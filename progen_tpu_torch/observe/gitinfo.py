"""Resolve the repo's git SHA for measurement record attribution.

Measurement JSON records are only comparable across time when each one
says which commit produced it; ``git_sha()`` is best-effort (returns
``None`` outside a work tree or without git on PATH) so measurements never
fail on account of provenance.  A tree unpacked from ``git archive`` has no
``.git`` and stamps ``None``.

Copied from progen_tpu/observe/gitinfo.py (standard library only); the
port keeps its own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import functools
import subprocess
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent


@functools.lru_cache(maxsize=1)
def git_sha(short: bool = False) -> str | None:
    """Current HEAD commit (``None`` when unresolvable). Cached per process."""
    cmd = ["git", "rev-parse", "--short" if short else "--verify", "HEAD"]
    try:
        out = subprocess.run(
            cmd,
            cwd=_REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=5,
            check=False,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None
