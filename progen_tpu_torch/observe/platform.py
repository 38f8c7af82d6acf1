"""Record stamping and card probing shared by the port's measurement scripts.

Copied from progen_tpu/observe/platform.py, with the CUDA card in place of
the TPU backend and the port's runtime in the error record's stamp.  What
in the port calls each function:

* :func:`stamp_record` — the one door every measurement JSON record leaves
  through: ``chip_smoke.py``'s phase lines (``emit``) and its
  ``{"kernels": ...}`` lines, ``progen_tpu_torch/trace_main_path.py``'s and
  ``progen_tpu_torch/kernels/ablate.py``'s records, and
  :func:`emit_error_record`.  The CLIs' records (``sample.py``,
  ``train/cli.py``) keep the JAX CLIs' unstamped format.
* :func:`probe_backend` — ``chip_smoke.main`` calls it before anything
  else.  It checks that the card comes up in a SUBPROCESS per attempt: a
  held or broken driver can pass ``torch.cuda.is_available()`` and then
  fail, or hang, when the first context is made, and a hang in the
  caller's own process could never be timed out.  Attempts retry through
  the port's resilience layer (``PROGEN_BENCH_RETRY_*`` env knobs).
* :func:`emit_error_record` — when the card (or the run itself) is beyond
  saving, print ONE parseable JSON error line with the runtime's stamp, so
  a reader ingests a structured record instead of a raw traceback.
  :func:`probe_backend` calls it on a definitive failure.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from progen_tpu_torch.observe.gitinfo import git_sha

# last wall_time stamped by this process — records within one process are
# guaranteed strictly increasing even if the wall clock steps backwards
# (NTP slew mid-run), so records of one sha can be ordered by wall_time
_last_wall = 0.0

# the card is made to do real work: a context, a tensor, a reduction read back
_PROBE = "import torch; assert int(torch.ones(8, device='cuda:0').sum()) == 8"

# what the last probe_backend call saw: ok, attempts, seconds
LAST_PROBE: dict = {}


def stamp_record(record: dict | None = None, **extra) -> dict:
    """The one door every measurement JSON record leaves through.

    Merges ``extra`` into a copy of ``record`` and guarantees the
    ``git_sha`` and ``wall_time`` stamps, so a record can always be
    traced back to the code that produced it and ordered against other
    records of the same metric.  ``wall_time`` is monotonic-safe within
    a process; callers on a traced path pass ``wall_time=...`` captured
    outside the timed region rather than letting this function read the
    clock.  Callers pass their fields and never touch
    :func:`~progen_tpu_torch.observe.gitinfo.git_sha` directly —
    ``tests/test_torch_platform.py`` sweeps the measurement scripts to
    keep it that way."""
    global _last_wall

    out = dict(record or {})
    out.update(extra)
    out.setdefault("git_sha", git_sha())
    wall = out.get("wall_time")
    if not isinstance(wall, (int, float)):
        wall = time.time()
    wall = max(float(wall), _last_wall + 1e-3) if _last_wall else float(wall)
    _last_wall = wall
    out["wall_time"] = round(wall, 3)
    return out


def emit_error_record(e: BaseException, **extra) -> None:
    """One parseable JSON error line on stdout with the runtime's stamp —
    a reader ingests this instead of a traceback.  ``extra`` keys are
    merged into the record."""
    import platform

    import torch

    print(json.dumps(stamp_record({
        "error": f"{type(e).__name__}: {e}",
        "metric": None,
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python": platform.python_version(),
    }, **extra)), flush=True)


def probe_backend(**extra) -> bool:
    """Check the card comes up, retrying failed attempts.

    Makes a CUDA context and a tensor on ``cuda:0`` in a subprocess per
    attempt (see the module docstring for why), retried under
    ``PROGEN_BENCH_RETRY_*``.  Torch's message cannot tell a card another
    process holds from one that is absent, so every failed attempt is
    retried within the policy's attempts and deadline.  On definitive
    failure, emits the structured error record (merging ``extra``) and
    returns False — callers return without touching the card.
    :data:`LAST_PROBE` keeps the call's attempts and seconds.
    """
    import subprocess

    from progen_tpu_torch.resilience.retry import (
        AttemptTimeout, RetryPolicy, retry_call,
    )

    policy = RetryPolicy.from_env("PROGEN_BENCH_RETRY")
    per_try = policy.attempt_timeout or 60.0
    # the subprocess enforces the per-attempt bound itself — don't stack
    # the thread-based attempt timeout on top
    policy = dataclasses.replace(policy, attempt_timeout=None,
                                 classifier=lambda exc: True)
    seen = {"attempts": 0}

    def probe():
        seen["attempts"] += 1
        try:
            proc = subprocess.run(
                [sys.executable, "-c", _PROBE],
                capture_output=True, text=True, timeout=per_try,
            )
        except subprocess.TimeoutExpired:
            raise AttemptTimeout(
                f"card init exceeded {per_try:.0f}s") from None
        if proc.returncode != 0:
            tail = (proc.stderr or "").strip().splitlines()[-8:]
            raise RuntimeError("card init failed: " + " | ".join(tail))

    t0 = time.perf_counter()
    try:
        retry_call(probe, policy=policy, label="card-init")
        ok = True
    except Exception as e:  # attempts or deadline spent: report, don't raise
        emit_error_record(e, **extra)
        ok = False
    LAST_PROBE.clear()
    LAST_PROBE.update(ok=ok, seconds=time.perf_counter() - t0, **seen)
    return ok
