"""graftcheck CLI for the port: torch/CUDA-aware static analysis.

The counterpart of ``tools/graftcheck.py``, with its flags and exit
codes.  Usage, from the root of the repo:

    python -m progen_tpu_torch.analysis progen_tpu_torch chip_smoke.py
    python -m progen_tpu_torch.analysis --format json progen_tpu_torch
    python -m progen_tpu_torch.analysis --format sarif progen_tpu_torch > f.sarif
    python -m progen_tpu_torch.analysis --rules host-sync,kernel-status progen_tpu_torch
    python -m progen_tpu_torch.analysis --changed        # files vs merge-base
    python -m progen_tpu_torch.analysis --changed HEAD~3 progen_tpu_torch
    python -m progen_tpu_torch.analysis --list-rules
    python -m progen_tpu_torch.analysis --update-baseline progen_tpu_torch ...

Exit codes: 0 clean (or all findings baselined), 1 non-baselined findings,
2 usage/internal error — suitable for CI.

Suppression comments that never match a finding are themselves reported
(``stale-suppression``) so sanctioned-leak comments can't rot; pass
``--allow-stale`` to skip that check.

The analyzer is pure stdlib and so is this CLI: ``progen_tpu_torch``'s
``__init__`` imports torch only when its model is asked for.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

_MERGE_BASE = "__merge-base__"  # sentinel: bare --changed with no ref


def _git(args: list[str], root: Path) -> str | None:
    try:
        proc = subprocess.run(
            ["git", *args], cwd=root, capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    return proc.stdout


def changed_files(root: Path, ref: str) -> list[Path] | None:
    """Python files changed vs ``ref`` (plus untracked ones), for the
    fast pre-commit loop.  ``None`` means "couldn't tell" — not a git
    checkout, unknown ref, no git binary — and the caller falls back to
    a full scan rather than silently checking nothing."""
    if ref == _MERGE_BASE:
        base = _git(["merge-base", "HEAD", "main"], root)
        if base is None:
            base = _git(["merge-base", "HEAD", "origin/main"], root)
        if base is None:
            return None
        ref = base.strip()
    diff = _git(["diff", "--name-only", "--diff-filter=d", ref], root)
    if diff is None:
        return None
    untracked = _git(
        ["ls-files", "--others", "--exclude-standard"], root) or ""
    out: list[Path] = []
    seen: set = set()
    for rel in diff.splitlines() + untracked.splitlines():
        rel = rel.strip()
        if not rel.endswith(".py") or rel in seen:
            continue
        seen.add(rel)
        p = root / rel
        if p.is_file():
            out.append(p)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="graftcheck", description=__doc__.splitlines()[0]
    )
    parser.add_argument("paths", nargs="*", help="files or directories")
    parser.add_argument(
        "--format",
        choices=("human", "json", "sarif"),
        default=None,
        help="output format (default: human)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="shorthand for --format json",
    )
    parser.add_argument(
        "--rules",
        default=None,
        help="comma-separated subset of rules to run",
    )
    parser.add_argument(
        "--changed",
        nargs="?",
        const=_MERGE_BASE,
        default=None,
        metavar="REF",
        help="lint only files changed vs REF (default: merge-base with "
             "main); outside a git checkout this falls back to the full "
             "scan of the given paths",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        default=DEFAULT_BASELINE,
        help=f"baseline file (default: {DEFAULT_BASELINE.name})",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="report baselined findings too",
    )
    parser.add_argument(
        "--update-baseline",
        action="store_true",
        help="write all current findings to the baseline file and exit 0",
    )
    parser.add_argument(
        "--allow-stale",
        action="store_true",
        help="don't report suppression comments that matched nothing",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    args = parser.parse_args(argv)
    if args.json and args.format not in (None, "json"):
        parser.error("--json conflicts with --format " + args.format)
    fmt = "json" if args.json else (args.format or "human")

    from progen_tpu_torch import analysis

    if args.list_rules:
        for name in sorted(analysis.load_rules()):
            print(name)
        return 0

    if not args.paths and args.changed is None:
        parser.error("no paths given (try: progen_tpu_torch chip_smoke.py)")

    rules = args.rules.split(",") if args.rules else None
    if rules:
        unknown = set(rules) - set(analysis.load_rules())
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    paths = [Path(p) for p in args.paths]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"no such path: {', '.join(map(str, missing))}", file=sys.stderr)
        return 2

    if args.changed is not None:
        changed = changed_files(REPO_ROOT, args.changed)
        if changed is None:
            if not paths:
                print("--changed: not a git checkout and no paths to fall "
                      "back to", file=sys.stderr)
                return 2
            print("graftcheck: --changed unavailable (no git); running a "
                  "full scan", file=sys.stderr)
        else:
            if paths:
                # intersect: only changed files under the given paths
                roots = [p.resolve() for p in paths]

                def under(f: Path) -> bool:
                    rf = f.resolve()
                    return any(r == rf or r in rf.parents for r in roots)

                changed = [f for f in changed if under(f)]
            paths = changed
            if not paths:
                print("0 finding(s) (no changed Python files)")
                return 0

    findings = analysis.run(paths, root=REPO_ROOT, rules=rules,
                            report_stale=not args.allow_stale)

    if args.update_baseline:
        analysis.save_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = set()
    if not args.no_baseline and args.baseline.is_file():
        baseline = analysis.load_baseline(args.baseline)
    new, baselined = analysis.apply_baseline(findings, baseline)

    if fmt == "json":
        print(analysis.format_json(new, baselined=len(baselined)))
    elif fmt == "sarif":
        print(analysis.format_sarif(new, baselined=len(baselined)))
    else:
        print(analysis.format_human(new, baselined=len(baselined)))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
