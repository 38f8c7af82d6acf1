"""graftcheck rule engine: findings, suppressions, baseline, runner.

Copied from ``progen_tpu/analysis/engine.py``; it differs only where it
names the port: the mesh vocabulary is read from
``progen_tpu_torch/core/mesh.py`` and :func:`run` loads the port's rules.
Findings, suppressions, baselines and the human, JSON and SARIF formats
are the original's, byte for byte.

The analyzer is pure-stdlib AST walking — it never imports torch or jax
and never executes repo code, so it runs in milliseconds and is safe to
call from a tier-1 test or a pre-push hook.  Rules live in sibling ``rules_*`` modules
and register themselves into :data:`RULES` at import time.

Suppression grammar (checked on the finding's line, then the line above if
that line is comment-only):

    x = risky()  # graftcheck: disable=host-sync
    # graftcheck: disable=host-sync,trace-safety
    # graftcheck: disable-file=mesh-axis        (anywhere: whole file)

Baseline: ``progen_tpu_torch/analysis/baseline.json`` holds accepted
legacy findings keyed on ``(rule, path, message)`` — deliberately not the line number, so
unrelated edits above a baselined finding don't invalidate it.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Callable, Iterable, Sequence

DEFAULT_MESH_AXES = frozenset({"data", "fsdp", "tensor", "seq"})

_SUPPRESS_RE = re.compile(r"#\s*graftcheck:\s*disable=([\w,\-]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*graftcheck:\s*disable-file=([\w,\-]+)")
_COMMENT_ONLY_RE = re.compile(r"^\s*#")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # posix, relative to the analysis root
    line: int
    col: int
    message: str

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


@dataclasses.dataclass
class ParsedModule:
    path: str  # posix relpath used in findings
    source: str
    tree: ast.Module
    lines: list[str]


@dataclasses.dataclass
class RepoContext:
    """Cross-file facts shared by all rules (currently: mesh-axis vocab)."""

    root: Path
    mesh_axes: frozenset[str] = DEFAULT_MESH_AXES


# rule name -> callable(module, ctx) -> iterable of Finding
RULES: dict[str, Callable[[ParsedModule, RepoContext], Iterable[Finding]]] = {}


def rule(name: str):
    """Decorator: register a rule function under ``name``."""

    def register(fn):
        fn.rule_name = name
        RULES[name] = fn
        return fn

    return register


# ---------------------------------------------------------------------------
# context discovery
# ---------------------------------------------------------------------------


def _string_tuple_assigns(tree: ast.Module, names: set[str]) -> set[str]:
    found: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not any(t in names for t in targets):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            elts = node.value.elts
            if elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in elts
            ):
                found.update(e.value for e in elts)
    return found


def discover_mesh_axes(root: Path) -> frozenset[str]:
    """Read the mesh-axis vocabulary out of core/mesh.py (AST only).

    Falls back to :data:`DEFAULT_MESH_AXES` when the declaration can't be
    found — a missing vocab must never turn every mesh lookup into noise.
    """
    axes: set[str] = set()
    for rel in ("progen_tpu_torch/core/mesh.py",
                "progen_tpu_torch/parallel/sharding.py"):
        path = root / rel
        if not path.is_file():
            continue
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError:
            continue
        axes |= _string_tuple_assigns(tree, {"MESH_AXES", "AXES", "MESH_AXIS_NAMES"})
    return frozenset(axes) if axes else DEFAULT_MESH_AXES


def build_context(root: Path) -> RepoContext:
    return RepoContext(root=root, mesh_axes=discover_mesh_axes(root))


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------


def _comment_lines(lines: Sequence[str]):
    """``(lineno, line_text)`` for lines carrying a real COMMENT token.
    Tokenizing (rather than regexing every line) keeps suppression
    examples inside docstrings — like the ones at the top of this file —
    from acting as live suppressions or rotting into stale ones."""
    src = "\n".join(lines) + "\n"
    comment_rows: set[int] | None = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                comment_rows.add(tok.start[0])
    except (tokenize.TokenError, SyntaxError, IndentationError, ValueError):
        comment_rows = None  # unterminated string etc: fall back to all lines
    for i, text in enumerate(lines, start=1):
        if comment_rows is None or i in comment_rows:
            yield i, text


class Suppressions:
    """Parses the suppression comments of one file and, while findings
    are checked against it, records which entries actually fired — a
    suppression that never matches anything is itself reportable (the
    ``stale-suppression`` rule) so sanctioned-leak comments can't
    outlive the code they sanction."""

    def __init__(self, lines: Sequence[str]):
        self.by_line: dict[int, set[str]] = {}
        self.file_wide: set[str] = set()
        self._comment_only: set[int] = set()
        # entries that matched at least one finding: (line, rule) for
        # per-line entries, (0, rule) for file-wide ones
        self.matched: set[tuple[int, str]] = set()
        for i, text in _comment_lines(lines):
            m = _SUPPRESS_FILE_RE.search(text)
            if m:
                self.file_wide.update(m.group(1).split(","))
            m = _SUPPRESS_RE.search(text)
            if m:
                self.by_line.setdefault(i, set()).update(m.group(1).split(","))
            if _COMMENT_ONLY_RE.match(text):
                self._comment_only.add(i)

    def is_suppressed(self, finding: Finding) -> bool:
        hit = False
        for name in (finding.rule, "all"):
            if name in self.file_wide:
                self.matched.add((0, name))
                hit = True
        if hit:
            return True
        for line in (finding.line, finding.line - 1):
            rules = self.by_line.get(line)
            if rules is None:
                continue
            if line != finding.line and line not in self._comment_only:
                continue  # trailing comment on the previous code line: no
            for name in (finding.rule, "all"):
                if name in rules:
                    self.matched.add((line, name))
                    hit = True
        return hit

    def stale_findings(self, path: str,
                       rules_run: set | None = None) -> list[Finding]:
        """Suppression entries that no finding ever matched.  With a
        rule filter active, entries naming rules that didn't run are
        skipped — their target simply wasn't looked for."""

        def eligible(name: str) -> bool:
            if rules_run is None:
                return True
            return name == "all" or name in rules_run

        out: list[Finding] = []
        for line in sorted(self.by_line):
            for name in sorted(self.by_line[line]):
                if eligible(name) and (line, name) not in self.matched:
                    out.append(Finding(
                        rule="stale-suppression", path=path, line=line,
                        col=0,
                        message=f"suppression 'graftcheck: disable={name}' "
                                "never matched a finding — the sanctioned "
                                "code is gone, delete the comment"))
        for name in sorted(self.file_wide):
            if eligible(name) and (0, name) not in self.matched:
                out.append(Finding(
                    rule="stale-suppression", path=path, line=1, col=0,
                    message=f"suppression 'graftcheck: disable-file={name}' "
                            "never matched a finding — the sanctioned "
                            "code is gone, delete the comment"))
        return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> set[tuple[str, str, str]]:
    data = json.loads(path.read_text())
    return {
        (f["rule"], f["path"], f["message"]) for f in data.get("findings", [])
    }


def save_baseline(path: Path, findings: Sequence[Finding]) -> None:
    data = {
        "version": 1,
        "findings": [
            {"rule": f.rule, "path": f.path, "message": f.message}
            for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
        ],
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def apply_baseline(
    findings: Sequence[Finding], baseline: set[tuple[str, str, str]]
) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (new, baselined)."""
    new, old = [], []
    for f in findings:
        (old if f.key() in baseline else new).append(f)
    return new, old


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "node_modules", ".venv"}


def iter_python_files(paths: Sequence[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for sub in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in sub.parts):
                    yield sub


def parse_module(path: Path, root: Path) -> ParsedModule | None:
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError:
        return None
    try:
        rel = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    return ParsedModule(
        path=rel, source=source, tree=tree, lines=source.splitlines()
    )


def check_source(
    source: str,
    path: str = "<string>",
    rules: Sequence[str] | None = None,
    ctx: RepoContext | None = None,
    report_stale: bool = False,
) -> list[Finding]:
    """Analyze a source string — the unit-test entry point."""
    tree = ast.parse(source)
    module = ParsedModule(
        path=path, source=source, tree=tree, lines=source.splitlines()
    )
    return check_module(module, ctx or RepoContext(root=Path(".")), rules,
                        report_stale=report_stale)


def check_module(
    module: ParsedModule,
    ctx: RepoContext,
    rules: Sequence[str] | None = None,
    *,
    report_stale: bool = False,
) -> list[Finding]:
    suppress = Suppressions(module.lines)
    out: list[Finding] = []
    for name, fn in RULES.items():
        if rules is not None and name not in rules:
            continue
        for finding in fn(module, ctx):
            if not suppress.is_suppressed(finding):
                out.append(finding)
    if report_stale:
        rules_run = None if rules is None else set(rules)
        for finding in suppress.stale_findings(module.path, rules_run):
            # a stale-suppression finding is suppressible like any other
            # (and doing so un-stales the entry that names it)
            if not suppress.is_suppressed(finding):
                out.append(finding)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def run(
    paths: Sequence[Path],
    root: Path,
    rules: Sequence[str] | None = None,
    *,
    report_stale: bool = False,
) -> list[Finding]:
    # rule modules register themselves on import; keep this lazy so that
    # `from progen_tpu_torch.analysis import engine` alone stays
    # import-cycle free
    from progen_tpu_torch.analysis import load_rules

    load_rules()
    ctx = build_context(root)
    findings: list[Finding] = []
    for file in iter_python_files(paths):
        module = parse_module(file, root)
        if module is None:
            findings.append(
                Finding(
                    rule="parse-error",
                    path=file.as_posix(),
                    line=1,
                    col=0,
                    message="file does not parse as Python",
                )
            )
            continue
        findings.extend(check_module(module, ctx, rules,
                                     report_stale=report_stale))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------


def format_human(findings: Sequence[Finding], baselined: int = 0) -> str:
    lines = [
        f"{f.path}:{f.line}:{f.col}: [{f.rule}] {f.message}" for f in findings
    ]
    tail = f"{len(findings)} finding(s)"
    if baselined:
        tail += f" ({baselined} baselined finding(s) hidden)"
    lines.append(tail)
    return "\n".join(lines)


def format_json(findings: Sequence[Finding], baselined: int = 0) -> str:
    return json.dumps(
        {
            "version": 1,
            "findings": [f.to_json() for f in findings],
            "count": len(findings),
            "baselined": baselined,
        },
        indent=2,
    )


def format_sarif(findings: Sequence[Finding], baselined: int = 0) -> str:
    """SARIF 2.1.0 — the interchange format CI annotators and editors
    consume; one run, one result per finding, columns 1-based."""
    rule_ids = sorted({f.rule for f in findings})
    results = [
        {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path,
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {
                            "startLine": max(1, f.line),
                            "startColumn": f.col + 1,
                        },
                    }
                }
            ],
        }
        for f in findings
    ]
    doc = {
        "$schema": "https://docs.oasis-open.org/sarif/sarif/v2.1.0/os/"
                   "schemas/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftcheck",
                        "informationUri":
                            "https://example.invalid/progen-tpu/graftcheck",
                        "rules": [{"id": r} for r in rule_ids],
                    }
                },
                "results": results,
                "properties": {"baselined": baselined},
            }
        ],
    }
    return json.dumps(doc, indent=2)
