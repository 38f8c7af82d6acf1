"""Rules ``rng-reuse`` and ``rng-split-dropped``: PRNG key discipline.

The counterpart of ``progen_tpu/analysis/rules_rng.py`` on the port's
JAX key chain (``decode/rng.py``: threefry keys held as raw key data, so
that the port samples the JAX package's tokens).  Keys are splittable
counters, not stateful generators: feeding the same key to two samplers
yields identical draws, and splitting a key without using the result is
always a bug.

Producers bind fresh keys: ``rng.key``, ``rng.split``, ``rng.split_key``,
``split_keys_batched`` and ``next()`` of a ``KeySeq``.  Sinks use a key
up: ``rng.uniform``, ``rng.gumbel``, ``rng.random_bits`` and the sampler
functions that take one (``key_gumbel``, ``gumbel_topk_sample_batched``);
a split consumes the key it splits.

``rng-reuse`` does a linear abstract walk of each function body, counting
consumptions per key variable; ``if``/``else`` branches merge by max (either
branch may run), loop bodies are walked twice (a consumption that survives
one iteration without a re-split fires on the second pass).
"""

from __future__ import annotations

import ast

from progen_tpu_torch.analysis.capturegraph import call_name, walk_functions
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule

_KEY_PARAM_NAMES = frozenset({"key", "rng", "rng_key", "prng_key", "keys",
                              "key_data"})

# splits: consume the key they are given and bind fresh ones
_SPLITS = frozenset({
    "rng.split", "split", "rng.split_key", "split_key",
    "split_keys_batched", "sampler.split_keys_batched",
})

# producers: assigning their result (re)binds a fresh key
_KEY_PRODUCERS = _SPLITS | frozenset({"rng.key", "next"})

# consumers: passing a key here uses up its entropy
_KEY_SINKS = _SPLITS | frozenset({
    "rng.uniform", "uniform", "rng.gumbel", "gumbel",
    "rng.random_bits", "random_bits", "key_gumbel", "sampler.key_gumbel",
    "gumbel_topk_sample_batched", "sampler.gumbel_topk_sample_batched",
})


def _is_underscore(name: str) -> bool:
    return name == "_" or name.startswith("_unused")


def _key_args(node: ast.Call) -> list[str]:
    """Names passed to a key sink (positionally or as key=)."""
    out = []
    for a in node.args:
        if isinstance(a, ast.Name):
            out.append(a.id)
    for kw in node.keywords:
        if kw.arg == "key" and isinstance(kw.value, ast.Name):
            out.append(kw.value.id)
    return out


class _FnScan:
    def __init__(self, fn, module_path: str):
        self.fn = fn
        self.path = module_path
        self.findings: list[Finding] = []
        self._reported: set[tuple[int, str]] = set()
        # var -> consumption count; presence marks "known key variable"
        counts: dict[str, int] = {}
        for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs:
            if a.arg in _KEY_PARAM_NAMES:
                counts[a.arg] = 0
        self.final = self._walk_body(fn.body, counts)

    # -- state ops ---------------------------------------------------------

    def _consume(self, counts, name: str, node: ast.AST) -> None:
        if name not in counts:
            return
        counts[name] += 1
        if counts[name] >= 2:
            key = (node.lineno, name)
            if key not in self._reported:
                self._reported.add(key)
                self.findings.append(
                    Finding(
                        rule="rng-reuse",
                        path=self.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"key '{name}' consumed again without an "
                            "intervening rng.split"
                        ),
                    )
                )

    def _rebind(self, counts, name: str) -> None:
        counts[name] = 0

    # -- walkers -----------------------------------------------------------

    def _walk_body(self, body, counts) -> dict[str, int]:
        for stmt in body:
            counts = self._walk_stmt(stmt, counts)
        return counts

    def _walk_stmt(self, stmt, counts) -> dict[str, int]:
        if isinstance(stmt, ast.Assign):
            self._scan_expr(stmt.value, counts)
            self._bind_targets(stmt.targets, stmt.value, counts)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._scan_expr(stmt.value, counts)
                self._bind_targets([stmt.target], stmt.value, counts)
        elif isinstance(stmt, ast.AugAssign):
            self._scan_expr(stmt.value, counts)
        elif isinstance(stmt, ast.Expr):
            self._check_dropped_split(stmt)
            self._scan_expr(stmt.value, counts)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._scan_expr(stmt.value, counts)
        elif isinstance(stmt, ast.If):
            self._scan_expr(stmt.test, counts)
            a = self._walk_body(stmt.body, dict(counts))
            b = self._walk_body(stmt.orelse, dict(counts))
            counts = {
                k: max(a.get(k, 0), b.get(k, 0))
                for k in set(a) | set(b)
            }
        elif isinstance(stmt, (ast.For, ast.While)):
            if isinstance(stmt, ast.For):
                self._scan_expr(stmt.iter, counts)
            else:
                self._scan_expr(stmt.test, counts)
            # simulate two iterations: reuse across iterations surfaces on
            # the second pass unless the loop re-splits
            counts = self._walk_body(stmt.body, counts)
            counts = self._walk_body(stmt.body, counts)
            counts = self._walk_body(stmt.orelse, counts)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            counts = self._walk_body(stmt.body, counts)
        elif isinstance(stmt, ast.Try):
            counts = self._walk_body(stmt.body, counts)
            for handler in stmt.handlers:
                counts = self._walk_body(handler.body, dict(counts))
            counts = self._walk_body(stmt.orelse, counts)
            counts = self._walk_body(stmt.finalbody, counts)
        # nested defs get their own _FnScan via walk_functions; skip here
        return counts

    def _bind_targets(self, targets, value, counts) -> None:
        producer = (
            isinstance(value, ast.Call)
            and call_name(value) in _KEY_PRODUCERS
        )
        for t in targets:
            if isinstance(t, ast.Name):
                if producer or t.id in counts:
                    self._rebind(counts, t.id)
                if not producer and t.id in counts and not isinstance(
                    value, ast.Call
                ):
                    # aliasing an unknown value over a key var: stop tracking
                    counts.pop(t.id, None)
                    counts[t.id] = 0
            elif isinstance(t, (ast.Tuple, ast.List)) and producer:
                for elt in t.elts:
                    if isinstance(elt, ast.Name):
                        self._rebind(counts, elt.id)

    def _scan_expr(self, expr, counts) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) not in _KEY_SINKS:
                continue
            for var in _key_args(node):
                self._consume(counts, var, node)

    def _check_dropped_split(self, stmt: ast.Expr) -> None:
        value = stmt.value
        if (
            isinstance(value, ast.Call)
            and call_name(value) in _SPLITS
        ):
            self.findings.append(
                Finding(
                    rule="rng-split-dropped",
                    path=self.path,
                    line=stmt.lineno,
                    col=stmt.col_offset,
                    message=f"result of {call_name(value)} is discarded",
                )
            )


@rule("rng-reuse")
def check_reuse(module: ParsedModule, ctx: RepoContext):
    for fn in walk_functions(module.tree):
        scan = _FnScan(fn, module.path)
        for f in scan.findings:
            if f.rule == "rng-reuse":
                yield f


@rule("rng-split-dropped")
def check_dropped(module: ParsedModule, ctx: RepoContext):
    # dropped splits are also flagged when assigned entirely to underscores
    for fn in walk_functions(module.tree):
        scan = _FnScan(fn, module.path)
        for f in scan.findings:
            if f.rule == "rng-split-dropped":
                yield f
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if call_name(node.value) not in _SPLITS:
                continue
            names: list[str] = []
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.append(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    names.extend(
                        e.id for e in t.elts if isinstance(e, ast.Name)
                    )
            if names and all(_is_underscore(n) for n in names):
                yield Finding(
                    rule="rng-split-dropped",
                    path=module.path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=f"result of {call_name(node.value)} is discarded",
                )
