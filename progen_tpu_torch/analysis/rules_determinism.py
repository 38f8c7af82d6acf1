"""det-*: determinism lint for token-identity zones.

Copied from ``progen_tpu/analysis/rules_determinism.py``; the zones name
the port's files, and ``det-ambient-rng`` also flags draws from torch's
global generator (the port's rule is explicit generators).

Replay, spec-decoding verification, preemption evict-replay, and the
QoS trace harness all depend on scheduling decisions being a pure
function of the request stream.  Three things quietly break that
contract: iterating an unordered ``set`` (or ``dict.values()``) to pick
winners, reading a wall clock where virtual/sanctioned time is the
rule, and ambient randomness (``random.*`` module state, ``hash()``
with ``PYTHONHASHSEED`` unset).

The zones — which files/functions must be deterministic and which
clocks they are allowed to touch — are declared in :data:`DET_ZONES`.
The engine's monotonic-clock usage is the design (virtual time is
derived from it at replay), so ``time.perf_counter`` is sanctioned in
the engine scheduling zone but not elsewhere.

Rules: ``det-set-iter``, ``det-wallclock``, ``det-ambient-rng``.

In torch, ambient randomness is also the global generator: a draw
(``torch.rand*``, ``randn*``, ``randint*``, ``randperm``,
``multinomial``, ``bernoulli``, ``normal``, ``poisson`` and the in-place
``t.normal_()``/``uniform_()``/...) with no ``generator=``, and any
reseeding of it (``torch.manual_seed``).
"""

from __future__ import annotations

import ast
import dataclasses
import re

from progen_tpu_torch.analysis.capturegraph import dotted, qualnames
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule


@dataclasses.dataclass(frozen=True)
class DetZone:
    path_re: str        # matched against the module's repo-relative path
    qual_re: str        # matched against the function qualname
    clocks: tuple = ()  # dotted call names sanctioned inside this zone
    why: str = ""


DET_ZONES: tuple[DetZone, ...] = (
    DetZone(r"progen_tpu_torch/decode/qos\.py$", r".*",
            why="QoS ordering is replayed by the overload trace harness"),
    DetZone(r"progen_tpu_torch/serve/router\.py$", r".*",
            why="placement must replay for exactly-once completion"),
    DetZone(r"progen_tpu_torch/decode/spec\.py$", r".*",
            why="spec accept/reject is part of token identity"),
    DetZone(
        r"progen_tpu_torch/decode/engine\.py$",
        r"(?:.*\.)?(submit_fork|_release_forks|_maybe_preempt|_preempt_slot"
        r"|_admit_pending\w*|_admit_from_handoff|_plan_slot_pages"
        r"|_ensure_chunk_pages|_free_slot_pages|_harvest_done)$",
        clocks=(r"time\.perf_counter(?:_ns)?",),
        why="engine scheduling; the monotonic clock is the sanctioned "
            "timebase that virtual time is derived from"),
)

_ZONES = tuple(
    (re.compile(z.path_re), re.compile(z.qual_re),
     tuple(re.compile(c) for c in z.clocks), z.why)
    for z in DET_ZONES
)


def _zone_for(path: str, qual: str):
    for path_re, qual_re, clocks, why in _ZONES:
        if path_re.search(path) and qual_re.fullmatch(qual):
            return clocks, why
    return None


def _zone_functions(module: ParsedModule):
    for fn, qual in qualnames(module.tree).items():
        zone = _zone_for(module.path, qual)
        if zone is not None:
            yield fn, qual, zone


# ---------------------------------------------------------------------------
# det-set-iter
# ---------------------------------------------------------------------------

_ORDER_SENSITIVE_BUILTINS = {"min", "max", "next", "list", "tuple",
                             "enumerate", "zip"}


def _set_names(fn) -> set:
    """Names bound (anywhere in the function) to a definitely-set value."""
    names: set = set()
    for node in ast.walk(fn):
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            target = node.target.id
            value = node.value
        else:
            continue
        if _is_set_expr(value, names):
            names.add(target)
    return names


def _is_set_expr(node, set_names) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        callee = dotted(node.func)
        if callee in ("set", "frozenset"):
            return True
        # set-returning methods on a known set
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("union", "intersection", "difference",
                                       "symmetric_difference", "copy") \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in set_names:
            return True
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.BitOr, ast.BitAnd, ast.Sub,
                                     ast.BitXor)):
        return _is_set_expr(node.left, set_names) \
            or _is_set_expr(node.right, set_names)
    if isinstance(node, ast.Name):
        return node.id in set_names
    return False


def _unordered_iter_desc(node, set_names) -> str | None:
    """If iterating ``node`` has nondeterministic order, describe why."""
    if _is_set_expr(node, set_names):
        return "a set"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "values" and not node.args:
        # dict.values(): insertion-ordered per-process, but across
        # processes/restarts insertion order is load order — only flag
        # when the receiver is itself built from a set; plain
        # dict.values() iteration is deterministic under replay.
        if _is_set_expr(node.func.value, set_names):
            return "values() of a set-keyed mapping"
        return None
    if isinstance(node, ast.Call):
        callee = dotted(node.func)
        if callee == "sorted":
            return None
        if callee in ("list", "tuple", "reversed") and node.args:
            return _unordered_iter_desc(node.args[0], set_names)
    return None


@rule("det-set-iter")
def check_set_iteration(module: ParsedModule, ctx: RepoContext):
    for fn, qual, (clocks, why) in _zone_functions(module):
        set_names = _set_names(fn)
        for node in ast.walk(fn):
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.DictComp,
                                   ast.GeneratorExp)):
                # SetComp is exempt: set -> set is order-insensitive
                iters.extend(gen.iter for gen in node.generators)
            elif isinstance(node, ast.Call):
                callee = dotted(node.func)
                if callee in _ORDER_SENSITIVE_BUILTINS and node.args:
                    iters.append(node.args[0])
            for it in iters:
                desc = _unordered_iter_desc(it, set_names)
                if desc is not None:
                    yield Finding(
                        rule="det-set-iter", path=module.path,
                        line=it.lineno, col=it.col_offset,
                        message=f"iteration over {desc} feeds a decision in "
                                f"determinism zone '{qual}' ({why}) — sort "
                                "on a stable key first")


# ---------------------------------------------------------------------------
# det-wallclock
# ---------------------------------------------------------------------------

_WALLCLOCKS = (
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow", "datetime.now",
    "datetime.utcnow",
)


@rule("det-wallclock")
def check_wallclock(module: ParsedModule, ctx: RepoContext):
    for fn, qual, (clocks, why) in _zone_functions(module):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted(node.func)
            if callee not in _WALLCLOCKS:
                continue
            if any(c.fullmatch(callee) for c in clocks):
                continue
            yield Finding(
                rule="det-wallclock", path=module.path,
                line=node.lineno, col=node.col_offset,
                message=f"wall-clock read {callee}() inside determinism "
                        f"zone '{qual}' ({why}) — thread a sanctioned clock "
                        "in instead")


# ---------------------------------------------------------------------------
# det-ambient-rng
# ---------------------------------------------------------------------------

_RNG_OK = re.compile(r"random\.(Random|SystemRandom)$")
_RNG_MODULES = ("random.", "numpy.random.", "np.random.")

# torch draws that take their bits from the global generator unless
# given ``generator=``
_TORCH_DRAWS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "multinomial", "bernoulli", "normal", "poisson",
})
_TORCH_INPLACE_DRAWS = frozenset({
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})
# reseeding the global generator
_TORCH_SEEDS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
})


def _torch_ambient(node: ast.Call, callee: str) -> str | None:
    """How a call draws from, or reseeds, torch's global generator."""
    if callee in _TORCH_SEEDS:
        return f"{callee}() reseeds torch's global generator"
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    parts = callee.split(".")
    if parts[0] == "torch" and len(parts) == 2 and parts[1] in _TORCH_DRAWS:
        return f"{callee}() draws from torch's global generator"
    if len(parts) > 1 and parts[-1] in _TORCH_INPLACE_DRAWS:
        return f".{parts[-1]}() draws from torch's global generator"
    return None


@rule("det-ambient-rng")
def check_ambient_rng(module: ParsedModule, ctx: RepoContext):
    for fn, qual, (clocks, why) in _zone_functions(module):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted(node.func)
            if callee is None:
                continue
            if callee == "hash":
                yield Finding(
                    rule="det-ambient-rng", path=module.path,
                    line=node.lineno, col=node.col_offset,
                    message=f"builtin hash() inside determinism zone "
                            f"'{qual}' ({why}) depends on PYTHONHASHSEED — "
                            "use a content digest (zlib.crc32/hashlib)")
                continue
            ambient = _torch_ambient(node, callee)
            if ambient is not None:
                yield Finding(
                    rule="det-ambient-rng", path=module.path,
                    line=node.lineno, col=node.col_offset,
                    message=f"{ambient} inside determinism zone '{qual}' "
                            f"({why}) — pass an explicitly seeded "
                            "torch.Generator threaded from the request")
                continue
            if any(callee.startswith(m) for m in _RNG_MODULES) \
                    and not _RNG_OK.search(callee):
                yield Finding(
                    rule="det-ambient-rng", path=module.path,
                    line=node.lineno, col=node.col_offset,
                    message=f"ambient RNG call {callee}() inside determinism "
                            f"zone '{qual}' ({why}) — use an explicitly "
                            "seeded generator threaded from the request")
