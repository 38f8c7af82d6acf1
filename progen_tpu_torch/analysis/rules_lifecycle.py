"""resource-leak: path-sensitive resource-linearity checking.

Copied from ``progen_tpu/analysis/rules_lifecycle.py``.  Its
acquire/release patterns are the port's names as well: the engine's
``self._pool`` (``PagePool.allocate``/``release``), the router's
``note_handle`` credits, the ``HandoffQueue``, files, sockets and the
tracer's spans are spelled the same in ``progen_tpu_torch``.

Every resource class the serving fleet leaks in practice is declared in
:data:`SPECS` as an acquire/release pair (plus how ownership can leave a
function).  For each function we build the CFG (``analysis/cfg.py``) and
run a forward dataflow whose state is the set of *held* resources; any
path on which a held resource reaches

* the normal function exit (fall-through or early ``return``), or
* an explicit ``raise`` that escapes the function, or
* a rebinding of the holding variable

without a release or an ownership transfer is a finding.  Exception
edges count: an acquire inside a ``try`` whose handler forgets to roll
the resource back (the PR 16 fork-rollback class) reaches the normal
exit *through the handler* and is reported.

Ownership transfer is deliberately generous — passing the resource to
any call, storing it anywhere, returning it, or building a bigger value
out of it all stop tracking.  The rule only fires when a function
provably keeps the last reference to itself and drops it, which is what
keeps a path-sensitive rule quiet enough to gate CI at zero findings.

``with acquire() as x:`` is sanctioned by construction.  Declaring a new
resource is one :class:`ResourceSpec` entry; docs/ANALYSIS.md walks
through the fields.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from progen_tpu_torch.analysis.capturegraph import dotted, qualnames, walk_functions
from progen_tpu_torch.analysis.cfg import build_cfg, forward_dataflow
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule

RULE = "resource-leak"


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """One acquire/release protocol.

    ``acquire`` patterns are regexes full-matched against the dotted
    callee (``self._pool.allocate``).  ``mode`` says where the resource
    lives: ``result`` (the call's return value) or ``arg0`` (the first
    argument becomes an *obligation*, e.g. a noted batch id that must be
    acked).  ``release_arg`` callees release any tracked name passed as
    an argument; ``release_self`` are method names ON the resource
    (``sock.close()``).  ``escapes=False`` disables transfer-by-use for
    obligation tokens — passing a batch id around does not discharge the
    credit it owes."""

    name: str
    acquire: tuple[str, ...]
    mode: str = "result"
    release_arg: tuple[str, ...] = ()
    release_self: tuple[str, ...] = ()
    escapes: bool = True
    flag_discard: bool = True


SPECS: tuple[ResourceSpec, ...] = (
    ResourceSpec(
        name="pool page(s)",
        acquire=(r"(?:.*\.)?_?pool\.allocate",),
        release_arg=(r"(?:.*\.)?_?pool\.release",
                     r"(?:.*\.)?_?pool\._release_ref"),
    ),
    ResourceSpec(
        name="ack credit",
        mode="arg0",
        acquire=(r"(?:.*\.)?router\.note_handle",),
        release_arg=(r"(?:.*\.)?_return_credit",
                     r"(?:.*\.)?router\.forward",
                     r"(?:.*\.)?router\.ack"),
        escapes=False,
        flag_discard=False,
    ),
    ResourceSpec(
        name="handoff handle",
        acquire=(r"(?:.*\.)?_?handoff(?:_queue)?\.get",),
        release_arg=(r"(?:.*\.)?_?handoff(?:_queue)?\.requeue",),
    ),
    ResourceSpec(
        name="file handle",
        acquire=(r"open", r"tempfile\.NamedTemporaryFile",
                 r"tempfile\.TemporaryDirectory"),
        release_self=("close", "cleanup"),
    ),
    ResourceSpec(
        name="socket",
        acquire=(r"socket\.socket", r"socket\.create_connection"),
        release_self=("close", "detach"),
    ),
    ResourceSpec(
        name="tracer span",
        acquire=(r"(?:.*\.)?_?tracer\.span",),
        release_self=("__exit__",),
    ),
)

_ACQ = [[re.compile(p) for p in s.acquire] for s in SPECS]
_REL_ARG = [[re.compile(p) for p in s.release_arg] for s in SPECS]


def _acquire_spec(call: ast.Call) -> int | None:
    callee = dotted(call.func)
    if callee is None:
        return None
    for i, pats in enumerate(_ACQ):
        if any(p.fullmatch(callee) for p in pats):
            return i
    return None


# Token: (var, spec_index, line, col, raised) — ``raised`` marks that the
# path crossed an explicit raise while holding the resource.


@dataclasses.dataclass
class _Effects:
    """Statement effects, computed once per CFG node."""

    released: frozenset  # (name, spec_i)
    acquired: tuple      # (target, spec_i, line, col)
    bound: frozenset     # names (re)bound by this statement
    escaped: frozenset   # names used in an ownership-transferring position
    assert_names: frozenset


def _receiver_base(call: ast.Call) -> ast.Name | None:
    f = call.func
    while isinstance(f, ast.Attribute):
        f = f.value
    return f if isinstance(f, ast.Name) else None


def _stmt_effects(stmt: ast.stmt) -> _Effects:
    released: set = set()
    acquired: list = []
    bound: set = set()
    skip_ids: set = set()  # Name nodes that are not escaping uses

    for sub in ast.walk(stmt):
        if not isinstance(sub, ast.Call):
            continue
        base = _receiver_base(sub)
        if base is not None:
            skip_ids.add(id(base))
        callee = dotted(sub.func)
        if callee is None:
            continue
        for i, spec in enumerate(SPECS):
            if any(p.fullmatch(callee) for p in _REL_ARG[i]):
                for arg in list(sub.args) + [k.value for k in sub.keywords]:
                    if isinstance(arg, ast.Name):
                        released.add((arg.id, i))
                        skip_ids.add(id(arg))
            if spec.release_self and isinstance(sub.func, ast.Attribute) \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.attr in spec.release_self:
                released.add((sub.func.value.id, i))
            if spec.mode == "arg0":
                if any(p.fullmatch(callee) for p in _ACQ[i]) and sub.args \
                        and isinstance(sub.args[0], ast.Name):
                    acquired.append((sub.args[0].id, i,
                                     sub.lineno, sub.col_offset))
                    skip_ids.add(id(sub.args[0]))

    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name):
                bound.add(t.id)
        value = stmt.value
        if isinstance(value, ast.Call) and len(bound) == 1 \
                and len(targets) == 1 and isinstance(targets[0], ast.Name):
            spec_i = _acquire_spec(value)
            if spec_i is not None and SPECS[spec_i].mode == "result":
                acquired.append((targets[0].id, spec_i,
                                 value.lineno, value.col_offset))

    if isinstance(stmt, ast.Assert):
        names = {n.id for n in ast.walk(stmt.test)
                 if isinstance(n, ast.Name)}
        return _Effects(frozenset(released), tuple(acquired),
                        frozenset(bound), frozenset(), frozenset(names))

    escaped = {
        n.id for n in ast.walk(stmt)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
        and id(n) not in skip_ids
    }
    return _Effects(frozenset(released), tuple(acquired), frozenset(bound),
                    frozenset(escaped), frozenset())


def _narrow_killed(test: ast.expr, label: str) -> frozenset:
    """Names whose resource provably does not exist on this branch edge
    (``allocate`` returning None took the failure path)."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Name) \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.Is) and label == "true":
            return frozenset({test.left.id})
        if isinstance(test.ops[0], ast.IsNot) and label == "false":
            return frozenset({test.left.id})
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and isinstance(test.operand, ast.Name) and label == "true":
        return frozenset({test.operand.id})
    if isinstance(test, ast.Name) and label == "false":
        return frozenset({test.id})
    return frozenset()


def _for_element_release(stmt) -> set:
    """``for pid in pages: pool.release(pid)`` — releasing every element
    of a tracked collection releases the collection.  Returns the spec
    indices whose release the body performs on the loop variable."""
    if not isinstance(stmt.target, ast.Name):
        return set()
    loop_var = stmt.target.id
    out = set()
    for body_stmt in stmt.body:
        eff = _stmt_effects(body_stmt)
        out.update(i for (name, i) in eff.released if name == loop_var)
    return out


def _check_fn(fn, qual: str, path: str) -> list[Finding]:
    cfg = build_cfg(fn)
    found: dict = {}  # (line, col, message) -> Finding

    def emit(line, col, message):
        key = (line, col, message)
        if key not in found:
            found[key] = Finding(rule=RULE, path=path, line=line, col=col,
                                 message=message)

    effects_cache: dict = {}

    def effects(node):
        eff = effects_cache.get(node.idx)
        if eff is None:
            eff = _stmt_effects(node.stmt)
            effects_cache[node.idx] = eff
        return eff

    def transfer(node, state, label):
        if node.kind in ("entry", "exit", "raise_exit", "except", "finally"):
            return state
        if node.kind == "branch":
            killed = _narrow_killed(node.stmt.test, label) \
                if isinstance(node.stmt, (ast.If, ast.While)) else frozenset()
            if not killed:
                return state
            return frozenset(t for t in state if t[0] not in killed)
        if node.kind == "for":
            stmt = node.stmt
            out = set(state)
            rel_specs = _for_element_release(stmt)
            if isinstance(stmt.iter, ast.Name):
                it = stmt.iter.id
                # element-wise release, or iteration = use we can't
                # follow: either way the collection token goes away
                out = {t for t in out if t[0] != it}
            targets = {n.id for n in ast.walk(stmt.target)
                       if isinstance(n, ast.Name)}
            out = {t for t in out if t[0] not in targets}
            _ = rel_specs
            return frozenset(out)
        if node.kind == "with":
            out = set(state)
            for item in node.stmt.items:
                if isinstance(item.context_expr, ast.Name):
                    # ``with x:`` — the context manager owns shutdown
                    out = {t for t in out if t[0] != item.context_expr.id}
                if item.optional_vars is not None:
                    names = {n.id for n in ast.walk(item.optional_vars)
                             if isinstance(n, ast.Name)}
                    out = {t for t in out if t[0] not in names}
            return frozenset(out)

        # stmt / return / raise
        eff = effects(node)
        out = set(state)
        if eff.released:
            out = {t for t in out if (t[0], t[1]) not in eff.released}
        if eff.escaped:
            out = {t for t in out
                   if not (SPECS[t[1]].escapes and t[0] in eff.escaped)}
        if isinstance(node.stmt, ast.Assert) and label == "exc":
            # the assert names the resource: on the failure edge the
            # guarded value was falsy/None — nothing was held
            out = {t for t in out if t[0] not in eff.assert_names}
            return frozenset(out)
        if eff.bound:
            for t in list(out):
                if t[0] in eff.bound:
                    emit(t[2], t[3],
                         f"in {qual}(): '{t[0]}' is rebound while still "
                         f"holding {SPECS[t[1]].name} acquired here")
                    out.discard(t)
        if label != "exc":
            for (target, spec_i, line, col) in eff.acquired:
                out = {t for t in out if t[0] != target}
                out.add((target, spec_i, line, col, False))
        if node.kind == "raise" and label == "exc":
            out = {(v, s, ln, c, True) for (v, s, ln, c, _) in out}
        return frozenset(out)

    states = forward_dataflow(cfg, init=frozenset(), transfer=transfer,
                              join=lambda a, b: a | b)

    for var, spec_i, line, col, _raised in states.get(cfg.exit, frozenset()):
        emit(line, col,
             f"in {qual}(): {SPECS[spec_i].name} acquired into '{var}' can "
             "reach function exit without release or ownership transfer")
    for var, spec_i, line, col, raised in states.get(cfg.raise_exit,
                                                     frozenset()):
        if raised:
            emit(line, col,
                 f"in {qual}(): {SPECS[spec_i].name} acquired into '{var}' "
                 "leaks when a raise propagates out of the function")

    # acquire whose result is discarded: nothing can ever release it
    seen_discard: set = set()
    for node in cfg.nodes:
        if node.kind != "stmt" or not isinstance(node.stmt, ast.Expr):
            continue
        value = node.stmt.value
        if not isinstance(value, ast.Call):
            continue
        spec_i = _acquire_spec(value)
        if spec_i is None or SPECS[spec_i].mode != "result" \
                or not SPECS[spec_i].flag_discard:
            continue
        key = (value.lineno, value.col_offset)
        if key in seen_discard:
            continue  # finally-body copies share statements
        seen_discard.add(key)
        emit(value.lineno, value.col_offset,
             f"in {qual}(): result of {dotted(value.func)}() "
             f"({SPECS[spec_i].name}) is discarded — an unbound acquire "
             "can never be released")

    return list(found.values())


@rule(RULE)
def check_resource_leaks(module: ParsedModule, ctx: RepoContext):
    quals = qualnames(module.tree)
    out: list[Finding] = []
    for fn in walk_functions(module.tree):
        out.extend(_check_fn(fn, quals.get(fn, fn.name), module.path))
    return out
