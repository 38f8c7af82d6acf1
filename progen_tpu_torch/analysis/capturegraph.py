"""Shared AST machinery for the port's graftcheck rules.

The counterpart of ``progen_tpu/analysis/jaxgraph.py``.  Its
framework-neutral helpers (:func:`dotted`, :func:`call_name`,
:func:`unwrap_partial`, :func:`target_simple_name`,
:func:`walk_functions`, :func:`qualnames`) are copied from there
unchanged.  Its ``TraceGraph`` (the functions reachable from a
``jit``/``scan``/``pallas_call`` root) has a counterpart here,
:class:`CaptureGraph`: the functions reachable from a CUDA-graph capture.
Its ``StaticEnv`` serves only the Pallas index-map rule, which has no
subject in the port, and is not copied.

A capture records a body once and replays what it launched: the host code
in it runs once, at capture time.  A ``print`` or a clock read there is a
constant on every replay, and a host sync (``.item()``, ``.cpu()``)
breaks the capture on the card, while on the CPU, where
``CapturedProgram`` calls the body eagerly (``decode/graphs.py``), it
runs silently.  So the captured bodies are found statically.

Roots are of two kinds:

* a callable handed to a capture API (:data:`CAPTURE_APIS`, first
  argument): ``CapturedProgram(fn, ...)``.  The callable is followed
  through a parameter it was forwarded by (the engine's local
  ``capture(key, body, *args)`` hands ``body`` on; each call site's
  argument is a root), through ``self.X`` attributes bound in the class
  (``self._admit = self._admit_impl``), and through a factory whose
  returned inner ``def`` is the body (``CapturedProgram(optimizer_step(
  state), ...)``);
* the statements under ``with torch.cuda.graph(...)``: a region, captured
  as it stands; the functions it calls are captured too, but a region is
  no callable and so no root.

Like ``TraceGraph``, the graph is per module and under-approximates: a
call into another module is not followed, and a name it cannot resolve
reaches nothing.
"""

from __future__ import annotations

import ast
import functools
from typing import Iterable

FuncDef = ast.FunctionDef | ast.AsyncFunctionDef


# ---------------------------------------------------------------------------
# copied from progen_tpu/analysis/jaxgraph.py
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> str | None:
    """``Name``/``Attribute`` chain -> dotted string, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted(node.func)


def unwrap_partial(node: ast.AST) -> ast.AST:
    """``functools.partial(f, ...)`` / ``partial(f, ...)`` -> ``f``."""
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in ("partial", "functools.partial") and node.args:
            return unwrap_partial(node.args[0])
    return node


def target_simple_name(node: ast.AST) -> str | None:
    """Simple name a callable expression refers to within this module.

    ``f`` -> ``f``; ``self._step`` / ``cls._step`` -> ``_step`` (methods are
    resolved by simple name); dotted module refs (``jax.random.split``) -> None.
    """
    node = unwrap_partial(node)
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id in ("self", "cls"):
            return node.attr
    return None


def walk_functions(tree: ast.Module) -> Iterable[FuncDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def qualnames(tree: ast.Module) -> dict[FuncDef, str]:
    """Map every function def to its dotted qualname (``Class.method``)."""
    out: dict[FuncDef, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out[child] = q
                visit(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


# every rule of a module asks for its qualnames, and the wire rules for
# those of the counterpart files: compute each tree's once (no caller
# mutates the map)
qualnames = functools.lru_cache(maxsize=32)(qualnames)


# ---------------------------------------------------------------------------
# the capture graph
# ---------------------------------------------------------------------------

# calls whose first argument is recorded as a CUDA graph's body
CAPTURE_APIS = frozenset({
    "CapturedProgram",
    "graphs.CapturedProgram",
    "torch.cuda.make_graphed_callables",
})

# context managers whose body is recorded as it runs
GRAPH_CONTEXTS = frozenset({"torch.cuda.graph", "cuda.graph"})


def own_nodes(fn: ast.AST) -> list[ast.AST]:
    """Every node of ``fn``'s body, without descending into nested defs
    and classes (they are functions of their own)."""
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _params(fn: FuncDef) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args)]


def _callable_values(expr: ast.AST) -> list[ast.AST]:
    """The callables an assigned expression may hold: both arms of
    ``a if c else b``."""
    if isinstance(expr, ast.IfExp):
        return _callable_values(expr.body) + _callable_values(expr.orelse)
    return [expr]


class CaptureGraph:
    """Per-module set of function defs reachable from a CUDA-graph
    capture.  ``roots``: each captured callable, by its name at the
    capture (``ServingEngine._admit``, or the qualname of a factory's
    returned body), and the defs it resolves to; ``regions``: the
    ``with torch.cuda.graph(...)`` statements; ``captured``: every def
    reachable from either."""

    def __init__(self, tree: ast.Module):
        self.quals = qualnames(tree)
        self.parent: dict[FuncDef, FuncDef | None] = {}
        self.cls: dict[FuncDef, str | None] = {}
        self.nested: dict[FuncDef | None, dict[str, FuncDef]] = {None: {}}
        self.methods: dict[str, dict[str, FuncDef]] = {}
        self.attr_binds: dict[tuple[str, str], list] = {}
        self._tree = tree
        self._own: dict = {}
        self._binds: dict = {}
        self._calls: list | None = None
        self._index(tree)
        self.roots: dict[str, set[FuncDef]] = {}
        # ``(with statement, the function it is in)``
        self.regions: list[tuple[ast.With, FuncDef | None]] = []
        self._find_roots()
        self.captured: set[FuncDef] = self._propagate()

    # -- indexing ------------------------------------------------------------

    def _index(self, tree: ast.Module) -> None:
        def visit(node, fn, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.parent[child] = fn
                    self.cls[child] = cls
                    if fn is None and cls is not None:
                        self.methods.setdefault(cls, {})[child.name] = child
                    else:
                        self.nested.setdefault(fn, {})[child.name] = child
                    self.nested.setdefault(child, {})
                    visit(child, child, cls if fn is None else None)
                elif isinstance(child, ast.ClassDef):
                    if fn is None:
                        visit(child, None, child.name)
                else:
                    visit(child, fn, cls)

        visit(tree, None, None)
        # ``self.X = <callable>`` in any method: what ``self.X`` may call
        for fn, cls in self.cls.items():
            if cls is None:
                continue
            for node in self._nodes(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        self.attr_binds.setdefault((cls, t.attr), []).extend(
                            (v, fn) for v in _callable_values(node.value))

    def _enclosing(self, fn: FuncDef | None):
        while fn is not None:
            yield fn
            fn = self.parent.get(fn)

    def _method_class(self, fn: FuncDef | None) -> str | None:
        """The class of the method ``fn`` is, or is nested in."""
        for f in self._enclosing(fn):
            if self.cls.get(f) is not None:
                return self.cls[f]
        return None

    # -- resolution ----------------------------------------------------------

    def _nodes(self, fn: FuncDef | None) -> list[ast.AST]:
        """``own_nodes`` of ``fn`` (of the module for None), cached."""
        if fn not in self._own:
            self._own[fn] = own_nodes(fn if fn is not None else self._tree)
        return self._own[fn]

    def resolve(self, expr: ast.AST, ctx: FuncDef | None, *,
                forward: bool = True, _seen: set | None = None) -> set[FuncDef]:
        """The defs of this module that the callable ``expr``, evaluated
        in function ``ctx``, may be.  ``forward``: follow a parameter to
        what its callers pass."""
        seen = set() if _seen is None else _seen
        key = (id(expr), id(ctx))
        if key in seen:
            return set()
        seen.add(key)
        expr = unwrap_partial(expr)
        if isinstance(expr, ast.Name):
            kind, what, where = self._lookup(expr.id, ctx)
            if kind == "param":
                out: set[FuncDef] = set()
                for arg, caller in (self._forwarded_args(what, expr.id)
                                    if forward else ()):
                    out |= self.resolve(arg, caller, _seen=seen)
                return out
            if kind == "bound":
                return self.resolve(what, where, forward=forward, _seen=seen)
            return {what} if kind == "def" else set()
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
                and expr.value.id in ("self", "cls"):
            cls = self._method_class(ctx)
            if cls is None:
                return set()
            method = self.methods.get(cls, {}).get(expr.attr)
            if method is not None:
                return {method}
            out = set()
            for value, where in self.attr_binds.get((cls, expr.attr), ()):
                out |= self.resolve(value, where, forward=forward, _seen=seen)
            return out
        if isinstance(expr, ast.Call):
            # a factory call: the inner defs the factory returns
            out = set()
            for factory in self.resolve(expr.func, ctx, forward=forward,
                                        _seen=seen):
                out |= self._returned_defs(factory)
            return out
        return set()

    def _lookup(self, name: str, ctx: FuncDef | None):
        """What ``name`` means in ``ctx``, scope by scope outwards:
        ``("param", f, None)``, ``("def", fn, None)``, ``("bound", value,
        f)`` for a single local assignment, or ``(None, None, None)``."""
        for f in self._enclosing(ctx):
            if name in _params(f) or name in (p.arg for p in f.args.kwonlyargs):
                return "param", f, None
            if name in self.nested.get(f, {}):
                return "def", self.nested[f][name], None
            bound = self._local_binding(f, name)
            if bound is not None:
                return "bound", bound, f
        top = self.nested[None].get(name)
        return ("def", top, None) if top is not None else (None, None, None)

    def _local_binding(self, fn: FuncDef, name: str) -> ast.AST | None:
        """The value of a single plain ``name = value`` in ``fn``, if it
        is bound exactly once there."""
        if fn not in self._binds:
            binds: dict[str, list] = {}
            for node in self._nodes(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    binds.setdefault(node.targets[0].id, []).append(node.value)
            self._binds[fn] = binds
        values = self._binds[fn].get(name, ())
        return values[0] if len(values) == 1 else None

    def _returned_defs(self, factory: FuncDef) -> set[FuncDef]:
        out = set()
        inner = self.nested.get(factory, {})
        for node in self._nodes(factory):
            if isinstance(node, ast.Return) and isinstance(node.value, ast.Name) \
                    and node.value.id in inner:
                out.add(inner[node.value.id])
        return out

    def _call_sites(self, target: FuncDef):
        """``(call, ctx)`` for every call in this module whose callee
        resolves to ``target`` (a parameter called is not followed)."""
        if self._calls is None:
            self._calls = [
                (node, fn, self.resolve(node.func, fn, forward=False))
                for fn in [None, *self.parent] for node in self._nodes(fn)
                if isinstance(node, ast.Call)]
        return [(call, fn) for call, fn, defs in self._calls if target in defs]

    def _forwarded_args(self, fn: FuncDef, param: str):
        """``(argument, caller)`` for what each call of ``fn`` passes as
        ``param``: the parameter forwards the callable on."""
        names = _params(fn)
        pos = names.index(param) if param in names else None
        if pos is not None and self.cls.get(fn) is not None \
                and names[0] in ("self", "cls"):
            pos -= 1
        for call, caller in self._call_sites(fn):
            arg = None
            if pos is not None and pos < len(call.args) and not any(
                    isinstance(a, ast.Starred) for a in call.args[:pos + 1]):
                arg = call.args[pos]
            for kw in call.keywords:
                if kw.arg == param:
                    arg = kw.value
            if arg is not None:
                yield arg, caller

    # -- roots ---------------------------------------------------------------

    def _display(self, expr: ast.AST, ctx: FuncDef | None,
                 defs: set[FuncDef]) -> str:
        expr = unwrap_partial(expr)
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
                and expr.value.id in ("self", "cls"):
            cls = self._method_class(ctx)
            if cls is not None:
                return f"{cls}.{expr.attr}"
        return " | ".join(sorted(self.quals[d] for d in defs))

    def _find_roots(self) -> None:
        for fn in [None, *self.parent]:
            for node in self._nodes(fn):
                if isinstance(node, ast.Call) and node.args \
                        and call_name(node) in CAPTURE_APIS:
                    self._add_root(node.args[0], fn, set())
                elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                        isinstance(item.context_expr, ast.Call)
                        and call_name(item.context_expr) in GRAPH_CONTEXTS
                        for item in node.items):
                    self.regions.append((node, fn))

    def _add_root(self, expr: ast.AST, ctx: FuncDef | None, seen: set) -> None:
        if (id(expr), id(ctx)) in seen:
            return
        seen.add((id(expr), id(ctx)))
        expr = unwrap_partial(expr)
        if isinstance(expr, ast.Name):
            kind, owner, _ = self._lookup(expr.id, ctx)
            if kind == "param":
                # a parameter forwarded to the capture: each call site's
                # argument is a root
                for arg, caller in self._forwarded_args(owner, expr.id):
                    self._add_root(arg, caller, seen)
                return
        defs = self.resolve(expr, ctx)
        if defs:
            self.roots.setdefault(self._display(expr, ctx, defs),
                                  set()).update(defs)

    # -- propagation ---------------------------------------------------------

    def _callees(self, nodes, ctx: FuncDef | None) -> set[FuncDef]:
        out: set[FuncDef] = set()
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            out |= self.resolve(node.func, ctx)
            # a def handed to a call runs where the call runs
            for arg in (*node.args, *(kw.value for kw in node.keywords)):
                if isinstance(arg, (ast.Name, ast.Attribute)):
                    out |= self.resolve(arg, ctx)
        return out

    @staticmethod
    def region_nodes(region: ast.With) -> list[ast.AST]:
        """Every node of a region's body (nested defs excluded)."""
        return [n for stmt in region.body for n in (stmt, *own_nodes(stmt))]

    def _propagate(self) -> set[FuncDef]:
        work: list[FuncDef] = [d for defs in self.roots.values() for d in defs]
        for region, ctx in self.regions:
            work.extend(self._callees(self.region_nodes(region), ctx))
        captured: set[FuncDef] = set()
        while work:
            fn = work.pop()
            if fn in captured:
                continue
            captured.add(fn)
            work.extend(self._callees(self._nodes(fn), fn))
        return captured


_LAST: list = [None, None]  # (tree, graph): the rules of one module share it


def capture_graph(tree: ast.Module) -> CaptureGraph:
    """The :class:`CaptureGraph` of ``tree``, built once for all the
    rules that check the module."""
    if _LAST[0] is not tree:
        _LAST[:] = [tree, CaptureGraph(tree)]
    return _LAST[1]
