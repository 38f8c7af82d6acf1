"""Copied verbatim from ``progen_tpu/analysis/cfg.py``.

Intraprocedural control-flow graphs + a generic forward dataflow
fixpoint, pure stdlib — the path-sensitive substrate under the lifecycle
rules (``rules_lifecycle``).

One :class:`CFG` per function.  Nodes are *simple statements* (one node
per assign/expr/return/...), plus synthetic nodes:

* ``entry`` / ``exit`` — function entry and *normal* exit (every
  ``return`` and body fall-through reaches ``exit``);
* ``raise_exit`` — exceptional exit: exceptions that escape the
  function, explicit or implicit, land here;
* ``branch`` — the test of an ``if``/``while`` (``stmt`` is the
  ``ast.If``/``ast.While``, out-edges are labelled ``true``/``false``);
* ``for`` — a ``for`` head (``true`` = the iterator yielded, ``false``
  = exhausted);
* ``except`` — an ``except`` clause head (entered via ``exc`` edges).

Edge labels: ``norm`` (sequencing), ``true``/``false`` (branch
outcomes), ``exc`` (exception propagation — from any statement that can
raise to the enclosing handlers and, because a typed handler may not
match, onward to ``raise_exit``).

``try``/``finally`` is modelled by *instantiating* the ``finally`` body
once per distinct continuation (fall-through, return, break, continue,
exception) — the node lists differ but share the same ``ast`` statement
objects, so per-statement analyses behave identically on every copy.
``while True:``-style constant tests drop the dead edge so analyses
don't report along impossible paths.

The fixpoint (:func:`forward_dataflow`) is edge-sensitive: the transfer
function sees ``(node, state, edge_label)`` and can e.g. withhold an
acquisition along the acquiring statement's own ``exc`` edge, or narrow
``x is None`` facts along ``true``/``false``.  States must be hashable
values with equality; ``join`` must be monotone for termination.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Iterable

__all__ = ["CFG", "Node", "build_cfg", "forward_dataflow"]

FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

# statement types that get their own node and cannot raise by themselves
_SIMPLE = (
    ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr, ast.Pass,
    ast.Delete, ast.Global, ast.Nonlocal, ast.Import, ast.ImportFrom,
    ast.Assert, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
)

_CATCH_ALL = {"Exception", "BaseException"}


@dataclasses.dataclass
class Node:
    idx: int
    kind: str  # entry|exit|raise_exit|stmt|branch|for|with|except|return|raise
    stmt: ast.stmt | None = None

    @property
    def line(self) -> int:
        return getattr(self.stmt, "lineno", 0)


class CFG:
    def __init__(self, fn):
        self.fn = fn
        self.nodes: list[Node] = []
        self.succ: dict[int, list[tuple[int, str]]] = {}
        self.entry = self._new("entry")
        self.exit = self._new("exit")
        self.raise_exit = self._new("raise_exit")

    def _new(self, kind: str, stmt: ast.stmt | None = None) -> int:
        n = Node(len(self.nodes), kind, stmt)
        self.nodes.append(n)
        return n.idx

    def _edge(self, src: int, dst: int, label: str = "norm") -> None:
        edges = self.succ.setdefault(src, [])
        if (dst, label) not in edges:
            edges.append((dst, label))

    # -- queries (unit tests assert against these) -------------------------

    def node(self, idx: int) -> Node:
        return self.nodes[idx]

    def successors(self, idx: int) -> list[tuple[int, str]]:
        return list(self.succ.get(idx, ()))

    def nodes_for_line(self, lineno: int) -> list[Node]:
        """Every node whose statement starts on ``lineno`` — a finally
        body statement appears once per instantiated continuation."""
        return [n for n in self.nodes if n.stmt is not None
                and n.stmt.lineno == lineno]

    def reachable_from(self, idx: int, *, labels: set[str] | None = None
                       ) -> set[int]:
        seen, stack = set(), [idx]
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            for dst, label in self.succ.get(n, ()):
                if labels is None or label in labels:
                    stack.append(dst)
        return seen


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Frame:
    """One level of enclosing control context, innermost last."""

    kind: str  # "loop" | "try"
    # loop
    head: int = -1
    breaks: list = dataclasses.field(default_factory=list)
    is_for: bool = False
    # try
    handler_heads: tuple = ()
    catch_all: bool = False
    finalbody: tuple = ()
    section: str = "body"  # which part of the try is being built
    fin_cache: dict = dataclasses.field(default_factory=dict)


def _may_raise(stmt: ast.stmt) -> bool:
    """Conservative 'this statement can raise': it contains a call (or is
    an assert).  Attribute/subscript errors are deliberately ignored —
    treating every expression as throwing would drown real error-path
    findings in impossible ones."""
    if isinstance(stmt, (ast.Assert, ast.Raise)):
        return True
    for sub in ast.walk(stmt):
        if isinstance(sub, ast.Call):
            return True
        if isinstance(sub, (ast.Await, ast.Yield, ast.YieldFrom)):
            return True
    return False


def _const_test(test: ast.expr):
    """Constant-valued branch test -> its truthiness, else None."""
    if isinstance(test, ast.Constant):
        return bool(test.value)
    return None


class _Builder:
    def __init__(self, fn):
        self.cfg = CFG(fn)

    def build(self) -> CFG:
        dangling = self._body(self.cfg.fn.body, [(self.cfg.entry, "norm")], [])
        self._connect(dangling, self.cfg.exit)
        return self.cfg

    # -- plumbing ----------------------------------------------------------

    def _connect(self, preds: list[tuple[int, str]], dst: int) -> None:
        for src, label in preds:
            self.cfg._edge(src, dst, label)

    def _route(self, preds, frames, purpose) -> None:
        """Send ``preds`` out of the frame stack: through every enclosing
        ``finally`` to the purpose's destination (exit / loop head / loop
        break / handlers+raise_exit)."""
        for i in range(len(frames) - 1, -1, -1):
            fr = frames[i]
            if fr.kind == "loop" and purpose[0] in ("break", "continue") \
                    and fr is purpose[1]:
                if purpose[0] == "break":
                    fr.breaks.extend(preds)
                else:
                    self._connect(preds, fr.head)
                return
            if fr.kind != "try":
                continue
            if purpose[0] == "exc" and fr.section == "body" \
                    and fr.handler_heads:
                for h in fr.handler_heads:
                    self._connect(preds, h)
                if fr.catch_all:
                    return
                # a typed handler may not match: keep propagating
                preds = [(src, "exc") for src, _ in preds]
            if fr.finalbody:
                head = self._finally_instance(frames, i, purpose)
                self._connect(preds, head)
                return
        if purpose[0] == "exc":
            self._connect(preds, self.cfg.raise_exit)
        else:
            self._connect(preds, self.cfg.exit)

    def _finally_instance(self, frames, i, purpose) -> int:
        """Shared copy of ``frames[i]``'s finally body for ``purpose``;
        its own exit continues routing outward past frame ``i``."""
        fr = frames[i]
        key = (purpose[0], id(purpose[1]) if len(purpose) > 1 else None)
        if key in fr.fin_cache:
            return fr.fin_cache[key]
        head = self.cfg._new("finally", None)
        fr.fin_cache[key] = head
        outer = frames[:i]
        dangling = self._body(list(fr.finalbody), [(head, "norm")], outer)
        self._route(dangling, outer, purpose)
        return head

    # -- statement sequencing ----------------------------------------------

    def _body(self, stmts, preds, frames) -> list[tuple[int, str]]:
        for stmt in stmts:
            preds = self._stmt(stmt, preds, frames)
            if not preds:
                break  # everything below is unreachable
        return preds

    def _stmt(self, stmt, preds, frames) -> list[tuple[int, str]]:
        if isinstance(stmt, ast.If):
            return self._if(stmt, preds, frames)
        if isinstance(stmt, ast.While):
            return self._while(stmt, preds, frames)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._for(stmt, preds, frames)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, preds, frames)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, preds, frames)
        if isinstance(stmt, ast.Match):
            return self._match(stmt, preds, frames)
        if isinstance(stmt, ast.Return):
            node = self.cfg._new("return", stmt)
            self._connect(preds, node)
            self._exc(node, stmt, frames)
            self._route([(node, "norm")], frames, ("return",))
            return []
        if isinstance(stmt, ast.Raise):
            node = self.cfg._new("raise", stmt)
            self._connect(preds, node)
            self._route([(node, "exc")], frames, ("exc",))
            return []
        if isinstance(stmt, ast.Break):
            node = self.cfg._new("stmt", stmt)
            self._connect(preds, node)
            loop = self._innermost_loop(frames)
            self._route([(node, "norm")], frames, ("break", loop))
            return []
        if isinstance(stmt, ast.Continue):
            node = self.cfg._new("stmt", stmt)
            self._connect(preds, node)
            loop = self._innermost_loop(frames)
            self._route([(node, "norm")], frames, ("continue", loop))
            return []
        # simple statement
        node = self.cfg._new("stmt", stmt)
        self._connect(preds, node)
        return self._stmt_node(stmt, node, frames)

    def _stmt_node(self, stmt, node, frames) -> list[tuple[int, str]]:
        self._exc(node, stmt, frames)
        return [(node, "norm")]

    def _exc(self, node, stmt, frames) -> None:
        if _may_raise(stmt):
            self._route([(node, "exc")], frames, ("exc",))

    @staticmethod
    def _innermost_loop(frames) -> _Frame:
        for fr in reversed(frames):
            if fr.kind == "loop":
                return fr
        raise AssertionError("break/continue outside loop")

    # -- compound statements ----------------------------------------------

    def _if(self, stmt, preds, frames):
        node = self.cfg._new("branch", stmt)
        self._connect(preds, node)
        self._exc(node, ast.Expr(value=stmt.test), frames)
        const = _const_test(stmt.test)
        out = []
        if const is not False:
            out.extend(self._body(stmt.body, [(node, "true")], frames))
        if const is not True:
            if stmt.orelse:
                out.extend(self._body(stmt.orelse, [(node, "false")], frames))
            else:
                out.append((node, "false"))
        return out

    def _while(self, stmt, preds, frames):
        node = self.cfg._new("branch", stmt)
        self._connect(preds, node)
        self._exc(node, ast.Expr(value=stmt.test), frames)
        fr = _Frame(kind="loop", head=node)
        const = _const_test(stmt.test)
        if const is not False:
            back = self._body(stmt.body, [(node, "true")], frames + [fr])
            self._connect(back, node)
        out = list(fr.breaks)
        if const is not True:
            if stmt.orelse:
                out.extend(self._body(stmt.orelse, [(node, "false")], frames))
            else:
                out.append((node, "false"))
        return out

    def _for(self, stmt, preds, frames):
        node = self.cfg._new("for", stmt)
        self._connect(preds, node)
        self._exc(node, ast.Expr(value=stmt.iter), frames)
        fr = _Frame(kind="loop", head=node, is_for=True)
        back = self._body(stmt.body, [(node, "true")], frames + [fr])
        self._connect(back, node)
        out = list(fr.breaks)
        if stmt.orelse:
            out.extend(self._body(stmt.orelse, [(node, "false")], frames))
        else:
            out.append((node, "false"))
        return out

    def _with(self, stmt, preds, frames):
        node = self.cfg._new("with", stmt)
        self._connect(preds, node)
        self._exc(node, stmt, frames)  # entering may raise
        return self._body(stmt.body, [(node, "norm")], frames)

    def _match(self, stmt, preds, frames):
        node = self.cfg._new("branch", stmt)
        self._connect(preds, node)
        out = [(node, "false")]  # no case matched
        for case in stmt.cases:
            out.extend(self._body(case.body, [(node, "true")], frames))
        return out

    def _try(self, stmt, preds, frames):
        heads = []
        catch_all = not stmt.handlers  # bare try/finally: nothing caught
        for h in stmt.handlers:
            heads.append(self.cfg._new("except", None))
            if h.type is None:
                catch_all = True
            else:
                name = None
                if isinstance(h.type, (ast.Name, ast.Attribute)):
                    name = h.type.attr if isinstance(h.type, ast.Attribute) \
                        else h.type.id
                if name in _CATCH_ALL:
                    catch_all = True
        fin = tuple(stmt.finalbody)
        fr = _Frame(kind="try", handler_heads=tuple(heads),
                    catch_all=catch_all and bool(stmt.handlers),
                    finalbody=fin)
        body_out = self._body(stmt.body, preds, frames + [fr])
        if stmt.orelse:
            fr.section = "else"
            body_out = self._body(stmt.orelse, body_out, frames + [fr])
        out = list(body_out)
        fr.section = "handler"
        for head, h in zip(heads, stmt.handlers):
            out.extend(self._body(h.body, [(head, "norm")], frames + [fr]))
        if fin:
            if not out:
                return []  # every try path returned/raised: finally
                # copies already exist on those routes
            # normal completion runs its own finally copy, then falls
            # through to whatever follows the try statement
            head = self.cfg._new("finally", None)
            self._connect(out, head)
            return self._body(list(fin), [(head, "norm")], frames)
        return out


def build_cfg(fn) -> CFG:
    """CFG for one ``ast.FunctionDef`` / ``ast.AsyncFunctionDef``."""
    if not isinstance(fn, FuncDef):
        raise TypeError(f"build_cfg wants a function def, got {type(fn)}")
    return _Builder(fn).build()


# ---------------------------------------------------------------------------
# dataflow
# ---------------------------------------------------------------------------


def forward_dataflow(
    cfg: CFG,
    *,
    init,
    transfer: Callable,
    join: Callable,
    max_iter: int = 100_000,
):
    """Forward fixpoint over ``cfg``.

    ``transfer(node, state, label)`` maps the state at a node's entry to
    the state propagated along one labelled out-edge; ``join(a, b)``
    merges states where paths meet.  Returns ``{node_idx: entry_state}``
    for every reached node.  Monotone ``join`` + finite state lattice =>
    termination; ``max_iter`` is a backstop against non-monotone bugs.
    """
    states = {cfg.entry: init}
    work = [cfg.entry]
    iters = 0
    while work:
        iters += 1
        if iters > max_iter:
            raise RuntimeError("dataflow did not converge (non-monotone "
                               "transfer/join?)")
        n = work.pop()
        state = states[n]
        node = cfg.nodes[n]
        for dst, label in cfg.succ.get(n, ()):
            out = transfer(node, state, label)
            old = states.get(dst)
            new = out if old is None else join(old, out)
            if new != old:
                states[dst] = new
                work.append(dst)
    return states


def functions(tree: ast.Module) -> Iterable:
    """All function defs in a module, nested included (mirror of
    ``jaxgraph.walk_functions`` without the import)."""
    for node in ast.walk(tree):
        if isinstance(node, FuncDef):
            yield node
