"""Rules ``kernel-status`` and ``kernel-fallback``: the port's kernel
hygiene.

The counterpart of ``progen_tpu/analysis/rules_pallas.py``'s class.  The
Pallas rules have no subject here (no ``BlockSpec``, no refs); the port's
kernels are CUDA C++ behind ctypes (``ops/cuda_*.py``), and two things go
wrong at their launch sites that no CPU test can see.

A launch is a call that hands the kernel a CUDA stream: an argument that
is ``torch.cuda.current_stream(...).cuda_stream``, or a name (or a
``*args`` tuple) bound from an expression holding one.

``kernel-status``: a kernel function returns its ``cudaError``; a launch
whose status is dropped fails silently and leaves its output buffer as
``torch.empty`` made it.  The status must be checked and raised on:

    err = fn(..., stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")

or handed to a checker (``check(fn(...))``) or returned to the caller.

``kernel-fallback``: the port never falls back.  A ``try`` around a
launch (or around a call of a kernel wrapper, ``cuda_*.fn(...)``, or of a
function of this module that launches) whose handler calls the plain
twin (``plain.*``, ``plain_*``), returns, or swallows the error without
raising, turns a kernel fault into a silent change of route — the tests
and the chip smoke then pass on a kernel that never ran.
"""

from __future__ import annotations

import ast

from progen_tpu_torch.analysis.capturegraph import (
    dotted, own_nodes, target_simple_name, walk_functions)
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule


def _holds_stream(node: ast.AST, names: set[str]) -> bool:
    """``x.cuda_stream``, a stream name, or a tuple or list holding one."""
    if isinstance(node, ast.Starred):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr == "cuda_stream":
        return True
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_holds_stream(e, names) for e in node.elts)
    return False


def _stream_names(fn: ast.AST) -> set[str]:
    """Names bound in ``fn`` to a CUDA stream, or to a tuple of launch
    arguments holding one (``args = (..., stream)``)."""
    assigns = [n for n in own_nodes(fn) if isinstance(n, ast.Assign)]
    names: set[str] = set()
    while True:
        found = {t.id for node in assigns if _holds_stream(node.value, names)
                 for target in node.targets for t in ast.walk(target)
                 if isinstance(t, ast.Name)}
        if found <= names:
            return names
        names |= found


def _is_launch(call: ast.Call, streams: set[str]) -> bool:
    return any(isinstance(arg, (ast.Starred, ast.Attribute, ast.Name))
               and _holds_stream(arg, streams)
               for arg in (*call.args, *(kw.value for kw in call.keywords)))


def _launches(fn: ast.AST) -> list[ast.Call]:
    streams = _stream_names(fn)
    return [n for n in own_nodes(fn)
            if isinstance(n, ast.Call) and _is_launch(n, streams)]


def _label(call: ast.Call) -> str:
    return dotted(call.func) or "kernel"


def _is_checker(call: ast.Call) -> bool:
    name = dotted(call.func) or ""
    return "check" in name.rsplit(".", 1)[-1].lower()


def _raises(stmts) -> bool:
    return any(isinstance(n, ast.Raise)
               for s in stmts for n in (s, *own_nodes(s)))


def _mentions(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name for n in ast.walk(node))


def _status_checked(fn: ast.AST, name: str, after: int) -> bool:
    """Is the status bound to ``name`` (at line ``after``) tested by an
    ``if`` that raises, handed to a checker, or returned?"""
    for node in own_nodes(fn):
        if getattr(node, "lineno", 0) < after:
            continue
        if isinstance(node, (ast.If, ast.While)) and _mentions(node.test, name) \
                and _raises(node.body):
            return True
        if isinstance(node, ast.Call) and _is_checker(node) and any(
                _mentions(a, name) for a in node.args):
            return True
        if isinstance(node, ast.Return) and node.value is not None \
                and _mentions(node.value, name):
            return True
    return False


@rule("kernel-status")
def check_status(module: ParsedModule, ctx: RepoContext):
    if "cuda_stream" not in module.source:
        return  # no stream taken, so no launch
    for fn in walk_functions(module.tree):
        launches = _launches(fn)
        if not launches:
            continue
        parent = {}
        for node in own_nodes(fn):
            for child in ast.iter_child_nodes(node):
                parent[child] = node
        for call in launches:
            up = parent.get(call)
            message = None
            if isinstance(up, ast.Expr):
                message = (f"kernel launch '{_label(call)}' drops the "
                           "cudaError it returns")
            elif isinstance(up, ast.Assign):
                names = [t.id for t in up.targets if isinstance(t, ast.Name)]
                if len(names) != 1 or names[0] == "_" \
                        or names[0].startswith("_unused"):
                    message = (f"kernel launch '{_label(call)}' drops the "
                               "cudaError it returns")
                elif not _status_checked(fn, names[0], up.lineno):
                    message = (f"the cudaError of kernel launch "
                               f"'{_label(call)}' bound to '{names[0]}' is "
                               "never checked")
            elif isinstance(up, ast.Call) and _is_checker(up):
                pass
            elif isinstance(up, (ast.Return, ast.Lambda)):
                pass  # handed on to the caller
            else:
                stmt = up
                while stmt is not None and not isinstance(stmt, ast.stmt):
                    stmt = parent.get(stmt)
                if not (isinstance(stmt, (ast.If, ast.While))
                        and _raises(stmt.body)):
                    message = (f"the cudaError of kernel launch "
                               f"'{_label(call)}' is never checked")
            if message:
                yield Finding(
                    rule="kernel-status", path=module.path,
                    line=call.lineno, col=call.col_offset,
                    message=f"{message} in {fn.name}(): a failed launch "
                            "leaves its output unwritten; raise on a "
                            "nonzero status")


def _is_plain(call: ast.Call) -> bool:
    name = dotted(call.func) or ""
    return any(part.lstrip("_").startswith("plain") for part in name.split("."))


def _kernel_call(call: ast.Call, streams: set[str], launchers: set[str]) -> bool:
    name = dotted(call.func) or ""
    return (_is_launch(call, streams)
            or any(part.startswith("cuda_") for part in name.split(".")[:-1])
            or target_simple_name(call.func) in launchers)


@rule("kernel-fallback")
def check_fallback(module: ParsedModule, ctx: RepoContext):
    if "cuda_" not in module.source:
        return  # no stream taken and no wrapper called, so no launch
    launches = "cuda_stream" in module.source
    launchers = {fn.name for fn in walk_functions(module.tree)
                 if launches and _launches(fn)}
    for scope in [module.tree, *walk_functions(module.tree)]:
        streams = (_stream_names(scope) if launches and scope is not module.tree
                   else set())
        for node in own_nodes(scope):
            if not isinstance(node, ast.Try):
                continue
            body = [n for s in node.body for n in (s, *own_nodes(s))]
            if not any(isinstance(n, ast.Call)
                       and _kernel_call(n, streams, launchers) for n in body):
                continue
            for handler in node.handlers:
                nodes = [n for s in handler.body for n in (s, *own_nodes(s))]
                plain = next((n for n in nodes if isinstance(n, ast.Call)
                              and _is_plain(n)), None)
                if plain is not None:
                    why = f"calls the plain twin '{dotted(plain.func)}'"
                elif any(isinstance(n, ast.Return) for n in nodes):
                    why = "returns"
                elif not _raises(handler.body):
                    why = "swallows the error"
                else:
                    continue
                yield Finding(
                    rule="kernel-fallback", path=module.path,
                    line=handler.lineno, col=handler.col_offset,
                    message=f"an exception handler around a kernel launch "
                            f"{why}: the port never falls back from a "
                            "kernel; let the fault raise")
