"""wire-*: serialize/deserialize schema consistency.

Copied from ``progen_tpu/analysis/rules_wire.py``; :data:`WIRE_PAIRS`
names the port's writers and readers, and adds the tensor-parallel
group's slab frames (``split_handle_frame`` and its readers).  One scrape
is new: ``"store:KEY"``, the dict literals a writer stores under
``frame["KEY"]`` (the slab section of a slab frame's header).

The handoff/transport wire protocol is a pile of dict-shaped frames
whose writers and readers live in different processes and different
files — nothing type-checks them against each other.  Three rules close
the loop statically:

* ``wire-dead-field`` — a field the writer emits that no paired reader
  ever looks at (dead payload bytes, or a reader someone forgot);
* ``wire-strict-read`` — a field the writer ELIDES at its default value
  (the "priority omitted when 0" pattern) but a reader indexes strictly
  (``d["priority"]``): works until the first default-valued message;
* ``wire-const-mismatch`` — a MAGIC/VERSION constant bound to
  conflicting values in one module, or pack/unpack struct format
  strings that drifted apart.

Pairs come from two places: a naming convention inside one module
(``X_to_wire``/``X_from_wire``, ``serialize_X``/``deserialize_X``,
``pack_X``/``unpack_X`` — first parameter is the message dict), and the
declarative :data:`WIRE_PAIRS` table for the real fleet protocol whose
writers and readers span files (the table wins where both apply).
Counterpart files are parsed through ``ctx.root`` — AST only, nothing is
imported.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from progen_tpu_torch.analysis.capturegraph import dotted, qualnames, walk_functions
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule

# ---------------------------------------------------------------------------
# pair declarations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WirePair:
    """Writers: ``(relpath, func, scrape)`` where scrape is ``"dicts"``
    (message-dict literals + subscript stores in the function),
    ``"kwarg:NAME"`` (dict literals passed as keyword ``NAME`` — how the
    prefill loop injects routing tags into ``serialize_handle``) or
    ``"store:KEY"`` (dict literals stored as ``frame["KEY"] = {...}``).
    Readers: ``(relpath, func, varname)`` — every subscript/.get on that
    variable in the function counts as a read."""

    name: str
    writers: tuple
    readers: tuple


WIRE_PAIRS: tuple[WirePair, ...] = (
    WirePair(
        "request",
        writers=(("progen_tpu_torch/decode/handoff.py", "request_to_wire",
                  "dicts"),),
        readers=(("progen_tpu_torch/decode/handoff.py", "request_from_wire",
                  "d"),),
    ),
    WirePair(
        "completion",
        writers=(("progen_tpu_torch/serve/worker.py", "_completion_to_wire",
                  "dicts"),),
        readers=(
            ("progen_tpu_torch/serve/cluster.py", "_completion_from_wire",
             "header"),
            ("progen_tpu_torch/serve/cluster.py", "ServeCluster._handle_event",
             "header"),
        ),
    ),
    WirePair(
        "handle-header",
        writers=(
            ("progen_tpu_torch/decode/handoff.py", "serialize_handle",
             "dicts"),
            ("progen_tpu_torch/serve/worker.py", "_prefill_loop",
             "kwarg:extra_header"),
        ),
        readers=(
            ("progen_tpu_torch/decode/handoff.py", "deserialize_handle",
             "header"),
            ("progen_tpu_torch/decode/handoff.py",
             "deserialize_handle_sharded", "header"),
            ("progen_tpu_torch/serve/cluster.py", "ServeCluster._on_handle",
             "header"),
            ("progen_tpu_torch/serve/cluster.py", "ServeCluster._handle_event",
             "header"),
            ("progen_tpu_torch/serve/worker.py", "_decode_loop", "header"),
            ("progen_tpu_torch/serve/worker.py", "_group_decode_loop",
             "header"),
        ),
    ),
    WirePair(
        "slab",
        writers=(("progen_tpu_torch/decode/handoff.py", "split_handle_frame",
                  "store:slab"),),
        readers=(("progen_tpu_torch/decode/handoff.py",
                  "deserialize_handle_sharded", "slab"),),
    ),
)

_CONVENTIONS = (
    (re.compile(r"(.+)_to_wire$"), "{}_from_wire"),
    (re.compile(r"serialize_(.+)$"), "deserialize_{}"),
    (re.compile(r"pack_(.+)$"), "unpack_{}"),
)

_TABLE_FUNCS = {
    (path, func.rsplit(".", 1)[-1])
    for pair in WIRE_PAIRS
    for (path, func, *_rest) in list(pair.writers) + list(pair.readers)
}


# ---------------------------------------------------------------------------
# scraping
# ---------------------------------------------------------------------------


def _nested_walk(fn):
    """Yield ``(node, conditional)`` — conditional means the node sits
    under a branch/loop/try, i.e. the write does not happen on every
    message."""

    def visit(stmts, cond):
        for stmt in stmts:
            yield stmt, cond
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub and isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    inner = cond or not isinstance(stmt, (
                        ast.FunctionDef, ast.AsyncFunctionDef))
                    yield from visit(sub, inner)
            for h in getattr(stmt, "handlers", ()):
                yield from visit(h.body, True)

    yield from visit(fn.body, False)


def _dict_literal_keys(node: ast.Dict):
    for k in node.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            yield k.value, k.lineno, k.col_offset


def scrape_writer(fn, scrape: str = "dicts") -> dict:
    """``{field: (conditional, line, col)}`` the function writes."""
    fields: dict = {}

    def note(key, line, col, cond):
        prev = fields.get(key)
        if prev is None or (prev[0] and not cond):
            fields[key] = (cond, line, col)

    if scrape.startswith("store:"):
        slot = scrape.split(":", 1)[1]
        for stmt, cond in _nested_walk(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Subscript) \
                    and isinstance(stmt.targets[0].slice, ast.Constant) \
                    and stmt.targets[0].slice.value == slot \
                    and isinstance(stmt.value, ast.Dict):
                for key, ln, col in _dict_literal_keys(stmt.value):
                    note(key, ln, col, cond)
        return fields

    if scrape.startswith("kwarg:"):
        kwarg = scrape.split(":", 1)[1]
        for stmt, cond in _nested_walk(fn):
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    for kw in sub.keywords:
                        if kw.arg == kwarg and isinstance(kw.value, ast.Dict):
                            for key, ln, col in _dict_literal_keys(kw.value):
                                note(key, ln, col, cond)
        return fields

    dict_vars: set = set()
    for stmt, cond in _nested_walk(fn):
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Dict) \
                and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            keys = list(_dict_literal_keys(stmt.value))
            if keys:
                dict_vars.add(stmt.targets[0].id)
                for key, ln, col in keys:
                    note(key, ln, col, cond)
        elif isinstance(stmt, ast.Return) and isinstance(stmt.value,
                                                         ast.Dict):
            for key, ln, col in _dict_literal_keys(stmt.value):
                note(key, ln, col, cond)
    for stmt, cond in _nested_walk(fn):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Subscript):
            t = stmt.targets[0]
            if isinstance(t.value, ast.Name) and t.value.id in dict_vars \
                    and isinstance(t.slice, ast.Constant) \
                    and isinstance(t.slice.value, str):
                note(t.slice.value, stmt.lineno, stmt.col_offset, cond)
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "update" \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id in dict_vars \
                    and sub.args and isinstance(sub.args[0], ast.Dict):
                for key, ln, col in _dict_literal_keys(sub.args[0]):
                    note(key, ln, col, cond)
    return fields


def scrape_reader(fn, varnames) -> dict:
    """``{field: (strict, line, col)}`` read off the message variable(s).
    A strict read that is guarded anywhere in the function (``"k" in d``
    or ``d.get("k") is not None``) counts as tolerant."""
    varnames = set(varnames)
    reads: dict = {}
    guards: set = set()

    def note(key, strict, line, col):
        prev = reads.get(key)
        if prev is None or (strict and not prev[0]):
            reads[key] = (strict, line, col)

    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in varnames \
                and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            note(node.slice.value, True, node.lineno, node.col_offset)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            recv, attr = node.func.value, node.func.attr
            if isinstance(recv, ast.Name) and recv.id in varnames \
                    and node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                key = node.args[0].value
                if attr == "get":
                    note(key, False, node.lineno, node.col_offset)
                    guards.add(key)  # d.get("k") is a presence probe too
                elif attr == "pop":
                    note(key, len(node.args) < 2, node.lineno,
                         node.col_offset)
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str):
            comp = node.comparators[0]
            if isinstance(comp, ast.Name) and comp.id in varnames:
                guards.add(node.left.value)
                note(node.left.value, False, node.lineno, node.col_offset)
    return {
        k: (strict and k not in guards, line, col)
        for k, (strict, line, col) in reads.items()
    }


# ---------------------------------------------------------------------------
# counterpart resolution
# ---------------------------------------------------------------------------

_AST_CACHE: dict = {}


def _module_tree(ctx: RepoContext, relpath: str, current: ParsedModule):
    if current.path == relpath:
        return current.tree
    key = (str(ctx.root), relpath)
    if key not in _AST_CACHE:
        path = ctx.root / relpath
        tree = None
        if path.is_file():
            try:
                tree = ast.parse(path.read_text())
            except SyntaxError:
                tree = None
        _AST_CACHE[key] = tree
    return _AST_CACHE[key]


def _find_fn(tree, qual: str):
    if tree is None:
        return None
    quals = qualnames(tree)
    simple = qual.rsplit(".", 1)[-1]
    for fn, q in quals.items():
        if q == qual or (("." not in qual) and q.rsplit(".", 1)[-1] == simple
                         and "." not in q):
            return fn
    for fn, q in quals.items():
        if q.rsplit(".", 1)[-1] == simple:
            return fn
    return None


def _first_param(fn) -> str | None:
    args = [a.arg for a in fn.args.args if a.arg not in ("self", "cls")]
    return args[0] if args else None


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _pair_findings(module, pairname, written, read_union, here_written,
                   here_reads):
    """Findings anchored in the current module for one resolved pair.
    ``here_written`` holds only the fields whose write site is in this
    module — dead-field findings anchor at the write, so fields written
    by a counterpart file are reported when THAT file is checked."""
    out = []
    if read_union is not None:
        for key, (cond, line, col) in sorted(here_written.items()):
            if key not in read_union:
                out.append(Finding(
                    rule="wire-dead-field", path=module.path, line=line,
                    col=col,
                    message=f"wire field '{key}' ({pairname}) is written "
                            "but never read by any paired reader"))
    for key, (strict, line, col) in sorted(here_reads.items()):
        if strict and written.get(key, (False,))[0]:
            out.append(Finding(
                rule="wire-strict-read", path=module.path, line=line,
                col=col,
                message=f"wire field '{key}' ({pairname}) is elided by its "
                        "writer at the default value but read without a "
                        "fallback — use .get() with the elide default"))
    return out


def _resolve_pair(module, ctx, pair: WirePair):
    written: dict = {}
    here_written: dict = {}
    for relpath, func, scrape in pair.writers:
        tree = _module_tree(ctx, relpath, module)
        fn = _find_fn(tree, func)
        if fn is None:
            continue
        fields = scrape_writer(fn, scrape)
        for key, val in fields.items():
            prev = written.get(key)
            if prev is None or (prev[0] and not val[0]):
                written[key] = val
        if relpath == module.path:
            here_written.update(fields)
    if not written:
        return None
    read_union: set = set()
    readers_found = False
    here_reads: dict = {}
    for relpath, func, var in pair.readers:
        tree = _module_tree(ctx, relpath, module)
        fn = _find_fn(tree, func)
        if fn is None:
            continue
        readers_found = True
        reads = scrape_reader(fn, {var})
        read_union.update(reads)
        if relpath == module.path:
            for key, val in reads.items():
                prev = here_reads.get(key)
                if prev is None or (val[0] and not prev[0]):
                    here_reads[key] = val
    if not readers_found:
        return None
    if not here_written and not here_reads:
        return None
    return (pair.name, written, read_union, here_written, here_reads)


@rule("wire-dead-field")
def check_dead_fields(module: ParsedModule, ctx: RepoContext):
    yield from (f for f in _run_pairs(module, ctx)
                if f.rule == "wire-dead-field")


@rule("wire-strict-read")
def check_strict_reads(module: ParsedModule, ctx: RepoContext):
    yield from (f for f in _run_pairs(module, ctx)
                if f.rule == "wire-strict-read")


def _run_pairs(module: ParsedModule, ctx: RepoContext):
    out: list[Finding] = []
    seen_funcs: set = set()
    for pair in WIRE_PAIRS:
        involved = any(rel == module.path
                       for rel, *_r in list(pair.writers) + list(pair.readers))
        if not involved:
            continue
        resolved = _resolve_pair(module, ctx, pair)
        if resolved is None:
            continue
        name, written, read_union, here_written, here_reads = resolved
        out.extend(_pair_findings(module, name, written, read_union,
                                  here_written, here_reads))
        for rel, func, *_r in list(pair.writers) + list(pair.readers):
            if rel == module.path:
                seen_funcs.add(func.rsplit(".", 1)[-1])

    # same-module convention pairs (X_to_wire / X_from_wire, ...)
    fns = {f.name: f for f in walk_functions(module.tree)}
    for fname, fn in sorted(fns.items()):
        if fname in seen_funcs or (module.path, fname) in _TABLE_FUNCS:
            continue
        for pat, template in _CONVENTIONS:
            m = pat.match(fname)
            if not m:
                continue
            other = fns.get(template.format(m.group(1)))
            if other is None or other.name in seen_funcs:
                continue
            written = scrape_writer(fn)
            var = _first_param(other)
            if not written or var is None:
                continue
            reads = scrape_reader(other, {var})
            out.extend(_pair_findings(module, fname, written, set(reads),
                                      written, reads))
            break
    key = lambda f: (f.rule, f.line, f.col, f.message)  # noqa: E731
    seen: set = set()
    uniq = []
    for f in sorted(out, key=key):
        if key(f) not in seen:
            seen.add(key(f))
            uniq.append(f)
    return uniq


# ---------------------------------------------------------------------------
# constants / struct formats
# ---------------------------------------------------------------------------

_CONST_RE = re.compile(r"(MAGIC|VERSION)")
_PACKISH = re.compile(r"(to_wire|serialize|pack)")
_UNPACKISH = re.compile(r"(from_wire|deserialize|unpack|peek|parse)")


@rule("wire-const-mismatch")
def check_const_mismatch(module: ParsedModule, ctx: RepoContext):
    bound: dict = {}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant):
            name = node.targets[0].id
            if not (name.isupper() and _CONST_RE.search(name)):
                continue
            val = node.value.value
            if name in bound and bound[name][0] != val:
                yield Finding(
                    rule="wire-const-mismatch", path=module.path,
                    line=node.lineno, col=node.col_offset,
                    message=f"wire constant '{name}' is bound to "
                            f"conflicting values ({bound[name][0]!r} vs "
                            f"{val!r}) — pack and peek will disagree")
            else:
                bound.setdefault(name, (val, node.lineno))

    pack_fmts: set = set()
    unpack_fmts: set = set()
    sites: dict = {}
    for fn in walk_functions(module.tree):
        side = None
        # unpack first: "unpack_frame" also contains the substring "pack"
        if _UNPACKISH.search(fn.name):
            side = unpack_fmts
        elif _PACKISH.search(fn.name):
            side = pack_fmts
        if side is None:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = dotted(node.func) or ""
                if callee.split(".")[-1] in ("pack", "pack_into", "unpack",
                                             "unpack_from", "Struct",
                                             "calcsize") \
                        and callee.split(".")[0] == "struct" \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    fmt = node.args[0].value
                    side.add(fmt)
                    sites.setdefault(fmt, (node.lineno, node.col_offset))
    if pack_fmts and unpack_fmts and pack_fmts != unpack_fmts:
        for fmt in sorted(pack_fmts ^ unpack_fmts):
            line, col = sites[fmt]
            yield Finding(
                rule="wire-const-mismatch", path=module.path, line=line,
                col=col,
                message=f"struct format {fmt!r} is used on only one side of "
                        f"a pack/unpack pair (pack side {sorted(pack_fmts)}, "
                        f"unpack side {sorted(unpack_fmts)})")
