"""Rule ``mesh-axis``: mesh axis names must exist in the mesh.

The counterpart of ``progen_tpu/analysis/rules_sharding.py``.  The JAX
rule reads ``PartitionSpec`` literals; the port names its axes where it
looks a ``DeviceMesh`` dimension up, and a name the mesh does not declare
raises only at run time, on the ranks, often only under a mesh the CPU
tests never build.  So every string literal in one of these places must
be a member of the vocabulary scraped from ``core/mesh.py``
(``MESH_AXES``):

* ``mesh["seq"]``, ``mesh["data", "fsdp"]`` — a subscript of a name or
  attribute ending in ``mesh``;
* ``mesh.get_group("tensor")``, ``mesh.get_local_rank("seq")``;
* ``MESH_AXES.index("tensor")``, ``mesh.mesh_dim_names.index("seq")``;
* ``mesh_sizes(mesh)["tensor"]``;
* ``init_device_mesh(..., mesh_dim_names=(...))``.

Non-literal axis expressions (variables, ``*axes`` splats) are skipped:
the rule only judges what it can read.
"""

from __future__ import annotations

import ast

from progen_tpu_torch.analysis.capturegraph import call_name, dotted
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule

_GROUP_METHODS = frozenset({"get_group", "get_local_rank"})
_INDEXED_VOCABS = frozenset({"MESH_AXES", "mesh_dim_names"})
_SIZE_TABLES = frozenset({"mesh_sizes"})
_MESH_BUILDERS = frozenset({"init_device_mesh", "DeviceMesh"})


def _literal_axes(node: ast.AST):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value, node
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _literal_axes(elt)


def _axis_sites(tree: ast.Module):
    """``(expr, how)`` for each expression that names mesh axes."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript):
            base = node.value
            name = dotted(base) or ""
            if name.lower().endswith("mesh"):
                yield node.slice, "mesh lookup"
            elif isinstance(base, ast.Call) \
                    and (call_name(base) or "").rsplit(".", 1)[-1] \
                    in _SIZE_TABLES:
                yield node.slice, "mesh_sizes lookup"
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _GROUP_METHODS and node.args:
                yield node.args[0], f"'.{attr}'"
            elif attr == "index" and node.args and (
                    dotted(node.func.value) or "").rsplit(".", 1)[-1] \
                    in _INDEXED_VOCABS:
                yield node.args[0], "axis index"
        if isinstance(node, ast.Call) \
                and (call_name(node) or "").rsplit(".", 1)[-1] \
                in _MESH_BUILDERS:
            for kw in node.keywords:
                if kw.arg == "mesh_dim_names":
                    yield kw.value, "mesh_dim_names"


@rule("mesh-axis")
def check(module: ParsedModule, ctx: RepoContext):
    for expr, how in _axis_sites(module.tree):
        for axis, lit in _literal_axes(expr):
            if axis not in ctx.mesh_axes:
                known = ", ".join(sorted(ctx.mesh_axes))
                yield Finding(
                    rule="mesh-axis",
                    path=module.path,
                    line=lit.lineno,
                    col=lit.col_offset,
                    message=(
                        f"mesh axis '{axis}' ({how}) is not a declared "
                        f"mesh axis (known: {known})"
                    ),
                )
