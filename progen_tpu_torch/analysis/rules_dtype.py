"""Rules ``dtype-pet`` and ``dtype-f32-literal``: mixed-precision hygiene.

The counterpart of ``progen_tpu/analysis/rules_dtype.py``.

``dtype-pet``: the hazard class is a contraction that accumulates below
f32.  In JAX that is an ``einsum``/``dot_general`` with no
``preferred_element_type``.  In torch a matmul's accumulation is set
process-wide, so the hazard is a precision switch thrown inside the
numeric core (``ops/``, ``decode/``, ``models/``, ``train/``):
``torch.set_float32_matmul_precision`` with anything but ``"highest"``,
or ``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32`` or
``allow_{bf16,fp16}_reduced_precision_reduction`` set true.  Any of them
makes f32 matmuls run in TF32 (or reduces bf16 partial sums in bf16) on
the card, and silently breaks the f32 policy's parity with the JAX
package, which the CPU never shows.

``dtype-f32-literal``: a Python float literal that is not exactly
representable in bfloat16 (e.g. ``1e-6``, ``0.1``) mixed into arithmetic
with an explicitly-bf16 operand (``t.to(torch.bfloat16)``,
``t.bfloat16()``, ``dtype=torch.bfloat16``) rounds at the binding —
epsilons vanish, scales drift.  Exact literals (``0.5``, ``2.0``) pass.
"""

from __future__ import annotations

import ast
import math
import struct

from progen_tpu_torch.analysis.capturegraph import call_name, dotted
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule

_PRECISION_CALLS = frozenset({"torch.set_float32_matmul_precision",
                              "set_float32_matmul_precision"})

# flags that lower a matmul's accumulation when set true
_PRECISION_FLAGS = frozenset({"allow_tf32",
                              "allow_bf16_reduced_precision_reduction",
                              "allow_fp16_reduced_precision_reduction"})

_SCOPED_DIRS = ("ops/", "decode/", "models/", "train/")


def _in_scope(path: str) -> bool:
    return any(f"/{d}" in path or path.startswith(d) for d in _SCOPED_DIRS)


def bf16_exact(value: float) -> bool:
    """True if ``value`` round-trips bfloat16 exactly (8-bit mantissa)."""
    if not math.isfinite(value):
        return True
    f32 = struct.unpack(">I", struct.pack(">f", value))[0]
    if struct.unpack(">f", struct.pack(">I", f32))[0] != value:
        return False  # not even f32-exact
    # round-to-nearest-even to the top 16 bits
    lower = f32 & 0xFFFF
    rounded = f32 & 0xFFFF0000
    if lower > 0x8000 or (lower == 0x8000 and (f32 >> 16) & 1):
        rounded += 0x10000
    return struct.unpack(">f", struct.pack(">I", rounded & 0xFFFFFFFF))[0] == value


def _mentions_bf16(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "bfloat16":
            return True
        if isinstance(sub, ast.Constant) and sub.value == "bfloat16":
            return True
    return False


def _switches(tree: ast.Module):
    """``(node, what)`` for each precision switch thrown in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and call_name(node) in _PRECISION_CALLS:
            arg = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "precision"),
                None)
            if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                yield node, f"'{call_name(node)}' below \"highest\""
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                name = dotted(t)
                if name is None or name.rsplit(".", 1)[-1] \
                        not in _PRECISION_FLAGS:
                    continue
                if isinstance(node.value, ast.Constant) \
                        and node.value.value is False:
                    continue
                yield node, f"'{name} = ...' (true or not a constant)"


@rule("dtype-pet")
def check_pet(module: ParsedModule, ctx: RepoContext):
    if not _in_scope(module.path):
        return
    for node, what in _switches(module.tree):
        yield Finding(
            rule="dtype-pet",
            path=module.path,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"{what} inside the numeric core: f32 matmuls then "
                "accumulate below f32 on the card; leave the precision "
                "switches at their f32 defaults"
            ),
        )


@rule("dtype-f32-literal")
def check_literals(module: ParsedModule, ctx: RepoContext):
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.BinOp):
            continue
        for lit, other in (
            (node.left, node.right),
            (node.right, node.left),
        ):
            if (
                isinstance(lit, ast.Constant)
                and isinstance(lit.value, float)
                and not bf16_exact(lit.value)
                and _mentions_bf16(other)
            ):
                yield Finding(
                    rule="dtype-f32-literal",
                    path=module.path,
                    line=lit.lineno,
                    col=lit.col_offset,
                    message=(
                        f"float literal {lit.value!r} is not bf16-exact but "
                        "mixes into bf16 arithmetic; compute in f32 and cast "
                        "once at the end"
                    ),
                )
                break
