"""Symmetric int8 quantization for the serving path (ported from
progen_tpu/ops/quant.py).

Weight-only int8: each weight matrix is quantized per OUTPUT channel with an
absmax scale, so one f32 multiply after the product recovers the range.  The
product itself runs int8-as-activation-dtype with an f32 result:
``[-127, 127]`` is exact in bf16, so the only loss is the rounding taken at
quantization time.  Scales never leave f32.

* array level: :func:`quantize_w`, :func:`dequantize_w`, :func:`int8_matmul`
  (a plain product, left to ``torch.matmul`` as the JAX package leaves it to
  XLA) and :func:`quantize_rows` (per-row scaling of paged gate-cache rows);
* tree level: :func:`quantize_params` walks a full-precision flax-layout
  parameter tree of tensors and returns ``(qparams, scales)``.

The ``np_*`` twins are pure-numpy oracles for the tests.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

# +-127 keeps the code symmetric around zero (-128 is never produced), and
# both endpoints are exact in bf16
QMAX = 127.0


def _scale_shape(ndim: int, channel_axis: int) -> list[int]:
    shape = [1] * ndim
    shape[channel_axis] = -1
    return shape


def quantize_w(w: torch.Tensor, channel_axis: int = -1):
    """Symmetric per-channel absmax int8 quantization.  Returns ``(q,
    scale)``: ``q`` int8 of ``w``'s shape, ``scale`` f32 of shape
    ``(w.shape[channel_axis],)``.  All-zero channels get scale 1.0.
    Rounding is half to even (``torch.round``), as ``jnp.round``."""
    w32 = w.float()
    channel_axis = channel_axis % w32.dim()
    reduce_axes = [a for a in range(w32.dim()) if a != channel_axis]
    absmax = w32.abs().amax(dim=reduce_axes) if reduce_axes else w32.abs()
    scale = torch.where(absmax > 0.0, absmax / QMAX, torch.ones_like(absmax))
    s_b = scale.reshape(_scale_shape(w32.dim(), channel_axis))
    q = torch.round(w32 / s_b).clamp(-QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize_w(q: torch.Tensor, scale: torch.Tensor, channel_axis: int = -1):
    """Inverse of :func:`quantize_w` up to rounding; f32."""
    channel_axis = channel_axis % q.dim()
    return q.float() * scale.float().reshape(_scale_shape(q.dim(), channel_axis))


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    """``x @ dequantize(q, scale)`` with the dequantization after the
    product.  ``x (..., Din)`` is the activation, ``q (Din, Dout)`` the int8
    kernel in flax layout, ``scale (Dout,)`` f32.  The kernel is cast to
    ``x.dtype`` (exact), the product is returned in f32 (on the card a bf16
    product accumulates in f32 and rounds once to bf16 before the scale; the
    JAX package keeps the f32 accumulator), scaled per channel in f32."""
    y = torch.matmul(x, q.to(x.dtype)).float()
    return y * scale.float()


def quantize_rows(x: torch.Tensor, group=None):
    """Per-row (last axis) absmax int8 quantization of cache rows.  Returns
    ``(q, scale)`` with ``scale`` f32 of ``x.shape[:-1]``.  ``group``: ``x``
    holds a rank's channels of each row, split over a tensor group; the
    absmax is then the whole row's (a max over the group), so each rank's
    codes and the scale are those of the whole row."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    if group is not None:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(absmax > 0.0, absmax / QMAX, torch.ones_like(absmax))
    q = torch.round(x32 / scale[..., None]).clamp(-QMAX, QMAX)
    return q.to(torch.int8), scale


# the logits head stays full precision: its rounding error lands directly on
# the sampled distribution, and it is one product per step
_SKIP_SCOPES = ("to_logits",)


def quantize_params(params: Mapping):
    """Quantize a full-precision ProGen parameter tree (flax layout: nested
    dicts of tensors, dense ``kernel`` leaves ``(in, out)``) in one walk.

    Returns ``(qparams, scales)``: ``qparams`` mirrors ``params`` with every
    dense ``kernel`` (except under ``to_logits``) re-typed int8 per output
    channel and each SGU ``spatial_weights`` re-typed int8 per ROW (the row
    scale folds into the spatial mix, which contracts over columns);
    everything else passes through.  ``scales`` is a sparse parallel tree of
    the f32 scales under ``<leaf>_scale`` names."""

    def walk(tree, skip):
        q, s = {}, {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                sub_q, sub_s = walk(v, skip or k in _SKIP_SCOPES)
                q[k] = sub_q
                if sub_s:
                    s[k] = sub_s
            elif k == "kernel" and not skip:
                q[k], s[k + "_scale"] = quantize_w(v, channel_axis=-1)
            elif k == "spatial_weights":
                q[k], s[k + "_scale"] = quantize_w(v, channel_axis=0)
            else:
                q[k] = v
        return q, s

    return walk(params, False)


# ------------------------------------------------------------ numpy oracles


def np_quantize_w(w, channel_axis: int = -1):
    """Pure-numpy twin of :func:`quantize_w` (same rounding)."""
    w32 = np.asarray(w, np.float32)
    channel_axis = channel_axis % w32.ndim
    reduce_axes = tuple(a for a in range(w32.ndim) if a != channel_axis)
    absmax = np.max(np.abs(w32), axis=reduce_axes)
    scale = np.where(absmax > 0.0, absmax / QMAX, 1.0).astype(np.float32)
    s_b = scale.reshape(_scale_shape(w32.ndim, channel_axis))
    q = np.clip(np.round(w32 / s_b), -QMAX, QMAX).astype(np.int8)
    return q, scale


def np_dequantize_w(q, scale, channel_axis: int = -1):
    channel_axis = channel_axis % q.ndim
    s_b = np.asarray(scale, np.float32).reshape(
        _scale_shape(q.ndim, channel_axis))
    return q.astype(np.float32) * s_b


def np_int8_matmul(x, q, scale):
    """f32-exact oracle for :func:`int8_matmul`."""
    y = np.asarray(x, np.float32) @ q.astype(np.float32)
    return y * np.asarray(scale, np.float32)
