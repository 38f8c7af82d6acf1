"""Windowed causal local attention, plain PyTorch
(ported from progen_tpu/ops/local_attention.py).

This is the plain version of the windowed-attention kernel
(``ops/cuda_attention.py``): the CPU path, and what the kernel is held
against on the card.

* ``L % window_size == 0``; the sequence is cut into ``L / wsz`` windows;
* keys/values get a ZERO window prepended, and each query window attends
  over ``[previous window ‖ own window]`` = ``2*wsz`` keys, so window 0's
  phantom zero keys put ``wsz`` zero logits into the softmax denominator;
* mask ``tril(ones(wsz, 2*wsz), k=wsz)``, masked logits ``-1e10``;
* scale ``dim_head ** -0.5``; f32 logits and softmax, probabilities cast
  to ``v.dtype`` before the second product, which accumulates in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ATTN_MASK_VALUE = -1e10


def window_mask(window_size: int, device=None) -> torch.Tensor:
    """``(wsz, 2*wsz)`` bool mask: query i sees keys j with j <= i + wsz."""
    return torch.ones(window_size, 2 * window_size, dtype=torch.bool,
                      device=device).tril(window_size)


def concat_previous_window(t: torch.Tensor) -> torch.Tensor:
    """``(..., W, n, d) -> (..., W, 2n, d)``: prepend a zero window, then
    pair each window with its predecessor."""
    t = F.pad(t, (0, 0, 0, 0, 1, 0))
    return torch.cat((t[..., :-1, :, :], t[..., 1:, :, :]), dim=-2)


def local_attention(q, k, v, *, window_size: int, scale: float | None = None,
                    return_lse: bool = False):
    """Windowed attention over ``(B, H, L, Dh)`` tensors -> ``(B, H, L, Dh)``.

    ``return_lse=True`` also returns the per-row f32 logsumexp ``(B, H, L)``
    of the scaled, masked logits, which the kernel writes for the backward.
    """
    b, h, n, d = q.shape
    wsz = window_size
    if n % wsz != 0:
        raise ValueError(f"sequence length {n} must be divisible by window {wsz}")
    w = n // wsz
    scale = d ** -0.5 if scale is None else scale

    qw = q.reshape(b, h, w, wsz, d)
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d))
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d))

    sim = torch.einsum("bhwid,bhwjd->bhwij", qw.float(), kw.float()) * scale
    sim = sim.masked_fill(~window_mask(wsz, q.device), ATTN_MASK_VALUE)
    attn = torch.softmax(sim, dim=-1).to(vw.dtype)
    out = torch.einsum("bhwij,bhwjd->bhwid", attn.float(), vw.float())
    out = out.to(vw.dtype).reshape(b, h, n, d)
    if return_lse:
        return out, torch.logsumexp(sim, dim=-1).reshape(b, h, n)
    return out
