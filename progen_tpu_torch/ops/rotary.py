"""Rotary position embedding, interleaved (GPT-J) variant
(ported from progen_tpu/ops/rotary.py).

Frequencies ``1/10000^(2i/d)`` each repeated twice consecutively; rotation
pairs ADJACENT channels ``(x0, x1) -> (-x1, x0)``; the tables are built in
f32 and cast to ``x.dtype`` before the multiply.  The model rotates q, k
AND v.  Position axis is ``-2``, feature axis ``-1``.
"""

from __future__ import annotations

import torch


def fixed_pos_embedding(n: int, dim: int, device=None,
                        dtype: torch.dtype = torch.float32):
    """Sin/cos tables of shape ``(n, dim)`` (dim must be even), in f32."""
    inv_freq = 1.0 / (10000 ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    angles = (torch.arange(n, dtype=torch.float32, device=device)[:, None]
              * inv_freq[None, :])
    angles = torch.repeat_interleave(angles, 2, dim=-1)
    return torch.sin(angles).to(dtype), torch.cos(angles).to(dtype)


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """``(..., x0, x1, x2, x3, ...) -> (..., -x1, x0, -x3, x2, ...)``."""
    x = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def apply_rotary_pos_emb(x: torch.Tensor, sin: torch.Tensor,
                         cos: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``sin.shape[-1]`` channels of ``x``; pass the rest."""
    rot_dim = sin.shape[-1]
    sin = sin.to(x.dtype)
    cos = cos.to(x.dtype)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x_rot = (x_rot * cos) + (rotate_every_two(x_rot) * sin)
    if x_pass.shape[-1] == 0:
        return x_rot
    return torch.cat((x_rot, x_pass), dim=-1)
