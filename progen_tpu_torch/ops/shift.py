"""Token shift (ported from progen_tpu/ops/shift.py).

The first ``d - d//2`` channels (``array_split`` semantics) look one
position back, zero at position 0; the rest pass.  Position axis is ``-2``.
Under a sequence split position 0 of a slice looks at ``prev``, the last
row's shifted channels of the slice before it (``parallel/context.py``'s
``left_halo``), which JAX's GSPMD gets for free.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shift_split(d: int) -> int:
    """How many leading channels of a width-``d`` row shift."""
    return d - d // 2


def shift_tokens(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """``prev`` ``(..., 1, d - d // 2)``: the row before position 0 (zeros
    without it)."""
    split = shift_split(x.shape[-1])
    x_shift, x_pass = x[..., :split], x[..., split:]
    if prev is None:
        x_shift = F.pad(x_shift, (0, 0, 1, 0))[..., :-1, :]
    else:
        x_shift = torch.cat((prev, x_shift[..., :-1, :]), dim=-2)
    return torch.cat((x_shift, x_pass), dim=-1)
