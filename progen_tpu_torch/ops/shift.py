"""Token shift (ported from progen_tpu/ops/shift.py).

The first ``d - d//2`` channels (``array_split`` semantics) look one
position back, zero at position 0; the rest pass.  Position axis is ``-2``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shift_tokens(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    split = d - d // 2
    x_shift, x_pass = x[..., :split], x[..., split:]
    x_shift = F.pad(x_shift, (0, 0, 1, 0))[..., :-1, :]
    return torch.cat((x_shift, x_pass), dim=-1)
