"""Mixed-precision policy (ported from progen_tpu/core/precision.py).

Parameters live in ``param_dtype``, blocks compute in ``compute_dtype`` and
the final logits are cast to ``output_dtype``.  The default is the TPU
package's choice, f32 params / bf16 compute / f32 output; the H100's tensor
cores take bf16 at the same rate as fp16.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)


def make_policy(mixed_precision: bool = True) -> Policy:
    """``mixed_precision=False`` computes in f32 end to end (parity mode)."""
    if mixed_precision:
        return Policy(torch.float32, torch.bfloat16, torch.float32)
    return Policy(torch.float32, torch.float32, torch.float32)
