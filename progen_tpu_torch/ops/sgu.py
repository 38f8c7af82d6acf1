"""Spatial gating unit core op, plain PyTorch (ported from progen_tpu/ops/sgu.py).

This is the plain version of the causal SGU kernel (``ops/cuda_sgu.py``):
the CPU path, and what the kernel is held against on the card.  The gate is
mixed across positions by a learned causal ``(n, n)`` matrix:
``out[m] = sum_{k<=m} weights[m, k] * gate[k] + bias[m]``.
"""

from __future__ import annotations

import torch


def spatial_gate(gate: torch.Tensor, weights: torch.Tensor,
                 biases: torch.Tensor) -> torch.Tensor:
    """Mix ``gate`` ``(..., n, d)`` with causal ``weights`` ``(n, n)`` and
    ``biases`` ``(n, 1)``: ``tril`` on the weights, an f32 product, ``+ b``
    in f32, then a cast to the gate's dtype."""
    w = torch.tril(weights)
    mixed = torch.einsum("...nd,mn->...md", gate.float(), w.float())
    mixed = mixed + biases.float()
    return mixed.to(gate.dtype)


def gated_mix(res: torch.Tensor, gate: torch.Tensor, weights: torch.Tensor,
              biases: torch.Tensor) -> torch.Tensor:
    """``res * spatial_gate(gate, weights, biases)``: the whole function the
    kernel computes, multiplied in the compute dtype after the cast."""
    return res * spatial_gate(gate, weights, biases)
