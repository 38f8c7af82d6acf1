"""Spatial gating unit core op, plain PyTorch (ported from progen_tpu/ops/sgu.py).

This is the plain version of the causal SGU kernels (``ops/cuda_sgu.py``),
forward and backward: the CPU path, and what the kernels are held against
on the card.  The gate is
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


def spatial_gate_dgate(weights: torch.Tensor, dout: torch.Tensor,
                       res: torch.Tensor) -> torch.Tensor:
    """``d_gate = tril(weights)^T . (dout * res)`` over ``(..., n, d)``:
    ``dout * res`` rounded to the compute dtype first, then an f32 product,
    cast to dout's dtype (``progen_tpu/ops/pallas_sgu.py:_dgate_kernel``)."""
    dmix = dout * res
    w = torch.tril(weights)
    dgate = torch.einsum("...md,mn->...nd", dmix.float(), w.float())
    return dgate.to(dout.dtype)


def spatial_gate_dw(dout: torch.Tensor, res: torch.Tensor,
                    gate: torch.Tensor) -> torch.Tensor:
    """``d_W = tril(sum_b (dout * res)_b . gate_b^T)``, ``(n, n)``: the
    product rounded to the compute dtype, the sum over the batch in f32,
    the strict upper triangle exactly 0, cast to the inputs' dtype, which
    is the weights' (``progen_tpu/ops/pallas_sgu.py:_dw_kernel``)."""
    dmix = dout * res
    dw = torch.einsum("...md,...nd->mn", dmix.float(), gate.float())
    return torch.tril(dw).to(gate.dtype)
