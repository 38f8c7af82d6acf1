"""Causal SGU forward: the hand-written CUDA kernel and its wrapper (the
port of ``progen_tpu/ops/pallas_sgu.py:_fwd_kernel``).

``spatial_gate_fwd`` takes a CPU tensor through the plain version
(``ops/sgu.py``) and a CUDA tensor through the kernel
(``kernels/csrc/sgu_fwd.cu``), which it builds at first use.  On a CUDA
tensor it launches the kernel or raises; it never falls back.
``launches`` counts the kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from progen_tpu_torch import kernels
from progen_tpu_torch.ops.sgu import gated_mix

KERNEL = "sgu_fwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = getattr(kernels.load(KERNEL), KERNEL)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(res, gate, weights, biases):
    n = weights.shape[0]
    if weights.dim() != 2 or weights.shape != (n, n):
        raise ValueError(f"weights must be square, got {tuple(weights.shape)}")
    if gate.dim() < 2 or gate.shape[-2] != n or res.shape != gate.shape:
        raise ValueError(f"res/gate {tuple(res.shape)}/{tuple(gate.shape)} must "
                         f"be (..., {n}, d) matching weights {tuple(weights.shape)}")
    if tuple(biases.shape) != (n, 1):
        raise ValueError(f"biases must be ({n}, 1), got {tuple(biases.shape)}")
    tensors = (res, gate, weights, biases)
    if gate.dtype not in DTYPES or any(t.dtype != gate.dtype for t in tensors):
        raise ValueError("the kernel takes float32 or bfloat16 res, gate, "
                         "weights and biases of one dtype, got "
                         f"{[t.dtype for t in tensors]}")
    if gate.shape[-1] % 8 != 0:
        raise ValueError(f"the kernel takes d % 8 == 0, got d={gate.shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous res, gate, weights, biases")
    if any(t.device != gate.device for t in tensors):
        raise ValueError("res, gate, weights, biases must be on one device")


def spatial_gate_fwd(res: torch.Tensor, gate: torch.Tensor,
                     weights: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """``res * cast(tril(weights) @ gate + biases)`` over ``res``/``gate``
    ``(..., n, d)``, ``weights`` ``(n, n)``, ``biases`` ``(n, 1)``."""
    global launches
    if gate.device.type == "cpu":
        return gated_mix(res, gate, weights, biases)
    if gate.device.type != "cuda":
        raise ValueError(f"no kernel for device {gate.device}")
    _check(res, gate, weights, biases)
    n, d = gate.shape[-2], gate.shape[-1]
    batch = gate.numel() // (n * d)
    fn = _kernel_fn()
    out = torch.empty_like(gate)
    err = fn(res.data_ptr(), gate.data_ptr(), weights.data_ptr(),
             biases.data_ptr(), out.data_ptr(), batch, n, d, DTYPES[gate.dtype],
             torch.cuda.current_stream(gate.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launches += 1
    return out
