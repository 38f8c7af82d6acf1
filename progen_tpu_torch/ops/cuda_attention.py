"""Windowed local attention forward: the hand-written CUDA kernel and its
wrapper (the port of ``progen_tpu/ops/pallas_attention.py:_fwd_kernel``).

``local_attention_fwd`` takes a CPU tensor through the plain version
(``ops/local_attention.py``) and a CUDA tensor through the kernel
(``kernels/csrc/local_attention_fwd.cu``), which it builds at first use.
On a CUDA tensor it launches the kernel or raises; it never falls back.
``launches`` counts the kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from progen_tpu_torch import kernels
from progen_tpu_torch.ops.local_attention import local_attention

KERNEL = "local_attention_fwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DIM_HEADS = (32, 64, 128)

launches = 0
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = getattr(kernels.load(KERNEL), KERNEL)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, window_size):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, L, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    n, d = q.shape[2], q.shape[3]
    if window_size <= 0 or n % window_size != 0:
        raise ValueError(f"sequence length {n} must be divisible by window "
                         f"{window_size}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in DIM_HEADS:
        raise ValueError(f"the kernel takes dim_head in {DIM_HEADS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def local_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window_size: int, scale: float | None = None):
    """Windowed attention over ``(B, H, L, D)`` -> ``(out, lse)``: ``out``
    ``(B, H, L, D)`` in q's dtype and the per-row logsumexp ``lse``
    ``(B, H, L)`` in f32."""
    global launches
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return local_attention(q, k, v, window_size=window_size, scale=scale,
                               return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window_size)
    b, h, n, d = q.shape
    fn = _kernel_fn()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b * h, n, d, window_size, float(scale),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launches += 1
    return out, lse
