"""Ragged paged gate mix: the hand-written CUDA kernels and the wrapper the
paged decode step calls (the port of
``progen_tpu/ops/pallas_paged_attention.py``: ``_mix_kernel`` and
``_mix_kernel_q8``).

:func:`paged_gate_mix` takes CPU tensors through the plain version
(``ops/paged_gate_mix.py``) and CUDA tensors through the kernels of
``kernels/csrc/paged_gate_mix.cu``, built at first use: K3 when neither side
is quantized, K3-q8 when the weights, the pool or both are int8.  On a CUDA
tensor it launches a kernel or raises; there is no ``impl`` switch and no
fallback.  ``launches`` and ``q8_launches`` count the launches of K3 and
K3-q8, and nothing else.  :func:`write_gate_row` is a scatter in plain
PyTorch on either device, as it is plain JAX in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from progen_tpu_torch import kernels
from progen_tpu_torch.ops import paged_gate_mix as plain
from progen_tpu_torch.ops.paged_gate_mix import write_gate_row

__all__ = ["paged_gate_mix", "write_gate_row"]

LIBRARY = "paged_gate_mix"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = 0
q8_launches = 0
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel_fn(name: str, n_tensors: int, n_ints: int):
    if name not in _fns:
        fn = getattr(kernels.load(LIBRARY), name)
        fn.argtypes = ([ctypes.c_void_p] * n_tensors + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(weights, biases, pool, table, pos, w_scale, pool_scale):
    n = weights.shape[0]
    if weights.dim() != 2 or weights.shape[1] != n:
        raise ValueError(f"weights must be (n, n), got {tuple(weights.shape)}")
    if tuple(biases.shape) != (n, 1) or biases.dtype != torch.float32:
        raise ValueError(f"biases must be ({n}, 1) float32, got "
                         f"{tuple(biases.shape)} {biases.dtype}")
    if pool.dim() != 3 or pool.shape[-1] % 4 != 0:
        raise ValueError(f"pool must be (num_pages, page_size, d) with "
                         f"d % 4 == 0, got {tuple(pool.shape)}")
    if table.dim() != 2 or table.dtype != torch.int32:
        raise ValueError(f"table must be (B, pages_per_row) int32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if tuple(pos.shape) != (table.shape[0],) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be ({table.shape[0]},) int32, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if (weights.dtype == torch.int8) != (w_scale is not None) \
            or weights.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"weights must be float32, or int8 with w_scale; got "
                         f"{weights.dtype}, w_scale "
                         f"{'given' if w_scale is not None else 'missing'}")
    if (pool.dtype == torch.int8) != (pool_scale is not None) \
            or pool.dtype not in DTYPES:
        raise ValueError(f"pool must be float32 or bfloat16, or int8 with "
                         f"pool_scale; got {pool.dtype}, pool_scale "
                         f"{'given' if pool_scale is not None else 'missing'}")
    if w_scale is not None and (tuple(w_scale.shape) != (n,)
                                or w_scale.dtype != torch.float32):
        raise ValueError(f"w_scale must be ({n},) float32, got "
                         f"{tuple(w_scale.shape)} {w_scale.dtype}")
    if pool_scale is not None and (tuple(pool_scale.shape) != tuple(pool.shape[:2])
                                   or pool_scale.dtype != torch.float32):
        raise ValueError(f"pool_scale must be {tuple(pool.shape[:2])} float32, "
                         f"got {tuple(pool_scale.shape)} {pool_scale.dtype}")
    tensors = [t for t in (weights, biases, pool, table, pos, w_scale, pool_scale)
               if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if any(t.device != pool.device for t in tensors):
        raise ValueError("the kernel's tensors must be on one device")


def paged_gate_mix(weights: torch.Tensor, biases: torch.Tensor,
                   pool: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                   *, n_rows: int, w_scale: torch.Tensor | None = None,
                   pool_scale: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b] = sum_{i <= pos_b} W[pos_b, i] * pool[table[b, i // ps],
    i % ps] + bias[pos_b]``, ``(B, d)`` f32; arguments as the plain
    version's.  On the card ``table`` and ``pos`` must be int32, and
    ``n_rows`` is not needed (the kernel walks ``pos_b + 1`` rows)."""
    global launches, q8_launches
    if pool.device.type == "cpu":
        return plain.paged_gate_mix(weights, biases, pool, table, pos,
                                    n_rows=n_rows, w_scale=w_scale,
                                    pool_scale=pool_scale)
    if pool.device.type != "cuda":
        raise ValueError(f"no kernel for device {pool.device}")
    _check(weights, biases, pool, table, pos, w_scale, pool_scale)
    batch, pages_per_row = table.shape
    num_pages, page_size, d = pool.shape
    n = weights.shape[0]
    out = torch.empty((batch, d), dtype=torch.float32, device=pool.device)
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    shape = (batch, n, d, page_size, pages_per_row, num_pages)
    if w_scale is None and pool_scale is None:
        fn = _kernel_fn("paged_gate_mix", 6, 7)
        err = fn(weights.data_ptr(), biases.data_ptr(), pool.data_ptr(),
                 table.data_ptr(), pos.data_ptr(), out.data_ptr(), *shape,
                 DTYPES[pool.dtype], stream)
        name = "paged_gate_mix"
    else:
        fn = _kernel_fn("paged_gate_mix_q8", 8, 8)
        err = fn(weights.data_ptr(), biases.data_ptr(), pool.data_ptr(),
                 table.data_ptr(), pos.data_ptr(),
                 None if w_scale is None else w_scale.data_ptr(),
                 None if pool_scale is None else pool_scale.data_ptr(),
                 out.data_ptr(), *shape, DTYPES[weights.dtype],
                 DTYPES[pool.dtype], stream)
        name = "paged_gate_mix_q8"
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    if name == "paged_gate_mix":
        launches += 1
    else:
        q8_launches += 1
    return out
