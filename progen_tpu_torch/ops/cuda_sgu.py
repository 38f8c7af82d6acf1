"""Causal SGU: the hand-written CUDA kernels, their wrappers and the
autograd function the model calls (the port of
``progen_tpu/ops/pallas_sgu.py``: ``_fwd_kernel``, ``_dgate_kernel`` and
``_dw_kernel``).

``spatial_gate_fwd``, ``spatial_gate_dgate`` and ``spatial_gate_dw`` take a
CPU tensor through the plain versions (``ops/sgu.py``) and a CUDA tensor
through the kernels (``kernels/csrc/sgu_fwd.cu`` and ``sgu_bwd.cu``), which
they build at first use.  On a CUDA tensor they launch the kernels or
raise; they never fall back.  ``launches``, ``dgate_launches`` and
``dw_launches`` count the calls that launch K2-fwd, K2-dgate and K2-dW, and
nothing else (in bf16 a K2-dW call is two launches: the split partial
products, then their ordered sum, see :func:`dw_split`).

K2-fwd has two routes, chosen before the launch by :func:`fwd_route` from
the dtype alone: bf16 takes the Hopper kernel (a TMA ring into ``wgmma``,
``"wgmma"``), f32 the first kernel (FMA loops, ``"fma"``).
``fwd_route_launches`` counts the launches of each.

:func:`gated_mix` is what the model calls: K2-fwd once, and under autograd
the backward of ``pallas_sgu.py:316-335``: d_res is K2-fwd again with dout
in place of res, d_gate is K2-dgate, d_W is K2-dW and d_b a plain f32
reduction.
"""

from __future__ import annotations

import ctypes

import torch

from progen_tpu_torch import kernels
from progen_tpu_torch.ops import sgu as plain

KERNEL = "sgu_fwd"
BWD = "sgu_bwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
fwd_route_launches = {"wgmma": 0, "fma": 0}
dgate_launches = 0
dw_launches = 0
_fns: dict[str, ctypes._CFuncPtr] = {}


# K2-dW's bf16 tiling (kernels/csrc/sgu_bwd.cu): 128 x 128 tiles of the
# lower triangle, 64 channels per step of the (batch, channel) axis
DW_TILE = 128
DW_STEP = 64
# bf16 K2-fwd's tiling (kernels/csrc/sgu_fwd.cu, namespace fw): a block owns
# 128 output rows (two warpgroups of 64) and 128 channels of one batch row
# and walks 64-deep steps of k
FWD_ROWS = 128
FWD_COLS = 128
FWD_STEP = 64


def _kernel_fn(name: str, library: str, n_tensors: int):
    if name not in _fns:
        fn = getattr(kernels.load(library), name)
        fn.argtypes = ([ctypes.c_void_p] * n_tensors + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_rows(*tensors):
    """``(..., n, d)`` tensors of one shape, dtype and device, contiguous,
    float32 or bfloat16, ``d % 8 == 0``."""
    first = tensors[0]
    if first.dim() < 2 or any(t.shape != first.shape for t in tensors):
        raise ValueError(f"the kernel takes (..., n, d) tensors of one shape, "
                         f"got {[tuple(t.shape) for t in tensors]}")
    if first.dtype not in DTYPES or any(t.dtype != first.dtype for t in tensors):
        raise ValueError(f"the kernel takes float32 or bfloat16 tensors of one "
                         f"dtype, got {[t.dtype for t in tensors]}")
    if first.shape[-1] % 8 != 0:
        raise ValueError(f"the kernel takes d % 8 == 0, got d={first.shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if any(t.device != first.device for t in tensors):
        raise ValueError("the kernel's tensors must be on one device")


def _check_weights(weights, rows, biases=None):
    n = rows.shape[-2]
    if tuple(weights.shape) != (n, n):
        raise ValueError(f"weights must be ({n}, {n}) for rows "
                         f"{tuple(rows.shape)}, got {tuple(weights.shape)}")
    extra = (weights,) if biases is None else (weights, biases)
    if biases is not None and tuple(biases.shape) != (n, 1):
        raise ValueError(f"biases must be ({n}, 1), got {tuple(biases.shape)}")
    if any(t.dtype != rows.dtype for t in extra):
        raise ValueError(f"weights and biases must be {rows.dtype}, got "
                         f"{[t.dtype for t in extra]}")
    if not all(t.is_contiguous() for t in extra):
        raise ValueError("the kernel takes contiguous weights and biases")
    if any(t.device != rows.device for t in extra):
        raise ValueError("the kernel's tensors must be on one device")


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


def _run(fn, name: str, ptrs, rows: torch.Tensor) -> None:
    n, d = rows.shape[-2], rows.shape[-1]
    batch = rows.numel() // (n * d)
    err = fn(*ptrs, batch, n, d, DTYPES[rows.dtype],
             torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def spatial_gate_fwd(res: torch.Tensor, gate: torch.Tensor,
                     weights: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """``res * cast(tril(weights) @ gate + biases)`` over ``res``/``gate``
    ``(..., n, d)``, ``weights`` ``(n, n)``, ``biases`` ``(n, 1)``."""
    global launches
    if _device(gate) == "cpu":
        return plain.gated_mix(res, gate, weights, biases)
    _check_rows(res, gate)
    _check_weights(weights, gate, biases)
    route = fwd_route(gate.dtype)
    name = KERNEL if route == "fma" else f"{KERNEL}_wgmma"
    if route == "wgmma":
        weights = _padded_weights(weights)
        kernels.check_aligned(res, gate, weights)
    fn = _kernel_fn(name, KERNEL, 5)
    out = torch.empty_like(gate)
    _run(fn, name, (res.data_ptr(), gate.data_ptr(), weights.data_ptr(),
                    biases.data_ptr(), out.data_ptr()), gate)
    launches += 1
    fwd_route_launches[route] += 1
    return out


def fwd_route(dtype: torch.dtype) -> str:
    """Which K2-fwd kernel takes this dtype: ``"wgmma"`` (the Hopper
    kernel) for bf16, ``"fma"`` (the first kernel) for f32."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def k2_fwd_tiles(batch: int, n: int, d: int) -> list[tuple[int, int, int, list]]:
    """The bf16 K2-fwd kernel's blocks and walks, the formulas of
    ``sgu_fwd.cu`` (``fw::block_tile`` and the step kinds): for each block
    in launch order, longest walk first, ``(b, m0, c0, walk)`` with ``walk``
    the ``(r0, k0, kind)`` of each 64-deep step ``k0`` and each of its two
    warpgroups' rows ``r0``, ``kind`` one of ``"full"``, ``"diagonal"``
    (the strict upper part of W's box zeroed) and ``"skipped"``."""
    row_tiles, col_tiles = -(-n // FWD_ROWS), -(-d // FWD_COLS)
    blocks = []
    for blk in range(batch * row_tiles * col_tiles):
        ct, rest = blk % col_tiles, blk // col_tiles
        b, mi = rest % batch, row_tiles - 1 - rest // batch
        m0 = mi * FWD_ROWS
        walk = []
        for it in range(-(-min(m0 + FWD_ROWS, n) // FWD_STEP)):
            k0 = it * FWD_STEP
            for r0 in (m0, m0 + FWD_STEP):
                kind = "full" if k0 < r0 else "diagonal" if k0 == r0 else "skipped"
                walk.append((r0, k0, kind))
        blocks.append((b, m0, ct * FWD_COLS, walk))
    return blocks


def _padded_weights(weights: torch.Tensor) -> torch.Tensor:
    """``weights`` with its rows ``ceil8(n)`` elements apart, as K2-dgate
    and bf16 K2-fwd read them (TMA needs 16-byte row strides): itself when
    ``n % 8 == 0``, else a zero-padded ``(n, ceil8(n))`` copy (the zeros
    lie outside the ``(n, n)`` square the kernel reads)."""
    n = weights.shape[0]
    if n % 8 == 0:
        return weights
    padded = torch.zeros((n, -(-n // 8) * 8), dtype=weights.dtype,
                         device=weights.device)
    padded[:, :n] = weights
    return padded


def spatial_gate_dgate(weights: torch.Tensor, dout: torch.Tensor,
                       res: torch.Tensor) -> torch.Tensor:
    """``tril(weights)^T . (dout * res)``, ``(..., n, d)`` in dout's dtype."""
    global dgate_launches
    if _device(dout) == "cpu":
        return plain.spatial_gate_dgate(weights, dout, res)
    _check_rows(dout, res)
    _check_weights(weights, dout)
    kernels.check_aligned(weights, dout, res)
    fn = _kernel_fn(f"{BWD}_dgate", BWD, 4)
    w = _padded_weights(weights)
    dgate = torch.empty_like(dout)
    _run(fn, f"{BWD}_dgate", (w.data_ptr(), dout.data_ptr(),
                              res.data_ptr(), dgate.data_ptr()), dout)
    dgate_launches += 1
    return dgate


def dw_split(batch: int, n: int, d: int, sms: int) -> tuple[int, list[range]]:
    """How bf16 K2-dW splits its reduction axis over the card's ``sms``
    streaming multiprocessors.

    The axis is ``batch * ceil(d / 64)`` steps of 64 channels of one batch
    row (step ``j``: row ``j // ceil(d / 64)``).  Each of the ``T`` tiles of
    the lower triangle (128 x 128) gets ``splits`` blocks, one per range of
    steps, so ``T * splits`` blocks fill the SMs in one wave; split ``s``
    takes steps ``[s * steps // splits, (s + 1) * steps // splits)``, the
    formula the kernel uses.  Returns ``(splits, ranges)``."""
    side = -(-n // DW_TILE)
    tiles = side * (side + 1) // 2
    steps = batch * -(-d // DW_STEP)
    splits = max(1, min(steps, sms // tiles))
    return splits, [range(s * steps // splits, (s + 1) * steps // splits)
                    for s in range(splits)]


def dw_workspace_numel(n: int, splits: int) -> int:
    """f32 entries of bf16 K2-dW's workspace: one partial 128 x 128 tile per
    (split, tile of the lower triangle)."""
    side = -(-n // DW_TILE)
    return splits * side * (side + 1) // 2 * DW_TILE * DW_TILE


def spatial_gate_dw(dout: torch.Tensor, res: torch.Tensor,
                    gate: torch.Tensor) -> torch.Tensor:
    """``tril(sum_b (dout * res)_b . gate_b^T)``, ``(n, n)`` in the inputs'
    dtype, the strict upper triangle exactly 0."""
    global dw_launches
    if _device(gate) == "cpu":
        return plain.spatial_gate_dw(dout, res, gate)
    _check_rows(dout, res, gate)
    kernels.check_aligned(dout, res, gate)
    n, d = gate.shape[-2], gate.shape[-1]
    batch = gate.numel() // (n * d)
    f32 = gate.dtype == torch.float32
    fn = _kernel_fn(f"{BWD}_dw" if f32 else f"{BWD}_dw_split", BWD, 4 if f32 else 5)
    dw = torch.empty((n, n), dtype=gate.dtype, device=gate.device)
    stream = torch.cuda.current_stream(gate.device).cuda_stream
    if f32:
        err = fn(dout.data_ptr(), res.data_ptr(), gate.data_ptr(), dw.data_ptr(),
                 batch, n, d, DTYPES[gate.dtype], stream)
    else:
        sms = torch.cuda.get_device_properties(gate.device).multi_processor_count
        splits, _ = dw_split(batch, n, d, sms)
        work = torch.empty(dw_workspace_numel(n, splits), dtype=torch.float32,
                           device=gate.device)
        err = fn(dout.data_ptr(), res.data_ptr(), gate.data_ptr(), work.data_ptr(),
                 dw.data_ptr(), batch, n, d, splits, stream)
    if err != 0:
        raise RuntimeError(f"{BWD}_dw launch failed with CUDA error {err}")
    dw_launches += 1
    return dw


class SpatialGateFn(torch.autograd.Function):
    """K2-fwd forward; the backward of ``pallas_sgu.py:_sgu_bwd``."""

    @staticmethod
    def forward(ctx, res, gate, weights, biases):
        out = spatial_gate_fwd(res, gate, weights, biases)
        ctx.save_for_backward(res, gate, weights, biases)
        return out

    @staticmethod
    def backward(ctx, dout):
        res, gate, weights, biases = ctx.saved_tensors
        dout = dout.contiguous()
        d_res = spatial_gate_fwd(dout, gate, weights, biases)
        d_gate = spatial_gate_dgate(weights, dout, res)
        d_w = spatial_gate_dw(dout, res, gate)
        lead = tuple(range(dout.dim() - 2))
        d_b = (dout * res).float().sum(lead + (dout.dim() - 1,))
        return d_res, d_gate, d_w, d_b.reshape(-1, 1).to(biases.dtype)


def gated_mix(res: torch.Tensor, gate: torch.Tensor, weights: torch.Tensor,
              biases: torch.Tensor) -> torch.Tensor:
    """``res * cast(tril(weights) @ gate + biases)`` with a backward through
    the kernels.  Under ``torch.no_grad()`` it runs K2-fwd once and nothing
    else."""
    return SpatialGateFn.apply(res, gate, weights, biases)
