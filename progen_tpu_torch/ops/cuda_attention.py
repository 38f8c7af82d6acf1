"""Windowed local attention: the hand-written CUDA kernels, their wrappers
and the autograd function the model calls (the port of
``progen_tpu/ops/pallas_attention.py``: ``_fwd_kernel``, ``_dq_kernel`` and
``_dkv_kernel``).

``local_attention_fwd`` and ``local_attention_bwd`` take a CPU tensor
through the plain versions (``ops/local_attention.py``) and a CUDA tensor
through the kernels (``kernels/csrc/local_attention_fwd.cu`` and
``local_attention_bwd.cu``; ``local_attention_bwd_dq`` and
``local_attention_bwd_dkv`` launch one backward kernel each), which they
build at first use.  On a CUDA tensor they launch the kernels or raise;
they never fall back.  ``launches``, ``dq_launches`` and ``dkv_launches``
count the launches of K1-fwd, K1-dq and K1-dkv, and nothing else.

Every kernel has two routes, chosen before the launch by :func:`fwd_route`
and :func:`bwd_route` from the dtype, ``dim_head`` and the window alone:
bf16 with ``dim_head`` 64 or 128 and windows that are multiples of 128 take
the Hopper kernels (a TMA ring into ``wgmma``, ``"wgmma"``); f32,
``dim_head`` 32 and other windows take the WMMA kernels (``"wmma"``).  A
failure on one route raises; it never tries the other.
``fwd_route_launches`` and ``bwd_route_launches`` count the launches of each
route.

:func:`local_attention` is what the model calls: K1-fwd once, and under
autograd K1-dq and K1-dkv in the backward, from the saved q, k, v, out and
the forward's lse.
"""

from __future__ import annotations

import ctypes

import torch

from progen_tpu_torch import kernels
from progen_tpu_torch.ops.local_attention import local_attention as plain_fwd
from progen_tpu_torch.ops.local_attention import local_attention_bwd as plain_bwd

KERNEL = "local_attention_fwd"
BWD = "local_attention_bwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DIM_HEADS = (32, 64, 128)

# the bf16 Hopper kernels' tiling (attention_wgmma.cuh): a block owns 128
# rows of one window, two warpgroups of 64, and streams 64-row tiles of the
# other side
BWD_ROWS = 128
BWD_TILE = 64
WGMMA_DIM_HEADS = (64, 128)

launches = 0
fwd_route_launches = {"wgmma": 0, "wmma": 0}
dq_launches = 0
dkv_launches = 0
bwd_route_launches = {"wgmma": 0, "wmma": 0}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel_fn(name: str, library: str, n_tensors: int):
    if name not in _fns:
        fn = getattr(kernels.load(library), name)
        fn.argtypes = ([ctypes.c_void_p] * n_tensors + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(q, k, v, window_size, *more):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, L, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    n, d = q.shape[2], q.shape[3]
    if window_size <= 0 or n % window_size != 0:
        raise ValueError(f"sequence length {n} must be divisible by window "
                         f"{window_size}")
    tensors = (q, k, v, *more)
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"the kernel takes float32 or bfloat16 tensors of one "
                         f"dtype, got {[t.dtype for t in tensors]}")
    if d not in DIM_HEADS:
        raise ValueError(f"the kernel takes dim_head in {DIM_HEADS}, got {d}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if any(t.device != q.device for t in tensors):
        raise ValueError("the kernel's tensors must be on one device")


def local_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window_size: int, scale: float | None = None):
    """Windowed attention over ``(B, H, L, D)`` -> ``(out, lse)``: ``out``
    ``(B, H, L, D)`` in q's dtype and the per-row logsumexp ``lse``
    ``(B, H, L)`` in f32."""
    global launches
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return plain_fwd(q, k, v, window_size=window_size, scale=scale,
                         return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window_size)
    b, h, n, d = q.shape
    route = fwd_route(q.dtype, d, window_size)
    name = KERNEL if route == "wmma" else f"{KERNEL}_wgmma"
    if route == "wgmma":
        kernels.check_aligned(q, k, v)
    fn = _kernel_fn(name, KERNEL, 5)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b * h, n, d, window_size, float(scale),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launches += 1
    fwd_route_launches[route] += 1
    return out, lse


def bwd_route(dtype: torch.dtype, dim_head: int, window_size: int) -> str:
    """Which backward kernels take these shapes: ``"wgmma"`` (the Hopper
    kernels) for bf16, ``dim_head`` in (64, 128) and a window that is a
    multiple of 128; ``"wmma"`` for everything else the kernels take."""
    if (dtype == torch.bfloat16 and dim_head in WGMMA_DIM_HEADS
            and window_size > 0 and window_size % BWD_ROWS == 0):
        return "wgmma"
    return "wmma"


def fwd_route(dtype: torch.dtype, dim_head: int, window_size: int) -> str:
    """Which K1-fwd kernel takes these shapes: the same rule as
    :func:`bwd_route` (the Hopper forward walks what K1-dq walks)."""
    return bwd_route(dtype, dim_head, window_size)


def k1_fwd_tiles(n: int, window_size: int) -> list[tuple[int, list[tuple[int, int, str]]]]:
    """The bf16 K1-fwd kernel's blocks and walks, the formulas of
    ``local_attention_fwd.cu`` (``fwg::block_row``) and
    ``attention_wgmma.cuh`` (``dq_first``, ``dq_tiles``, ``dq_kind``): for
    each block of one (b, h) in launch order, longest walk first, its first
    query row ``b0`` and, for each streamed 64-key tile ``t0`` in order and
    each of its two warpgroups' rows ``r0``, ``(r0, t0, kind)``.  Rows of
    window 0 also count the phantom window's ``wsz`` zero logits, as an
    exact term.  A block at place p of window w >= 1 walks
    ``wsz / 64 + 2 p + 2`` tiles, one of window 0 ``2 p + 2``."""
    wsz, wins, places = window_size, n // window_size, window_size // BWD_ROWS
    later = (wins - 1) * places  # blocks outside window 0
    blocks = []
    for rank in range(n // BWD_ROWS):
        if rank < later:
            b0 = ((wins - 1 - rank % (wins - 1)) * wsz
                  + (places - 1 - rank // (wins - 1)) * BWD_ROWS)
        else:
            b0 = (places - 1 - (rank - later)) * BWD_ROWS
        first = max(0, (b0 // wsz - 1) * wsz)
        walk = []
        for it in range((b0 + BWD_TILE - first) // BWD_TILE + 1):
            t0 = first + BWD_TILE * it
            for r0 in (b0, b0 + BWD_TILE):
                kind = "full" if t0 < r0 else "diagonal" if t0 == r0 else "skipped"
                walk.append((r0, t0, kind))
        blocks.append((b0, walk))
    return blocks


def k1_bwd_tiles(n: int, window_size: int, side: str) -> list[tuple[int, int, str]]:
    """The bf16 backward kernels' tile walk, the formulas of
    ``attention_wgmma.cuh`` (``dq_tiles``, ``dq_kind``, ``dkv_tiles``,
    ``dkv_kind``): for each block, in order, each of its two warpgroups'
    ``(r0, t0, kind)`` with every streamed tile, ``kind`` one of ``"full"``,
    ``"diagonal"`` (causal mask inside the tile) and ``"skipped"``.
    ``side="dq"``: rows r0.. are queries, tiles t0.. keys; ``side="dkv"``:
    rows are keys, tiles queries (K1-dkv walks them twice, once for dv and
    once for dk).  Every tile is 64 rows."""
    if side not in ("dq", "dkv"):
        raise ValueError(f"side must be 'dq' or 'dkv', got {side!r}")
    wsz, pairs = window_size, []
    for b0 in range(0, n, BWD_ROWS):
        if side == "dq":
            first = max(0, (b0 // wsz - 1) * wsz)
            tiles = (b0 + BWD_TILE - first) // BWD_TILE + 1
        else:
            first = b0
            tiles = (min((b0 // wsz + 2) * wsz, n) - b0) // BWD_TILE
        for it in range(tiles):
            t0 = first + BWD_TILE * it
            for r0 in (b0, b0 + BWD_TILE):
                below = t0 < r0 if side == "dq" else t0 > r0
                kind = "full" if below else "diagonal" if t0 == r0 else "skipped"
                pairs.append((r0, t0, kind))
    return pairs


def _check_rows(q, *rows):
    """The backward kernels' per-row f32 inputs, on q's CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernels take CUDA tensors, got {q.device}")
    b, h, n = q.shape[:3]
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, n) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"lse and D must be contiguous float32 ({b}, {h}, {n}) "
                             f"tensors on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def local_attention_bwd_dq(q, k, v, do, lse, dd, window_size: int,
                           scale: float | None = None) -> torch.Tensor:
    """K1-dq on CUDA tensors: ``dq`` ``(B, H, L, D)`` in q's dtype, from the
    forward's f32 ``lse`` and ``dd = rowsum(do * out)`` in f32, ``(B, H, L)``
    each."""
    global dq_launches
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _check(q, k, v, window_size, do)
    _check_rows(q, lse, dd)
    kernels.check_aligned(q, k, v, do, lse, dd)
    b, h, n, d = q.shape
    route = bwd_route(q.dtype, d, window_size)
    name = f"{BWD}_dq" if route == "wmma" else f"{BWD}_dq_wgmma"
    fn = _kernel_fn(name, BWD, 7)
    dq = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), b * h, n, d,
             window_size, float(scale), DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    dq_launches += 1
    bwd_route_launches[route] += 1
    return dq


def local_attention_bwd_dkv(q, k, v, do, lse, dd, window_size: int,
                            scale: float | None = None):
    """K1-dkv on CUDA tensors: ``(dk, dv)`` of the real keys, each
    ``(B, H, L, D)`` in q's dtype; arguments as for
    :func:`local_attention_bwd_dq`."""
    global dkv_launches
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _check(q, k, v, window_size, do)
    _check_rows(q, lse, dd)
    kernels.check_aligned(q, k, v, do, lse, dd)
    b, h, n, d = q.shape
    route = bwd_route(q.dtype, d, window_size)
    name = f"{BWD}_dkv" if route == "wmma" else f"{BWD}_dkv_wgmma"
    fn = _kernel_fn(name, BWD, 8)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h,
             n, d, window_size, float(scale), DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    dkv_launches += 1
    bwd_route_launches[route] += 1
    return dk, dv


def local_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        window_size: int, scale: float | None = None):
    """Gradients ``(dq, dk, dv)``, each ``(B, H, L, D)`` in q's dtype, from
    the forward's ``out`` and f32 ``lse`` and the cotangent ``do``:
    ``D = rowsum(do * out)`` in f32 (a plain reduction, as in the TPU
    package), then K1-dq and K1-dkv."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, out, lse, do, window_size, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window_size, out, do)
    _check_rows(q, lse)
    dd = (do.float() * out.float()).sum(-1)
    dq = local_attention_bwd_dq(q, k, v, do, lse, dd, window_size, scale)
    dk, dv = local_attention_bwd_dkv(q, k, v, do, lse, dd, window_size, scale)
    return dq, dk, dv


class LocalAttentionFn(torch.autograd.Function):
    """K1-fwd forward; K1-dq and K1-dkv backward from the saved q, k, v,
    out and lse (``pallas_attention.py``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, window_size, scale):
        out, lse = local_attention_fwd(q, k, v, window_size, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window_size, ctx.scale = window_size, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = local_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.window_size, ctx.scale)
        return dq, dk, dv, None, None


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window_size: int, scale: float | None = None) -> torch.Tensor:
    """Windowed attention over ``(B, H, L, D)`` with a backward through the
    kernels.  Under ``torch.no_grad()`` it runs K1-fwd once and nothing
    else."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return LocalAttentionFn.apply(q, k, v, window_size, scale)
