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

Each kernel's route is chosen before the launch by :func:`fwd_route`,
:func:`dq_route` and :func:`dkv_route` from the dtype, ``dim_head`` and the
window alone; the three share one rule.  ``dim_head`` 32, 64 or 128 with a
window that is a multiple of 128 (every shipped config) takes the Hopper
kernels: in bf16 a TMA ring into ``wgmma`` (``"wgmma"``), in f32 the
tensor cores as three TF32 products a product (``"tf32x3"``, a
``cp.async`` ring into ``mma.sync``), all three kernels in both.  At
``dim_head`` 32 (``default``) they are kernels of their own, in blocks of
64 rows: in bf16 one consumer warpgroup fed by 64-byte-swizzled TMA copies,
in f32 four warps that hold their own operands' split in registers.
Everything else (a window that is no multiple of 128) takes the WMMA
kernels (``"wmma"``; their f32 products are FMA loops).  A failure on one route raises; it never tries another.  ``fwd_route_launches``,
``dq_route_launches`` and ``dkv_route_launches`` count the launches of each
route, and ``route="wmma"`` forces a launch onto the first kernel (to time
it on the same inputs).

:func:`local_attention` is what the model calls: K1-fwd once, and under
autograd K1-dq and K1-dkv in the backward, from the saved q, k, v, out and
the forward's lse.

Every entry takes an optional halo, ``k_halo``/``v_halo`` ``(B, H, wsz, D)``:
window 0's previous window in place of the phantom zeros (the port of
``pallas_local_attention_ext``, ``pallas_attention.py:258``; the left
neighbour's last window under context parallelism, ``parallel/context.py``).
It is one more source of the same three kernels, not another kernel: K1-dkv
then also writes the halo's ``dk_halo``/``dv_halo``, which
:class:`LocalAttentionFn` returns as the halo's gradients.
``halo_launches``, ``halo_dq_launches`` and ``halo_dkv_launches`` count the
launches that took a halo (they are in the three counts above too).
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

# the Hopper kernels' tiling (attention_wgmma.cuh, attention_tf32x3.cuh): a
# block owns 128 rows of one window (two warpgroups of 64 in bf16, eight
# warps of 16 in f32) and streams tiles of the other side (64 rows in bf16;
# in f32 64 keys for K1-fwd, 32 keys for K1-dq, 32 queries for K1-dkv)
BWD_ROWS = 128
BWD_TILE = 64
TF32X3_WARP_ROWS = 16
TF32X3_BWD_TILE = 32
# dim_head 32: all three kernels in blocks of 64 rows, in f32
# (attention_tf32x3.cuh, d32) four warps of 16 streaming tiles of 64 keys
# (K1-fwd), 32 keys (K1-dq: TF32X3_BWD_TILE) or 32 queries (K1-dkv), in bf16
# (attention_wgmma.cuh, d32) one warpgroup streaming tiles of 64 keys or 64
# queries
D32_ROWS = 64
D32_KEYS = 64
# each route's extern "C" suffix
SUFFIX = {"wmma": "", "wgmma": "_wgmma", "tf32x3": "_tf32x3"}

launches = 0
fwd_route_launches = {"wgmma": 0, "tf32x3": 0, "wmma": 0}
dq_launches = 0
dkv_launches = 0
halo_launches = 0
halo_dq_launches = 0
halo_dkv_launches = 0
dq_route_launches = {"wgmma": 0, "tf32x3": 0, "wmma": 0}
dkv_route_launches = {"wgmma": 0, "tf32x3": 0, "wmma": 0}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel_fn(name: str, library: str, n_tensors: int):
    if name not in _fns:
        fn = getattr(kernels.load(library), name)
        fn.argtypes = ([ctypes.c_void_p] * n_tensors + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_halo(q, window_size, k_halo, v_halo) -> None:
    """A halo is two contiguous ``(B, H, wsz, D)`` tensors of q's dtype on
    q's device, or none."""
    if (k_halo is None) != (v_halo is None):
        raise ValueError("k_halo and v_halo come together")
    if k_halo is None:
        return
    want = (*q.shape[:2], window_size, q.shape[3])
    for t in (k_halo, v_halo):
        if (tuple(t.shape) != want or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"the halo must be contiguous {want} {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


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


def _forced(route: str | None, chosen: str) -> str:
    """The route to launch: ``chosen``, or a forced ``route`` that is
    ``"wmma"`` (which takes every shape the kernels take) or ``chosen``."""
    if route not in (None, "wmma", chosen):
        raise ValueError(f"route {route!r} does not take this launch (its route is "
                         f"{chosen!r}; 'wmma' takes any)")
    return route or chosen


def local_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window_size: int, scale: float | None = None,
                        k_halo: torch.Tensor | None = None,
                        v_halo: torch.Tensor | None = None, route: str | None = None):
    """Windowed attention over ``(B, H, L, D)`` -> ``(out, lse)``: ``out``
    ``(B, H, L, D)`` in q's dtype and the per-row logsumexp ``lse``
    ``(B, H, L)`` in f32; window 0's previous window is the halo when one is
    given, else the phantom zeros.  ``route`` forces a CUDA launch onto
    ``"wmma"`` instead of :func:`fwd_route`'s (to time the first kernel on
    the same inputs)."""
    global launches, halo_launches
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return plain_fwd(q, k, v, window_size=window_size, scale=scale,
                         return_lse=True, k_halo=k_halo, v_halo=v_halo)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window_size)
    _check_halo(q, window_size, k_halo, v_halo)
    b, h, n, d = q.shape
    route = _forced(route, fwd_route(q.dtype, d, window_size))
    name = KERNEL + SUFFIX[route]
    if route != "wmma":
        kernels.check_aligned(q, k, v, *(t for t in (k_halo, v_halo) if t is not None))
    fn = _kernel_fn(name, KERNEL, 7)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_halo), _ptr(v_halo),
             out.data_ptr(), lse.data_ptr(), b * h, n, d, window_size, float(scale),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launches += 1
    halo_launches += k_halo is not None
    fwd_route_launches[route] += 1
    return out, lse


def dq_route(dtype: torch.dtype, dim_head: int, window_size: int) -> str:
    """Which K1-dq kernel takes these shapes: ``dim_head`` 32, 64 or 128 and
    a window that is a multiple of 128 (the Hopper kernels' blocks of 128
    rows, 64 at dim_head 32) take ``"wgmma"`` in bf16 and ``"tf32x3"`` in
    f32; everything else the kernels take ``"wmma"``."""
    if dim_head not in DIM_HEADS or window_size <= 0 or window_size % BWD_ROWS != 0:
        return "wmma"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def fwd_route(dtype: torch.dtype, dim_head: int, window_size: int) -> str:
    """Which K1-fwd kernel takes these shapes: :func:`dq_route`'s rule."""
    return dq_route(dtype, dim_head, window_size)


def dkv_route(dtype: torch.dtype, dim_head: int, window_size: int) -> str:
    """Which K1-dkv kernel takes these shapes: :func:`dq_route`'s rule."""
    return dq_route(dtype, dim_head, window_size)


def k1_fwd_tiles(n: int, window_size: int, halo: bool = False, block: int = BWD_ROWS,
                 rows: int = BWD_TILE,
                 tile: int = BWD_TILE) -> list[tuple[int, list[tuple[int, int, str]]]]:
    """The Hopper K1-fwd kernels' blocks and walks, the formulas of
    ``attention_wgmma.cuh`` (``block_row``, ``dq_first``, ``dq_tiles``,
    ``dq_kind``) and of ``attention_tf32x3.cuh`` (``d32::fwd_block_row``):
    for each block of one (b, h) in launch order, longest walk first, its
    first query row ``b0`` and, for each streamed ``tile``-key tile ``t0``
    in order and each of its row groups' rows ``r0`` (``rows`` each),
    ``(r0, t0, kind)``, ``kind`` one of ``"full"``, ``"diagonal"`` (the
    causal mask inside the tile) and ``"skipped"``.  The defaults are the
    128-row blocks of both routes at dim_head 64 and 128 (two warpgroups of
    64 rows; the f32 route's warps cut each in four); dim_head 32 takes
    ``block=D32_ROWS, tile=D32_KEYS`` with ``rows=TF32X3_WARP_ROWS`` in f32
    (four warps) and ``rows=D32_ROWS`` in bf16 (one warpgroup), for K1-fwd
    and for K1-dq, which walks K1-fwd's blocks (its f32 kernel in tiles of
    :data:`TF32X3_BWD_TILE` keys).  Rows
    of window 0 also count the phantom window's ``wsz`` zero logits, as an
    exact term.  A block at place p of window w >= 1 walks
    ``(wsz + block (p + 1)) / tile`` tiles, one of window 0
    ``block (p + 1) / tile``.  With a ``halo`` window 0 walks the halo's
    tiles first (``t0`` in ``[-wsz, 0)``), as many tiles as any other
    window."""
    wsz, wins, places = window_size, n // window_size, window_size // block
    later = (wins - 1) * places  # blocks outside window 0
    blocks = []
    for rank in range(n // block):
        if rank < later:
            b0 = ((wins - 1 - rank % (wins - 1)) * wsz
                  + (places - 1 - rank // (wins - 1)) * block)
        else:
            b0 = (places - 1 - (rank - later)) * block
        first = (b0 // wsz - 1) * wsz if halo else max(0, (b0 // wsz - 1) * wsz)
        walk = []
        for it in range((b0 + block - first) // tile):
            t0 = first + tile * it
            for r0 in range(b0, b0 + block, rows):
                kind = ("full" if t0 + tile - 1 <= r0 else
                        "skipped" if t0 > r0 + rows - 1 else "diagonal")
                walk.append((r0, t0, kind))
        blocks.append((b0, walk))
    return blocks


def k1_dkv_blocks(n: int, window_size: int, halo: bool = False,
                  block: int = D32_ROWS) -> list[int]:
    """The K1-dkv kernels' key blocks at dim_head 32 in launch order, f32
    and bf16 (``attention_tf32x3.cuh``'s ``d32::dkv_block_row``), longest walk
    first: each block's first key row ``b0``.  A block at place p of a
    window but the last streams ``2 wsz - block p`` queries, one of the last
    window ``wsz - block p``; with a ``halo`` the halo's blocks
    (``b0 < 0``, window 0's ``wsz`` queries each) come last."""
    wsz, wins, places = window_size, n // window_size, window_size // block
    early = (wins - 1) * places  # blocks outside the last window
    b0s = [(r % (wins - 1)) * wsz + (r // (wins - 1)) * block for r in range(early)]
    b0s += [(wins - 1) * wsz + p * block for p in range(places)]
    return b0s + (list(range(-wsz, 0, block)) if halo else [])


def k1_bwd_tiles(n: int, window_size: int, side: str, halo: bool = False,
                 tile: int = BWD_TILE, rows: int = BWD_TILE,
                 block: int = BWD_ROWS,
                 blocks: list[int] | None = None) -> list[tuple[int, int, str]]:
    """The Hopper backward kernels' tile walk, the formulas of
    ``attention_wgmma.cuh`` (``dq_first``, ``dq_tiles``, ``dq_kind``,
    ``dkv_tiles``, ``dkv_kind``) and of ``local_attention_bwd.cu``'s
    ``tf32x3`` kernels: for each block (128 rows), in order of its first
    row, each of its row groups' ``(r0, t0, kind)`` with every streamed
    tile, ``kind`` one of ``"full"``, ``"diagonal"`` (causal mask inside
    the tile) and ``"skipped"``.  ``side="dq"``: rows r0.. are queries,
    tiles t0.. keys; ``side="dkv"``: rows are keys, tiles queries (K1-dkv
    walks them twice in bf16 at dim_head 64 and 128, once for dv and once
    for dk; once at dim_head 32).  bf16 streams ``tile`` = 64 rows to two
    warpgroups of ``rows`` = 64 (one at dim_head 32); f32 streams tiles of
    32 (:data:`TF32X3_BWD_TILE`) to eight warps of 16
    (:data:`TF32X3_WARP_ROWS`; four at dim_head 32), and its K1-dq launches
    the blocks in K1-fwd's longest-first order (:func:`k1_fwd_tiles`).
    ``block`` is the rows a block owns: 128, or :data:`D32_ROWS` at
    dim_head 32 (where K1-dq streams tiles of :data:`D32_KEYS` keys in bf16
    and of :data:`TF32X3_BWD_TILE` in f32).  ``blocks`` is the blocks' first rows in launch order (K1-dkv
    at dim_head 32 passes :func:`k1_dkv_blocks`, K1-dq K1-fwd's order from
    :func:`k1_fwd_tiles`); by default they
    go in order of their first row.  With a ``halo`` the halo's rows are
    ``[-wsz, 0)``: K1-dq's window-0 blocks stream them first, and K1-dkv
    runs ``wsz / block`` more blocks after the others, for the halo's keys,
    which stream the queries of window 0."""
    if side not in ("dq", "dkv"):
        raise ValueError(f"side must be 'dq' or 'dkv', got {side!r}")
    wsz, pairs = window_size, []
    if blocks is None:
        blocks = list(range(0, n, block))
        if halo and side == "dkv":
            blocks += list(range(-wsz, 0, block))
    for b0 in blocks:
        if side == "dq":
            first = (b0 // wsz - 1) * wsz if halo else max(0, (b0 // wsz - 1) * wsz)
            tiles = (b0 + block - first) // tile
        elif b0 < 0:
            first, tiles = 0, wsz // tile
        else:
            first = b0
            tiles = (min((b0 // wsz + 2) * wsz, n) - b0) // tile
        for it in range(tiles):
            t0 = first + tile * it
            for r0 in range(b0, b0 + block, rows):
                if side == "dq":
                    full, seen = t0 + tile <= r0, t0 <= r0 + rows - 1
                else:
                    full, seen = t0 >= r0 + rows, t0 + tile - 1 >= r0
                kind = "full" if full else "diagonal" if seen else "skipped"
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
                           scale: float | None = None, k_halo=None,
                           v_halo=None, route: str | None = None) -> torch.Tensor:
    """K1-dq on CUDA tensors: ``dq`` ``(B, H, L, D)`` in q's dtype, from the
    forward's f32 ``lse`` and ``dd = rowsum(do * out)`` in f32, ``(B, H, L)``
    each; the halo as the forward took it.  ``route`` forces ``"wmma"``
    instead of :func:`dq_route`'s, as :func:`local_attention_fwd`'s does."""
    global dq_launches, halo_dq_launches
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _check(q, k, v, window_size, do)
    _check_rows(q, lse, dd)
    _check_halo(q, window_size, k_halo, v_halo)
    halo = [t for t in (k_halo, v_halo) if t is not None]
    kernels.check_aligned(q, k, v, do, lse, dd, *halo)
    b, h, n, d = q.shape
    route = _forced(route, dq_route(q.dtype, d, window_size))
    name = f"{BWD}_dq{SUFFIX[route]}"
    fn = _kernel_fn(name, BWD, 9)
    dq = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_halo), _ptr(v_halo),
             do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), b * h, n, d,
             window_size, float(scale), DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    dq_launches += 1
    halo_dq_launches += bool(halo)
    dq_route_launches[route] += 1
    return dq


def local_attention_bwd_dkv(q, k, v, do, lse, dd, window_size: int,
                            scale: float | None = None, k_halo=None, v_halo=None,
                            route: str | None = None):
    """K1-dkv on CUDA tensors: ``(dk, dv)`` of the real keys, each
    ``(B, H, L, D)`` in q's dtype, and with a halo also ``(dk_halo,
    dv_halo)``, each ``(B, H, wsz, D)``; arguments as for
    :func:`local_attention_bwd_dq`.  ``route`` forces ``"wmma"`` instead of
    :func:`dkv_route`'s, as :func:`local_attention_fwd`'s does."""
    global dkv_launches, halo_dkv_launches
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _check(q, k, v, window_size, do)
    _check_rows(q, lse, dd)
    _check_halo(q, window_size, k_halo, v_halo)
    halo = [t for t in (k_halo, v_halo) if t is not None]
    kernels.check_aligned(q, k, v, do, lse, dd, *halo)
    b, h, n, d = q.shape
    route = _forced(route, dkv_route(q.dtype, d, window_size))
    name = f"{BWD}_dkv{SUFFIX[route]}"
    fn = _kernel_fn(name, BWD, 12)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dk_halo = torch.empty_like(k_halo) if halo else None
    dv_halo = torch.empty_like(v_halo) if halo else None
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_halo), _ptr(v_halo),
             do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _ptr(dk_halo), _ptr(dv_halo), b * h, n, d, window_size, float(scale),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    dkv_launches += 1
    halo_dkv_launches += bool(halo)
    dkv_route_launches[route] += 1
    return (dk, dv, dk_halo, dv_halo) if halo else (dk, dv)


def local_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        window_size: int, scale: float | None = None,
                        k_halo: torch.Tensor | None = None,
                        v_halo: torch.Tensor | None = None):
    """Gradients ``(dq, dk, dv)``, each ``(B, H, L, D)`` in q's dtype, from
    the forward's ``out`` and f32 ``lse`` and the cotangent ``do``:
    ``D = rowsum(do * out)`` in f32 (a plain reduction, as in the TPU
    package), then K1-dq and K1-dkv.  With a halo, ``(dq, dk, dv, dk_halo,
    dv_halo)``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, out, lse, do, window_size, scale,
                         k_halo=k_halo, v_halo=v_halo)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window_size, out, do)
    _check_rows(q, lse)
    dd = (do.float() * out.float()).sum(-1)
    dq = local_attention_bwd_dq(q, k, v, do, lse, dd, window_size, scale, k_halo, v_halo)
    return (dq, *local_attention_bwd_dkv(q, k, v, do, lse, dd, window_size, scale,
                                         k_halo, v_halo))


class LocalAttentionFn(torch.autograd.Function):
    """K1-fwd forward; K1-dq and K1-dkv backward from the saved q, k, v,
    out and lse (``pallas_attention.py``'s ``custom_vjp``); with a halo the
    backward also returns its gradients (``pallas_local_attention_ext``'s
    ``dk_ext``/``dv_ext`` first window)."""

    @staticmethod
    def forward(ctx, q, k, v, window_size, scale, k_halo=None, v_halo=None):
        out, lse = local_attention_fwd(q, k, v, window_size, scale, k_halo, v_halo)
        ctx.save_for_backward(q, k, v, out, lse, k_halo, v_halo)
        ctx.window_size, ctx.scale = window_size, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, k_halo, v_halo = ctx.saved_tensors
        grads = local_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                    ctx.window_size, ctx.scale, k_halo, v_halo)
        dk_halo, dv_halo = grads[3:] if k_halo is not None else (None, None)
        return (*grads[:3], None, None, dk_halo, dv_halo)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window_size: int, scale: float | None = None,
                    k_halo: torch.Tensor | None = None,
                    v_halo: torch.Tensor | None = None) -> torch.Tensor:
    """Windowed attention over ``(B, H, L, D)`` with a backward through the
    kernels; ``k_halo``/``v_halo`` ``(B, H, wsz, D)`` as window 0's previous
    window, whose gradients flow back through them.  Under
    ``torch.no_grad()`` it runs K1-fwd once and nothing else."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return LocalAttentionFn.apply(q, k, v, window_size, scale, k_halo, v_halo)
