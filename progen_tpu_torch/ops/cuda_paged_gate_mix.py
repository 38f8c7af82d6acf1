"""Ragged paged gate mix: the hand-written CUDA kernels and the wrapper the
paged decode step calls (the port of
``progen_tpu/ops/pallas_paged_attention.py``: ``_mix_kernel`` and
``_mix_kernel_q8``).

:func:`paged_gate_mix` takes CPU tensors through the plain version
(``ops/paged_gate_mix.py``) and CUDA tensors through the kernels of
``kernels/csrc/paged_gate_mix.cu``, built at first use: K3 when neither side
is quantized, K3-q8 when the weights, the pool or both are int8.  On a CUDA
tensor it launches a kernel or raises; there is no ``impl`` switch and no
fallback.  Two routes, picked by :func:`route` before the launch: ``"bulk"``
(the row walk split across blocks, fed by asynchronous bulk copies; the
splits' sums meet in split order, within a thread-block cluster through
distributed shared memory, across clusters through a ticket) for every pool
whose rows are a multiple of 16 bytes, ``"simt"`` (the first kernel) for
the rest.
``launches`` and ``q8_launches`` count the launches of K3 and K3-q8, and
nothing else; ``route_launches`` counts both by route.  :func:`k3_splits`
mirrors the bulk kernel's grid and walks.  :func:`write_gate_row` is a
scatter in plain PyTorch on either device, as it is plain JAX in the JAX
package.
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

# the bulk kernel's plan (paged_gate_mix.cu, namespace bk; the library
# reports its own through paged_gate_mix_bulk_plan): rows of the walk a
# block takes (f32 and bf16 pools, int8 pools), bytes of each pool row a
# block owns, rows a ring stage holds, consumer row groups (group g sums the
# split's rows i with i % GROUPS == g), splits whose blocks form a
# thread-block cluster
SPLIT_ROWS = 32
SPLIT_ROWS_INT8 = 16
SLAB_BYTES = 2048
STAGE_ROWS = 8
GROUPS = 2
CLUSTER = 8

launches = 0
q8_launches = 0
route_launches = {"bulk": 0, "simt": 0}
_fns: dict[str, ctypes._CFuncPtr] = {}
# per device, every ticket buffer handed out (the newest last): a captured
# graph keeps the address it was captured with, so none is ever freed
_tickets: dict[torch.device, list[torch.Tensor]] = {}


def _kernel_fn(name: str, n_tensors: int, n_ints: int):
    if name not in _fns:
        fn = getattr(kernels.load(LIBRARY), name)
        fn.argtypes = ([ctypes.c_void_p] * n_tensors + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def route(pool_dtype: torch.dtype, d: int) -> str:
    """Which kernel takes a pool of ``pool_dtype`` rows of ``d`` channels:
    ``"bulk"`` when a row is a multiple of 16 bytes (bulk copies move
    16-byte units), ``"simt"`` otherwise.  The page size does not matter:
    the bulk kernel copies row by row."""
    return "bulk" if d * pool_dtype.itemsize % 16 == 0 else "simt"


def split_rows(pool_dtype: torch.dtype) -> int:
    """Rows of the walk a bulk block takes: an int8 row is one slab, so an
    int8 pool's splits are half as long and its grid as wide."""
    return SPLIT_ROWS_INT8 if pool_dtype.itemsize == 1 else SPLIT_ROWS


def k3_grid(n: int, d: int, page_size: int, pages_per_row: int,
            pool_dtype: torch.dtype, batch: int) -> tuple[int, int, int]:
    """The bulk kernel's grid ``(splits, slabs, batch)``, splits in whole
    clusters: from the shapes alone, never from the positions, so a
    captured launch serves any."""
    clusters = -(-min(n, pages_per_row * page_size) // (split_rows(pool_dtype) * CLUSTER))
    return clusters * CLUSTER, -(-d * pool_dtype.itemsize // SLAB_BYTES), batch


def k3_splits(pos, n: int, d: int, page_size: int, pages_per_row: int,
              pool_dtype: torch.dtype) -> tuple[tuple[int, int, int], list[tuple]]:
    """The bulk kernel's grid and, for each of its blocks in launch order
    (split fastest, then slab, then batch row), ``(b, slab, split, rows,
    channels, live)``: ``rows`` the walk's rows the block sums, ``channels``
    the channels it owns, ``live`` the number of splits of row ``b`` that
    sum.  The splits ``s < live`` sum in order within their cluster (``s //
    CLUSTER``), the clusters in order after; the blocks of a cluster with no
    live split exit at once, the others join their cluster's barriers.  The
    formulas of ``paged_gate_mix_bulk_kernel``."""
    splits, slabs, batch = k3_grid(n, d, page_size, pages_per_row, pool_dtype, len(pos))
    width = SLAB_BYTES // pool_dtype.itemsize
    rows_per_split = split_rows(pool_dtype)
    blocks = []
    for b, p in enumerate(int(p) for p in pos):
        last = min(p, n - 1, pages_per_row * page_size - 1)
        live = 1 if last < 0 else last // rows_per_split + 1
        for slab in range(slabs):
            channels = range(slab * width, min(d, (slab + 1) * width))
            for split in range(splits):
                r0 = split * rows_per_split
                rows = range(r0, min(last + 1, r0 + rows_per_split)) if split < live else range(0)
                blocks.append((b, slab, split, rows, channels, live))
    return (splits, slabs, batch), blocks


def _tickets_for(device: torch.device, count: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``count`` tickets on ``device``;
    each launch leaves its tickets at zero."""
    held = _tickets.setdefault(device, [])
    if not held or held[-1].numel() < count:
        held.append(torch.zeros(max(count, 1024), dtype=torch.int32, device=device))
    return held[-1]


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


def launch(mix_route: str, weights: torch.Tensor, biases: torch.Tensor,
           pool: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
           w_scale: torch.Tensor | None = None,
           pool_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K3 (or K3-q8, with a scale) on the named route, whatever
    :func:`route` says; :func:`paged_gate_mix` launches the route
    :func:`route` names.  CUDA tensors only; raises if the launch fails."""
    global launches, q8_launches
    if pool.device.type != "cuda":
        raise ValueError(f"no kernel for device {pool.device}")
    if mix_route not in route_launches:
        raise ValueError(f"no route {mix_route!r}")
    _check(weights, biases, pool, table, pos, w_scale, pool_scale)
    batch, pages_per_row = table.shape
    num_pages, page_size, d = pool.shape
    n = weights.shape[0]
    shape = (batch, n, d, page_size, pages_per_row, num_pages)
    q8 = w_scale is not None or pool_scale is not None
    name = "paged_gate_mix_q8" if q8 else "paged_gate_mix"
    dtypes = (DTYPES[weights.dtype], DTYPES[pool.dtype]) if q8 else (DTYPES[pool.dtype],)
    n_tensors = 8 if q8 else 6
    if mix_route == "bulk":
        if route(pool.dtype, d) != "bulk":
            raise ValueError(f"the bulk kernel takes rows that are a multiple of "
                             f"16 bytes, got {d} x {pool.dtype}")
        kernels.check_aligned(pool)
        fn = _kernel_fn(f"{name}_bulk", n_tensors + 2, len(shape) + 1 + len(dtypes))
    else:
        fn = _kernel_fn(name, n_tensors, len(shape) + len(dtypes))
    out = torch.empty((batch, d), dtype=torch.float32, device=pool.device)
    scales = ((None if w_scale is None else w_scale.data_ptr(),
               None if pool_scale is None else pool_scale.data_ptr()) if q8 else ())
    head = (weights.data_ptr(), biases.data_ptr(), pool.data_ptr(), table.data_ptr(),
            pos.data_ptr(), *scales, out.data_ptr())
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    if mix_route == "bulk":
        splits, slabs, _ = k3_grid(n, d, page_size, pages_per_row, pool.dtype, batch)
        partials = torch.empty((batch, splits // CLUSTER, d), dtype=torch.float32,
                               device=pool.device)
        tickets = _tickets_for(pool.device, batch * slabs * CLUSTER)
        err = fn(*head, partials.data_ptr(), tickets.data_ptr(), *shape, splits, *dtypes,
                 stream)
    else:
        err = fn(*head, *shape, *dtypes, stream)
    if err != 0:
        raise RuntimeError(f"{name} ({mix_route}) launch failed with CUDA error {err}")
    if q8:
        q8_launches += 1
    else:
        launches += 1
    route_launches[mix_route] += 1
    return out


def paged_gate_mix(weights: torch.Tensor, biases: torch.Tensor,
                   pool: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                   *, n_rows: int, w_scale: torch.Tensor | None = None,
                   pool_scale: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b] = sum_{i <= pos_b} W[pos_b, i] * pool[table[b, i // ps],
    i % ps] + bias[pos_b]``, ``(B, d)`` f32; arguments as the plain
    version's.  On the card ``table`` and ``pos`` must be int32, and
    ``n_rows`` is not needed (the kernel walks ``pos_b + 1`` rows)."""
    if pool.device.type == "cpu":
        return plain.paged_gate_mix(weights, biases, pool, table, pos,
                                    n_rows=n_rows, w_scale=w_scale,
                                    pool_scale=pool_scale)
    return launch(route(pool.dtype, pool.shape[-1]), weights, biases, pool, table, pos,
                  w_scale=w_scale, pool_scale=pool_scale)
