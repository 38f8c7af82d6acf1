"""Ragged paged gate mix, plain PyTorch versions (ported from
progen_tpu/ops/pallas_paged_attention.py: ``_xla_mix`` and
``write_gate_row``).

The attention k/v cache of this architecture is already an O(2 * window)
ring per slot; the per-token state that grows with the request is the
**SGU gate cache**, which the spatial gating unit contracts over ALL
previous rows.  The paged engine keeps those rows in a global pool
``(num_pages, page_size, d)`` and a per-row page table ``(B,
pages_per_row)``; for batch row ``b`` at position ``pos_b``::

    mixed[b] = sum_{i <= pos_b} W[pos_b, i] * pool[table[b, i // ps], i % ps]
               + bias[pos_b]

:func:`paged_gate_mix` here gathers each row's pages, slices to the dense
cache length and runs the SAME masked f32 contraction as the dense decode
step (``decode/incremental.py:sgu_decode``), so on the CPU the paged and the
dense step agree bit for bit.  The hand-written kernels and the wrappers the
decode step calls are in ``ops/cuda_paged_gate_mix.py``.
"""

from __future__ import annotations

import torch

from progen_tpu_torch.ops.quant import quantize_rows

# The pool's two reserved pages, as ``decode/paging.py`` names them (the
# decode package imports this module, so the names are repeated here; a test
# holds the two pairs equal): page 0 is all zeros and never written, page 1
# is a write sink that is never read.
NULL_PAGE = 0
DUMP_PAGE = 1


def paged_gate_mix(weights: torch.Tensor, biases: torch.Tensor,
                   pool: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                   *, n_rows: int, w_scale: torch.Tensor | None = None,
                   pool_scale: torch.Tensor | None = None) -> torch.Tensor:
    """``(B, d)`` f32 ``mixed + bias``; the caller casts to the compute
    dtype and multiplies by the gate's other half.

    ``weights`` ``(n, n)`` f32, or int8 with ``w_scale`` ``(n,)`` f32 (one
    scale per weight row); ``biases`` ``(n, 1)``; ``pool`` ``(num_pages,
    page_size, d)`` in the compute dtype, or int8 with ``pool_scale``
    ``(num_pages, page_size)`` f32; ``table`` ``(B, pages_per_row)`` int
    (``NULL_PAGE`` for unowned entries); ``pos`` ``(B,)`` int; ``n_rows``
    the dense cache length the gather is sliced to.  Stale rows of reused
    pages meet exact-zero causal weights."""
    batch, pages_per_row = table.shape
    _, page_size, d = pool.shape
    table, pos = table.long(), pos.long()
    rows = pool[table].reshape(batch, pages_per_row * page_size, d)
    rows = rows[:, :n_rows].float()
    if pool_scale is not None:
        ps = pool_scale[table].reshape(batch, pages_per_row * page_size)
        rows = rows * ps[:, :n_rows, None]
    w_rows = weights[pos].float()[:, :n_rows]
    if w_scale is not None:
        w_rows = w_rows * w_scale.float()[pos][:, None]
    n = rows.shape[1]
    causal = torch.arange(n, device=pool.device)[None, :] <= pos[:, None]
    w_rows = w_rows[:, :n] * causal.float()
    mixed = torch.einsum("bnd,bn->bd", rows, w_rows)
    return mixed + biases.float()[pos]


def write_gate_row(pool: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                   gate: torch.Tensor, write_ok: torch.Tensor,
                   scale: torch.Tensor | None = None, group=None):
    """Scatter each live row's fresh gate row into its page, IN PLACE.

    Rows with ``write_ok`` false (done, inactive, paused) and rows whose
    table entry is still ``NULL_PAGE`` are redirected to the write sink
    ``DUMP_PAGE``: the scatter stays dense and unpredicated, and the zero
    page and read-only shared pages are never written.  With ``scale`` (the
    ``(num_pages, page_size)`` f32 scale pool of an int8 gate pool) the row
    is quantized per row on the way: its int8 code and its scale land
    through the same redirected target, and the call returns ``(pool,
    scale)`` instead of ``pool``.  ``group``: the pool holds a rank's
    channels of each row; the row's scale is the whole row's
    (``quantize_rows``)."""
    page_size = pool.shape[1]
    pos = pos.long()
    tgt = torch.gather(table.long(), 1, (pos // page_size)[:, None])[:, 0]
    tgt = torch.where(write_ok & (tgt != NULL_PAGE), tgt, DUMP_PAGE)
    off = pos % page_size
    if scale is None:
        pool[tgt, off] = gate.to(pool.dtype)
        return pool
    q, s = quantize_rows(gate, group)
    pool[tgt, off] = q
    scale[tgt, off] = s
    return pool, scale
