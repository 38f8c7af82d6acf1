"""The bulk K3 and K3-q8 kernels' plan, checked on the CPU in pure Python
and numpy: the route each pool takes (``cuda_paged_gate_mix.route``), the
split walk the kernel runs (mirrored by ``k3_splits``: each live row summed
exactly once per (batch row, slab), none past the position, no weight
column >= n, a grid from the shapes alone), a numpy emulation of the
kernel's order of sums against the plain paged gate mix (f32, 1e-5 * (1 +
|x|), the bar of tests/test_paged.py), and the kernel each wrapper asks for
before a launch on a CUDA tensor."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from progen_tpu_torch.kernels import ablate
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.ops import cuda_paged_gate_mix as k3
from progen_tpu_torch.ops import paged_gate_mix as plain_paged
from progen_tpu_torch.ops.quant import quantize_rows, quantize_w
from tests.test_torch_train_ops import check_ablation_applies

torch.set_num_threads(1)

POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", POOL_DTYPES, ids=str)
def test_every_shipped_config_takes_the_bulk_route(name, dtype):
    """The gMLP half width of every config (2048 at ProGen-small) is a
    multiple of 16 bytes in every pool type."""
    c = CONFIGS[name]
    assert k3.route(dtype, c.dim * c.ff_mult // 2) == "bulk"


@pytest.mark.parametrize("dtype,d,want", [
    (torch.int8, 72, "simt"),       # 72 bytes: no multiple of 16
    (torch.int8, 2056, "simt"),
    (torch.int8, 80, "bulk"),
    (torch.bfloat16, 72, "bulk"),   # 144 bytes
    (torch.bfloat16, 68, "simt"),
    (torch.float32, 72, "bulk"),
    (torch.float32, 4, "bulk"),
])
def test_route_follows_the_row_bytes(dtype, d, want):
    assert k3.route(dtype, d) == want


def _covers(pos, n, d, ps, ppr, dtype):
    grid, blocks = k3.k3_splits(pos, n, d, ps, ppr, dtype)
    splits, slabs, batch = grid
    assert grid == k3.k3_grid(n, d, ps, ppr, dtype, len(pos))
    assert len(blocks) == splits * slabs * batch
    # launch order: split fastest, then slab, then batch row
    assert [(b, slab, split) for b, slab, split, *_ in blocks] == [
        (b, slab, split) for b in range(batch) for slab in range(slabs)
        for split in range(splits)]
    width = k3.SLAB_BYTES // dtype.itemsize
    for b, p in enumerate(pos):
        last = min(p, n - 1, ppr * ps - 1)
        channels = []
        for slab in range(slabs):
            mine = [blk for blk in blocks if blk[:2] == (b, slab)]
            chans = {blk[4] for blk in mine}
            assert len(chans) == 1
            chan = chans.pop()
            assert len(chan) <= width and len(chan) * dtype.itemsize % 16 == 0
            channels.extend(chan)
            live = mine[0][5]
            assert all(blk[5] == live for blk in mine) and 1 <= live <= splits
            seen = []
            for _, _, split, rows, _, _ in mine:
                if split >= live:
                    assert len(rows) == 0  # no rows: its cluster's barriers, or exit
                    continue
                assert len(rows) <= k3.split_rows(dtype)
                assert rows.start == split * k3.split_rows(dtype) or len(rows) == 0
                seen.extend(rows)
            assert seen == list(range(last + 1))  # each live row once, in split order
            assert all(i <= p and i < n and i // ps < ppr for i in seen)
        assert channels == list(range(d))
    return grid


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n,d,ps,dtype", [
    (1024, 2048, 16, torch.bfloat16),   # the engine at ProGen-small
    (1024, 2048, 16, torch.int8),
    (1024, 2048, 16, torch.float32),
    (1000, 2048, 24, torch.bfloat16),   # pages overhang the weight square
    (100, 72, 24, torch.float32),
    (100, 1040, 8, torch.float32),      # a ragged last slab
])
def test_k3_splits_cover_each_live_row_once(seed, n, d, ps, dtype):
    """Random ragged positions (0, n - 1, past n, negative among them): per
    (batch row, slab) the live splits sum rows 0..min(pos, n - 1) exactly
    once, no row past the position, no weight column >= n, and every
    channel belongs to one slab; the grid depends on the shapes alone."""
    rng = np.random.default_rng(seed)
    ppr = -(-n // ps)
    batch = int(rng.integers(1, 9))
    pos = [int(p) for p in rng.integers(0, n, size=batch)]
    pos[0] = [0, n - 1, n + 5, -1, 0, n - 1][seed]
    grid = _covers(pos, n, d, ps, ppr, dtype)
    other = [int(p) for p in rng.integers(0, n, size=batch)]
    assert _covers(other, n, d, ps, ppr, dtype) == grid


def test_k3_splits_at_the_smokes_positions():
    """At the smoke's positions (bf16, d = 2048, page 16): 32 splits (4
    clusters of 8) x 2 slabs x 8 rows; 236 blocks sum, 3672 rows a slab,
    and 19 clusters a slab run (152 blocks, the others exit at once).  An
    int8 pool: 64 splits of 16 rows x 1 slab, 232 blocks sum."""
    pos = (0, 15, 16, 300, 511, 777, 1022, 1023)
    grid, blocks = k3.k3_splits(pos, 1024, 2048, 16, 64, torch.bfloat16)
    assert grid == (32, 2, 8) and k3.CLUSTER == 8
    live = [blk for blk in blocks if blk[2] < blk[5]]
    assert len(live) == 236
    assert sum(len(blk[3]) for blk in live) == 2 * 3672
    running = {(b, slab, split // 8) for b, slab, split, _, _, live in blocks
               if split // 8 <= (live - 1) // 8}
    assert len(running) == 2 * 19
    # an int8 pool: one slab, splits of 16 rows, about as many blocks sum
    grid, blocks = k3.k3_splits(pos, 1024, 2048, 16, 64, torch.int8)
    assert grid == (64, 1, 8)
    assert len([blk for blk in blocks if blk[2] < blk[5]]) == 232


def _case(rng, n, d, ps, pos):
    batch = len(pos)
    ppr = -(-n // ps)
    num_pages = 2 + batch * ppr
    pool = rng.normal(size=(num_pages, ps, d)).astype(np.float32)
    pool[0] = 0.0
    table = np.zeros((batch, ppr), np.int32)
    perm = rng.permutation(num_pages - 2) + 2
    for b, p in enumerate(pos):
        used = p // ps + 1
        table[b, :used] = perm[b * ppr: b * ppr + used]
    w = (rng.normal(size=(n, n)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(n, 1)).astype(np.float32)
    return w, bias, pool, table, np.asarray(pos, np.int32)


def _emulate(w, bias, pool, table, pos, w_scale=None, pool_scale=None):
    """The bulk kernel's order of sums in f32: per split, consumer group g
    sums the split's rows i with i % GROUPS == g in row order (the weight
    times w_scale, the row times its pool scale), and the groups add in
    order; a cluster adds its live splits in split order; the clusters add
    in order; then the bias."""
    n = w.shape[0]
    num_pages, ps, d = pool.shape
    ppr = table.shape[1]
    dtype = {np.dtype(np.int8): torch.int8}.get(pool.dtype, torch.float32)
    _, blocks = k3.k3_splits(pos, n, d, ps, ppr, dtype)
    sums = {}  # (b, slab, cluster) -> its f32 sum
    one = np.float32(1)
    for b, slab, split, rows, chans, live in blocks:
        if split >= live:
            continue
        row = min(max(int(pos[b]), 0), n - 1)
        cs = slice(chans.start, chans.stop)
        groups = [np.zeros(len(chans), np.float32) for _ in range(k3.GROUPS)]
        for i in rows:
            page = int(table[b, i // ps])
            if not 0 <= page < num_pages:
                continue
            x = pool[page, i % ps, cs].astype(np.float32)
            if pool_scale is not None:
                x = x * pool_scale[page, i % ps]
            wv = np.float32(w[row, i]) * (one if w_scale is None else w_scale[row])
            groups[i % k3.GROUPS] = groups[i % k3.GROUPS] + wv * x
        part = groups[0]
        for g in groups[1:]:
            part = part + g
        key = (b, slab, split // k3.CLUSTER)
        sums[key] = part if key not in sums else sums[key] + part
    out = np.zeros((len(pos), d), np.float32)
    for (b, slab, cluster), part in sorted(sums.items()):
        cs = slice(slab * (k3.SLAB_BYTES // dtype.itemsize),
                   min(d, (slab + 1) * (k3.SLAB_BYTES // dtype.itemsize)))
        out[b, cs] = part if cluster == 0 else out[b, cs] + part
    for b, p in enumerate(pos):
        out[b] = out[b] + bias[min(max(int(p), 0), n - 1), 0]
    return out


@pytest.mark.parametrize("variant", ["f32_w", "int8_w_int8_pool", "int8_w_f32_pool",
                                     "f32_w_int8_pool"])
@pytest.mark.parametrize("n,d,ps,pos", [
    (256, 1040, 16, [0, 15, 16, 100, 255, 200, 31, 32]),
    (100, 72, 24, [5, 99, 47]),        # pages overhang the weight square
    (64, 512, 8, [63, 63, 0]),
])
def test_the_kernels_order_of_sums_matches_the_plain_mix(variant, n, d, ps, pos):
    """The emulated bulk kernel against ``ops/paged_gate_mix.paged_gate_mix``
    (one einsum over the gathered rows): the same f32 products summed in
    another order, within 1e-5 * (1 + |x|)."""
    rng = np.random.default_rng(n + d)
    w, bias, pool, table, pos = _case(rng, n, d, ps, pos)
    wq, ws = (t.numpy() for t in quantize_w(torch.from_numpy(w), channel_axis=0))
    pq, pscale = (t.numpy() for t in quantize_rows(torch.from_numpy(pool)))
    args = {"f32_w": (w, pool, None, None), "int8_w_int8_pool": (wq, pq, ws, pscale),
            "int8_w_f32_pool": (wq, pool, ws, None),
            "f32_w_int8_pool": (w, pq, None, pscale)}[variant]
    ww, pp, w_scale, pool_scale = args
    got = _emulate(ww, bias, pp, table, pos, w_scale, pool_scale)
    as_t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    want = plain_paged.paged_gate_mix(as_t(ww), as_t(bias), as_t(pp), as_t(table),
                                      as_t(pos), n_rows=n, w_scale=as_t(w_scale),
                                      pool_scale=as_t(pool_scale)).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want)))


def test_a_table_entry_outside_the_pool_is_skipped():
    """An id outside the pool in a used entry adds nothing (as the zero page
    would); ids outside the pool past the last used entry are never read."""
    rng = np.random.default_rng(5)
    w, bias, pool, table, pos = _case(rng, 64, 512, 8, [40, 63, 9])
    num_pages = pool.shape[0]
    bad = table.copy()
    bad[0, 2] = -1
    bad[1, 3] = num_pages + 3
    bad[2, 2:] = num_pages   # unused: row 2 ends in its page 1
    clean = table.copy()
    clean[0, 2] = 0
    clean[1, 3] = 0
    got = _emulate(w, bias, pool, bad, pos)
    want = plain_paged.paged_gate_mix(*(torch.from_numpy(a) for a in
                                        (w, bias, pool, clean, pos)), n_rows=64).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want)))


class _Picked(Exception):
    pass


def _pick(name, n_tensors, n_ints):
    raise _Picked(name)


@pytest.mark.parametrize("w_dtype,pool_dtype,d,name", [
    (torch.float32, torch.bfloat16, 2048, "paged_gate_mix_bulk"),
    (torch.float32, torch.float32, 2048, "paged_gate_mix_bulk"),
    (torch.int8, torch.int8, 2048, "paged_gate_mix_q8_bulk"),
    (torch.int8, torch.bfloat16, 2048, "paged_gate_mix_q8_bulk"),
    (torch.float32, torch.int8, 2048, "paged_gate_mix_q8_bulk"),
    (torch.int8, torch.int8, 72, "paged_gate_mix_q8"),
    (torch.float32, torch.int8, 72, "paged_gate_mix_q8"),
    (torch.int8, torch.bfloat16, 72, "paged_gate_mix_q8_bulk"),
])
def test_the_wrapper_picks_its_kernel_before_the_launch(monkeypatch, w_dtype,
                                                        pool_dtype, d, name):
    """On a CUDA tensor the wrapper asks for the kernel of its route, and
    counts nothing until a launch succeeds."""
    monkeypatch.setattr(k3, "_kernel_fn", _pick)
    n, ps, batch = 64, 16, 3
    with FakeTensorMode():
        w = torch.empty(n, n, device="cuda", dtype=w_dtype)
        bias = torch.empty(n, 1, device="cuda")
        pool = torch.empty(6, ps, d, device="cuda", dtype=pool_dtype)
        table = torch.empty(batch, 4, device="cuda", dtype=torch.int32)
        pos = torch.empty(batch, device="cuda", dtype=torch.int32)
        w_scale = torch.empty(n, device="cuda") if w_dtype == torch.int8 else None
        pool_scale = (torch.empty(6, ps, device="cuda") if pool_dtype == torch.int8
                      else None)
    before = k3.launches, k3.q8_launches, dict(k3.route_launches)
    with pytest.raises(_Picked, match=f"^{name}$"):
        k3.paged_gate_mix(w, bias, pool, table, pos, n_rows=n, w_scale=w_scale,
                          pool_scale=pool_scale)
    assert (k3.launches, k3.q8_launches, k3.route_launches) == before


def test_the_bulk_route_refuses_what_it_cannot_copy():
    """A misaligned pool, and a row that is no multiple of 16 bytes forced
    onto the bulk route, are refused before any launch."""
    n, ps, d = 64, 16, 2048
    with FakeTensorMode():
        w = torch.empty(n, n, device="cuda")
        bias = torch.empty(n, 1, device="cuda")
        table = torch.empty(2, 4, device="cuda", dtype=torch.int32)
        pos = torch.empty(2, device="cuda", dtype=torch.int32)
        base = torch.empty(6 * ps * d + 1, device="cuda", dtype=torch.bfloat16)
        bad = base.as_strided((6, ps, d), (ps * d, d, 1), 1)
        narrow = torch.empty(6, ps, 68, device="cuda", dtype=torch.bfloat16)
    before = k3.launches, dict(k3.route_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k3.paged_gate_mix(w, bias, bad, table, pos, n_rows=n)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        k3.launch("bulk", w, bias, narrow, table, pos)
    assert (k3.launches, k3.route_launches) == before


@pytest.mark.parametrize("variant", sorted(ablate.SOURCES["paged_gate_mix"][2]))
def test_k3_ablation_variants_apply_to_the_source(variant):
    """Each ablation of the bulk K3 applies to its source."""
    check_ablation_applies("paged_gate_mix", variant)
