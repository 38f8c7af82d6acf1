"""The Hopper forward kernels' plans, checked on the CPU: the routes
(``cuda_attention.fwd_route``, ``cuda_sgu.fwd_route``) for every shipped
config, the tile walks and block orders that ``local_attention_fwd.cu`` and
``sgu_fwd.cu`` run (mirrored by ``k1_fwd_tiles`` and ``k2_fwd_tiles``), the
route each wrapper picks before a launch on a CUDA tensor, and the
wrappers' CPU route against the JAX package's Pallas kernels in the
interpreter (f32 at 1e-5, bf16 at 0.05, the bars of
tests/test_pallas_attention.py and test_pallas_sgu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from progen_tpu.ops.pallas_attention import _forward_ext
from progen_tpu.ops.pallas_sgu import pallas_spatial_gate
from progen_tpu_torch.kernels import ablate
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from tests.test_torch_train_ops import check_ablation_applies

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.05)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fwd_route_for_every_shipped_config(name):
    """bf16 takes the Hopper kernels in every config (K1-fwd but for
    ``default``'s dim_head 32); f32 takes the first kernels everywhere."""
    c = CONFIGS[name]
    want = "wmma" if name == "default" else "wgmma"
    assert cuda_attention.fwd_route(torch.bfloat16, c.dim_head, c.window_size) == want
    assert cuda_attention.fwd_route(torch.float32, c.dim_head, c.window_size) == "wmma"
    assert cuda_sgu.fwd_route(torch.bfloat16) == "wgmma"
    assert cuda_sgu.fwd_route(torch.float32) == "fma"


@pytest.mark.parametrize("dtype,d,wsz,route", [
    (torch.bfloat16, 128, 256, "wgmma"),
    (torch.bfloat16, 64, 128, "wgmma"),
    (torch.bfloat16, 128, 64, "wmma"),    # a window under 128
    (torch.bfloat16, 128, 40, "wmma"),    # a window that is no multiple of 128
    (torch.bfloat16, 32, 512, "wmma"),    # dim_head 32
    (torch.float32, 128, 256, "wmma"),
])
def test_fwd_route_follows_the_backward_rule(dtype, d, wsz, route):
    assert cuda_attention.fwd_route(dtype, d, wsz) == route
    assert cuda_attention.bwd_route(dtype, d, wsz) == route


def _visible(n, wsz):
    """(query, real key) visibility: own window up to the query, and all of
    the previous window (window 0's is the phantom, which has no real keys)."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return (j <= i) & (j >= (i // wsz - 1) * wsz)


@pytest.mark.parametrize("n,wsz", [(256, 128), (256, 256), (1024, 128), (1024, 256),
                                   (1024, 512), (2048, 128), (2048, 512)])
def test_k1_fwd_tile_walk_covers_each_visible_pair_once(n, wsz):
    """Each query row belongs to one block; its walk, the diagonal tiles
    masked, meets every visible (query, real key) pair exactly once and no
    other (window 0's phantom keys are no tile: the kernel adds their zero
    logits as an exact term); and every tile a block loads is seen by one
    of its warpgroups."""
    seen = np.zeros((n, n), dtype=int)  # [query, key]
    tri = np.tril(np.ones((64, 64), dtype=int))  # [query, key]: key <= query
    rows = np.zeros(n, dtype=int)
    blocks = cuda_attention.k1_fwd_tiles(n, wsz)
    for b0, walk in blocks:
        rows[b0:b0 + 128] += 1
        assert {r0 for r0, _, _ in walk} == {b0, b0 + 64}
        loaded = {}
        for r0, t0, kind in walk:
            assert kind in ("full", "diagonal", "skipped")
            assert 0 <= t0 and t0 + 64 <= n
            loaded[t0] = loaded.get(t0, False) or kind != "skipped"
            if kind != "skipped":
                tile = np.ones((64, 64), dtype=int) if kind == "full" else tri
                seen[r0:r0 + 64, t0:t0 + 64] += tile
        assert all(loaded.values()), f"block {b0} loads a tile no row sees"
    assert (rows == 1).all()
    assert seen.max() == 1
    assert (seen.astype(bool) == _visible(n, wsz)).all()


@pytest.mark.parametrize("n,wsz", [(256, 128), (1024, 128), (1024, 256), (2048, 512)])
def test_k1_fwd_blocks_run_longest_walk_first(n, wsz):
    """The launch order is longest walk first, and a block at place p of
    window w walks wsz / 64 + 2 p + 2 tiles (2 p + 2 in window 0)."""
    blocks = cuda_attention.k1_fwd_tiles(n, wsz)
    lengths = [len(walk) // 2 for _, walk in blocks]
    assert lengths == sorted(lengths, reverse=True)
    for (b0, _), tiles in zip(blocks, lengths):
        place = (b0 % wsz) // 128
        assert tiles == (wsz // 64 if b0 >= wsz else 0) + 2 * place + 2


def test_k1_fwd_walk_at_progen_small():
    """At n = 1024, wsz = 256: 8 blocks per (b, h) walking 8, 8, 8, 6, 6, 6,
    4, 2 tiles, 48 in all; 88 (warpgroup, tile) pairs do work, as in K1-dq."""
    blocks = cuda_attention.k1_fwd_tiles(1024, 256)
    assert [len(walk) // 2 for _, walk in blocks] == [8, 8, 8, 6, 6, 6, 4, 2]
    kinds = [kind for _, walk in blocks for _, _, kind in walk]
    assert kinds.count("skipped") == 8 and kinds.count("diagonal") == 16
    assert sorted(kinds) == sorted(kind for _, _, kind in
                                   cuda_attention.k1_bwd_tiles(1024, 256, "dq"))


@pytest.mark.parametrize("batch,n,d", [(2, 256, 256), (2, 1000, 256), (3, 100, 520),
                                       (1, 60, 16), (4, 1024, 2048)])
def test_k2_fwd_tile_walk_covers_the_triangle_once(batch, n, d):
    """Each (batch row, 128 rows, 128 channels) output tile is one block;
    per (batch row, channel tile) the walks meet every 64 x 64 tile (m, k)
    of the lower triangle exactly once, the diagonal ones masked, and no
    tile above it."""
    row_tiles, col_tiles = -(-n // 128), -(-d // 128)
    blocks = cuda_sgu.k2_fwd_tiles(batch, n, d)
    assert sorted((b, m0, c0) for b, m0, c0, _ in blocks) == sorted(
        (b, 128 * mi, 128 * ct) for b in range(batch) for mi in range(row_tiles)
        for ct in range(col_tiles))
    side = -(-n // 64)
    want = {(m, k): ("diagonal" if m == k else "full")
            for m in range(side) for k in range(m + 1)}
    for b in range(batch):
        for ct in range(col_tiles):
            got = {}
            for bb, m0, c0, walk in blocks:
                if (bb, c0) != (b, 128 * ct):
                    continue
                for r0, k0, kind in walk:
                    assert 0 <= k0 < n
                    if kind == "skipped" or r0 >= n:
                        assert kind == "skipped" or r0 == m0 + 64
                        continue
                    key = (r0 // 64, k0 // 64)
                    assert key not in got
                    got[key] = kind
            assert got == want


@pytest.mark.parametrize("batch,n,d", [(2, 1024, 256), (4, 1000, 2048), (3, 100, 520)])
def test_k2_fwd_blocks_run_longest_walk_first(batch, n, d):
    """The launch order is the kernel's (channel tile fastest, then batch
    row, then row tile from the last) and its walks never grow."""
    blocks = cuda_sgu.k2_fwd_tiles(batch, n, d)
    lengths = [len(walk) for _, _, _, walk in blocks]
    assert lengths == sorted(lengths, reverse=True)
    col_tiles, row_tiles = -(-d // 128), -(-n // 128)
    for blk, (b, m0, c0, _) in enumerate(blocks):
        rest = blk // col_tiles
        assert (c0 // 128, b, m0 // 128) == (blk % col_tiles, rest % batch,
                                             row_tiles - 1 - rest // batch)


class _Picked(Exception):
    pass


def _pick(name, library, n_tensors):
    raise _Picked(name)


@pytest.mark.parametrize("dtype,d,wsz,name", [
    (torch.bfloat16, 128, 128, "local_attention_fwd_wgmma"),
    (torch.bfloat16, 64, 256, "local_attention_fwd_wgmma"),
    (torch.bfloat16, 32, 128, "local_attention_fwd"),
    (torch.bfloat16, 128, 64, "local_attention_fwd"),
    (torch.float32, 128, 128, "local_attention_fwd"),
])
def test_k1_fwd_wrapper_picks_its_kernel_before_the_launch(monkeypatch, dtype, d, wsz, name):
    """On a CUDA tensor the wrapper asks for the kernel of its route, and
    counts nothing until a launch succeeds."""
    monkeypatch.setattr(cuda_attention, "_kernel_fn", _pick)
    with FakeTensorMode():
        q = torch.empty(1, 2, 256, d, device="cuda", dtype=dtype)
    before = cuda_attention.launches, dict(cuda_attention.fwd_route_launches)
    with pytest.raises(_Picked, match=f"^{name}$"):
        cuda_attention.local_attention_fwd(q, q, q, wsz)
    assert (cuda_attention.launches, cuda_attention.fwd_route_launches) == before


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "sgu_fwd_wgmma"),
                                        (torch.float32, "sgu_fwd")])
def test_k2_fwd_wrapper_picks_its_kernel_before_the_launch(monkeypatch, dtype, name):
    monkeypatch.setattr(cuda_sgu, "_kernel_fn", _pick)
    with FakeTensorMode():
        rows = torch.empty(2, 16, 8, device="cuda", dtype=dtype)
        w = torch.empty(16, 16, device="cuda", dtype=dtype)
        b = torch.empty(16, 1, device="cuda", dtype=dtype)
    before = cuda_sgu.launches, dict(cuda_sgu.fwd_route_launches)
    with pytest.raises(_Picked, match=f"^{name}$"):
        cuda_sgu.spatial_gate_fwd(rows, rows, w, b)
    assert (cuda_sgu.launches, cuda_sgu.fwd_route_launches) == before


def _misaligned_cuda(shape, dtype):
    """A contiguous fake CUDA view one element past a 16-byte boundary."""
    numel = int(np.prod(shape))
    with FakeTensorMode():
        base = torch.empty(numel + 1, device="cuda", dtype=dtype)
        return base.as_strided(shape, torch.empty(shape).stride(), 1)


def test_hopper_forward_wrappers_refuse_misaligned_tensors():
    """TMA copies need 16-byte-aligned tensors: a view one element off is
    refused before any launch."""
    with FakeTensorMode():
        q = torch.empty(1, 2, 256, 128, device="cuda", dtype=torch.bfloat16)
        rows = torch.empty(2, 16, 8, device="cuda", dtype=torch.bfloat16)
        w = torch.empty(16, 16, device="cuda", dtype=torch.bfloat16)
        b = torch.empty(16, 1, device="cuda", dtype=torch.bfloat16)
    bad_q = _misaligned_cuda((1, 2, 256, 128), torch.bfloat16)
    bad_rows = _misaligned_cuda((2, 16, 8), torch.bfloat16)
    before = cuda_attention.launches, cuda_sgu.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_attention.local_attention_fwd(q, bad_q, q, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_sgu.spatial_gate_fwd(rows, bad_rows, w, b)
    assert (cuda_attention.launches, cuda_sgu.launches) == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32), (torch.bfloat16, BF16)],
                         ids=["f32", "bf16"])
def test_k1_fwd_cpu_route_matches_the_pallas_kernel(dtype, tol):
    """At a shape the Hopper route takes on the card (bf16, dim_head 64, a
    window of 128), the wrapper's CPU route gives the TPU kernel's output
    and logsumexp, the phantom window included."""
    rng = np.random.default_rng(11)
    n, wsz, d = 256, 128, 64
    q, k, v = (rng.normal(size=(1, 2, n, d)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(t).to(dtype) for t in (q, k, v))
    before = cuda_attention.launches
    out, lse = cuda_attention.local_attention_fwd(tq, tk, tv, wsz)
    assert cuda_attention.launches == before and out.dtype == dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(t, jdt) for t in (q, k, v))
    pad = [(0, 0), (0, 0), (wsz, 0), (0, 0)]
    want, want_lse = _forward_ext(jq, jnp.pad(jk, pad), jnp.pad(jv, pad), wsz,
                                  d ** -0.5, True)
    np.testing.assert_allclose(_np(out), _np(want), **tol)
    np.testing.assert_allclose(_np(lse), _np(want_lse), **tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32), (torch.bfloat16, BF16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [100, 256])
def test_k2_fwd_cpu_route_matches_the_pallas_kernel(dtype, tol, n):
    """The wrapper's CPU route gives the TPU kernel's out = res * cast(
    tril(W) . gate + b), W's upper triangle not zero, a ragged n and one
    that fills whole tiles."""
    rng = np.random.default_rng(12)
    d = 16
    res, gate = (rng.normal(size=(2, n, d)).astype(np.float32) for _ in range(2))
    w = rng.normal(0, 0.05, size=(n, n)).astype(np.float32)
    b = rng.normal(size=(n, 1)).astype(np.float32)
    before = cuda_sgu.launches
    got = cuda_sgu.spatial_gate_fwd(*(torch.from_numpy(t).to(dtype)
                                      for t in (res, gate, w, b)))
    assert cuda_sgu.launches == before and got.dtype == dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = pallas_spatial_gate(*(jnp.asarray(t, jdt) for t in (res, gate, w, b)))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("source,variant", [
    (source, variant) for source in ("local_attention_fwd", "sgu_fwd")
    for variant in sorted(ablate.SOURCES[source][2])])
def test_forward_ablation_variants_apply_to_the_source(source, variant):
    """Each ablation of the Hopper K1-fwd and K2-fwd applies to its source."""
    check_ablation_applies(source, variant)
