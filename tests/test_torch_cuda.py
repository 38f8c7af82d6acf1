"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run them
on the card with ``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``.
f32 is held at 1e-4 (summation order).  bf16 SGU outputs are O(1) and are
held at 0.05 (the JAX package's bf16 bar); bf16 attention outputs are
averages of many values, well below 1, and are held at 1e-2.  bf16
attention gradients are held at 2e-2 of their largest magnitude (their
size depends on the shape), plus 2e-2 relative.  The paged gate mix
differs from its plain version only in summation order (the products are
exact in f32): f32 pools at 1e-5 * (1 + |plain|), bf16 and int8 at 2e-3 of
the largest output."""

import ctypes

import pytest
import torch

import numpy as np

from progen_tpu_torch import kernels

from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.prefill import make_prefiller
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.ops import cuda_attention, cuda_paged_gate_mix, cuda_sgu
from progen_tpu_torch.ops import paged_gate_mix as plain_paged
from progen_tpu_torch.ops.quant import quantize_rows, quantize_w
from progen_tpu_torch.ops.local_attention import local_attention, local_attention_bwd
from progen_tpu_torch.ops.sgu import gated_mix, spatial_gate_dgate, spatial_gate_dw
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.step import make_train_functions

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
TOL_ATTN_OUT = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_ATTN_GRAD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_GRAD_RMS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype, tol=TOL):
    tol = tol[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,d,wsz", [
    (2, 3, 16, 32, 8),      # windows smaller than a 64-row tile
    (1, 2, 64, 64, 64),     # single window: the phantom window only
    (2, 2, 192, 128, 64),
    (1, 1, 40, 32, 40),     # a tile that overhangs the sequence
])
def test_attention_kernel_matches_plain(gen, dtype, b, h, n, d, wsz):
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    before = cuda_attention.launches
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    want, want_lse = local_attention(q, k, v, window_size=wsz, return_lse=True)
    _close(out, want, dtype, TOL_ATTN_OUT)
    _close(lse, want_lse, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d", [(2, 100, 16), (1, 130, 64), (3, 256, 136)])
def test_sgu_kernel_matches_plain(gen, dtype, b, n, d):
    res, gate = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                 for _ in range(2))
    w = (torch.randn(n, n, device="cuda", generator=gen) * 0.05).to(dtype)
    bias = torch.randn(n, 1, device="cuda", generator=gen).to(dtype)
    before = cuda_sgu.launches
    out = cuda_sgu.spatial_gate_fwd(res, gate, w, bias)
    torch.cuda.synchronize()
    assert cuda_sgu.launches == before + 1
    _close(out, gated_mix(res, gate, w, bias), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,d,wsz,bf16_route", [
    (4, 8, 1024, 128, 256, "wgmma"),   # ProGen-small's serving shape
    (8, 8, 1024, 128, 256, "wgmma"),   # ProGen-small's training shape
    (4, 8, 256, 128, 256, "wgmma"),    # one window: the phantom window only
    (2, 8, 1024, 64, 256, "wgmma"),    # ProGen-tiny's head
    (1, 12, 2048, 128, 512, "wgmma"),  # ProGen-base's window
    (1, 3, 512, 128, 128, "wgmma"),    # the smallest window the wgmma route takes
    (2, 3, 1024, 32, 512, "wmma"),     # ProGen-default's head
    (2, 8, 1024, 128, 64, "wmma"),     # a window under 128
])
def test_attention_kernel_takes_its_route_and_gives_the_same_bits(
        gen, dtype, b, h, n, d, wsz, bf16_route):
    """K1-fwd on the route each case must take (f32 always on the WMMA
    kernel), against the plain version; a second run gives the same bits."""
    route = bf16_route if dtype == torch.bfloat16 else "wmma"
    assert cuda_attention.fwd_route(dtype, d, wsz) == route
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    before = dict(cuda_attention.fwd_route_launches)
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    torch.cuda.synchronize()
    routed = {r: cuda_attention.fwd_route_launches[r] - before[r] for r in before}
    assert routed == {"wgmma": 0, "wmma": 0, route: 1}
    want, want_lse = local_attention(q, k, v, window_size=wsz, return_lse=True)
    _close(out, want, dtype, TOL_ATTN_OUT)
    _close(lse, want_lse, torch.float32)
    again, again_lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    assert torch.equal(again, out) and torch.equal(again_lse, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,weights", [
    (4, 1024, 2048, "init"),     # ProGen-small's gMLP at the init scale
    (4, 1024, 2048, "normal"),   # ... and with a mix far from the bias
    (8, 1024, 2048, "normal"),   # the training shape
    (1, 1024, 2048, "normal"),   # batch 1
    (4, 1000, 2048, "normal"),   # a ragged n: W padded to 16-byte rows
    (2, 512, 2048, "normal"),    # the main path's largest prefill
    (3, 100, 520, "normal"),     # under one tile, a ragged channel tile
])
def test_sgu_kernel_takes_its_route_and_gives_the_same_bits(gen, dtype, b, n, d, weights):
    """K2-fwd on the route of its dtype (bf16 on the Hopper kernel, f32 on
    the FMA one), against the plain version; a second run gives the same
    bits."""
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert cuda_sgu.fwd_route(dtype) == route
    res, gate = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                 for _ in range(2))
    if weights == "init":
        w = (torch.rand(n, n, device="cuda", generator=gen) * 2 - 1) * (1e-3 / n)
    else:
        w = torch.randn(n, n, device="cuda", generator=gen) * 0.05
    w = w.to(dtype)
    bias = torch.randn(n, 1, device="cuda", generator=gen).to(dtype)
    before = dict(cuda_sgu.fwd_route_launches)
    out = cuda_sgu.spatial_gate_fwd(res, gate, w, bias)
    torch.cuda.synchronize()
    routed = {r: cuda_sgu.fwd_route_launches[r] - before[r] for r in before}
    assert routed == {"wgmma": 0, "fma": 0, route: 1}
    _close(out, gated_mix(res, gate, w, bias), dtype)
    assert torch.equal(cuda_sgu.spatial_gate_fwd(res, gate, w, bias), out)


def test_prefill_goes_through_the_kernels(gen):
    cfg = ProGenConfig(num_tokens=32, dim=64, seq_len=64, depth=3,
                       window_size=16, global_mlp_depth=2, heads=2,
                       dim_head=32, ff_mult=2)
    model = ProGen(cfg, make_policy(False), device="cuda").eval()
    tokens = torch.randint(1, 32, (2, 32), device="cuda", generator=gen)
    before = cuda_attention.launches, cuda_sgu.launches
    logits, caches = make_prefiller(model)(tokens, torch.tensor([32, 20]), 48)
    assert (cuda_attention.launches - before[0], cuda_sgu.launches - before[1]) \
        == (cfg.depth, cfg.global_mlp_depth)
    cpu = ProGen(cfg, make_policy(False), device="cpu").eval()
    want, _ = make_prefiller(cpu)(tokens.cpu(), torch.tensor([32, 20]), 48)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)


def _close_scaled(got, want, dtype):
    """``|got - want| <= tol * max|want| + tol * |want|``, and the RMS error
    within ``TOL_GRAD_RMS`` of ``want``'s RMS (a kernel that drops part of
    its work can pass the first bar in bf16)."""
    tol = TOL_ATTN_GRAD[dtype]
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=tol,
                               atol=tol * float(want.abs().max()))
    rms = lambda t: float(t.pow(2).mean().sqrt())
    assert rms(got.float() - want) <= TOL_GRAD_RMS[dtype] * rms(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,d,wsz,bf16_route", [
    (2, 3, 16, 32, 8, "wmma"),      # windows smaller than a 64-row tile
    (1, 2, 64, 64, 64, "wmma"),     # single window: the phantom window only
    (2, 2, 192, 128, 64, "wmma"),
    (1, 1, 40, 32, 40, "wmma"),     # a tile that overhangs the sequence
    (1, 2, 512, 128, 256, "wgmma"),  # ProGen-small's window
    (8, 8, 1024, 128, 256, "wgmma"),  # ProGen-small's training shape
    (2, 8, 256, 128, 256, "wgmma"),   # one window: the phantom window only
    (2, 8, 1024, 64, 256, "wgmma"),   # ProGen-tiny's head
    (1, 12, 2048, 128, 512, "wgmma"),  # ProGen-base's window
    (1, 3, 512, 128, 128, "wgmma"),   # the smallest window the wgmma route takes
])
def test_attention_backward_kernels_match_plain(gen, dtype, b, h, n, d, wsz, bf16_route):
    """Each case on the route it must take (f32 always on the WMMA
    kernels); a second run gives the same bits (no atomics)."""
    route = bf16_route if dtype == torch.bfloat16 else "wmma"
    assert cuda_attention.bwd_route(dtype, d, wsz) == route
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    before = (cuda_attention.dq_launches, cuda_attention.dkv_launches,
              dict(cuda_attention.bwd_route_launches))
    got = cuda_attention.local_attention_bwd(q, k, v, out, lse, do, wsz)
    torch.cuda.synchronize()
    assert (cuda_attention.dq_launches, cuda_attention.dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    routed = {r: cuda_attention.bwd_route_launches[r] - before[2][r] for r in before[2]}
    assert routed == {"wgmma": 0, "wmma": 0, route: 2}
    want = local_attention_bwd(q, k, v, out, lse, do, wsz)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close_scaled(g, w, dtype)
    again = cuda_attention.local_attention_bwd(q, k, v, out, lse, do, wsz)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,small", [
    (2, 100, 16, True),     # n < one tile and n % 8 != 0: W padded
    (1, 130, 64, True),
    (3, 256, 136, True),    # d not a multiple of the 128-channel tile
    (1, 100, 8, False),     # one 64-channel step, most of it zeros
    (3, 100, 520, False),   # d = 520: a ragged last channel step
    (2, 1000, 520, False),  # ragged n at full length
    (1, 1024, 2048, False),  # batch 1 at ProGen-small's width
])
def test_sgu_backward_kernels_match_plain(gen, dtype, b, n, d, small):
    """Each at the scaled bars of the other backward kernels; the small
    cases also at the plain 1e-4 / 0.05 bars they always had.  Two runs give
    the same bits; d_W's strict upper triangle is exactly 0."""
    res, gate, dout = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
    w = (torch.randn(n, n, device="cuda", generator=gen) * 0.05).to(dtype)
    before = cuda_sgu.dgate_launches, cuda_sgu.dw_launches
    dgate = cuda_sgu.spatial_gate_dgate(w, dout, res)
    dw = cuda_sgu.spatial_gate_dw(dout, res, gate)
    torch.cuda.synchronize()
    assert (cuda_sgu.dgate_launches, cuda_sgu.dw_launches) == \
        (before[0] + 1, before[1] + 1)
    want_dgate = spatial_gate_dgate(w, dout, res)
    want_dw = spatial_gate_dw(dout, res, gate)
    _close_scaled(dgate, want_dgate, dtype)
    _close_scaled(dw, want_dw, dtype)
    if small:
        _close(dgate, want_dgate, dtype)
        _close(dw, want_dw, dtype)
    assert dgate.dtype == dw.dtype == dtype
    assert torch.count_nonzero(torch.triu(dw, 1)) == 0
    assert torch.equal(cuda_sgu.spatial_gate_dgate(w, dout, res), dgate)
    assert torch.equal(cuda_sgu.spatial_gate_dw(dout, res, gate), dw)


def test_train_step_goes_through_the_kernels(gen):
    cfg = ProGenConfig(num_tokens=256, dim=64, seq_len=64, depth=3,
                       window_size=16, global_mlp_depth=2, heads=2,
                       dim_head=32, ff_mult=2)
    batch = torch.randint(1, 256, (2, cfg.seq_len + 1), device="cuda",
                          generator=gen)
    grads = []
    for device in ("cuda", "cpu"):
        model = ProGen(cfg, make_policy(False), device=device)
        fns = make_train_functions(model, make_optimizer())
        state = fns.init_state()
        before = (cuda_attention.launches, cuda_attention.dq_launches,
                  cuda_attention.dkv_launches, cuda_sgu.launches,
                  cuda_sgu.dgate_launches, cuda_sgu.dw_launches)
        state, metrics = fns.train_step(state, batch.to(device))
        after = (cuda_attention.launches, cuda_attention.dq_launches,
                 cuda_attention.dkv_launches, cuda_sgu.launches,
                 cuda_sgu.dgate_launches, cuda_sgu.dw_launches)
        launched = tuple(a - b for a, b in zip(after, before))
        want = (3, 3, 3, 4, 2, 2) if device == "cuda" else (0,) * 6
        assert launched == want
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][name], rtol=1e-4, atol=1e-4,
                                   msg=name)


def _paged_case(gen, n, d, ps, pos, pool_dtype):
    """A pool with garbage in the dump page and in every row past ``pos`` of
    each last page, tables that are NULL past the last page, and the q8
    twins of the weights and the pool."""
    batch = len(pos)
    ppr = -(-n // ps)
    num_pages = 2 + batch * ppr
    pool = torch.randn(num_pages, ps, d, device="cuda", generator=gen)
    pool[0] = 0.0
    table = torch.zeros(batch, ppr, dtype=torch.int32, device="cuda")
    perm = (torch.randperm(num_pages - 2, device="cuda", generator=gen) + 2).int()
    for b, p in enumerate(pos):
        used = p // ps + 1
        table[b, :used] = perm[b * ppr: b * ppr + used]
    w = torch.randn(n, n, device="cuda", generator=gen) * 0.05
    bias = torch.randn(n, 1, device="cuda", generator=gen)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    wq, ws = quantize_w(w, channel_axis=0)
    pq, pscale = quantize_rows(pool)
    return {"w": w, "bias": bias, "pool": pool.to(pool_dtype), "table": table,
            "pos": pos_t, "wq": wq, "ws": ws, "pq": pq, "pscale": pscale,
            "n_rows": n}


def _close_paged(got, want):
    # both sides multiply the same f32 values (bf16 and int8 widen exactly)
    # and differ in summation order only, whatever the operand types
    assert bool(((got - want).abs() <= 1e-5 * (1 + want.abs())).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,ps,pos", [
    (64, 128, 8, [0, 7, 8, 33, 63]),
    (100, 72, 24, [5, 99, 47]),          # pages overhang the weight square
    (256, 2048, 16, [0, 15, 16, 100, 255, 200, 31, 32]),
])
def test_paged_gate_mix_kernel_matches_plain(gen, dtype, n, d, ps, pos):
    c = _paged_case(gen, n, d, ps, pos, dtype)
    before = cuda_paged_gate_mix.launches, cuda_paged_gate_mix.q8_launches
    got = cuda_paged_gate_mix.paged_gate_mix(c["w"], c["bias"], c["pool"], c["table"],
                                             c["pos"], n_rows=n)
    torch.cuda.synchronize()
    assert (cuda_paged_gate_mix.launches, cuda_paged_gate_mix.q8_launches) == \
        (before[0] + 1, before[1])
    want = plain_paged.paged_gate_mix(c["w"], c["bias"], c["pool"], c["table"],
                                      c["pos"], n_rows=n)
    assert got.dtype == torch.float32 and got.shape == (len(pos), d)
    _close_paged(got, want)


@pytest.mark.parametrize("case", ["w8_p8", "w8_bf16", "f32_p8"])
@pytest.mark.parametrize("n,d,ps,pos", [
    (64, 128, 8, [0, 7, 8, 33, 63]),
    (100, 72, 24, [5, 99, 47]),
    (256, 2048, 16, [0, 15, 16, 100, 255, 200, 31, 32]),
])
def test_paged_gate_mix_q8_kernel_matches_plain(gen, case, n, d, ps, pos):
    c = _paged_case(gen, n, d, ps, pos, torch.bfloat16)
    args = {"w8_p8": (c["wq"], c["pq"], c["ws"], c["pscale"]),
            "w8_bf16": (c["wq"], c["pool"], c["ws"], None),
            "f32_p8": (c["w"], c["pq"], None, c["pscale"])}[case]
    w, pool, w_scale, pool_scale = args
    before = cuda_paged_gate_mix.launches, cuda_paged_gate_mix.q8_launches
    got = cuda_paged_gate_mix.paged_gate_mix(
        w, c["bias"], pool, c["table"], c["pos"], n_rows=n, w_scale=w_scale,
        pool_scale=pool_scale)
    torch.cuda.synchronize()
    assert (cuda_paged_gate_mix.launches, cuda_paged_gate_mix.q8_launches) == \
        (before[0], before[1] + 1)
    want = plain_paged.paged_gate_mix(
        w, c["bias"], pool, c["table"], c["pos"], n_rows=n, w_scale=w_scale,
        pool_scale=pool_scale)
    _close_paged(got, want)


PAGED_POS = (0, 15, 16, 300, 511, 777, 1022, 1023)
# the smoke's cases at the engine's shapes (n = 1024, d = 2048, page 16),
# and its overhang case (n = 1000, page 24)
K3_CASES = {
    "engine_ragged": (1024, 16, PAGED_POS),
    "one_row_at_1023": (1024, 16, (1023,)),
    "all_at_0": (1024, 16, (0,) * 8),
    "all_at_1023": (1024, 16, (1023,) * 8),
    "outside_the_pool": (1024, 16, PAGED_POS),
    "overhang": (1000, 24, (0, 23, 24, 300, 511, 777, 998, 999)),
}
K3_VARIANTS = {  # weights, pool, w_scale, pool_scale keys of a paged case
    "f32_w": ("w", "pool", None, None),
    "w8_p8": ("wq", "pq", "ws", "pscale"),
    "w8_bf16": ("wq", "pool", "ws", None),
    "f32_p8": ("w", "pq", None, "pscale"),
}


def _k3_args(c, variant):
    return tuple(c[k] if k else None for k in K3_VARIANTS[variant])


@pytest.mark.parametrize("variant", sorted(K3_VARIANTS))
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_paged_gate_mix_bulk_route(gen, case, variant):
    """Each case twice through the wrapper: both launches on the bulk route,
    the same bits, 1e-5 * (1 + |plain|) from the plain version.  Table
    entries outside the pool (past each row's last page, and one used entry
    in each of the first two rows) are skipped: the plain version, which
    gathers every entry, gets NULL there."""
    n, ps, pos = K3_CASES[case]
    c = _paged_case(gen, n, 2048, ps, list(pos), torch.bfloat16)
    plain_table = c["table"].clone()
    if case == "outside_the_pool":
        num_pages = c["pool"].shape[0]
        for b, p in enumerate(pos):
            c["table"][b, p // ps + 1:] = num_pages + b
        for b, bad in ((0, -1), (1, num_pages + 7)):
            c["table"][b, pos[b] // ps] = bad
            plain_table[b, pos[b] // ps] = 0
    w, pool, w_scale, pool_scale = _k3_args(c, variant)
    before = dict(cuda_paged_gate_mix.route_launches)
    got, again = (cuda_paged_gate_mix.paged_gate_mix(
        w, c["bias"], pool, c["table"], c["pos"], n_rows=n, w_scale=w_scale,
        pool_scale=pool_scale) for _ in range(2))
    torch.cuda.synchronize()
    assert cuda_paged_gate_mix.route_launches == {**before, "bulk": before["bulk"] + 2}
    assert torch.equal(got, again)
    want = plain_paged.paged_gate_mix(w, c["bias"], pool, plain_table, c["pos"], n_rows=n,
                                      w_scale=w_scale, pool_scale=pool_scale)
    _close_paged(got, want)


@pytest.mark.parametrize("variant", ["f32_w", "w8_p8"])
def test_paged_gate_mix_replays_in_a_cuda_graph(gen, variant):
    """One K3 (K3-q8) call captured in a CUDA graph, replayed after ``pos``
    and ``table`` change in place: each replay gives an eager call's bits
    on the new values, so the grid reads no position on the host and the
    tickets set themselves back to zero."""
    n, ps = 1024, 16
    c = _paged_case(gen, n, 2048, ps, list(PAGED_POS), torch.bfloat16)
    w, pool, w_scale, pool_scale = _k3_args(c, variant)
    table, pos = c["table"].clone(), c["pos"].clone()

    def call():
        return cuda_paged_gate_mix.paged_gate_mix(w, c["bias"], pool, table, pos,
                                                  n_rows=n, w_scale=w_scale,
                                                  pool_scale=pool_scale)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call()
    rng = np.random.default_rng(3)
    ppr, num_pages = n // ps, pool.shape[0]
    for new_pos in ((1023, 0, 512, 7, 1023, 300, 64, 999), (5,) * 8, (1023,) * 8):
        perm = rng.permutation(num_pages - 2) + 2
        new_table = np.zeros((8, ppr), np.int32)
        for b, p in enumerate(new_pos):
            new_table[b, :p // ps + 1] = perm[b * ppr: b * ppr + p // ps + 1]
        table.copy_(torch.from_numpy(new_table))
        pos.copy_(torch.tensor(new_pos, dtype=torch.int32))
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        assert torch.equal(static, eager)
        _close_paged(static, plain_paged.paged_gate_mix(
            w, c["bias"], pool, table, pos, n_rows=n, w_scale=w_scale,
            pool_scale=pool_scale))


def test_the_bulk_kernels_plan_matches_the_wrappers_mirror(gen):
    """``k3_splits`` and ``k3_grid`` mirror the plan the library was built
    with."""
    plan = (ctypes.c_int * 6)()
    kernels.load("paged_gate_mix").paged_gate_mix_bulk_plan(plan)
    assert list(plan) == [getattr(cuda_paged_gate_mix, k) for k in (
        "SPLIT_ROWS", "SPLIT_ROWS_INT8", "SLAB_BYTES", "STAGE_ROWS", "GROUPS", "CLUSTER")]


def test_paged_gate_mix_refuses_what_the_kernel_does_not_take(gen):
    c = _paged_case(gen, 64, 128, 8, [3, 40], torch.float32)
    with pytest.raises(ValueError, match="int32"):
        cuda_paged_gate_mix.paged_gate_mix(c["w"], c["bias"], c["pool"],
                                           c["table"].long(), c["pos"], n_rows=64)
    with pytest.raises(ValueError, match="w_scale"):
        cuda_paged_gate_mix.paged_gate_mix(c["wq"], c["bias"], c["pool"],
                                           c["table"], c["pos"], n_rows=64)


@pytest.mark.parametrize("quantize", [None, "weights+pages"])
def test_engine_chunk_goes_through_the_paged_kernel(gen, quantize):
    cfg = ProGenConfig(num_tokens=32, dim=64, seq_len=64, depth=3,
                       window_size=16, global_mlp_depth=2, heads=2,
                       dim_head=32, ff_mult=2)
    rng = np.random.default_rng(0)
    requests = [dict(uid=i, tokens=[int(t) for t in rng.integers(1, 32, size=5 + 3 * i)],
                     max_new_tokens=9, temperature=0.0) for i in range(3)]
    tokens = {}
    for device in ("cuda", "cpu"):
        engine = ServingEngine(ProGen(cfg, make_policy(False), device=device),
                               num_slots=2, chunk_size=4, max_len=64, paged=True,
                               page_size=8, quantize=quantize)
        before = cuda_paged_gate_mix.launches, cuda_paged_gate_mix.q8_launches
        for r in requests:
            engine.submit(Request(**r))
        done = engine.run_until_idle()
        launched = (cuda_paged_gate_mix.launches - before[0],
                    cuda_paged_gate_mix.q8_launches - before[1])
        steps = engine.chunks_run * engine.chunk_size * cfg.global_mlp_depth
        want = ((0, 0) if device == "cpu" else
                (0, steps) if quantize else (steps, 0))
        assert launched == want
        assert all(c.ok for c in done) and len(done) == 3
        tokens[device] = {c.uid: c.tokens.tolist() for c in done}
    same = sum(a == b for u in tokens["cpu"]
               for a, b in zip(tokens["cpu"][u], tokens["cuda"][u]))
    total = sum(len(v) for v in tokens["cpu"].values())
    assert same / total >= 0.9  # summation order may flip a near-tie


def test_prefetcher_copies_batches_on_a_side_stream(gen):
    """Batches copied on the prefetcher's stream are whole when a kernel of
    the consumer's stream reads them, also behind a long device spin."""
    from progen_tpu_torch.data.prefetch import DevicePrefetcher

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 255, (8, 1025)).astype(np.int32) for _ in range(6)]
    pf = DevicePrefetcher(iter(batches), device="cuda", depth=2)
    sums = []
    for got in pf:
        torch.cuda._sleep(1_000_000)
        assert got.device.type == "cuda" and got.dtype == torch.int32
        sums.append(got.long().sum(dim=1))
    torch.cuda.synchronize()
    for s, want in zip(sums, batches):
        assert s.cpu().tolist() == want.astype(np.int64).sum(axis=1).tolist()


def test_trainer_resumes_bit_exact_on_the_card(gen, tmp_path):
    """A small f32 model through the Trainer on the card: 4 steps with
    background checkpoints, against 2 steps and a resumed 2; the stored
    params load into a fresh model that gives the same logits."""
    from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
    from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = ProGenConfig(num_tokens=256, dim=64, seq_len=64, depth=3, window_size=16,
                       global_mlp_depth=2, heads=2, dim_head=32, ff_mult=2)
    rng = np.random.default_rng(1)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 60), dtype=np.uint8))
    write_tfrecord(tmp_path / shard_filename(0, 40, "train"), [mk() for _ in range(40)])
    write_tfrecord(tmp_path / shard_filename(0, 5, "valid"), [mk() for _ in range(5)])

    def run(ckpt, max_steps):
        tc = TrainerConfig(batch_size=2, grad_accum_every=2, learning_rate=1e-3,
                           mixed_precision=False, checkpoint_every=2, validate_every=2,
                           sample_every=1000, log_every=1, max_steps=max_steps)
        t = Trainer(cfg, tc, str(tmp_path), str(tmp_path / ckpt), device="cuda")
        return t, t.run()

    full_t, full = run("full", 4)
    run("split", 2)
    split_t, split = run("split", 4)
    assert split_t.restore_seconds is not None
    for k, v in full["state"].params.items():
        assert torch.equal(v, split["state"].params[k]), k
    assert [s["background"] for s in full_t.checkpoint_log][:1] == [True]
    fresh = ProGen(cfg, make_policy(False), device="cuda", seed=5)
    fresh.load_state_dict(full_t.store.restore_params(map_location="cuda"))
    tokens = torch.randint(1, 255, (2, 64), device="cuda", generator=gen)
    with torch.no_grad():
        assert torch.equal(fresh(tokens), full_t.model(tokens))


@pytest.mark.parametrize("quantize", [None, "weights+pages"])
def test_a_warmed_paged_engine_gives_the_eager_engines_tokens(gen, quantize):
    """``aot_warmup`` captures each program as a CUDA graph; the warmed
    engine's tokens equal the eager engine's on the card, token for token,
    and the kernels' counters advance by the same launches (the replays
    add what their captures counted)."""
    cfg = ProGenConfig(num_tokens=32, dim=64, seq_len=64, depth=3,
                       window_size=16, global_mlp_depth=2, heads=2,
                       dim_head=32, ff_mult=2)
    model = ProGen(cfg, make_policy(False), device="cuda", seed=2)
    rng = np.random.default_rng(0)
    requests = [dict(uid=i, tokens=[int(t) for t in rng.integers(1, 32, size=5 + 7 * i)],
                     max_new_tokens=12, top_k=None if i % 2 else 8,
                     temperature=0.0 if i % 2 else 1.0, seed=i) for i in range(5)]
    runs = {}
    for warm in (False, True):
        engine = ServingEngine(model, num_slots=2, chunk_size=4, max_len=64, paged=True,
                               page_size=8, quantize=quantize)
        if warm:
            stats = engine.aot_warmup()
            assert stats["programs"] == 4  # admits at 16, 32, 64 and the chunk
            assert all(p.captured for p in engine._aot.values())
        before = (cuda_attention.launches, cuda_sgu.launches,
                  cuda_paged_gate_mix.launches + cuda_paged_gate_mix.q8_launches)
        for r in requests:
            engine.submit(Request(**r))
        done = engine.run_until_idle()
        torch.cuda.synchronize()
        after = (cuda_attention.launches, cuda_sgu.launches,
                 cuda_paged_gate_mix.launches + cuda_paged_gate_mix.q8_launches)
        assert all(c.ok for c in done) and len(done) == 5
        runs[warm] = ({c.uid: c.tokens.tolist() for c in done},
                      tuple(a - b for a, b in zip(after, before)), engine.chunks_run)
    assert runs[True] == runs[False]


SUPERSTEP_CFG = ProGenConfig(num_tokens=256, dim=64, seq_len=64, depth=3, window_size=16,
                             global_mlp_depth=2, heads=2, dim_head=32, ff_mult=2)


def _state_tensors(state) -> dict:
    opt = state.opt_state
    out = {f"params.{k}": v for k, v in state.params.items()}
    for kind in ("mu", "nu", "acc_grads"):
        out.update({f"{kind}.{k}": v for k, v in (getattr(opt, kind) or {}).items()})
    return {k: v.detach().clone() for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("accum,k", [(1, 4), (2, 2)])
def test_the_captured_optimizer_step_is_the_eager_steps(gen, dtype, accum, k):
    """``train_multi_step`` on the card (one captured optimizer step,
    replayed) against the same micro-batches through ``train_step``, two
    dispatches from one init: every loss, grad norm and lr, every parameter,
    both moments and the accumulator bit for bit; the kernels' counters
    advance by the eager steps' launches; a new state (other tensors) is
    captured again."""
    from progen_tpu_torch.train.schedule import make_lr_schedule

    cfg, mixed = SUPERSTEP_CFG, dtype == "bf16"
    micros = torch.randint(1, 256, (2, k, accum, 2, cfg.seq_len + 1), device="cuda",
                           generator=gen)

    def fns_and_state():
        model = ProGen(cfg, make_policy(mixed), device="cuda", seed=3)
        fns = make_train_functions(model, make_optimizer(
            make_lr_schedule("constant", 1e-3, warmup_steps=32), grad_accum_every=accum))
        return fns, fns.init_state()

    def counts():
        return (cuda_attention.launches, cuda_attention.dq_launches,
                cuda_attention.dkv_launches, cuda_sgu.launches,
                cuda_sgu.dgate_launches, cuda_sgu.dw_launches)

    fns, state = fns_and_state()
    eager, before = [], counts()
    for sb in micros:
        for i in range(k):
            for a in range(accum):
                state, m = fns.train_step(state, sb[i, a])
                eager.append({key: m[key].clone() for key in ("loss", "grad_norm", "lr")})
    torch.cuda.synchronize()
    eager_launches = tuple(a - b for a, b in zip(counts(), before))
    want = _state_tensors(state)

    fns, state = fns_and_state()
    fused, before = [], counts()
    for sb in micros:
        state, m = fns.train_multi_step(state, sb)
        fused.append(m)
    torch.cuda.synchronize()
    assert fns.captured_program().captured
    assert tuple(a - b for a, b in zip(counts(), before)) == eager_launches
    assert eager_launches == tuple(n * 2 * k * accum for n in (3, 3, 3, 4, 2, 2))
    loss = torch.cat([m["loss"].reshape(-1) for m in fused])
    assert torch.equal(loss, torch.stack([e["loss"] for e in eager]))
    norms = torch.cat([m["grad_norm"].reshape(-1) for m in fused])
    assert torch.equal(norms, torch.stack([e["grad_norm"] for e in eager]))
    lrs = torch.cat([m["lr"] for m in fused])
    assert torch.equal(lrs, torch.stack([e["lr"] for e in eager])[accum - 1::accum])
    got = _state_tensors(state)
    for name, t in want.items():
        assert torch.equal(got[name], t), name

    program = fns.captured_program()
    state = fns.init_state()  # new moments: other addresses
    fns.train_multi_step(state, micros[0])
    assert fns.captured_program() is not program


@pytest.mark.parametrize("policy", ["full", "dots", "attn"])
def test_remat_gives_the_same_gradients_on_the_card(gen, policy):
    """Each remat policy through the kernels: loss and every gradient
    equal the step without remat, in f32, bit for bit; K1-fwd launched
    twice a layer under full and dots, once under attn."""
    from progen_tpu_torch.train.loss import batch_loss

    cfg = SUPERSTEP_CFG
    batch = torch.randint(1, 256, (2, cfg.seq_len + 1), device="cuda", generator=gen)
    out = {}
    for remat in (False, True):
        model = ProGen(cfg, make_policy(False), device="cuda", seed=4, remat=remat,
                       remat_policy=policy)
        before = cuda_attention.launches
        loss = batch_loss(model(batch[:, :-1]), batch[:, 1:])
        loss.backward()
        torch.cuda.synchronize()
        out[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                      cuda_attention.launches - before)
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[False][1].items():
        assert torch.equal(out[True][1][name], g), name
    assert out[False][2] == cfg.depth
    assert out[True][2] == cfg.depth * (1 if policy == "attn" else 2)


def test_the_memory_plan_is_the_cards_peak(gen):
    """ProGen-small, bf16 compute, batch 8, no remat: two eager train steps'
    ``max_memory_allocated`` above the bytes live before the model within
    5% of ``train/memory.plan`` (``chip_smoke.py``'s bar)."""
    import gc

    from progen_tpu_torch.models.configs import SMALL
    from progen_tpu_torch.train.memory import plan

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = ProGen(SMALL, make_policy(True), device="cuda", seed=0)
    fns = make_train_functions(model, make_optimizer())
    state = fns.init_state()
    batch = torch.randint(1, 255, (8, SMALL.seq_len + 1), device="cuda", generator=gen)
    for _ in range(2):
        state, m = fns.train_step(state, batch)
    float(m["loss"])
    peak = torch.cuda.max_memory_allocated() - start
    want = plan(SMALL, batch_size=8).total_bytes
    assert abs(want / peak - 1) <= 0.05, (want, peak)


@pytest.mark.parametrize("strategies", [("dp",), ("fsdp",), ("fsdp", "tp")])
def test_the_captured_meshed_step_is_the_eager_steps(gen, strategies):
    """On a world-1 NCCL mesh, bf16 compute, batch 2 of a 4-layer model:
    ``train_multi_step`` of 3 steps (one captured optimizer step with the
    mesh's collectives, replayed) against 3 eager meshed steps from the same
    init: every loss, grad norm and parameter bit-equal."""
    import torch.distributed as dist

    from progen_tpu_torch.core.mesh import MeshConfig, initialize_distributed, make_mesh
    from progen_tpu_torch.parallel.sharding import full_tensor

    cfg = ProGenConfig(num_tokens=256, dim=256, seq_len=256, depth=4, window_size=128,
                       global_mlp_depth=1, heads=2, dim_head=64)
    batches = torch.randint(1, 255, (3, 2, cfg.seq_len + 1), device="cuda", generator=gen)
    initialize_distributed("cuda")
    try:
        runs = []
        for fused in (False, True):
            model = ProGen(cfg, make_policy(True), device="cuda", seed=0)
            fns = make_train_functions(model, make_optimizer(), mesh=make_mesh(MeshConfig()),
                                       strategies=strategies)
            state = fns.init_state()
            if fused:
                assert fns.superstep_route == "graph"
                state, m = fns.train_multi_step(state, batches[:, None])
                losses, norms = m["loss"].reshape(-1), m["grad_norm"].reshape(-1)
            else:
                rows = []
                for b in batches:
                    state, m = fns.train_step(state, b)
                    rows.append(m)
                losses = torch.stack([r["loss"] for r in rows])
                norms = torch.stack([r["grad_norm"] for r in rows])
            pieces = model.parallel_plan.pieces
            runs.append((losses, norms, {n: full_tensor(p.detach(), pieces(n)).clone()
                                         for n, p in state.params.items()}))
            del model, fns, state
        (l0, g0, p0), (l1, g1, p1) = runs
        assert torch.equal(l0, l1) and torch.equal(g0, g1)
        assert all(torch.equal(p0[n], p1[n]) for n in p0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kernel", ["k1_zero_halo", "k2_fwd", "k3", "k3_q8"])
def test_the_kernels_at_a_tensor_rank_of_two(gen, kernel):
    """The kernels of decode under a mesh at the shapes a rank of a
    ``tensor`` 2 mesh gives them at ProGen-small, bf16 (the Hopper routes):
    K1-fwd through its halo entry with the zero window on 4 of 8 heads,
    K2-fwd on 1024 of 2048 gate channels, K3 and K3-q8 at ``d`` 1024 over
    8 ragged rows; each against its plain version at its bars, twice for
    the same bits, on the route of the whole width."""
    if kernel == "k1_zero_halo":
        q, k, v = (torch.randn(4, 4, 1024, 128, device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        zero = torch.zeros(4, 4, 256, 128, device="cuda", dtype=torch.bfloat16)
        before = dict(cuda_attention.fwd_route_launches)
        out, lse = cuda_attention.local_attention_fwd(q, k, v, 256, None, zero, zero)
        again = cuda_attention.local_attention_fwd(q, k, v, 256, None, zero, zero)
        torch.cuda.synchronize()
        assert cuda_attention.fwd_route_launches["wgmma"] == before["wgmma"] + 2
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        want, want_lse = local_attention(q, k, v, window_size=256, return_lse=True,
                                         k_halo=zero, v_halo=zero)
        _close(out, want, torch.bfloat16, TOL_ATTN_OUT)
        _close(lse, want_lse, torch.float32)
    elif kernel == "k2_fwd":
        res, gate = (torch.randn(4, 1024, 1024, device="cuda", generator=gen).bfloat16()
                     for _ in range(2))
        w = (torch.randn(1024, 1024, device="cuda", generator=gen) * 0.05).bfloat16()
        bias = torch.ones(1024, 1, device="cuda", dtype=torch.bfloat16)
        before = dict(cuda_sgu.fwd_route_launches)
        out, again = (cuda_sgu.spatial_gate_fwd(res, gate, w, bias) for _ in range(2))
        torch.cuda.synchronize()
        assert cuda_sgu.fwd_route_launches["wgmma"] == before["wgmma"] + 2
        assert torch.equal(out, again)
        _close(out, gated_mix(res, gate, w, bias), torch.bfloat16)
    else:
        c = _paged_case(gen, 1024, 1024, 16, list(PAGED_POS), torch.bfloat16)
        w, pool, w_scale, pool_scale = _k3_args(c, "f32_w" if kernel == "k3" else "w8_p8")
        before = dict(cuda_paged_gate_mix.route_launches)
        got, again = (cuda_paged_gate_mix.paged_gate_mix(
            w, c["bias"], pool, c["table"], c["pos"], n_rows=1024, w_scale=w_scale,
            pool_scale=pool_scale) for _ in range(2))
        torch.cuda.synchronize()
        assert cuda_paged_gate_mix.route_launches == {**before, "bulk": before["bulk"] + 2}
        assert torch.equal(got, again)
        want = plain_paged.paged_gate_mix(w, c["bias"], pool, c["table"], c["pos"],
                                          n_rows=1024, w_scale=w_scale, pool_scale=pool_scale)
        _close_paged(got, want)


def test_the_f32_step_is_deterministic_on_the_card(gen):
    """Two f32 backward passes of one model and batch (batch 8, 256 tokens
    a row of a 256-token vocabulary: every embedding row is hit many times)
    give every gradient bit for bit; the embedding's weight gradient is a
    one-hot product, not ``F.embedding``'s atomic sum."""
    from progen_tpu_torch.train.loss import batch_loss

    cfg = ProGenConfig(num_tokens=256, dim=256, seq_len=256, depth=2, window_size=128,
                       global_mlp_depth=1, heads=2, dim_head=128)
    batch = torch.randint(1, 256, (8, cfg.seq_len + 1), device="cuda", generator=gen)
    grads = []
    for _ in range(2):
        model = ProGen(cfg, make_policy(False), device="cuda", seed=5)
        batch_loss(model(batch[:, :-1]), batch[:, 1:]).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(grads[1][name], g), name


def test_a_world_1_meshed_sampler_is_the_unmeshed_one(gen):
    """The sampler on a world-1 NCCL mesh under ``(fsdp, tp)`` and
    ``(dp, tp, sp)`` (f32, a 2-layer model): at least 0.98 of the unmeshed
    sampler's tokens for the same key (K1 runs its halo entry there, so
    bit equality is not owed), and a second meshed call bit-equal."""
    import torch.distributed as dist

    from progen_tpu_torch.core.mesh import MeshConfig, initialize_distributed, make_mesh
    from progen_tpu_torch.decode.sampler import make_sampler
    from progen_tpu_torch.parallel.sharding import parallelize

    cfg = ProGenConfig(num_tokens=256, dim=256, seq_len=256, depth=2, window_size=128,
                       global_mlp_depth=1, heads=2, dim_head=128)
    prime = torch.randint(1, 25, (2, 20), device="cuda", generator=gen)
    key = torch.tensor([0, 11])
    want = make_sampler(ProGen(cfg, make_policy(False), device="cuda", seed=2))(
        prime, cfg.seq_len, key=key, top_k=25)
    initialize_distributed("cuda")
    try:
        for strategies in (("fsdp", "tp"), ("dp", "tp", "sp")):
            mesh = make_mesh(MeshConfig(1, 1, 1, 1))
            model = ProGen(cfg, make_policy(False), device="cuda", seed=2)
            plan = parallelize(model, mesh, strategies)
            sampler = make_sampler(model, mesh=mesh, strategies=strategies,
                                   params_shardings=plan)
            got = sampler(prime, cfg.seq_len, key=key, top_k=25)
            assert torch.equal(sampler(prime, cfg.seq_len, key=key, top_k=25), got)
            assert float((got == want).float().mean()) >= 0.98, strategies
    finally:
        dist.destroy_process_group()


def test_a_fleet_on_the_card_gives_the_in_process_engines_tokens(gen, tmp_path):
    """One prefill worker and one decode replica, both processes on
    ``cuda:0``, at a small f32 config: the fleet's tokens equal the
    in-process disaggregated engine's built from the same spec, and the
    workers' exit lines show the kernels: K1-fwd and K2-fwd in the prefill
    worker only, K3 in the replica only."""
    import json

    from progen_tpu_torch.serve import ServeCluster, build_engine_from_spec, make_spec

    cfg = ProGenConfig(num_tokens=32, dim=64, seq_len=64, depth=3, window_size=16,
                       global_mlp_depth=2, heads=2, dim_head=32, ff_mult=2)
    spec = make_spec(cfg, mixed_precision=False, init_seed=2, device="cuda",
                     engine=dict(num_slots=4, chunk_size=4, max_len=64, paged=True,
                                 page_size=8, prefill_batch=2, handoff_depth=2))
    rng = np.random.default_rng(0)
    requests = [dict(uid=i, tokens=[int(t) for t in rng.integers(1, 32, 5 + 7 * i)],
                     max_new_tokens=12, top_k=None if i % 2 else 8,
                     temperature=0.0 if i % 2 else 1.0, seed=i) for i in range(5)]
    engine = build_engine_from_spec(spec)
    for r in requests:
        engine.submit(Request(**r))
    want = {c.uid: c.tokens.tolist() for c in engine.run_until_idle()}
    cluster = ServeCluster(spec, log_dir=str(tmp_path))
    try:
        for r in requests:
            cluster.submit(Request(**r))
        done = cluster.drain(timeout=600.0)
    finally:
        stats = cluster.shutdown()
    assert all(c.ok for c in done)
    assert {c.uid: c.tokens.tolist() for c in done} == want
    assert stats["workers"]["decode:0"]["stage_seconds"]["prefill_s"] == 0.0
    exits = {}
    for log in tmp_path.glob("*.log"):
        for line in log.read_text().splitlines():
            if line.startswith('{"worker_exit"'):
                exits[log.stem] = json.loads(line)["launches"]
    pre, dec = exits["prefill_0"], exits["decode_0"]
    assert pre["cuda_attention.launches"] > 0 and pre["cuda_sgu.launches"] > 0
    assert pre["cuda_paged_gate_mix.launches"] == 0
    assert dec["cuda_paged_gate_mix.launches"] > 0
    assert dec["cuda_attention.launches"] == dec["cuda_sgu.launches"] == 0
