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

import pytest
import torch

import numpy as np

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
