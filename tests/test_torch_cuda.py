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
# the f32 route of K1's three kernels where bf16 takes each route
F32_ROUTE = {"wgmma": "tf32x3", "wmma": "wmma"}


def _f32_route(d: int, wsz: int, bf16_route: str) -> str:
    """K1's f32 route: ``F32_ROUTE``'s, but every K1 kernel takes its
    dim_head-32 ``tf32x3`` kernel at dim_head 32 with a window that is a
    multiple of 128."""
    if d == 32 and wsz % 128 == 0:
        return "tf32x3"
    return F32_ROUTE[bf16_route]


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
    # ProGen-default's head: its own wgmma kernel (f32: tf32x3; the ids kept
    # from when it took wmma)
    pytest.param(2, 3, 1024, 32, 512, "wgmma", id="2-3-1024-32-512-wmma"),
    (2, 8, 1024, 128, 64, "wmma"),     # a window under 128
])
def test_attention_kernel_takes_its_route_and_gives_the_same_bits(
        gen, dtype, b, h, n, d, wsz, bf16_route):
    """K1-fwd on the route each case must take (f32 on the 3xTF32 kernels
    where bf16 takes the wgmma one and at dim_head 32, else on the WMMA
    kernel), against the plain version; a second run gives the same bits."""
    route = (bf16_route if dtype == torch.bfloat16
             else _f32_route(d, wsz, bf16_route))
    assert cuda_attention.fwd_route(dtype, d, wsz) == route
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    before = dict(cuda_attention.fwd_route_launches)
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    torch.cuda.synchronize()
    routed = {r: cuda_attention.fwd_route_launches[r] - before[r] for r in before}
    assert routed == {"wgmma": 0, "tf32x3": 0, "wmma": 0, route: 1}
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
    the 3xTF32 one), against the plain version; a second run gives the same
    bits."""
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
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
    assert routed == {**dict.fromkeys(routed, 0), route: 1}
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
    """Each case on the routes it must take (f32: K1-dq and K1-dkv on the
    3xTF32 kernels where bf16 takes the wgmma ones); a second run gives the
    same bits (no atomics)."""
    dq_route = bf16_route if dtype == torch.bfloat16 else F32_ROUTE[bf16_route]
    dkv_route = (bf16_route if dtype == torch.bfloat16
                 else _f32_route(d, wsz, bf16_route))
    assert cuda_attention.dq_route(dtype, d, wsz) == dq_route
    assert cuda_attention.dkv_route(dtype, d, wsz) == dkv_route
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    before = (cuda_attention.dq_launches, cuda_attention.dkv_launches,
              dict(cuda_attention.dq_route_launches), dict(cuda_attention.dkv_route_launches))
    got = cuda_attention.local_attention_bwd(q, k, v, out, lse, do, wsz)
    torch.cuda.synchronize()
    assert (cuda_attention.dq_launches, cuda_attention.dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    routed = ({r: cuda_attention.dq_route_launches[r] - before[2][r] for r in before[2]},
              {r: cuda_attention.dkv_route_launches[r] - before[3][r] for r in before[3]})
    assert routed == ({"wgmma": 0, "tf32x3": 0, "wmma": 0, dq_route: 1},
                      {"wgmma": 0, "tf32x3": 0, "wmma": 0, dkv_route: 1})
    want = local_attention_bwd(q, k, v, out, lse, do, wsz)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close_scaled(g, w, dtype)
    again = cuda_attention.local_attention_bwd(q, k, v, out, lse, do, wsz)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


# f32 on the 3xTF32 route (K1-fwd, K1-dq, K1-dkv): ProGen-small's serving and
# training shapes, one window (the phantom window alone), ProGen-tiny's
# head, ProGen-base's window, the smallest window the route takes
TF32X3_CASES = [
    (4, 8, 1024, 128, 256),
    (8, 8, 1024, 128, 256),
    (4, 8, 256, 128, 256),
    (2, 8, 1024, 64, 256),
    (1, 12, 2048, 128, 512),
    (1, 3, 512, 128, 128),
]


def _tf32x3_launch(q, k, v, do, wsz, kh, vh):
    """K1-fwd, then K1-dq and K1-dkv from its lse and D (in f32)."""
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, kh, vh)
    dd = (do.float() * out.float()).sum(-1)
    dq = cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz, None, kh, vh)
    return (out, lse, dq, *cuda_attention.local_attention_bwd_dkv(
        q, k, v, do, lse, dd, wsz, None, kh, vh))


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("b,h,n,d,wsz", TF32X3_CASES)
def test_the_tf32x3_kernels_match_plain(gen, b, h, n, d, wsz, halo):
    """K1-fwd, K1-dq and K1-dkv in f32 on the 3xTF32 route, with and
    without a random halo, against the plain version at the f32 bars
    (``out`` and ``lse`` 1e-4; ``dq``, ``dk``, ``dv`` and the halo's at the
    scaled gradient bars); every launch on ``tf32x3`` by the counters; a
    second run gives the same bits."""
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen) for _ in range(4))
    kh, vh = ((torch.randn(b, h, wsz, d, device="cuda", generator=gen) for _ in range(2))
              if halo else (None, None))
    assert cuda_attention.fwd_route(torch.float32, d, wsz) == "tf32x3"
    assert cuda_attention.dkv_route(torch.float32, d, wsz) == "tf32x3"
    assert cuda_attention.dq_route(torch.float32, d, wsz) == "tf32x3"
    counters = (cuda_attention.fwd_route_launches, cuda_attention.dq_route_launches,
                cuda_attention.dkv_route_launches)
    before = [dict(c) for c in counters]
    got = _tf32x3_launch(q, k, v, do, wsz, kh, vh)
    torch.cuda.synchronize()
    for counter, was in zip(counters, before):
        assert counter == {**was, "tf32x3": was["tf32x3"] + 1}
    want, want_lse = local_attention(q, k, v, window_size=wsz, return_lse=True,
                                     k_halo=kh, v_halo=vh)
    _close(got[0], want, torch.float32, TOL_ATTN_OUT)
    _close(got[1], want_lse, torch.float32)
    grads = local_attention_bwd(q, k, v, got[0], got[1], do, wsz, k_halo=kh, v_halo=vh)
    assert len(got) == (7 if halo else 5)
    for g, w in zip(got[2:], grads):
        _close_scaled(g, w, torch.float32)
    for a, g in zip(_tf32x3_launch(q, k, v, do, wsz, kh, vh), got):
        assert torch.equal(a, g)


# f32 at dim_head 32: the training CLI's default run (B 4, ProGen-default's
# H 3, L 1024, window 512), the smallest window the route takes, one window
D32_CASES = [
    (4, 3, 1024, 32, 512),
    (2, 3, 512, 32, 128),
    (1, 2, 512, 32, 512),
]


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("b,h,n,d,wsz", D32_CASES)
def test_the_d32_tf32x3_kernels_match_plain(gen, b, h, n, d, wsz, halo):
    """K1-fwd, K1-dq and K1-dkv in f32 at dim_head 32 on their 3xTF32
    kernels, with and without a random halo, against the plain version at
    the f32 bars; every launch on its route by the counters; a second run
    gives the same bits."""
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen) for _ in range(4))
    kh, vh = ((torch.randn(b, h, wsz, d, device="cuda", generator=gen) for _ in range(2))
              if halo else (None, None))
    routes = ("tf32x3", "tf32x3", "tf32x3")
    counters = (cuda_attention.fwd_route_launches, cuda_attention.dq_route_launches,
                cuda_attention.dkv_route_launches)
    assert tuple(f(torch.float32, d, wsz) for f in (
        cuda_attention.fwd_route, cuda_attention.dq_route, cuda_attention.dkv_route)) == routes
    before = [dict(c) for c in counters]
    got = _tf32x3_launch(q, k, v, do, wsz, kh, vh)
    torch.cuda.synchronize()
    for counter, was, route in zip(counters, before, routes):
        assert counter == {**was, route: was[route] + 1}
    want, want_lse = local_attention(q, k, v, window_size=wsz, return_lse=True,
                                     k_halo=kh, v_halo=vh)
    _close(got[0], want, torch.float32, TOL_ATTN_OUT)
    _close(got[1], want_lse, torch.float32)
    grads = local_attention_bwd(q, k, v, got[0], got[1], do, wsz, k_halo=kh, v_halo=vh)
    assert len(got) == (7 if halo else 5)
    for g, w in zip(got[2:], grads):
        _close_scaled(g, w, torch.float32)
    for a, g in zip(_tf32x3_launch(q, k, v, do, wsz, kh, vh), got):
        assert torch.equal(a, g)


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("b,h,n,d,wsz", D32_CASES)
def test_the_d32_bf16_wgmma_kernels_match_plain(gen, b, h, n, d, wsz, halo):
    """K1-fwd, K1-dq and K1-dkv in bf16 at dim_head 32 on their wgmma
    kernels (64-row blocks, 64-byte-swizzled TMA), with and without a random
    halo, against the plain version at the bf16 bars (``out`` 1e-2, ``lse``
    1e-4; dq, dk, dv and the halo's 2e-2 of their largest plus 2e-2
    relative, RMS 1e-2); every launch on its route by the counters; a second
    run gives the same bits."""
    bf16 = torch.bfloat16
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(bf16)
                   for _ in range(4))
    kh, vh = ((torch.randn(b, h, wsz, d, device="cuda", generator=gen).to(bf16)
               for _ in range(2)) if halo else (None, None))
    routes = ("wgmma", "wgmma", "wgmma")
    counters = (cuda_attention.fwd_route_launches, cuda_attention.dq_route_launches,
                cuda_attention.dkv_route_launches)
    assert tuple(f(bf16, d, wsz) for f in (
        cuda_attention.fwd_route, cuda_attention.dq_route, cuda_attention.dkv_route)) == routes
    before = [dict(c) for c in counters]
    got = _tf32x3_launch(q, k, v, do, wsz, kh, vh)
    torch.cuda.synchronize()
    for counter, was, route in zip(counters, before, routes):
        assert counter == {**was, route: was[route] + 1}
    want, want_lse = local_attention(q, k, v, window_size=wsz, return_lse=True,
                                     k_halo=kh, v_halo=vh)
    _close(got[0], want, bf16, TOL_ATTN_OUT)
    _close(got[1], want_lse, torch.float32)
    grads = local_attention_bwd(q, k, v, got[0], got[1], do, wsz, k_halo=kh, v_halo=vh)
    assert len(got) == (7 if halo else 5)
    for g, w in zip(got[2:], grads):
        assert g.dtype == bf16
        _close_scaled(g, w, bf16)
    for a, g in zip(_tf32x3_launch(q, k, v, do, wsz, kh, vh), got):
        assert torch.equal(a, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("b,h,n,d,wsz", D32_CASES)
def test_the_d32_dq_kernels_match_plain_and_wmma(gen, b, h, n, d, wsz, halo, dtype):
    """K1-dq at dim_head 32 on its Hopper kernel (f32 ``tf32x3``, bf16
    ``wgmma``), with and without a random halo, from the lse of K1-fwd's
    kernel: against the plain K1-dq and the first (``wmma``) kernel forced
    on the same inputs, each at the scaled gradient bars; one launch on its
    route by the counters; a second run gives the same bits."""
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    kh, vh = ((torch.randn(b, h, wsz, d, device="cuda", generator=gen).to(dtype)
               for _ in range(2)) if halo else (None, None))
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert cuda_attention.dq_route(dtype, d, wsz) == route
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, kh, vh)
    dd = (do.float() * out.float()).sum(-1)
    before = dict(cuda_attention.dq_route_launches)
    dq = cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz, None, kh, vh)
    torch.cuda.synchronize()
    assert cuda_attention.dq_route_launches == {**before, route: before[route] + 1}
    assert dq.dtype == dtype
    _close_scaled(dq, local_attention_bwd(q, k, v, out, lse, do, wsz, k_halo=kh,
                                          v_halo=vh)[0], dtype)
    _close_scaled(dq, cuda_attention.local_attention_bwd_dq(
        q, k, v, do, lse, dd, wsz, None, kh, vh, route="wmma"), dtype)
    assert torch.equal(
        cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz, None, kh, vh), dq)


def test_the_d32_bf16_kernels_replay_in_a_cuda_graph(gen):
    """bf16 K1-fwd, K1-dq and K1-dkv at dim_head 32 on their wgmma kernels
    captured in one CUDA graph with a halo at ProGen-default's head and
    window, replayed 3 times after new inputs are copied in: each replay
    bit-equal to eager launches on the same inputs."""
    _d32_graph_replay(gen, torch.bfloat16)


def test_the_d32_tf32x3_kernels_replay_in_a_cuda_graph(gen):
    """f32 K1-fwd, K1-dq and K1-dkv at dim_head 32 on their tf32x3 kernels,
    as the bf16 ones replay."""
    _d32_graph_replay(gen, torch.float32)


def _d32_graph_replay(gen, dtype):
    assert {f(dtype, 32, 512) for f in (cuda_attention.fwd_route, cuda_attention.dq_route,
                                        cuda_attention.dkv_route)} == \
        {"wgmma" if dtype == torch.bfloat16 else "tf32x3"}
    shape, wsz = (2, 3, 1024, 32), 512
    static = [torch.randn(*shape, device="cuda", generator=gen).to(dtype) for _ in range(4)]
    static += [torch.randn(2, 3, wsz, 32, device="cuda", generator=gen).to(dtype)
               for _ in range(2)]
    q, k, v, do, kh, vh = static
    _tf32x3_launch(q, k, v, do, wsz, kh, vh)  # build and load before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _tf32x3_launch(q, k, v, do, wsz, kh, vh)
    for _ in range(3):
        for t in static:
            t.copy_(torch.randn(t.shape, device="cuda", generator=gen).to(dtype))
        graph.replay()
        want = _tf32x3_launch(q, k, v, do, wsz, kh, vh)
        torch.cuda.synchronize()
        for a, g in zip(outs, want):
            assert torch.equal(a, g)


def test_the_tf32x3_kernels_replay_in_a_cuda_graph(gen):
    """K1-fwd, K1-dq and K1-dkv on the 3xTF32 route captured in one CUDA graph
    (with a halo, at ProGen-small's head and window) and replayed 3 times
    after new inputs are copied in: each replay bit-equal to eager launches
    on the same inputs."""
    shape, wsz = (2, 4, 1024, 128), 256
    static = [torch.randn(*shape, device="cuda", generator=gen) for _ in range(4)]
    static += [torch.randn(2, 4, wsz, 128, device="cuda", generator=gen) for _ in range(2)]
    q, k, v, do, kh, vh = static
    _tf32x3_launch(q, k, v, do, wsz, kh, vh)  # build and load before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _tf32x3_launch(q, k, v, do, wsz, kh, vh)
    for _ in range(3):
        for t in static:
            t.copy_(torch.randn(t.shape, device="cuda", generator=gen))
        graph.replay()
        want = _tf32x3_launch(q, k, v, do, wsz, kh, vh)
        torch.cuda.synchronize()
        for a, g in zip(outs, want):
            assert torch.equal(a, g)


# f32 K2-fwd, K2-dgate and K2-dW on the 3xTF32 route: ProGen-small's training shape,
# batch 1, a ragged n, the main path's largest prefill, under one tile
# with a ragged channel tile (W padded to 16-byte rows), ragged n and d
K2_TF32X3_CASES = [
    (8, 1024, 2048),
    (1, 1024, 2048),
    (4, 1000, 2048),
    (2, 512, 2048),
    (3, 100, 520),
    (2, 1000, 520),
]


def _k2_tf32x3_launch(res, gate, w, bias, dout, route=None):
    """K2-fwd, d_res (K2-fwd with dout in place of res), K2-dW and
    K2-dgate."""
    return (cuda_sgu.spatial_gate_fwd(res, gate, w, bias, route=route),
            cuda_sgu.spatial_gate_fwd(dout, gate, w, bias, route=route),
            cuda_sgu.spatial_gate_dw(dout, res, gate, route=route),
            cuda_sgu.spatial_gate_dgate(w, dout, res, route=route))


def _k2_inputs(gen, b, n, d):
    res, gate, dout = (torch.randn(b, n, d, device="cuda", generator=gen) for _ in range(3))
    w = torch.randn(n, n, device="cuda", generator=gen) * 0.05
    bias = torch.randn(n, 1, device="cuda", generator=gen)
    return res, gate, w, bias, dout


@pytest.mark.parametrize("b,n,d", K2_TF32X3_CASES)
def test_the_k2_tf32x3_kernels_match_plain(gen, b, n, d):
    """K2-fwd, K2-dgate and K2-dW in f32 on the 3xTF32 route against the
    plain versions at the f32 bars (``out`` 1e-4, ``dW`` and ``d_gate`` at
    the scaled gradient bars), every launch on ``tf32x3``, a second run the
    same bits, dW's strict upper triangle 0; the first (``fma``) kernels,
    forced on the same inputs, within the same bars."""
    res, gate, w, bias, dout = _k2_inputs(gen, b, n, d)
    for route in (cuda_sgu.fwd_route, cuda_sgu.dgate_route, cuda_sgu.dw_route):
        assert route(torch.float32) == "tf32x3"
    counters = (cuda_sgu.fwd_route_launches, cuda_sgu.dw_route_launches,
                cuda_sgu.dgate_route_launches)
    before = [dict(c) for c in counters]
    got = _k2_tf32x3_launch(res, gate, w, bias, dout)
    torch.cuda.synchronize()
    for counter, was, n_launches in zip(counters, before, (2, 1, 1)):
        assert counter == {**was, "tf32x3": was["tf32x3"] + n_launches}
    want = (gated_mix(res, gate, w, bias), gated_mix(dout, gate, w, bias),
            spatial_gate_dw(dout, res, gate), spatial_gate_dgate(w, dout, res))
    for first in (got, _k2_tf32x3_launch(res, gate, w, bias, dout, route="fma")):
        _close(first[0], want[0], torch.float32)
        _close(first[1], want[1], torch.float32)
        _close_scaled(first[2], want[2], torch.float32)
        _close_scaled(first[3], want[3], torch.float32)
    assert torch.count_nonzero(torch.triu(got[2], 1)) == 0
    for a, g in zip(_k2_tf32x3_launch(res, gate, w, bias, dout), got):
        assert torch.equal(a, g)


def test_the_k2_tf32x3_kernels_replay_in_a_cuda_graph(gen):
    """K2-fwd, d_res, K2-dW and K2-dgate on the 3xTF32 route captured in one CUDA graph
    at ProGen-small's gMLP width, a ragged n, and replayed 3 times after new
    inputs are copied in: each replay bit-equal to eager launches."""
    static = list(_k2_inputs(gen, 2, 1000, 2048))
    _k2_tf32x3_launch(*static)  # build and load before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _k2_tf32x3_launch(*static)
    for _ in range(3):
        for t in static:
            t.copy_(torch.randn(t.shape, device="cuda", generator=gen))
        graph.replay()
        want = _k2_tf32x3_launch(*static)
        torch.cuda.synchronize()
        for a, g in zip(outs, want):
            assert torch.equal(a, g)


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
    cases also at the plain 1e-4 / 0.05 bars they always had.  Each launch
    on the route of its dtype (bf16 ``wgmma``, f32 ``tf32x3``).  Two runs
    give the same bits; d_W's strict upper triangle is exactly 0."""
    res, gate, dout = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
    w = (torch.randn(n, n, device="cuda", generator=gen) * 0.05).to(dtype)
    before = cuda_sgu.dgate_launches, cuda_sgu.dw_launches
    routes = dict(cuda_sgu.dgate_route_launches), dict(cuda_sgu.dw_route_launches)
    dgate = cuda_sgu.spatial_gate_dgate(w, dout, res)
    dw = cuda_sgu.spatial_gate_dw(dout, res, gate)
    torch.cuda.synchronize()
    assert (cuda_sgu.dgate_launches, cuda_sgu.dw_launches) == \
        (before[0] + 1, before[1] + 1)
    bf16 = dtype == torch.bfloat16
    for counter, was, route in ((cuda_sgu.dgate_route_launches, routes[0],
                                 "wgmma" if bf16 else "tf32x3"),
                                (cuda_sgu.dw_route_launches, routes[1],
                                 "wgmma" if bf16 else "tf32x3")):
        assert counter == {**was, route: was[route] + 1}
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


# SHA-256 of bf16_backward_digests() from a build of kernels/csrc as it was
# before K1-dq and K2-dgate had an f32 "tf32x3" route (NVIDIA H100 80GB
# HBM3, nvcc 12.9): adding those routes moves no bf16 bit
BF16_BWD_SHA256 = {
    "dq": "a6d5edb4b86390d5213ae97fba291355866c5837d13f884f0dee76210aebcdb8",
    "dq_halo": "bc034500412638fb0331b6cf363f7614546e1aa3f7b1805e7c791717c2e679d1",
    "dgate": "d7218a506e61239705270b9725c70a62f58590d931cdc17482a3ce9695f0568b",
    "dgate_ragged": "1ec13704d3f9886ec7a966ff29f8f31e6135e7e8d15fd7f50f6da338ce9d84b0",
}


def bf16_backward_digests(csrc: str | None = None) -> dict[str, str]:
    """SHA-256 of bf16 K1-dq's output at (2, 8, 1024, 128), window 256,
    without and with a halo (lse from the bf16 K1-fwd kernel), and of bf16
    K2-dgate's at (2, 1024, 2048) and (1, 1000, 520): inputs drawn with
    numpy from seed 0, so that they do not depend on torch's generators.
    ``csrc`` builds and loads the kernels from another copy of
    ``kernels/csrc`` for the call (how BF16_BWD_SHA256 was taken:
    ``python tests/test_torch_cuda.py OTHER/progen_tpu_torch/kernels/csrc``)."""
    import hashlib
    from pathlib import Path

    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
        return x.to(device="cuda", dtype=torch.bfloat16).contiguous()

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy().tobytes()
                              ).hexdigest()

    saved = (kernels.CSRC, dict(kernels._loaded), dict(cuda_attention._fns),
             dict(cuda_sgu._fns))
    if csrc is not None:
        kernels.CSRC = Path(csrc)
        for cache in (kernels._loaded, cuda_attention._fns, cuda_sgu._fns):
            cache.clear()
    try:
        got = {}
        b, h, n, d, wsz = 2, 8, 1024, 128, 256
        q, k, v, do = (randn(b, h, n, d) for _ in range(4))
        kh, vh = randn(b, h, wsz, d), randn(b, h, wsz, d)
        dd = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).cuda()
        for name, halo in (("dq", (None, None)), ("dq_halo", (kh, vh))):
            _, lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, *halo)
            got[name] = digest(cuda_attention.local_attention_bwd_dq(
                q, k, v, do, lse, dd, wsz, None, *halo))
        for name, (b, n, d) in (("dgate", (2, 1024, 2048)), ("dgate_ragged", (1, 1000, 520))):
            dout, res = randn(b, n, d), randn(b, n, d)
            w = randn(n, n, scale=0.05)
            got[name] = digest(cuda_sgu.spatial_gate_dgate(w, dout, res))
        return got
    finally:
        kernels.CSRC = saved[0]
        for cache, was in zip((kernels._loaded, cuda_attention._fns, cuda_sgu._fns),
                              saved[1:]):
            cache.clear()
            cache.update(was)


# SHA-256 of f32_attention_digests() from a build of kernels/csrc as it was
# before K1-fwd and K1-dkv had their dim_head-32 tf32x3 kernels (NVIDIA
# H100 80GB HBM3, nvcc 12.9): adding those kernels moves no bit of the
# dim_head-128 f32 ones
F32_ATTN_SHA256 = {
    "out": "ad3f5274b8fd5f5b98671109b32a9b65545f12d1e4a01fe814421594c208c6b2",
    "lse": "15d2f7fe10e1970af15bf71cab2d0cc8e410394f39036a2fcd7f8d3aa58e34a2",
    "dq": "9d9bd419043ac6947e34455dcb61b898ea4c0b176c63aa155502c743d7f57e77",
    "dk": "255db120e1bb839d62d927a2a284c2cd6bb77eeda46367b239231217c8d65e8e",
    "dv": "3b1988c7f75e750715958cacb49df1a13c45242579740535ff5c55b98080220d",
    "out_with_halo": "c4069e952c68ffe4e2695106460ab0f8b8d416377a5820876f23d37ca5050bf5",
    "lse_with_halo": "af213ee5f1a202b5a9a678cc04892254b63867247ef140004fec18d583eea20f",
    "dq_with_halo": "cd18ef03140686ff0fd6679b299867a86dd8c9fde9503af987923f369f9f498f",
    "dk_with_halo": "b1caa3edfdc1b3c016d0d758058de67818d453d31b3fb19cf311b84ce4bfa32e",
    "dv_with_halo": "e0acba0a8f94f74044a9dd2712fe7f97e598cc9f08a019f3f172dcd0616d6ae0",
    "dk_halo_with_halo": "464a83d647919b887e6563f9226c255f4e3a80dfa8a82c0acbb6ac37dd391387",
    "dv_halo_with_halo": "15e46aa07009cd4ca8c1254c6041c860e161825296b42affd05f65362f31b3c4",
}


def f32_attention_digests(csrc: str | None = None) -> dict[str, str]:
    """SHA-256 of the f32 K1-fwd's out and lse, K1-dq's dq and K1-dkv's dk
    and dv (and dk_halo, dv_halo) at (2, 8, 1024, 128), window 256, on the
    tf32x3 route, without and with a halo: inputs drawn with numpy from
    seed 1.  ``csrc`` as for :func:`bf16_backward_digests`."""
    import hashlib
    from pathlib import Path

    rng = np.random.default_rng(1)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.int32).cpu().numpy().tobytes()
                              ).hexdigest()

    saved = (kernels.CSRC, dict(kernels._loaded), dict(cuda_attention._fns))
    if csrc is not None:
        kernels.CSRC = Path(csrc)
        for cache in (kernels._loaded, cuda_attention._fns):
            cache.clear()
    try:
        got = {}
        b, h, n, d, wsz = 2, 8, 1024, 128, 256
        q, k, v, do = (randn(b, h, n, d) for _ in range(4))
        kh, vh = randn(b, h, wsz, d), randn(b, h, wsz, d)
        for suffix, halo in (("", (None, None)), ("_with_halo", (kh, vh))):
            outs = _tf32x3_launch(q, k, v, do, wsz, *halo)
            names = ("out", "lse", "dq", "dk", "dv", "dk_halo", "dv_halo")
            for name, t in zip(names, outs):
                got[name + suffix] = digest(t)
        return got
    finally:
        kernels.CSRC = saved[0]
        for cache, was in zip((kernels._loaded, cuda_attention._fns), saved[1:]):
            cache.clear()
            cache.update(was)


# SHA-256 of kept_digests() from a build of kernels/csrc as it was before
# K1-fwd and K1-dkv had their bf16 dim_head-32 kernels (NVIDIA H100 80GB
# HBM3, nvcc 12.9): adding those kernels moves no bit of the bf16 K1 at
# dim_head 64 and 128, of K2 and of any f32 output.  The k1_bfloat16_d32
# entries from a build as it was before K1-dq had its dim_head-32 Hopper
# kernels: adding those moves no bit of the others (K1-dq at dim_head 32
# is taken on the "wmma" kernel, which they left alone).
KEPT_SHA256 = {
    "k1_bfloat16_d128_out":
        "764c6a71c3788b052625a177dfef9bfff69219bd64c5f6ee90ffa4eb3f8b9f50",
    "k1_bfloat16_d128_lse":
        "9fc2d1aca927399ae247a1402fc391742e55f0d5b795a67a0bbc7f0deb793b81",
    "k1_bfloat16_d128_dq":
        "3e4e8353246e603b760cae9b8f560f983c638177a4e500f20ba15944f90f195c",
    "k1_bfloat16_d128_dk":
        "e0d4468486fadb66cc0e62d1d0ae3ee0e770227bdf5759fb5f1838fae016ec25",
    "k1_bfloat16_d128_dv":
        "3058db164026a1e4d005ad427a285a49163a204da8568d402f682111de879bb2",
    "k1_bfloat16_d128_out_with_halo":
        "3cde280378a2398bba3620569b9b4a2bd5dc8af73e343d2f21772e2c791ce3e8",
    "k1_bfloat16_d128_lse_with_halo":
        "aa3a4716fc088d78e9398ddd80523e42308b48a4f4cbbcb19d2f59905a75ccef",
    "k1_bfloat16_d128_dq_with_halo":
        "d4540a9656b461dfc7c36b9e1cc1c754ee44b66b1f5f53436b279a3593f92e39",
    "k1_bfloat16_d128_dk_with_halo":
        "5cfa2e9971aaf9128035e4707092cf4a4f684329ad4007f58a917faaa491b07f",
    "k1_bfloat16_d128_dv_with_halo":
        "fa936f68eaf7715b078bd31f1e92ff5991b0dbd2732ed87005579b488c8e88e6",
    "k1_bfloat16_d128_dk_halo_with_halo":
        "31601a01b08194c7702f08a6552b8bda17dd1f1846d3cc92acb10d0f91827ba0",
    "k1_bfloat16_d128_dv_halo_with_halo":
        "2c534ee78b302b993ad927e0cb382d4f99e22100de94cf5644e2d2e479d27319",
    "k1_bfloat16_d64_out":
        "08d04ca24ad6af33d86e1afef46d716d718a4768081f26c3b46e411056913130",
    "k1_bfloat16_d64_lse":
        "2ebc9fad1acab8c67d5e2db95e6810056f853e3b63670009ea95f3b06e222c6a",
    "k1_bfloat16_d64_dq":
        "acf7c8cfc44c10ebf6f987123447b0ddbdbe53951c46e0eec38d2ace89f34732",
    "k1_bfloat16_d64_dk":
        "bbc45bb3fa35634058b23309909ea8f5a15d469ff55a5e1c161b0fff2e83d4d2",
    "k1_bfloat16_d64_dv":
        "7383a8763d10a3d9e619232731a961a1b5fee55225b63780b14aa22e4e85e78a",
    "k1_bfloat16_d64_out_with_halo":
        "74fedd811660955a27e77e15723193ed878dd1d1006e9ea56d4ee530fa87a2f4",
    "k1_bfloat16_d64_lse_with_halo":
        "f4b72b5f57a8683eafc249f98911cbb7753a079e1c0ab6df8fe53a6bc482d74a",
    "k1_bfloat16_d64_dq_with_halo":
        "9fd46d9c2863f8c9f7051386e42398bba4bf646d8a2b9efbb1fbf22fe64ed659",
    "k1_bfloat16_d64_dk_with_halo":
        "eac097c94fbbfd63f3067b616740a436abeefd2139b686ac7a9fffc0dcab062b",
    "k1_bfloat16_d64_dv_with_halo":
        "07ae23511c45adff8e85ce35c3e068af6a89c87e722b0a577cbd7008c121f0c3",
    "k1_bfloat16_d64_dk_halo_with_halo":
        "0fe3aa5a48367447d2a025efc7f188277ca2303e325505a2227beed3bfd047a6",
    "k1_bfloat16_d64_dv_halo_with_halo":
        "2f7f6d099a6af0851cd7d6af6497d144b9e5b57645851518fd22e48950fcd171",
    "k1_float32_d32_out":
        "3477b52f588928502d66c60692115b7c7134d08bc7b24b3923ca623793f4efb4",
    "k1_float32_d32_lse":
        "c70b17c005cd379a58b5df2e3902677baee2303c9ff0376fdd62b7b34ff40917",
    "k1_float32_d32_dq":
        "62777df39ca153208aeef14f74b022c690e431de3c2daa3dc855e95162e15b86",
    "k1_float32_d32_dk":
        "83245ce153b9512636e25142d3c02386e8c608563fe886808a1ea4fa1e8f9518",
    "k1_float32_d32_dv":
        "9071b27848f5fccca6d38219d0fc13f247b44b10811053f7e8ebca928bf6c7fa",
    "k1_float32_d32_out_with_halo":
        "fd84df7264e85948d7ed8daaff395a93f7792da64f65876adc8fec92fe579eb3",
    "k1_float32_d32_lse_with_halo":
        "b262e5d9b21fa1a133b9a362d418fdb62174c3fcee27d0f118a363de71641964",
    "k1_float32_d32_dq_with_halo":
        "14a505bc33437b8ce947b8e68d9ca58010aeb435e7e7024e0910dc339f2b73cb",
    "k1_float32_d32_dk_with_halo":
        "a9b479dbb4e481d755d25f486002f58b33fe112a0158fa83cfca433cd60d4908",
    "k1_float32_d32_dv_with_halo":
        "3a4a0ff0c57b3e7f3424d7616013d23251a358701458928f581c05e26cb30c41",
    "k1_float32_d32_dk_halo_with_halo":
        "20bdcaefdd41539e221f7bbcd987e698819acb2848a2d27eadd3b0d852aa8daf",
    "k1_float32_d32_dv_halo_with_halo":
        "b266c61e3ec370df81c37e3196f80f6e011fc1b68c60ad64495a6003e1d1ec9b",
    "k1_float32_d64_out":
        "e0f91e8e8a809a2961b964c03a87549ced33b7e1f2a949d80c2af05ada137e48",
    "k1_float32_d64_lse":
        "f5f961429ace9cdd412917f361390f8503fedc3e5a1ae2a2abd40b55335aaf1e",
    "k1_float32_d64_dq":
        "89c2008c57a71707338ca16f2af2cb62273a9a8292a6cb0830fcf6abc8ecf22e",
    "k1_float32_d64_dk":
        "6a6d1485a552d1607805ffcb98717669cbff2140b329783b33a581662462ffb6",
    "k1_float32_d64_dv":
        "10bc3bf28a5b0089070984971a92a372c910ec05d7ea0f234e2df4016927ddd4",
    "k1_float32_d64_out_with_halo":
        "e031655522fed9596a7b3f4e2746cb055613b8fca133286958993b670da6deec",
    "k1_float32_d64_lse_with_halo":
        "b5abdec7f732027bcb3f540c60de0a16d2173768668c60cd003bdca3a0dc85be",
    "k1_float32_d64_dq_with_halo":
        "3904e39088ce721d3009fb7ed0ae1ace97af60f18ce66d593e4a22739e5aa416",
    "k1_float32_d64_dk_with_halo":
        "99bb1b0bf4886ca5e0652b1492c29bc141ca2a77f488ac5804cfd28ed071eeb0",
    "k1_float32_d64_dv_with_halo":
        "4002f6bdd04a3ef7bf8fa5f1c6a37e3bcdd05059d988ed0ccd3a0f323e4d7c60",
    "k1_float32_d64_dk_halo_with_halo":
        "e23153bcc3200139e0040ee6ad55bf297a426625530c999fa9cca7a8917b6c95",
    "k1_float32_d64_dv_halo_with_halo":
        "a3e804ebfccc563985968dc9911fd956fd83c55f59794f5395fad19e8a91c21c",
    "k2_bfloat16_fwd": "1584334438700e9cfa0caffbb01b9c2a61f8ed460584ac1ef0a15517ae91c4c9",
    "k2_bfloat16_dgate":
        "3cc5e00ac9bf61738cb4e455fc35c86828b0283fd42cc86ab99b577bd41c0385",
    "k2_bfloat16_dw": "c461a1cc2c3d6628ac1c0d6628312d8f997ed2ffa6866d612a99c57210d13ed8",
    "k2_float32_fwd": "72c1ba7fe05f76bdc5002550bf2656f10f4b596850599b994041568150774aef",
    "k2_float32_dgate": "b15610f8d35bf49b8902e290631f899e5a44f0c3fdb8cabf8102edb58ed2050e",
    "k2_float32_dw": "47647b9e9de89462bcf4082a26d1b9e31c97a91ae4cd2037c0c968798e157aba",
    "k1_bfloat16_d32_out":
        "1a64b56eabf0d1e4e8e9cb4e3aa5861c95fb0dd0084cb29cdedfc81266874019",
    "k1_bfloat16_d32_lse":
        "f9137ee8696f9cba3c17a20c1ca15c7823c057f8fe142181a25a5f8a10f51d9f",
    "k1_bfloat16_d32_dq":
        "0d7578df6f97f33d79704957007cab9fb76574f0dbb4ca33d38510e0be4d4501",
    "k1_bfloat16_d32_dk":
        "85175f5e5cb7ca31bca415bd6990d9b6879781da1aff29bea35efb28ce9ab54b",
    "k1_bfloat16_d32_dv":
        "0b4e982ada8a83c533cef7d84ca06c3ad79f0fa64ba8deca2203f629e834e6dd",
    "k1_bfloat16_d32_out_with_halo":
        "7a643ba7f577836c51f42371ff4ed00247221bd6382dc25e5c0e37a471dd45d3",
    "k1_bfloat16_d32_lse_with_halo":
        "466a5e5b17d6b0a4dda773e693a2d2cf959bb22c490ffade7cfc1ffb430835ec",
    "k1_bfloat16_d32_dq_with_halo":
        "be8773608dcaa4ed7daa7e9c1c70d5b02f661d5105137638c9e98b85633c8de6",
    "k1_bfloat16_d32_dk_with_halo":
        "0aa571ca5b91480326cdfba90a9d123d74aaa0820745d2361cb893a4372ef1ae",
    "k1_bfloat16_d32_dv_with_halo":
        "84d9c989dcde1216e1093f658932f5a294f573a379027bb9416cd77f2802f00b",
    "k1_bfloat16_d32_dk_halo_with_halo":
        "b25819bdc93b28ba9a7f8e6caab5feb39a61908187b784d591036c3d391bbc68",
    "k1_bfloat16_d32_dv_halo_with_halo":
        "dc7eb6a33ead884c668923d505b434beae2ab1c41f0b3d43334c45ebe578b3b2",
}


def kept_digests(csrc: str | None = None) -> dict[str, str]:
    """SHA-256 of the outputs that the dim_head-32 Hopper kernels must leave
    alone: bf16 K1-fwd's out and lse, K1-dq's dq and K1-dkv's dk and dv at
    (2, 3, 1024, 128) and (2, 3, 1024, 64), window 256, without and with a
    halo; bf16 K2-fwd, K2-dgate and K2-dW at (2, 1024, 2048); the same K1
    outputs in f32 at dim_head 32 (window 512) and 64 and in bf16 at
    dim_head 32 (window 512); f32 K2's three.  At dim_head 32 K1-dq runs the
    first (``wmma``) kernel, forced.  Inputs drawn with numpy from seed 7.
    ``csrc`` as for :func:`bf16_backward_digests`."""
    import hashlib
    from pathlib import Path

    rng = np.random.default_rng(7)

    def randn(*shape, dtype, scale=1.0):
        x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
        return x.to(device="cuda", dtype=dtype).contiguous()

    def digest(t):
        t = t.contiguous()
        view = t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)
        return hashlib.sha256(view.cpu().numpy().tobytes()).hexdigest()

    saved = (kernels.CSRC, dict(kernels._loaded), dict(cuda_attention._fns),
             dict(cuda_sgu._fns))
    if csrc is not None:
        kernels.CSRC = Path(csrc)
        for cache in (kernels._loaded, cuda_attention._fns, cuda_sgu._fns):
            cache.clear()
    try:
        got = {}
        names = ("out", "lse", "dq", "dk", "dv", "dk_halo", "dv_halo")

        def k1(dtype, d, wsz):
            q, k, v, do = (randn(2, 3, 1024, d, dtype=dtype) for _ in range(4))
            kh, vh = (randn(2, 3, wsz, d, dtype=dtype) for _ in range(2))
            dq_route = "wmma" if d == 32 else None
            for suffix, halo in (("", (None, None)), ("_with_halo", (kh, vh))):
                out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, *halo)
                dd = (do.float() * out.float()).sum(-1)
                outs = (out, lse,
                        cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz, None,
                                                              *halo, route=dq_route),
                        *cuda_attention.local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz,
                                                                None, *halo))
                for name, t in zip(names, outs):
                    got[f"k1_{str(dtype)[6:]}_d{d}_{name}{suffix}"] = digest(t)

        for case in ((torch.bfloat16, 128, 256), (torch.bfloat16, 64, 256),
                     (torch.float32, 32, 512), (torch.float32, 64, 256)):
            k1(*case)
        for dtype in (torch.bfloat16, torch.float32):
            res, gate, dout = (randn(2, 1024, 2048, dtype=dtype) for _ in range(3))
            w = randn(1024, 1024, dtype=dtype, scale=0.05)
            bias = randn(1024, 1, dtype=dtype)
            got[f"k2_{str(dtype)[6:]}_fwd"] = digest(cuda_sgu.spatial_gate_fwd(res, gate, w, bias))
            got[f"k2_{str(dtype)[6:]}_dgate"] = digest(cuda_sgu.spatial_gate_dgate(w, dout, res))
            got[f"k2_{str(dtype)[6:]}_dw"] = digest(cuda_sgu.spatial_gate_dw(dout, res, gate))
        k1(torch.bfloat16, 32, 512)  # drawn last: the earlier inputs stay as they were
        return got
    finally:
        kernels.CSRC = saved[0]
        for cache, was in zip((kernels._loaded, cuda_attention._fns, cuda_sgu._fns),
                              saved[1:]):
            cache.clear()
            cache.update(was)


def test_the_kernels_beside_the_bf16_d32_ones_keep_their_bits(gen):
    """bf16 K1 at dim_head 64 and 128 (with and without a halo), bf16 K2,
    f32 K1 at dim_head 32 and 64 and f32 K2 give the bits of the build
    before the bf16 dim_head-32 kernels were added; bf16 K1 at dim_head 32
    those of the build before K1-dq's dim_head-32 kernels were added
    (K1-dq at dim_head 32 on the ``wmma`` kernel, forced)."""
    assert cuda_attention.fwd_route(torch.bfloat16, 32, 512) == "wgmma"
    assert cuda_attention.dq_route(torch.float32, 32, 512) == "tf32x3"
    assert kept_digests() == KEPT_SHA256


def test_the_d128_f32_kernels_keep_their_bits(gen):
    """f32 K1-fwd, K1-dq and K1-dkv at dim_head 128 (with and without a
    halo) give the bits of the build before the dim_head-32 kernels were
    added."""
    assert cuda_attention.fwd_route(torch.float32, 128, 256) == "tf32x3"
    assert f32_attention_digests() == F32_ATTN_SHA256


def test_bf16_dq_and_dgate_keep_their_bits(gen):
    """bf16 K1-dq (with and without a halo) and K2-dgate give the bits of
    the build before their f32 tf32x3 routes were added."""
    assert cuda_attention.dq_route(torch.bfloat16, 128, 256) == "wgmma"
    assert cuda_sgu.dgate_route(torch.bfloat16) == "wgmma"
    assert bf16_backward_digests() == BF16_BWD_SHA256


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


def test_the_captured_f32_step_on_tf32x3_is_the_eager_steps(gen):
    """The f32 optimizer step at a head and window the 3xTF32 kernels take
    (dim_head 64, window 128): captured and replayed by ``train_multi_step``
    it gives the eager steps' losses, grad norms and parameters bit for bit,
    every launch of the six training kernels on ``tf32x3``."""
    cfg = ProGenConfig(num_tokens=256, dim=128, seq_len=256, depth=2, window_size=128,
                       global_mlp_depth=1, heads=2, dim_head=64)
    micros = torch.randint(1, 256, (2, 2, 1, 2, cfg.seq_len + 1), device="cuda",
                           generator=gen)
    runs = []
    for fused in (False, True):
        model = ProGen(cfg, make_policy(False), device="cuda", seed=6)
        fns = make_train_functions(model, make_optimizer())
        state = fns.init_state()
        counters = (cuda_attention.fwd_route_launches, cuda_attention.dq_route_launches,
                    cuda_attention.dkv_route_launches, cuda_sgu.fwd_route_launches,
                    cuda_sgu.dgate_route_launches, cuda_sgu.dw_route_launches)
        before = tuple(dict(c) for c in counters)
        losses = []
        for sb in micros:
            if fused:
                state, m = fns.train_multi_step(state, sb)
                losses.append(m["loss"].reshape(-1))
            else:
                for i in range(sb.shape[0]):
                    state, m = fns.train_step(state, sb[i, 0])
                    losses.append(m["loss"].reshape(-1))
        torch.cuda.synchronize()
        after = (cuda_attention.fwd_route_launches, cuda_attention.dq_route_launches,
                 cuda_attention.dkv_route_launches, cuda_sgu.fwd_route_launches,
                 cuda_sgu.dgate_route_launches, cuda_sgu.dw_route_launches)
        routed = [{r: a[r] - b[r] for r in b if a[r] != b[r]} for a, b in zip(after, before)]
        gmlp = cfg.global_mlp_depth
        assert routed == [{"tf32x3": 4 * cfg.depth}, {"tf32x3": 4 * cfg.depth},
                          {"tf32x3": 4 * cfg.depth}, {"tf32x3": 8 * gmlp},
                          {"tf32x3": 4 * gmlp}, {"tf32x3": 4 * gmlp}]
        if fused:
            assert fns.captured_program().captured
        runs.append((torch.cat(losses), _state_tensors(state)))
    assert torch.equal(runs[0][0], runs[1][0])
    for name, t in runs[0][1].items():
        assert torch.equal(runs[1][1][name], t), name


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
    give every gradient bit for bit, with all six training kernels on
    ``tf32x3``; the embedding's weight gradient is a one-hot product, not
    ``F.embedding``'s atomic sum."""
    from progen_tpu_torch.train.loss import batch_loss

    cfg = ProGenConfig(num_tokens=256, dim=256, seq_len=256, depth=2, window_size=128,
                       global_mlp_depth=1, heads=2, dim_head=128)
    batch = torch.randint(1, 256, (8, cfg.seq_len + 1), device="cuda", generator=gen)
    counters = (cuda_attention.fwd_route_launches, cuda_attention.dq_route_launches,
                cuda_attention.dkv_route_launches, cuda_sgu.fwd_route_launches,
                cuda_sgu.dgate_route_launches, cuda_sgu.dw_route_launches)
    grads = []
    for _ in range(2):
        before = [dict(c) for c in counters]
        model = ProGen(cfg, make_policy(False), device="cuda", seed=5)
        batch_loss(model(batch[:, :-1]), batch[:, 1:]).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        torch.cuda.synchronize()
        routed = [{r for r in c if c[r] != was[r]} for c, was in zip(counters, before)]
        assert routed == [{"tf32x3"}] * 6
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



def test_probe_backend_finds_the_card(gen, capsys):
    """``observe.platform.probe_backend`` (``chip_smoke.py``'s first call)
    brings the card up in its subprocess at the first attempt and prints
    nothing; the peak behind MFU is known for the H100 80GB HBM3 only."""
    from progen_tpu_torch.observe import platform
    from progen_tpu_torch.observe.flops import PEAK_BF16_FLOPS, peak_flops_per_chip

    assert platform.probe_backend() is True
    assert capsys.readouterr().out == ""
    assert platform.LAST_PROBE["attempts"] == 1 and platform.LAST_PROBE["ok"]
    assert peak_flops_per_chip() == PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps({"bf16": bf16_backward_digests(*sys.argv[1:2]),
                      "f32": f32_attention_digests(*sys.argv[1:2]),
                      "kept": kept_digests(*sys.argv[1:2])}))
