"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run them
on the card with ``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``.
f32 is held at 1e-4 (summation order).  bf16 SGU outputs are O(1) and are
held at 0.05 (the JAX package's bf16 bar); bf16 attention outputs are
averages of many values, well below 1, and are held at 1e-2.  bf16
attention gradients are held at 2e-2 of their largest magnitude (their
size depends on the shape), plus 2e-2 relative."""

import pytest
import torch

from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.prefill import make_prefiller
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
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
@pytest.mark.parametrize("b,h,n,d,wsz", [
    (2, 3, 16, 32, 8),      # windows smaller than a 64-row tile
    (1, 2, 64, 64, 64),     # single window: the phantom window only
    (2, 2, 192, 128, 64),
    (1, 1, 40, 32, 40),     # a tile that overhangs the sequence
    (1, 2, 512, 128, 256),  # ProGen-small's window
])
def test_attention_backward_kernels_match_plain(gen, dtype, b, h, n, d, wsz):
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    before = cuda_attention.dq_launches, cuda_attention.dkv_launches
    got = cuda_attention.local_attention_bwd(q, k, v, out, lse, do, wsz)
    torch.cuda.synchronize()
    assert (cuda_attention.dq_launches, cuda_attention.dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    want = local_attention_bwd(q, k, v, out, lse, do, wsz)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close_scaled(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d", [(2, 100, 16), (1, 130, 64), (3, 256, 136)])
def test_sgu_backward_kernels_match_plain(gen, dtype, b, n, d):
    res, gate, dout = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
    w = (torch.randn(n, n, device="cuda", generator=gen) * 0.05).to(dtype)
    before = cuda_sgu.dgate_launches, cuda_sgu.dw_launches
    dgate = cuda_sgu.spatial_gate_dgate(w, dout, res)
    dw = cuda_sgu.spatial_gate_dw(dout, res, gate)
    torch.cuda.synchronize()
    assert (cuda_sgu.dgate_launches, cuda_sgu.dw_launches) == \
        (before[0] + 1, before[1] + 1)
    _close(dgate, spatial_gate_dgate(w, dout, res), dtype)
    _close(dw, spatial_gate_dw(dout, res, gate), dtype)
    assert dw.dtype == dtype
    assert torch.count_nonzero(torch.triu(dw, 1)) == 0


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
