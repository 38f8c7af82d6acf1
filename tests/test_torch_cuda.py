"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run them
on the card with ``python -m pytest tests/test_torch_cuda.py -m gpu``.
f32 is held at 1e-4 (summation order).  bf16 SGU outputs are O(1) and are
held at 0.05 (the JAX package's bf16 bar); bf16 attention outputs are
averages of many values, well below 1, and are held at 1e-2."""

import pytest
import torch

from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.prefill import make_prefiller
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.ops.local_attention import local_attention
from progen_tpu_torch.ops.sgu import gated_mix

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
TOL_ATTN_OUT = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
