"""The port's ops (``progen_tpu_torch.ops``) against the JAX package's, on
the same numpy-seeded inputs.  f32 is held at rtol/atol 1e-5 (the bar of
tests/test_pallas_attention.py and test_pallas_sgu.py), bf16 at 0.05.
Where JAX has a Pallas kernel it runs in the interpreter, as its own tests
run it on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from progen_tpu.ops import local_attention as jax_local_attention
from progen_tpu.ops.pallas_attention import _forward_ext, pallas_local_attention
from progen_tpu.ops.pallas_sgu import pallas_spatial_gate
from progen_tpu.ops.rotary import apply_rotary_pos_emb as jax_rotary
from progen_tpu.ops.rotary import fixed_pos_embedding as jax_tables
from progen_tpu.ops.sgu import spatial_gate as jax_spatial_gate
from progen_tpu.ops.shift import shift_tokens as jax_shift
from progen_tpu_torch import kernels
from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.ops.local_attention import local_attention
from progen_tpu_torch.ops.rotary import apply_rotary_pos_emb, fixed_pos_embedding
from progen_tpu_torch.ops.sgu import gated_mix, spatial_gate
from progen_tpu_torch.ops.shift import shift_tokens

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.05)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n,d", [(16, 8), (24, 32)])
def test_rotary_matches_jax(n, d):
    sin, cos = fixed_pos_embedding(n, d)
    jsin, jcos = jax_tables(n, d)
    np.testing.assert_allclose(_np(sin), _np(jsin), **F32)
    np.testing.assert_allclose(_np(cos), _np(jcos), **F32)
    x = _normal(np.random.default_rng(0), 2, 3, n, d)
    got = apply_rotary_pos_emb(torch.from_numpy(x), sin, cos)
    want = jax_rotary(jnp.asarray(x), jsin, jcos)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_rotary_partial_rot_dim_passes_the_rest():
    x = _normal(np.random.default_rng(1), 2, 8, 12)
    sin, cos = fixed_pos_embedding(8, 8)
    jsin, jcos = jax_tables(8, 8)
    got = apply_rotary_pos_emb(torch.from_numpy(x), sin, cos)
    np.testing.assert_allclose(_np(got), _np(jax_rotary(jnp.asarray(x), jsin, jcos)),
                               **F32)
    np.testing.assert_array_equal(_np(got)[..., 8:], x[..., 8:])


@pytest.mark.parametrize("d", [8, 7])
def test_shift_matches_jax(d):
    x = _normal(np.random.default_rng(2), 2, 5, d)
    got = shift_tokens(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), _np(jax_shift(jnp.asarray(x))))


ATTN_CASES = [
    (16, 8, 8),   # two windows
    (24, 8, 16),  # L not a multiple of 2*wsz
    (8, 8, 4),    # single window: every query sees the phantom zero window
    (32, 8, 32),
]


@pytest.mark.parametrize("n,wsz,d", ATTN_CASES)
def test_local_attention_matches_jax_and_pallas(n, wsz, d):
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, 2, 3, n, d) for _ in range(3))
    got, lse = local_attention(*map(torch.from_numpy, (q, k, v)),
                               window_size=wsz, return_lse=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jax_local_attention(jq, jk, jv, window_size=wsz)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(
        _np(got), _np(pallas_local_attention(jq, jk, jv, wsz)), **F32)
    # the TPU kernel's own logsumexp, through the interpreter
    pad = [(0, 0), (0, 0), (wsz, 0), (0, 0)]
    _, want_lse = _forward_ext(jq, jnp.pad(jk, pad), jnp.pad(jv, pad), wsz,
                               d ** -0.5, True)
    np.testing.assert_allclose(_np(lse), _np(want_lse), **F32)


def test_local_attention_phantom_window_counts_in_the_denominator():
    """Window 0's zero keys add wsz zero logits: renormalising over the
    own window alone would give a different answer."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 1, 8, 4)) for _ in range(3))
    got = local_attention(q, k, v, window_size=8)
    sim = (q @ k.transpose(-1, -2)) * 4 ** -0.5
    sim = sim.masked_fill(~torch.ones(8, 8, dtype=torch.bool).tril(), float("-inf"))
    own_only = torch.softmax(sim, -1) @ v
    assert not torch.allclose(got, own_only, atol=1e-3)
    np.testing.assert_allclose(
        _np(got), _np(jax_local_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                          window_size=8)), **F32)


def test_local_attention_bf16_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, 1, 2, 16, 8) for _ in range(3))
    got = local_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)),
                          window_size=8)
    assert got.dtype == torch.bfloat16
    want = jax_local_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                               window_size=8)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("n", [100, 130])
def test_sgu_matches_jax_and_pallas(n):
    rng = np.random.default_rng(6)
    d = 16
    res, gate = _normal(rng, 2, n, d), _normal(rng, 2, n, d)
    w = rng.normal(0, 0.05, size=(n, n)).astype(np.float32)
    b = rng.normal(size=(n, 1)).astype(np.float32)
    got_mix = spatial_gate(*(torch.from_numpy(t) for t in (gate, w, b)))
    np.testing.assert_allclose(
        _np(got_mix), _np(jax_spatial_gate(*(jnp.asarray(t) for t in (gate, w, b)))),
        **F32)
    got = gated_mix(*(torch.from_numpy(t) for t in (res, gate, w, b)))
    want = pallas_spatial_gate(*(jnp.asarray(t) for t in (res, gate, w, b)))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_sgu_bf16_matches_jax():
    rng = np.random.default_rng(7)
    n, d = 64, 16
    res, gate = _normal(rng, 2, n, d), _normal(rng, 2, n, d)
    w = rng.normal(0, 0.05, size=(n, n)).astype(np.float32)
    b = np.ones((n, 1), np.float32)
    got = gated_mix(*(torch.from_numpy(t).bfloat16() for t in (res, gate, w, b)))
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(t, jnp.bfloat16) for t in (res, gate, w, b)]
    np.testing.assert_allclose(_np(got), _np(j[0] * jax_spatial_gate(*j[1:])), **BF16)


def test_kernel_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 2, 16, 32)) for _ in range(3))
    before = cuda_attention.launches, cuda_sgu.launches
    out, lse = cuda_attention.local_attention_fwd(q, k, v, 8)
    want, want_lse = local_attention(q, k, v, window_size=8, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    res, gate = (torch.from_numpy(_normal(rng, 2, 16, 8)) for _ in range(2))
    w = torch.from_numpy(_normal(rng, 16, 16))
    b = torch.ones(16, 1)
    assert torch.equal(cuda_sgu.spatial_gate_fwd(res, gate, w, b),
                       gated_mix(res, gate, w, b))
    assert (cuda_attention.launches, cuda_sgu.launches) == before


def test_kernel_wrappers_raise_on_cuda_tensors_without_a_build(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with no nvcc there is no
    silent fallback to the plain version."""
    monkeypatch.setattr(kernels, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(cuda_attention, "_fn", None)
    monkeypatch.setattr(cuda_sgu, "_fn", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR / "absent")
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 32, device="cuda")
        gate = torch.empty(2, 16, 8, device="cuda")
        w = torch.empty(16, 16, device="cuda")
        b = torch.empty(16, 1, device="cuda")
    before = cuda_attention.launches, cuda_sgu.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_attention.local_attention_fwd(q, q, q, 8)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_sgu.spatial_gate_fwd(gate, gate, w, b)
    assert (cuda_attention.launches, cuda_sgu.launches) == before


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 48, device="cuda")  # dim_head 48
        q16 = torch.empty(1, 2, 16, 32, device="cuda", dtype=torch.float16)
        gate = torch.empty(2, 16, 12, device="cuda")  # d % 8 != 0
        w = torch.empty(16, 16, device="cuda")
        b = torch.empty(16, 1, device="cuda")
    with pytest.raises(ValueError, match="dim_head"):
        cuda_attention.local_attention_fwd(q, q, q, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_attention.local_attention_fwd(q16, q16, q16, 8)
    with pytest.raises(ValueError, match="divisible"):
        cuda_attention.local_attention_fwd(q, q, q, 5)
    with pytest.raises(ValueError, match="d % 8"):
        cuda_sgu.spatial_gate_fwd(gate, gate, w, b)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
