"""The port's key chain (``progen_tpu_torch.decode.rng``) against
``jax.random``: keys, splits and random bits equal JAX's uint32 words
EXACTLY; Gumbel noise within 2e-6 absolute (two f32 logs, whose last bit
differs between the libraries); and the per-row sampler picks JAX's tokens
given JAX's logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.decode.sampler import (
    gumbel_topk_sample_batched as jax_sample_batched,
    split_keys_batched as jax_split_keys_batched,
)
from progen_tpu_torch.decode import rng
from progen_tpu_torch.decode.sampler import (
    gumbel_topk_sample_batched,
    split_keys_batched,
)

torch.set_num_threads(1)

V = 256


def _seeds(seed, n=6):
    drawn = np.random.default_rng(seed).integers(0, 2 ** 32, size=n, dtype=np.uint64)
    drawn[:2] = (0, 2 ** 32 - 1)
    return drawn.astype(np.uint32)


def _jax_keys(seeds):
    return jax.vmap(jax.random.key)(jnp.asarray(seeds))


def _port_keys(seeds):
    return rng.key(torch.from_numpy(seeds.astype(np.int64)))


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int64
    assert bool(((t >= 0) & (t < 2 ** 32)).all())
    return t.numpy().astype(np.uint32)


def test_jax_is_on_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_matches_jax(seed):
    seeds = _seeds(seed)
    want = np.asarray(jax.random.key_data(_jax_keys(seeds)))
    np.testing.assert_array_equal(_u32(_port_keys(seeds)), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_matches_jax(seed):
    seeds = _seeds(seed)
    want = jax.vmap(jax.random.split)(_jax_keys(seeds))
    got = rng.split(_port_keys(seeds))
    np.testing.assert_array_equal(_u32(got), np.asarray(jax.random.key_data(want)))
    # and a second generation, from the children
    want2 = jax.vmap(lambda k: jax.random.split(k, 3))(want[:, 1])
    np.testing.assert_array_equal(_u32(rng.split(got[:, 1], 3)),
                                  np.asarray(jax.random.key_data(want2)))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_keys_batched_matches_jax_over_a_chain(seed):
    seeds = _seeds(seed)
    jax_data = jax.random.key_data(_jax_keys(seeds))
    port_data = _port_keys(seeds)
    for _ in range(5):
        jax_data, jax_sub = jax_split_keys_batched(jax_data)
        port_data, port_sub = split_keys_batched(port_data)
        np.testing.assert_array_equal(_u32(port_data), np.asarray(jax_data))
        np.testing.assert_array_equal(_u32(port_sub),
                                      np.asarray(jax.random.key_data(jax_sub)))


@pytest.mark.parametrize("n", [1, 7, V])
def test_random_bits_match_jax(n):
    seeds = _seeds(3)
    want = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(_jax_keys(seeds))
    np.testing.assert_array_equal(_u32(rng.random_bits(_port_keys(seeds), n)),
                                  np.asarray(want))


def test_uniform_matches_jax():
    """Exactly on the unit ranges the Gumbel draw uses (the scaling is then
    exact); within an f32 ulp on a general range, where XLA may fuse the
    multiply and the add."""
    seeds = _seeds(4)
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi, exact in ((0.0, 1.0, True), (tiny, 1.0, True), (-2.5, 4.0, False)):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (V,), jnp.float32, lo, hi))(_jax_keys(seeds)))
        got = rng.uniform(_port_keys(seeds), V, lo, hi).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
        assert got.min() >= lo and got.max() < hi


@pytest.mark.parametrize("seed", [5, 6])
def test_gumbel_matches_jax(seed):
    seeds = _seeds(seed)
    want = jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(_jax_keys(seeds))
    got = rng.gumbel(_port_keys(seeds), V)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def _sampling_case(seed, b=12):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(b, V)).astype(np.float32) * 3.0
    seeds = r.integers(0, 2 ** 32, size=b, dtype=np.uint64).astype(np.uint32)
    return logits, seeds


def _both(logits, seeds, top_k, temp, mask=None, dtype=jnp.float32):
    want = jax_sample_batched(
        _jax_keys(seeds), jnp.asarray(logits).astype(dtype), jnp.asarray(top_k),
        jnp.asarray(temp), None if mask is None else jnp.asarray(mask))
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = gumbel_topk_sample_batched(
        _port_keys(seeds), torch.from_numpy(logits).to(torch_dtype),
        torch.from_numpy(top_k).long(), torch.from_numpy(temp),
        None if mask is None else torch.from_numpy(mask))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_sampler_picks_jax_tokens(seed):
    """Greedy rows, top_k 0 (disabled) and 8, temperatures 0.7-1.3, row by
    row in one batch."""
    logits, seeds = _sampling_case(seed)
    b = len(seeds)
    top_k = np.array([0, 8] * (b // 2), np.int32)
    temp = np.linspace(0.7, 1.3, b).astype(np.float32)
    temp[::3] = 0.0
    got, want = _both(logits, seeds, top_k, temp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[::3], logits[::3].argmax(-1))  # greedy rows
    # top-k rows never leave their 8 best logits
    order = np.argsort(-logits, axis=-1)
    for row in range(1, b, 2):
        if temp[row] > 0:
            assert got[row] in order[row, :8]


def test_batched_sampler_respects_a_logit_mask():
    logits, seeds = _sampling_case(7)
    b = len(seeds)
    mask = np.random.default_rng(8).random((b, V)) < 0.1
    mask[:, 5] = True  # never an all-false row
    top_k = np.array([0, 8, 300] * (b // 3), np.int32)  # 300 clips to V
    temp = np.where(np.arange(b) % 4 == 0, 0.0, 1.0).astype(np.float32)
    got, want = _both(logits, seeds, top_k, temp, mask)
    np.testing.assert_array_equal(got, want)
    assert mask[np.arange(b), got].all()


def test_batched_sampler_survives_a_tiny_temperature_on_bf16_logits():
    """bf16 logits over temperature 1e-9 overflow and give NaN rows unless
    the sampler works in f32 and floors the temperature at 1e-8."""
    logits, seeds = _sampling_case(9)
    b = len(seeds)
    top_k = np.full(b, 8, np.int32)
    temp = np.full(b, 1e-9, np.float32)
    got, want = _both(logits * 10, seeds, top_k, temp, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(got, want)
    as_bf16 = torch.from_numpy(logits * 10).to(torch.bfloat16).float().numpy()
    assert (as_bf16[np.arange(b), got] == as_bf16.max(-1)).all()
