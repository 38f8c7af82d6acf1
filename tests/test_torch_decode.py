"""The port's serving path (``progen_tpu_torch.decode``) against the JAX
package's: prefill harvest at ragged lengths, the cached decode step,
greedy chunked sampling, Gumbel top-k on JAX's own noise, EOS truncation
and early exit.  f32 at 1e-4 (accumulation order differs over depth), bf16
at 0.05."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import make_chunked_sampler as jax_chunked_sampler
from progen_tpu.decode import make_prefiller as jax_prefiller
from progen_tpu.decode import teacher_forced_logits as jax_teacher_forced
from progen_tpu.decode.incremental import LocalAttentionDecode as JaxAttnDecode
from progen_tpu.decode.incremental import SGUDecode as JaxSGUDecode
from progen_tpu.decode.sampler import gumbel_topk_sample as jax_gumbel_topk
from progen_tpu.decode.sampler import truncate_after_eos as jax_truncate
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.parallel import unbox
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode import (
    ProGenDecodeStep,
    gumbel_topk_sample,
    init_caches,
    make_chunked_sampler,
    make_prefiller,
    pad_prime_length,
    teacher_forced_logits,
    truncate_after_eos,
)
from progen_tpu_torch.decode.incremental import local_attention_decode, sgu_decode
from progen_tpu_torch.models.progen import ProGen, ProGenConfig

torch.set_num_threads(1)

CFG = ProGenConfig(num_tokens=32, dim=32, seq_len=32, depth=3, window_size=8,
                   global_mlp_depth=2, heads=2, dim_head=16, ff_mult=2)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.05)
# The SGU gate cache is a LayerNorm output of the layers' bf16 residual
# stream: values near the row mean keep the rounding differences of every
# layer below at full size.  On these inputs JAX's own bf16 gate cache
# differs from its f32 one by up to 0.07, so it is held at twice BF16.
BF16_GATE = dict(rtol=0.1, atol=0.1)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=CFG, policy=jax_policy(False))
    tokens = jnp.zeros((2, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(11), tokens))


def _port(params, mixed: bool = False):
    model = ProGen(CFG, make_policy(mixed), device="cpu")
    model.load_state_dict(params_from_flax(params))
    return model.eval()


def _eos_params(params):
    """Params whose to_logits bias makes EOS (token 0) win every argmax."""
    p = params["params"]
    bias = p["to_logits"]["bias"]
    return {"params": {**p, "to_logits": {**p["to_logits"],
                                          "bias": bias.at[0].add(1e4)}}}


def _tokens(seed, shape, low=1):
    return np.random.default_rng(seed).integers(low, CFG.num_tokens, size=shape)


def test_pad_prime_length():
    assert pad_prime_length(1, 8, 32) == 8
    assert pad_prime_length(9, 8, 32) == 16
    assert pad_prime_length(32, 8, 32) == 32
    assert pad_prime_length(17, 8, 64) == 24
    with pytest.raises(ValueError):
        pad_prime_length(0, 8, 32)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_harvest_at_ragged_lengths_matches_jax(flax_params, mixed):
    tokens = _tokens(0, (3, 16))
    lengths = np.array([5, 16, 9])
    decode_len = 24
    want_logits, want = jax_prefiller(CFG, jax_policy(mixed))(
        flax_params, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths),
        decode_len=decode_len)
    got_logits, got = make_prefiller(_port(flax_params, mixed))(
        torch.from_numpy(tokens), torch.from_numpy(lengths), decode_len)
    tol = BF16 if mixed else F32
    dtype = torch.bfloat16 if mixed else torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **tol)
    for name in ("attn_prev", "ff_prev", "k", "v"):
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            assert g.dtype == dtype, f"{name}[{i}]"
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32), **tol,
                                       err_msg=f"{name}[{i}]")
    assert set(got["sgu_gate"]) == set(want["sgu_gate"]) == {"1", "2"}
    for key, g in got["sgu_gate"].items():
        assert g.shape == (3, decode_len, CFG.dim * CFG.ff_mult // 2)
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(want["sgu_gate"][key], np.float32),
                                   **(BF16_GATE if mixed else F32))
        assert not g[0, 5:].any()  # rows past the prime stay zero


def test_decode_step_matches_the_parallel_forward_and_jax(flax_params):
    tokens = _tokens(1, (2, 16), low=0)
    model = _port(flax_params)
    got = teacher_forced_logits(model, torch.from_numpy(tokens))
    with torch.no_grad():
        parallel = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), parallel.numpy(), **F32)
    want = jax_teacher_forced(CFG, flax_params, jnp.asarray(tokens, jnp.int32),
                              jax_policy(False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bf16_decode_step_matches_the_parallel_forward_and_jax(flax_params):
    """The main path's dtype: bf16 compute, f32 params and logits."""
    tokens = _tokens(1, (2, 16), low=0)
    model = _port(flax_params, mixed=True)
    got = teacher_forced_logits(model, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    with torch.no_grad():
        parallel = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), parallel.numpy(), **BF16)
    want = jax_teacher_forced(CFG, flax_params, jnp.asarray(tokens, jnp.int32),
                              jax_policy(True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _jax_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _assert_same_bf16(got, want, what):
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32), err_msg=what)


# The bf16 decode ops below are held to JAX's bit for bit: on the CPU both
# round in the same places, and a lost cast (probabilities to bf16, the
# f32 logits, the SGU's f32 mix and bias before its cast) moves an output by
# one bf16 ulp, which any tolerance would hide.


def test_bf16_attention_decode_step_matches_jax_bit_for_bit(flax_params):
    rng = np.random.default_rng(8)
    b, w, ring = 2, CFG.window_size, 2 * CFG.window_size
    pos = np.array([5, 21])  # window 0 (phantom slots) and window 2
    s = np.arange(ring)[None]
    p_s = pos[:, None] - np.mod(pos[:, None] - s, ring)
    valid = p_s >= (pos // w * w)[:, None] - w
    x, prev = rng.normal(size=(2, b, CFG.dim))
    k_cache, v_cache = rng.normal(size=(2, b, CFG.heads, ring, CFG.dim_head))
    angle = rng.uniform(0, 6, size=(b, CFG.dim_head))
    sin, cos = np.sin(angle), np.cos(angle)
    block = _port(flax_params, mixed=True).attn[0]
    jax_block = JaxAttnDecode(dim=CFG.dim, window_size=w, heads=CFG.heads,
                              dim_head=CFG.dim_head, shift=block.shift,
                              policy=jax_policy(True))
    want = jax_block.apply(
        {"params": flax_params["params"]["attn0"]}, *map(_jax_bf16, (
            x, sin, cos)), jnp.asarray(pos % ring), jnp.asarray(valid),
        *map(_jax_bf16, (prev, k_cache, v_cache)))
    k_t, v_t = _bf16(k_cache), _bf16(v_cache)
    out, new_prev = local_attention_decode(
        block, _bf16(x), _bf16(sin), _bf16(cos), torch.from_numpy(pos % ring),
        torch.from_numpy(valid), _bf16(prev), k_t, v_t)
    for name, g, w_ in zip(("out", "prev", "k", "v"),
                           (out, new_prev, k_t, v_t), want):
        assert g.dtype == torch.bfloat16, name
        _assert_same_bf16(g, w_, name)


def test_bf16_sgu_decode_step_matches_jax_bit_for_bit(flax_params):
    rng = np.random.default_rng(9)
    hidden = CFG.dim * CFG.ff_mult
    n = CFG.seq_len
    # weights far from the init scale, so the mix is not ~ the bias
    sgu = {**flax_params["params"]["ff1"]["sgu"],
           "spatial_weights": rng.normal(0, 0.3, (n, n)).astype(np.float32),
           "spatial_biases": rng.normal(size=(n, 1)).astype(np.float32)}
    params = {"params": {**flax_params["params"],
                         "ff1": {**flax_params["params"]["ff1"], "sgu": sgu}}}
    pos = np.array([5, 21])
    x = rng.normal(size=(2, hidden))
    gate_cache = rng.normal(size=(2, n, hidden // 2))
    jax_block = JaxSGUDecode(seq_len=n, dim_out=hidden // 2,
                             policy=jax_policy(True))
    want, want_cache = jax_block.apply({"params": sgu}, _jax_bf16(x),
                                       jnp.asarray(pos), _jax_bf16(gate_cache))
    cache = _bf16(gate_cache)
    out = sgu_decode(_port(params, mixed=True).ff[1].sgu, _bf16(x),
                     torch.from_numpy(pos), cache)
    assert out.dtype == cache.dtype == torch.bfloat16
    _assert_same_bf16(out, want, "out")
    _assert_same_bf16(cache, want_cache, "gate cache")


def test_decode_step_takes_per_row_positions(flax_params):
    """Rows at different positions in one step: each row matches the same
    row stepped alone."""
    model = _port(flax_params)
    step = ProGenDecodeStep(model)
    tokens = torch.from_numpy(_tokens(2, (2, 12), low=0))
    caches = init_caches(CFG, 2, model.policy, decode_len=12, device="cpu")
    for pos in range(9):
        step(tokens[:, pos], pos, caches)
    alone = [init_caches(CFG, 1, model.policy, decode_len=12, device="cpu")
             for _ in range(2)]
    for b in range(2):
        for pos in range(9):
            step(tokens[b:b + 1, pos], pos, alone[b])
    logits, _ = step(tokens[:, 9], torch.tensor([9, 9]), caches)
    for b in range(2):
        want, _ = step(tokens[b:b + 1, 9], 9, alone[b])
        np.testing.assert_allclose(logits[b:b + 1].numpy(), want.numpy(), **F32)


def test_greedy_chunked_sampler_tokens_match_jax(flax_params):
    prime = _tokens(3, (2, 5))
    length = 24
    want = jax_chunked_sampler(CFG, jax_policy(False), chunk_size=4)(
        flax_params, jax.random.key(0), jnp.asarray(prime, jnp.int32), length,
        top_k=None, add_bos=True, temperature=0.0)
    sampler = make_chunked_sampler(_port(flax_params), chunk_size=4)
    got = sampler(torch.from_numpy(prime), length, add_bos=True,
                  temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sampler.last_num_chunks == -(-(length - 6) // 4)


def test_early_exit_matches_jax(flax_params):
    params = _eos_params(flax_params)
    prime = _tokens(4, (2, 3))
    jax_sample = jax_chunked_sampler(CFG, jax_policy(False), chunk_size=4)
    want = jax_sample(params, jax.random.key(0), jnp.asarray(prime, jnp.int32),
                      24, top_k=5, add_bos=True, temperature=1.0)
    sampler = make_chunked_sampler(_port(params), chunk_size=4)
    got = sampler(torch.from_numpy(prime), 24,
                  generator=torch.Generator().manual_seed(0), top_k=5,
                  add_bos=True, temperature=1.0)
    # EOS wins every draw, so the rows are done after the first chunk
    assert sampler.last_num_chunks == jax_sample.last_num_chunks == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_is_seeded_and_stays_in_the_vocabulary(flax_params):
    sampler = make_chunked_sampler(_port(flax_params), chunk_size=8)
    prime = torch.from_numpy(_tokens(5, (2, 4)))

    def draw(seed):
        return sampler(prime, 32, generator=torch.Generator().manual_seed(seed),
                       top_k=8, add_bos=True, temperature=1.0)

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 32) and int(a.min()) >= 0 and int(a.max()) < CFG.num_tokens
    assert torch.equal(a[:, 1:5], prime)


@pytest.mark.parametrize("top_k,temperature", [(5, 1.0), (3, 0.5), (None, 2.0)])
def test_gumbel_topk_on_jax_noise_gives_jax_tokens(top_k, temperature):
    logits = np.random.default_rng(6).normal(size=(4, CFG.num_tokens)).astype(np.float32)
    key = jax.random.key(9)
    want = jax_gumbel_topk(key, jnp.asarray(logits), top_k, temperature)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = gumbel_topk_sample(torch.from_numpy(logits), top_k, temperature,
                             noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_topk_greedy_and_mask():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0]])
    assert int(gumbel_topk_sample(logits, None, 0.0)) == 1
    mask = torch.tensor([[True, False, True, True]])
    assert int(gumbel_topk_sample(logits, None, 0.0, mask=mask)) == 3
    gen = torch.Generator().manual_seed(0)
    draws = {int(gumbel_topk_sample(logits, 2, 1.0, generator=gen))
             for _ in range(50)}
    assert draws == {1, 3}  # top-2 only


def test_truncate_after_eos_matches_jax():
    seq = np.random.default_rng(7).integers(0, 4, size=(6, 20))
    seq[:, 0] = 0
    got = truncate_after_eos(torch.from_numpy(seq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_truncate(jnp.asarray(seq))))
    row = torch.tensor([[0, 5, 6, 0, 7, 0, 8]])
    assert truncate_after_eos(row).tolist() == [[0, 5, 6, 0, 0, 0, 0]]
