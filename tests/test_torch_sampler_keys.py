"""The port's sampler on the JAX key chain: ``make_sampler`` and
``ChunkedSampler`` given a ``KeySeq`` key give the JAX package's
``make_sampler`` tokens bit for bit, on the same parameters (f32, the
``default`` config at a short length); and the port's sampling CLI takes
the JAX CLI's defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sample as jax_cli
from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.core.rng import KeySeq as JaxKeySeq
from progen_tpu.decode import make_sampler as jax_make_sampler
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models.configs import DEFAULT as JAX_DEFAULT
from progen_tpu.parallel import unbox
from progen_tpu_torch import sample as port_cli
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode import ChunkedSampler, make_sampler
from progen_tpu_torch.decode.rng import KeySeq
from progen_tpu_torch.models.configs import DEFAULT
from progen_tpu_torch.models.progen import ProGen

torch.set_num_threads(1)

LENGTH = 40


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_DEFAULT, policy=jax_policy(False))
    tokens = jnp.zeros((1, JAX_DEFAULT.window_size), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(3), tokens))


@pytest.fixture(scope="module")
def port_model(flax_params):
    model = ProGen(DEFAULT, make_policy(False), device="cpu")
    model.load_state_dict(params_from_flax(flax_params))
    return model.eval()


@pytest.fixture(scope="module")
def jax_sample():
    return jax_make_sampler(JAX_DEFAULT, jax_policy(False))


def test_key_seq_matches_jax():
    """``next(KeySeq(seed))`` is ``split(key(seed))[1]``, step after step."""
    for seed in (0, 42, 2 ** 32 - 1):
        port, ref = KeySeq(seed), JaxKeySeq(seed)
        for _ in range(4):
            np.testing.assert_array_equal(next(port).numpy(),
                                          np.asarray(jax.random.key_data(next(ref))))


@pytest.mark.parametrize("prime_len,add_bos,top_k,temperature,chunk", [
    (5, True, 5, 1.0, 32),      # top-k 5 at temperature 1
    (5, True, None, 0.0, 32),   # greedy
    (0, True, 25, 1.0, 32),     # add_bos with an empty prime: BOS alone
    (9, True, 25, 1.0, 7),      # a chunk that does not divide the decode
    (4, False, 5, 0.7, 16),     # the prime as given, no BOS
], ids=["topk5", "greedy", "empty_prime", "chunk7", "no_bos"])
def test_key_chain_sampler_gives_jax_tokens(flax_params, port_model, jax_sample,
                                            prime_len, add_bos, top_k, temperature,
                                            chunk):
    prime = np.random.default_rng(prime_len).integers(1, 256, size=(2, prime_len))
    if not add_bos:
        prime[:, 0] = 0  # the BOS/pad column the CLI gives an empty prime
    want = jax_sample(flax_params, next(JaxKeySeq(42)), jnp.asarray(prime, jnp.int32),
                      length=LENGTH, top_k=top_k, add_bos=add_bos,
                      temperature=temperature)
    got = make_sampler(port_model, chunk_size=chunk)(
        torch.from_numpy(prime), LENGTH, key=next(KeySeq(42)), top_k=top_k,
        add_bos=add_bos, temperature=temperature)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_another_key_gives_other_tokens(port_model):
    sampler = ChunkedSampler(port_model, chunk_size=16)
    prime = torch.ones(2, 3, dtype=torch.long)
    a, b = (sampler(prime, LENGTH, key=next(KeySeq(seed)), top_k=25, add_bos=True)
            for seed in (42, 43))
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="not both"):
        sampler(prime, LENGTH, key=next(KeySeq(42)), generator=torch.Generator())


def _click_default(name):
    return next(p.default for p in jax_cli.main.params if p.name == name)


@pytest.mark.parametrize("name", ["seed", "chunk", "top_k", "temperature", "num_samples"])
def test_cli_defaults_are_the_jax_clis(name):
    assert getattr(port_cli.parse_args([]), name) == _click_default(name)
