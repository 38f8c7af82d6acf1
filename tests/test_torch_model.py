"""The port's ProGen (``progen_tpu_torch.models``) against the JAX package's,
on parameters drawn by the JAX init and carried across by
``compat/convert.py``.  Whole-model logits and intermediates at f32 are held
at 1e-4 (accumulation order differs over depth), bf16 at 0.05."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.parallel import unbox
from progen_tpu_torch.compat.convert import (
    load_npz,
    params_from_flax,
    params_to_flax,
    save_npz,
)
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.models.progen import ProGen, ProGenConfig

torch.set_num_threads(1)

CFG = ProGenConfig(num_tokens=32, dim=32, seq_len=32, depth=3, window_size=8,
                   global_mlp_depth=2, heads=2, dim_head=16, ff_mult=2)
L = 24  # three windows, shorter than seq_len: the SGU slices its weights
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.05)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=CFG, policy=jax_policy(False))
    tokens = jnp.zeros((2, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(3), tokens))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, CFG.num_tokens, size=(2, L))


def _port(flax_params, mixed: bool):
    model = ProGen(CFG, make_policy(mixed), device="cpu")
    model.load_state_dict(params_from_flax(flax_params))
    return model.eval()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_params_round_trip(flax_params, tmp_path):
    state = params_from_flax(flax_params)
    model = ProGen(CFG, make_policy(False), device="cpu")
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape, name
    # flax Dense kernels are (in, out); nn.Linear weights are (out, in)
    np.testing.assert_array_equal(
        state["attn.0.to_qkv.weight"].numpy(),
        np.asarray(flax_params["params"]["attn0"]["to_qkv"]["kernel"]).T)
    back = dict(_flat(params_to_flax(state)))
    want = dict(_flat(flax_params["params"]))
    assert set(back) == set(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key])
    model.load_state_dict(state)
    path = tmp_path / "w.npz"
    save_npz(path, model)
    other = ProGen(CFG, make_policy(False), device="cpu", seed=1)
    load_npz(path, other)
    for name, t in model.state_dict().items():
        assert torch.equal(other.state_dict()[name], t), name


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_logits_match_jax(flax_params, tokens, impl, mixed):
    jax_model = JaxProGen(config=CFG, policy=jax_policy(mixed),
                          attn_impl=impl, sgu_impl=impl)
    want = jax_model.apply(flax_params, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = _port(flax_params, mixed)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(BF16 if mixed else F32))


def test_intermediates_match_the_flax_cache_collection(flax_params, tokens):
    jax_model = JaxProGen(config=CFG, policy=jax_policy(False))
    _, varz = jax_model.apply(flax_params, jnp.asarray(tokens, jnp.int32),
                              mutable=["cache"])
    with torch.no_grad():
        _, cache = _port(flax_params, False)(torch.from_numpy(tokens),
                                             return_cache=True)
    want = dict(_flat(varz["cache"]))  # sown values are 1-tuples
    got = {}
    for block, entries in cache.items():
        for name, value in entries.items():
            if isinstance(value, dict):
                for sub, t in value.items():
                    got[(block, name, sub)] = t
            else:
                got[(block, name)] = value
    assert set(got) == set(want)
    for key, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[key][0], **F32,
                                   err_msg=str(key))


def test_seeded_init_matches_the_jax_distributions():
    c = CONFIGS["default"]
    model = ProGen(c, make_policy(), device="cpu", seed=0)
    again = ProGen(c, make_policy(), device="cpu", seed=0)
    for name, t in model.state_dict().items():
        assert torch.equal(t, again.state_dict()[name]), name
    w = model.attn[0].to_qkv.weight.detach()
    assert abs(float(w.std()) - c.dim ** -0.5) < 0.05 * c.dim ** -0.5
    std_trunc = c.dim ** -0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std_trunc + 1e-6
    assert float(model.to_logits.bias.detach().abs().max()) == 0.0
    emb = model.embed.weight.detach()
    assert abs(float(emb.std()) - c.dim ** -0.5) < 0.05 * c.dim ** -0.5
    sgu = model.ff[c.depth - 1].sgu.requires_grad_(False)
    n = c.seq_len
    assert float(sgu.spatial_weights.abs().max()) <= 1e-3 / n
    assert float(sgu.spatial_weights.std()) > 0.5 * (1e-3 / n) / 3 ** 0.5
    assert torch.equal(sgu.spatial_biases, torch.ones(n, 1))
    assert model.ff[0].sgu is None and model.ff[0].glu


def test_forward_rejects_what_the_model_cannot_run():
    model = ProGen(CFG, make_policy(False), device="cpu")
    with pytest.raises(ValueError, match="batched"):
        model(torch.zeros(CFG.seq_len, dtype=torch.long))
    with pytest.raises(ValueError, match="seq_len"):
        model(torch.zeros(1, CFG.seq_len + CFG.window_size, dtype=torch.long))
