"""Remat on the port (``ProGen(remat=True, remat_policy=...)``,
``models/progen.py``) against the port without remat and the JAX package's
remat model, on the CPU, f32:

* for each of ``full``, ``dots`` and ``attn`` the loss and every gradient
  leaf equal the port's without remat bit for bit (the recomputation runs
  the same ops on the same inputs), and JAX's remat model's at the
  whole-model f32 bar of 1e-4;
* what each policy keeps: ``dots`` replays no matrix product in the
  backward, ``full`` replays them; K1-fwd runs twice a layer under
  ``full`` and ``dots`` and once under ``attn`` (its ``lse`` kept), K2-fwd
  once more per gMLP layer under every policy;
* an unknown policy raises ``ValueError`` naming ``remat_policy``
  (``tests/test_model.py:150``); the Trainer with ``remat`` takes the
  steps of the Trainer without it, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.parallel import unbox
from progen_tpu.train import loss as jax_loss
from progen_tpu_torch.compat.convert import grads_to_flax, params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.train.loss import batch_loss
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

KW = dict(num_tokens=32, dim=16, seq_len=16, depth=3, window_size=8,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
POLICIES = ("full", "dots", "attn")
MODEL_F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, CFG.num_tokens, (2, CFG.seq_len + 1))
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    params = jax.device_get(unbox(jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, CFG.seq_len), jnp.int32)))["params"])
    return tokens, params


def _port(params, tokens, **kw):
    """Loss and gradients (flax layout) of the port's model."""
    model = ProGen(CFG, make_policy(False), device="cpu", **kw)
    model.load_state_dict(params_from_flax(params))
    t = torch.from_numpy(tokens)
    loss = batch_loss(model(t[:, :-1]), t[:, 1:])
    loss.backward()
    return float(loss.detach()), dict(_flat(grads_to_flax(model)))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_are_the_no_remat_grads_bit_for_bit(setup, policy):
    tokens, params = setup
    l0, g0 = _port(params, tokens)
    l1, g1 = _port(params, tokens, remat=True, remat_policy=policy)
    assert l1 == l0
    assert g1.keys() == g0.keys()
    for name in g0:
        np.testing.assert_array_equal(g1[name], g0[name], err_msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_match_jax_remat(setup, policy):
    tokens, params = setup
    jmodel = JaxProGen(config=JAX_CFG, policy=jax_policy(False), remat=True,
                       remat_policy=policy)

    def f(p):
        return jax_loss.batch_loss(jmodel.apply({"params": p}, tokens[:, :-1]), tokens[:, 1:])

    jl, jg = jax.jit(jax.value_and_grad(f))(params)
    loss, grads = _port(params, tokens, remat=True, remat_policy=policy)
    np.testing.assert_allclose(loss, float(jl), **MODEL_F32)
    want = dict(_flat(jax.device_get(jg)))
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], rtol=MODEL_F32["rtol"],
                                   atol=MODEL_F32["atol"] * float(np.abs(want[name]).max()),
                                   err_msg=name)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _backward_products(setup, **kw) -> int:
    tokens, params = setup
    model = ProGen(CFG, make_policy(False), device="cpu", **kw)
    t = torch.from_numpy(tokens)
    loss = batch_loss(model(t[:, :-1]), t[:, 1:])
    with _CountMM() as mode:
        loss.backward()
    return mode.mm


def test_dots_replays_no_product_and_full_replays_them(setup):
    none = _backward_products(setup)
    assert _backward_products(setup, remat=True, remat_policy="dots") == none
    assert _backward_products(setup, remat=True, remat_policy="full") > none


@pytest.mark.parametrize("policy,k1,k2", [(None, 1, 2), ("full", 2, 3), ("dots", 2, 3),
                                          ("attn", 1, 3)])
def test_forward_kernels_per_layer_under_each_policy(setup, monkeypatch, policy, k1, k2):
    """K1-fwd per layer (the recompute under full and dots; attn keeps the
    lse) and K2-fwd per gMLP layer (forward, d_res, and the recompute under
    every policy): the smoke's launch formula."""
    calls = {"k1": 0, "k2": 0}
    fwd1, fwd2 = cuda_attention.local_attention_fwd, cuda_sgu.spatial_gate_fwd

    def k1_fwd(*a, **kw):
        calls["k1"] += 1
        return fwd1(*a, **kw)

    def k2_fwd(*a, **kw):
        calls["k2"] += 1
        return fwd2(*a, **kw)

    monkeypatch.setattr(cuda_attention, "local_attention_fwd", k1_fwd)
    monkeypatch.setattr(cuda_sgu, "spatial_gate_fwd", k2_fwd)
    tokens, params = setup
    _port(params, tokens, **({} if policy is None else dict(remat=True, remat_policy=policy)))
    assert calls == {"k1": k1 * CFG.depth, "k2": k2 * CFG.global_mlp_depth}


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        ProGen(CFG, make_policy(False), device="cpu", remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        JaxProGen(config=JAX_CFG, policy=jax_policy(False), remat=True,
                  remat_policy="everything").init(jax.random.key(0),
                                                  jnp.zeros((1, CFG.seq_len), jnp.int32))


def test_no_remat_without_gradients(setup):
    """Under no_grad (eval, sampling) a remat model is the plain model."""
    tokens, params = setup
    out = []
    for kw in ({}, dict(remat=True, remat_policy="attn")):
        model = ProGen(CFG, make_policy(False), device="cpu", **kw)
        model.load_state_dict(params_from_flax(params))
        with torch.no_grad():
            out.append(model(torch.from_numpy(tokens[:, :-1])))
    assert torch.equal(out[0], out[1])


def test_the_trainer_with_remat_takes_the_same_steps(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    rng = np.random.default_rng(0)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 30), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 24, "train"), [mk() for _ in range(24)])
    write_tfrecord(d / shard_filename(0, 4, "valid"), [mk() for _ in range(4)])
    cfg = dataclasses.replace(CFG, num_tokens=256)
    finals = []
    for kw in ({}, dict(remat=True, remat_policy="dots")):
        t = Trainer(cfg, TrainerConfig(
            batch_size=2, grad_accum_every=2, learning_rate=1e-3, validate_every=1000,
            sample_every=1000, checkpoint_every=1000, mixed_precision=False, log_every=1,
            max_steps=3, **kw), str(d), str(tmp_path / f"ck{len(finals)}"), device="cpu")
        finals.append(t.run())
        t.close()
    assert finals[0]["loss"] == finals[1]["loss"]
    for k, v in finals[0]["state"].params.items():
        assert torch.equal(v, finals[1]["state"].params[k]), k
