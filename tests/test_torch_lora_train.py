"""Frozen-base LoRA training in the port (``train/lora.py``) against the JAX
package's per-step ``train_step`` (the fused ``train_multi_step`` is not
ported), on the CPU in f32 with the JAX parameters carried across
(``compat/convert.py:lora_params_from_flax``), on tests/test_workloads.py's
config: step 0 is the base model bit for bit; four steps, accumulating 1
and 2, give JAX's losses, grad norms (over the whole tree, the frozen base
included) and adapters at 1e-5; the base is bit-unchanged; the trained
factors, through ``extract_adapters`` and ``bank_from_trained``, make the
engine's tenant 1 reproduce the training forward; the adapter optimizer
equals optax's ``multi_transform(adamw, set_to_zero)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.parallel import unbox
from progen_tpu.train import lora as jax_lora_train
from progen_tpu_torch.compat.convert import lora_params_from_flax, params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.prefill import make_prefiller
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.train.lora import (
    ADAPTER_LABEL,
    FROZEN_LABEL,
    LoRAProGen,
    extract_adapters,
    init_from_base,
    lora_param_labels,
    lora_train_functions,
    make_lora_optimizer,
)
from progen_tpu_torch.workloads import bank_from_trained, validate_lora_bank

torch.set_num_threads(1)

KW = dict(num_tokens=32, dim=16, depth=2, seq_len=64, window_size=8, heads=2,
          dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
RANK = 2
LR = 1e-2
STEPS = 4
F32 = dict(rtol=1e-5, atol=1e-5)


def _batches(n, b=2):
    rng = np.random.default_rng(0)
    return rng.integers(1, CFG.num_tokens, size=(n, b, CFG.seq_len + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_base_params():
    sample = jnp.zeros((2, CFG.seq_len), jnp.int32)
    base = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    return jax.device_get(unbox(jax.jit(base.init)(jax.random.key(9), sample))["params"])


def _jax_run(base_params, accum):
    """JAX: the LoRA wrapper's init, the pretrained base dropped in, then
    STEPS per-step train steps; (initial params, final params, metrics)."""
    jmodel = jax_lora_train.LoRAProGen(config=JAX_CFG, rank=RANK, policy=jax_policy(False))
    sample = jnp.zeros((2, CFG.seq_len), jnp.int32)
    fns = jax_lora_train.lora_train_functions(jmodel, sample, learning_rate=LR,
                                              grad_accum_every=accum)
    state = fns.init_state(jax.random.key(0))
    state = state.replace(params=jax_lora_train.init_from_base(state.params, base_params))
    initial = jax.device_get(state.params)
    metrics = []
    for batch in _batches(STEPS):
        state, m = fns.train_step(state, jnp.asarray(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return initial, jax.device_get(state.params), metrics


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def runs(request, jax_base_params):
    accum = request.param
    initial, final, jmetrics = _jax_run(jax_base_params, accum)
    model = LoRAProGen(CFG, RANK, make_policy(False), device="cpu")
    model.load_state_dict(lora_params_from_flax(initial))
    fns = lora_train_functions(model, learning_rate=LR, grad_accum_every=accum)
    state = fns.init_state()
    base_before = {k: p.detach().clone() for k, p in state.params.items()
                   if k.startswith("base.")}
    metrics = []
    for batch in _batches(STEPS):
        state, m = fns.train_step(state, torch.from_numpy(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(accum=accum, model=model, state=state, metrics=metrics,
                jmetrics=jmetrics, jfinal=final, base_before=base_before)


def test_step_zero_is_the_base_model_bit_for_bit(jax_base_params):
    model = LoRAProGen(CFG, RANK, make_policy(False), device="cpu", seed=3)
    base = ProGen(CFG, make_policy(False), device="cpu")
    base.load_state_dict(params_from_flax(jax_base_params))
    init_from_base(dict(model.named_parameters()), base.state_dict())
    tokens = torch.from_numpy(_batches(1)[0, :, :-1]).long()
    with torch.no_grad():
        got, want = model(tokens), base(tokens)
    assert torch.equal(got, want)
    jwant = JaxProGen(config=JAX_CFG, policy=jax_policy(False)).apply(
        {"params": jax_base_params}, jnp.asarray(tokens.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-4, atol=1e-4)
    # b starts at zero, a lecun-normal (truncated at two std)
    a, b = model.attn0_qkv_a, model.attn0_qkv_b
    assert not b.any() and a.abs().max() <= 2 * (CFG.dim ** -0.5) / 0.8796 + 1e-6
    assert tuple(a.shape) == (CFG.dim, RANK) and tuple(b.shape) == (RANK, 3 * 16)


def test_losses_and_grad_norms_are_jaxs(runs):
    """Per step: the loss, and grad_norm over the WHOLE tree (base included:
    its gradients are computed and thrown away, as in JAX)."""
    for got, want in zip(runs["metrics"], runs["jmetrics"]):
        np.testing.assert_allclose(got["loss"], want["loss"], **F32)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **F32)
        np.testing.assert_allclose(got["lr"], want["lr"], **F32)
    adapters_only = float(torch.sqrt(sum(
        (p.grad.float() ** 2).sum() for k, p in runs["state"].params.items()
        if not k.startswith("base."))))
    assert runs["metrics"][-1]["grad_norm"] > adapters_only * (1 + 1e-3)


def test_adapters_are_jaxs_and_the_base_is_bit_unchanged(runs):
    state, jfinal = runs["state"], runs["jfinal"]
    for k, p in state.params.items():
        if k.startswith("base."):
            assert torch.equal(p, runs["base_before"][k]), k
        else:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jfinal[k]), **F32)
    assert not torch.equal(runs["model"].ff1_sgu_b, torch.zeros_like(runs["model"].ff1_sgu_b))
    # only the adapters hold optimizer state
    assert set(state.opt_state.mu) == {k for k in state.params if not k.startswith("base.")}
    assert state.opt_state.count == STEPS // runs["accum"]


def test_trained_adapters_serve_as_tenant_one(runs):
    """extract_adapters -> bank_from_trained -> the base with the bank as
    tenant 1 (the prefill the engine's admission runs) reproduces the
    training forward; the engine's greedy first token is its argmax."""
    model, state = runs["model"], runs["state"]
    trained = extract_adapters(state.params, CFG)
    assert trained["ff1"]["sgu"]["a"].dtype == torch.float32
    bank = bank_from_trained(CFG, RANK, [trained])
    assert validate_lora_bank(CFG, bank) == 2
    base = ProGen(CFG, make_policy(False), device="cpu")
    base.load_state_dict({k[len("base."):]: v for k, v in model.state_dict().items()
                          if k.startswith("base.")})
    base.eval()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(1, CFG.num_tokens, (2, 16)))
    with torch.no_grad():
        train_logits = model(tokens)
    lengths = torch.tensor([16, 11])
    last, _ = make_prefiller(base)(tokens, lengths, 32, adapters=bank,
                                   tenant=torch.ones(2, dtype=torch.long))
    want = train_logits[torch.arange(2), lengths - 1]
    np.testing.assert_allclose(last.numpy(), want.numpy(), rtol=0, atol=1e-6)
    eng = ServingEngine(base, num_slots=2, max_len=32, chunk_size=4, lora_bank=bank)
    for i in range(2):
        eng.submit(Request(uid=i, tokens=tokens[i, : lengths[i]].tolist(), max_new_tokens=1,
                           temperature=0.0, tenant=1))
    first = {c.uid: int(c.tokens[0]) for c in eng.run_until_idle(max_chunks=10)}
    assert first == {i: int(want[i].argmax()) for i in range(2)}


def test_the_adapter_optimizer_is_optaxs_multi_transform():
    """Three updates of a toy tree with weight decay on: the adapters move
    as optax's adamw (no clip, every factor decayed) and the base never."""
    rng = np.random.default_rng(2)
    shapes = {"w": (4, 3), "v": (3,)}
    jparams = {"base": {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()},
               "l_a": rng.normal(size=(4, 2)).astype(np.float32),
               "l_b": rng.normal(size=(2, 3)).astype(np.float32)}
    tx = jax_lora_train.make_lora_optimizer(0.1, weight_decay=0.05)
    jstate = tx.init(jparams)
    params = {"base.w": torch.from_numpy(jparams["base"]["w"].copy()),
              "base.v": torch.from_numpy(jparams["base"]["v"].copy()),
              "l_a": torch.from_numpy(jparams["l_a"].copy()),
              "l_b": torch.from_numpy(jparams["l_b"].copy())}
    assert lora_param_labels(params) == {"base.w": FROZEN_LABEL, "base.v": FROZEN_LABEL,
                                         "l_a": ADAPTER_LABEL, "l_b": ADAPTER_LABEL}
    opt = make_lora_optimizer(0.1, weight_decay=0.05)
    state = opt.init(params)
    base_before = {k: v.clone() for k, v in params.items() if k.startswith("base.")}
    for _ in range(3):
        # large gradients: a clip at 0.5 would fire
        jgrads = jax.tree.map(lambda p: 10 * rng.normal(size=p.shape).astype(np.float32),
                              jparams)
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = jax.device_get(jax.tree.map(lambda p, u: p + u, jparams, updates))
        grads = {"base.w": torch.from_numpy(jgrads["base"]["w"]),
                 "base.v": torch.from_numpy(jgrads["base"]["v"]),
                 "l_a": torch.from_numpy(jgrads["l_a"]), "l_b": torch.from_numpy(jgrads["l_b"])}
        state = opt.update(grads, state, params)
    for k in ("l_a", "l_b"):
        np.testing.assert_allclose(params[k].numpy(), jparams[k], **F32)
    for k, v in base_before.items():
        assert torch.equal(params[k], v)
        np.testing.assert_array_equal(v.numpy(), jparams["base"][k[5:]])


def test_init_from_base_and_the_converter_refuse_mismatches():
    model = LoRAProGen(CFG, RANK, make_policy(False), device="cpu")
    params = dict(model.named_parameters())
    base = ProGen(CFG, make_policy(False), device="cpu", seed=5).state_dict()
    init_from_base(params, base)
    assert torch.equal(model.base.embed.weight, base["embed.weight"])
    with pytest.raises(ValueError, match="not LoRAProGen"):
        init_from_base({"attn0_qkv_a": params["attn0_qkv_a"]}, base)
    with pytest.raises(ValueError, match="missing"):
        init_from_base(params, {k: v for k, v in base.items() if k != "embed.weight"})
    # every factor of the JAX wrapper lands on the port's, by name
    jmodel = jax_lora_train.LoRAProGen(config=JAX_CFG, rank=RANK, policy=jax_policy(False))
    jparams = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(1), jnp.zeros((1, CFG.seq_len), jnp.int32)))
    state = lora_params_from_flax(unbox(jparams))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    np.testing.assert_array_equal(model.ff0_sgu_a.detach().numpy(),
                                  np.asarray(unbox(jparams)["params"]["ff0_sgu_a"]))
