"""The port's training path (``progen_tpu_torch.train``) against the JAX
package's, on the same numpy-seeded inputs and parameters: the loss, the
optimizer against optax (clip firing and not, accumulation 1 and 3), the
schedules, three whole train steps of a small gMLP config through
``make_train_functions`` (loss, grad_norm and lr per step, the first
step's gradients and every parameter after by flax name) and
``eval_step``.  f32 is held at 1e-5 per op and 1e-4 for
the whole step (accumulation order over depth, and Adam's first steps
turn each gradient into about +-lr); bf16 at 0.05."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.observe.flops import model_flops_per_token as jax_flops
from progen_tpu.train import loss as jax_loss
from progen_tpu.train import make_optimizer as jax_make_optimizer
from progen_tpu.train import make_train_functions as jax_make_train_functions
from progen_tpu.train.schedule import make_lr_schedule as jax_make_lr_schedule
from progen_tpu_torch.compat.convert import grads_to_flax, params_from_flax, params_to_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe.flops import model_flops_per_token
from progen_tpu_torch.train.loss import batch_loss, cross_entropy, eos_from_pad_mask
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.schedule import lr_at, make_lr_schedule
from progen_tpu_torch.train.step import make_train_functions

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
STEP_F32 = dict(rtol=1e-4, atol=1e-4)
STEP_BF16 = dict(rtol=0.05, atol=0.05)
UPDATE_BF16 = 0.15
# num_tokens 256: the synthetic rows are bytes
CFG = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=8,
                   global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


# -- loss ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_matches_jax(dtype):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 12, 32)).astype(np.float32)
    targets = rng.integers(1, 32, size=(4, 12))
    targets[0, 7:] = 0   # a pad tail: the first pad is the EOS target
    targets[1, 3] = 0    # an interior zero
    targets[2, :] = 0    # an all-pad row keeps one position
    t_logits = torch.from_numpy(logits).to(dtype)
    j_logits = jnp.asarray(logits, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    t_targets, j_targets = torch.from_numpy(targets), jnp.asarray(targets)
    np.testing.assert_array_equal(eos_from_pad_mask(t_targets).numpy(),
                                  np.asarray(jax_loss.eos_from_pad_mask(j_targets)))
    np.testing.assert_allclose(cross_entropy(t_logits, t_targets).numpy(),
                               np.asarray(jax_loss.cross_entropy(j_logits, j_targets)),
                               **F32)
    np.testing.assert_allclose(float(batch_loss(t_logits, t_targets)),
                               float(jax_loss.batch_loss(j_logits, j_targets)), **F32)


# -- optimizer ----------------------------------------------------------------

SHAPES = {"w": (6, 5), "b": (5,), "col": (4, 1), "scale": (3,)}


@pytest.mark.parametrize("accum", [1, 3])
@pytest.mark.parametrize("grad_scale", [10.0, 1e-3])  # the clip fires / not
def test_optimizer_matches_optax(accum, grad_scale):
    rng = np.random.default_rng(accum)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (grad_scale * rng.normal(size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(4 * accum)]
    schedule = jax_make_lr_schedule("cosine", 1e-2, warmup_steps=1, decay_steps=4)
    tx = jax_make_optimizer(learning_rate=schedule, grad_accum_every=accum)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    j_update = jax.jit(lambda g, st, p: (lambda u, st: (optax.apply_updates(p, u), st))(
        *tx.update(g, st, p)))
    opt = make_optimizer(make_lr_schedule("cosine", 1e-2, warmup_steps=1,
                                          decay_steps=4), grad_accum_every=accum)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = opt.init(t_params)
    norms = []
    for g in grads:
        j_params, j_state = j_update({k: jnp.asarray(v) for k, v in g.items()},
                                     j_state, j_params)
        t_state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             t_state, t_params)
        norms.append(float(optax.global_norm(g)))
        for k in SHAPES:
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]),
                                       **F32, err_msg=k)
    assert (min(norms) > 0.5) == (grad_scale > 1)  # which side of the clip
    adam = (j_state.inner_opt_state if accum > 1 else j_state)[1][0]
    assert t_state.count == int(adam.count) == 4


# -- schedules ----------------------------------------------------------------


@pytest.mark.parametrize("name,warmup,decay", [
    ("constant", 0, None), ("constant", 3, None), ("cosine", 3, 10),
    ("cosine", 0, 10), ("linear", 3, 10), ("linear", 0, 7)])
def test_schedules_match_jax(name, warmup, decay):
    got = make_lr_schedule(name, 2e-4, warmup_steps=warmup, decay_steps=decay,
                           min_lr_ratio=0.1)
    want = jax_make_lr_schedule(name, 2e-4, warmup_steps=warmup,
                                decay_steps=decay, min_lr_ratio=0.1)
    assert callable(got) == callable(want)
    for step in (0, 1, 2, 3, 4, 5, 7, 9, 10, 11, 20):
        want_lr = float(want(step)) if callable(want) else want
        assert lr_at(got, step) == pytest.approx(want_lr, rel=1e-6, abs=1e-12), step


def test_schedule_errors_match_jax():
    for kwargs in ({"name": "cosine"}, {"name": "linear", "warmup_steps": 5,
                                        "decay_steps": 5}, {"name": "step"}):
        with pytest.raises(ValueError):
            jax_make_lr_schedule(base_lr=1e-3, **kwargs)
        with pytest.raises(ValueError):
            make_lr_schedule(base_lr=1e-3, **kwargs)


# -- the whole train step -----------------------------------------------------


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [synthetic_uniref_batch(rng, 2, CFG.seq_len) for _ in range(3)]


def _jax_and_port(mixed, grad_accum_every=1):
    """JAX's and the port's train functions on the same initial parameters,
    cosine schedule with warmup; returns both and the port's model."""
    schedule = dict(name="cosine", base_lr=1e-3, warmup_steps=1, decay_steps=3)
    j_model = JaxProGen(config=CFG, policy=jax_policy(mixed))
    j_sched = jax_make_lr_schedule(**schedule)
    j_fns = jax_make_train_functions(
        j_model, jax_make_optimizer(learning_rate=j_sched,
                                    grad_accum_every=grad_accum_every),
        jnp.zeros((2, CFG.seq_len), jnp.int32), grad_accum_every=grad_accum_every,
        lr_schedule=j_sched)
    j_state = j_fns.init_state(jax.random.key(0))
    model = ProGen(CFG, make_policy(mixed), device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(j_state.params)))
    fns = make_train_functions(model, make_optimizer(
        make_lr_schedule(**schedule), grad_accum_every=grad_accum_every))
    return j_model, j_fns, j_state, model, fns


@pytest.mark.parametrize("mixed", [False, True])
def test_three_train_steps_match_jax(batches, mixed):
    """f32: every gradient leaf and parameter at 1e-4.  bf16: every gradient
    leaf at 0.05 of its own largest magnitude, and each parameter's update
    over the three steps at 0.05 of the JAX update's RMS (an update never
    applied reads 1.0 there)."""
    j_model, j_fns, j_state, model, fns = _jax_and_port(mixed)
    j_grads = jax.jit(jax.grad(lambda p: jax_loss.batch_loss(
        j_model.apply({"params": p}, batches[0][:, :-1]), batches[0][:, 1:])))(
            j_state.params)
    p0 = dict(_flat(jax.device_get(j_state.params)))
    state = fns.init_state()

    tol = STEP_BF16 if mixed else STEP_F32
    for i, batch in enumerate(batches):
        j_state, j_metrics = j_fns.train_step(j_state, jnp.asarray(batch))
        state, metrics = fns.train_step(state, torch.from_numpy(batch))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]),
                                       **tol, err_msg=f"step {i} {key}")
        if i == 0:
            want = dict(_flat(j_grads))
            for name, g in _flat(grads_to_flax(model)):
                np.testing.assert_allclose(
                    g, want[name], rtol=tol["rtol"],
                    atol=tol["atol"] * float(np.abs(want[name]).max()),
                    err_msg=f"grad {name}")
    assert state.step == 3 and state.opt_state.count == 3
    want = dict(_flat(jax.device_get(j_state.params)))
    got = dict(_flat(params_to_flax(model.state_dict())))
    assert got.keys() == want.keys()
    for name in want:
        if mixed:
            step = want[name] - p0[name]
            err = np.sqrt(np.mean((got[name] - p0[name] - step) ** 2))
            assert err <= UPDATE_BF16 * np.sqrt(np.mean(step ** 2)), name
        else:
            np.testing.assert_allclose(got[name], want[name], **tol, err_msg=name)


def test_accumulated_train_steps_match_jax(batches):
    """Accumulation over 2 micro-batches, f32: per micro-step loss,
    grad_norm and lr (the lr of the batch the micro-step belongs to), and
    every parameter after two effective batches."""
    _, j_fns, j_state, model, fns = _jax_and_port(False, grad_accum_every=2)
    state = fns.init_state()
    for i, batch in enumerate(batches + batches[:1]):
        j_state, j_metrics = j_fns.train_step(j_state, jnp.asarray(batch))
        state, metrics = fns.train_step(state, torch.from_numpy(batch))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]),
                                       **STEP_F32, err_msg=f"micro-step {i} {key}")
    assert state.step == 4 and state.opt_state.count == 2
    want = dict(_flat(jax.device_get(j_state.params)))
    got = dict(_flat(params_to_flax(model.state_dict())))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **STEP_F32, err_msg=name)


def test_eval_step_matches_jax(batches):
    j_model = JaxProGen(config=CFG, policy=jax_policy(False))
    j_fns = jax_make_train_functions(j_model, jax_make_optimizer(),
                                     jnp.zeros((2, CFG.seq_len), jnp.int32))
    j_state = j_fns.init_state(jax.random.key(1))
    model = ProGen(CFG, make_policy(False), device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(j_state.params)))
    fns = make_train_functions(model, make_optimizer())
    batch = np.concatenate([batches[0], np.zeros_like(batches[0][:1])])  # + a pad row
    got = fns.eval_step(fns.init_state(), torch.from_numpy(batch))
    want = j_fns.eval_step(j_state, jnp.asarray(batch))
    np.testing.assert_array_equal(got["real_rows"].numpy(),
                                  np.asarray(want["real_rows"]))
    assert got["real_rows"].tolist() == [True, True, False]
    np.testing.assert_allclose(got["per_row_loss"].numpy(),
                               np.asarray(want["per_row_loss"]), **STEP_F32)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **STEP_F32)


def test_flops_per_token_matches_jax():
    """The port runs the causal SGU kernels: JAX's ``sgu_impl="pallas"`` count."""
    for cfg in (CFG, CONFIGS["small"]):
        n = 123_456_789
        assert model_flops_per_token(cfg, n) == jax_flops(cfg, n, sgu_impl="pallas")


def test_synthetic_rows_match_the_bench():
    import bench

    for seed in (0, 1):
        np.testing.assert_array_equal(
            synthetic_uniref_batch(np.random.default_rng(seed), 3, 64),
            bench.synthetic_uniref_batch(np.random.default_rng(seed), 3, 64))
