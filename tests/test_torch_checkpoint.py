"""The port's checkpoint store (``checkpoint/store.py``): a bit-exact round
trip of the train state (params, both moments, the accumulator mid-batch,
the counts), the JAX store's semantics (an empty store, keep-N, duplicate
and overwritten steps, reset, params restored without the optimizer's
file, retried ``ckpt.save`` faults, a failed write raising ``RetryError``
and leaving no step), flax params through the store and back bit for bit
(held against the in-memory flax tree, never against orbax), and
``ProGenConfig.to_dict``/``from_dict``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models.configs import CONFIGS as JAX_CONFIGS
from progen_tpu.parallel import unbox
from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.compat.convert import params_from_flax, params_to_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.retry import RetryError, RetryPolicy
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.step import make_train_functions

torch.set_num_threads(1)

CFG = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=16,
                   global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)
FAST = RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.0)


def _trained(seed=0, accum=1, steps=1):
    """A state after ``steps`` micro-steps: moments (and the accumulator)
    hold real values."""
    model = ProGen(CFG, make_policy(False), device="cpu", seed=seed)
    fns = make_train_functions(model, make_optimizer(1e-3, grad_accum_every=accum))
    state = fns.init_state()
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        state, _ = fns.train_step(state, torch.from_numpy(
            synthetic_uniref_batch(rng, 2, CFG.seq_len)))
    return model, fns, state


def _save(store, state, step=None, **kw):
    return store.save(state.step if step is None else step, state,
                      next_seq_index=kw.pop("next_seq_index", 16),
                      model_config=CFG.to_dict(), run_id="abc", **kw)


def _tensors(state):
    opt = state.opt_state
    out = {f"params.{k}": v for k, v in state.params.items()}
    for field in ("mu", "nu", "acc_grads"):
        for k, v in (getattr(opt, field) or {}).items():
            out[f"{field}.{k}"] = v
    return out


@pytest.mark.parametrize("accum,steps", [(1, 2), (2, 3)], ids=["plain", "mid_accumulation"])
def test_save_restore_round_trip_is_bit_exact(tmp_path, accum, steps):
    _, _, state = _trained(accum=accum, steps=steps)
    store = CheckpointStore(str(tmp_path / "ck"))
    assert _save(store, state) is True
    assert store.latest_step() == steps and store.all_steps() == [steps]
    assert sorted(p.name for p in store.step_dir(steps).iterdir()) == [
        "meta.json", "opt_state.pt", "params.pt"]
    assert store.restore_meta() == {"next_seq_index": 16, "model_config": CFG.to_dict(),
                                    "run_id": "abc", "train_step": steps}

    _, fresh_fns, _ = _trained(seed=1, accum=accum, steps=0)
    fresh = fresh_fns.init_state()
    got = store.restore_state(fresh)
    assert got.step == steps
    assert got.opt_state.count == state.opt_state.count
    assert got.opt_state.mini_step == state.opt_state.mini_step == (steps % accum)
    want, have = _tensors(state), _tensors(got)
    assert want.keys() == have.keys()
    for name in want:
        assert torch.equal(have[name], want[name]), name
    # restored IN PLACE into the live model's parameters
    assert all(got.params[k] is fresh.params[k] for k in fresh.params)


def test_an_empty_store_returns_none(tmp_path):
    store = CheckpointStore(str(tmp_path / "nothing"))
    _, fns, _ = _trained(steps=0)
    assert store.latest_step() is None and store.all_steps() == []
    assert store.restore_meta() is None and store.restore_params() is None
    assert store.restore_state(fns.init_state()) is None


def test_keep_last_n_prunes(tmp_path):
    _, _, state = _trained()
    store = CheckpointStore(str(tmp_path / "ck"), keep_last_n=2)
    for step in (1, 2, 3, 4):
        assert _save(store, state, step=step)
    assert store.all_steps() == [3, 4]
    assert sorted(p.name for p in store.path.iterdir()) == ["3", "4"]


def test_duplicate_step_is_skipped_and_overwrite_replaces(tmp_path):
    _, _, state = _trained()
    store = CheckpointStore(str(tmp_path / "ck"))
    assert _save(store, state, next_seq_index=8)
    assert _save(store, state, next_seq_index=99) is False
    assert store.restore_meta()["next_seq_index"] == 8
    assert _save(store, state, next_seq_index=99, overwrite=True) is True
    assert store.restore_meta()["next_seq_index"] == 99
    assert sorted(p.name for p in store.path.iterdir()) == [str(state.step)]


def test_reset_wipes_the_store(tmp_path):
    _, _, state = _trained()
    store = CheckpointStore(str(tmp_path / "ck"))
    _save(store, state)
    store.reset()
    assert not store.path.exists() and store.latest_step() is None
    assert _save(store, state)  # usable again


def test_restore_params_opens_no_optimizer_file(tmp_path, monkeypatch):
    model, _, state = _trained()
    store = CheckpointStore(str(tmp_path / "ck"))
    _save(store, state)
    opened = []
    real_load = torch.load

    def spy(f, *a, **kw):
        opened.append(str(f))
        return real_load(f, *a, **kw)

    monkeypatch.setattr(torch, "load", spy)
    params = store.restore_params()
    assert [p.rsplit("/", 1)[-1] for p in opened] == ["params.pt"]
    assert params.keys() == model.state_dict().keys()
    assert all(torch.equal(params[k], v) for k, v in model.state_dict().items())


def test_an_injected_save_fault_is_retried(tmp_path):
    _, _, state = _trained()
    store = CheckpointStore(str(tmp_path / "ck"), retry_policy=FAST)
    faults.configure("ckpt.save:io_error:times=2;ckpt.restore:unavailable:times=1")
    try:
        assert _save(store, state)
        assert store.restore_meta()["train_step"] == state.step
    finally:
        faults.reset()


def test_a_failed_write_raises_retry_error_and_leaves_no_step(tmp_path, monkeypatch):
    _, _, state = _trained()
    store = CheckpointStore(str(tmp_path / "ck"), retry_policy=FAST)
    real_dump = json.dump

    def broken_disk(*a, **kw):
        raise OSError("EIO: input/output error")

    monkeypatch.setattr(json, "dump", broken_disk)
    with pytest.raises(RetryError):
        _save(store, state)
    monkeypatch.setattr(json, "dump", real_dump)
    assert store.all_steps() == [] and list(store.path.iterdir()) == []


def test_restore_refuses_another_shape(tmp_path):
    _, _, state = _trained()
    store = CheckpointStore(str(tmp_path / "ck"))
    _save(store, state)
    other = ProGen(ProGenConfig(**{**CFG.to_dict(), "dim": 48}), make_policy(False),
                   device="cpu")
    fns = make_train_functions(other, make_optimizer(1e-3))
    with pytest.raises(ValueError, match="stored shape"):
        store.restore_state(fns.init_state())
    acc_fns = _trained(accum=2, steps=0)[1]
    with pytest.raises(ValueError, match="grad_accum_every"):
        store.restore_state(acc_fns.init_state())


def test_gcs_paths_are_refused():
    with pytest.raises(ValueError, match="not ported"):
        CheckpointStore("gs://bucket/ckpts")


def test_flax_params_through_the_store_are_bit_exact(tmp_path):
    """flax tree -> ``params_from_flax`` -> the store -> ``restore_params``
    -> ``params_to_flax`` equals the in-memory flax tree bit for bit."""
    j_model = JaxProGen(config=JAX_CONFIGS["default"], policy=jax_policy(False))
    tree = jax.device_get(unbox(jax.jit(j_model.init)(
        jax.random.key(7), jnp.zeros((1, 512), jnp.int32)))["params"])
    model = ProGen(CONFIGS["default"], make_policy(False), device="cpu")
    model.load_state_dict(params_from_flax(tree))
    fns = make_train_functions(model, make_optimizer())
    store = CheckpointStore(str(tmp_path / "ck"))
    store.save(0, fns.init_state(), next_seq_index=0,
               model_config=CONFIGS["default"].to_dict())
    back = params_to_flax(store.restore_params())
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        got = flat_got[path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        assert np.array_equal(got.view(np.uint32), np.asarray(leaf).view(np.uint32)), path


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_to_dict_round_trips(name):
    cfg = CONFIGS[name]
    d = cfg.to_dict()
    assert d == JAX_CONFIGS[name].to_dict()
    assert ProGenConfig.from_dict(json.loads(json.dumps(d))) == cfg
