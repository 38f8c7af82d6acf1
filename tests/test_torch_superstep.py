"""The port's superstep (``train/step.py:train_multi_step``, the
``SuperbatchStager`` of ``data/prefetch.py`` and the Trainer's span loop)
against its own per-step path and the JAX package's, on the CPU, f32:

* JAX's ``test_fused_superstep_bit_exact`` grid, ``(accum, k)`` in
  ``(1, 1), (1, 8), (4, 1), (4, 8)``, two dispatches fed through a real
  stager: the port's ``train_multi_step`` equals its own sequential
  ``train_step`` calls bit for bit (losses, grad norms, lrs, parameters,
  both moments, the accumulator), and JAX's ``train_multi_step`` from the
  same flax parameters and micro-batches at the train step's bar (1e-4,
  ``tests/test_torch_train.py``);
* the optimizer reads its count only through the scalars tensor: count
  5's scalars fed to a state at count 0 give count 5's update, bit for bit
  (what a CUDA graph captured at one step would otherwise freeze);
* JAX's stager tests (``tests/test_superstep.py:116-197``) on the port's
  stager, and ``superstep_span`` against JAX's on a grid;
* JAX's ``test_lora_train_frozen_base_superstep_and_bank``
  (``tests/test_workloads.py:404``) on the port;
* the port's ``test_superstep_run_crosses_hooks_and_resumes_bit_exact``
  (``tests/test_trainer_e2e.py:261``) on the port's store.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.data.prefetch import SuperbatchStager as JaxStager
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.parallel import unbox
from progen_tpu.train import make_optimizer as jax_make_optimizer
from progen_tpu.train import make_train_functions as jax_make_train_functions
from progen_tpu.train.schedule import make_lr_schedule as jax_make_lr_schedule
from progen_tpu.train.step import TrainState as JaxTrainState
from progen_tpu.train.trainer import superstep_span as jax_superstep_span
from progen_tpu_torch.compat.convert import params_from_flax, params_to_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.prefetch import SuperbatchStager
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe.tracker import Tracker
from progen_tpu_torch.train.lora import (
    LoRAProGen,
    extract_adapters,
    init_from_base,
    lora_train_functions,
)
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.schedule import make_lr_schedule
from progen_tpu_torch.train.step import make_train_functions
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig, superstep_span
from progen_tpu_torch.workloads import bank_from_trained, validate_lora_bank

torch.set_num_threads(1)

KW = dict(num_tokens=32, dim=16, seq_len=16, depth=2, window_size=8,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
BATCH = 2
STEP_F32 = dict(rtol=1e-4, atol=1e-4)
# a warmup schedule: the lr moves every optimizer step
SCHEDULE = dict(name="constant", base_lr=1e-3, warmup_steps=32)


def _micros(n, seed=3):
    """n micro-batches shaped like the data pipeline's: (B, L+1) int
    tokens, BOS column, pad tails (``tests/test_superstep.py:_micros``)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, BATCH, CFG.seq_len + 1), np.int32)
    for i in range(n):
        for r in range(BATCH):
            ln = int(rng.integers(CFG.seq_len // 2, CFG.seq_len + 1))
            out[i, r, 1:1 + ln] = rng.integers(1, 25, ln)
    return out


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    sample = jnp.zeros((BATCH, CFG.seq_len), jnp.int32)
    return jax.device_get(unbox(jax.jit(model.init)(jax.random.key(0), sample))["params"])


def _port(flax_params, accum):
    model = ProGen(CFG, make_policy(False), device="cpu")
    model.load_state_dict(params_from_flax(flax_params))
    fns = make_train_functions(model, make_optimizer(
        make_lr_schedule(**SCHEDULE), grad_accum_every=accum))
    return model, fns


def _tensors(state) -> dict:
    """Every tensor of a port state, by kind and name, as numpy."""
    opt = state.opt_state
    out = {f"params.{k}": v for k, v in state.params.items()}
    for kind in ("mu", "nu", "acc_grads"):
        out.update({f"{kind}.{k}": v for k, v in (getattr(opt, kind) or {}).items()})
    return {k: v.detach().numpy().copy() for k, v in out.items()}


@pytest.mark.parametrize("accum,k", [(1, 1), (1, 8), (4, 1), (4, 8)])
def test_fused_superstep_bit_exact(flax_params, accum, k):
    """train_multi_step(K) == K * accum sequential train_step calls, bit for
    bit, through a real stager, two dispatches; and JAX's fused path at the
    train step's bar."""
    dispatches = 2
    micros = _micros(dispatches * k * accum)

    model, fns = _port(flax_params, accum)
    state = fns.init_state()
    seq_losses, seq_norms, seq_lrs = [], [], []
    for batch in micros:
        state, m = fns.train_step(state, torch.from_numpy(batch))
        seq_losses.append(float(m["loss"]))
        seq_norms.append(float(m["grad_norm"]))
        seq_lrs.append(float(m["lr"]))
    seq_state = _tensors(state)

    model, fns = _port(flax_params, accum)
    state = fns.init_state()
    stager = SuperbatchStager(iter(list(micros)), device="cpu", accum=accum, k_max=k)
    fused = []
    try:
        for _ in range(dispatches):
            state, m = fns.train_multi_step(state, stager.get(k))
            assert m["loss"].shape == (k, accum) and m["grad_norm"].shape == (k, accum)
            assert m["lr"].shape == (k,)
            fused.append({key: v.numpy() for key, v in m.items()})
    finally:
        stager.close()
    assert state.step == dispatches * k * accum
    assert state.opt_state.count == dispatches * k and state.opt_state.mini_step == 0
    np.testing.assert_array_equal(np.concatenate([f["loss"].ravel() for f in fused]),
                                  np.asarray(seq_losses, np.float32))
    np.testing.assert_array_equal(np.concatenate([f["grad_norm"].ravel() for f in fused]),
                                  np.asarray(seq_norms, np.float32))
    # one lr per OPTIMIZER step: the lr of its micro-steps
    np.testing.assert_array_equal(np.concatenate([f["lr"] for f in fused]),
                                  np.asarray(seq_lrs, np.float32).reshape(-1, accum)[:, -1])
    got = _tensors(state)
    assert got.keys() == seq_state.keys()
    for name, want in seq_state.items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)

    # JAX's train_multi_step from the same params and micro-batches
    schedule = jax_make_lr_schedule(**SCHEDULE)
    tx = jax_make_optimizer(learning_rate=schedule, grad_accum_every=accum)
    jfns = jax_make_train_functions(
        JaxProGen(config=JAX_CFG, policy=jax_policy(False)), tx,
        jnp.zeros((BATCH, CFG.seq_len), jnp.int32), grad_accum_every=accum,
        lr_schedule=schedule)
    params = jax.tree.map(jnp.asarray, flax_params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    sb = micros.reshape((dispatches, k, accum) + micros.shape[1:])
    for d in range(dispatches):
        jstate, jm = jfns.train_multi_step(jstate, jnp.asarray(sb[d]))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(fused[d][key], np.asarray(jm[key]), **STEP_F32,
                                       err_msg=f"dispatch {d} {key}")
    want = params_to_flax({k: v for k, v in model.state_dict().items()})
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(jstate.params))[0]:
        node = want
        for part in path:
            node = node[part.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **STEP_F32, err_msg=str(path))


@pytest.mark.parametrize("accum", [1, 3])
def test_the_update_reads_its_count_only_from_the_scalars(accum):
    """Scalars for count 5 fed to a state at count 0 give count 5's update:
    bias corrections and learning rate come from the tensor, not from the
    state's Python count (a captured graph would otherwise replay the
    count it was captured at)."""
    rng = np.random.default_rng(accum)
    shapes = {"w": (6, 5), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(accum)]
    opt = make_optimizer(make_lr_schedule("cosine", 1e-2, warmup_steps=2, decay_steps=9),
                         grad_accum_every=accum)
    results = []
    for count, scalars_at in ((5, None), (0, 5)):
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        state = opt.init(params)
        for t in state.mu.values():
            t.fill_(0.25)
        state.count = count
        scalars = None if scalars_at is None else torch.from_numpy(opt.scalars(scalars_at))
        for g in grads:
            state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state,
                               params, scalars)
        results.append({k: v.numpy() for k, v in params.items()})
    for k in shapes:
        np.testing.assert_array_equal(results[0][k], results[1][k])
        assert not np.array_equal(results[0][k], p0[k])
    lr, step, bc1, bc2 = opt.scalars(5)
    assert step == -lr and bc1 == np.float32(1) - np.float32(0.9) ** np.float32(6)


def test_a_superstep_must_start_on_a_step_boundary(flax_params):
    _, fns = _port(flax_params, 2)
    state, _ = fns.train_step(fns.init_state(), torch.from_numpy(_micros(1)[0]))
    with pytest.raises(ValueError, match="boundary"):
        fns.train_multi_step(state, torch.from_numpy(_micros(2)).reshape(1, 2, BATCH, -1))
    with pytest.raises(ValueError, match="superbatch"):
        fns.train_multi_step(fns.init_state(), torch.from_numpy(_micros(2)))


# -- the stager (tests/test_superstep.py:116-197 on the port) -------------------


def test_stager_stacks_in_stream_order_with_partial_final_span():
    micros = [np.full((2, 5), i, np.int32) for i in range(12)]
    stager = SuperbatchStager(iter(micros), lambda b: b, accum=2, k_max=3)
    try:
        sb = stager.get(3)
        assert sb.shape == (3, 2, 2, 5)
        np.testing.assert_array_equal(sb[0, 0], micros[0])
        np.testing.assert_array_equal(sb[2, 1], micros[5])
        partial = stager.get(2)
        assert partial.shape == (2, 2, 2, 5)
        np.testing.assert_array_equal(partial[0, 0], micros[6])
        np.testing.assert_array_equal(partial[1, 1], micros[9])
    finally:
        stager.close()


def test_stager_validates_construction_and_k():
    with pytest.raises(ValueError):
        SuperbatchStager(iter([]), lambda b: b, accum=0, k_max=1)
    with pytest.raises(ValueError):
        SuperbatchStager(iter([]), lambda b: b, accum=1, k_max=0)
    with pytest.raises(ValueError):
        SuperbatchStager(iter([]), lambda b: b, accum=1, k_max=1, device="cpu")
    stager = SuperbatchStager(iter([np.zeros((1, 2), np.int32)] * 4), lambda b: b,
                              accum=1, k_max=2)
    try:
        with pytest.raises(ValueError):
            stager.get(3)
        with pytest.raises(ValueError):
            stager.get(0)
    finally:
        stager.close()


def test_stager_exhaustion_raises_stopiteration():
    stager = SuperbatchStager(iter([np.zeros((1, 2), np.int32)] * 3), lambda b: b,
                              accum=2, k_max=2)
    try:
        stager.get(1)
        with pytest.raises(StopIteration):
            stager.get(1)  # one micro left, a full step needs accum=2
    finally:
        stager.close()


def test_stager_prefetch_depth_buffers_ahead_boundedly():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield np.full((1, 2), i, np.int32)

    stager = SuperbatchStager(gen(), lambda b: b, accum=1, k_max=2, depth=2)
    try:
        stager.get(2)
        deadline = time.time() + 5.0
        # depth * k_max * accum = 4 buffered ahead (+1 in worker flight)
        while len(produced) < 6 and time.time() < deadline:
            time.sleep(0.01)
        assert len(produced) >= 6
        time.sleep(0.1)
        assert len(produced) <= 2 + 4 + 1
    finally:
        stager.close()


@pytest.mark.parametrize("device", [None, "cpu"])
def test_stager_returns_fresh_buffers_each_get(device):
    """Each get() stacks into a NEW buffer (the JAX stager's donation
    contract); with a device it is a tensor there, equal to JAX's stack."""
    micros = [np.full((1, 2), i, np.int32) for i in range(8)]
    kw = {"device": device} if device else {"to_device": lambda b: b}
    stager = SuperbatchStager(iter(micros), accum=1, k_max=2, **kw)
    jax_stager = JaxStager(iter(micros), np.asarray, accum=1, k_max=2)
    try:
        a, b = stager.get(2), stager.get(2)
        assert a is not b
        a, b = np.asarray(a), np.asarray(b)
        assert not np.shares_memory(a, b)
        np.testing.assert_array_equal(np.concatenate([a, b]),
                                      np.concatenate([jax_stager.get(2), jax_stager.get(2)]))
    finally:
        stager.close()
        jax_stager.close()


# -- the span (trainer.superstep_span) ---------------------------------------


@pytest.mark.parametrize("k_max", [1, 2, 8])
@pytest.mark.parametrize("cadences", [(3, 7, 10, 25), (1,), (0, 100), (4, 4, 6, 1000)])
def test_superstep_span_is_jaxs(k_max, cadences):
    for gs in range(0, 120):
        for remaining in (0, 1, 3, 50):
            assert (superstep_span(gs, k_max, cadences, remaining)
                    == jax_superstep_span(gs, k_max, cadences, remaining))


def test_superstep_span_never_skips_or_doubles_hooks():
    cadences = (3, 7, 10, 25)
    gs, fired = 0, []
    while gs < 200:
        span = superstep_span(gs, 8, cadences, 200 - gs)
        assert 1 <= span <= 8
        for every in cadences:
            assert gs + span <= (gs // every + 1) * every, "span crossed a boundary"
        gs += span
        fired += [(gs, every) for every in cadences if gs % every == 0]
    assert fired == [(s, e) for s in range(1, 201) for e in cadences if s % e == 0]


# -- LoRA (tests/test_workloads.py:404 on the port) ---------------------------


def test_lora_train_frozen_base_superstep_and_bank():
    """Adapters train through the unmodified train path: step 0 is the base
    model bit for bit, the base never moves, the superstep equals the
    sequential steps bit for bit, and the trained factors make a serving
    bank that reproduces the training forward."""
    lora_cfg = ProGenConfig(num_tokens=32, dim=16, depth=2, seq_len=64, window_size=8,
                            heads=2, dim_head=8, ff_mult=2)
    rank = 2
    base = ProGen(lora_cfg, make_policy(False), device="cpu", seed=9)
    rng = np.random.default_rng(0)
    K, accum = 2, 2
    superbatch = torch.from_numpy(
        rng.integers(1, lora_cfg.num_tokens, size=(K, accum, 2, lora_cfg.seq_len + 1)))

    def fresh():
        model = LoRAProGen(lora_cfg, rank, make_policy(False), device="cpu")
        fns = lora_train_functions(model, learning_rate=1e-2, grad_accum_every=accum)
        state = fns.init_state()
        init_from_base(state.params, base.state_dict())
        return model, fns, state

    model, fns, state = fresh()
    sample = superbatch[0, 0, :, :-1]
    with torch.no_grad():
        assert torch.equal(model(sample), base(sample))
    frozen = {k: p.detach().clone() for k, p in state.params.items() if k.startswith("base.")}
    state, metrics = fns.train_multi_step(state, superbatch)
    assert metrics["loss"].shape == (K, accum)
    assert torch.isfinite(metrics["loss"]).all()
    for k, p in frozen.items():
        assert torch.equal(state.params[k], p), k
    trained = extract_adapters(state.params, lora_cfg)
    assert any(site["b"].abs().max() > 0 for layer in trained.values()
               for site in layer.values())

    _, fns2, state2 = fresh()
    for kk in range(K):
        for aa in range(accum):
            state2, _ = fns2.train_step(state2, superbatch[kk, aa])
    for k in state.params:
        assert torch.equal(state.params[k], state2.params[k]), k

    bank = bank_from_trained(lora_cfg, rank, [trained])
    assert validate_lora_bank(lora_cfg, bank) == 2
    tokens = torch.from_numpy(rng.integers(1, lora_cfg.num_tokens, size=(2, 16)))
    with torch.no_grad():
        serve = base(tokens, adapters=bank, tenant=torch.ones(2, dtype=torch.long))
        train = model(tokens)
    np.testing.assert_allclose(serve.numpy(), train.numpy(), rtol=0, atol=1e-6)


# -- the Trainer (tests/test_trainer_e2e.py:261 on the port) -------------------


TRAINER_CFG = ProGenConfig(num_tokens=256, dim=16, seq_len=16, depth=2, window_size=8,
                           global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 14), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 48, "train"), [mk() for _ in range(48)])
    write_tfrecord(d / shard_filename(0, 8, "valid"), [mk() for _ in range(8)])
    return d


def _flex_trainer(data_dir, ckpt_dir, max_steps, runs, **kw):
    base = dict(batch_size=2, grad_accum_every=2, epochs=50, learning_rate=1e-3,
                validate_every=1000, sample_every=1000, checkpoint_every=1000,
                prime_length=4, mixed_precision=False, log_every=1, max_steps=max_steps)
    base.update(kw)
    return Trainer(TRAINER_CFG, TrainerConfig(**base), str(data_dir), str(ckpt_dir),
                   tracker=Tracker(out_dir=str(runs)), device="cpu")


def test_superstep_run_crosses_hooks_and_resumes_bit_exact(data_dir, tmp_path):
    """``superstep=2`` through validate (3, 6) and checkpoint (4)
    boundaries: full spans of 2 at 0 -> 2 and 4 -> 6, spans of 1 at
    2 -> 3 -> 4, a stop at the step-4 checkpoint and a resume, which lands
    on the unfused loop's cursor and its parameters bit for bit; every hook
    and log at the per-step loop's steps."""
    cadences = dict(validate_every=3, checkpoint_every=4, log_every=2, sample_every=1000)
    ref = _flex_trainer(data_dir, tmp_path / "ck_ref", 6, tmp_path / "runs_ref",
                        superstep=1, **cadences)
    out_ref = ref.run()
    ref.close()
    assert out_ref["step"] == 6

    t1 = _flex_trainer(data_dir, tmp_path / "ck_fused", 4, tmp_path / "runs_1",
                       superstep=2, **cadences)
    spans = []
    real = t1.fns.train_multi_step

    def counted(state, superbatch):
        spans.append(superbatch.shape[0])
        return real(state, superbatch)

    t1.fns = dataclasses.replace(t1.fns, train_multi_step=counted)
    assert t1.run()["step"] == 4
    t1.close()
    assert spans == [2, 1, 1]

    t2 = _flex_trainer(data_dir, tmp_path / "ck_fused", 6, tmp_path / "runs_2",
                       superstep=2, **cadences)
    state, start_seq, _ = t2.restore_or_init()
    assert state.step == 4 * 2 and start_seq == 4 * 4
    out2 = t2.run()
    t2.close()
    assert out2["step"] == 6
    for k, v in out_ref["state"].params.items():
        assert torch.equal(v, out2["state"].params[k]), k

    def rows(runs):
        return [r for f in sorted(runs.glob("*/metrics.jsonl"))
                for r in map(json.loads, f.read_text().splitlines())]
    ref_rows = rows(tmp_path / "runs_ref")
    fused_rows = rows(tmp_path / "runs_1") + rows(tmp_path / "runs_2")
    assert ({r["step"]: r["loss"] for r in fused_rows if "loss" in r}
            == {r["step"]: r["loss"] for r in ref_rows if "loss" in r})
    # validation at the per-step loop's steps; before the stop on its batch
    # (a resumed run reads the valid split from its start again)
    want = {r["step"]: r["valid_loss"] for r in ref_rows if "valid_loss" in r}
    got = {r["step"]: r["valid_loss"] for r in fused_rows if "valid_loss" in r}
    assert sorted(got) == sorted(want) == [3, 6] and got[3] == want[3]


# -- the superstep under a mesh (tests/test_multihost.py:215 on the port) ------

MESH_CADENCES = ("--log_every", "2", "--checkpoint_every", "3", "--validate_every", "3",
                 "--sample_every", "1000")
MESHES = {"dp": ("-1,1,1,1", "dp"), "fsdp_tp": ("1,1,2,1", "fsdp,tp")}
BATCH_SHARDS = {"dp": 2, "fsdp_tp": 1}  # the rows of a step: 2 a shard


def _two_ranks(tmp, data_dir, name, mesh, strategies, max_steps, superstep, ckpt=None):
    """Two gloo ranks of the train CLI (``RANK``/``WORLD_SIZE``, a
    ``file://`` store); returns the started processes."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    models = tmp / "models"
    models.mkdir(exist_ok=True)
    (models / "default.toml").write_text("".join(
        f"{k} = {json.dumps(v)}\n" for k, v in TRAINER_CFG.to_dict().items()))
    args = [sys.executable, "-m", "progen_tpu_torch.train", "--data_path", str(data_dir),
            "--checkpoint_path", str(tmp / f"ck_{ckpt or name}"), "--config_path", str(models),
            "--runs_dir", str(tmp / f"runs_{name}"), "--batch_size", "2",
            "--grad_accum_every", "1", "--learning_rate", "1e-3", *MESH_CADENCES,
            "--prime_length", "4", "--max_steps", str(max_steps), "--mesh", mesh,
            "--strategies", strategies, "--superstep", str(superstep),
            "--init_method", f"file://{tmp / f'store_{name}'}", "--device", "cpu"]
    return [subprocess.Popen(args, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
                                             "OMP_NUM_THREADS": "1"})
            for r in range(2)]


def _wait(procs) -> list[list[str]]:
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [o.splitlines() for o, _ in outs]


@pytest.fixture(scope="module")
def meshed_supersteps(data_dir, tmp_path_factory):
    """On a two-rank gloo world under ``dp`` and under ``fsdp,tp``: 4 steps
    per step; 4 steps at superstep 2; 3 steps at superstep 2 and a resume
    to 4.  Log 2, checkpoint and validation 3: spans 2, 1, 1."""
    tmp = tmp_path_factory.mktemp("meshed_superstep")
    runs = {}
    for label, (mesh, strategies) in MESHES.items():
        for name, steps, k in (("per_step", 4, 1), ("fused", 4, 2), ("split", 3, 2)):
            runs[label, name] = _two_ranks(tmp, data_dir, f"{label}_{name}", mesh, strategies,
                                           steps, k)
    out = {key: _wait(procs) for key, procs in runs.items()}
    for label, (mesh, strategies) in MESHES.items():
        out[label, "resumed"] = _wait(_two_ranks(tmp, data_dir, f"{label}_resumed", mesh,
                                                 strategies, 4, 2, ckpt=f"{label}_split"))
    return tmp, out


def _records(lines) -> list[dict]:
    return [json.loads(line) for line in lines if line.startswith("{")]


@pytest.mark.parametrize("label", list(MESHES))
def test_meshed_superstep_equals_per_step_bit_for_bit(meshed_supersteps, label):
    """``superstep=2`` on the mesh takes the per-step meshed run's steps:
    every logged loss and grad norm and the validation equal, and the
    gathered checkpoints at steps 3 and 4 (params and both moments) equal
    bit for bit; the route is the body in a loop (gloo)."""
    from progen_tpu_torch.checkpoint.store import CheckpointStore

    tmp, out = meshed_supersteps
    per, fused = _records(out[label, "per_step"][0]), _records(out[label, "fused"][0])
    pick = lambda rs, key: {r["step"]: (r[key], r.get("grad_norm")) for r in rs if key in r}
    assert pick(fused, "loss") == pick(per, "loss") and sorted(pick(per, "loss")) == [2, 4]
    assert pick(fused, "valid_loss") == pick(per, "valid_loss")
    assert sorted(pick(per, "valid_loss")) == [3]
    assert fused[0]["superstep_route"] == "loop" and per[0]["superstep_route"] is None
    assert out[label, "per_step"][1] == out[label, "fused"][1] == []  # rank 1 prints nothing
    for step in (3, 4):
        a = CheckpointStore(str(tmp / f"ck_{label}_per_step")).step_dir(step)
        b = CheckpointStore(str(tmp / f"ck_{label}_fused")).step_dir(step)
        for f in ("params.pt", "opt_state.pt"):
            want, got = (torch.load(d / f, weights_only=True) for d in (a, b))
            if f == "opt_state.pt":
                assert (got["count"], got["mini_step"]) == (want["count"], want["mini_step"])
                want, got = ({**want["mu"], **{f"nu.{k}": v for k, v in want["nu"].items()}},
                             {**got["mu"], **{f"nu.{k}": v for k, v in got["nu"].items()}})
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), (label, step, f, k)


@pytest.mark.parametrize("label", list(MESHES))
def test_meshed_superstep_resumes_bit_for_bit(meshed_supersteps, label):
    """Stopped at the step-3 checkpoint and resumed on the mesh, the
    superstep lands on the per-step run's step-4 state bit for bit."""
    from progen_tpu_torch.checkpoint.store import CheckpointStore

    tmp, out = meshed_supersteps
    resumed = _records(out[label, "resumed"][0])
    assert resumed[0]["start_seq_index"] == 3 * 2 * BATCH_SHARDS[label]
    assert [r["step"] for r in resumed if "loss" in r] == [4]
    a = CheckpointStore(str(tmp / f"ck_{label}_per_step")).step_dir(4)
    b = CheckpointStore(str(tmp / f"ck_{label}_split")).step_dir(4)
    want, got = (torch.load(d / "params.pt", weights_only=True) for d in (a, b))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (label, k)
