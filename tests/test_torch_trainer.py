"""The port's ``Trainer`` (``train/trainer.py``) on the CPU, f32:

* (i) its per-step losses over ``train_data_synth/`` equal the JAX
  ``make_train_functions`` stepped over the JAX iterator's batches from the
  same parameters (converted from flax and saved into the port's store at
  step 0), within 1e-4 relative;
* (ii) N steps then a resumed M steps equal N+M steps bit for bit, at
  accumulation 1 and 2, unshuffled and shuffled, and across epochs of a
  3-step corpus with a shuffle (the un-wrapped cursor);
* (iii) a preemption flag or a SIGTERM saves, returns ``preempted`` and
  the run resumes to the uninterrupted parameters;
* (iv) ``run_attempts=2`` outlives a transient ``train.step`` fault;
* (v) a background save stores its step's values while later steps
  update the state in place, and a periodic save that finds it writing is
  skipped;
* (vi) a stored config that differs raises; (vii) the full validation
  loss is exact; fields not ported are refused by name; the sampler
  warm-up is gated;
* (viii) the train CLI checkpoints, resumes and wipes; (ix) the sample CLI
  samples the JAX sampler's tokens from a checkpoint;
* the watchdog trips, dumps and exits 42."""

import dataclasses
import json
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.core.rng import KeySeq as JaxKeySeq
from progen_tpu.data.tfrecord import iterator_from_tfrecords_folder as jax_iterator
from progen_tpu.decode import make_sampler as jax_make_sampler
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxProGenConfig
from progen_tpu.models.configs import DEFAULT as JAX_DEFAULT
from progen_tpu.parallel import unbox
from progen_tpu.train import make_optimizer as jax_make_optimizer
from progen_tpu.train import make_train_functions as jax_make_train_functions
from progen_tpu_torch import sample as sample_cli
from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.mesh import MeshConfig
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.data.tokenizer import decode_tokens, encode_tokens
from progen_tpu_torch.models.configs import DEFAULT
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe.tracker import Tracker
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.watchdog import WATCHDOG_EXIT_CODE, FlightRecorder, Watchdog
from progen_tpu_torch.train import trainer as trainer_mod
from progen_tpu_torch.train.loss import cross_entropy
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.step import make_train_functions
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SYNTH = str(ROOT / "train_data_synth")
CFG = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=16,
                   global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)
# the JAX package's default config at a short sequence (parity with JAX)
PARITY_CFG = dataclasses.replace(DEFAULT, seq_len=128, window_size=64)
PARITY_STEPS = 6


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 40), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 30, "train"), [mk() for _ in range(30)])
    write_tfrecord(d / shard_filename(1, 18, "train"), [mk() for _ in range(18)])
    write_tfrecord(d / shard_filename(0, 7, "valid"), [mk() for _ in range(7)])
    return d


def _trainer(data, ckpt, max_steps, runs=None, model_config=CFG, **kw):
    base = dict(batch_size=2, grad_accum_every=1, learning_rate=1e-3,
                validate_every=1000, sample_every=1000, checkpoint_every=1000,
                prime_length=4, mixed_precision=False, log_every=1,
                max_steps=max_steps)
    base.update(kw)
    tracker = Tracker(out_dir=str(runs)) if runs is not None else None
    return Trainer(model_config, TrainerConfig(**base), str(data), str(ckpt),
                   tracker=tracker, device="cpu")


def _losses(runs: Path) -> dict[int, float]:
    rows = [json.loads(line) for f in runs.glob("*/metrics.jsonl")
            for line in f.read_text().splitlines()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def _assert_same_params(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- (i) parity with JAX ----------------------------------------------------


def test_trainer_losses_match_jax_make_train_functions(tmp_path):
    jax_cfg = JaxProGenConfig(**PARITY_CFG.to_dict())
    j_model = JaxProGen(config=jax_cfg, policy=jax_policy(False))
    j_fns = jax_make_train_functions(
        j_model, jax_make_optimizer(learning_rate=1e-3),
        jnp.zeros((2, PARITY_CFG.seq_len), jnp.int32))
    j_state = j_fns.init_state(jax.random.key(0))

    # the flax params into the port's store at step 0, cursor 0
    model = ProGen(PARITY_CFG, make_policy(False), device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(j_state.params)))
    fns = make_train_functions(model, make_optimizer(1e-3))
    CheckpointStore(str(tmp_path / "ck")).save(
        0, fns.init_state(), next_seq_index=0, model_config=PARITY_CFG.to_dict())

    trainer = _trainer(SYNTH, tmp_path / "ck", PARITY_STEPS, runs=tmp_path / "runs",
                       model_config=PARITY_CFG)
    out = trainer.run()
    assert out["step"] == PARITY_STEPS and np.isfinite(out["valid_loss"])
    got = _losses(tmp_path / "runs")

    _, it_fn = jax_iterator(SYNTH, "train")
    batches = it_fn(seq_len=PARITY_CFG.seq_len, batch_size=2, loop=True)
    want = {}
    for step in range(1, PARITY_STEPS + 1):
        j_state, metrics = j_fns.train_step(j_state, jnp.asarray(next(batches)))
        want[step] = float(metrics["loss"])
    assert sorted(got) == sorted(want)
    for step in want:
        assert got[step] == pytest.approx(want[step], rel=1e-4), step


# -- (ii) resume is bit-exact ---------------------------------------------------


@pytest.mark.parametrize("accum,shuffle,n,m", [
    (1, 0, 3, 3), (2, 0, 2, 3), (2, 6, 3, 2),
], ids=["accum1", "accum2", "accum2_shuffled"])
def test_resume_equals_the_uninterrupted_run(data_dir, tmp_path, accum, shuffle, n, m):
    kw = dict(grad_accum_every=accum, shuffle_buffer=shuffle)
    base = _trainer(data_dir, tmp_path / "base", n + m, runs=tmp_path / "r_base", **kw).run()
    first = _trainer(data_dir, tmp_path / "ck", n, runs=tmp_path / "r_first", **kw)
    first.run()
    second = _trainer(data_dir, tmp_path / "ck", n + m, runs=tmp_path / "r_second", **kw)
    state, start_seq, _ = second.restore_or_init()
    assert state.step == n * accum and start_seq == n * 2 * accum
    out = second.run()
    assert out["step"] == n + m
    _assert_same_params(out["state"].params, base["state"].params)
    want = _losses(tmp_path / "r_base")
    got = _losses(tmp_path / "r_second")
    assert sorted(got) == list(range(n + 1, n + m + 1))
    assert all(got[s] == want[s] for s in got)


def test_multi_epoch_shuffled_resume_is_bit_exact(tmp_path):
    """12 records, 4 a step: 3 steps an epoch.  Interrupted at step 4 the
    cursor is 16 > 12: the resume must skip the un-wrapped cursor."""
    d = tmp_path / "corpus"
    d.mkdir()
    rng = np.random.default_rng(5)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 14), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 12, "train"), [mk() for _ in range(12)])
    write_tfrecord(d / shard_filename(0, 4, "valid"), [mk() for _ in range(4)])
    kw = dict(grad_accum_every=2, shuffle_buffer=8, seed=7)
    base = _trainer(d, tmp_path / "base", 8, **kw).run()
    _trainer(d, tmp_path / "ck", 4, **kw).run()
    second = _trainer(d, tmp_path / "ck", 8, **kw)
    state, start_seq, _ = second.restore_or_init()
    assert state.step == 4 * 2 and start_seq == 16
    out = second.run()
    assert out["step"] == 8
    _assert_same_params(out["state"].params, base["state"].params)


# -- (iii) preemption, (iv) a transient fault -------------------------------


def test_preemption_flag_saves_and_the_run_resumes(data_dir, tmp_path):
    t = _trainer(data_dir, tmp_path / "ck", 50, grad_accum_every=2)
    t._request_preempt_checkpoint()  # what the SIGTERM handler does
    out = t.run()
    assert out["preempted"] is True and out["step"] == 1
    assert t.store.all_steps() == [2]
    t2 = _trainer(data_dir, tmp_path / "ck", 2, grad_accum_every=2)
    state, start_seq, _ = t2.restore_or_init()
    assert state.step == 2 and start_seq == 4
    out2 = t2.run()
    assert out2["step"] == 2 and not out2.get("preempted")


def test_sigterm_preemption_resumes_to_the_uninterrupted_params(data_dir, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    try:
        base = _trainer(data_dir, tmp_path / "base", 5).run()
        faults.configure("train.step:preempt:at=3")
        try:
            out = _trainer(data_dir, tmp_path / "ck", 5).run()
        finally:
            faults.reset()
        assert out["preempted"] is True and out["step"] == 3
        resumed = _trainer(data_dir, tmp_path / "ck", 5).run()
    finally:
        signal.signal(signal.SIGTERM, before)
    assert resumed["step"] == 5
    _assert_same_params(resumed["state"].params, base["state"].params)


def test_run_attempts_outlive_a_transient_step_fault(data_dir, tmp_path):
    base = _trainer(data_dir, tmp_path / "base", 6).run()
    t = _trainer(data_dir, tmp_path / "ck", 6, checkpoint_every=2, run_attempts=2)
    faults.configure("train.step:io_error:at=5")
    try:
        out = t.run()
    finally:
        faults.reset()
    assert out["step"] == 6
    _assert_same_params(out["state"].params, base["state"].params)
    with pytest.raises(ConnectionResetError):
        faults.configure("train.step:io_error:at=2")
        try:
            _trainer(data_dir, tmp_path / "ck1", 6, run_attempts=1).run()
        finally:
            faults.reset()


# -- (v) background saves ---------------------------------------------------


def test_background_save_stores_its_steps_values(data_dir, tmp_path):
    """The step-2 save is held back until step 5 has run: it must still
    store step 2's values (a snapshot, not the live tensors), and the step-4
    save, which finds it writing, is skipped; the step-6 save, which finds
    nothing writing, runs in the background."""
    at_two = _trainer(data_dir, tmp_path / "two", 2).run()["state"].params
    t = _trainer(data_dir, tmp_path / "ck", 6, checkpoint_every=2)
    release = threading.Event()
    real_save, real_step = t.store.save, t.fns.train_step
    calls = []

    def held_save(step, snapshot, **kw):
        release.wait(timeout=60)
        return real_save(step, snapshot, **kw)

    def counted_step(state, batch):
        out = real_step(state, batch)
        calls.append(1)
        if len(calls) == 5:  # let the step-2 save finish before step 6's hook
            release.set()
            t._ckpt_thread.join(timeout=60)
        return out

    t.store.save = held_save
    t.fns = dataclasses.replace(t.fns, train_step=counted_step)
    out = t.run()
    assert t.store.all_steps() == [2, 6]
    _assert_same_params(t.store.restore_params(2), at_two)
    _assert_same_params(t.store.restore_params(6), out["state"].params)
    assert [(s["step"], s["background"], s["saved"]) for s in t.checkpoint_log] == [
        (2, True, True), (6, True, True), (6, False, False)]


def test_a_failed_background_write_is_not_swallowed(data_dir, tmp_path, monkeypatch):
    from progen_tpu_torch.resilience.retry import RetryError, RetryPolicy

    t = _trainer(data_dir, tmp_path / "ck", 4, checkpoint_every=2)
    t.store._retry = RetryPolicy(max_attempts=2, base_delay=0.001)
    faults.configure("ckpt.save:io_error:times=10")
    try:
        with pytest.raises(RetryError):
            t.run()
    finally:
        faults.reset()


# -- (vi) config mismatch, (vii) validation, refusals, warm-up -----------------


def test_a_stored_config_that_differs_raises(data_dir, tmp_path):
    _trainer(data_dir, tmp_path / "ck", 1).run()
    other = ProGenConfig(**{**CFG.to_dict(), "dim": 48})
    t2 = _trainer(data_dir, tmp_path / "ck", 1, model_config=other)
    with pytest.raises(ValueError, match="model config differs"):
        t2.restore_or_init()


def test_full_validation_eval_is_exact(tmp_path):
    """The mean over the WHOLE valid split, the last batch partial (3 % 2),
    pad rows masked out."""
    d = tmp_path / "eval_data"
    d.mkdir()
    rng = np.random.default_rng(3)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 14), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 4, "train"), [mk() for _ in range(4)])
    write_tfrecord(d / shard_filename(0, 3, "valid"), [mk() for _ in range(3)])
    t = _trainer(d, tmp_path / "ck", 1)
    state = t.fns.init_state()
    got = t.evaluate(state)
    from progen_tpu_torch.data.tfrecord import iterator_from_tfrecords_folder

    _, it_fn = iterator_from_tfrecords_folder(str(d), "valid")
    rows = np.concatenate(list(it_fn(seq_len=CFG.seq_len, batch_size=1)))
    assert rows.shape[0] == 3
    with torch.no_grad():
        per_row = [float(cross_entropy(t.model(torch.from_numpy(r[None, :-1])),
                                       torch.from_numpy(r[None, 1:]))[0]) for r in rows]
    assert got == pytest.approx(np.mean(per_row), rel=1e-5)


@pytest.mark.parametrize("field,value", [("attn_impl", "xla"), ("sgu_impl", "xla")])
def test_fields_not_ported_are_refused_by_name(data_dir, tmp_path, field, value):
    """Modes not ported are refused by name (before any process group is
    made): only the attention and SGU implementations, which are not to be
    ported; every mesh, strategy and superstep is."""
    assert trainer_mod.NOT_PORTED == ("attn_impl", "sgu_impl")
    assert not hasattr(trainer_mod, "PARTLY_PORTED")
    kw = {field: value}
    with pytest.raises(ValueError, match=f"TrainerConfig.{field}="):
        _trainer(data_dir, tmp_path / "ck", 1, **kw)


def test_statusz_port_starts_the_server(data_dir, tmp_path):
    """``statusz_port`` (ported): 0 binds an ephemeral loopback port whose
    /healthz answers; ``close()`` stops it and gives SIGTERM back."""
    import urllib.error
    import urllib.request

    assert "statusz_port" not in trainer_mod.NOT_PORTED
    before = signal.getsignal(signal.SIGTERM)
    t = _trainer(data_dir, tmp_path / "ck", 1, statusz_port=0)
    try:
        assert t.statusz_port and t.statusz_port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{t.statusz_port}/healthz",
                                    timeout=10) as resp:
            body = json.loads(resp.read())
        assert body["status"] == "ok" and body["role"] == "trainer"
    finally:
        t.close()
    assert signal.getsignal(signal.SIGTERM) == before
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{t.statusz_port}/healthz", timeout=2)


class _CountingSampler:
    def __init__(self):
        self.calls = []

    def __call__(self, prime, length, **kw):
        self.calls.append(length)
        return torch.zeros((prime.shape[0], length), dtype=torch.long)


@pytest.mark.parametrize("warm,max_steps,sample_every,want", [
    (False, 4, 2, 2),      # gated off by the flag: only the hooks' calls
    (True, 3, 4, 0),       # no sample hook can fire before max_steps
    (True, 4, 4, 2),       # a hook ahead: the warm-up, then the hook
])
def test_sampler_warmup_is_gated(data_dir, tmp_path, warm, max_steps, sample_every, want):
    t = _trainer(data_dir, tmp_path / "ck", max_steps, warm_sampler=warm,
                 sample_every=sample_every)
    t.sampler = _CountingSampler()
    t.run()
    hooks = max_steps // sample_every
    assert len(t.sampler.calls) == want == hooks + (1 if warm and hooks else 0)
    if warm and hooks:
        assert t.sampler.calls[0] == t.cfg.prime_length + 1


def test_the_trainer_needs_a_card_unless_told_cpu(data_dir, tmp_path, monkeypatch):
    from progen_tpu_torch.train import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(CFG, TrainerConfig(), str(data_dir), str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--data_path", str(data_dir), "--checkpoint_path",
                  str(tmp_path / "ck"), "--max_steps", "1"])
    assert not (tmp_path / "ck").exists()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from progen_tpu_torch.observe.meter import ThroughputMeter, profile_trace

    with profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profile_trace(None):
        pass
    meter = ThroughputMeter(window=2)
    meter.tick(100)          # opens the clock; never rated
    assert meter.tokens_per_sec is None
    time.sleep(0.01)
    meter.tick(100)
    assert 0 < meter.tokens_per_sec <= 100 / 0.01
    assert meter.tokens_per_sec_per_chip == meter.tokens_per_sec


def test_the_prefetched_feed_gives_the_synchronous_feeds_run(data_dir, tmp_path):
    """The worker-thread feed (depth 2) and the default synchronous feed
    train on the same batches in the same order."""
    for depth in (0, 2):
        _trainer(data_dir, tmp_path / f"ck{depth}", 3, runs=tmp_path / f"runs{depth}",
                 prefetch_depth=depth).run()
    assert _losses(tmp_path / "runs0") == _losses(tmp_path / "runs2")
    assert len(_losses(tmp_path / "runs0")) == 3


# -- (viii) the train CLI, (ix) the sample CLI ---------------------------------


def _cli(args, stdin=None):
    run = subprocess.run([sys.executable, "-m", "progen_tpu_torch.train", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         input=stdin)
    assert run.returncode == 0, run.stderr[-3000:]
    # the --new prompt ends without a newline, ahead of the first record
    return [json.loads(line[line.index("{"):]) for line in run.stdout.splitlines()
            if "{" in line], run


def test_train_cli_help_runs():
    run = subprocess.run([sys.executable, "-m", "progen_tpu_torch.train", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    for flag in ("--data_path", "--checkpoint_path", "--checkpoint_every", "--new",
                 "--validate_every", "--sample_every", "--inject-faults",
                 "--run_attempts", "--watchdog_timeout", "--no_warm_sampler",
                 "--no_background_checkpoint"):
        assert flag in run.stdout, flag


def test_train_cli_negations_are_spelled_as_train_py_spells_them():
    from progen_tpu_torch.train import cli
    args = cli.parse_args([])
    assert args.background_checkpoint and args.warm_sampler
    args = cli.parse_args(["--no_background_checkpoint", "--no_warm_sampler"])
    assert not args.background_checkpoint and not args.warm_sampler


def test_train_cli_checkpoints_resumes_and_wipes(data_dir, tmp_path):
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "default.toml").write_text("".join(
        f"{k} = {json.dumps(v)}\n" for k, v in CFG.to_dict().items()))
    common = ["--data_path", str(data_dir), "--checkpoint_path", str(tmp_path / "ck"),
              "--config_path", str(tmp_path / "models"), "--runs_dir", str(tmp_path / "runs"),
              "--batch_size", "2", "--grad_accum_every", "1", "--log_every", "1",
              "--checkpoint_every", "1", "--validate_every", "2", "--sample_every", "2",
              "--prime_length", "4", "--device", "cpu"]
    lines, _ = _cli(common + ["--max_steps", "2"])
    assert lines[0]["start_seq_index"] == 0
    assert [r["step"] for r in lines if "loss" in r] == [1, 2]
    assert [r["checkpoint"] for r in lines if "checkpoint" in r] == [1, 2]
    assert any("valid_loss" in r for r in lines) and any("sample" in r for r in lines)
    assert "full_valid_loss" in lines[-1]

    lines, _ = _cli(common + ["--max_steps", "3"])  # resumes at the cursor
    assert lines[0]["start_seq_index"] == 4
    assert [r["step"] for r in lines if "loss" in r] == [3]

    _, run = _cli(common + ["--max_steps", "3", "--new"], stdin="n\n")
    assert CheckpointStore(str(tmp_path / "ck")).all_steps() == [1, 2, 3]
    lines, _ = _cli(common + ["--max_steps", "1", "--new"], stdin="y\n")
    assert lines[0]["start_seq_index"] == 0
    assert CheckpointStore(str(tmp_path / "ck")).all_steps() == [1]


def test_sample_cli_from_a_checkpoint_gives_the_jax_tokens(tmp_path, capsys,
                                                          monkeypatch):
    j_model = JaxProGen(config=JAX_DEFAULT, policy=jax_policy(False))
    flax = jax.device_get(unbox(jax.jit(j_model.init)(
        jax.random.key(3), jnp.zeros((1, JAX_DEFAULT.window_size), jnp.int32))))
    model = ProGen(DEFAULT, make_policy(False), device="cpu")
    model.load_state_dict(params_from_flax(flax))
    fns = make_train_functions(model, make_optimizer())
    CheckpointStore(str(tmp_path / "ck")).save(
        0, fns.init_state(), next_seq_index=123, model_config=DEFAULT.to_dict())

    # the CLI computes in bf16; the token comparison with JAX runs in f32
    monkeypatch.setattr(sample_cli, "make_policy", lambda mixed: make_policy(False))
    texts = sample_cli.main(["--checkpoint_path", str(tmp_path / "ck"), "--prime", "MKV",
                             "--num_samples", "2", "--top_k", "5", "--seq_len", "40",
                             "--seed", "42", "--device", "cpu"])
    assert "trained for 123 sequences" in capsys.readouterr().out
    prime = jnp.tile(jnp.asarray(encode_tokens("MKV"), jnp.int32)[None], (2, 1))
    want = jax_make_sampler(JAX_DEFAULT, jax_policy(False))(
        flax, next(JaxKeySeq(42)), prime, length=40, top_k=5, add_bos=True)
    assert texts == [decode_tokens(row[4:]) for row in np.asarray(want)]
    with pytest.raises(SystemExit, match="no checkpoints"):
        sample_cli.main(["--checkpoint_path", str(tmp_path / "empty"), "--device", "cpu"])


# -- the watchdog copy --------------------------------------------------------


def test_watchdog_trips_and_dumps(tmp_path):
    rec = FlightRecorder()
    rec.record("step", step=1, loss=2.5)
    exits = []
    wd = Watchdog(timeout=0.2, out_dir=str(tmp_path), recorder=rec,
                  exit_fn=exits.append, poll_interval=0.05)
    wd.start()
    deadline = time.monotonic() + 5.0
    while not exits and time.monotonic() < deadline:
        time.sleep(0.02)
    wd.stop()
    assert exits == [WATCHDOG_EXIT_CODE] == [42]
    stacks = list(tmp_path.glob("watchdog_stacks_*.txt"))
    flights = list(tmp_path.glob("watchdog_flight_*.json"))
    assert stacks and flights and "MainThread" in stacks[0].read_text()
    assert json.loads(flights[0].read_text())["events"][0]["loss"] == 2.5


def test_watchdog_exits_42_from_a_wedged_process(tmp_path):
    script = textwrap.dedent(f"""
        import time
        from progen_tpu_torch.resilience.watchdog import Watchdog
        Watchdog(timeout=0.2, out_dir={str(tmp_path)!r}, poll_interval=0.05).start()
        time.sleep(30)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == WATCHDOG_EXIT_CODE, out.stderr
    assert "stalled" in out.stderr
