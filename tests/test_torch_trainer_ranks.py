"""The port's train CLI across ranks on the CPU: ``python -m
progen_tpu_torch.train`` as two ``gloo`` ranks started by hand (``RANK``,
``WORLD_SIZE`` and a ``file://`` store under ``tmp_path``), under ``dp``,
``fsdp``, ``tp`` (``--mesh 1,1,2,1``: both ranks read the same rows, each
holds half of the heads and mlp channels) and ``fsdp,tp`` (the same mesh:
FSDP2 over each rank's tensor shard), three steps on the test's own
tfrecords, as ``tests/test_multihost.py:163-212`` runs the JAX trainer on
two processes:

* each rank reads its round-robin share of the records, so the ranks' rows
  together are the one-process global batch (a permutation of it) and the
  per-step losses equal the one-rank port Trainer's at rel 2e-4 (the loss
  is a row mean);
* exactly one run directory, written by rank 0 alone, which also printed
  every record and the sample;
* the checkpoint, gathered and written by rank 0 (a packed ``tp``
  parameter's pieces back in order), restores with no mesh, takes one more
  step and equals the one-rank state;
* the ragged corpus of ``tests/test_trainer_e2e.py:78`` (18 records, a
  global batch of 8) crosses its epoch boundaries across the ranks;
* ``--remat`` under ``fsdp`` takes the same steps as ``fsdp`` without it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.models.progen import ProGenConfig
from progen_tpu_torch.observe.tracker import Tracker
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=16,
                   global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)
STEPS = 3


def _write_data(d: Path, rng, train: tuple, valid: int, lengths=(6, 40)) -> Path:
    d.mkdir()
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(*lengths), dtype=np.uint8))
    for i, n in enumerate(train):
        write_tfrecord(d / shard_filename(i, n, "train"), [mk() for _ in range(n)])
    write_tfrecord(d / shard_filename(0, valid, "valid"), [mk() for _ in range(valid)])
    return d


# strategy -> the two ranks' mesh (data, fsdp, tensor, seq)
MESH = {"dp": "-1,1,1,1", "fsdp": "1,-1,1,1", "tp": "1,1,2,1", "fsdp,tp": "1,1,2,1"}


def _run_ranks(tmp: Path, name: str, data: Path, strategy: str, batch: int, steps: int,
               sample_every: int, extra: tuple = ()):
    """Start two ranks of the CLI; returns each rank's stdout lines."""
    (tmp / "models").mkdir(exist_ok=True)
    (tmp / "models" / "default.toml").write_text("".join(
        f"{k} = {json.dumps(v)}\n" for k, v in CFG.to_dict().items()))
    args = [sys.executable, "-m", "progen_tpu_torch.train", "--data_path", str(data),
            "--checkpoint_path", str(tmp / f"ck_{name}"), "--config_path", str(tmp / "models"),
            "--runs_dir", str(tmp / f"runs_{name}"), "--batch_size", str(batch),
            "--grad_accum_every", "1", "--learning_rate", "1e-3", "--log_every", "1",
            "--checkpoint_every", str(steps), "--validate_every", "1000",
            "--sample_every", str(sample_every), "--prime_length", "4",
            "--max_steps", str(steps), "--mesh", MESH[strategy],
            "--strategies", strategy, "--init_method", f"file://{tmp / f'store_{name}'}",
            "--device", "cpu", *extra]
    procs = [subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
                                              "OMP_NUM_THREADS": "1"})
             for r in range(2)]
    return procs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every two-rank run at once: dp and fsdp on one corpus, dp on the
    ragged one; and the one-rank Trainer's losses on the first."""
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(0)
    data = _write_data(tmp / "data", rng, (30, 18), 7)
    ragged = _write_data(tmp / "ragged", np.random.default_rng(1), (18,), 3, (6, 14))
    runs = {name: _run_ranks(tmp, name, d, strategy, batch, steps, every, extra)
            for name, d, strategy, batch, steps, every, extra in (
                ("dp", data, "dp", 2, STEPS, STEPS, ()),
                ("fsdp", data, "fsdp", 2, STEPS, STEPS, ()),
                # one batch shard: each rank reads the global batch
                ("tp", data, "tp", 4, STEPS, STEPS, ()),
                ("fsdp,tp", data, "fsdp,tp", 4, STEPS, STEPS, ()),
                ("fsdp_remat", data, "fsdp", 2, STEPS, STEPS, ("--remat",)),
                ("ragged", ragged, "dp", 4, 5, 1000, ()))}
    one = Trainer(CFG, TrainerConfig(
        batch_size=4, grad_accum_every=1, learning_rate=1e-3, validate_every=1000,
        sample_every=1000, checkpoint_every=1000, prime_length=4, mixed_precision=False,
        log_every=1, max_steps=STEPS), str(data), str(tmp / "ck_one"),
        tracker=Tracker(out_dir=str(tmp / "runs_one")), device="cpu")
    final = one.run()["state"]
    one.tracker.finish()
    one_state = {"params": final.params, "mu": final.opt_state.mu, "nu": final.opt_state.nu}
    one_state = {k: {n: t.detach().clone() for n, t in d.items()} for k, d in one_state.items()}
    out = {}
    for name, procs in runs.items():
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (stdout, stderr) in zip(procs, outs):
            assert p.returncode == 0, f"{name}:\n{stderr[-4000:]}"
        out[name] = [o[0].splitlines() for o in outs]
    return tmp, data, out, _losses(tmp / "runs_one"), one_state


def _losses(runs: Path) -> dict[int, float]:
    rows = [json.loads(line) for f in runs.glob("*/metrics.jsonl")
            for line in f.read_text().splitlines()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


@pytest.mark.parametrize("strategy", ["dp", "fsdp", "tp", "fsdp,tp"])
def test_two_ranks_take_the_one_rank_steps(worlds, strategy):
    tmp, _, out, one, _ = worlds
    got = _losses(tmp / f"runs_{strategy}")
    assert set(got) == set(one) == set(range(1, STEPS + 1))
    for step in one:
        assert got[step] == pytest.approx(one[step], rel=2e-4), (step, got, one)


@pytest.mark.parametrize("strategy", ["dp", "fsdp", "tp", "fsdp,tp"])
def test_rank_zero_is_the_one_writer(worlds, strategy):
    tmp, _, out, _, _ = worlds
    run_dirs = list((tmp / f"runs_{strategy}").iterdir())
    assert len(run_dirs) == 1
    assert (run_dirs[0] / "samples.html").exists()  # rank 0 sampled at step 3
    rank0, rank1 = out[strategy]
    assert rank1 == []  # rank 1 prints nothing
    records = [json.loads(line) for line in rank0 if line.startswith("{")]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3]
    assert any("sample" in r for r in records) and "full_valid_loss" in records[-1]


@pytest.mark.parametrize("strategy", ["dp", "fsdp", "tp", "fsdp,tp"])
def test_the_checkpoint_restores_with_no_mesh(worlds, strategy):
    tmp, data, _, _, _ = worlds
    ckpt = tmp / f"ck_{strategy}"
    meta = CheckpointStore(str(ckpt)).restore_meta()
    assert meta["train_step"] == STEPS and meta["next_seq_index"] == 4 * STEPS
    t = Trainer(CFG, TrainerConfig(
        batch_size=4, grad_accum_every=1, learning_rate=1e-3, validate_every=1000,
        sample_every=1000, checkpoint_every=1000, prime_length=4, mixed_precision=False,
        log_every=1, max_steps=STEPS + 1), str(data), str(ckpt), device="cpu")
    state, start, _ = t.restore_or_init()
    assert state.step == STEPS and start == 4 * STEPS
    result = t.run()
    assert result["step"] == STEPS + 1 and np.isfinite(result["loss"])


def test_remat_under_fsdp_takes_the_steps_without_it(worlds):
    """``--remat`` (policy ``full``) composes with FSDP2 across two ranks:
    the same losses as the ranks without remat, 1e-6 relative."""
    tmp, _, _, _, _ = worlds
    got, want = _losses(tmp / "runs_fsdp_remat"), _losses(tmp / "runs_fsdp")
    assert set(got) == set(want) == set(range(1, STEPS + 1))
    for step in want:
        assert got[step] == pytest.approx(want[step], rel=1e-6), (step, got, want)


def test_a_ragged_corpus_crosses_epochs_across_ranks(worlds):
    tmp, _, out, _, _ = worlds
    records = [json.loads(line) for line in out["ragged"][0] if line.startswith("{")]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4, 5]
    assert [r["epoch"] for r in records if "epoch" in r] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)


@pytest.mark.parametrize("strategy", ["dp", "fsdp", "tp", "fsdp,tp"])
def test_the_gathered_checkpoint_is_the_one_rank_state(worlds, strategy):
    """Every tensor that rank 0 gathered and wrote (the parameters and both
    moments, after the last step) against the one-rank Trainer's at the
    same step: 2e-4 relative (the losses' bar), and 1e-4 of the leaf's
    largest value absolute (elements near zero)."""
    tmp, _, _, _, one = worlds
    step_dir = CheckpointStore(str(tmp / f"ck_{strategy}")).step_dir(STEPS)
    opt = torch.load(step_dir / "opt_state.pt", weights_only=True)
    stored = {"params": torch.load(step_dir / "params.pt", weights_only=True),
              "mu": opt["mu"], "nu": opt["nu"]}
    for kind, want in one.items():
        assert set(stored[kind]) == set(want)
        for name, value in want.items():
            value = value.numpy()
            np.testing.assert_allclose(stored[kind][name].numpy(), value, rtol=2e-4,
                                       atol=1e-4 * np.abs(value).max(),
                                       err_msg=f"{strategy}: {kind}.{name}")
