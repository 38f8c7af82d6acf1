"""The port's record stamping, card probe and MFU peak on the CPU.

``observe/gitinfo.py`` and ``observe/platform.py`` are held to their JAX
originals: ``git_sha`` and ``stamp_record`` give JAX's outputs on the same
inputs; the error record carries the port's runtime stamp; the card probe
retries a card that does not come up, prints one error record and returns
False, and prints nothing when the card comes up.  ``peak_flops_per_chip``
knows only the H100 80GB HBM3, so MFU reads None elsewhere, in the
Trainer's records and the training CLI's alike.  The port's observe
package exports every name of JAX's (one renamed); its measurement
scripts stamp every record; and the Trainer's JSON lines, written from
two threads, never share a line."""

import io
import json
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import progen_tpu.observe as jax_observe
from progen_tpu.observe import flops as jax_flops
from progen_tpu.observe import gitinfo as jax_gitinfo
from progen_tpu.observe import platform as jax_platform
import progen_tpu_torch.observe as observe
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.models.progen import ProGenConfig
from progen_tpu_torch.observe import flops, gitinfo, platform
from progen_tpu_torch.train import cli as train_cli
from progen_tpu_torch.train import trainer as trainer_module
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
# JAX's observe names the port holds under another name: JAX's table is
# TFLOP/s by TPU device kind, the port's FLOP/s by CUDA card name
RENAMES = {"PEAK_BF16_TFLOPS": "PEAK_BF16_FLOPS"}
# the port's scripts that print measurement records
MEASUREMENT_SCRIPTS = ("chip_smoke.py", "progen_tpu_torch/trace_main_path.py",
                       "progen_tpu_torch/kernels/ablate.py")


# ------------------------------------------------------------------- git_sha


@pytest.fixture
def fresh_sha():
    """Both packages' ``git_sha`` caches empty for one test, and after it."""
    for mod in (gitinfo, jax_gitinfo):
        mod.git_sha.cache_clear()
    yield
    for mod in (gitinfo, jax_gitinfo):
        mod.git_sha.cache_clear()


@pytest.mark.parametrize("short", [False, True])
def test_git_sha_is_jaxs(fresh_sha, short):
    assert gitinfo._REPO_ROOT == ROOT == jax_gitinfo._REPO_ROOT
    assert gitinfo.git_sha(short=short) == jax_gitinfo.git_sha(short=short)


@pytest.mark.parametrize("short", [False, True])
def test_git_sha_is_none_outside_a_work_tree(fresh_sha, monkeypatch, tmp_path, short):
    """An empty directory (as a ``git archive`` unpacks: no ``.git``) has no
    HEAD: both packages say None; git looks no higher than ``tmp_path``."""
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path.parent))
    for mod in (gitinfo, jax_gitinfo):
        monkeypatch.setattr(mod, "_REPO_ROOT", tmp_path)
    assert gitinfo.git_sha(short=short) is None
    assert jax_gitinfo.git_sha(short=short) is None


# -------------------------------------------------------------- stamp_record


def _stamps(mod):
    inputs = [({"bench": "x", "n": 3}, {"platform": "cpu", "wall_time": 1000.0}),
              ({"metric": "y"}, {"wall_time": 999.0}),  # a clock step backwards
              ({"git_sha": "abc", "metric": "z"}, {"wall_time": 2000.25}),
              (None, {"wall_time": 2000.2504, "extra": [1, 2]})]
    return [mod.stamp_record(record, **extra) for record, extra in inputs]


def test_stamp_record_is_jaxs(monkeypatch):
    """The same records with fixed wall times stamp the same, clamps
    included, from a fresh process's state."""
    for mod in (platform, jax_platform):
        monkeypatch.setattr(mod, "_last_wall", 0.0)
    port, jax = _stamps(platform), _stamps(jax_platform)
    assert port == jax
    assert [r["wall_time"] for r in port] == [1000.0, 1000.001, 2000.25, 2000.251]
    assert port[2]["git_sha"] == "abc"
    assert port[0]["git_sha"] == gitinfo.git_sha()


def test_stamp_record_sets_git_sha_and_merges():
    rec = platform.stamp_record({"bench": "x", "n": 3}, platform="cpu")
    assert rec["bench"] == "x" and rec["n"] == 3 and rec["platform"] == "cpu"
    assert rec["git_sha"] == gitinfo.git_sha()
    # caller-provided sha wins (e.g. replaying an archived record)
    assert platform.stamp_record({"git_sha": "abc"})["git_sha"] == "abc"
    # input dict is not mutated
    src = {"a": 1}
    platform.stamp_record(src)
    assert src == {"a": 1}


def test_stamp_record_wall_time_monotonic():
    r1 = platform.stamp_record({"metric": "x"})
    r2 = platform.stamp_record({"metric": "x"})
    assert r2["wall_time"] > r1["wall_time"]
    # caller-provided wall_time (captured outside a traced region) is
    # kept, but clamped so in-process ordering never goes backwards
    r3 = platform.stamp_record({"metric": "x"}, wall_time=r2["wall_time"] - 50)
    assert r3["wall_time"] > r2["wall_time"]
    future = r3["wall_time"] + 1000.0
    r4 = platform.stamp_record({"metric": "x"}, wall_time=future)
    assert r4["wall_time"] == pytest.approx(future)


# ------------------------------------------------- error record and the probe


def _json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_emit_error_record_prints_one_stamped_line(monkeypatch, capsys):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    platform.emit_error_record(RuntimeError("card lost"), script="x.py", batch=4)
    out = capsys.readouterr().out
    assert len(out.splitlines()) == 1
    (rec,) = _json_lines(out)
    assert rec["error"] == "RuntimeError: card lost" and rec["metric"] is None
    assert rec["torch_version"] == torch.__version__
    assert rec["cuda_version"] == torch.version.cuda
    assert rec["cuda_visible_devices"] == "3"
    assert rec["python"] == ".".join(map(str, sys.version_info[:3]))
    assert rec["script"] == "x.py" and rec["batch"] == 4
    assert rec["git_sha"] == gitinfo.git_sha() and rec["wall_time"] > 0
    assert not {"jax_platforms", "jax_version"} & set(rec)


def _retry_env(monkeypatch, attempts: int) -> None:
    monkeypatch.setenv("PROGEN_BENCH_RETRY_ATTEMPTS", str(attempts))
    monkeypatch.setenv("PROGEN_BENCH_RETRY_BASE_DELAY", "0.01")
    monkeypatch.setenv("PROGEN_BENCH_RETRY_MAX_DELAY", "0.01")


def test_probe_backend_without_a_card_reports_and_returns_false(monkeypatch, capsys):
    """No card visible: both attempts run their subprocess and fail, one
    error record is printed, and the probe returns False without raising."""
    _retry_env(monkeypatch, 2)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert platform.probe_backend(script="probe-test") is False
    assert platform.LAST_PROBE["attempts"] == 2 and not platform.LAST_PROBE["ok"]
    records = _json_lines(capsys.readouterr().out)
    assert len(records) == 1
    assert records[0]["error"].startswith("RetryError: card-init: gave up after 2 attempt(s)")
    assert "card init failed" in records[0]["error"]
    assert records[0]["script"] == "probe-test" and records[0]["metric"] is None


def test_probe_backend_counts_a_hung_probe_as_a_failed_attempt(monkeypatch, capsys):
    _retry_env(monkeypatch, 2)
    monkeypatch.setenv("PROGEN_BENCH_RETRY_ATTEMPT_TIMEOUT", "7")
    seen = []

    def hang(cmd, **kwargs):
        seen.append(kwargs["timeout"])
        raise subprocess.TimeoutExpired(cmd, kwargs["timeout"])

    monkeypatch.setattr(subprocess, "run", hang)
    assert platform.probe_backend() is False
    assert seen == [7.0, 7.0]
    (rec,) = _json_lines(capsys.readouterr().out)
    assert "card init exceeded 7s" in rec["error"]


def test_probe_backend_with_a_card_returns_true_silently(monkeypatch, capsys):
    _retry_env(monkeypatch, 2)
    calls = []

    def card_up(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    monkeypatch.setattr(subprocess, "run", card_up)
    assert platform.probe_backend() is True
    assert capsys.readouterr().out == ""
    (cmd,) = calls
    assert cmd[:2] == [sys.executable, "-c"] and "cuda:0" in cmd[2]
    assert "jax" not in cmd[2]
    assert platform.LAST_PROBE["attempts"] == 1 and platform.LAST_PROBE["ok"]


# ------------------------------------------------------- the peak behind MFU


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", torch.device("cuda")])
@pytest.mark.parametrize("name,want", [(H100, 989e12), ("NVIDIA H100 PCIe", None),
                                       ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_flops_per_chip_by_card_name(monkeypatch, device, name, want):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert flops.peak_flops_per_chip(device) == want


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_peak_flops_per_chip_is_none_on_the_cpu(device):
    assert flops.peak_flops_per_chip(device) is None


def test_mfu_is_jaxs_and_none_without_a_peak():
    assert flops.PEAK_BF16_FLOPS == {H100: flops.H100_PEAK_BF16_FLOPS} == {H100: 989e12}
    for peak in (989e12, 197e12):
        assert flops.mfu(12345.5, 6.7e8, peak) == jax_flops.mfu(12345.5, 6.7e8, peak)
    assert flops.mfu(12345.5, 6.7e8, None) is None
    assert jax_flops.mfu(12345.5, 6.7e8, None) is None


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 40), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 20, "train"), [mk() for _ in range(20)])
    write_tfrecord(d / shard_filename(0, 5, "valid"), [mk() for _ in range(5)])
    return d


@pytest.mark.parametrize("peak", [None, 989e12])
def test_trainer_logs_mfu_only_with_a_peak(data_dir, tmp_path, monkeypatch, capsys, peak):
    """Three CPU steps: with the H100's peak (as on that card) each logged
    step's mfu is its rate's share of 989e12, as JAX's Trainer logs it;
    without one (the CPU, an unknown card) no step logs an mfu."""
    seen = []
    monkeypatch.setattr(trainer_module, "peak_flops_per_chip",
                        lambda device: seen.append(device) or peak)
    tcfg = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=16,
                        global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)
    cfg = TrainerConfig(batch_size=2, grad_accum_every=1, learning_rate=1e-3,
                        validate_every=1000, sample_every=1000, checkpoint_every=1000,
                        prime_length=4, mixed_precision=False, log_every=1, max_steps=3)
    t = Trainer(tcfg, cfg, str(data_dir), str(tmp_path / "ck"), device="cpu")
    try:
        t.run()
        num_params = sum(p.numel() for p in t.model.parameters())
    finally:
        t.close()
    assert seen == [torch.device("cpu")]
    steps = [r for r in _json_lines(capsys.readouterr().out) if "loss" in r]
    rated = [r for r in steps if "tokens_per_sec_per_chip" in r]
    assert [r["step"] for r in steps] == [1, 2, 3] and rated
    fpt = flops.model_flops_per_token(tcfg, num_params)
    for r in steps:
        if peak is None or "tokens_per_sec_per_chip" not in r:
            assert "mfu" not in r
        else:
            assert r["mfu"] == jax_flops.mfu(r["tokens_per_sec_per_chip"], fpt, peak)


def test_train_cli_mfu_on_a_card_with_a_peak(monkeypatch, capsys):
    """The synthetic CLI run's ``mfu`` is its rate's share of the peak that
    ``peak_flops_per_chip`` gives for its device (the H100's, patched in
    here); the CPU's own None is pinned by ``test_torch_imports.py``."""
    seen, counted = [], []
    monkeypatch.setattr(train_cli, "peak_flops_per_chip",
                        lambda device: seen.append(device) or 989e12)
    monkeypatch.setattr(train_cli, "model_flops_per_token", lambda *a: counted.append(
        flops.model_flops_per_token(*a)) or counted[-1])
    records = train_cli.main(["--model_name", "tiny", "--batch_size", "1",
                              "--grad_accum_every", "1", "--max_steps", "1",
                              "--log_every", "1", "--device", "cpu"])
    assert seen == [torch.device("cpu")]
    assert _json_lines(capsys.readouterr().out) == records
    (r,) = records
    (fpt,) = counted
    assert r["mfu"] > 0
    assert r["mfu"] == jax_flops.mfu(r["tokens_per_s"], fpt, 989e12)


# ------------------------------------------------------------- the exports


def test_observe_exports_every_jax_name():
    """``progen_tpu_torch.observe.__all__`` covers JAX's, modulo ``RENAMES``,
    and every exported name resolves."""
    want = {RENAMES.get(name, name) for name in jax_observe.__all__}
    assert want <= set(observe.__all__), sorted(want - set(observe.__all__))
    for name in observe.__all__:
        assert getattr(observe, name) is not None
    assert observe.PEAK_BF16_FLOPS is flops.PEAK_BF16_FLOPS
    assert observe.stamp_record is platform.stamp_record
    assert observe.git_sha is gitinfo.git_sha


# --------------------------------------------------- the measurement scripts


@pytest.mark.parametrize("script", MEASUREMENT_SCRIPTS)
def test_every_measurement_record_leaves_through_stamp_record(script):
    """Source sweep (the port of ``tests/test_observe.py``'s over the JAX
    bench drivers): each script that prints JSON records routes them through
    ``observe.platform.stamp_record`` and never stamps ``git_sha`` by hand;
    every ``print(json.dumps(...))`` but ``chip_smoke.py``'s last line is
    stamped."""
    src = (ROOT / script).read_text()
    assert "json.dumps(" in src and "stamp_record" in src
    assert "git_sha()" not in src
    unstamped = [line.strip() for line in src.splitlines()
                 if "print(json.dumps(" in line and "print(json.dumps(stamp_record(" not in line]
    allowed = ['print(json.dumps({"ok": True, "device": {'] if script == "chip_smoke.py" else []
    assert unstamped == allowed


# ----------------------------------------------- JSON lines from two threads


def test_trainer_records_from_two_threads_never_share_a_line(monkeypatch):
    """The Trainer emits from the main thread and from its background save's
    thread: 2 x 2000 records written at once, into a stdout that lets the
    other thread run inside every write, come out as 4000 lines, each one
    record."""
    n = 2000

    class YieldingStdout(io.StringIO):
        def write(self, text: str) -> int:
            time.sleep(0)  # the other thread may write here
            return super().write(text)

    out = YieldingStdout()
    monkeypatch.setattr(sys, "stdout", out)
    fake = types.SimpleNamespace(rank=0)
    start = threading.Barrier(2)

    def emit(name: str) -> None:
        start.wait()
        for i in range(n):
            Trainer._emit(fake, step=i, thread=name, pad="x" * 48)

    threads = [threading.Thread(target=emit, args=(name,)) for name in ("main", "save")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lines = out.getvalue().splitlines()
    assert len(lines) == 2 * n
    records = [json.loads(line) for line in lines]
    for name in ("main", "save"):
        assert [r["step"] for r in records if r["thread"] == name] == list(range(n))
