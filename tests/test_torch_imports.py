"""The port stands alone: no module of ``progen_tpu_torch``, not
``chip_smoke.py`` and not the ranks' worker of the multi-rank tests
(``tests/_torch_parallel_worker.py``) imports JAX, flax, optax, orbax,
TensorFlow, ``google_crc32c``, safetensors, click or the JAX package, and
the port's sampling, serving and training CLIs run on the CPU when asked
to."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from progen_tpu_torch import sample
from progen_tpu_torch.train import cli as train_cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "progen_tpu", "tensorflow",
             "google_crc32c", "safetensors", "click", "etils"}


def _port_files():
    return (sorted((ROOT / "progen_tpu_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_parallel_worker.py"])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "progen_tpu_torch/models/progen.py" in names
    assert "progen_tpu_torch/ops/cuda_attention.py" in names
    assert "progen_tpu_torch/train/step.py" in names
    assert "progen_tpu_torch/train/cli.py" in names
    for new in ("decode/engine.py", "decode/rng.py", "decode/paging.py", "decode/qos.py",
                "ops/quant.py", "ops/paged_gate_mix.py", "ops/cuda_paged_gate_mix.py",
                "resilience/faults.py", "resilience/retry.py", "observe/robustness.py",
                "data/tfrecord.py", "data/prefetch.py", "data/fasta.py", "generate_data.py",
                "checkpoint/store.py", "observe/meter.py", "observe/tracker.py",
                "resilience/watchdog.py", "train/trainer.py", "train/lora.py",
                "workloads/__init__.py", "workloads/lora.py", "workloads/infill.py",
                "core/mesh.py", "parallel/__init__.py", "parallel/sharding.py",
                "parallel/context.py", "observe/metrics.py", "observe/trace.py",
                "observe/statusz.py", "observe/__init__.py", "compat/reference.py",
                "convert_checkpoint.py", "train/memory.py", "parallel/tensor.py",
                "parallel/decode.py"):
        assert f"progen_tpu_torch/{new}" in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_jax_package_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("from progen_tpu.ops import sgu\nimport progen_tpu_torch\n")
    assert set(_imported_roots(f)) & FORBIDDEN == {"progen_tpu"}


def test_sample_cli_prints_samples_on_cpu(capsys):
    texts = sample.main(["--config", "default", "--seed", "0", "--prime", "MKV",
                         "--num_samples", "2", "--top_k", "25",
                         "--seq_len", "40", "--chunk", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(texts) == 2
    assert out.count("MKV") == 2 and out.count("*" * 40) == 2
    assert all(len(t) <= 40 - 4 for t in texts)
    again = sample.main(["--config", "default", "--seed", "0", "--prime", "MKV",
                         "--num_samples", "2", "--seq_len", "40", "--chunk", "8",
                         "--device", "cpu"])
    assert again == texts  # seeded weights and noise


def test_sample_cli_records_a_profile_of_the_decode(tmp_path, capsys):
    """``--xprof_dir``: a ``torch.profiler`` trace of the decode, the
    samples unchanged."""
    argv = ["--config", "default", "--seed", "0", "--prime", "MKV", "--seq_len", "24",
            "--chunk", "8", "--device", "cpu"]
    texts = sample.main(argv + ["--xprof_dir", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert sample.main(argv) == texts


def test_sample_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample.main(["--config", "default", "--prime", "MKV"])


SERVE = ["--serve", "--config", "default", "--seed", "0", "--prime", "MKV|MALWTR|M",
         "--top_k", "25", "--seq_len", "24", "--slots", "2", "--chunk", "4"]


@pytest.mark.parametrize("mode", [[], ["--paged", "--page_size", "4"],
                                  ["--paged", "--page_size", "4", "--quantize",
                                   "weights+pages"]],
                         ids=["dense", "paged", "paged_q8"])
def test_serve_cli_answers_every_prime_on_cpu(capsys, mode):
    records = sample.main(SERVE + mode + ["--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == records and [r["uid"] for r in records] == [0, 1, 2]
    assert [r["prime"] for r in records] == ["MKV", "MALWTR", "M"]
    for r in records:
        assert r["status"] == "ok" and r["finish_reason"] in ("eos", "length")
        assert 1 <= len(r["tokens"]) <= 24 - len(r["prime"]) - 1
    if not mode:  # seeded weights and per-request keys: the same again, paged too
        capsys.readouterr()
        again = sample.main(SERVE + ["--paged", "--page_size", "4", "--device", "cpu"])
        assert [r["tokens"] for r in again] == [r["tokens"] for r in records]


def test_serve_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample.main(SERVE)


def test_train_cli_takes_steps_on_cpu():
    """``python -m progen_tpu_torch.train`` on the CPU: two steps of the
    default config, one JSON line each."""
    run = subprocess.run(
        [sys.executable, "-m", "progen_tpu_torch.train", "--model_name", "default",
         "--batch_size", "1", "--grad_accum_every", "1", "--max_steps", "2",
         "--log_every", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    records = [json.loads(line) for line in run.stdout.splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    for r in records:
        assert set(r) == {"step", "loss", "grad_norm", "lr", "step_ms",
                          "tokens_per_s", "mfu"}
        assert 0 < r["loss"] < 10 and r["grad_norm"] > 0
        assert r["lr"] == 2e-4 and r["mfu"] is None  # no device number on the CPU


def test_train_cli_takes_supersteps_with_remat_on_cpu():
    """``--superstep 2 --remat`` on the CPU: four micro-batches in two
    spans of two optimizer steps, one JSON line per span; the losses are
    the per-step run's."""
    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "progen_tpu_torch.train", "--model_name", "default",
             "--batch_size", "1", "--grad_accum_every", "1", "--max_steps", "4",
             "--log_every", "1", "--device", "cpu", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
        return [json.loads(line) for line in out.stdout.splitlines()]

    fused = run("--superstep", "2", "--remat", "--remat_policy", "attn")
    assert [r["step"] for r in fused] == [2, 4]
    per_step = {r["step"]: r["loss"] for r in run()}
    assert [r["loss"] for r in fused] == [per_step[2], per_step[4]]


@pytest.mark.parametrize("flags,project,use_wandb,profile_dir", [
    ([], "progen-training", True, None),
    (["--wandb_off", "--wandb_project_name", "mine", "--profile_dir", "prof"],
     "mine", False, "prof")])
def test_train_cli_takes_the_wandb_and_profile_flags(tmp_path, monkeypatch, flags,
                                                      project, use_wandb, profile_dir):
    """``--wandb_off``, ``--wandb_project_name`` (JAX's default
    ``progen-training``) reach the Tracker and ``--profile_dir`` the
    TrainerConfig, as ``train.py:224-228`` hands them on."""
    seen = {}

    class FakeTracker:
        def __init__(self, **kwargs):
            seen["tracker"] = kwargs

        def finish(self):
            pass

    class FakeTrainer:
        def __init__(self, model_config, cfg, *args, **kwargs):
            seen["cfg"] = cfg

        def run(self):
            return {}

        def close(self):
            pass

    monkeypatch.setattr(train_cli, "Tracker", FakeTracker)
    monkeypatch.setattr(train_cli, "Trainer", FakeTrainer)
    train_cli.main(["--data_path", str(tmp_path), "--checkpoint_path", str(tmp_path / "ck"),
                    "--config_path", str(ROOT / "configs" / "model"), "--device", "cpu",
                    *flags])
    assert seen["tracker"]["project"] == project
    assert seen["tracker"]["use_wandb"] is use_wandb
    assert seen["cfg"].profile_dir == profile_dir


def test_train_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--model_name", "default", "--max_steps", "1"])


@pytest.mark.parametrize("phases", [["train"], ["serve", "engine"]])
def test_trace_needs_a_card(monkeypatch, phases):
    from progen_tpu_torch import trace_main_path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_main_path.main(["--phases", *phases])


def test_trace_refuses_an_unknown_phase():
    from progen_tpu_torch import trace_main_path
    with pytest.raises(SystemExit):
        trace_main_path.main(["--phases", "decode_only"])
