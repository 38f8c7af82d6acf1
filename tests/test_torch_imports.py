"""The port stands alone: no module of ``progen_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax or the JAX package, and the
port's sampling CLI runs on the CPU when asked to."""

import ast
from pathlib import Path

import pytest
import torch

from progen_tpu_torch import sample

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "progen_tpu"}


def _port_files():
    return sorted((ROOT / "progen_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


def test_sample_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample.main(["--config", "default", "--prime", "MKV"])
