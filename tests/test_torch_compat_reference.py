"""The reference's Haiku pickles into the port (``compat/reference.py``,
``python -m progen_tpu_torch.convert_checkpoint``), as
``tests/test_compat.py:80-107`` tests the JAX package's converter: the test
writes a reference-style pickle from flax parameters through the inverse
key map, converts it into the port's store and checks

* the key map, the expected shapes and the converted tree are JAX's;
* the meta (the cursor and ``run_id``), the fresh moments, and that the
  restored model's logits match the JAX model on the source weights at
  1e-4;
* the missing-key, unexpected-key and wrong-shape errors;
* the CLI on the CPU, then the port's ``Trainer`` resuming at the cursor
  and ``sample`` decoding from the store.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.compat import convert_reference_params as jax_convert
from progen_tpu.compat import reference_key_map as jax_key_map
from progen_tpu.compat.reference import expected_param_shapes as jax_shapes
from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.parallel import unbox
from progen_tpu_torch import sample as sample_cli
from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.compat.reference import (
    convert_reference_checkpoint,
    convert_reference_params,
    expected_param_shapes,
    reference_key_map,
)
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KW = dict(num_tokens=256, dim=16, seq_len=16, depth=3, window_size=8,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    tokens = jnp.zeros((1, CFG.seq_len), jnp.int32)
    return jax.device_get(unbox(jax.jit(model.init)(jax.random.key(11), tokens))["params"])


def _to_reference_format(flax_params):
    """Inverse of the converter: flax tree -> haiku two-level dict."""
    ref: dict = {}
    for (mod, name), path in reference_key_map(CFG).items():
        node = flax_params
        for part in path:
            node = node[part]
        ref.setdefault(mod, {})[name] = np.asarray(node)
    return ref


def _pickle(tmp_path, flax_params) -> Path:
    package = {
        "next_seq_index": 12,
        "params": _to_reference_format(flax_params),
        "optim_state": {"opaque": "not converted"},
        # the reference's dead kwargs: from_dict drops them
        "model_config": {**CFG.to_dict(), "clamp_gate": True, "attn_dim": None},
        "run_id": "refrun01",
    }
    pkl = tmp_path / "ckpt_1646000000.pkl"
    pkl.write_bytes(pickle.dumps(package))
    return pkl


@pytest.mark.parametrize("overrides", [{}, {"ff_glu": False}, {"global_mlp_depth": 0}],
                         ids=["glu", "no_glu", "no_gmlp"])
def test_key_map_and_shapes_are_jaxs(overrides):
    kw = {**KW, **overrides}
    port, jax_cfg = ProGenConfig(**kw), JaxConfig(**kw)
    assert reference_key_map(port) == jax_key_map(jax_cfg)
    assert expected_param_shapes(port) == jax_shapes(jax_cfg)


def test_the_converted_tree_is_jaxs(flax_params):
    ref = _to_reference_format(flax_params)
    got, want = convert_reference_params(ref, CFG), jax_convert(ref, JAX_CFG)
    flat = lambda t: {tuple(k.key for k in p): np.asarray(v)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_convert_rejects_mismatched_params(flax_params):
    ref = _to_reference_format(flax_params)
    incomplete = {k: v for k, v in ref.items() if not k.endswith("attn0/~/linear")}
    with pytest.raises(ValueError, match="missing from pickle"):
        convert_reference_params(incomplete, CFG)
    bad = {**ref, "pro_gen_base/~/mystery": {"w": np.zeros((1,))}}
    with pytest.raises(ValueError, match="unexpected in pickle"):
        convert_reference_params(bad, CFG)
    wrong = {k: dict(v) for k, v in ref.items()}
    wrong["pro_gen_base/~/embed"]["embeddings"] = np.zeros((3, CFG.dim), np.float32)
    with pytest.raises(ValueError, match="disagree"):
        convert_reference_params(wrong, CFG)


def test_converted_pickle_drives_the_model(tmp_path, flax_params):
    """Pickle -> the port's store: the meta carries the cursor and run id,
    the moments are fresh, and the restored model gives the JAX model's
    logits on the source weights."""
    meta = convert_reference_checkpoint(str(_pickle(tmp_path, flax_params)),
                                        str(tmp_path / "store"), grad_accum_every=2)
    assert meta["next_seq_index"] == 12 and meta["run_id"] == "refrun01"
    store = CheckpointStore(str(tmp_path / "store"))
    stored = store.restore_meta()
    assert stored["next_seq_index"] == 12 and stored["run_id"] == "refrun01"
    assert stored["train_step"] == 0
    assert ProGenConfig.from_dict(stored["model_config"]) == CFG
    opt = torch.load(store.step_dir(0) / "opt_state.pt", weights_only=True)
    assert opt["count"] == 0 and opt["acc_grads"] is not None
    assert all(not t.any() for kind in ("mu", "nu", "acc_grads") for t in opt[kind].values())

    model = ProGen(CFG, make_policy(False), device="cpu", seed=5)
    model.load_state_dict(store.restore_params())
    probe = np.random.default_rng(0).integers(1, CFG.num_tokens, (2, CFG.seq_len))
    with torch.no_grad():
        got = model(torch.from_numpy(probe)).numpy()
    want = JaxProGen(config=JAX_CFG, policy=jax_policy(False)).apply(
        {"params": flax_params}, jnp.asarray(probe))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)

    # converting again replaces step 0
    again = dict(flax_params, norm_out={"scale": np.full((CFG.dim,), 2.0, np.float32)})
    convert_reference_checkpoint(str(_pickle(tmp_path, again)), str(tmp_path / "store"))
    assert torch.equal(store.restore_params()["norm_out.scale"], torch.full((CFG.dim,), 2.0))


def test_the_cli_converts_and_the_port_resumes_and_samples(tmp_path, flax_params, capsys):
    pkl = _pickle(tmp_path, flax_params)
    run = subprocess.run(
        [sys.executable, "-m", "progen_tpu_torch.convert_checkpoint", "--pkl", str(pkl),
         "--checkpoint_path", str(tmp_path / "ck"), "--grad_accum_every", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["next_seq_index"] == 12 and line["run_id"] == "refrun01"
    assert line["converted_params"] == sum(np.asarray(v).size for v in
                                           jax.tree_util.tree_leaves(flax_params))

    d = tmp_path / "data"
    d.mkdir()
    rng = np.random.default_rng(0)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 14), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 40, "train"), [mk() for _ in range(40)])
    write_tfrecord(d / shard_filename(0, 4, "valid"), [mk() for _ in range(4)])
    t = Trainer(CFG, TrainerConfig(
        batch_size=2, grad_accum_every=1, learning_rate=1e-3, validate_every=1000,
        sample_every=1000, checkpoint_every=1000, mixed_precision=False, log_every=1,
        max_steps=2), str(d), str(tmp_path / "ck"), device="cpu")
    state, start, _ = t.restore_or_init()
    assert state.step == 0 and start == 12
    result = t.run()
    t.close()
    assert result["step"] == 2 and np.isfinite(result["loss"])
    assert CheckpointStore(str(tmp_path / "ck")).restore_meta()["next_seq_index"] == 12 + 2 * 2

    capsys.readouterr()
    texts = sample_cli.main(["--checkpoint_path", str(tmp_path / "ck"), "--prime", "MKV",
                             "--seq_len", "16", "--chunk", "4", "--device", "cpu"])
    assert len(texts) == 1
