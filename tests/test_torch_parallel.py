"""The port's parallelism across ranks (``progen_tpu_torch.parallel``,
``core/mesh.py``) against the JAX package's single-device answers, on one
CPU ``gloo`` world of 4 ranks started once for the module
(``tests/_torch_parallel_worker.py``, which imports neither JAX nor this
directory's ``conftest.py``; its process group meets at a ``file://`` store
under ``tmp_path``).  On the meshes (1,1,1,4), (2,1,1,2), (1,4,1,1),
(4,1,1,1), (1,2,1,2), (1,1,4,1), (1,2,2,1) and (1,1,2,2), in the order
(data, fsdp, tensor, seq):

* the sequence-parallel windowed attention against ``local_attention`` on
  the whole sequence, and the gradients through its halo (the cases of
  ``tests/test_context_parallel.py:22-65,167``); partial windows refused;
* ``cp_spatial_gate`` against ``spatial_gate``, forward and VJP;
* the sharded SGU's output and ``d_W``/``d_bias`` summed over the batch
  ranks against ``pallas_spatial_gate`` on one device
  (``tests/test_pallas_sgu.py:129``); a ``seq`` split refused;
* one f32 train step of the whole model under ``("dp", "sp")``,
  ``("fsdp",)``, ``("dp",)`` and ``("fsdp", "sp")`` (the SGU weights
  sharded over ``seq`` and left out of FSDP2), and under ``("tp",)``,
  ``("fsdp", "tp")`` (2-D: FSDP2 over each rank's tensor shard) and
  ``("tp", "sp")`` on a model whose 4 heads divide over 4 tensor ranks (the
  packed ``to_qkv`` and ``proj_in`` in their rank-grouped layout, the SGU's
  LayerNorm over split channels, its gathered ``proj_out`` input, the
  row-parallel sums: what ``tests/test_train.py:98``,
  ``tests/test_context_parallel.py:130``, ``tests/test_model_pallas.py:37``
  and ``tests/test_mesh_sharding.py:44-60,222-226`` hold on 8 JAX devices),
  against JAX's single-device step from the
  same numpy parameters and batch, at JAX's own bars: loss rtol 1e-5,
  ``grad_norm`` 1e-4, parameters rtol 1e-4 / atol 1e-5
  (``tests/test_context_parallel.py:108-116``), and every parameter's
  gradient, reduced over the ranks before the clip, against ``jax.grad``
  of the same loss: one Adam step from zero moments moves each element by
  about ``lr``, whatever its gradient's size, so only the gradients show a
  leaf summed or divided over the wrong ranks;
* ``parallel/sharding.full_tensor`` of a dim sharded twice (a
  ``(Replicate, Shard(0), Shard(0))`` tensor at rows even and uneven over
  the ranks, and every parameter of the ``("fsdp", "tp")`` step), bit-equal
  on every rank.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxProGenConfig
from progen_tpu.ops import local_attention, spatial_gate
from progen_tpu.ops.pallas_sgu import pallas_spatial_gate
from progen_tpu.parallel import unbox
from progen_tpu.train import batch_loss as jax_batch_loss
from progen_tpu.train import make_optimizer as jax_make_optimizer
from progen_tpu.train import make_train_functions as jax_make_train_functions
from progen_tpu_torch.compat.convert import params_from_flax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ATTN_CASES = [(32, 8), (64, 8), (32, 4)]
GATE_CASES = [16, 32]
CFG = dict(num_tokens=64, dim=16, seq_len=32, depth=2, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
LR = 1e-3
# the (Replicate, Shard(0), Shard(0)) tensor's rows (the worker's
# FULL_TENSOR_ROWS) -> each rank's local rows: even, and uneven
FULL_TENSOR_ROWS = {8: [2, 2, 2, 2], 7: [2, 2, 2, 1]}
# the tp meshes' model: 4 heads, so (1,1,4,1) divides them
TP_CFG = dict(CFG, heads=4, dim_head=4)
TRAIN = {"dp2_sp2": "train", "fsdp4": "train", "dp4": "train", "fsdp2_sp2": "train",
         "tp4": "train_tp", "fsdp2_tp2": "train_tp", "tp2_sp2": "train_tp"}
F32 = dict(rtol=1e-5, atol=1e-5)


def _references(rng):
    """The job's inputs and JAX's single-device answers."""
    job, want = {}, {}
    for n, wsz in ATTN_CASES:
        q, k, v = (rng.normal(size=(2, 3, n, 8)).astype(np.float32) for _ in range(3))
        case = f"attn/{n}_{wsz}"
        job.update({f"{case}/q": q, f"{case}/k": k, f"{case}/v": v,
                    f"{case}/wsz": np.array(wsz)})
        want[f"{case}/out"] = np.asarray(local_attention(q, k, v, window_size=wsz))
    q, k, v = (rng.normal(size=(1, 2, 32, 4)).astype(np.float32) for _ in range(3))
    job.update({"grad/q": q, "grad/k": k, "grad/v": v, "grad/wsz": np.array(8)})
    grads = jax.grad(lambda q, k, v: local_attention(q, k, v, window_size=8).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    want.update({f"grad/d{n}": np.asarray(g) for n, g in zip("qkv", grads)})
    for n in GATE_CASES:
        case = f"gate/{n}"
        gate = rng.normal(size=(2, n, 6)).astype(np.float32)
        w = rng.normal(size=(n, n)).astype(np.float32)
        bias = rng.normal(size=(n, 1)).astype(np.float32)
        cot = rng.normal(size=(2, n, 6)).astype(np.float32)
        job.update({f"{case}/gate": gate, f"{case}/w": w, f"{case}/bias": bias,
                    f"{case}/cot": cot})
        out, vjp = jax.vjp(spatial_gate, gate, w, bias)
        want[f"{case}/out"] = np.asarray(out)
        for name, g in zip(("dgate", "dw", "dbias"), vjp(jnp.asarray(cot))):
            want[f"{case}/{name}"] = np.asarray(g)
    res, gate = (rng.normal(size=(4, 64, 16)).astype(np.float32) for _ in range(2))
    w = (rng.normal(size=(64, 64)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(64, 1)).astype(np.float32)
    job.update({"sgu/res": res, "sgu/gate": gate, "sgu/w": w, "sgu/bias": bias})
    want["sgu/out"] = np.asarray(pallas_spatial_gate(res, gate, w, bias))
    dw, dbias = jax.grad(lambda ww, bb: jnp.sum(pallas_spatial_gate(res, gate, ww, bb) ** 2),
                         argnums=(0, 1))(w, bias)
    want["sgu/dw"], want["sgu/dbias"] = np.asarray(dw), np.asarray(dbias)

    job["train/lr"] = np.array(LR)
    for key, config in (("train", CFG), ("train_tp", TP_CFG)):
        _train_reference(rng, key, config, job, want)
    return job, want


def _train_reference(rng, key, config, job, want):
    """JAX's one-device f32 train step of ``config`` from its own init on a
    batch with pad tails: the job's parameters and batch under ``key``, and
    the loss, grad norm, gradients and updated parameters."""
    cfg = JaxProGenConfig(**config)
    model = JaxProGen(config=cfg, policy=jax_policy(False))
    fns = jax_make_train_functions(model, jax_make_optimizer(LR),
                                   jnp.zeros((4, cfg.seq_len), jnp.int32))
    state = fns.init_state(jax.random.key(0))
    init = params_from_flax(jax.tree.map(np.asarray, unbox(state.params)))
    batch = np.concatenate([np.zeros((4, 1), np.int32),
                            rng.integers(1, 60, size=(4, cfg.seq_len)).astype(np.int32)], 1)
    batch[1, 20:] = 0  # a pad tail whose first pad lies in the second half
    batch[2, 9:] = 0   # ... and one in the first
    grads = jax.grad(lambda p: jax_batch_loss(model.apply({"params": p}, batch[:, :-1]),
                                              batch[:, 1:]))(unbox(state.params))
    state, metrics = fns.train_step(state, jnp.asarray(batch))
    job.update({f"{key}/params/{k}": v.numpy() for k, v in init.items()})
    job.update({f"{key}/config": np.array(json.dumps(config)), f"{key}/batch": batch})
    want[f"{key}/loss"] = float(metrics["loss"])
    want[f"{key}/grad_norm"] = float(metrics["grad_norm"])
    want[f"{key}/grads"] = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, grads)).items()}
    want[f"{key}/params"] = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, unbox(state.params))).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The worker's results and JAX's answers."""
    tmp = tmp_path_factory.mktemp("gloo_world")
    job, want = _references(np.random.default_rng(0))
    full_rng = np.random.default_rng(1)
    for rows in FULL_TENSOR_ROWS:
        job[f"full/{rows}"] = want[f"full/{rows}"] = \
            full_rng.standard_normal((rows, 5)).astype(np.float32)
    np.savez(tmp / "job.npz", **job)
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"),
         str(tmp / "job.npz"), str(tmp / "out.npz"), str(WORLD), str(tmp / "store")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    return dict(np.load(tmp / "out.npz")), want


@pytest.mark.parametrize("n,wsz", ATTN_CASES)
def test_sequence_parallel_attention_matches_one_device(world, n, wsz):
    got, want = world
    key = f"attn/{n}_{wsz}/out"
    np.testing.assert_allclose(got[key], want[key], **F32)


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_gradients_flow_through_the_halo(world, name):
    got, want = world
    np.testing.assert_allclose(got[f"grad/{name}"], want[f"grad/{name}"], **F32)


def test_partial_windows_are_refused(world):
    got, _ = world
    assert "divisible by window" in str(got["partial_window_refused"])


@pytest.mark.parametrize("n", GATE_CASES)
@pytest.mark.parametrize("name", ["out", "dgate", "dw", "dbias"])
def test_cp_spatial_gate_matches_one_device(world, n, name):
    """The forward at JAX's own 1e-5; the gradients, sums of up to 2·n·6
    products of N(0, 1) values, at 1e-5 relative and 1e-4 absolute."""
    got, want = world
    atol = 1e-5 if name == "out" else 1e-4
    np.testing.assert_allclose(got[f"gate/{n}/{name}"], want[f"gate/{n}/{name}"],
                               rtol=1e-5, atol=atol)


@pytest.mark.parametrize("mesh", ["fsdp4", "dp4"])
def test_sharded_sgu_weight_gradients_sum_over_the_batch(world, mesh):
    got, want = world
    np.testing.assert_allclose(got[f"sgu/{mesh}/out"], want["sgu/out"], **F32)
    for name in ("dw", "dbias"):
        np.testing.assert_allclose(got[f"sgu/{mesh}/{name}"], want[f"sgu/{name}"],
                                   rtol=1e-4, atol=1e-4)
    assert "sequence parallelism" in str(got["sgu/seq_refused"])


@pytest.mark.parametrize("label", list(TRAIN))
def test_train_step_across_ranks_matches_jax_one_device(world, label):
    got, want = world
    key = TRAIN[label]
    np.testing.assert_allclose(float(got[f"train/{label}/loss"]), want[f"{key}/loss"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got[f"train/{label}/grad_norm"]),
                               want[f"{key}/grad_norm"], rtol=1e-4, atol=1e-5)
    prefix = f"train/{label}/params/"
    names = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert names == set(want[f"{key}/params"])
    for name, value in want[f"{key}/params"].items():
        np.testing.assert_allclose(got[prefix + name], value, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{label}: {name}")


@pytest.mark.parametrize("label", list(TRAIN))
def test_gradients_across_ranks_match_jax_per_leaf(world, label):
    """Each leaf at the f32 step's bars: 1e-4 relative, and 1e-4 of the
    leaf's largest |gradient| absolute (elements near zero)."""
    got, want = world
    prefix = f"train/{label}/grads/"
    names = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert names == set(want[f"{TRAIN[label]}/grads"])
    for name, value in want[f"{TRAIN[label]}/grads"].items():
        np.testing.assert_allclose(got[prefix + name], value, rtol=1e-4,
                                   atol=1e-4 * np.abs(value).max(),
                                   err_msg=f"{label}: d{name}")


@pytest.mark.parametrize("rows", list(FULL_TENSOR_ROWS))
def test_full_tensor_of_a_twice_sharded_dim_is_bit_equal_on_every_rank(world, rows):
    """``parallel/sharding.full_tensor`` of a ``(Replicate, Shard(0),
    Shard(0))`` DTensor on the ``(data, fsdp, tensor)`` view of the
    ``(1, 2, 2, 1)`` mesh, which torch gathers in two sequential all_gathers
    and warns "may give inconsistent results between ranks": every rank's
    value is bit-equal to the unsharded one, at rows even and uneven over
    the ranks."""
    got, want = world
    assert got[f"full/{rows}/local_rows"].tolist() == FULL_TENSOR_ROWS[rows]
    for rank, value in enumerate(got[f"full/{rows}"]):
        np.testing.assert_array_equal(value, want[f"full/{rows}"], err_msg=f"rank {rank}")


def test_fsdp_tp_parameters_gather_bit_equal_on_every_rank(world):
    """Under ``("fsdp", "tp")`` the tensor-split parameters are FSDP2 shards
    of a tensor shard on three mesh dims; the column-split biases have dim 0
    split twice, ``(Replicate, _StridedShard(0), Shard(0))``, the placement
    torch warns about.  After the step every rank's ``full_tensor`` of every
    parameter equals rank 0's bit for bit."""
    got, _ = world
    placements = json.loads(str(got["train/fsdp2_tp2/placements"]))
    twice = [name for name, p in placements.items()
             if len(p) == 3 and p[0].startswith("R") and all("(0" in q for q in p[1:])]
    assert "ff.0.proj_in.bias" in twice, placements
    assert json.loads(str(got["train/fsdp2_tp2/ranks_differ"])) == []
