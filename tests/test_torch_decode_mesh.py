"""Decode under a mesh (``progen_tpu_torch/parallel/decode.py``): the port's
meshed sampler, decode step, engine and Trainer sample hook on one CPU
``gloo`` world of 4 ranks (``tests/_torch_parallel_worker.py``, a
``decode`` job; its ranks import neither JAX nor ``conftest.py``), against
the JAX package's one-device ``make_sampler`` and the port's unmeshed
answers, built here from the same numpy parameters.  In the order (data,
fsdp, tensor, seq):

* ``make_sampler``/``make_chunked_sampler(mesh=, strategies=,
  params_shardings=)`` under ``test_decode_sharded.py:43``'s three meshes
  at 4 ranks, (2,2,1,1) ``fsdp``, (1,2,2,1) ``(fsdp, tp)`` and (2,1,2,1)
  ``(dp, tp)``, plus (1,1,4,1) ``tp`` and (1,1,2,2) ``(tp, sp)``: the
  tokens of JAX's ``make_sampler`` on the same key, full length and the
  short decode of ``:68``, int32, the same on every rank and on a second
  call;
* a decode step under ``fsdp`` on 4 ranks against the unsharded step:
  reading a local shard as the whole weight cannot pass;
* the sampler's refusals: an unplaced model, another mesh, other
  strategies, no mesh for a placed model, another plan;
* the engine under ``(fsdp, tp)``, request for request equal to the
  unmeshed port engine: dense (twice, as ``tests/test_serving.py:275``),
  paged and 8-bit pages with the pool fully returned
  (``tests/test_paged.py:318``), int8 weights (twice,
  ``tests/test_quant.py:375``), speculative with the identity draft equal
  to the meshed non-spec engine (``tests/test_spec_decode.py:213``),
  disaggregated, embeddings, a reload to new weights (into a copy of the
  caller's model, then in place, also under int8 weights), and a snapshot
  restored on a fresh meshed engine;
* a LoRA bank under ``tp`` (1,1,4,1): tenant-0 rows bit-equal to the
  bankless meshed engine, every tenant equal to the unmeshed banked one;
* the Trainer's sample hook under ``(fsdp, tp)``: the string the unmeshed
  Trainer logs, with no whole-model copy.

``remote_prefill`` stays refused, here on one rank.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import make_sampler as jax_make_sampler
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxProGenConfig
from progen_tpu.parallel import unbox
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.decode.engine import ServingEngine
from progen_tpu_torch.decode.incremental import ProGenDecodeStep
from progen_tpu_torch.decode.prefill import make_prefiller
from progen_tpu_torch.models.progen import ProGenConfig
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig
from progen_tpu_torch.workloads.lora import random_lora_bank

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location(
    "_torch_parallel_worker", ROOT / "tests" / "_torch_parallel_worker.py")
worker = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(worker)
WORLD = 4
# test_decode_sharded.py's model with 4 heads of 4, so (1,1,4,1) divides them
CFG = dict(num_tokens=32, dim=16, seq_len=24, depth=3, window_size=4,
           global_mlp_depth=1, heads=4, dim_head=4, ff_mult=2)
# test_decode_sharded.py:55-57 and :76-78: (prime, length, top_k, key)
SAMPLES = {"full": ([[5, 9, 12], [7, 2, 20]], CFG["seq_len"], 8, 3),
           "short": ([[4, 4]], 12, 5, 5)}
TRAINER_MODEL = dict(num_tokens=256, dim=16, seq_len=24, depth=2, window_size=4,
                     global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
TRAINER_CFG = dict(batch_size=2, grad_accum_every=1, prime_length=4, mixed_precision=False,
                   seed=3)
LORA = dict(tenants=3, rank=2, seed=11)


def _requests(rng, n: int, vocab: int, max_new: int = 6, tenants: int = 0) -> list[dict]:
    return [dict(uid=i, tokens=[int(t) for t in rng.integers(1, vocab, rng.integers(2, 8))],
                 max_new_tokens=max_new, seed=i, top_k=8,
                 **({"tenant": i % tenants} if tenants else {}))
            for i in range(n)]


def _jax_case(model_cfg, params, case):
    prime, length, top_k, key = SAMPLES[case]
    sample = jax_make_sampler(model_cfg, jax_policy(False))
    tokens = sample({"params": params}, jax.random.key(key), jnp.asarray(prime, jnp.int32),
                    length=length, top_k=top_k, add_bos=True)
    return np.asarray(tokens), np.asarray(jax.random.key_data(jax.random.key(key)), np.int64)


def _trainer_sample(trainer: Trainer, batch) -> list:
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer._sample_and_log(batch, 0)
    return [json.loads(line).get("sample") for line in printed.getvalue().splitlines()]


def _references(tmp: Path):
    """The job, JAX's tokens and the port's unmeshed answers."""
    rng = np.random.default_rng(0)
    cfg = JaxProGenConfig(**CFG)
    model = JaxProGen(config=cfg, policy=jax_policy(False))
    params = unbox(model.init(jax.random.key(7), jnp.zeros((2, CFG["seq_len"]), jnp.int32)))
    params = params["params"]
    state = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, params)).items()}
    job = {f"decode/params/{k}": v for k, v in state.items()}
    job["decode/config"] = np.array(json.dumps(CFG))
    want = {}
    for case, (prime, length, top_k, _) in SAMPLES.items():
        want[case], key = _jax_case(cfg, params, case)
        job.update({f"decode/{case}/prime": np.asarray(prime, np.int64),
                    f"decode/{case}/length": np.array(length),
                    f"decode/{case}/top_k": np.array(top_k), f"decode/{case}/key": key})
    job_d = {k: v for k, v in job.items()}
    unmeshed = lambda: worker.decode_model(job_d)

    # one step after a ragged prefill, unsharded
    tokens = rng.integers(1, CFG["num_tokens"], (3, 8)).astype(np.int64)
    lengths = np.array([3, 8, 5], np.int64)
    job.update({"decode/step/tokens": tokens, "decode/step/lengths": lengths,
                "decode/step/len": np.array(12)})
    m = unmeshed()
    _, caches = make_prefiller(m)(torch.from_numpy(tokens), torch.from_numpy(lengths), 12)
    want["step"] = ProGenDecodeStep(m)(torch.from_numpy(tokens[:, 0]),
                                       torch.from_numpy(lengths), caches)[0].numpy()

    requests = _requests(rng, 5, CFG["num_tokens"])
    job["decode/requests"] = np.array(json.dumps(requests))
    for mode, kwargs in worker.ENGINE_MODES.items():
        want[f"engine/{mode}"] = worker.engine_answers(
            ServingEngine(unmeshed(), **worker.ENGINE_KW, **kwargs), requests)
    engine = ServingEngine(unmeshed(), **worker.ENGINE_KW)
    want["engine/embed"] = worker.engine_embeds(engine, requests)
    half = {k: torch.from_numpy(v) * 0.5 for k, v in state.items()}
    m = unmeshed()
    m.load_state_dict(half)
    want["engine/reloaded"] = worker.engine_answers(ServingEngine(m, **worker.ENGINE_KW),
                                                    requests)
    want["engine/int8/reloaded"] = worker.engine_answers(
        ServingEngine(m, **worker.ENGINE_KW, **worker.ENGINE_MODES["int8"]), requests)

    lora = _requests(rng, 6, CFG["num_tokens"], tenants=LORA["tenants"])
    job.update({"decode/lora/requests": np.array(json.dumps(lora)),
                **{f"decode/lora/{k}": np.array(v) for k, v in LORA.items()}})
    bank = random_lora_bank(ProGenConfig(**CFG), LORA["tenants"], LORA["rank"],
                            seed=LORA["seed"], device="cpu")
    want["engine/lora"] = worker.engine_answers(
        ServingEngine(unmeshed(), lora_bank=bank, **worker.ENGINE_KW), lora)

    batch = rng.integers(1, 255, (2, TRAINER_MODEL["seq_len"] + 1)).astype(np.int32)
    job.update({"decode/trainer/model": np.array(json.dumps(TRAINER_MODEL)),
                "decode/trainer/config": np.array(json.dumps(TRAINER_CFG)),
                "decode/trainer/data": np.array(str(tmp / "no_data")),
                "decode/trainer/ckpt": np.array(str(tmp / "ck")),
                "decode/trainer/batch": batch})
    trainer = Trainer(ProGenConfig(**TRAINER_MODEL), TrainerConfig(**TRAINER_CFG),
                      str(tmp / "no_data"), str(tmp / "ck_one"), device="cpu")
    want["trainer/sample"] = _trainer_sample(trainer, batch)
    trainer.close()
    return job, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The decode job's results and the references."""
    tmp = tmp_path_factory.mktemp("decode_world")
    job, want = _references(tmp)
    np.savez(tmp / "job.npz", **job)
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"),
         str(tmp / "job.npz"), str(tmp / "out.npz"), str(WORLD), str(tmp / "store"),
         "decode"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    return dict(np.load(tmp / "out.npz")), want


@pytest.mark.parametrize("case", list(SAMPLES))
@pytest.mark.parametrize("label", list(worker.DECODE_MESHES))
def test_meshed_sampler_gives_jax_tokens(world, label, case):
    got, want = world
    key = f"sample/{label}/{case}"
    np.testing.assert_array_equal(got[key], want[case])
    assert str(got[f"{key}/dtype"]) == "torch.int32"
    assert bool(got[f"{key}/every_rank"]), "the ranks sampled different tokens"
    assert bool(got[f"{key}/repeat"]), "a second call gave other tokens"


def test_the_decode_step_unshards_under_fsdp(world):
    """Every weight is sharded 4 ways: a step that read a rank's shard as
    the whole weight could not give the unsharded step's logits."""
    got, want = world
    np.testing.assert_allclose(got["step/fsdp4/logits"], want["step"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,words", [
    ("unplaced", "not placed"), ("mesh", "differs from the mesh"),
    ("strategies", "differ from the model's"), ("no_mesh", "no mesh was given"),
    ("plan", "is not the plan")])
def test_the_sampler_refuses_what_the_mesh_has_not_placed(world, name, words):
    got, _ = world
    assert words in str(got[f"refused/{name}"]), str(got[f"refused/{name}"])


def test_remote_prefill_and_paged_impl_stay_refused():
    for name in ("remote_prefill", "paged_impl"):
        with pytest.raises(NotImplementedError, match=name):
            ServingEngine(ProGenConfig(**CFG), device="cpu", **{name: object()})


@pytest.mark.parametrize("mode", list(worker.ENGINE_MODES))
def test_meshed_engine_equals_the_unmeshed_one(world, mode):
    got, want = world
    answers = json.loads(str(got[f"engine/{mode}/0"]))
    assert answers == want[f"engine/{mode}"]
    assert bool(got[f"engine/{mode}/0/every_rank"])
    if f"engine/{mode}/1" in got:  # run twice: deterministic
        assert json.loads(str(got[f"engine/{mode}/1"])) == answers
    if f"engine/{mode}/0/pool_returned" in got:
        assert bool(got[f"engine/{mode}/0/pool_returned"])


def test_meshed_spec_equals_the_meshed_plain_engine(world):
    got, _ = world
    assert json.loads(str(got["engine/spec/0"])) == json.loads(str(got["engine/dense/0"]))


def test_meshed_engine_embeds_reloads_and_restores(world):
    """Embeddings at 1e-5 of the unmeshed engine's; a reload to new weights
    gives a fresh unmeshed engine's answers on them; a snapshot after two
    steps, restored on a fresh meshed engine, gives the uninterrupted
    answers."""
    got, want = world
    np.testing.assert_allclose(got["engine/embed"], want["engine/embed"], rtol=1e-5, atol=1e-6)
    assert json.loads(str(got["engine/reloaded"])) == want["engine/reloaded"]
    assert json.loads(str(got["engine/restored"])) == want["engine/dense"]


@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_a_meshed_reload_writes_into_the_served_shards(world, mode):
    """An engine that serves a model of its own reloads in place, each rank
    writing its part (the int8 buffers' rank parts under int8 weights): a
    fresh unmeshed engine's answers on the new weights."""
    got, want = world
    if mode == "dense":  # after the reload into a copy, back to the first weights
        assert json.loads(str(got["engine/reloaded_back"])) == want["engine/dense"]
    else:
        reloaded = json.loads(str(got["engine/int8/reloaded"]))
        assert reloaded == want["engine/int8/reloaded"]
        assert reloaded != want["engine/int8"]


def test_a_lora_bank_under_tp(world):
    got, want = world
    banked = json.loads(str(got["engine/lora"]))
    bankless = json.loads(str(got["engine/lora_bankless"]))
    assert bool(got["engine/lora/every_rank"])
    assert banked == want["engine/lora"]
    tenant0 = [str(i) for i in range(6) if i % LORA["tenants"] == 0]
    assert {u: banked[u] for u in tenant0} == {u: bankless[u] for u in tenant0}
    assert any(banked[u] != bankless[u] for u in banked if u not in tenant0)


def test_the_trainer_samples_in_its_training_shardings(world):
    got, want = world
    assert json.loads(str(got["trainer/sample"])) == want["trainer/sample"]
    assert want["trainer/sample"][0]
    assert not bool(got["trainer/has_sample_model"])


def _cli_answers(stdout: str, serve: bool):
    """What the sampling CLI printed: the JSON lines' tokens with
    ``--serve``, else the text."""
    if not serve:
        return stdout
    return [json.loads(line)["tokens"] for line in stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("serve", [False, True])
def test_the_sample_cli_decodes_across_ranks(tmp_path, capsys, serve):
    """``sample.py --mesh 1,2,1,1 --strategies fsdp`` as two gloo ranks
    started by hand: rank 0 prints the unmeshed CLI's samples, rank 1
    nothing."""
    from progen_tpu_torch import sample as sample_cli

    argv = ["--config", "default", "--seq_len", "24", "--chunk", "4", "--device", "cpu",
            "--num_samples", "2", "--prime", "MKV|MAL" if serve else "MKV"]
    if serve:
        argv += ["--serve", "--slots", "2", "--paged", "--page_size", "4", "--spec"]
    meshed = argv + ["--mesh", "1,2,1,1", "--strategies", "fsdp",
                     "--init_method", f"file://{tmp_path / 'store'}"]
    procs = [subprocess.Popen([sys.executable, "-m", "progen_tpu_torch.sample", *meshed],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
                                   "OMP_NUM_THREADS": "1", "PYTHONIOENCODING": "utf-8"})
             for r in range(2)]
    sample_cli.main(argv)
    want = _cli_answers(capsys.readouterr().out, serve)
    outs = [[o.decode("utf-8") for o in p.communicate(timeout=300)] for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert want and _cli_answers(outs[0][0], serve) == want
    assert not _cli_answers(outs[1][0], serve)
