"""The ranks of one CPU ``gloo`` world for ``tests/test_torch_parallel.py``,
``tests/test_torch_decode_mesh.py`` and ``tests/test_torch_serve_groups.py``.

    python tests/_torch_parallel_worker.py JOB.npz OUT.npz WORLD STORE [KIND]

starts WORLD ranks with ``torch.multiprocessing``, their process group at
``file://STORE``, and runs every case of the job of KIND.  A ``decode``
job (:func:`decode_job`) runs the meshed sampler, decode step, engine and
Trainer sample hook; a ``slabs`` job (:func:`slabs_job`) reads a replica
group's slab frames.  A ``train`` job (the default) runs on the meshes
(1,1,1,4), (2,1,1,2), (1,4,1,1), (4,1,1,1), (1,2,1,2), (1,1,4,1), (1,2,2,1)
and (1,1,2,2): the sequence-parallel attention (forward, its gradients
through the halo, partial windows refused) and SGU mix, the sharded SGU's
weight gradients, and one f32 train step of the whole model per strategy
(its parameters after the step and their reduced gradients; the ``tp``
meshes on the job's ``train_tp`` model, whose heads divide by 4).  Rank 0 writes every result, whole
(gathered over the ranks), to OUT.npz.  It imports torch and the port only:
no JAX and no ``conftest.py``, so its ranks start in seconds.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MESHES = {"seq4": (1, 1, 1, 4), "dp2_sp2": (2, 1, 1, 2), "fsdp4": (1, 4, 1, 1),
          "dp4": (4, 1, 1, 1), "fsdp2_sp2": (1, 2, 1, 2), "tp4": (1, 1, 4, 1),
          "fsdp2_tp2": (1, 2, 2, 1), "tp2_sp2": (1, 1, 2, 2)}
# label -> (strategies, the job's model and batch)
TRAIN_STEPS = {"dp2_sp2": (("dp", "sp"), "train"), "fsdp4": (("fsdp",), "train"),
               "dp4": (("dp",), "train"), "fsdp2_sp2": (("fsdp", "sp"), "train"),
               "tp4": (("tp",), "train_tp"), "fsdp2_tp2": (("fsdp", "tp"), "train_tp"),
               "tp2_sp2": (("tp", "sp"), "train_tp")}


def gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The slices of ``t`` over ``group``, concatenated along ``dim``."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim)


def seq_slice(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    s, r = mesh.size(3), mesh.get_local_rank("seq")
    n = t.shape[dim] // s
    return t.narrow(dim, r * n, n).contiguous()


def attention_cases(job, mesh, out):
    from progen_tpu_torch.parallel import context

    group = mesh.get_group("seq")
    for key in sorted(k for k in job if k.startswith("attn/") and k.endswith("/q")):
        case = key[:-2]
        wsz = int(job[f"{case}/wsz"])
        q, k, v = (seq_slice(torch.from_numpy(job[f"{case}/{n}"]), mesh, 2)
                   for n in "qkv")
        got = context.cp_local_attention(q, k, v, mesh=mesh, window_size=wsz)
        out[f"{case}/out"] = gather(got, group, 2)
    # gradients through the halo: d(sum out) by q, k and v
    q, k, v = (seq_slice(torch.from_numpy(job[f"grad/{n}"]), mesh, 2).requires_grad_()
               for n in "qkv")
    context.cp_local_attention(q, k, v, mesh=mesh, window_size=int(job["grad/wsz"])).sum().backward()
    for name, t in zip("qkv", (q, k, v)):
        out[f"grad/d{name}"] = gather(t.grad, group, 2)
    z = seq_slice(torch.zeros(1, 1, 24, 4), mesh, 2)  # 6 a slice, window 4: partial
    try:
        context.cp_local_attention(z, z, z, mesh=mesh, window_size=4)
        out["partial_window_refused"] = np.array("")
    except ValueError as e:
        out["partial_window_refused"] = np.array(str(e))


def gate_cases(job, mesh, out):
    from progen_tpu_torch.parallel import context

    group = mesh.get_group("seq")
    for case in sorted({k.rsplit("/", 1)[0] for k in job if k.startswith("gate/")}):
        gate = seq_slice(torch.from_numpy(job[f"{case}/gate"]), mesh, 1).requires_grad_()
        w = seq_slice(torch.from_numpy(job[f"{case}/w"]), mesh, 0).requires_grad_()
        b = seq_slice(torch.from_numpy(job[f"{case}/bias"]), mesh, 0).requires_grad_()
        got = context.cp_spatial_gate(gate, w, b, mesh=mesh)
        (got * seq_slice(torch.from_numpy(job[f"{case}/cot"]), mesh, 1)).sum().backward()
        out[f"{case}/out"] = gather(got, group, 1)
        out[f"{case}/dgate"] = gather(gate.grad, group, 1)
        out[f"{case}/dw"] = gather(w.grad, group, 0)
        out[f"{case}/dbias"] = gather(b.grad, group, 0)


def sharded_sgu_case(job, mesh, label, out):
    """K2 per rank on its batch rows, loss sum(out ** 2) over the global
    batch: ranks x the mean that ``reduce_gradients`` takes is the sum."""
    from progen_tpu_torch.parallel import context
    from progen_tpu_torch.parallel.sharding import ParallelPlan, batch_sharding, reduce_gradients

    res, gate = (batch_sharding(mesh, torch.from_numpy(job[f"sgu/{n}"])) for n in ("res", "gate"))
    w = torch.nn.Parameter(torch.from_numpy(job["sgu/w"]))
    b = torch.nn.Parameter(torch.from_numpy(job["sgu/bias"]))
    got = context.sharded_spatial_gate(res, gate, w, b, mesh=mesh)
    (got ** 2).sum().backward()
    plan = ParallelPlan(mesh, ("dp",), frozenset(), frozenset())
    reduce_gradients(plan, {"w": w, "b": b})
    ranks = mesh.size(0) * mesh.size(1)
    out[f"sgu/{label}/out"] = gather(got, mesh.get_group("data") if mesh.size(0) > 1
                                     else mesh.get_group("fsdp"), 0)
    out[f"sgu/{label}/dw"] = w.grad * ranks
    out[f"sgu/{label}/dbias"] = b.grad * ranks
    try:
        context.sharded_spatial_gate(res, gate, w, b,
                                     mesh=MESH_CACHE["seq4"])
        out["sgu/seq_refused"] = np.array("")
    except ValueError as e:
        out["sgu/seq_refused"] = np.array(str(e))


def train_step_case(job, mesh, label, strategies, out, key="train"):
    from progen_tpu_torch.core.precision import make_policy
    from progen_tpu_torch.models.progen import ProGen, ProGenConfig
    from progen_tpu_torch.parallel.sharding import batch_sharding, full_tensor
    from progen_tpu_torch.train.optimizer import make_optimizer
    from progen_tpu_torch.train.step import make_train_functions

    cfg = ProGenConfig(**json.loads(str(job[f"{key}/config"])))
    model = ProGen(cfg, make_policy(False), device="cpu")
    init = {k[len(f"{key}/params/"):]: torch.from_numpy(v) for k, v in job.items()
            if k.startswith(f"{key}/params/")}
    model.load_state_dict(init)
    fns = make_train_functions(model, make_optimizer(float(job["train/lr"])), mesh=mesh,
                               strategies=strategies)
    state = fns.init_state()
    batch = batch_sharding(mesh, torch.from_numpy(job[f"{key}/batch"]))
    state, metrics = fns.train_step(state, batch)
    out[f"train/{label}/loss"] = metrics["loss"]
    out[f"train/{label}/grad_norm"] = metrics["grad_norm"]
    plan = model.parallel_plan
    for name, p in state.params.items():  # every rank gathers, in one order
        pieces = plan.pieces(name)
        out[f"train/{label}/params/{name}"] = full_tensor(p.detach(), pieces)
        # the gradient reduced over the ranks, before the clip
        out[f"train/{label}/grads/{name}"] = full_tensor(p.grad, pieces)


MESH_CACHE: dict = {}


def train_job(job, out) -> None:
    from progen_tpu_torch.core.mesh import MeshConfig, make_mesh

    for label, sizes in MESHES.items():
        MESH_CACHE[label] = make_mesh(MeshConfig(*sizes))
    attention_cases(job, MESH_CACHE["seq4"], out)
    gate_cases(job, MESH_CACHE["seq4"], out)
    for label in ("fsdp4", "dp4"):
        sharded_sgu_case(job, MESH_CACHE[label], label, out)
    for label, (strategies, key) in TRAIN_STEPS.items():
        train_step_case(job, MESH_CACHE[label], label, strategies, out, key)


# the decode job's meshes: label -> (data, fsdp, tensor, seq), strategies
DECODE_MESHES = {"dp2_fsdp2": ((2, 2, 1, 1), ("fsdp",)),
                 "fsdp2_tp2": ((1, 2, 2, 1), ("fsdp", "tp")),
                 "dp2_tp2": ((2, 1, 2, 1), ("dp", "tp")),
                 "tp4": ((1, 1, 4, 1), ("tp",)),
                 "tp2_sp2": ((1, 1, 2, 2), ("tp", "sp"))}
# the engine's modes on the (fsdp, tp) mesh: label -> ServingEngine kwargs
ENGINE_MODES = {"dense": {}, "paged": {"paged": True},
                "q8": {"paged": True, "quantize": "weights+pages"},
                "int8": {"quantize": "weights"}, "spec": {"spec": True},
                "disagg": {"paged": True, "disagg": True}}
ENGINE_KW = dict(num_slots=2, chunk_size=3, max_len=20, page_size=4)


def decode_model(job):
    """The decode job's f32 model on the CPU with the job's parameters."""
    from progen_tpu_torch.core.precision import make_policy
    from progen_tpu_torch.models.progen import ProGen, ProGenConfig

    model = ProGen(ProGenConfig(**json.loads(str(job["decode/config"]))), make_policy(False),
                   device="cpu")
    model.load_state_dict({k[len("decode/params/"):]: torch.from_numpy(v)
                           for k, v in job.items() if k.startswith("decode/params/")})
    return model.eval()


def same_on_every_rank(value) -> bool:
    """Whether every rank of the world holds ``value`` (a JSON-able one)."""
    values = [None] * dist.get_world_size()
    dist.all_gather_object(values, json.dumps(value))
    return all(v == values[0] for v in values)


def engine_answers(engine, requests) -> dict:
    """``{uid: tokens}`` of ``requests`` served to completion."""
    from progen_tpu_torch.decode.engine import Request

    for r in requests:
        engine.submit(Request(**r))
    done = engine.run_until_idle()
    assert all(c.ok for c in done), [c.status for c in done]
    return {str(c.uid): [int(t) for t in c.tokens] for c in done}


def sampler_cases(job, out) -> None:
    """The meshed samplers' tokens under every decode mesh, each rank's."""
    from progen_tpu_torch.core.mesh import MeshConfig, make_mesh
    from progen_tpu_torch.decode.sampler import make_chunked_sampler, make_sampler
    from progen_tpu_torch.parallel.sharding import parallelize

    for label, (sizes, strategies) in DECODE_MESHES.items():
        mesh = make_mesh(MeshConfig(*sizes))
        model = decode_model(job)
        plan = parallelize(model, mesh, strategies)
        for case, make in (("full", make_sampler), ("short", make_chunked_sampler)):
            sampler = make(model, chunk_size=5, mesh=mesh, strategies=strategies,
                           params_shardings=plan)
            got = sampler(torch.from_numpy(job[f"decode/{case}/prime"]),
                          int(job[f"decode/{case}/length"]),
                          key=torch.from_numpy(job[f"decode/{case}/key"]),
                          top_k=int(job[f"decode/{case}/top_k"]), add_bos=True)
            again = sampler(torch.from_numpy(job[f"decode/{case}/prime"]),
                            int(job[f"decode/{case}/length"]),
                            key=torch.from_numpy(job[f"decode/{case}/key"]),
                            top_k=int(job[f"decode/{case}/top_k"]), add_bos=True)
            out[f"sample/{label}/{case}"] = got.numpy()
            out[f"sample/{label}/{case}/dtype"] = np.array(str(got.dtype))
            out[f"sample/{label}/{case}/every_rank"] = np.array(
                same_on_every_rank(got.tolist()))
            out[f"sample/{label}/{case}/repeat"] = np.array(torch.equal(got, again))


def step_case(job, out) -> None:
    """One decode step under ``fsdp`` on 4 ranks after a meshed prefill:
    its logits, to hold against the unsharded step's."""
    from progen_tpu_torch.core.mesh import MeshConfig, make_mesh
    from progen_tpu_torch.decode.incremental import ProGenDecodeStep
    from progen_tpu_torch.decode.prefill import make_prefiller
    from progen_tpu_torch.parallel.decode import decode_mesh
    from progen_tpu_torch.parallel.sharding import parallelize

    model = decode_model(job)
    parallelize(model, make_mesh(MeshConfig(1, 4, 1, 1)), ("fsdp",))
    view = decode_mesh(model)
    tokens = torch.from_numpy(job["decode/step/tokens"])
    lengths = torch.from_numpy(job["decode/step/lengths"])
    _, caches = make_prefiller(model, view)(tokens, lengths, decode_len=int(job["decode/step/len"]))
    logits, _ = ProGenDecodeStep(model, view)(tokens[:, 0], lengths, caches)
    out["step/fsdp4/logits"] = logits.numpy()


def refusal_cases(job, out) -> None:
    """What the sampler refuses, each message kept."""
    from progen_tpu_torch.core.mesh import MeshConfig, make_mesh
    from progen_tpu_torch.decode.sampler import make_sampler
    from progen_tpu_torch.parallel.sharding import parallelize

    mesh = make_mesh(MeshConfig(1, 2, 2, 1))
    cases = {"unplaced": lambda: make_sampler(decode_model(job), mesh=mesh,
                                              strategies=("fsdp", "tp"))}
    placed = decode_model(job)
    plan = parallelize(placed, mesh, ("fsdp", "tp"))
    other = make_mesh(MeshConfig(2, 1, 2, 1))
    cases["strategies"] = lambda: make_sampler(placed, mesh=mesh, strategies=("tp",))
    cases["mesh"] = lambda: make_sampler(placed, mesh=other, strategies=("fsdp", "tp"))
    cases["no_mesh"] = lambda: make_sampler(placed)
    cases["plan"] = lambda: make_sampler(placed, mesh=mesh, strategies=("fsdp", "tp"),
                                         params_shardings=dataclasses.replace(plan))
    for name, call in cases.items():
        try:
            call()
            out[f"refused/{name}"] = np.array("")
        except ValueError as e:
            out[f"refused/{name}"] = np.array(str(e))


def engine_cases(job, out) -> None:
    """The meshed engine in each mode on the (fsdp, tp) mesh, twice where
    its determinism is checked; a LoRA bank under tp; reloads, into a copy
    and in place."""
    from progen_tpu_torch.core.mesh import MeshConfig, make_mesh
    from progen_tpu_torch.decode.engine import ServingEngine
    from progen_tpu_torch.parallel.sharding import parallelize
    from progen_tpu_torch.workloads.lora import random_lora_bank

    requests = json.loads(str(job["decode/requests"]))
    mesh, strategies = make_mesh(MeshConfig(1, 2, 2, 1)), ("fsdp", "tp")
    model = decode_model(job)
    parallelize(model, mesh, strategies)
    for mode, kwargs in ENGINE_MODES.items():
        for run in range(2 if mode in ("dense", "int8") else 1):
            engine = ServingEngine(model, mesh=mesh, strategies=strategies, **ENGINE_KW,
                                   **kwargs)
            got = engine_answers(engine, requests)
            out[f"engine/{mode}/{run}"] = np.array(json.dumps(got))
            out[f"engine/{mode}/{run}/every_rank"] = np.array(same_on_every_rank(got))
            if engine.paged:
                pool = engine._pool
                out[f"engine/{mode}/{run}/pool_returned"] = np.array(
                    pool.free_pages + pool.cached_pages == pool.capacity)
            if mode == "dense" and run == 0:
                engine.close()
                out["engine/restored"] = np.array(json.dumps(
                    restored_answers(model, mesh, strategies, requests)))
                engine = ServingEngine(model, mesh=mesh, strategies=strategies, **ENGINE_KW)
                embed = engine_embeds(engine, requests)
                out["engine/embed"] = embed
                # new weights: the job's, scaled, as a whole state dict
                state = {k[len("decode/params/"):]: torch.from_numpy(v) * 0.5
                         for k, v in job.items() if k.startswith("decode/params/")}
                engine.reload_weights(state)
                out["engine/reloaded"] = np.array(json.dumps(engine_answers(engine, requests)))
                # the engine now serves a model of its own: written in place
                engine.reload_weights({k: v * 2 for k, v in state.items()})
                out["engine/reloaded_back"] = np.array(json.dumps(
                    engine_answers(engine, requests)))
            if mode == "int8" and run == 1:  # its own int8 model: buffers written in place
                engine.reload_weights({k[len("decode/params/"):]: torch.from_numpy(v) * 0.5
                                       for k, v in job.items()
                                       if k.startswith("decode/params/")})
                out["engine/int8/reloaded"] = np.array(json.dumps(
                    engine_answers(engine, requests)))
            engine.close()
    tp_mesh = make_mesh(MeshConfig(1, 1, 4, 1))
    model = decode_model(job)
    parallelize(model, tp_mesh, ("tp",))
    bank = random_lora_bank(model.config, int(job["decode/lora/tenants"]),
                            int(job["decode/lora/rank"]), seed=int(job["decode/lora/seed"]),
                            device="cpu")
    lora = json.loads(str(job["decode/lora/requests"]))
    for name, kwargs in (("lora", {"lora_bank": bank}), ("lora_bankless", {})):
        engine = ServingEngine(model, mesh=tp_mesh, strategies=("tp",), **ENGINE_KW, **kwargs)
        reqs = lora if kwargs else [{k: v for k, v in r.items() if k != "tenant"}
                                    for r in lora]
        got = engine_answers(engine, reqs)
        out[f"engine/{name}"] = np.array(json.dumps(got))
        out[f"engine/{name}/every_rank"] = np.array(same_on_every_rank(got))
        engine.close()


def restored_answers(model, mesh, strategies, requests) -> dict:
    """The requests through a meshed dense engine stopped after two steps,
    its snapshot restored on a fresh meshed engine and run to the end."""
    from progen_tpu_torch.decode.engine import Request, ServingEngine

    first = ServingEngine(model, mesh=mesh, strategies=strategies, **ENGINE_KW)
    for r in requests:
        first.submit(Request(**r))
    done = first.step() + first.step()
    snap = first.snapshot()
    first.close()
    second = ServingEngine(model, mesh=mesh, strategies=strategies, **ENGINE_KW)
    second.restore(snap)
    done += second.run_until_idle()
    second.close()
    return {str(c.uid): [int(t) for t in c.tokens] for c in done}


def engine_embeds(engine, requests) -> np.ndarray:
    """The engine's embeddings of the requests' primes, in uid order."""
    from progen_tpu_torch.decode.engine import Request

    for r in requests:
        engine.submit_embed(Request(uid=r["uid"], tokens=r["tokens"], workload="embed"))
    done = sorted(engine.run_until_idle(), key=lambda c: c.uid)
    return np.stack([c.embedding for c in done])


def trainer_case(job, out) -> None:
    """The Trainer's sample hook on the (fsdp, tp) mesh: the string it logs."""
    import contextlib
    import io

    from progen_tpu_torch.core.mesh import MeshConfig
    from progen_tpu_torch.models.progen import ProGenConfig
    from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = TrainerConfig(**json.loads(str(job["decode/trainer/config"])),
                        mesh=MeshConfig(1, 2, 2, 1), strategies=("fsdp", "tp"))
    trainer = Trainer(ProGenConfig(**json.loads(str(job["decode/trainer/model"]))), cfg,
                      str(job["decode/trainer/data"]), str(job["decode/trainer/ckpt"]),
                      device="cpu")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer._sample_and_log(job["decode/trainer/batch"], 0)
    trainer.close()
    lines = [json.loads(line) for line in printed.getvalue().splitlines()]
    out["trainer/sample"] = np.array(json.dumps([r.get("sample") for r in lines]))
    out["trainer/has_sample_model"] = np.array(hasattr(trainer, "sample_model"))


def decode_job(job, out) -> None:
    sampler_cases(job, out)
    step_case(job, out)
    refusal_cases(job, out)
    engine_cases(job, out)
    trainer_case(job, out)


def slabs_job(job, out) -> None:
    """A replica group's slab frames: each rank of a ``tensor`` = WORLD mesh
    reads its shard's slab of every frame of the job
    (``deserialize_handle_sharded``, with the group's vote); every rank's
    leaves are gathered to rank 0 as ``MODE/FRAME/RANK/PATH``.  Then the
    last rank alone gets a corrupt slab: ``corrupt/RANK`` records that the
    vote made every rank raise ``FrameCorrupt``."""
    from progen_tpu_torch.core.mesh import MeshConfig, make_mesh
    from progen_tpu_torch.decode.handoff import (
        FrameCorrupt,
        _flatten_state,
        deserialize_handle_sharded,
    )
    from progen_tpu_torch.serve.worker import _group_all_ok

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(MeshConfig(1, 1, world, 1))
    frames = sorted({k.rsplit("/", 1)[0] for k in job if k.startswith("slab/")})
    for name in frames:
        h = deserialize_handle_sharded(bytes(job[f"{name}/{rank}"]), mesh,
                                       vote=_group_all_ok)
        mine = {p: t.numpy() for p, t in _flatten_state(h.state)}
        every = [None] * world
        dist.all_gather_object(every, mine)
        for r, leaves in enumerate(every):
            for p, a in leaves.items():
                out[f"{name[len('slab/'):]}/{r}/{p}"] = a
    slab = bytearray(job[f"{frames[0]}/{rank}"])
    if rank == world - 1:
        slab[-1] ^= 0xFF  # the payload's last byte: its CRC fails
    try:
        deserialize_handle_sharded(bytes(slab), mesh, vote=_group_all_ok)
        raised = False
    except FrameCorrupt:
        raised = True
    every = [None] * world
    dist.all_gather_object(every, raised)
    for r, flag in enumerate(every):
        out[f"corrupt/{r}"] = np.array(flag)


JOBS = {"train": train_job, "decode": decode_job, "slabs": slabs_job}


def rank_main(rank: int, job_path: str, out_path: str, world: int, store: str,
              kind: str = "train") -> None:
    from progen_tpu_torch.core.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{store}", world_size=world,
                           rank=rank)
    job = dict(np.load(job_path))
    out: dict = {}
    JOBS[kind](job, out)
    dist.barrier()
    if rank == 0:
        np.savez(out_path, **{k: v.detach().numpy() if torch.is_tensor(v) else v
                              for k, v in out.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    job_path, out_path, world, store = sys.argv[1:5]
    kind = sys.argv[5] if len(sys.argv) > 5 else "train"
    mp.spawn(rank_main, args=(job_path, out_path, int(world), store, kind),
             nprocs=int(world))
