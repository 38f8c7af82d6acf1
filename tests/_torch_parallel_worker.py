"""The ranks of one CPU ``gloo`` world for ``tests/test_torch_parallel.py``.

    python tests/_torch_parallel_worker.py JOB.npz OUT.npz WORLD STORE

starts WORLD ranks with ``torch.multiprocessing``, their process group at
``file://STORE``, and runs every case of the job on the meshes
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


def rank_main(rank: int, job_path: str, out_path: str, world: int, store: str) -> None:
    from progen_tpu_torch.core.mesh import MeshConfig, initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{store}", world_size=world,
                           rank=rank)
    job = dict(np.load(job_path))
    out: dict = {}
    for label, sizes in MESHES.items():
        MESH_CACHE[label] = make_mesh(MeshConfig(*sizes))
    attention_cases(job, MESH_CACHE["seq4"], out)
    gate_cases(job, MESH_CACHE["seq4"], out)
    for label in ("fsdp4", "dp4"):
        sharded_sgu_case(job, MESH_CACHE[label], label, out)
    for label, (strategies, key) in TRAIN_STEPS.items():
        train_step_case(job, MESH_CACHE[label], label, strategies, out, key)
    dist.barrier()
    if rank == 0:
        np.savez(out_path, **{k: v.detach().numpy() if torch.is_tensor(v) else v
                              for k, v in out.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    job_path, out_path, world, store = sys.argv[1:5]
    mp.spawn(rank_main, args=(job_path, out_path, int(world), store), nprocs=int(world))
