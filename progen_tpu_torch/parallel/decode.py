"""Decode under a mesh: the sampler, the prefill, the decode step and the
serving engine run a model that :func:`~progen_tpu_torch.parallel.sharding.parallelize`
placed, in its training shardings (the port of the JAX package's mesh-aware
decode, ``progen_tpu/decode/sampler.py:138-160``, where the params "STAY in
their training shardings").

Every rank decodes every row: a decode batch is small, so the JAX package
replicates everything but the tensor-split state
(``progen_tpu/decode/prefill.py:_constrain_caches``).  Per strategy:

* ``tp`` -- a layer runs its rank's heads and gate channels, with the
  collectives of ``parallel/tensor.py``; the k/v rings hold the rank's
  heads, the gate caches or the page pool the rank's channels;
* ``fsdp`` -- the decode step never calls a block's ``forward``: it runs
  each block's computation, and the root's embedding and logits head,
  through the module's ``run`` (``models/progen.py:Runs``), which
  ``parallelize`` registers with FSDP2 as a forward method.  FSDP2's own
  pre- and post-forward then unshard the module around it (with the
  all-gather streams ordered after the compute stream, as in a
  ``forward``) and reshard it after: a block's parameters are whole on a
  rank only while that block runs.  Explicit ``unshard()``/``reshard()``
  calls outside a forward skip that stream ordering;
* ``sp`` -- the ``seq`` ranks decode as replicas: the prefill runs the
  whole prime on each rank, with no sequence split.  :class:`DecodeMesh`
  is the mesh as decode sees it (its ``seq`` dim reads as one rank) and
  holds the SGU's spatial weights gathered whole, once per sampler call or
  engine build;
* ``dp`` -- nothing to do: the parameters are whole on every rank.

:func:`check_placed` holds a model to the mesh, strategies and plan a
caller names, as the sampler and the engine take them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from progen_tpu_torch.parallel.sharding import full_tensor
from progen_tpu_torch.parallel.tensor import rank_slice, tensor_split


class DecodeMesh:
    """A placed model's mesh as decode sees it: the same groups, but the
    ``seq`` dim reads as one rank (its ranks decode as replicas), and the
    SGUs' spatial weights and biases gathered whole (``spatial``: SGU
    module id -> ``(weights, biases)``; empty when no parameter is sharded
    over ``seq``).  It answers what the model's forward asks of a mesh
    (``mesh_dim_names``, ``size``, ``get_group``, ``get_local_rank``)."""

    def __init__(self, mesh: DeviceMesh, spatial: dict):
        self.device_mesh = mesh
        self.mesh_dim_names = mesh.mesh_dim_names
        self.spatial = spatial

    def size(self, dim: int) -> int:
        return 1 if self.mesh_dim_names[dim] == "seq" else self.device_mesh.size(dim)

    def get_group(self, name: str):
        return self.device_mesh.get_group(name)

    def get_local_rank(self, name: str) -> int:
        return 0 if name == "seq" else self.device_mesh.get_local_rank(name)


def decode_mesh(model) -> DecodeMesh | None:
    """The decode view of a placed ``model`` (``None`` for a model no mesh
    placed).  Under ``sp`` it gathers every SGU's spatial weights and biases
    whole: a collective, so every rank calls it, in the same order."""
    plan = getattr(model, "parallel_plan", None)
    if plan is None:
        return None
    return DecodeMesh(plan.mesh, _gather_spatial(model) if plan.seq_params else {})


def refresh(view: DecodeMesh | None, model) -> None:
    """Gather ``model``'s spatial weights and biases into ``view`` again, in
    place, after new weights were written into the placed model: a
    captured program goes on reading the view's tensors.  Nothing to do
    without a ``seq`` split; a collective with one."""
    if view is None or not view.spatial:
        return
    with torch.no_grad():
        for key, tensors in _gather_spatial(model).items():
            for mine, new in zip(view.spatial[key], tensors):
                mine.copy_(new)


@torch.no_grad()
def _gather_spatial(model) -> dict:
    """SGU module id -> its ``(spatial_weights, spatial_biases)`` whole."""
    return {id(ff.sgu): (full_tensor(ff.sgu.spatial_weights.detach()),
                         full_tensor(ff.sgu.spatial_biases.detach()))
            for ff in model.ff if ff.sgu is not None}


def check_placed(model, mesh: DeviceMesh | None, strategies: Sequence[str],
                 params_shardings=None) -> None:
    """Hold ``model`` to the caller's ``mesh``, ``strategies`` and
    ``params_shardings`` (the ``ParallelPlan`` that ``parallelize``
    returned): a model the mesh has not placed, a placed model without its
    mesh, and a mesh, strategies or plan that differ from the model's plan
    each raise ``ValueError`` naming both sides."""
    plan = getattr(model, "parallel_plan", None)
    if mesh is None:
        if plan is not None:
            raise ValueError(
                f"the model is placed on mesh {plan.mesh} under strategies "
                f"{plan.strategies}, but no mesh was given: pass mesh= and "
                "strategies= of its plan")
        if params_shardings is not None:
            raise ValueError("params_shardings without a mesh: pass the mesh it places on")
        return
    if plan is None:
        raise ValueError(
            f"mesh {mesh} given, but the model is not placed on it: call "
            "parallel.sharding.parallelize(model, mesh, strategies) first")
    if mesh != plan.mesh:
        raise ValueError(f"mesh {mesh} differs from the mesh the model is placed on, "
                         f"{plan.mesh}")
    if set(strategies) != set(plan.strategies):
        raise ValueError(f"strategies {tuple(strategies)} differ from the model's "
                         f"plan's, {plan.strategies}")
    if params_shardings is not None and params_shardings is not plan:
        raise ValueError(
            f"params_shardings (mesh {getattr(params_shardings, 'mesh', None)}, "
            f"strategies {getattr(params_shardings, 'strategies', None)}) is not the "
            f"plan the model is placed by (mesh {plan.mesh}, strategies "
            f"{plan.strategies})")


def shard_bank(bank: dict, mesh) -> dict:
    """A rank's part of a LoRA bank under ``mesh``'s ``tensor`` dim (the
    bank itself without one), as the model reads it there: the
    column-parallel ``qkv`` site's ``b`` columns in the packed rank-grouped
    layout (``[q_r|k_r|v_r]``), the row-parallel ``out`` site's ``a`` rows
    of the rank's heads (its partial products are summed over the group),
    and the ``sgu`` site's ``b`` columns of the rank's ``sgu.proj_out``
    outputs (its ``a`` reads the gathered mix whole)."""
    ranks, _ = tensor_split(mesh)
    if ranks == 1:
        return bank
    out = {}
    for layer, sites in bank.items():
        out[layer] = {}
        for name, site in sites.items():
            a, b = site["a"], site["b"]
            if name == "qkv":
                width = b.shape[-1] // 3
                at = rank_slice(width, mesh)
                b = torch.cat([b[..., i * width:(i + 1) * width][..., at]
                               for i in range(3)], -1)
            elif name == "out":
                a = a[:, rank_slice(a.shape[1], mesh)]
            elif name == "sgu":
                b = b[..., rank_slice(b.shape[-1], mesh)]
            out[layer][name] = {"a": a.contiguous(), "b": b.contiguous()}
    return out
