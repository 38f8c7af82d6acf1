"""Parallelism as rule tables over one mesh (ported from
progen_tpu/parallel/sharding.py), made into placements on
``torch.distributed``.

The JAX package maps each parameter's LOGICAL axis names onto the four mesh
axes of ``core/mesh.py`` and lets GSPMD partition.  The port keeps the same
tables (:data:`RULE_SETS`, :func:`logical_rules`) and the same logical axes
per parameter (:data:`PARAM_AXES`) and carries them out itself:

* ``dp`` -- the batch over ``(data, fsdp)``; parameters replicated, their
  gradients summed over the batch ranks (:func:`reduce_gradients`);
* ``fsdp`` -- FSDP2 ``fully_shard`` per block and at the root over the
  ``(data, fsdp)`` dims (replicated over ``data``, sharded over ``fsdp``),
  each parameter on the dim the table names (``embed``, ``vocab``,
  ``spatial_row``, ``mlp_in``; dim 0 where it names none, since FSDP2 shards
  every parameter it manages);
* ``tp`` -- the ``qkv`` and ``mlp`` dims over ``tensor``, as ``DTensor``
  parameters on the mesh's ``tensor`` dim: ``to_qkv`` and ``ff.proj_in``
  column-parallel, ``attn.to_out`` and ``ff.proj_out`` row-parallel,
  ``sgu.proj_out`` ``("mlp_in", "mlp")`` (its output channels); the model
  runs each rank's heads and channels with the collectives of
  ``parallel/tensor.py``.  Composed with ``fsdp`` FSDP2 shards each rank's
  part further (2-D sharding);
* ``sp`` -- activations split along the sequence over ``seq`` (the model's
  own business, ``models/progen.py``); the SGU's spatial weights and biases
  row-sharded over ``seq``, as ``DTensor`` parameters.  ``sp`` is merged
  first, so ``spatial_row -> seq`` beats ``fsdp``'s ``spatial_row -> fsdp``.

**Packed projections under ``tp``.**  ``to_qkv``'s output is ``[q|k|v]``
and a GEGLU's or an SGU layer's ``proj_in`` output ``[x|gate]``
(``[res|gate]``): a contiguous split of such a dim would give rank 0 all of
q and half of k.  So a packed parameter is held on the device in a
rank-grouped layout, ``[q_0|k_0|v_0|q_1|k_1|v_1|...]``, whose contiguous
shards are each rank's matching pieces (``Dense.packed`` names the pieces).
:func:`full_tensor` and :func:`load_full` take the pieces and undo or make
that layout, so a checkpoint keeps the store's one layout and restores at
any world size and without a mesh.

Every rank builds the model with the same full values (the same seed, or the
same converted parameters) BEFORE :func:`parallelize` shards it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from progen_tpu_torch.core.mesh import MESH_AXES, mesh_sizes, process_batch_shards

# Each rule set: logical axis -> mesh axis (or tuple of mesh axes, or None).
RULE_SETS: dict[str, list[tuple[str, Any]]] = {
    "dp": [
        ("act_batch", ("data", "fsdp")),
    ],
    "fsdp": [
        ("act_batch", ("data", "fsdp")),
        ("embed", "fsdp"),
        ("vocab", "fsdp"),
        ("spatial_row", "fsdp"),
        ("mlp_in", "fsdp"),
    ],
    "tp": [
        ("act_batch", ("data", "fsdp")),
        ("qkv", "tensor"),
        ("mlp", "tensor"),
        ("act_heads", "tensor"),
        ("act_mlp", "tensor"),
    ],
    "sp": [
        ("act_batch", ("data", "fsdp")),
        ("act_seq", "seq"),
        ("spatial_row", "seq"),
    ],
}
STRATEGIES = ("dp", "fsdp", "tp", "sp")  # the ones the port places


def logical_rules(strategies: Sequence[str] = ("dp",)) -> list[tuple[str, Any]]:
    """Merge rule sets; first occurrence of a logical axis wins, with ``sp``
    merged FIRST whatever its position."""
    ordered = [s for s in strategies if s == "sp"]
    ordered += [s for s in strategies if s != "sp"]
    merged: list[tuple[str, Any]] = []
    seen: set[str] = set()
    for s in ordered:
        for name, axis in RULE_SETS[s]:
            if name not in seen:
                merged.append((name, axis))
                seen.add(name)
    return merged


def validate_tp_divisibility(model_config, tensor_size: int,
                             strategies: Sequence[str] = ("tp",)) -> None:
    """Fail early when a tensor axis cannot divide the model dims that the
    tp rule set column-shards; a no-op when tp isn't requested or the axis
    is trivial."""
    if "tp" not in strategies or tensor_size <= 1:
        return
    cfg = model_config
    dims: list[tuple[str, int]] = [
        ("heads", cfg.heads),
        ("attention inner dim (heads*dim_head)", cfg.heads * cfg.dim_head),
    ]
    seen_hidden: set[int] = set()
    for i in range(cfg.depth):
        gmlp = cfg.layer_uses_gmlp(i)
        hidden = cfg.dim * cfg.ff_mult * (1 if gmlp or not cfg.ff_glu else 2)
        if hidden not in seen_hidden:
            seen_hidden.add(hidden)
            dims.append((f"ff hidden dim (layer {i})", hidden))
        if gmlp:
            half = (cfg.dim * cfg.ff_mult) // 2
            if half not in seen_hidden:
                seen_hidden.add(half)
                dims.append((f"sgu half dim (layer {i})", half))
    bad = [(name, size) for name, size in dims if size % tensor_size]
    if bad:
        details = ", ".join(f"{name}={size}" for name, size in bad)
        raise ValueError(
            f"tensor axis size {tensor_size} does not divide the model's "
            f"tp-sharded dims: {details}. Pick a tensor size that divides "
            "all of them (or drop 'tp' from strategies).")


# Each parameter's logical axes as the JAX model declares them
# (progen_tpu/models/progen.py), by the suffix of its name here, with the
# dim of the port's tensor each one is: a flax kernel is (in, out), an
# nn.Linear weight (out, in).
PARAM_AXES: tuple[tuple[str, tuple[str | None, ...], tuple[int, ...]], ...] = (
    ("embed.weight", ("vocab", "embed"), (0, 1)),
    ("to_qkv.weight", ("embed", "qkv"), (1, 0)),
    ("attn.{i}.to_out.weight", ("qkv", "embed"), (1, 0)),
    ("attn.{i}.to_out.bias", ("embed",), (0,)),
    ("ff.{i}.proj_in.weight", ("embed", "mlp"), (1, 0)),
    ("ff.{i}.proj_in.bias", ("mlp",), (0,)),
    ("sgu.proj_out.weight", ("mlp_in", "mlp"), (1, 0)),
    ("sgu.proj_out.bias", ("mlp",), (0,)),
    ("ff.{i}.proj_out.weight", ("mlp", "embed"), (1, 0)),
    ("ff.{i}.proj_out.bias", ("embed",), (0,)),
    ("spatial_weights", ("spatial_row", "spatial_col"), (0, 1)),
    ("spatial_biases", ("spatial_row", None), (0, 1)),
    ("norm.scale", ("norm",), (0,)),
    ("norm_out.scale", ("norm",), (0,)),
    ("to_logits.weight", ("embed", "vocab"), (1, 0)),
    ("to_logits.bias", ("vocab",), (0,)),
)


def param_logical_axes(name: str) -> tuple[tuple[str | None, ...], tuple[int, ...]]:
    """The JAX logical axes of the port's parameter ``name`` and the dim of
    its tensor each one is."""
    parts = name.split(".")
    # "attn.3.to_out.weight" -> "attn.{i}.to_out.weight"
    generic = ".".join("{i}" if p.isdigit() else p for p in parts)
    for suffix, axes, dims in PARAM_AXES:
        if generic.endswith(suffix):
            return axes, dims
    raise KeyError(f"no logical axes for parameter {name!r}")


def mesh_axes_of(name: str, strategies: Sequence[str]) -> dict[int, Any]:
    """``{tensor dim: mesh axis}`` of parameter ``name`` under
    ``strategies``, by flax's rule priority (``flax.linen.spmd``): rules in
    order, each assigning its mesh axis to its logical axis if that dim is
    still unassigned and the mesh axis still free."""
    axes, dims = param_logical_axes(name)
    assigned: dict[int, Any] = {}
    used: set[str] = set()
    for logical, mesh_axis in logical_rules(strategies):
        if logical not in axes or mesh_axis is None:
            continue
        dim = dims[axes.index(logical)]
        names = set(mesh_axis) if isinstance(mesh_axis, tuple) else {mesh_axis}
        if dim not in assigned and not names & used:
            assigned[dim] = mesh_axis
            used |= names
    return assigned


def replicated(mesh: DeviceMesh) -> tuple:
    """The placements of a tensor every rank holds whole."""
    return (Replicate(),) * mesh.ndim


def param_placements(name: str, mesh: DeviceMesh, strategies: Sequence[str]) -> tuple:
    """The placements over the four-axis mesh of parameter ``name`` under
    ``strategies``: ``Shard(dim)`` on each mesh axis the table gives it,
    ``Replicate()`` elsewhere."""
    out = list(replicated(mesh))
    for dim, axis in mesh_axes_of(name, strategies).items():
        out[MESH_AXES.index(axis)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass
class ParallelPlan:
    """What :func:`parallelize` did to a model: its mesh and strategies,
    the parameters FSDP2 manages, the ones sharded over ``seq``, and the
    pieces of each packed parameter sharded over ``tensor``
    (``{name: pieces}``)."""

    mesh: DeviceMesh
    strategies: tuple[str, ...]
    fsdp_params: frozenset[str]
    seq_params: frozenset[str]
    packed: dict = dataclasses.field(default_factory=dict)

    def size(self, axis: str) -> int:
        return mesh_sizes(self.mesh)[axis]

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def pieces(self, name: str) -> int:
        """The packed pieces of parameter (or gradient, moment) ``name``."""
        return self.packed.get(name, 1)


def check_strategies(strategies: Sequence[str], mesh: DeviceMesh) -> tuple[str, ...]:
    """The strategies as a tuple; names the port does not know raise, and
    so does a tensor axis > 1 without ``tp`` (its ranks would replicate
    work, as the JAX Trainer says)."""
    strategies = tuple(strategies)
    unknown = [s for s in strategies if s not in STRATEGIES]
    if unknown:
        raise ValueError(f"unknown strategies {unknown}; the port places {STRATEGIES}")
    tensor = mesh_sizes(mesh)["tensor"]
    if tensor > 1 and "tp" not in strategies:
        raise ValueError(
            f"mesh has tensor axis {tensor} but 'tp' is not in strategies "
            f"{strategies} — the tensor devices would replicate work; add 'tp' "
            "or set MeshConfig(tensor=1)")
    return strategies


def _fsdp_dim(placement, param: torch.Tensor, shards: int) -> Shard:
    """FSDP2's shard dim of a parameter: the table's ``fsdp`` placement when
    it shards a dim that divides evenly (FSDP2 shards other dims than 0
    only evenly), else dim 0."""
    if placement.is_shard() and param.shape[placement.dim] % shards == 0:
        return placement
    return Shard(0)


def parallelize(model: torch.nn.Module, mesh: DeviceMesh,
                strategies: Sequence[str] = ("dp",)) -> ParallelPlan:
    """Place ``model``'s parameters on ``mesh`` under ``strategies``, in
    place, and hand the model the mesh (its sequence mixing and, under
    ``tp``, its heads and channels then run through ``parallel/context.py``
    and ``parallel/tensor.py``).  Every rank must hold the same full values
    first."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    strategies = check_strategies(strategies, mesh)
    seq_at, fsdp_at = MESH_AXES.index("seq"), MESH_AXES.index("fsdp")
    tensor_at = MESH_AXES.index("tensor")
    placements = {n: param_placements(n, mesh, strategies)
                  for n, _ in model.named_parameters()}
    seq_params: set[str] = set()
    packed: dict[str, int] = {}
    for module_name, module in list(model.named_modules()):
        for attr, p in list(module.named_parameters(recurse=False)):
            name = f"{module_name}.{attr}" if module_name else attr
            if placements[name][seq_at].is_shard():  # sp's spatial_row -> seq
                seq_params.add(name)
                sharded = distribute_tensor(p.data, mesh["seq"], [placements[name][seq_at]])
            elif placements[name][tensor_at].is_shard():  # tp's qkv, mlp -> tensor
                pieces = getattr(module, "packed", 1)
                if pieces > 1:
                    packed[name] = pieces
                full = regroup(p.data, pieces, mesh_sizes(mesh)["tensor"])
                sharded = distribute_tensor(full, mesh["tensor"], [placements[name][tensor_at]])
            else:
                continue
            setattr(module, attr, torch.nn.Parameter(sharded))
    _place_int8(model, mesh, strategies)
    fsdp_params: set[str] = set()
    if "fsdp" in strategies:
        shards = mesh_sizes(mesh)["fsdp"]
        by_id = {id(p): n for n, p in model.named_parameters()}
        ignored = {p for p in model.parameters() if by_id[id(p)] in seq_params}
        kwargs = {"mesh": mesh["data", "fsdp"], "ignored_params": ignored or None,
                  "shard_placement_fn": lambda p: _fsdp_dim(
                      placements[by_id[id(p)]][fsdp_at], p, shards)}
        for block in (*model.attn, *model.ff):
            fully_shard(block, **kwargs)
        fully_shard(model, **kwargs)
        # the decode step's computations run through FSDP2's forward hooks
        # (models/progen.py:Runs)
        for module in (*model.attn, *model.ff, model):
            register_fsdp_forward_method(module, "run")
        fsdp_params = {n for n in by_id.values() if n not in seq_params}
    model.mesh = mesh
    plan = ParallelPlan(mesh, strategies, frozenset(fsdp_params), frozenset(seq_params),
                        packed)
    model.parallel_plan = plan
    return plan


def _place_int8(model: torch.nn.Module, mesh: DeviceMesh, strategies) -> None:
    """Under ``tp``, each rank's part of every int8 serving weight
    (``models/progen.py:QuantDense``, buffers that the loop over parameters
    does not see), with the float weight's placement: a column-parallel
    layer keeps its rows (in the packed rank-grouped layout) and their
    scales; a row-parallel one its columns and the whole scale, which it
    applies after the sum.  The scales were taken from the whole weight.
    A plain tensor, not a DTensor: no gradient, no checkpoint reads it."""
    if mesh_sizes(mesh)["tensor"] == 1:
        return
    for name, module in model.named_modules():
        if hasattr(module, "weight_scale"):
            for attr in ("weight", "weight_scale"):
                setattr(module, attr, _int8_part(module, f"{name}.{attr}",
                                                 getattr(module, attr), mesh, strategies))


def _int8_part(module: torch.nn.Module, name: str, whole: torch.Tensor,
               mesh: DeviceMesh, strategies) -> torch.Tensor:
    """A rank's part of the whole int8 buffer ``name`` (``weight`` or
    ``weight_scale``) of ``module``, as :func:`_place_int8` cuts it."""
    ranks = mesh_sizes(mesh)["tensor"]
    if not hasattr(module, "weight_scale") or ranks == 1:
        return whole
    placement = param_placements(name.removesuffix("_scale"), mesh,
                                 strategies)[MESH_AXES.index("tensor")]
    if not placement.is_shard():
        return whole
    dim = placement.dim
    if name.endswith("_scale") and dim != 0:  # a row-parallel layer's whole scale
        return whole
    pieces = getattr(module, "packed", 1) if dim == 0 else 1
    me = mesh.get_local_rank("tensor")
    return regroup(whole, pieces, ranks).chunk(ranks, dim)[me].contiguous()


@torch.no_grad()
def load_placed(model: torch.nn.Module, state: dict) -> None:
    """Write the whole weights ``state`` (the store's layout, every name of
    ``model.state_dict()``) into the placed ``model`` in place: each
    parameter's shard takes its part (:func:`load_full`), each int8 buffer
    its rank's part (:func:`_place_int8`'s cut).  A collective: every rank
    calls it with the same weights."""
    plan = model.parallel_plan
    params = dict(model.named_parameters())
    buffers = {n: b for n, b in model.named_buffers() if n in state}
    if set(state) != set(params) | set(buffers):
        raise ValueError(f"the weights' names differ from the model's: missing "
                         f"{sorted(set(params) | set(buffers) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(params) - set(buffers))}")
    for name, p in params.items():
        load_full(p, state[name], plan.pieces(name))
    modules = dict(model.named_modules())
    for name, b in buffers.items():
        module = modules[name.rpartition(".")[0]]
        b.copy_(_int8_part(module, name, state[name], plan.mesh, plan.strategies))


def regroup(t: torch.Tensor, pieces: int, parts: int, inverse: bool = False) -> torch.Tensor:
    """``t`` packed as ``pieces`` equal pieces along dim 0 (``[q|k|v]``),
    reordered into ``parts`` rank groups, ``[q_0|k_0|v_0|q_1|...]``, whose
    contiguous ``parts``-way split gives each rank its matching pieces;
    ``inverse`` undoes it.  The identity for one piece or one part."""
    if pieces == 1 or parts == 1:
        return t
    rows = t.shape[0] // (pieces * parts)
    outer = (parts, pieces) if inverse else (pieces, parts)
    return t.reshape(*outer, rows, *t.shape[1:]).transpose(0, 1).reshape(t.shape)


def _tensor_parts(t: torch.Tensor) -> int:
    """How many ways a DTensor is sharded over the mesh's ``tensor`` dim."""
    if not isinstance(t, DTensor):
        return 1
    names = t.device_mesh.mesh_dim_names or ()
    if "tensor" not in names:
        return 1
    at = names.index("tensor")
    return t.device_mesh.size(at) if t.placements[at].is_shard() else 1


def local(t: torch.Tensor) -> torch.Tensor:
    """A rank's own part of ``t``: the local shard of a DTensor, ``t``
    otherwise (its storage either way, so an in-place write lands)."""
    return t.to_local() if isinstance(t, DTensor) else t


def _all_reduce_flat(tensors: list[torch.Tensor], group) -> None:
    """Sum ``tensors`` (one dtype) over ``group`` in place, in one call."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


@torch.no_grad()
def reduce_gradients(plan: ParallelPlan, params: dict[str, torch.Tensor]) -> None:
    """After the backward of each rank's loss: every rank's gradients become
    those of the global batch's loss, a mean over the batch ranks of their
    row means (each rank's loss is its rows' mean).  A ``seq`` rank's
    gradient is its slice's share, so they are summed over ``seq`` except
    for the parameters sharded over it (each rank owns its rows).  FSDP2
    has already averaged its parameters' over ``(data, fsdp)``; the others
    are summed and divided here.  The sum over the batch ranks is what the
    TPU kernel K2-dW's ``reduce_axes`` can do inside the kernel
    (``pallas_sgu.py:307-343``)."""
    batch = [a for a in ("data", "fsdp") if plan.size(a) > 1]
    seq = plan.size("seq") > 1
    over_seq, over_batch = [], []
    for name, p in params.items():
        if p.grad is None:
            continue
        g = local(p.grad)
        if seq and name not in plan.seq_params:
            over_seq.append(g)
        if batch and name not in plan.fsdp_params:
            over_batch.append(g)
    if seq:
        _all_reduce_flat(over_seq, plan.group("seq"))
    for axis in batch:
        _all_reduce_flat(over_batch, plan.group(axis))
    if batch:
        ranks = math.prod(plan.size(a) for a in batch)
        for g in over_batch:
            g.div_(ranks)


@torch.no_grad()
def batch_mean(t: torch.Tensor, plan: ParallelPlan) -> torch.Tensor:
    """The mean of ``t`` over the batch ranks (a rank's value for its rows;
    equal batch shards), the same on every rank."""
    batch = [a for a in ("data", "fsdp") if plan.size(a) > 1]
    if not batch:
        return t
    t = t.detach().clone()
    for axis in batch:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=plan.group(axis))
    return t / math.prod(plan.size(a) for a in batch)


def sharded_dims(t: torch.Tensor) -> tuple[str, ...]:
    """The mesh axes a DTensor is sharded over (none for a plain tensor);
    FSDP2's strided shard of a tensor-sharded dim counts (it answers False
    to ``is_shard()``)."""
    if not isinstance(t, DTensor):
        return ()
    names = t.device_mesh.mesh_dim_names
    return tuple(n for n, pl in zip(names, t.placements)
                 if not (pl.is_replicate() or pl.is_partial()))


def global_sum_of_squares(tensors: dict[str, torch.Tensor]) -> torch.Tensor:
    """``sum of t**2`` over every tensor, in f32, each distinct element
    counted once over all ranks: a shard's sum is added up over the ranks
    that hold the other shards, a replicated tensor counted as it is."""
    by_dims: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors.values():
        by_dims.setdefault((sharded_dims(t), _mesh_of(t)), []).append(local(t))
    total = None
    for (dims, mesh), parts in by_dims.items():
        s = sum(torch.sum(p.float() * p.float()) for p in parts)
        for axis in dims:
            if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
                dist.all_reduce(s, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
        total = s if total is None else total + s
    return total


def _mesh_of(t: torch.Tensor):
    return t.device_mesh if isinstance(t, DTensor) else None


def full_tensor(t: torch.Tensor, pieces: int = 1) -> torch.Tensor:
    """The whole value of ``t`` on every rank (a collective for a DTensor:
    every rank must call it, in the same order), in the store's layout:
    a packed tensor's ``pieces`` (:attr:`ParallelPlan.packed`) are put back
    in order."""
    if not isinstance(t, DTensor):
        return t
    return regroup(t.full_tensor(), pieces, _tensor_parts(t), inverse=True)


@torch.no_grad()
def load_full(dst: torch.Tensor, full: torch.Tensor, pieces: int = 1) -> None:
    """Copy the whole value ``full`` (the store's layout) into ``dst``, a
    DTensor's local shard taking its own part (a packed one in its rank's
    layout)."""
    if isinstance(dst, DTensor):
        full = regroup(full.to(dst.device), pieces, _tensor_parts(dst))
        part = distribute_tensor(full, dst.device_mesh, dst.placements)
        local(dst).copy_(local(part))
    else:
        dst.copy_(full)


def batch_sharding(mesh: DeviceMesh, batch: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a global ``batch``: the contiguous block at its
    batch coordinate, as JAX lays a batch out over ``('data', 'fsdp')``."""
    count, index = process_batch_shards(mesh)
    rows = batch.shape[dim]
    if rows % count:
        raise ValueError(f"global batch {rows} does not split over {count} batch shards")
    per = rows // count
    return batch.narrow(dim, index * per, per)
