"""Tensor parallelism over the mesh's ``tensor`` dim: the collectives that
the JAX package's GSPMD inserts around the ``tp`` rule set's shardings
(``progen_tpu/parallel/sharding.py``: ``qkv``, ``mlp``, ``act_heads`` and
``act_mlp`` over ``tensor``), written out as autograd functions.

Each rank holds its heads' columns of ``to_qkv``, its channels of
``ff.proj_in`` and ``sgu.proj_out`` (column-parallel) and the matching rows
of ``attn.to_out`` and ``ff.proj_out`` (row-parallel); the residual stream,
the LayerNorms, the embedding and the logits head are whole on every rank.
``models/progen.py`` calls:

* :func:`copy_to` where a whole tensor enters a rank's part of the work
  (identity forward, gradients summed over the group backward), so the
  gradients of what produced it (the norms, the embedding, the shift's
  inputs, a replicated parameter read by a rank's channels) are whole on
  every rank;
* :func:`reduce_from` on a row-parallel projection's partial output (a sum
  over the group forward, identity backward), before its bias is added
  once;
* :func:`gather_from` where a rank's channels feed a projection that reads
  every channel (``sgu.proj_out``, ``("mlp_in", "mlp")``): an all-gather
  forward, a reduce-scatter backward;
* :func:`sum_over` for the statistics of the SGU's LayerNorm over its gate
  channels (a sum forward and backward).

A group of one rank (``tensor`` 1) makes every one of them the identity and
no collective is issued.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def tensor_split(mesh) -> tuple[int, object]:
    """``(ranks, group)`` of ``mesh``'s ``tensor`` dim; ``(1, None)``
    without a mesh or when the dim has one rank."""
    if mesh is None:
        return 1, None
    ranks = mesh.size(mesh.mesh_dim_names.index("tensor"))
    return (ranks, mesh.get_group("tensor")) if ranks > 1 else (1, None)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    """All-gather along the last dim; the backward sums the whole gradient
    over the group and keeps this rank's channels."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        parts = x.movedim(-1, 0).contiguous()
        out = torch.empty((n * parts.shape[0], *parts.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, parts, group=group)
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        whole = grad.movedim(-1, 0).contiguous()
        out = torch.empty((whole.shape[0] // n, *whole.shape[1:]), dtype=grad.dtype,
                          device=grad.device)
        dist.reduce_scatter_tensor(out, whole, op=dist.ReduceOp.SUM, group=ctx.group)
        return out.movedim(0, -1), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOver.apply(x, group)


def rank_slice(width: int, mesh) -> slice:
    """This rank's channels of a ``width``-wide dim split over ``tensor``."""
    ranks, _ = tensor_split(mesh)
    if ranks == 1:
        return slice(0, width)
    part = width // ranks
    at = mesh.get_local_rank("tensor") * part
    return slice(at, at + part)
