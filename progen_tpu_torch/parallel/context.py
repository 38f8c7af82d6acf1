"""Context (sequence) parallelism over the mesh's ``seq`` dim (ported from
progen_tpu/parallel/context.py).

Each rank holds a contiguous slice of the sequence, ``L_local = L / seq``
rows, and the model's two sequence-mixing structures exchange what crosses
a slice boundary:

* windowed attention: a query window needs ``[previous window ‖ own
  window]`` keys, so a slice needs ONE window of keys and values from its
  left neighbour, a point-to-point send per layer (:func:`left_halo`);
  the leftmost slice gets zeros, the phantom window.  The K1 kernels take
  it as their halo (``ops/cuda_attention.py``), and the backward sends the
  halo's gradient back to the neighbour, which adds it to its last window's;
* the SGU's spatial mix: output row m mixes every gate row n <= m, so the
  gate is all-gathered over ``seq`` (its backward a reduce-scatter) while
  the ``(L, L)`` weights stay row-sharded; the causal mask uses GLOBAL row
  indices.

Every tensor here is a rank's own slice; there is no global array.  JAX's
``attn_impl`` switch is not ported, so :func:`cp_local_attention` is
:func:`sharded_local_attention` under its JAX name.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from progen_tpu_torch.ops import cuda_attention, cuda_sgu


def _neighbour_exchange(t: torch.Tensor, group, to_right: bool) -> torch.Tensor:
    """Send ``t`` to the next rank of ``group`` (``to_right``) or the
    previous one and return what the other neighbour sent; zeros where there
    is no such neighbour."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    src, dst = (me - 1, me + 1) if to_right else (me + 1, me - 1)
    t = t.contiguous()
    out = torch.zeros_like(t)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _LeftHalo(torch.autograd.Function):
    """Each rank's ``last`` goes to its right neighbour; a rank gets its left
    neighbour's (zeros on the leftmost).  The backward sends the halo's
    gradient left, where it is the gradient of ``last``."""

    @staticmethod
    def forward(ctx, last, group):
        ctx.group = group
        return _neighbour_exchange(last, group, to_right=True)

    @staticmethod
    def backward(ctx, grad):
        return _neighbour_exchange(grad, ctx.group, to_right=False), None


def left_halo(last: torch.Tensor, mesh: DeviceMesh, seq_axis: str = "seq") -> torch.Tensor:
    """The left neighbour's ``last`` over the mesh's ``seq`` dim (zeros on
    the leftmost rank and without a sequence split), differentiable."""
    if mesh.size(mesh.mesh_dim_names.index(seq_axis)) == 1:
        return torch.zeros_like(last)
    return _LeftHalo.apply(last, mesh.get_group(seq_axis))


def _haloed_windows(k_loc, v_loc, window_size: int, mesh: DeviceMesh,
                    seq_axis: str = "seq"):
    """The halo of a rank's ``(B, H, L_local, D)`` keys and values: their
    left neighbour's last window, ``(k_halo, v_halo)`` ``(B, H, wsz, D)``."""
    n_loc = k_loc.shape[2]
    wsz = window_size
    if n_loc % wsz != 0:
        raise ValueError(
            f"local sequence {n_loc} must be divisible by window {wsz}; "
            "choose a seq-axis size that keeps whole windows per shard")
    return (left_halo(k_loc[:, :, -wsz:], mesh, seq_axis),
            left_halo(v_loc[:, :, -wsz:], mesh, seq_axis))


def sharded_local_attention(q, k, v, *, mesh: DeviceMesh, window_size: int,
                            scale: float | None = None, seq_axis: str = "seq"):
    """The windowed attention of a rank's ``(B_local, H, L_local, D)`` slice
    under a mesh (the port of ``sharded_pallas_local_attention``): the left
    neighbour's last key/value window is the halo of the K1 kernels (on a
    CUDA tensor; the plain version on a CPU one).  Under every mesh, as in
    JAX: without a sequence split the halo is the zero window.  Requires
    ``L_local % window_size == 0``."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    k_halo, v_halo = _haloed_windows(k, v, window_size, mesh, seq_axis)
    return cuda_attention.local_attention(q, k, v, window_size, scale,
                                          k_halo.contiguous(), v_halo.contiguous())


cp_local_attention = sharded_local_attention


class _GatherSeq(torch.autograd.Function):
    """All-gather ``t`` along dim 1 over ``group``; the backward
    reduce-scatters (sums) the gradient back to each rank's slice."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        n = dist.get_world_size(group)
        local = t.transpose(0, 1).contiguous()
        out = torch.empty((n * local.shape[0], *local.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, local, group=group)
        return out.transpose(0, 1)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        full = grad.transpose(0, 1).contiguous()
        out = torch.empty((full.shape[0] // n, *full.shape[1:]), dtype=grad.dtype,
                          device=grad.device)
        dist.reduce_scatter_tensor(out, full, op=dist.ReduceOp.SUM, group=ctx.group)
        return out.transpose(0, 1), None


def cp_spatial_gate(gate, weights, biases, *, mesh: DeviceMesh, seq_axis: str = "seq"):
    """Sequence-sharded SGU mixing of a rank's slice: ``gate`` ``(B,
    L_local, D)``, its rows of ``weights`` ``(L_local, L)`` and ``biases``
    ``(L_local, 1)``; all-gather the gate, mask causally by GLOBAL row
    index, mix in f32 (JAX computes this in an einsum, not in a kernel),
    add the bias and cast to the gate's dtype."""
    n_loc, n_total = weights.shape
    group = mesh.get_group(seq_axis)
    gate_full = _GatherSeq.apply(gate, group) if dist.get_world_size(group) > 1 else gate
    rows = dist.get_rank(group) * n_loc + torch.arange(n_loc, device=gate.device)
    mask = torch.arange(n_total, device=gate.device)[None, :] <= rows[:, None]
    w = weights * mask.to(weights.dtype)
    mixed = torch.einsum("bnd,mn->bmd", gate_full.float(), w.float())
    return (mixed + biases).to(gate.dtype)


def sharded_spatial_gate(res, gate, weights, biases, *, mesh: DeviceMesh,
                         seq_axis: str = "seq"):
    """K2 under a mesh without a sequence split: each rank runs the kernels
    on its batch rows against the whole weights (the port of
    ``sharded_pallas_spatial_gate``).  The sum of ``d_W``/``d_bias`` over
    the batch ranks, which the TPU kernel's ``reduce_axes`` could do, is the
    train step's gradient reduction (``parallel/sharding.py``).  A sequence
    split raises: :func:`cp_spatial_gate` owns the op there."""
    seq = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    if seq != 1:
        raise ValueError(
            f"the SGU kernels cannot run under sequence parallelism (mesh "
            f"{seq_axis!r} axis has size {seq}); cp_spatial_gate owns the op")
    return cuda_sgu.gated_mix(res, gate, weights, biases)
