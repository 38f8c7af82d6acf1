"""ProGen model core in PyTorch (ported from progen_tpu/models/progen.py).

Natively batched ``(B, L) -> (B, L, num_tokens)``: byte-token embed ->
depth x [pre-LN windowed local attention, pre-LN feed-forward] -> LN +
logits head.  Numerics follow the JAX package: scale-only LayerNorm (eps
1e-5, f32 statistics, output in the compute dtype); token shift at the top
of both blocks; rotary on q, k AND v; GEGLU feed-forward with the tanh GELU
(``flax.linen.gelu``), swapped for the SGU/gMLP spatial gate in the last
``global_mlp_depth`` layers; bare residual adds; logits cast to the output
dtype.

The sequence mixing goes through the kernels' autograd functions,
``ops/cuda_attention.local_attention`` and ``ops/cuda_sgu.gated_mix``: on
the card the hand-written CUDA kernels, forward and backward, on the CPU
their plain versions.  Where the flax model ``sow``s decode caches, this one
fills the ``cache`` dict that ``forward(..., return_cache=True)`` returns,
keyed like flax's ``"cache"`` collection (without its one-element tuples).

Dense layers are ``nn.Linear`` (weight ``(out, in)``, the transpose of a
flax kernel; ``compat/convert.py`` carries weights across).

Multi-tenant LoRA (``workloads/lora.py``): ``forward(..., adapters=bank,
tenant=ids)`` adds each row's own tenant's low-rank delta at every adapter
site (:func:`apply_lora`); tenant-0 rows keep the base model's bits.

Under a mesh (``mesh=``, a ``DeviceMesh`` of ``core/mesh.py``; placed by
``parallel/sharding.parallelize``) each rank runs its slice, routed as JAX
routes it (``progen_tpu/models/progen.py:48-52,215-233,330-361``): the
attention through ``parallel/context.sharded_local_attention`` (the K1 kernels
with a halo, under every mesh), the SGU through ``cp_spatial_gate`` when the
sequence is split over ``seq`` and ``sharded_spatial_gate`` otherwise.  A
sequence split also needs what JAX's GSPMD gives for free: the token shift's
row from the left neighbour and rotary at global positions.  Under ``tp``
(the mesh's ``tensor`` dim) each rank runs its heads and its mlp channels
(``parallel/tensor.py``): the attention and the feed-forward block enter
their column-parallel projections through ``copy_to``, their row-parallel
output projections (``to_out``, ``ff.proj_out``) sum over the tensor ranks
before the bias is added once, the SGU's LayerNorm takes its statistics over
every rank's gate channels, the spatial mix (K2) runs on the rank's
channels, and the gated product is gathered before ``sgu.proj_out``, which
reads every channel.  K1 and K2 run on the rank's heads and channels, each a
contiguous tensor.  A LoRA bank under ``tp`` is the rank's part of it
(``parallel/decode.py:shard_bank``), its row-parallel ``out`` site summed
over the tensor ranks.  Decode runs the forward under ``forward(mesh=)``, a
view of the model's mesh in which the ``seq`` ranks are replicas
(``parallel/decode.py``).

``remat=True`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant, no RNG stash: the forward draws
no random numbers), a memory trade that changes no number: the recomputed
block runs the same kernels on the same inputs.  ``remat_policy`` says what
the forward keeps (JAX's ``nn.remat`` policies,
``progen_tpu/models/progen.py:437-459``):

* ``"full"``: only each block's input; the backward replays the whole
  block, K1-fwd and K2-fwd included;
* ``"dots"``: a selective checkpoint (``create_selective_checkpoint_contexts``)
  that keeps the outputs of ``aten.mm``, ``aten.addmm`` and ``aten.bmm``,
  the projections, and replays the rest, the kernels included.  JAX's
  ``dots_with_no_batch_dims_saveable`` keeps only products without batch
  dimensions; ``aten.bmm`` (the LoRA deltas' einsums) has one and is kept
  here all the same, and a product is seen by the op it dispatches to, not
  by its ``dot_general`` dimensions;
* ``"attn"``: the post-rotary q, k, v and the attention output (JAX's
  ``save_only_these_names``), with K1-fwd's ``lse``: the attention block's
  norm -> shift -> qkv -> rotary and its output projection are two
  checkpointed pieces around K1, which stays outside them, so its autograd
  function keeps q, k, v, out and lse and the backward runs no K1-fwd; the
  feed-forward block is replayed whole.  Unlike XLA, which replays only the
  norm and the shift there, the replay of the first piece also recomputes
  the qkv product and the rotary (a selective checkpoint replays every op
  it does not keep).

An unknown policy raises ``ValueError`` naming ``remat_policy``.  Remat
applies where gradients are recorded and no decode cache is filled.

``weights="int8"`` is the serving-only quantized mode (``ops/quant.py``):
every dense site but ``to_logits`` holds an int8 weight and an f32 scale per
output channel, and the SGU an int8 ``spatial_weights`` with an f32 scale per
ROW.  Quantized tensors are buffers, not parameters; they start as zeros
(scales as ones) and are loaded from ``quantize_params``' output.  Under
``tp`` ``parallelize`` gives each rank its part of every int8 weight, its
scales taken from the whole weight first (:class:`QuantDense`).

The token embedding's weight gradient is a one-hot product
(:func:`embed_tokens`), deterministic on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.mesh import mesh_sizes
from progen_tpu_torch.core.precision import Policy, make_policy
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.ops.quant import int8_matmul
from progen_tpu_torch.ops.rotary import apply_rotary_pos_emb, fixed_pos_embedding
from progen_tpu_torch.ops.shift import shift_split, shift_tokens
from progen_tpu_torch.parallel import context, tensor
from progen_tpu_torch.parallel.sharding import load_full, local

# kwargs the reference accepts but never reads, plus CLI-level kwargs
_IGNORED_CONFIG_KEYS = ("clamp_gate", "attn_dim", "mixed_precision")
# flax's truncated-normal correction: the std of N(0, 1) cut at +-2
_TRUNC_STD = 0.87962566103423978
_NORM_EPS = 1e-5  # Haiku's LayerNorm default, kept by the JAX package
REMAT_POLICIES = ("full", "dots", "attn")
# the products the "dots" policy keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _keep_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, *args, policy: str = "full"):
    """``fn(*args)`` under a non-reentrant checkpoint: ``"dots"`` keeps the
    products' outputs (:data:`_DOTS`), any other policy only the inputs."""
    context = {}
    if policy == "dots":
        context["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                  _keep_dots)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **context)


@dataclasses.dataclass(frozen=True)
class ProGenConfig:
    num_tokens: int = 256
    dim: int = 512
    seq_len: int = 1024
    depth: int = 12
    window_size: int = 256
    global_mlp_depth: int = 2
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    ff_glu: bool = True
    shift_tokens: bool = True

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ProGenConfig":
        clean = {k: v for k, v in d.items() if k not in _IGNORED_CONFIG_KEYS}
        return cls(**clean)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def layer_uses_gmlp(self, i: int) -> bool:
        """Layer i (0-based) uses the SGU/gMLP feed-forward iff it is among
        the last ``global_mlp_depth`` layers."""
        return (self.depth - i) <= self.global_mlp_depth


def lora_delta(x: torch.Tensor, site: dict, tenant: torch.Tensor,
               reduce_group=None) -> torch.Tensor:
    """Batched multi-tenant LoRA delta for one adapter site.

    ``x``: the dense layer's input ``(B, ..., Din)``; ``site``: stacked
    per-tenant factors ``{"a": (T, Din, r), "b": (T, r, Dout)}`` (any
    scale already folded into ``b``); ``tenant``: ``(B,)`` int tenant ids.
    Each row gathers ITS tenant's factors, cast to the activations' dtype,
    so one step serves every tenant in the batch.  ``reduce_group``: a
    row-parallel site, whose ``x`` and ``a`` are a rank's rows of the
    contraction; the rank-``r`` partial products are summed over the group."""
    a = site["a"].index_select(0, tenant).to(x.dtype)
    b = site["b"].index_select(0, tenant).to(x.dtype)
    h = tensor.reduce_from(torch.einsum("b...d,bdr->b...r", x, a), reduce_group)
    return torch.einsum("b...r,bro->b...o", h, b)


def apply_lora(base: torch.Tensor, x: torch.Tensor, site: dict,
               tenant: torch.Tensor, reduce_group=None) -> torch.Tensor:
    """``base + lora_delta`` for rows with ``tenant > 0``; rows with tenant
    0 return ``base`` BIT-identically.  The guard is a ``where`` on the
    output, not a zero delta: ``base + 0.0`` turns ``-0.0`` outputs into
    ``+0.0``."""
    delta = lora_delta(x, site, tenant, reduce_group)
    live = (tenant > 0).reshape((-1,) + (1,) * (base.dim() - 1))
    return torch.where(live, base + delta, base)


class _EmbedTokens(torch.autograd.Function):
    """``F.embedding`` whose weight gradient is the one-hot product
    ``onehot(tokens)^T @ grad`` over the vocabulary: a fixed order of sums,
    so the same step gives the same bits on the card, where
    ``F.embedding``'s backward adds rows with atomics."""

    @staticmethod
    def forward(ctx, tokens, weight):
        ctx.save_for_backward(tokens)
        ctx.vocab = weight.shape[0]
        return F.embedding(tokens, weight)

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        onehot = F.one_hot(tokens.reshape(-1).long(), ctx.vocab).to(grad.dtype)
        return None, onehot.T @ grad.reshape(-1, grad.shape[-1])


def embed_tokens(tokens: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``, with a deterministic backward
    (:class:`_EmbedTokens`)."""
    return _EmbedTokens.apply(tokens, weight)


class LayerNorm(nn.Module):
    """Scale-only LayerNorm as flax computes it under a bf16 ``dtype``:
    mean and ``E[x^2] - mean^2`` (clipped at 0) in f32, the f32 scale folded
    into the rsqrt, the result cast to the compute dtype."""

    def __init__(self, dim: int, policy: Policy, device=None):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=policy.param_dtype, device=device))

    def forward(self, x: torch.Tensor, group=None, channels: slice | None = None
                ) -> torch.Tensor:
        """``group``: ``x`` holds this rank's ``channels`` of the normed
        width, split over a tensor group; the statistics are then taken
        over every rank's channels and the rank's part of the scale is
        used."""
        xf = x.float()
        scale = self.scale
        if group is None:
            mean = xf.mean(-1, keepdim=True)
            var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        else:
            sums = tensor.sum_over(torch.cat(
                (xf.sum(-1, keepdim=True), (xf * xf).sum(-1, keepdim=True)), -1), group)
            sums = sums / scale.shape[0]
            mean, var = sums[..., :1], (sums[..., 1:] - sums[..., :1] ** 2).clamp_min(0.0)
            scale = tensor.copy_to(scale, group)[channels]
        mul = torch.rsqrt(var + _NORM_EPS) * scale.float()
        return ((xf - mean) * mul).to(self.compute_dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in the compute dtype, bias added after the
    product's rounding, as flax's ``Dense(dtype=...)`` does.

    ``packed``: how many equal pieces its output is made of (``[q|k|v]``,
    ``[x|gate]``), which tensor parallelism keeps together per rank
    (``parallel/sharding.py``).  Under ``tp`` the weight is a rank's part
    (its local shard); ``reduce_group`` makes it row-parallel: the partial
    products are summed over the group before the bias is added."""

    packed = 1

    def __init__(self, din: int, dout: int, *, bias: bool, policy: Policy,
                 device=None):
        super().__init__(din, dout, bias=bias, device=device,
                         dtype=policy.param_dtype)
        self.compute_dtype = policy.compute_dtype

    def forward(self, x: torch.Tensor, reduce_group=None) -> torch.Tensor:
        cd = self.compute_dtype
        y = tensor.reduce_from(F.linear(x.to(cd), local(self.weight).to(cd)), reduce_group)
        return y if self.bias is None else y + local(self.bias).to(cd)


class QuantDense(nn.Module):
    """Drop-in for :class:`Dense` under ``weights="int8"``: ``weight`` is an
    int8 buffer ``(out, in)`` and ``weight_scale`` an f32 buffer ``(out,)``;
    the product runs int8-as-compute-dtype, is scaled per channel in f32,
    cast to the compute dtype, and only then gets its bias."""

    def __init__(self, din: int, dout: int, *, bias: bool, policy: Policy,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = din, dout
        self.compute_dtype = policy.compute_dtype
        self.register_buffer("weight", torch.zeros(
            dout, din, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            dout, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(
            dout, dtype=policy.param_dtype, device=device)) if bias else None)

    def forward(self, x: torch.Tensor, reduce_group=None) -> torch.Tensor:
        """Under ``tp`` (``parallel/sharding.py``) the int8 weight is a
        rank's part and its scales were taken from the whole weight: a
        column-parallel layer holds its channels' scales; a row-parallel
        one (``reduce_group``) sums the unscaled partial products over the
        group and then applies the whole scale."""
        cd = self.compute_dtype
        if reduce_group is None:
            y = int8_matmul(x.to(cd), self.weight.T, self.weight_scale).to(cd)
        else:
            part = torch.matmul(x.to(cd), self.weight.T.to(cd)).float()
            y = (tensor.reduce_from(part, reduce_group) * self.weight_scale).to(cd)
        return y if self.bias is None else y + local(self.bias).to(cd)


def seq_split(mesh) -> tuple[int, int]:
    """``(slices, this rank's slice)`` of the sequence over ``mesh``'s
    ``seq`` dim; ``(1, 0)`` without a mesh."""
    if mesh is None or mesh_sizes(mesh)["seq"] == 1:
        return 1, 0
    return mesh_sizes(mesh)["seq"], mesh.get_local_rank("seq")


def _shift(x: torch.Tensor, mesh) -> torch.Tensor:
    """The token shift of a rank's slice: position 0 takes the left
    neighbour's last row under a sequence split."""
    if seq_split(mesh)[0] == 1:
        return shift_tokens(x)
    prev = context.left_halo(x[..., -1:, :shift_split(x.shape[-1])], mesh)
    return shift_tokens(x, prev)


def _dense(din: int, dout: int, *, bias: bool, policy: Policy, device=None,
           weights: str = "bf16") -> nn.Module:
    if weights == "int8":
        return QuantDense(din, dout, bias=bias, policy=policy, device=device)
    if weights != "bf16":
        raise ValueError(f"unknown weights mode {weights!r}; use 'bf16' or 'int8'")
    return Dense(din, dout, bias=bias, policy=policy, device=device)


class Runs:
    """``run(fn, ...)``: a computation of this module's other than its
    ``forward`` (the decode step's).  ``parallel/sharding.parallelize``
    registers ``run`` with FSDP2 as a forward method, so under ``fsdp`` the
    module's parameters are whole while ``fn`` runs, through FSDP2's own
    pre- and post-forward (its unshard, stream ordering and reshard), as in
    ``forward``."""

    def run(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)``."""
        return fn(self, *args, **kwargs)


class LocalAttention(Runs, nn.Module):
    """Pre-LN windowed attention block: fused bias-free QKV projection,
    output projection with bias."""

    def __init__(self, config: ProGenConfig, policy: Policy, device=None,
                 weights: str = "bf16"):
        super().__init__()
        c = config
        inner = c.heads * c.dim_head
        self.window_size = c.window_size
        self.heads = c.heads
        self.dim_head = c.dim_head
        self.shift = c.shift_tokens
        self.norm = LayerNorm(c.dim, policy, device=device)
        self.to_qkv = _dense(c.dim, 3 * inner, bias=False, policy=policy,
                             device=device, weights=weights)
        self.to_qkv.packed = 3  # [q|k|v]
        self.to_out = _dense(inner, c.dim, bias=True, policy=policy,
                             device=device, weights=weights)

    def forward(self, x, sin, cos, cache: dict | None = None,
                adapters: dict | None = None, tenant=None, mesh=None,
                remat: str | None = None):
        """``remat="attn"``: the pieces before and after K1 each under a
        checkpoint, K1 outside them (the module docstring)."""
        qkv_in = (x, sin, cos, cache, adapters, tenant, mesh)
        q, k, v = (remat_call(self._qkv, *qkv_in) if remat == "attn"
                   else self._qkv(*qkv_in))
        d = self.dim_head
        if mesh is not None:
            out = context.sharded_local_attention(
                q, k, v, mesh=mesh, window_size=self.window_size, scale=d ** -0.5)
        else:
            out = cuda_attention.local_attention(q, k, v, self.window_size, d ** -0.5)
        if remat == "attn":
            return remat_call(self._out, out, adapters, tenant, mesh)
        return self._out(out, adapters, tenant, mesh)

    def _qkv(self, x, sin, cos, cache, adapters, tenant, mesh):
        """The post-rotary q, k, v of this rank's heads, each ``(B, H, L,
        Dh)`` contiguous."""
        b, n, _ = x.shape
        ranks, group = tensor.tensor_split(mesh)
        h, d = self.heads // ranks, self.dim_head
        x = self.norm(x)
        if cache is not None:
            cache["prev"] = x  # post-norm PRE-shift: the decode shift carry
        if self.shift:
            x = _shift(x, mesh)
        x = tensor.copy_to(x, group)
        qkv = self.to_qkv(x)
        if adapters is not None:  # the delta reads the SHIFTED input
            qkv = apply_lora(qkv, x, adapters["qkv"], tenant)
        q, k, v = qkv.chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in (q, k, v))
        # rotary on q, k AND v
        q, k, v = (apply_rotary_pos_emb(t, sin, cos).contiguous()
                   for t in (q, k, v))
        if cache is not None:
            cache["k"] = k  # post-rotary k/v: what the decode rings hold
            cache["v"] = v
        return q, k, v

    def _out(self, out, adapters, tenant, mesh=None):
        """The output projection of the attention's ``(B, H, L, Dh)`` (a
        rank's heads under ``tp``: row-parallel)."""
        b, h, n, d = out.shape
        out = out.transpose(1, 2).reshape(b, n, h * d)
        group = tensor.tensor_split(mesh)[1]
        y = self.to_out(out, reduce_group=group)
        if adapters is not None:
            y = apply_lora(y, out, adapters["out"], tenant, group)
        return y


class SGU(nn.Module):
    """gMLP spatial gating unit: learned causal ``(n, n)`` token mixing of
    the LayerNormed gate half, then a projection."""

    def __init__(self, seq_len: int, dim_out: int, policy: Policy,
                 device=None, weights: str = "bf16"):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        self.norm = LayerNorm(dim_out, policy, device=device)
        if weights == "int8":
            # int8 per-row spatial weights under the same name; the f32 row
            # scale is folded back in f32 before the mix (which contracts
            # over COLUMNS, so one scale per row is exact up to rounding)
            self.register_buffer("spatial_weights", torch.zeros(
                seq_len, seq_len, dtype=torch.int8, device=device))
            self.register_buffer("spatial_weights_scale", torch.ones(
                seq_len, dtype=torch.float32, device=device))
        else:
            self.spatial_weights = nn.Parameter(torch.empty(
                seq_len, seq_len, dtype=policy.param_dtype, device=device))
            self.spatial_weights_scale = None
        self.spatial_biases = nn.Parameter(torch.ones(
            seq_len, 1, dtype=policy.param_dtype, device=device))
        self.proj_out = _dense(dim_out, dim_out, bias=True, policy=policy,
                               device=device, weights=weights)

    def forward(self, x, cache: dict | None = None, adapters: dict | None = None,
                tenant=None, mesh=None):
        """``adapters`` is this SGU's one site, ``{"a", "b"}``.  Under
        ``tp`` ``x`` holds this rank's ``[res|gate]`` channels."""
        res, gate = x.chunk(2, dim=-1)
        _, group = tensor.tensor_split(mesh)
        gate = self.norm(gate, group, tensor.rank_slice(self.norm.scale.shape[0], mesh))
        if cache is not None:
            cache["gate"] = gate  # normed gate rows: the decode gate cache
        n = gate.shape[-2]
        cd = self.compute_dtype
        slices, me = seq_split(mesh)
        if slices > 1:
            w, b = (tensor.copy_to(t, group) for t in self._rows(n, slices, me, cd))
            x = res * context.cp_spatial_gate(gate, w, b, mesh=mesh)
        else:
            # an input shorter than seq_len (a prefill) uses the leading L
            # rows and columns: exact, since row m only reads columns <= m < L
            w, b = (tensor.copy_to(t, group) for t in self.whole(mesh))
            w = w[:n, :n]
            if self.spatial_weights_scale is not None:
                w = w.float() * self.spatial_weights_scale[:n, None]
            w = w.to(cd).contiguous()
            b = b[:n].to(cd).contiguous()
            mix = cuda_sgu.gated_mix if mesh is None else functools.partial(
                context.sharded_spatial_gate, mesh=mesh)
            x = mix(res.contiguous(), gate.contiguous(), w, b)
        # sgu.proj_out reads every channel: a rank's are gathered
        x = tensor.gather_from(x, group)
        y = self.proj_out(x)
        if adapters is not None:  # the delta reads the gated mix
            y = apply_lora(y, x, adapters, tenant)
        return y

    def whole(self, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole spatial weights and biases: under decode's view of a
        mesh (``parallel/decode.py``) the copies it gathered from their
        ``seq`` shards, else the local tensors (under ``sp`` with one seq
        rank a DTensor of one shard; under ``fsdp`` the unsharded
        parameters while the block runs)."""
        spatial = getattr(mesh, "spatial", None)
        if spatial and id(self) in spatial:
            return spatial[id(self)]
        return local(self.spatial_weights), local(self.spatial_biases)

    def _rows(self, n: int, slices: int, me: int, cd: torch.dtype):
        """This rank's rows of the spatial weights and biases in the compute
        dtype, for a slice of ``n`` of the ``seq_len`` positions: a DTensor's
        own shard (``parallelize`` row-shards them over ``seq``), else the
        rows sliced from the whole."""
        if n * slices != self.spatial_biases.shape[0] or self.spatial_weights_scale is not None:
            raise ValueError(
                f"context-parallel SGU requires the full seq_len "
                f"{self.spatial_biases.shape[0]} in bf16/f32 weights, got {slices} "
                f"slices of {n}")
        rows = slice(me * n, (me + 1) * n)
        w, b = self.spatial_weights, self.spatial_biases
        w = w.to_local() if isinstance(w, DTensor) else w[rows]
        b = b.to_local() if isinstance(b, DTensor) else b[rows]
        return w.to(cd), b.to(cd)


class FeedForward(Runs, nn.Module):
    """Pre-LN MLP: GEGLU, or GELU then the SGU in the gMLP layers."""

    def __init__(self, config: ProGenConfig, use_sgu: bool, policy: Policy,
                 device=None, weights: str = "bf16"):
        super().__init__()
        c = config
        self.glu = c.ff_glu and not use_sgu
        self.shift = c.shift_tokens
        hidden = c.dim * c.ff_mult * (2 if self.glu else 1)
        self.norm = LayerNorm(c.dim, policy, device=device)
        self.proj_in = _dense(c.dim, hidden, bias=True, policy=policy,
                              device=device, weights=weights)
        if self.glu or use_sgu:
            self.proj_in.packed = 2  # [x|gate], [res|gate]
        self.sgu = (SGU(c.seq_len, hidden // 2, policy, device=device,
                        weights=weights) if use_sgu else None)
        # GLU and the SGU each halve the hidden width
        width = hidden // 2 if (self.glu or use_sgu) else hidden
        self.proj_out = _dense(width, c.dim, bias=True, policy=policy,
                               device=device, weights=weights)

    def forward(self, x, cache: dict | None = None, adapters: dict | None = None,
                tenant=None, mesh=None):
        x = self.norm(x)
        if cache is not None:
            cache["prev"] = x
        if self.shift:
            x = _shift(x, mesh)
        _, group = tensor.tensor_split(mesh)
        x = self.proj_in(tensor.copy_to(x, group))
        if self.glu:
            x, gate = x.chunk(2, dim=-1)
            x = x * F.gelu(gate, approximate="tanh")
        else:
            x = F.gelu(x, approximate="tanh")
        if self.sgu is not None:
            sub = None
            if cache is not None:
                sub = cache["sgu"] = {}
            x = self.sgu(x, sub, None if adapters is None else adapters["sgu"],
                         tenant, mesh)
        return self.proj_out(x, reduce_group=group)


class ProGen(Runs, nn.Module):
    """Embed -> depth x [LocalAttention, FeedForward] -> LN + logits head.

    ``device=None`` means ``cuda`` (raising without a card); the tests pass
    ``device="cpu"``.  ``weights="int8"`` builds the quantized serving model
    (see the module docstring).  Parameters start as the JAX package's initialisers
    draw them (:meth:`init_weights`), from ``seed``.  ``mesh`` routes the
    sequence mixing over a ``DeviceMesh`` (the module docstring); the token
    input is then a rank's slice.  ``remat``/``remat_policy``: recompute
    each block in the backward (the module docstring).
    """

    def __init__(self, config: ProGenConfig, policy: Policy | None = None,
                 device=None, seed: int = 0, weights: str = "bf16", mesh=None,
                 remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        if remat and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; use 'full', "
                             "'dots' or 'attn'")
        c = config
        self.config = c
        self.policy = policy or make_policy()
        self.weights = weights
        self.mesh = mesh
        self.remat = remat
        self.remat_policy = remat_policy
        dev = resolve_device(device)
        self.embed = nn.Embedding(c.num_tokens, c.dim, device=dev,
                                  dtype=self.policy.param_dtype)
        self.attn = nn.ModuleList(
            LocalAttention(c, self.policy, device=dev, weights=weights)
            for _ in range(c.depth))
        self.ff = nn.ModuleList(
            FeedForward(c, c.layer_uses_gmlp(i), self.policy, device=dev,
                        weights=weights)
            for i in range(c.depth))
        self.norm_out = LayerNorm(c.dim, self.policy, device=dev)
        self.to_logits = Dense(c.dim, c.num_tokens, bias=True,
                               policy=self.policy, device=dev)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Draw every parameter from the JAX package's distributions:
        lecun-normal (truncated at 2 std) dense kernels, zero dense biases,
        ``N(0, 1/dim)`` embedding, ``U(+-1e-3/n)`` spatial weights, ones for
        spatial biases and norm scales.  Drawn on the CPU from ``seed``, so
        every device gets the same weights, and a sharded parameter its
        part of them.  A ``meta`` model (a skeleton to place, then fill with
        ``parallel/sharding.load_placed``) holds no values: nothing is
        drawn."""
        if self.device.type == "meta":
            return
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, Dense):
                std = math.sqrt(1.0 / module.in_features) / _TRUNC_STD
                w = torch.empty(module.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=gen)
                load_full(module.weight, w, module.packed)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, SGU):
                if module.spatial_weights_scale is not None:
                    continue  # int8: zeros until quantized weights are loaded
                n = module.spatial_weights.shape[0]
                bound = 1e-3 / n
                w = torch.empty(module.spatial_weights.shape)
                w.uniform_(-bound, bound, generator=gen)
                load_full(module.spatial_weights, w)
                module.spatial_biases.fill_(1.0)
            elif isinstance(module, LayerNorm):
                module.scale.fill_(1.0)
        w = torch.empty(self.embed.weight.shape)
        w.normal_(0.0, math.sqrt(1.0 / self.config.dim), generator=gen)
        load_full(self.embed.weight, w)

    def forward(self, tokens: torch.Tensor, return_cache: bool = False,
                adapters: dict | None = None, tenant: torch.Tensor | None = None,
                mesh=None):
        """``tokens (B, L)`` int -> logits ``(B, L, V)`` in the output dtype;
        with ``return_cache=True``, ``(logits, cache)`` where ``cache`` holds
        per layer the intermediates prefill harvests: ``cache["attn{i}"]``
        has ``prev`` (post-norm, pre-shift), ``k`` and ``v`` (post-rotary,
        ``(B, H, L, Dh)``); ``cache["ff{i}"]`` has ``prev`` and, in the gMLP
        layers, ``sgu: {gate}`` (the normed gate).  ``adapters`` (a LoRA
        bank, ``workloads/lora.py``) with ``tenant (B,)`` adds each row's
        tenant's delta at every adapter site.  ``mesh``: a view of the
        model's own mesh to run under (decode's ``DecodeMesh``,
        ``parallel/decode.py``); the model's mesh by default."""
        cache: dict[str, dict] | None = {} if return_cache else None
        x = self._trunk(tokens, cache, adapters, tenant, mesh)
        logits = self.policy.cast_to_output(self.to_logits(self.norm_out(x)))
        if return_cache:
            return logits, cache
        return logits

    def final_hidden(self, tokens: torch.Tensor, adapters: dict | None = None,
                     tenant: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
        """The final post-``norm_out`` hidden states ``(B, L, dim)`` in the
        compute dtype: the embeddings path, with no logits head and no
        per-layer caches.  ``mesh`` as in :meth:`forward`."""
        return self.norm_out(self._trunk(tokens, None, adapters, tenant, mesh))

    def _trunk(self, tokens, cache, adapters, tenant, mesh=None) -> torch.Tensor:
        """Embed and run every block; the residual stream before
        ``norm_out``.  Fills ``cache`` when given."""
        cfg = self.config
        mesh = self.mesh if mesh is None else mesh
        if adapters is not None and tenant is None:
            raise ValueError("adapters require a (B,) tenant-id tensor")
        ranks = tensor.tensor_split(mesh)[0]
        if adapters is not None and ranks > 1:
            inner = 3 * cfg.heads * cfg.dim_head // ranks
            if adapters["attn0"]["qkv"]["b"].shape[-1] != inner:
                raise ValueError(
                    f"under a tensor axis of {ranks} a LoRA bank must be the rank's "
                    "part (parallel/decode.py:shard_bank): its qkv site is "
                    f"{adapters['attn0']['qkv']['b'].shape[-1]} wide, not {inner}")
        if tokens.dim() != 2:
            raise ValueError(
                f"ProGen takes batched (B, L) int tokens, got shape "
                f"{tuple(tokens.shape)}")
        n = tokens.shape[1]
        slices, me = seq_split(mesh)
        if cfg.global_mlp_depth > 0 and n * slices > cfg.seq_len:
            raise ValueError(
                f"input length {n} > config.seq_len {cfg.seq_len}: the gMLP "
                "layers' learned (seq_len, seq_len) spatial weights have no "
                "rows past seq_len")
        cd = self.policy.compute_dtype
        x = embed_tokens(tokens, self.embed.weight.to(cd))
        # rotary tables computed once, shared by all layers; f32, cast inside;
        # a slice of the sequence takes its rows at their global positions
        sin, cos = fixed_pos_embedding(n * slices, cfg.dim_head, device=tokens.device)
        sin, cos = sin[me * n:(me + 1) * n], cos[me * n:(me + 1) * n]
        remat = (self.remat_policy if self.remat and cache is None
                 and torch.is_grad_enabled() else None)
        for i in range(cfg.depth):
            attn_c = ff_c = None
            if cache is not None:
                attn_c = cache[f"attn{i}"] = {}
                ff_c = cache[f"ff{i}"] = {}
            attn_ad = ff_ad = None
            if adapters is not None:
                attn_ad, ff_ad = adapters.get(f"attn{i}"), adapters.get(f"ff{i}")
            attn_args = (x, sin, cos, attn_c, attn_ad, tenant, mesh)
            if remat == "attn":
                x = x + self.attn[i](*attn_args, remat="attn")
            elif remat is not None:
                x = x + remat_call(self.attn[i], *attn_args, policy=remat)
            else:
                x = x + self.attn[i](*attn_args)
            ff_args = (x, ff_c, ff_ad, tenant, mesh)
            if remat is not None:  # "attn" keeps nothing of the feed-forward
                x = x + remat_call(self.ff[i], *ff_args, policy=remat)
            else:
                x = x + self.ff[i](*ff_args)
        return x
