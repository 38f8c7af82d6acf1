"""Per-card memory planner for the training step and the serving engine
(ported from progen_tpu/train/memory.py; the JAX module's API, the count
terms to the byte, and an activation model of the port's own).

The first question at any scale is "does this (config, mesh, strategies,
remat, batch) fit the card?"; this module predicts the answer from the
model's shapes, so that the :class:`~progen_tpu_torch.train.trainer.Trainer`
refuses a configuration that cannot fit before it places the model or runs
a step (:func:`check_fits`; ``PROGEN_SKIP_MEMORY_CHECK=1`` skips the gate).

**Terms that are JAX's, to the byte:**

* ``count_params`` (closed form);
* f32 params, Adam's two moments and, with accumulation, the f32
  accumulator, divided by the axes that shard them (``fsdp`` x ``tensor``);
* the background checkpoint's snapshot, a device clone of that state
  (``train/trainer.py:_snapshot``, made only without a mesh);
* the staged superbatches, two ``(K, accum, B, L + 1)`` int32 buffers.
  ``data/prefetch.py:SuperbatchStager`` hands each span a fresh buffer and
  the trainer drops the previous one before it asks for the next, so the
  port holds one superbatch and the captured step's static ``(accum, B,
  L + 1)`` slice: JAX's two buffers bound it from above;
* the whole serving plan (:func:`serving_plan`): the port's engine keeps
  JAX's state layout.

**Terms that are the port's own**, each read off the port's code:

* ``grad_bytes``: the f32 gradients in ``.grad`` at the backward's peak
  (4 bytes a parameter, divided like the state, of the blocks the backward
  has passed; JAX's donated step never holds them);
* ``cast_bytes``: the compute-dtype copies that autograd keeps for the
  backward under bf16 compute: every ``Dense`` weight cast in its forward
  (``models/progen.py:Dense``, saved by ``aten.mm``), the SGU's spatial
  weights and biases cast for K2 (saved by ``ops/cuda_sgu.py:SpatialGateFn``)
  and the rotary tables cast for q, k and v (saved by the multiplies of
  ``ops/rotary.py:apply_rotary_pos_emb``).  Under FSDP2 the casts are of the
  unsharded weights, so they divide by ``tensor`` only.  Under remat every
  cast inside a checkpointed block is made again in the replay, so only the
  logits head's stays;
* ``activation_bytes``: the saved-tensor set of each layer
  (:func:`_layer_saved_bytes`), per remat policy, at the blocks of
  ``models/progen.py``:

  - ``none``: each scale-only ``LayerNorm`` keeps three f32 ``(t, width)``
    tensors (its f32 input, ``x - mean`` and the broadcast ``rsqrt * scale``)
    and three f32 ``(t, 1)`` statistics; each ``Dense`` keeps its input
    (the shifted rows for ``to_qkv`` and ``proj_in``, the reshaped attention
    output for ``to_out``, the gated product for ``proj_out``); K1's
    ``ops/cuda_attention.py:LocalAttentionFn`` keeps q, k, v, out (compute
    dtype) and the f32 lse, and under a mesh the zero or neighbour halo;
    the GEGLU keeps ``proj_in``'s output (``F.gelu`` and the product read
    it) and ``gelu(gate)``; the SGU keeps ``res`` (a contiguous copy), the
    LayerNorm of its gate and the normed gate (``SpatialGateFn`` keeps both
    of its row inputs), the gated mix (``sgu.proj_out``'s input, gathered
    over ``tensor`` under ``tp``) and ``sgu.proj_out``'s output;
  - ``full``: a checkpoint per block keeps only each block's input;
  - ``dots``: the selective checkpoint keeps each block's input and the
    outputs of ``aten.mm`` (every projection);
  - ``attn``: K1 outside the checkpointed pieces keeps q, k, v, out and
    lse, with the attention block's and the feed-forward block's inputs;

  the logits head (its LayerNorm and ``to_logits``' input) is outside every
  checkpoint.  The peak is found by walking the backward's blocks from the
  last (:func:`_backward_peak`): at each block the saved sets of the blocks
  below it, its own whole ``none`` set (a remat policy replays the block,
  casts included) and the gradients of the blocks above it.  Without remat
  the peak is the backward's start; under ``full`` at small batches it is
  the last blocks, when most gradients exist;
* ``logits_bytes``: the f32 log-softmax the loss keeps and its gradient,
  ``2 * t * V * 4`` as in JAX;
* ``unshard_bytes``: under ``fsdp``, FSDP2's all-gathered f32 weights of
  two blocks (the block running and the one prefetched).

:data:`ACT_EFFICIENCY` multiplies the activation term: the backward's
working set (each op's gradient buffers, freed as it goes) over the saved
set.  It was fitted to ``torch.cuda.max_memory_allocated`` above the start
of eager train steps on an NVIDIA H100 80GB HBM3 at 700.00 W (``chip_smoke.py``
phase ``trainer_mesh``, ProGen-small, bf16 compute: batch 8, 16 and 40
without remat, 8, 16 and 48 under ``full``, 8, 16 and 32 under ``attn``, 8
and 16 under ``dots``; every point then within 2%; ``PERF.md``), which is
the one kind in :data:`CALIBRATED_DEVICE_KINDS`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import torch

GiB = 1024**3

# the backward's working set over the saved set, per remat policy: fitted
# to max_memory_allocated on the calibrated card (module docstring)
ACT_EFFICIENCY = {"none": 1.0125, "dots": 1.0525, "full": 1.2, "attn": 1.0925}

# the device kinds (torch.cuda.get_device_name) the planner was fitted on;
# elsewhere an over-budget plan only warns
CALIBRATED_DEVICE_KINDS = frozenset({"NVIDIA H100 80GB HBM3"})

# the implementations the port has: its hand-written kernels
KERNEL_IMPL = "kernel"

_F32 = 4


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Predicted per-card device memory for one training-step
    configuration."""

    params_bytes: int
    moments_bytes: int
    accumulator_bytes: int
    activation_bytes: int
    cast_bytes: int
    logits_bytes: int
    num_params: int
    detail: dict
    snapshot_bytes: int = 0
    superbatch_bytes: int = 0
    grad_bytes: int = 0
    unshard_bytes: int = 0

    @property
    def state_bytes(self) -> int:
        return self.params_bytes + self.moments_bytes + self.accumulator_bytes

    @property
    def temp_bytes(self) -> int:
        return (self.activation_bytes + self.cast_bytes + self.logits_bytes
                + self.grad_bytes + self.unshard_bytes)

    @property
    def total_bytes(self) -> int:
        return (self.state_bytes + self.temp_bytes + self.snapshot_bytes
                + self.superbatch_bytes)

    def report(self) -> str:
        rows = [
            ("params (f32)", self.params_bytes),
            ("adam moments (f32)", self.moments_bytes),
            ("grad accumulator (f32)", self.accumulator_bytes),
            ("gradients in .grad (f32)", self.grad_bytes),
            ("activations kept for the backward", self.activation_bytes),
            ("compute-dtype weight casts kept", self.cast_bytes),
            ("f32 logits + softmax bwd", self.logits_bytes),
            ("fsdp all-gathered weights", self.unshard_bytes),
            ("background-checkpoint snapshot", self.snapshot_bytes),
            ("staged superbatches (int32)", self.superbatch_bytes),
            ("peak = state + grads + act + casts + logits + snapshot + stage",
             self.total_bytes),
        ]
        out = "\n".join(f"  {name:<62} {b / GiB:7.2f} GiB" for name, b in rows)
        for kind, shards in self.detail.get("axis_shards", {}).items():
            spec = " x ".join(f"{a}={v}" for a, v in shards.items())
            ways = 1
            for v in shards.values():
                ways *= v
            out += f"\n  {kind + ' sharded over':<62} {spec} ({ways}x)"
        return out


def count_params(cfg) -> int:
    """Exact parameter count of the model (closed form; equals the JAX
    package's and the port model's own count, asserted in tests)."""
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    n = cfg.num_tokens * d  # embed
    for i in range(cfg.depth):
        gmlp = cfg.layer_uses_gmlp(i)
        # attention: norm scale, qkv (no bias), out (+bias)
        n += d + d * 3 * inner + inner * d + d
        hidden = d * cfg.ff_mult * (1 if gmlp or not cfg.ff_glu else 2)
        # ff: norm scale, proj_in (+bias)
        n += d + d * hidden + hidden
        if gmlp:
            half = (d * cfg.ff_mult) // 2
            # sgu: norm scale, spatial weights/biases, proj_out (+bias)
            n += half + cfg.seq_len * cfg.seq_len + cfg.seq_len
            n += half * half + half
            n += half * d + d  # ff proj_out from half
        else:
            n += (hidden // (2 if cfg.ff_glu else 1)) * d + d  # ff proj_out
    n += d + d * cfg.num_tokens + cfg.num_tokens  # head norm + linear
    return n


def _check_impl(attn_impl: str, sgu_impl: str) -> None:
    for name, value in (("attn_impl", attn_impl), ("sgu_impl", sgu_impl)):
        if value != KERNEL_IMPL:
            raise ValueError(f"{name}={value!r}: the port has one implementation, "
                             f"{KERNEL_IMPL!r} (its hand-written kernels)")


def _layernorm_bytes(tokens: int, width: int) -> int:
    """A scale-only LayerNorm's saved set: three f32 ``(t, width)`` and
    three f32 ``(t, 1)`` tensors."""
    return 3 * _F32 * tokens * width + 3 * _F32 * tokens


def _dense_weight_numel(cfg, gmlp: bool, tensor: int, block: str | None = None) -> int:
    """Elements of one layer's ``Dense`` weights on a rank (of one block,
    ``"attn"`` or ``"ff"``, or both)."""
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    hidden = d * cfg.ff_mult * (1 if gmlp or not cfg.ff_glu else 2)
    attn = d * 3 * inner + inner * d
    ff = d * hidden
    if gmlp:
        half = (d * cfg.ff_mult) // 2
        ff += half * half + half * d
    else:
        ff += (hidden // (2 if cfg.ff_glu else 1)) * d
    n = {"attn": attn, "ff": ff, None: attn + ff}[block]
    return n // tensor


def _block_saved_bytes(cfg, tokens: int, policy: str, block: str, gmlp: bool,
                       act: int, tensor: int = 1, seq: int = 1,
                       meshed: bool = False) -> int:
    """Bytes one block (``"attn"`` or ``"ff"``) of a layer keeps for its
    backward on a rank (:func:`_layer_saved_bytes` names the arguments)."""
    d, t = cfg.dim, tokens
    inner = cfg.heads * cfg.dim_head // tensor
    heads = cfg.heads // tensor
    glu_width = d * cfg.ff_mult * 2 // tensor      # GEGLU proj_in output
    half = (d * cfg.ff_mult) // 2 // tensor         # SGU channels of a rank
    rows = t * seq // cfg.seq_len                  # sequences of the rank
    k1 = 4 * act * t * inner + _F32 * t * heads    # q, k, v, out; lse
    if meshed:
        k1 += 2 * act * rows * heads * cfg.window_size * cfg.dim_head
    block_in = act * t * d
    if policy == "full":
        return block_in
    if policy == "attn":
        return block_in + (k1 if block == "attn" else 0)
    if policy == "dots":
        if block == "attn":
            return block_in + act * t * 3 * inner + act * t * d   # to_qkv, to_out
        return (block_in + act * t * (2 * half if gmlp else glu_width)  # proj_in
                + act * t * d + (act * t * half if gmlp else 0))       # proj_out, sgu.proj_out
    if policy != "none":
        raise ValueError(f"unknown remat policy {policy!r}")
    if block == "attn":
        # norm, shifted rows (to_qkv's input), K1, to_out's input
        return _layernorm_bytes(t, d) + act * t * d + k1 + act * t * inner
    # norm, shifted rows (proj_in's input)
    saved = _layernorm_bytes(t, d) + act * t * d
    if not gmlp:
        # proj_in's output (the gelu and the product read it), gelu(gate),
        # the product (proj_out's input)
        return saved + act * t * glu_width + 2 * act * t * (glu_width // 2)
    saved += act * t * 2 * half                    # proj_in's output (gelu's input)
    saved += act * t * half                        # res, a contiguous copy
    if act == _F32:
        # f32 compute: the norm's f32 input IS the gate half of gelu's
        # output, which it keeps whole
        saved += act * t * 2 * half + 2 * _F32 * t * half + 3 * _F32 * t
    else:
        saved += _layernorm_bytes(t, half)
    if seq > 1:
        # cp_spatial_gate keeps the gathered gate in f32 and its own output
        saved += _F32 * t * seq * half + act * t * half
    else:
        saved += act * t * half                    # the normed gate (K2 keeps it)
    saved += act * t * half * tensor               # sgu.proj_out's input (gathered)
    saved += act * t * half                        # ff.proj_out's input
    return saved


def _layer_saved_bytes(cfg, tokens: int, policy: str, attn_impl: str,
                       gmlp: bool, act: int, tensor: int = 1,
                       sgu_impl: str = KERNEL_IMPL, seq: int = 1,
                       meshed: bool = False) -> int:
    """Bytes of forward tensors kept for the backward of ONE layer
    (attention block + feed-forward block) on a rank, per remat policy
    (the module docstring names the function that keeps each tensor).

    ``tokens`` are the rank's; ``act`` the compute dtype's element size;
    ``tensor`` the tp degree (the heads and mlp channels divide over it, the
    residual stream does not); ``seq`` the sequence split (the SGU then
    keeps the gathered f32 gate instead of K2's gate); ``meshed``: K1 keeps
    its halo (zeros without a sequence split)."""
    _check_impl(attn_impl, sgu_impl)
    return sum(_block_saved_bytes(cfg, tokens, policy, block, gmlp, act, tensor, seq, meshed)
               for block in ("attn", "ff"))


def _head_saved_bytes(cfg, tokens: int, act: int) -> int:
    """The logits head's saved set: its LayerNorm and ``to_logits``' input."""
    return _layernorm_bytes(tokens, cfg.dim) + act * tokens * cfg.dim


def _block_cast_bytes(cfg, i: int, block: str, mixed_precision: bool, tensor: int,
                      seq_local: int) -> int:
    """The compute-dtype casts one block makes in its forward (bf16 only):
    its ``Dense`` weights, the rotary tables (attention), the spatial
    weights and biases (an SGU)."""
    if not mixed_precision:
        return 0
    bf16 = 2
    gmlp = cfg.layer_uses_gmlp(i)
    casts = bf16 * _dense_weight_numel(cfg, gmlp, tensor, block)
    if block == "attn":
        casts += 6 * seq_local * cfg.dim_head * bf16   # sin, cos for q, k, v
    elif gmlp:
        casts += bf16 * (seq_local * seq_local + seq_local)
    return casts


def _cast_bytes(cfg, policy: str, mixed_precision: bool, tensor: int,
                seq_local: int) -> int:
    """Compute-dtype casts kept for the backward (bf16 compute only): every
    block's under no remat, the logits head's always (a remat policy makes
    its blocks' casts again in the backward)."""
    if not mixed_precision:
        return 0
    head = 2 * cfg.dim * cfg.num_tokens
    if policy != "none":
        return head
    return head + sum(_block_cast_bytes(cfg, i, block, True, tensor, seq_local)
                      for i in range(cfg.depth) for block in ("attn", "ff"))


def forward_saved_bytes(cfg, *, tokens: int, policy: str = "none",
                        mixed_precision: bool = True, tensor: int = 1,
                        seq: int = 1, meshed: bool = False) -> int:
    """Bytes the forward leaves for the backward on a rank of ``tokens``
    tokens (the layers' saved sets, the head's and the kept casts), before
    any replay: what the activation model predicts of a forward's live
    tensors, which ``tests/test_torch_memory.py`` counts."""
    act = 2 if mixed_precision else 4
    saved = sum(_layer_saved_bytes(cfg, tokens, policy, KERNEL_IMPL,
                                   cfg.layer_uses_gmlp(i), act, tensor, seq=seq,
                                   meshed=meshed)
                for i in range(cfg.depth))
    saved += _head_saved_bytes(cfg, tokens, act)
    seq_local = cfg.seq_len // seq
    if not mixed_precision or policy != "none":
        # the f32 rotary tables: the blocks' inputs (remat) or what the f32
        # multiplies keep
        saved += 2 * _F32 * seq_local * cfg.dim_head
    return saved + _cast_bytes(cfg, policy, mixed_precision, tensor, seq_local)


def _block_param_numel(cfg, i: int, block: str | None = None) -> int:
    """Parameters of layer ``i``'s attention (``"attn"``) or feed-forward
    (``"ff"``) block, or of both."""
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    attn = d + d * 3 * inner + inner * d + d
    gmlp = cfg.layer_uses_gmlp(i)
    hidden = d * cfg.ff_mult * (1 if gmlp or not cfg.ff_glu else 2)
    ff = d + d * hidden + hidden
    if gmlp:
        half = (d * cfg.ff_mult) // 2
        ff += half + cfg.seq_len * cfg.seq_len + cfg.seq_len + half * half + half
        ff += half * d + d
    else:
        ff += (hidden // (2 if cfg.ff_glu else 1)) * d + d
    return {"attn": attn, "ff": ff, None: attn + ff}[block]


def _backward_peak(cfg, tokens: int, policy: str, act: int, tensor: int, seq: int,
                   meshed: bool, mixed_precision: bool, shard: int) -> tuple[int, int]:
    """``(activations, gradients)`` live at the backward's peak, walking its
    blocks from the last: before the backward every block's saved set and
    the head's; at block ``b`` the saved sets of the blocks below it, ``b``'s
    whole ``none`` set (a remat policy replays it, with its casts) and the
    f32 gradients of the head and every block above ``b``.  The largest
    ``ACT_EFFICIENCY[policy] * activations + gradients`` wins."""
    seq_local = cfg.seq_len // seq
    blocks = [(i, b) for i in range(cfg.depth) for b in ("attn", "ff")]
    saved = [_block_saved_bytes(cfg, tokens, policy, b, cfg.layer_uses_gmlp(i), act,
                                tensor, seq, meshed) for i, b in blocks]
    live = [_block_saved_bytes(cfg, tokens, "none", b, cfg.layer_uses_gmlp(i), act,
                               tensor, seq, meshed)
            + (_block_cast_bytes(cfg, i, b, mixed_precision, tensor, seq_local)
               if policy != "none" else 0) for i, b in blocks]
    grads = [4 * _block_param_numel(cfg, i, b) // shard for i, b in blocks]
    d = cfg.dim
    head_grads = 4 * (d + d * cfg.num_tokens + cfg.num_tokens) // shard
    eff = ACT_EFFICIENCY[policy]
    best = (sum(saved) + _head_saved_bytes(cfg, tokens, act), 0)
    above = head_grads
    for at in reversed(range(len(blocks))):
        here = sum(saved[:at]) + (live[at] if policy != "none" else saved[at])
        if eff * here + above > eff * best[0] + best[1]:
            best = (here, above)
        above += grads[at]
    return int(eff * best[0]), best[1]


def plan(
    cfg,
    *,
    batch_size: int,
    mesh_shape: dict | None = None,
    strategies: Sequence[str] = ("dp",),
    remat: bool = False,
    remat_policy: str = "full",
    attn_impl: str = KERNEL_IMPL,
    sgu_impl: str = KERNEL_IMPL,
    mixed_precision: bool = True,
    grad_accum_every: int = 1,
    checkpoint_snapshot: bool = False,
    superstep_k: int = 1,
) -> MemoryPlan:
    """Predict per-card device memory for one train step.

    ``batch_size`` is the GLOBAL micro-batch; ``mesh_shape`` like
    ``{"data": 1, "fsdp": 8, "tensor": 1, "seq": 1}`` (None: no mesh).
    ``superstep_k > 1`` adds the staged ``(K, accum, B, L + 1)`` superbatch
    buffers, two at steady state."""
    _check_impl(attn_impl, sgu_impl)
    meshed = mesh_shape is not None
    mesh_shape = mesh_shape or {}
    data = mesh_shape.get("data", 1)
    fsdp = mesh_shape.get("fsdp", 1)
    tensor = mesh_shape.get("tensor", 1) if "tp" in strategies else 1
    seq = mesh_shape.get("seq", 1) if "sp" in strategies else 1

    n = count_params(cfg)
    # fsdp shards every parameter, tp the qkv/mlp matrices: both modelled
    # as dividing the whole count (the replicated norms are noise)
    fsdp_ways = fsdp if "fsdp" in strategies else 1
    state_shard = fsdp_ways * tensor
    params_b = 4 * n // state_shard
    moments_b = 8 * n // state_shard
    accum_b = (4 * n // state_shard) if grad_accum_every > 1 else 0

    act = 2 if mixed_precision else 4
    # per-rank tokens: the batch over (data, fsdp), the sequence over seq
    tokens = batch_size * cfg.seq_len // (data * max(fsdp, 1) * seq)
    seq_local = cfg.seq_len // seq

    policy = remat_policy if remat else "none"
    act_b, grad_b = _backward_peak(cfg, tokens, policy, act, tensor, seq, meshed,
                                   mixed_precision, state_shard)

    cast_b = _cast_bytes(cfg, policy, mixed_precision, tensor, seq_local)
    logits_b = 2 * tokens * cfg.num_tokens * 4
    unshard_b = 0
    if "fsdp" in strategies:
        unshard_b = 2 * 4 * max(_block_param_numel(cfg, i)
                                for i in range(cfg.depth)) // tensor

    detail = {
        "tokens_per_chip": tokens,
        "state_shard_ways": state_shard,
        "remat": policy,
        "attn_impl": attn_impl,
        "sgu_impl": sgu_impl,
        # per-axis shard pricing (report() renders these as rows): weights
        # divide over (fsdp, tensor); tokens over (data, fsdp, seq); the
        # heads and mlp channels also over tensor (_layer_saved_bytes)
        "axis_shards": {
            "weights": {"fsdp": fsdp_ways, "tensor": tensor},
            "activations": {"data": data, "fsdp": max(fsdp, 1), "seq": seq,
                            "tensor": tensor},
        },
    }
    # the Trainer's background checkpoint keeps one device copy of the
    # whole state while the next steps run
    snapshot_b = (params_b + moments_b + accum_b) if checkpoint_snapshot else 0

    superbatch_b = 0
    if superstep_k > 1:
        rows = batch_size // (data * max(fsdp, 1))
        superbatch_b = (2 * superstep_k * max(1, grad_accum_every) * rows
                        * (cfg.seq_len + 1) * 4)
        detail["superstep_k"] = superstep_k

    return MemoryPlan(
        params_bytes=params_b,
        moments_bytes=moments_b,
        accumulator_bytes=accum_b,
        activation_bytes=act_b,
        cast_bytes=cast_b,
        logits_bytes=logits_b,
        num_params=n,
        detail=detail,
        snapshot_bytes=snapshot_b,
        superbatch_bytes=superbatch_b,
        grad_bytes=grad_b,
        unshard_bytes=unshard_b,
    )


def device_hbm_bytes(device=None) -> int | None:
    """Total memory of the local card, or None off a card (the gate then
    does nothing).

    ``device`` defaults to the rank's own current CUDA device, never device
    0 by number: in a run of several ranks a gate that reads another
    rank's card may pass on some ranks and raise on others, and the ranks
    that passed then hang in their first collective."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def check_fits(plan_: MemoryPlan, hbm_bytes: int | None,
               headroom: float = 0.02,
               device_kind: str | None = None) -> str | None:
    """None when the plan fits; otherwise a multi-line error message with
    the breakdown and the knobs most likely to make it fit.

    When ``device_kind`` is given and is NOT in
    :data:`CALIBRATED_DEVICE_KINDS`, an over-budget prediction only warns:
    the activation model was fitted on one card, and blocking a run on a
    card it was never checked against would turn a fit question into a
    failed first run."""
    if hbm_bytes is None:
        return None
    budget = hbm_bytes * (1 - headroom)
    if plan_.total_bytes <= budget:
        return None
    if device_kind is not None and device_kind not in CALIBRATED_DEVICE_KINDS:
        warnings.warn(
            f"memory plan predicts {plan_.total_bytes / GiB:.2f} GiB > "
            f"{hbm_bytes / GiB:.2f} GiB of device memory, but the planner is "
            f"calibrated only on {sorted(CALIBRATED_DEVICE_KINDS)}, not "
            f"{device_kind!r}: proceeding; if the step runs out of memory, "
            "apply the plan's suggestions or set PROGEN_SKIP_MEMORY_CHECK=1",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
    suggestions = []
    if (plan_.snapshot_bytes
            and plan_.total_bytes - plan_.snapshot_bytes <= budget):
        suggestions.append(
            "disable background checkpointing (--no_background_checkpoint): "
            "its on-device state snapshot is what does not fit")
    if plan_.activation_bytes > plan_.cast_bytes:
        if plan_.detail["remat"] == "none":
            suggestions.append("enable remat (--remat; --remat_policy attn first)")
        elif plan_.detail["remat"] == "dots":
            suggestions.append("try --remat_policy attn (slimmer saved set) or full")
        elif plan_.detail["remat"] == "attn":
            suggestions.append("use --remat_policy full (recompute more)")
        suggestions.append("reduce --batch_size (activations scale with it)")
    if plan_.state_bytes > 0.7 * budget:
        # the f32 state is the blocker: shard it harder
        total_state = plan_.state_bytes * plan_.detail["state_shard_ways"]
        ways = max(2, -(-total_state // int(budget * 0.6)))
        suggestions.append(
            f"the f32 optimizer state dominates the card: shard it (fsdp={ways} in "
            "--mesh, with 'fsdp' in --strategies)")
    return (
        f"predicted per-card memory {plan_.total_bytes / GiB:.2f} GiB exceeds the "
        f"card's {hbm_bytes / GiB:.2f} GiB (planner calibrated on "
        f"{sorted(CALIBRATED_DEVICE_KINDS)}; PROGEN_SKIP_MEMORY_CHECK=1 "
        "overrides):\n"
        f"{plan_.report()}\n"
        "try: " + "; ".join(suggestions or ["a bigger mesh"])
    )


# --------------------------------------------------------------- serving side


@dataclasses.dataclass(frozen=True)
class ServingMemoryPlan:
    """Predicted device memory of the ServingEngine's per-request decode
    state (the JAX plan's fields and sums).

    The pageable resource is the SGU gate cache, the one buffer that scales
    with ``max_len`` per slot (the k/v ring is a fixed ``2 * window`` and the
    carries are ``O(dim)``).  The dense engine allocates
    ``gate_bytes_per_slot`` for every slot up front; paged mode replaces
    ``num_slots * gate_bytes_per_slot`` with ``pool_bytes`` (+ an int32 page
    table)."""

    ring_bytes_per_slot: int
    carry_bytes_per_slot: int
    seq_bytes_per_slot: int
    gate_bytes_per_slot: int  # dense mode only (0 when paged)
    pool_bytes: int           # paged mode only (0 when dense)
    table_bytes: int
    num_slots: int
    # speculative decoding: the draft model's dense caches per slot
    draft_bytes_per_slot: int = 0
    # disaggregated serving: up to ``handoff_depth`` full handles in flight
    handoff_bytes: int = 0
    # the slot-resident (max_len, vocab) bool logit mask, always allocated
    lmask_bytes_per_slot: int = 0
    # the stacked multi-tenant LoRA bank, one copy for every slot
    adapter_bytes: int = 0
    # resident weights, f32 and the int8 re-typing; informational, not in
    # total_bytes (which counts the per-request decode state)
    weight_bytes_full: int = 0
    weight_bytes_int8: int = 0

    @property
    def fixed_bytes_per_slot(self) -> int:
        return (self.ring_bytes_per_slot + self.carry_bytes_per_slot
                + self.seq_bytes_per_slot + self.lmask_bytes_per_slot)

    @property
    def pageable_bytes(self) -> int:
        """The budgeted resource: dense per-slot gate slabs or the pool."""
        return self.num_slots * self.gate_bytes_per_slot + self.pool_bytes

    @property
    def total_bytes(self) -> int:
        return (self.num_slots * (self.fixed_bytes_per_slot
                                  + self.gate_bytes_per_slot
                                  + self.draft_bytes_per_slot)
                + self.pool_bytes + self.table_bytes
                + self.handoff_bytes + self.adapter_bytes)


def gate_row_bytes(cfg, mixed_precision: bool = True,
                   gate_dtype: str = "bf16") -> int:
    """Bytes of ONE token row of SGU gate state across all gMLP layers: the
    unit the dense slab and the page pool are made of.  ``gate_dtype="int8"``
    prices the 8-bit page format, 1 byte a channel plus one f32 scale per
    (row, layer)."""
    gmlp_layers = sum(1 for i in range(cfg.depth) if cfg.layer_uses_gmlp(i))
    half = (cfg.dim * cfg.ff_mult) // 2
    if gate_dtype == "int8":
        return gmlp_layers * (half + 4)
    if gate_dtype != "bf16":
        raise ValueError(f"gate_dtype {gate_dtype!r}: want 'bf16' or 'int8'")
    act = 2 if mixed_precision else 4
    return gmlp_layers * half * act


def weight_hbm_bytes(cfg, *, quantize: bool = False) -> int:
    """Resident weight bytes of a serving replica: the f32 parameters, or
    their int8 re-typing under ``quantize`` (dense kernels and the spatial
    weights 1 byte an element plus f32 per-channel or per-row scales; the
    embedding, norms, biases and logits head stay f32, ``ops/quant.py``'s
    skip set)."""
    if not quantize:
        return count_params(cfg) * 4
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    n = cfg.num_tokens * d * 4  # embed stays f32
    for i in range(cfg.depth):
        gmlp = cfg.layer_uses_gmlp(i)
        hidden = d * cfg.ff_mult * (1 if gmlp or not cfg.ff_glu else 2)
        n += d * 4                                   # attention norm
        n += d * 3 * inner + 3 * inner * 4           # qkv + scale
        n += inner * d + d * 4 + d * 4               # out + scale + bias
        n += d * 4                                   # ff norm
        n += d * hidden + hidden * 4 + hidden * 4    # proj_in + scale + bias
        if gmlp:
            half = (d * cfg.ff_mult) // 2
            L = cfg.seq_len
            n += half * 4                            # sgu norm
            n += L * L + L * 4 + L * 4               # spatial + row scale + bias
            n += half * half + half * 4 + half * 4   # sgu proj_out
            n += half * d + d * 4 + d * 4            # ff proj_out from half
        else:
            dout = hidden // (2 if cfg.ff_glu else 1)
            n += dout * d + d * 4 + d * 4            # ff proj_out
    n += d * 4 + d * cfg.num_tokens * 4 + cfg.num_tokens * 4  # logits head
    return n


def serving_plan(cfg, *, num_slots: int, max_len: int | None = None,
                 mixed_precision: bool = True, paged: bool = False,
                 page_size: int = 16, num_pages: int | None = None,
                 draft_cfg=None, disagg: bool = False,
                 handoff_depth: int = 2, lora_tenants: int = 0,
                 lora_rank: int = 0,
                 gate_dtype: str = "bf16") -> ServingMemoryPlan:
    """Device memory of a ServingEngine configuration (dense or paged), to
    ``decode/engine.py``'s state layout: k/v rings, carries and ``seq`` per
    slot always; per-slot ``(max_len, half)`` gate slabs in dense mode, the
    ``(num_pages, page_size, half)`` pool per gMLP layer in paged mode
    (``num_pages`` by default the engine's full budget).

    ``draft_cfg`` adds the draft's dense caches per slot; ``disagg`` the
    handoff queue's worst case (``handoff_depth`` handles of dense rows, the
    draft's caches too when both modes are on); the per-slot ``(max_len,
    vocab)`` bool logit mask is always counted; ``lora_tenants``/
    ``lora_rank`` add the stacked bank.  ``gate_dtype="int8"`` prices 8-bit
    gate pages (paged only, as the engine requires)."""
    from progen_tpu_torch.workloads.lora import adapter_bank_bytes

    act = 2 if mixed_precision else 4
    L = min(max_len or cfg.seq_len, cfg.seq_len)
    ring = 2 * cfg.window_size
    ring_b = cfg.depth * 2 * cfg.heads * ring * cfg.dim_head * act
    carry_b = cfg.depth * 2 * cfg.dim * act
    seq_b = L * 4
    lmask_b = L * cfg.num_tokens  # bool, 1 byte per (position, vocab) cell
    if gate_dtype != "bf16" and not paged:
        raise ValueError("gate_dtype='int8' requires paged=True: the 8-bit gate "
                         "format is a page format")
    row_b = gate_row_bytes(cfg, mixed_precision)
    pages_per_row = -(-L // page_size)
    if paged:
        if num_pages is None:
            num_pages = 2 + num_slots * pages_per_row
        pool_b = num_pages * page_size * gate_row_bytes(
            cfg, mixed_precision, gate_dtype=gate_dtype)
        gate_b = 0
        table_b = num_slots * pages_per_row * 4
    else:
        pool_b = 0
        gate_b = L * row_b
        table_b = 0
    draft_b = 0
    if draft_cfg is not None:
        d_ring = 2 * draft_cfg.window_size
        draft_b = (draft_cfg.depth * 2 * draft_cfg.heads * d_ring
                   * draft_cfg.dim_head * act
                   + draft_cfg.depth * 2 * draft_cfg.dim * act
                   + L * gate_row_bytes(draft_cfg, mixed_precision))
    handoff_b = 0
    if disagg:
        # a handle row carries the DENSE gate slab and the logit mask, with
        # ~40 B of per-row scalars
        per_row = (ring_b + carry_b + seq_b + lmask_b + L * row_b
                   + draft_b + 40)
        handoff_b = handoff_depth * num_slots * per_row
    adapter_b = adapter_bank_bytes(cfg, lora_tenants, lora_rank) if lora_tenants else 0
    return ServingMemoryPlan(
        ring_bytes_per_slot=ring_b,
        carry_bytes_per_slot=carry_b,
        seq_bytes_per_slot=seq_b,
        gate_bytes_per_slot=gate_b,
        pool_bytes=pool_b,
        table_bytes=table_b,
        num_slots=num_slots,
        draft_bytes_per_slot=draft_b,
        handoff_bytes=handoff_b,
        lmask_bytes_per_slot=lmask_b,
        adapter_bytes=adapter_b,
        weight_bytes_full=weight_hbm_bytes(cfg),
        weight_bytes_int8=weight_hbm_bytes(cfg, quantize=True),
    )


def equal_budget_pages(cfg, *, dense_slots: int, max_len: int,
                       page_size: int = 16,
                       gate_dtype: str = "bf16") -> int:
    """Pool size (total pages, the 2 reserved included) whose gate-row bytes
    match what ``dense_slots`` fixed slots pin; at ``int8`` the same bytes
    buy ~2x the pages (dense slabs are always bf16)."""
    budget = dense_slots * max_len * gate_row_bytes(cfg)
    pool_row = gate_row_bytes(cfg, gate_dtype=gate_dtype)
    return max(3, budget // (page_size * pool_row))
