"""ProGen model core in PyTorch (ported from progen_tpu/models/progen.py).

Natively batched ``(B, L) -> (B, L, num_tokens)``: byte-token embed ->
depth x [pre-LN windowed local attention, pre-LN feed-forward] -> LN +
logits head.  Numerics follow the JAX package: scale-only LayerNorm (eps
1e-5, f32 statistics, output in the compute dtype); token shift at the top
of both blocks; rotary on q, k AND v; GEGLU feed-forward with the tanh GELU
(``flax.linen.gelu``), swapped for the SGU/gMLP spatial gate in the last
``global_mlp_depth`` layers; bare residual adds; logits cast to the output
dtype.

The sequence mixing goes through the kernel wrappers, ``ops/cuda_attention``
and ``ops/cuda_sgu``: on the card the hand-written CUDA kernels, on the CPU
their plain versions.  Where the flax model ``sow``s decode caches, this one
fills the ``cache`` dict that ``forward(..., return_cache=True)`` returns,
keyed like flax's ``"cache"`` collection (without its one-element tuples).

Dense layers are ``nn.Linear`` (weight ``(out, in)``, the transpose of a
flax kernel; ``compat/convert.py`` carries weights across).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import Policy, make_policy
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.ops.rotary import apply_rotary_pos_emb, fixed_pos_embedding
from progen_tpu_torch.ops.shift import shift_tokens

# kwargs the reference accepts but never reads, plus CLI-level kwargs
_IGNORED_CONFIG_KEYS = ("clamp_gate", "attn_dim", "mixed_precision")
# flax's truncated-normal correction: the std of N(0, 1) cut at +-2
_TRUNC_STD = 0.87962566103423978
_NORM_EPS = 1e-5  # Haiku's LayerNorm default, kept by the JAX package


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

    def layer_uses_gmlp(self, i: int) -> bool:
        """Layer i (0-based) uses the SGU/gMLP feed-forward iff it is among
        the last ``global_mlp_depth`` layers."""
        return (self.depth - i) <= self.global_mlp_depth


class LayerNorm(nn.Module):
    """Scale-only LayerNorm as flax computes it under a bf16 ``dtype``:
    mean and ``E[x^2] - mean^2`` (clipped at 0) in f32, the f32 scale folded
    into the rsqrt, the result cast to the compute dtype."""

    def __init__(self, dim: int, policy: Policy, device=None):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=policy.param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + _NORM_EPS) * self.scale.float()
        return ((xf - mean) * mul).to(self.compute_dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in the compute dtype, bias added after the
    product's rounding, as flax's ``Dense(dtype=...)`` does."""

    def __init__(self, din: int, dout: int, *, bias: bool, policy: Policy,
                 device=None):
        super().__init__(din, dout, bias=bias, device=device,
                         dtype=policy.param_dtype)
        self.compute_dtype = policy.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)


class LocalAttention(nn.Module):
    """Pre-LN windowed attention block: fused bias-free QKV projection,
    output projection with bias."""

    def __init__(self, config: ProGenConfig, policy: Policy, device=None):
        super().__init__()
        c = config
        inner = c.heads * c.dim_head
        self.window_size = c.window_size
        self.heads = c.heads
        self.dim_head = c.dim_head
        self.shift = c.shift_tokens
        self.norm = LayerNorm(c.dim, policy, device=device)
        self.to_qkv = Dense(c.dim, 3 * inner, bias=False, policy=policy,
                            device=device)
        self.to_out = Dense(inner, c.dim, bias=True, policy=policy,
                            device=device)

    def forward(self, x, sin, cos, cache: dict | None = None):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        x = self.norm(x)
        if cache is not None:
            cache["prev"] = x  # post-norm PRE-shift: the decode shift carry
        if self.shift:
            x = shift_tokens(x)
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in (q, k, v))
        # rotary on q, k AND v
        q, k, v = (apply_rotary_pos_emb(t, sin, cos).contiguous()
                   for t in (q, k, v))
        if cache is not None:
            cache["k"] = k  # post-rotary k/v: what the decode rings hold
            cache["v"] = v
        out, _ = cuda_attention.local_attention_fwd(
            q, k, v, self.window_size, d ** -0.5)
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.to_out(out)


class SGU(nn.Module):
    """gMLP spatial gating unit: learned causal ``(n, n)`` token mixing of
    the LayerNormed gate half, then a projection."""

    def __init__(self, seq_len: int, dim_out: int, policy: Policy,
                 device=None):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        self.norm = LayerNorm(dim_out, policy, device=device)
        self.spatial_weights = nn.Parameter(torch.empty(
            seq_len, seq_len, dtype=policy.param_dtype, device=device))
        self.spatial_biases = nn.Parameter(torch.ones(
            seq_len, 1, dtype=policy.param_dtype, device=device))
        self.proj_out = Dense(dim_out, dim_out, bias=True, policy=policy,
                              device=device)

    def forward(self, x, cache: dict | None = None):
        res, gate = x.chunk(2, dim=-1)
        gate = self.norm(gate)
        if cache is not None:
            cache["gate"] = gate  # normed gate rows: the decode gate cache
        # an input shorter than seq_len (a prefill) uses the leading L rows
        # and columns: exact, since row m only reads columns <= m < L
        n = gate.shape[-2]
        cd = self.compute_dtype
        w = self.spatial_weights[:n, :n].to(cd).contiguous()
        b = self.spatial_biases[:n].to(cd).contiguous()
        x = cuda_sgu.spatial_gate_fwd(res.contiguous(), gate.contiguous(), w, b)
        return self.proj_out(x)


class FeedForward(nn.Module):
    """Pre-LN MLP: GEGLU, or GELU then the SGU in the gMLP layers."""

    def __init__(self, config: ProGenConfig, use_sgu: bool, policy: Policy,
                 device=None):
        super().__init__()
        c = config
        self.glu = c.ff_glu and not use_sgu
        self.shift = c.shift_tokens
        hidden = c.dim * c.ff_mult * (2 if self.glu else 1)
        self.norm = LayerNorm(c.dim, policy, device=device)
        self.proj_in = Dense(c.dim, hidden, bias=True, policy=policy,
                             device=device)
        self.sgu = (SGU(c.seq_len, hidden // 2, policy, device=device)
                    if use_sgu else None)
        # GLU and the SGU each halve the hidden width
        width = hidden // 2 if (self.glu or use_sgu) else hidden
        self.proj_out = Dense(width, c.dim, bias=True, policy=policy,
                              device=device)

    def forward(self, x, cache: dict | None = None):
        x = self.norm(x)
        if cache is not None:
            cache["prev"] = x
        if self.shift:
            x = shift_tokens(x)
        x = self.proj_in(x)
        if self.glu:
            x, gate = x.chunk(2, dim=-1)
            x = x * F.gelu(gate, approximate="tanh")
        else:
            x = F.gelu(x, approximate="tanh")
        if self.sgu is not None:
            sub = None
            if cache is not None:
                sub = cache["sgu"] = {}
            x = self.sgu(x, sub)
        return self.proj_out(x)


class ProGen(nn.Module):
    """Embed -> depth x [LocalAttention, FeedForward] -> LN + logits head.

    ``device=None`` means ``cuda`` (raising without a card); the tests pass
    ``device="cpu"``.  Parameters start as the JAX package's initialisers
    draw them (:meth:`init_weights`), from ``seed``.
    """

    def __init__(self, config: ProGenConfig, policy: Policy | None = None,
                 device=None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        self.policy = policy or make_policy()
        dev = resolve_device(device)
        self.embed = nn.Embedding(c.num_tokens, c.dim, device=dev,
                                  dtype=self.policy.param_dtype)
        self.attn = nn.ModuleList(
            LocalAttention(c, self.policy, device=dev) for _ in range(c.depth))
        self.ff = nn.ModuleList(
            FeedForward(c, c.layer_uses_gmlp(i), self.policy, device=dev)
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
        every device gets the same weights."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, Dense):
                std = math.sqrt(1.0 / module.in_features) / _TRUNC_STD
                w = torch.empty(module.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=gen)
                module.weight.copy_(w)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, SGU):
                n = module.spatial_weights.shape[0]
                bound = 1e-3 / n
                w = torch.empty(module.spatial_weights.shape)
                w.uniform_(-bound, bound, generator=gen)
                module.spatial_weights.copy_(w)
                module.spatial_biases.fill_(1.0)
            elif isinstance(module, LayerNorm):
                module.scale.fill_(1.0)
        w = torch.empty(self.embed.weight.shape)
        w.normal_(0.0, math.sqrt(1.0 / self.config.dim), generator=gen)
        self.embed.weight.copy_(w)

    def forward(self, tokens: torch.Tensor, return_cache: bool = False):
        """``tokens (B, L)`` int -> logits ``(B, L, V)`` in the output dtype;
        with ``return_cache=True``, ``(logits, cache)`` where ``cache`` holds
        per layer the intermediates prefill harvests: ``cache["attn{i}"]``
        has ``prev`` (post-norm, pre-shift), ``k`` and ``v`` (post-rotary,
        ``(B, H, L, Dh)``); ``cache["ff{i}"]`` has ``prev`` and, in the gMLP
        layers, ``sgu: {gate}`` (the normed gate)."""
        cfg = self.config
        if tokens.dim() != 2:
            raise ValueError(
                f"ProGen takes batched (B, L) int tokens, got shape "
                f"{tuple(tokens.shape)}")
        n = tokens.shape[1]
        if cfg.global_mlp_depth > 0 and n > cfg.seq_len:
            raise ValueError(
                f"input length {n} > config.seq_len {cfg.seq_len}: the gMLP "
                "layers' learned (seq_len, seq_len) spatial weights have no "
                "rows past seq_len")
        cd = self.policy.compute_dtype
        x = F.embedding(tokens, self.embed.weight.to(cd))
        # rotary tables computed once, shared by all layers; f32, cast inside
        sin, cos = fixed_pos_embedding(n, cfg.dim_head, device=tokens.device)
        cache: dict[str, dict] | None = {} if return_cache else None
        for i in range(cfg.depth):
            attn_c = ff_c = None
            if cache is not None:
                attn_c = cache[f"attn{i}"] = {}
                ff_c = cache[f"ff{i}"] = {}
            x = x + self.attn[i](x, sin, cos, attn_c)
            x = x + self.ff[i](x, ff_c)
        logits = self.policy.cast_to_output(self.to_logits(self.norm_out(x)))
        if return_cache:
            return logits, cache
        return logits
