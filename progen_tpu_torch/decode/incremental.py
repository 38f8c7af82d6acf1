"""Single-token decode step with an O(window) attention cache
(ported from progen_tpu/decode/incremental.py).

The model carries three kinds of sequence state from one position to the
next:

* **token shift** needs the previous position's POST-NORM activations in
  each block -> one ``(B, dim)`` carry per block;
* **local windowed attention** at position i attends keys in
  ``[prev_window_start(i), i]``, at most ``2*window`` positions -> a RING
  BUFFER of post-rotary k/v per layer, slot ``pos % (2*window)``.  Slot s
  holds position ``p_s = pos - ((pos - s) mod 2w)`` and is attendable iff
  ``p_s >= window_start(pos) - window``; there is no ``p_s >= 0`` clause,
  so the untouched zero slots of window 0 reproduce the phantom zero-pad
  window;
* **SGU/gMLP** mixes ALL previous positions through a learned causal row
  -> a ``(B, n_rows, hidden/2)`` cache of normed gate activations per gMLP
  layer; step m contracts the cache with weight row m (masked to ``n <= m``).

The step runs the parallel model's own modules (``models/progen.py``), so
both share one set of parameters.  It has no kernel: its products are
matrix-vector sized and stay plain PyTorch.  Caches are updated IN PLACE
(the JAX step returns new ones); ``ProGenDecodeStep`` returns the same dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import Policy, make_policy
from progen_tpu_torch.models.progen import (
    SGU,
    FeedForward,
    LocalAttention,
    ProGen,
    ProGenConfig,
)
from progen_tpu_torch.ops.local_attention import ATTN_MASK_VALUE
from progen_tpu_torch.ops.rotary import fixed_pos_embedding, rotate_every_two


def _shift_with_carry(h: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift at one position: the first ceil(d/2) channels come from
    the previous position."""
    split = h.shape[-1] - h.shape[-1] // 2
    return torch.cat([prev[..., :split], h[..., split:]], dim=-1)


def _rotate_at(x, sin_row, cos_row):
    """Rotary for one position per row: ``x (B, h, d)``, rows ``(B, d)``."""
    return x * cos_row[:, None, :] + rotate_every_two(x) * sin_row[:, None, :]


def init_caches(config: ProGenConfig, batch_size: int,
                policy: Policy | None = None, decode_len: int | None = None,
                device=None) -> dict:
    """Zero caches for a fresh decode, on ``device`` (default ``cuda``).
    ``decode_len`` (default ``seq_len``) sizes the SGU gate cache, the one
    seq_len-sized buffer."""
    c = config
    device = resolve_device(device)
    dt = (policy or make_policy()).compute_dtype
    ring = 2 * c.window_size
    n_rows = min(decode_len or c.seq_len, c.seq_len)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "attn_prev": [zeros(batch_size, c.dim) for _ in range(c.depth)],
        "ff_prev": [zeros(batch_size, c.dim) for _ in range(c.depth)],
        "k": [zeros(batch_size, c.heads, ring, c.dim_head)
              for _ in range(c.depth)],
        "v": [zeros(batch_size, c.heads, ring, c.dim_head)
              for _ in range(c.depth)],
        "sgu_gate": {str(i): zeros(batch_size, n_rows, (c.dim * c.ff_mult) // 2)
                     for i in range(c.depth) if c.layer_uses_gmlp(i)},
    }


def local_attention_decode(block: LocalAttention, x, sin_row, cos_row, slot,
                           valid, prev, k_cache, v_cache):
    """One-position attention of ``block`` against its k/v ring (the JAX
    ``LocalAttentionDecode``).  Writes this position's k/v into ring slot
    ``slot`` in place; returns ``(out, new_prev)``."""
    b = x.shape[0]
    h, d = block.heads, block.dim_head
    normed = block.norm(x)
    new_prev = normed
    if block.shift:
        normed = _shift_with_carry(normed, prev)
    q, k, v = block.to_qkv(normed).chunk(3, dim=-1)
    q, k, v = (_rotate_at(t.reshape(b, h, d), sin_row, cos_row)
               for t in (q, k, v))
    rows = torch.arange(b, device=x.device)
    k_cache[rows, :, slot] = k
    v_cache[rows, :, slot] = v
    sim = torch.einsum("bhd,bhsd->bhs", q.float(), k_cache.float()) * d ** -0.5
    sim = sim.masked_fill(~valid[:, None, :], ATTN_MASK_VALUE)
    attn = torch.softmax(sim, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhs,bhsd->bhd", attn.float(), v_cache.float())
    out = out.to(v_cache.dtype).reshape(b, h * d)
    return block.to_out(out), new_prev


def sgu_decode(block: SGU, x, pos, gate_cache):
    """One-position spatial gate (the JAX ``SGUDecode``): write this
    position's normed gate row into ``gate_cache`` in place, contract the
    cache with weight row ``pos`` (f32 weights masked to ``n <= pos``, f32
    product, ``+ bias`` in f32, cast), then ``res * mixed``."""
    res, gate = x.chunk(2, dim=-1)
    gate = block.norm(gate)
    n_cache = gate_cache.shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    gate_cache[rows, pos] = gate
    w_rows = block.spatial_weights.float()[pos][:, :n_cache]  # (B, n_cache)
    causal = torch.arange(n_cache, device=x.device)[None, :] <= pos[:, None]
    w_rows = w_rows * causal.float()
    mixed = torch.einsum("bnd,bn->bd", gate_cache.float(), w_rows)
    mixed = (mixed + block.spatial_biases.float()[pos]).to(res.dtype)
    return block.proj_out(res * mixed)


def feed_forward_decode(block: FeedForward, x, pos, prev, gate_cache):
    """One-position feed-forward (the JAX ``FeedForwardDecode``); returns
    ``(out, new_prev)``."""
    normed = block.norm(x)
    new_prev = normed
    if block.shift:
        normed = _shift_with_carry(normed, prev)
    h = block.proj_in(normed)
    if block.glu:
        h, gate = h.chunk(2, dim=-1)
        h = h * F.gelu(gate, approximate="tanh")
    else:
        h = F.gelu(h, approximate="tanh")
    if block.sgu is not None:
        h = sgu_decode(block.sgu, h, pos, gate_cache)
    return block.proj_out(h), new_prev


class ProGenDecodeStep:
    """One decode step of ``model``:
    ``(tok (B,), pos, caches) -> (logits (B, V), caches)``.

    ``pos`` is an int or a ``(B,)`` tensor (each row at its own position).
    The rotary tables are built once, for all ``seq_len`` positions.
    """

    def __init__(self, model: ProGen):
        self.model = model
        cfg = model.config
        self.sin, self.cos = fixed_pos_embedding(cfg.seq_len, cfg.dim_head,
                                                 device=model.device)

    @torch.no_grad()
    def __call__(self, tok: torch.Tensor, pos, caches: dict):
        model = self.model
        cfg, pol = model.config, model.policy
        wsz = cfg.window_size
        ring = 2 * wsz
        b = tok.shape[0]
        dev = tok.device
        x = F.embedding(tok, model.embed.weight.to(pol.compute_dtype))
        pos = torch.as_tensor(pos, dtype=torch.long, device=dev).expand(b)
        sin_row = self.sin[pos].to(pol.compute_dtype)
        cos_row = self.cos[pos].to(pol.compute_dtype)
        slot = pos % ring
        s = torch.arange(ring, device=dev)[None, :]
        p_s = pos[:, None] - torch.remainder(pos[:, None] - s, ring)
        w_start = ((pos // wsz) * wsz)[:, None]
        valid = p_s >= w_start - wsz  # no p_s >= 0 clause: phantom window

        for i in range(cfg.depth):
            attn_out, caches["attn_prev"][i] = local_attention_decode(
                model.attn[i], x, sin_row, cos_row, slot, valid,
                caches["attn_prev"][i], caches["k"][i], caches["v"][i])
            x = x + attn_out
            ff_out, caches["ff_prev"][i] = feed_forward_decode(
                model.ff[i], x, pos, caches["ff_prev"][i],
                caches["sgu_gate"].get(str(i)))
            x = x + ff_out
        logits = model.to_logits(model.norm_out(x))
        return pol.cast_to_output(logits), caches
