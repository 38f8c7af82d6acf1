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
both share one set of parameters (full precision or ``weights="int8"``).
Caches are updated IN PLACE (the JAX step returns new ones); the step
returns the same dict.  A caller that must keep the old state (the serving
engine, which replaces its state only when a dispatch succeeded) hands the
step a copy.

:class:`ProGenDecodeStep` has no kernel: its products are matrix-vector
sized and stay plain PyTorch.  :class:`ProGenPagedDecodeStep` is the paged
engine's step: the gMLP layers keep their gate rows in a global page pool
(:func:`init_gate_pool`) behind a per-row page table, and contract them
through ``ops/cuda_paged_gate_mix.py`` (on the card the hand-written K3 or
K3-q8 kernel).  It takes a ``write_ok`` mask and DROPS every write of a row
that is not live: the pool scatter goes to the dump page, and the k/v ring
and the token-shift carries keep their old values.  A paused row's carries
still hold position ``pos - 1``; a discarded step that overwrote them would
corrupt the real step after the pause.
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
from progen_tpu_torch.ops.cuda_paged_gate_mix import paged_gate_mix, write_gate_row
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
                device=None, with_sgu: bool = True) -> dict:
    """Zero caches for a fresh decode, on ``device`` (default ``cuda``).
    ``decode_len`` (default ``seq_len``) sizes the SGU gate cache, the one
    seq_len-sized buffer.  ``with_sgu=False`` leaves that cache out: the
    paged engine keeps gate rows in a page pool (:func:`init_gate_pool`)."""
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
                     for i in range(c.depth) if c.layer_uses_gmlp(i)}
        if with_sgu else {},
    }


def init_gate_pool(config: ProGenConfig, num_pages: int, page_size: int,
                   policy: Policy | None = None, gate_dtype: str = "bf16",
                   device=None) -> dict:
    """Zero global gate-row pool, one ``(num_pages, page_size, hidden/2)``
    tensor per gMLP layer (keyed like ``sgu_gate``).  Page 0 is the all-zeros
    NULL page and stays zero; page 1 is the write-sink DUMP page.
    ``gate_dtype="bf16"`` means the compute dtype; ``"int8"`` the 8-bit page
    format, whose rows are quantized per row on scatter against the f32
    scale pool of :func:`init_gate_scale`."""
    c = config
    if gate_dtype == "int8":
        dt = torch.int8
    elif gate_dtype == "bf16":
        dt = (policy or make_policy()).compute_dtype
    else:
        raise ValueError(f"unknown gate_dtype {gate_dtype!r}; use 'bf16' or 'int8'")
    device = resolve_device(device)
    half = (c.dim * c.ff_mult) // 2
    return {str(i): torch.zeros(num_pages, page_size, half, dtype=dt, device=device)
            for i in range(c.depth) if c.layer_uses_gmlp(i)}


def init_gate_scale(config: ProGenConfig, num_pages: int, page_size: int,
                    device=None) -> dict:
    """Per-row f32 scale pool of the int8 gate pages, one ``(num_pages,
    page_size)`` tensor per gMLP layer; ones, so a row never written
    dequantizes to exact zeros."""
    device = resolve_device(device)
    return {str(i): torch.ones(num_pages, page_size, dtype=torch.float32,
                               device=device)
            for i in range(config.depth) if config.layer_uses_gmlp(i)}


def _keep_live(new, old, write_ok):
    """``new`` for rows where ``write_ok``, else ``old``."""
    if write_ok is None:
        return new
    return torch.where(write_ok.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def local_attention_decode(block: LocalAttention, x, sin_row, cos_row, slot,
                           valid, prev, k_cache, v_cache, write_ok=None):
    """One-position attention of ``block`` against its k/v ring (the JAX
    ``LocalAttentionDecode``).  Writes this position's k/v into ring slot
    ``slot`` in place; returns ``(out, new_prev)``.  With ``write_ok``
    ``(B,)`` bool, rows where it is false write nothing: their ring slot and
    their carry stay as they were (and their output is not to be used)."""
    b = x.shape[0]
    h, d = block.heads, block.dim_head
    normed = block.norm(x)
    new_prev = _keep_live(normed, prev, write_ok)
    if block.shift:
        normed = _shift_with_carry(normed, prev)
    q, k, v = block.to_qkv(normed).chunk(3, dim=-1)
    q, k, v = (_rotate_at(t.reshape(b, h, d), sin_row, cos_row)
               for t in (q, k, v))
    rows = torch.arange(b, device=x.device)
    k_cache[rows, :, slot] = _keep_live(k, k_cache[rows, :, slot], write_ok)
    v_cache[rows, :, slot] = _keep_live(v, v_cache[rows, :, slot], write_ok)
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
    w_rows = block.spatial_weights[pos].float()[:, :n_cache]  # (B, n_cache)
    if block.spatial_weights_scale is not None:
        # int8 weights: each batch row reads weight row pos[b] and its scale
        w_rows = w_rows * block.spatial_weights_scale[pos][:, None]
    causal = torch.arange(n_cache, device=x.device)[None, :] <= pos[:, None]
    w_rows = w_rows * causal.float()
    mixed = torch.einsum("bnd,bn->bd", gate_cache.float(), w_rows)
    mixed = (mixed + block.spatial_biases.float()[pos]).to(res.dtype)
    return block.proj_out(res * mixed)


def sgu_decode_paged(block: SGU, x, pos, pos32, pool, table, write_ok, n_rows,
                     pool_scale=None):
    """One-position spatial gate against the global page pool (the JAX
    ``SGUDecodePaged``): scatter this position's normed gate row into the
    row's current page (rows with ``write_ok`` false go to the dump page;
    an int8 pool quantizes the row on the way, its scale into
    ``pool_scale``), then the ragged paged contraction.  Under
    ``weights="int8"`` the int8 weight rows and their scales go INTO the
    kernel, not dequantized outside it.  ``pos`` is int64, ``pos32`` and
    ``table`` int32 (what the kernel takes)."""
    res, gate = x.chunk(2, dim=-1)
    gate = block.norm(gate)
    write_gate_row(pool, table, pos, gate, write_ok, scale=pool_scale)
    mixed = paged_gate_mix(block.spatial_weights, block.spatial_biases, pool,
                           table, pos32, n_rows=n_rows,
                           w_scale=block.spatial_weights_scale,
                           pool_scale=pool_scale)
    return block.proj_out(res * mixed.to(res.dtype))


def feed_forward_decode(block: FeedForward, x, pos, prev, gate_cache,
                        write_ok=None, paged=None):
    """One-position feed-forward (the JAX ``FeedForwardDecode`` and
    ``FeedForwardDecodePaged``); returns ``(out, new_prev)``.  ``paged``
    (a gMLP layer of the paged step) holds ``pos32``, ``pool``, ``table``,
    ``n_rows`` and ``pool_scale`` in place of ``gate_cache``."""
    normed = block.norm(x)
    new_prev = _keep_live(normed, prev, write_ok)
    if block.shift:
        normed = _shift_with_carry(normed, prev)
    h = block.proj_in(normed)
    if block.glu:
        h, gate = h.chunk(2, dim=-1)
        h = h * F.gelu(gate, approximate="tanh")
    else:
        h = F.gelu(h, approximate="tanh")
    if block.sgu is not None and paged is not None:
        h = sgu_decode_paged(block.sgu, h, pos, write_ok=write_ok, **paged)
    elif block.sgu is not None:
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
        return self._run(tok, pos, caches)

    def _paged_layer(self, i: int, caches: dict, pos32, table) -> dict | None:
        """What a gMLP layer of the paged step reads in place of a dense
        gate cache; ``None`` here: this step keeps dense caches."""
        return None

    def _run(self, tok, pos, caches, table=None, write_ok=None):
        model = self.model
        cfg, pol = model.config, model.policy
        wsz = cfg.window_size
        ring = 2 * wsz
        b = tok.shape[0]
        dev = tok.device
        x = F.embedding(tok, model.embed.weight.to(pol.compute_dtype))
        pos = torch.as_tensor(pos, dtype=torch.long, device=dev).expand(b)
        pos32 = pos.to(torch.int32)
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
                caches["attn_prev"][i], caches["k"][i], caches["v"][i],
                write_ok)
            x = x + attn_out
            paged = (self._paged_layer(i, caches, pos32, table)
                     if cfg.layer_uses_gmlp(i) else None)
            ff_out, caches["ff_prev"][i] = feed_forward_decode(
                model.ff[i], x, pos, caches["ff_prev"][i],
                caches.get("sgu_gate", {}).get(str(i)), write_ok, paged)
            x = x + ff_out
        logits = model.to_logits(model.norm_out(x))
        return pol.cast_to_output(logits), caches


class ProGenPagedDecodeStep(ProGenDecodeStep):
    """One paged decode step of ``model``: ``(tok (B,), pos, caches, table,
    write_ok) -> (logits (B, V), caches)``.

    The same step as :class:`ProGenDecodeStep`, except that the gMLP layers
    read and write the global gate-row pool (``caches["sgu_pool"]``, with
    ``caches["sgu_pool_scale"]`` beside it when ``gate_dtype="int8"``)
    through the per-row page ``table`` ``(B, pages_per_row)`` int32.
    ``write_ok`` ``(B,)`` bool: rows where it is false (paused, done,
    inactive) write NOTHING, neither pool rows nor ring slots nor carries;
    their logits are not to be used.  ``n_rows`` is the dense cache length
    the plain contraction slices to (the engine's ``max_len``), which keeps
    it bit-identical to the dense step on the CPU.
    """

    def __init__(self, model: ProGen, n_rows: int, gate_dtype: str = "bf16"):
        super().__init__(model)
        if gate_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown gate_dtype {gate_dtype!r}; use 'bf16' or 'int8'")
        self.n_rows = n_rows
        self.gate_dtype = gate_dtype

    @torch.no_grad()
    def __call__(self, tok: torch.Tensor, pos, caches: dict, table: torch.Tensor,
                 write_ok: torch.Tensor):
        return self._run(tok, pos, caches, table, write_ok)

    def _paged_layer(self, i, caches, pos32, table):
        scale = (caches["sgu_pool_scale"][str(i)]
                 if self.gate_dtype == "int8" else None)
        return {"pos32": pos32, "pool": caches["sgu_pool"][str(i)],
                "table": table, "n_rows": self.n_rows, "pool_scale": scale}
