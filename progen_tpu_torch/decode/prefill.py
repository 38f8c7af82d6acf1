"""One-pass parallel prefill: prime the decode caches with ONE forward
(ported from progen_tpu/decode/prefill.py).

The prime goes through the batched parallel forward once (on the card: the
windowed-attention and SGU kernels), and the per-layer state the decode
step needs is harvested from the forward's intermediates:

* **k/v rings**: ring slot ``s`` receives the LAST prime position congruent
  to ``s`` mod ``2w``; slots with no such position stay zero (the phantom
  zero-pad window before position 0);
* **token-shift carries**: row ``lengths[b] - 1`` of each block's post-norm
  activations;
* **SGU gate caches**: rows ``[0, lengths[b])`` of the normed gate; later
  rows stay zero (decode writes them before they are causally readable).

``lengths`` is per row, so one padded ``(B, P_pad)`` call primes rows of
different prime lengths.  ``P_pad`` is a multiple of ``window_size`` and
``<= seq_len``; the right-pad tokens never reach a harvested value.

:func:`make_embedder` is the embeddings endpoint's program on the same
ragged contract: one forward to the final hidden states, mean-pooled over
each row's real positions.

Under a mesh (``mesh=``, the ``DecodeMesh`` of ``parallel/decode.py``) the
forward runs in the model's shardings with no sequence split: the whole
prime on every rank, K1 through its halo entry (the zero window) and K2 on
the rank's gate channels under ``tp``; the harvested caches are then the
rank's heads and channels, as JAX's ``_constrain_caches`` lays them out.
"""

from __future__ import annotations

import torch

from progen_tpu_torch.core.precision import Policy
from progen_tpu_torch.decode.paging import DUMP_PAGE
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.ops.quant import quantize_rows


def pad_prime_length(p: int, window_size: int, seq_len: int,
                     bucket: bool = False) -> int:
    """Padded prefill length for a ``p``-token prime: a multiple of
    ``window_size`` capped at ``seq_len``.  With ``bucket=True`` the length
    also rounds up to ``window_size * 2^k``, so the serving engine's
    admission sees O(log(seq_len / window)) prefill shapes (the padded
    length is part of the prefix-cache key)."""
    if not (0 < p <= seq_len):
        raise ValueError(f"prime length {p} must be in (0, {seq_len}]")
    windows = -(-p // window_size)
    if bucket:
        b = 1
        while b < windows:
            b *= 2
        windows = b
    return min(windows * window_size, seq_len)


def prime_buckets(window_size: int, seq_len: int,
                  max_prime: int | None = None) -> list[int]:
    """Every bucketed prefill length a serving engine can dispatch:
    ``window_size * 2^k`` capped at ``seq_len``, for primes up to
    ``max_prime`` (default ``seq_len``)."""
    cap = min(max_prime or seq_len, seq_len)
    out: list[int] = []
    p = 1
    while p <= cap:
        b = pad_prime_length(p, window_size, seq_len, bucket=True)
        if not out or b != out[-1]:
            out.append(b)
        if b >= cap:
            break
        p = b + 1
    return out


def _take_row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, L, ...)``, ``idx (B,)`` -> ``x[b, idx[b]] (B, ...)``."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def harvest_caches(config: ProGenConfig, sown: dict, lengths: torch.Tensor,
                   policy: Policy, decode_len: int,
                   with_sgu: bool = True) -> dict:
    """Decode caches from the parallel forward's ``cache`` dict, per row
    masked to ``lengths``.  ``with_sgu=False`` leaves out the dense per-row
    gate cache: the paged engine scatters gate rows straight into the page
    pool (:func:`harvest_gate_pages`)."""
    c = config
    cd = policy.compute_dtype
    ring = 2 * c.window_size
    n_rows = min(decode_len, c.seq_len)
    lengths = lengths.long()
    last = lengths - 1  # (B,)
    dev = lengths.device

    caches: dict = {"attn_prev": [], "ff_prev": [], "k": [], "v": [],
                    "sgu_gate": {}}
    s = torch.arange(ring, device=dev)[None, :]
    q_s = last[:, None] - torch.remainder(last[:, None] - s, ring)  # (B, ring)
    live = (q_s >= 0)[:, None, :, None]
    for i in range(c.depth):
        attn, ff = sown[f"attn{i}"], sown[f"ff{i}"]
        caches["attn_prev"].append(_take_row(attn["prev"], last))
        caches["ff_prev"].append(_take_row(ff["prev"], last))
        k_all, v_all = attn["k"], attn["v"]  # (B, H, P_pad, Dh)
        idx = q_s.clamp_min(0)[:, None, :, None].expand(
            -1, k_all.shape[1], -1, k_all.shape[3])
        for name, t in (("k", k_all), ("v", v_all)):
            ring_rows = torch.gather(t, 2, idx)
            caches[name].append(
                torch.where(live, ring_rows, torch.zeros_like(ring_rows)).to(cd))
        if c.layer_uses_gmlp(i) and with_sgu:
            gate = ff["sgu"]["gate"]  # (B, P_pad, hidden/2)
            b, p_pad, half = gate.shape
            rows = torch.zeros(b, n_rows, half, dtype=cd, device=dev)
            upto = min(p_pad, n_rows)
            keep = torch.arange(upto, device=dev)[None, :, None] < lengths[:, None, None]
            rows[:, :upto] = torch.where(keep, gate[:, :upto],
                                         torch.zeros_like(gate[:, :upto])).to(cd)
            caches["sgu_gate"][str(i)] = rows
    return caches


def harvest_gate_pages(config: ProGenConfig, sown: dict,
                       lengths: torch.Tensor, pool: dict, wtable: torch.Tensor,
                       policy: Policy, pool_scale: dict | None = None, group=None):
    """Scatter the prefill's gate rows into a copy of the page pool.

    Prime row ``i`` of request ``b`` goes to pool page
    ``wtable[b, i // page_size]`` at offset ``i % page_size``.  ``wtable``
    is the WRITE table: the request's freshly allocated private pages, and
    ``DUMP_PAGE`` for what it must not write (prefix-cache hits, unowned
    tail entries).  Pad rows (``i >= lengths[b]``) go to ``DUMP_PAGE`` too,
    so the scatter stays dense.  A window-aligned ``P_pad`` can overshoot
    the table's span; the page index is clamped, and every overshooting row
    is a pad row.

    With ``pool_scale`` (the f32 twin of an int8 pool) each gate row is
    quantized per row before the scatter and the call returns
    ``(new_pool, new_scale)``.  The given pools are left untouched.
    ``group``: the gate rows are a rank's channels over a tensor group; an
    int8 row's scale is the whole row's."""
    new_pool = dict(pool)
    new_scale = dict(pool_scale) if pool_scale is not None else None
    lengths = lengths.long()
    wtable = wtable.long()
    for i in range(config.depth):
        if not config.layer_uses_gmlp(i):
            continue
        gate = sown[f"ff{i}"]["sgu"]["gate"]  # (B, P_pad, half), normed
        b, p_pad, half = gate.shape
        layer_pool = pool[str(i)].clone()  # (num_pages, page_size, half)
        page_size = layer_pool.shape[1]
        rows = torch.arange(p_pad, device=gate.device)
        page_idx = (rows // page_size).clamp_max(wtable.shape[1] - 1)
        tgt = wtable[:, page_idx]  # (B, P_pad)
        tgt = torch.where(rows[None, :] < lengths[:, None], tgt, DUMP_PAGE)
        tgt = tgt.reshape(-1)
        off = (rows % page_size).expand(b, p_pad).reshape(-1)
        if new_scale is None:
            layer_pool[tgt, off] = gate.to(layer_pool.dtype).reshape(-1, half)
        else:
            q, s = quantize_rows(gate, group)
            layer_pool[tgt, off] = q.reshape(-1, half)
            layer_scale = pool_scale[str(i)].clone()
            layer_scale[tgt, off] = s.reshape(-1)
            new_scale[str(i)] = layer_scale
        new_pool[str(i)] = layer_pool
    if new_scale is not None:
        return new_pool, new_scale
    return new_pool


def scatter_gate_rows(config: ProGenConfig, gate_rows: dict,
                      lengths: torch.Tensor, pool: dict, wtable: torch.Tensor,
                      pool_scale: dict | None = None, group=None):
    """Scatter DENSE per-row gate slabs into a copy of the page pool.

    The disaggregated admission path (``decode/handoff.py``): the prefill
    worker hands off ``(B, n_rows, half)`` gate slabs per gMLP layer (keyed
    ``str(i)`` like the dense cache), and the decode stage's merge scatters
    each handle row ``i < lengths[b]`` to page ``wtable[b, i // page_size]``
    at offset ``i % page_size``: the contract of :func:`harvest_gate_pages`,
    with the slab in place of the prefill's intermediates.  ``wtable`` rows
    for prefix-shared pages, unadmitted handle rows and pad tails hold
    ``DUMP_PAGE``.

    The slabs ride the handoff in the compute dtype whatever the pool's
    format; with ``pool_scale`` the rows are quantized here, at the pool
    boundary, and the call returns ``(new_pool, new_scale)``.  The given
    pools are left untouched.  ``group`` as in :func:`harvest_gate_pages`."""
    new_pool = dict(pool)
    new_scale = dict(pool_scale) if pool_scale is not None else None
    lengths = lengths.long()
    wtable = wtable.long()
    for i in range(config.depth):
        if not config.layer_uses_gmlp(i):
            continue
        gate = gate_rows[str(i)]  # (B, n_rows, half)
        b, n_rows, half = gate.shape
        layer_pool = pool[str(i)].clone()  # (num_pages, page_size, half)
        page_size = layer_pool.shape[1]
        rows = torch.arange(n_rows, device=gate.device)
        page_idx = (rows // page_size).clamp_max(wtable.shape[1] - 1)
        tgt = wtable[:, page_idx]  # (B, n_rows)
        tgt = torch.where(rows[None, :] < lengths[:, None], tgt, DUMP_PAGE)
        tgt = tgt.reshape(-1)
        off = (rows % page_size).expand(b, n_rows).reshape(-1)
        if new_scale is None:
            layer_pool[tgt, off] = gate.to(layer_pool.dtype).reshape(-1, half)
        else:
            q, s = quantize_rows(gate, group)
            layer_pool[tgt, off] = q.reshape(-1, half)
            layer_scale = pool_scale[str(i)].clone()
            layer_scale[tgt, off] = s.reshape(-1)
            new_scale[str(i)] = layer_scale
        new_pool[str(i)] = layer_pool
    if new_scale is not None:
        return new_pool, new_scale
    return new_pool


def make_prefiller(model: ProGen, mesh=None):
    """Build ``prefill(tokens, lengths, decode_len, adapters=None,
    tenant=None) -> (last_logits, caches)``.

    ``tokens``: ``(B, P_pad)`` int prime tokens, right-padded, ``P_pad`` a
    multiple of ``window_size`` and ``<= seq_len`` (:func:`pad_prime_length`).
    ``lengths``: ``(B,)`` real prime lengths.  ``decode_len``: positions the
    decode will visit (sizes the SGU caches).  ``adapters`` (a LoRA bank)
    with ``tenant (B,)`` runs each row as its tenant.  ``last_logits``
    ``(B, V)`` f32 are the logits at each row's last prime position.
    ``mesh``: the ``DecodeMesh`` of a placed ``model`` (see the module
    docstring).
    """
    config = model.config

    @torch.no_grad()
    def prefill(tokens: torch.Tensor, lengths, decode_len: int,
                adapters: dict | None = None, tenant=None):
        _check_padded(config, tokens)
        lengths = torch.as_tensor(lengths, dtype=torch.long,
                                  device=tokens.device)
        if tenant is not None:
            tenant = torch.as_tensor(tenant, dtype=torch.long,
                                     device=tokens.device)
        logits, sown = model(tokens, return_cache=True, adapters=adapters,
                             tenant=tenant, mesh=mesh)
        caches = harvest_caches(config, sown, lengths, model.policy,
                                decode_len)
        return _take_row(logits, lengths - 1).float(), caches

    return prefill


def make_embedder(model: ProGen, mesh=None):
    """Build ``embed(tokens, lengths) -> (B, dim) f32``: the embeddings
    endpoint's program.

    One forward of ``model`` to its final post-norm hidden states
    (``ProGen.final_hidden``: no logits head, no per-layer caches), cast to
    f32 and mean-pooled over each row's real positions ``< lengths[b]``
    (divided by ``max(lengths, 1)``); the window-aligned pad tail never
    contributes.  Same ragged ``(B, P_pad)`` + ``lengths`` contract as
    :func:`make_prefiller`.  Always the base model: no adapters.  ``mesh``
    as in :func:`make_prefiller`; ``final_hidden`` runs through the root's
    ``run`` (``models/progen.py:Runs``), so under ``fsdp`` the root's
    parameters (``embed``, ``norm_out``) are whole while it runs.
    """
    config = model.config

    @torch.no_grad()
    def embed(tokens: torch.Tensor, lengths) -> torch.Tensor:
        _check_padded(config, tokens)
        p_pad = tokens.shape[1]
        lengths = torch.as_tensor(lengths, dtype=torch.long,
                                  device=tokens.device)
        h = model.run(lambda m: m.final_hidden(tokens, mesh=mesh)).float()
        keep = torch.arange(p_pad, device=tokens.device)[None, :] < lengths[:, None]
        pooled = torch.sum(h * keep[:, :, None].float(), dim=1)
        return pooled / lengths.clamp_min(1).float()[:, None]

    return embed


def _check_padded(config: ProGenConfig, tokens: torch.Tensor) -> None:
    p_pad = tokens.shape[1]
    if p_pad % config.window_size != 0 or p_pad > config.seq_len:
        raise ValueError(
            f"padded prime length {p_pad} must be a multiple of "
            f"window_size {config.window_size} and <= seq_len "
            f"{config.seq_len}")
