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
"""

from __future__ import annotations

import torch

from progen_tpu_torch.core.precision import Policy
from progen_tpu_torch.models.progen import ProGen, ProGenConfig


def pad_prime_length(p: int, window_size: int, seq_len: int) -> int:
    """Padded prefill length for a ``p``-token prime: a multiple of
    ``window_size`` capped at ``seq_len``."""
    if not (0 < p <= seq_len):
        raise ValueError(f"prime length {p} must be in (0, {seq_len}]")
    return min(-(-p // window_size) * window_size, seq_len)


def _take_row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, L, ...)``, ``idx (B,)`` -> ``x[b, idx[b]] (B, ...)``."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def harvest_caches(config: ProGenConfig, sown: dict, lengths: torch.Tensor,
                   policy: Policy, decode_len: int) -> dict:
    """Decode caches from the parallel forward's ``cache`` dict, per row
    masked to ``lengths``."""
    c = config
    cd = policy.compute_dtype
    ring = 2 * c.window_size
    n_rows = min(decode_len, c.seq_len)
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
        if c.layer_uses_gmlp(i):
            gate = ff["sgu"]["gate"]  # (B, P_pad, hidden/2)
            b, p_pad, half = gate.shape
            rows = torch.zeros(b, n_rows, half, dtype=cd, device=dev)
            upto = min(p_pad, n_rows)
            keep = torch.arange(upto, device=dev)[None, :, None] < lengths[:, None, None]
            rows[:, :upto] = torch.where(keep, gate[:, :upto],
                                         torch.zeros_like(gate[:, :upto])).to(cd)
            caches["sgu_gate"][str(i)] = rows
    return caches


def make_prefiller(model: ProGen):
    """Build ``prefill(tokens, lengths, decode_len) -> (last_logits, caches)``.

    ``tokens``: ``(B, P_pad)`` int prime tokens, right-padded, ``P_pad`` a
    multiple of ``window_size`` and ``<= seq_len`` (:func:`pad_prime_length`).
    ``lengths``: ``(B,)`` real prime lengths.  ``decode_len``: positions the
    decode will visit (sizes the SGU caches).  ``last_logits`` ``(B, V)`` f32
    are the logits at each row's last prime position.
    """
    config = model.config

    @torch.no_grad()
    def prefill(tokens: torch.Tensor, lengths, decode_len: int):
        b, p_pad = tokens.shape
        if p_pad % config.window_size != 0 or p_pad > config.seq_len:
            raise ValueError(
                f"padded prime length {p_pad} must be a multiple of "
                f"window_size {config.window_size} and <= seq_len "
                f"{config.seq_len}")
        lengths = torch.as_tensor(lengths, dtype=torch.long,
                                  device=tokens.device)
        logits, sown = model(tokens, return_cache=True)
        caches = harvest_caches(config, sown, lengths, model.policy,
                                decode_len)
        return _take_row(logits, lengths - 1).float(), caches

    return prefill
