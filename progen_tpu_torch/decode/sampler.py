"""Autoregressive sampling: one-pass prefill + early-exit chunked decode
(ported from progen_tpu/decode/sampler.py).

Top-k Gumbel-max sampling in f32 (greedy at ``temperature=0``), masked
entries ``-inf``; truncation after the second zero (position 0's BOS/pad
counts as the first).  ``ChunkedSampler`` draws its Gumbel noise from an
explicit ``torch.Generator``: that is NOT the JAX key chain, so its sampled
tokens match the JAX package only where the noise is handed over
(``noise=``) or the decode is greedy.  The serving engine's per-row
sampling (:func:`gumbel_topk_sample_batched`, :func:`split_keys_batched`)
runs on the JAX key chain itself (``decode/rng.py``) and gives JAX's
tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from progen_tpu_torch.decode import rng
from progen_tpu_torch.decode.incremental import ProGenDecodeStep, init_caches
from progen_tpu_torch.decode.prefill import make_prefiller, pad_prime_length
from progen_tpu_torch.models.progen import ProGen


def apply_logit_mask(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keep ``logits`` where ``mask`` is true, ``-inf`` elsewhere."""
    return logits.masked_fill(~mask, float("-inf"))


def gumbel_noise(shape, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise in f32, drawn as ``jax.random.gumbel`` does:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_topk_sample(logits: torch.Tensor, top_k: int | None,
                       temperature: float = 1.0, *,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sample token ids ``(B,)`` from logits ``(B, V)``, in f32 throughout.

    ``noise`` (optional, ``(B, V)``) replaces the Gumbel draw from
    ``generator``, so a test can hand over the exact draw JAX made.
    ``mask`` (optional bool): tokens with a false entry are never emitted,
    greedy included.
    """
    logits = logits.float()
    if mask is not None:
        logits = apply_logit_mask(logits, mask)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = apply_logit_mask(logits, logits >= kth)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise.float(), dim=-1)


def gumbel_topk_sample_batched(keys: torch.Tensor, logits: torch.Tensor,
                               top_k: torch.Tensor, temperature: torch.Tensor,
                               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row sampling for the serving engine: each row has its own key,
    top-k and temperature.

    ``keys``: ``(B, 2)`` raw key data (``decode/rng.py``); ``logits``:
    ``(B, V)``; ``top_k``: ``(B,)`` int, ``0`` disables top-k for that row;
    ``temperature``: ``(B,)`` f32, ``0.0`` means greedy for that row.  All
    in f32 (bf16 logits under a tiny temperature overflow to inf, and the
    ``-inf`` top-k mask then gives NaN rows); the temperature is floored at
    1e-8; the per-row k-th value comes from a full ascending sort.
    ``mask`` (optional ``(B, V)`` bool) is applied before the greedy argmax,
    so greedy rows respect it too."""
    logits = logits.float()
    if mask is not None:
        logits = apply_logit_mask(logits, mask)
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / temperature.clamp_min(1e-8)[:, None]
    k_eff = torch.where(top_k > 0, top_k.clamp(1, v), v)
    srt = torch.sort(scaled, dim=-1).values  # ascending
    kth = torch.gather(srt, 1, (v - k_eff)[:, None].long())
    masked = apply_logit_mask(scaled, scaled >= kth)
    sampled = torch.argmax(masked + rng.gumbel(keys, v), dim=-1)
    return torch.where(temperature == 0.0, greedy, sampled)


def split_keys_batched(key_data: torch.Tensor):
    """Advance a batch of raw keys ``(B, 2)`` one split: returns
    ``(next_key_data, subkeys)``, as the JAX engine's key chain does."""
    pair = rng.split(key_data)
    return pair[:, 0], pair[:, 1]


def truncate_after_eos(seq: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Zero everything after the SECOND zero (the BOS/pad at position 0 is
    the first; the next zero is the learned EOS, which is kept)."""
    after = torch.cumsum(seq == pad_id, dim=-1) > 1
    return seq * (~after)


class ChunkedSampler:
    """The serving sampler: ONE parallel prefill of the prime, then decode
    in chunks of ``chunk_size`` cached steps; between chunks the host checks
    whether every row has emitted EOS and stops if so, so cost tracks the
    emitted tokens.  ``last_num_chunks`` holds the chunks the latest call
    ran.  Call it as ``sampler(prime, length, generator=..., top_k=...,
    add_bos=..., temperature=...)`` with ``prime`` ``(B, P)`` int on the
    model's device; it returns ``(B, length)`` EOS-truncated sequences.
    """

    def __init__(self, model: ProGen, chunk_size: int = 64):
        self.model = model
        self.chunk_size = chunk_size
        self.step = ProGenDecodeStep(model)
        self.prefill = make_prefiller(model)
        self.last_num_chunks = 0

    @torch.no_grad()
    def __call__(self, prime: torch.Tensor, length: int, *,
                 generator: torch.Generator | None = None,
                 top_k: int | None = None, add_bos: bool = False,
                 temperature: float = 1.0) -> torch.Tensor:
        config = self.model.config
        if prime.dim() != 2:
            raise ValueError(f"prime must be (B, P), got {tuple(prime.shape)}")
        b, p = prime.shape
        prime = prime.long()
        if add_bos:
            prime = torch.cat([torch.zeros_like(prime[:, :1]),
                               prime[:, :length - 1]], dim=1)
            p = min(p + 1, length)
        start_pos = p
        if not (0 < start_pos <= length <= config.seq_len):
            raise ValueError(
                f"need 0 < prime length {start_pos} <= length {length} <= "
                f"seq_len {config.seq_len}")

        p_pad = pad_prime_length(start_pos, config.window_size, config.seq_len)
        tokens = F.pad(prime, (0, p_pad - start_pos))
        lengths = torch.full((b,), start_pos, dtype=torch.long,
                             device=prime.device)
        last_logits, caches = self.prefill(tokens, lengths, decode_len=length)

        def sample(logits):
            return gumbel_topk_sample(logits, top_k, temperature,
                                      generator=generator)

        seq = torch.zeros(b, length, dtype=torch.long, device=prime.device)
        seq[:, :start_pos] = prime
        zcount = (prime == 0).sum(dim=1)
        if start_pos < length:
            val = torch.where(zcount > 1, 0, sample(last_logits))
            seq[:, start_pos] = val
            zcount = zcount + (val == 0)

        n_chunks = 0
        pos0 = start_pos
        while pos0 < length:
            # a step at pos writes position pos + 1; steps whose write would
            # fall past the end are skipped (the JAX chunk runs them idle)
            for pos in range(pos0, min(pos0 + self.chunk_size, length - 1)):
                logits, caches = self.step(seq[:, pos], pos, caches)
                val = torch.where(zcount > 1, 0, sample(logits))
                seq[:, pos + 1] = val
                zcount = zcount + (val == 0)
            n_chunks += 1
            pos0 += self.chunk_size
            if bool((zcount > 1).all()):
                break
        self.last_num_chunks = n_chunks
        return truncate_after_eos(seq)


def make_chunked_sampler(model: ProGen, chunk_size: int = 64) -> ChunkedSampler:
    """The JAX package's name for ``ChunkedSampler(model, chunk_size)``."""
    return ChunkedSampler(model, chunk_size)


@torch.no_grad()
def teacher_forced_logits(model: ProGen, tokens: torch.Tensor) -> torch.Tensor:
    """Run the cached decode step over a FIXED token sequence and return all
    logits ``(B, L, V)``: the decode-vs-parallel parity oracle."""
    b, n = tokens.shape
    step = ProGenDecodeStep(model)
    caches = init_caches(model.config, b, model.policy, decode_len=n,
                         device=tokens.device)
    out = []
    for pos in range(n):
        logits, caches = step(tokens[:, pos], pos, caches)
        out.append(logits)
    return torch.stack(out, dim=1)
