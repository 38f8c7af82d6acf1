"""Speculative decoding: draft-propose / target-verify / draft-commit
(ported from progen_tpu/decode/spec.py).

One speculative ROUND spends up to ``k + 1`` target steps and emits up to
``k + 1`` tokens per slot:

1. **draft propose**: a small draft ProGen (``models/configs.py``,
   ``draft_config_for``) runs ``k`` cached single-token steps on a CLONE of
   its caches and proposes ``d_1..d_k``.  Each proposal is sampled with the
   subkey the target would use for that step (the slot's key chain is
   re-derived, never committed), so a sampled request accepts exactly when
   draft and target sampling agree;
2. **target verify**: ``k + 1`` target steps over ``(tok, d_1, .., d_k)``.
   Step ``j`` samples ``s_j`` from the target's own logits with the slot's
   own key chain and emits it iff the slot is still live; the slot stays
   live for step ``j + 1`` iff ``s_j == d_{j+1}`` and the stop rule did not
   fire.  A step that is not live writes nothing (``write_ok``); the last
   step is the bonus token of a fully-accepted round;
3. **draft commit**: the draft's real caches take the verified inputs under
   the recorded live masks, so draft and target stay at the same position.

Every emitted token comes from the target's logits and key chain, so the
output is token-identical to plain decoding, greedy and sampled alike, for
any draft; the draft decides only how many of the ``k + 1`` steps count.

The JAX round is three ``lax.scan``\\ s whose carries are values: the
propose scan's draft caches are dropped by construction and a rejected
step's writes are merged away after it.  Here the caches are written in
place, so the propose loop runs on :func:`~progen_tpu_torch.decode
.incremental.copy_caches` of the draft's caches, and the verify and commit
steps pass their live mask as ``write_ok``.

:func:`check_draft_config` and :func:`spec_acceptance` (numpy) are copied
from the JAX module.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from progen_tpu_torch.decode.incremental import copy_caches
from progen_tpu_torch.decode.sampler import (
    gumbel_topk_sample_batched,
    split_keys_batched,
)
from progen_tpu_torch.models.progen import ProGenConfig


def check_draft_config(target: ProGenConfig, draft: ProGenConfig) -> None:
    """The draft must agree with the target on everything that gives
    tokens and positions their meaning; capacity knobs are free."""
    for field in ("num_tokens", "window_size", "seq_len"):
        t, d = getattr(target, field), getattr(draft, field)
        if t != d:
            raise ValueError(
                f"draft config {field}={d} != target {field}={t}: the "
                f"draft proposes tokens in the target's vocabulary at "
                f"the target's positions (see draft_config_for)")


def spec_acceptance(sampled, proposed, done):
    """Pure acceptance rule for one speculative round.

    ``sampled (.., k+1)``: the target's verified tokens ``s_0..s_k``;
    ``proposed (.., k)``: the draft's ``d_1..d_k`` (``proposed[j]`` is
    the guess for ``sampled[j]``); ``done (.., k+1)``: whether step
    ``j``'s stop rule fired (EOS or length).  Returns ``(live, emitted)``
    where ``live[.., j]`` says step ``j``'s token was emitted and
    ``emitted`` counts them: step 0 is always live (for a live slot);
    step ``j + 1`` is live iff step ``j`` was, matched its proposal, and
    did not finish.  The final step never has a proposal to match: it is
    the bonus token of a fully-accepted round.
    """
    sampled = np.asarray(sampled)
    proposed = np.asarray(proposed)
    done = np.asarray(done)
    k1 = sampled.shape[-1]
    if proposed.shape[-1] != k1 - 1 or done.shape[-1] != k1:
        raise ValueError("want sampled (.., k+1), proposed (.., k), "
                         "done (.., k+1)")
    live = np.ones(sampled.shape[:-1], bool)
    lives = []
    for j in range(k1):
        lives.append(live)
        match = (sampled[..., j] == proposed[..., j]) if j < k1 - 1 \
            else np.zeros_like(live)
        live = live & match & ~done[..., j]
    live_mat = np.stack(lives, axis=-1)
    return live_mat, live_mat.sum(axis=-1)


def spec_round(st: dict, *, spec_k: int, max_len: int, target_step: Callable,
               draft_step: Callable, advance: Callable,
               live0: torch.Tensor) -> torch.Tensor:
    """One speculative round over the engine's working slot state ``st``
    (updated in place: its caches and sequence are written, its small
    entries replaced).

    ``target_step(tok, pos, caches, live) -> logits`` and
    ``draft_step(tok, pos, draft_caches, live) -> logits`` are the engine's
    steps; rows where ``live`` is false write nothing (``live=None``: every
    row writes).  ``advance(st, live, logits) -> (nxt, done_now)`` is the
    engine's sampling tail: it samples each row's next token with the row's
    key chain and logit mask, advances the live rows and returns the sampled
    tokens and the rows whose stop rule fired.  ``live0`` is the slots
    allowed to advance this round (active, not done, not paused).

    Returns ``emitted (S,)``: the tokens each slot produced (0 for a slot
    dead at the round's start, up to ``spec_k + 1``).
    """
    rows = torch.arange(st["pos"].shape[0], device=st["pos"].device)
    pos0 = st["pos"]
    tok0 = st["seq"][rows, pos0]

    # -- draft propose, on a clone of the draft caches (the JAX scan's
    # throwaway carry).  The chain advances for every row (dead rows'
    # proposals are never consumed); positions clamp so a slot racing past
    # its stop cannot index past the gMLP weight rows.  The mask row of the
    # position the TARGET writes at this step applies to the draft sample
    # too, so both see the same constrained logits.
    scratch = copy_caches(st["draft_caches"])
    keys, tok, dpos = st["keys"], tok0, pos0
    proposed = []
    for _ in range(spec_k):
        logits = draft_step(tok, dpos, scratch, None)
        keys, sub = split_keys_batched(keys)
        mrow = st["lmask"][rows, (dpos + 1).clamp(0, max_len - 1)]
        tok = gumbel_topk_sample_batched(sub, logits, st["top_k"], st["temp"],
                                         mask=mrow)
        proposed.append(tok)
        dpos = (dpos + 1).clamp_max(max_len - 1)
    del scratch

    # -- target verify: input j is the current token at j = 0, the draft's
    # d_j after; guess j is d_{j+1}, and -1 (never sampled) for the bonus
    # step, which so always ends the round
    inputs = [tok0] + proposed
    guesses = proposed + [torch.full_like(tok0, -1)]
    live = live0
    lives = []
    for inp, guess in zip(inputs, guesses):
        lives.append(live)
        logits = target_step(inp, st["pos"], st["caches"], live)
        nxt, done_now = advance(st, live, logits)
        # the next step's liveness tests the SAMPLED token, not the one
        # written (a dead row writes its old value back)
        live = live & (nxt == guess) & ~done_now

    # -- draft commit: the real draft caches take the same inputs under the
    # recorded live masks, staying aligned with the target
    dpos = pos0
    for inp, live in zip(inputs, lives):
        draft_step(inp, dpos, st["draft_caches"], live)
        dpos = torch.where(live, (dpos + 1).clamp_max(max_len - 1), dpos)

    return torch.stack(lives).sum(dim=0)
