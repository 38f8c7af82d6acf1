"""The optimizer (ported from progen_tpu/train/optimizer.py): global-norm
clip 0.5 -> AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-3 on every
parameter with ``ndim > 1``) -> gradient accumulation every N micro-batches.

This is a small functional optimizer over the port's state, written to
optax's formulas rather than built on ``torch.optim``, whose clip and AdamW
round differently:

* ``optax.clip_by_global_norm``: ``g / norm * max_norm`` only when
  ``norm >= max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_``
  scales by ``max_norm / (norm + 1e-6)`` always);
* ``optax.adamw``: ``mu / (sqrt(nu) + eps)`` with both moments
  bias-corrected, PLUS ``wd * p``, then times ``-lr`` (``torch.optim.AdamW``
  decays ``p`` first);
* ``optax.MultiSteps``: the micro-gradients' running mean
  ``acc + (g - acc) / (k + 1)``; the clip and AdamW run once per effective
  batch on that mean, so Adam's count, and the schedule read from it,
  advance once per effective batch.

Parameters, moments and the accumulator are updated IN PLACE (the state
holds the same tensors from step to step), which saves a copy of each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from progen_tpu_torch.train.schedule import lr_at

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class OptState:
    """``count``: AdamW's step count, once per effective batch (what the
    schedule reads); ``mini_step``: the micro-batches accumulated so far in
    this batch; ``acc_grads``: their running mean, or None without
    accumulation."""

    count: int
    mu: Params
    nu: Params
    mini_step: int = 0
    acc_grads: Params | None = None


def decay_mask(params: Params) -> dict[str, bool]:
    """True where weight decay applies: every parameter with ndim > 1."""
    return {name: p.dim() > 1 for name, p in params.items()}


def global_norm(tensors: Params) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, in f32, on their device."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors.values()))


class Optimizer:
    """``init(params) -> OptState`` and ``update(grads, state, params) ->
    OptState``, which writes the new parameters into ``params``."""

    def __init__(self, learning_rate: float | Callable[[int], float] = 2e-4,
                 weight_decay: float = 1e-3, max_grad_norm: float = 0.5,
                 grad_accum_every: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.grad_accum_every = max(1, int(grad_accum_every))
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> OptState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        acc = zeros() if self.grad_accum_every > 1 else None
        return OptState(count=0, mu=zeros(), nu=zeros(), acc_grads=acc)

    def update(self, grads: Params, state: OptState, params: Params) -> OptState:
        k = self.grad_accum_every
        if k == 1:
            self._apply(grads, state, params)
            return dataclasses.replace(state, count=state.count + 1)
        acc = state.acc_grads
        with torch.no_grad():
            for name, g in grads.items():
                a = acc[name]
                a.copy_(a + (g - a) / (state.mini_step + 1))
        if state.mini_step < k - 1:
            return dataclasses.replace(state, mini_step=state.mini_step + 1)
        self._apply(acc, state, params)
        for a in acc.values():
            a.zero_()
        return dataclasses.replace(state, count=state.count + 1, mini_step=0)

    @torch.no_grad()
    def _apply(self, grads: Params, state: OptState, params: Params) -> None:
        """One clip + AdamW step from ``grads`` at Adam count ``state.count``."""
        b1, b2 = self.b1, self.b2
        norm = global_norm(grads)
        keep = norm < self.max_grad_norm
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        step_size = -lr_at(self.learning_rate, state.count)
        decay = decay_mask(params)
        for name, p in params.items():
            g = grads[name]
            g = torch.where(keep, g, (g / norm) * self.max_grad_norm)
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if decay[name]:
                u = u + self.weight_decay * p
            p.copy_(p + step_size * u)


def make_optimizer(learning_rate: float | Callable[[int], float] = 2e-4,
                   weight_decay: float = 1e-3, max_grad_norm: float = 0.5,
                   grad_accum_every: int = 1, b1: float = 0.9,
                   b2: float = 0.999) -> Optimizer:
    """The port of ``make_optimizer``: pass a schedule from
    :func:`~progen_tpu_torch.train.schedule.make_lr_schedule` as
    ``learning_rate``."""
    return Optimizer(learning_rate, weight_decay, max_grad_norm,
                     grad_accum_every, b1, b2)
