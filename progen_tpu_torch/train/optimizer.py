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

The scalars that depend on Adam's count (the learning rate, the step size
``-lr`` and the bias corrections ``1 - b1**t`` and ``1 - b2**t``) reach the
update as one f32 tensor on the parameters' device, :meth:`Optimizer.scalars`,
computed on the host from the count in ``np.float32`` arithmetic.  The
update's device work therefore reads no Python number that changes from
step to step, so one CUDA graph of it serves every step
(``train/step.py:train_multi_step``); a graph would freeze such a number at
the value of the step it was captured at.

Under a mesh (``parallel/sharding.py``) the state's tensors may be
DTensors (FSDP2 shards, parameters row-sharded over ``seq``): every update
runs on each rank's own shard, and :func:`global_norm` counts each distinct
element once over all ranks, so the clip fires at the norm of the whole
gradient (a replicated gradient counted once, shards summed).

The frozen-base LoRA optimizer (``train/lora.py``, optax's
``multi_transform(adamw, set_to_zero)``) is this class with no clip
(``max_grad_norm=None``) and ``frozen`` naming the base: a frozen
parameter has no moments and no accumulator and is never written.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from progen_tpu_torch.parallel.sharding import global_sum_of_squares, load_full, local
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

    def state_dict(self) -> dict:
        """The state by name, sharing its tensors (what a checkpoint
        stores)."""
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc_grads": self.acc_grads}

    @torch.no_grad()
    def load_state_dict(self, saved: dict, pieces=None) -> "OptState":
        """Copy ``saved``'s tensors into this state's, in place on their
        devices, and return the state at ``saved``'s counts (``pieces``: as
        :func:`copy_into`'s).  Raises when the names, shapes or the
        accumulator's presence differ."""
        for field in ("mu", "nu", "acc_grads"):
            mine, theirs = getattr(self, field), saved[field]
            if (mine is None) != (theirs is None):
                raise ValueError(
                    f"stored optimizer state {'has' if theirs is not None else 'lacks'} "
                    f"{field}: was it saved with another grad_accum_every?")
            if mine is not None:
                copy_into(mine, theirs, f"opt_state.{field}", pieces)
        return dataclasses.replace(self, count=int(saved["count"]),
                                   mini_step=int(saved["mini_step"]))


@torch.no_grad()
def copy_into(dst: Params, src: Params, what: str, pieces=None) -> None:
    """``dst[k].copy_(src[k])`` for every name (a sharded ``dst[k]`` takes
    its part of the whole ``src[k]``; ``pieces(k)``: the packed pieces of a
    tensor-sharded one); the names and shapes must match."""
    if set(dst) != set(src):
        raise ValueError(f"{what}: stored names differ: missing "
                         f"{sorted(set(dst) - set(src))}, unexpected "
                         f"{sorted(set(src) - set(dst))}")
    for name, t in dst.items():
        if t.shape != src[name].shape:
            raise ValueError(f"{what}.{name}: stored shape "
                             f"{tuple(src[name].shape)}, want {tuple(t.shape)}")
        load_full(t, src[name], 1 if pieces is None else pieces(name))


def decay_mask(params: Params) -> dict[str, bool]:
    """True where weight decay applies: every parameter with ndim > 1."""
    return {name: p.dim() > 1 for name, p in params.items()}


def global_norm(tensors: Params) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, in f32, on their device;
    over the whole of each sharded tensor, on every rank."""
    return torch.sqrt(global_sum_of_squares(tensors))


class Optimizer:
    """``init(params) -> OptState`` and ``update(grads, state, params) ->
    OptState``, which writes the new parameters into ``params``.

    ``max_grad_norm=None`` turns the clip off; ``frozen(name)`` marks
    parameters the optimizer never touches (their gradients are ignored,
    as optax's ``set_to_zero`` discards them)."""

    def __init__(self, learning_rate: float | Callable[[int], float] = 2e-4,
                 weight_decay: float = 1e-3, max_grad_norm: float | None = 0.5,
                 grad_accum_every: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, frozen: Callable[[str], bool] | None = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.grad_accum_every = max(1, int(grad_accum_every))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.frozen = frozen or (lambda name: False)

    def trainable(self, params: Params) -> Params:
        """The entries of ``params`` the optimizer updates."""
        return {k: p for k, p in params.items() if not self.frozen(k)}

    def scalars(self, count: int) -> np.ndarray:
        """The update's count-dependent scalars at Adam count ``count`` (the
        count BEFORE the update, what the schedule reads), as ``(4,)`` f32:
        ``[lr, -lr, 1 - b1**(count+1), 1 - b2**(count+1)]``: the learning
        rate, the step size and the two bias corrections; the schedule's
        value is rounded to f32 once."""
        t = np.float32(count + 1)
        lr = np.float32(lr_at(self.learning_rate, count))
        return np.array([lr, -lr, np.float32(1) - np.float32(self.b1) ** t,
                         np.float32(1) - np.float32(self.b2) ** t], np.float32)

    def init(self, params: Params) -> OptState:
        params = self.trainable(params)
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        acc = zeros() if self.grad_accum_every > 1 else None
        return OptState(count=0, mu=zeros(), nu=zeros(), acc_grads=acc)

    def update(self, grads: Params, state: OptState, params: Params,
               scalars: torch.Tensor | None = None) -> OptState:
        """One micro-batch's gradients into ``state`` and ``params``;
        ``scalars``: :meth:`scalars` of ``state.count`` as a tensor on the
        parameters' device (made here when None)."""
        k = self.grad_accum_every
        grads = {name: grads[name] for name in self.trainable(grads)}
        if scalars is None:
            device = local(next(iter(params.values()))).device
            scalars = torch.from_numpy(self.scalars(state.count)).to(device)
        if k == 1:
            self._apply(grads, state, params, scalars)
            return dataclasses.replace(state, count=state.count + 1)
        acc = state.acc_grads
        with torch.no_grad():
            for name, g in grads.items():
                a, g = local(acc[name]), local(g)
                a.copy_(a + (g - a) / (state.mini_step + 1))
        if state.mini_step < k - 1:
            return dataclasses.replace(state, mini_step=state.mini_step + 1)
        self._apply(acc, state, params, scalars)
        for a in acc.values():
            a.zero_()
        return dataclasses.replace(state, count=state.count + 1, mini_step=0)

    @torch.no_grad()
    def _apply(self, grads: Params, state: OptState, params: Params,
               scalars: torch.Tensor) -> None:
        """One clip + AdamW step from ``grads`` with the count's ``scalars``
        (over the trainable parameters, the names of ``grads``)."""
        b1, b2 = self.b1, self.b2
        clip = self.max_grad_norm is not None
        if clip:
            norm = global_norm(grads)
            keep = norm < self.max_grad_norm
        step_size, bc1, bc2 = scalars[1], scalars[2], scalars[3]
        decay = decay_mask(grads)
        for name, g in grads.items():
            p, g = local(params[name]), local(g)
            if clip:
                g = torch.where(keep, g, (g / norm) * self.max_grad_norm)
            mu, nu = local(state.mu[name]), local(state.nu[name])
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
