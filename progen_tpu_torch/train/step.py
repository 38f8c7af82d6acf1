"""The train and eval steps (ported from progen_tpu/train/step.py).

One ``train_step`` is forward, loss, backward (through the kernels'
autograd functions on the card), then the optimizer: clip, AdamW and the
parameter update, or only the accumulation on a micro-step that does not
end an effective batch.  The optimizer writes the parameters, the moments
and the accumulator IN PLACE, so a state kept across later steps must be a
copy (the trainer's background checkpoint snapshots it first).  The
``Trainer`` (``train/trainer.py``) drives these steps over tfrecords.
PyTorch runs eagerly, so there is no jit; ``train_multi_step`` (JAX's K-step
``lax.scan``) is not ported yet.

Under a mesh (``mesh``, ``strategies``) every rank runs the step on its
rows of the global batch (``parallel/sharding.batch_sharding``), and on its
slice of their sequence under ``sp``; the gradients are reduced over the
ranks before the clip (``parallel/sharding.reduce_gradients``), so every
rank takes the one-device step of the global batch.  The metrics are the
global batch's on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from progen_tpu_torch.parallel.sharding import (
    ParallelPlan,
    batch_mean,
    parallelize,
    reduce_gradients,
)
from progen_tpu_torch.train.loss import batch_loss, cross_entropy
from progen_tpu_torch.train.optimizer import OptState, Optimizer, Params, global_norm
from progen_tpu_torch.train.schedule import lr_at


@dataclasses.dataclass
class TrainState:
    """``step`` counts micro-batches; ``params`` are the model's own
    parameters by ``state_dict`` name (updated in place)."""

    step: int
    params: Params
    opt_state: OptState


@dataclasses.dataclass(frozen=True)
class TrainFunctions:
    """``init_state(seed=None)``, ``train_step(state, batch)`` and
    ``eval_step(state, batch)``; ``batch`` is the data pipeline's
    ``(B, seq_len + 1)`` int tokens."""

    init_state: Callable
    train_step: Callable
    eval_step: Callable


def _inputs(batch: torch.Tensor, plan: ParallelPlan | None):
    """Inputs and targets of a ``(B, seq_len + 1)`` batch: this rank's
    slice of the sequence under a ``seq`` split."""
    ids, labels = batch[:, :-1], batch[:, 1:]
    if plan is not None and plan.size("seq") > 1:
        n = ids.shape[1] // plan.size("seq")
        at = plan.mesh.get_local_rank("seq") * n
        ids, labels = ids[:, at:at + n], labels[:, at:at + n]
    return ids, labels


def make_train_functions(model: torch.nn.Module, optimizer: Optimizer, mesh=None,
                         strategies=("dp",)) -> TrainFunctions:
    """Build the step functions of ``model``; with a ``mesh`` (a four-axis
    ``DeviceMesh``) first place the model on it under ``strategies``
    (``parallel/sharding.parallelize``; every rank must hold the same full
    values).

    Every step's metrics carry ``"lr"``: the optimizer's learning rate (a
    float or a schedule) read at the optimizer count that the update is
    scaled with.  The count advances once per effective batch, so with
    accumulation the micro-steps of one batch report the same ``lr``.
    """
    plan = None
    if mesh is not None:
        plan = getattr(model, "parallel_plan", None) or parallelize(model, mesh, strategies)
    seq_group = plan.group("seq") if plan is not None and plan.size("seq") > 1 else None

    def global_mean(t: torch.Tensor) -> torch.Tensor:
        return t if plan is None else batch_mean(t, plan)

    def init_state(seed: int | None = None) -> TrainState:
        if seed is not None:
            model.init_weights(seed)
        params = dict(model.named_parameters())
        return TrainState(step=0, params=params, opt_state=optimizer.init(params))

    def train_step(state: TrainState, batch: torch.Tensor):
        batch = torch.as_tensor(batch, device=model.device)
        ids, labels = _inputs(batch, plan)
        for p in state.params.values():
            p.grad = None
        loss = batch_loss(model(ids), labels, group=seq_group)
        loss.backward()
        if plan is not None:
            reduce_gradients(plan, state.params)
        grads = {name: p.grad for name, p in state.params.items()}
        metrics = {"loss": global_mean(loss.detach()), "grad_norm": global_norm(grads),
                   "lr": lr_at(optimizer.learning_rate, state.opt_state.count)}
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor) -> dict:
        batch = torch.as_tensor(batch, device=model.device)
        ids, labels = _inputs(batch, plan)
        per_row = cross_entropy(model(ids), labels, group=seq_group)
        # all-zero rows are padding that squares off a final partial eval
        # batch; callers drop them by this mask.  Both are this rank's rows.
        return {"loss": global_mean(per_row.mean()), "per_row_loss": per_row,
                "real_rows": (batch != 0).any(dim=1)}

    return TrainFunctions(init_state=init_state, train_step=train_step,
                          eval_step=eval_step)
