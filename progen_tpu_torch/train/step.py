"""The train and eval steps (ported from progen_tpu/train/step.py).

One ``train_step`` is forward, loss, backward (through the kernels'
autograd functions on the card), then the optimizer: clip, AdamW and the
parameter update, or only the accumulation on a micro-step that does not
end an effective batch.  PyTorch runs eagerly, so there is no jit and no
mesh; ``train_multi_step`` (JAX's K-step ``lax.scan``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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


def make_train_functions(model: torch.nn.Module, optimizer: Optimizer) -> TrainFunctions:
    """Build the step functions of ``model``.

    Every step's metrics carry ``"lr"``: the optimizer's learning rate (a
    float or a schedule) read at the optimizer count that the update is
    scaled with.  The count advances once per effective batch, so with
    accumulation the micro-steps of one batch report the same ``lr``.
    """

    def init_state(seed: int | None = None) -> TrainState:
        if seed is not None:
            model.init_weights(seed)
        params = dict(model.named_parameters())
        return TrainState(step=0, params=params, opt_state=optimizer.init(params))

    def train_step(state: TrainState, batch: torch.Tensor):
        batch = torch.as_tensor(batch, device=model.device)
        ids, labels = batch[:, :-1], batch[:, 1:]
        for p in state.params.values():
            p.grad = None
        loss = batch_loss(model(ids), labels)
        loss.backward()
        grads = {name: p.grad for name, p in state.params.items()}
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads),
                   "lr": lr_at(optimizer.learning_rate, state.opt_state.count)}
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor) -> dict:
        batch = torch.as_tensor(batch, device=model.device)
        ids, labels = batch[:, :-1], batch[:, 1:]
        logits = model(ids)
        # all-zero rows are padding that squares off a final partial eval
        # batch; callers drop them by this mask
        return {"loss": batch_loss(logits, labels),
                "per_row_loss": cross_entropy(logits, labels),
                "real_rows": (batch != 0).any(dim=1)}

    return TrainFunctions(init_state=init_state, train_step=train_step,
                          eval_step=eval_step)
