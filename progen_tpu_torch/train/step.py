"""The train and eval steps (ported from progen_tpu/train/step.py).

One ``train_step`` is forward, loss, backward (through the kernels'
autograd functions on the card), then the optimizer: clip, AdamW and the
parameter update, or only the accumulation on a micro-step that does not
end an effective batch.  The optimizer writes the parameters, the moments
and the accumulator IN PLACE, so a state kept across later steps must be a
copy (the trainer's background checkpoint snapshots it first).  The
``Trainer`` (``train/trainer.py``) drives these steps over tfrecords.

The optimizer reads the scalars that change with its count (the learning
rate and Adam's bias corrections) from a small f32 tensor that the host
fills from the count (``Optimizer.scalars``), not from Python numbers: so a
micro-step has one body, whatever the step, and ``train_step`` and
``train_multi_step`` run that same body on the same tensors.

``train_multi_step(state, superbatch)`` is the port of JAX's fused K-step
``lax.scan``: ``superbatch`` is ``(K, accum, B, seq_len + 1)`` tokens, K
optimizer steps of ``accum`` micro-steps each.  On the card one OPTIMIZER
step (its ``accum`` micro-steps: forward, loss, backward through the
kernels' autograd functions, the clip, AdamW and the in-place update) is
captured once as a CUDA graph (``decode/graphs.CapturedProgram``) and
replayed K times, each replay after its slice of the superbatch and its
scalars are copied into the graph's static inputs: the host puts a few
copies and one replay on the device per optimizer step, where the eager
step launches some thousands of kernels.  The parameters, the moments and
the accumulator are the graph's own addresses (written in place, as the
eager step writes them); a state whose tensors are other ones (a fresh
``init_state``, a restore into new moments) is captured again, which the
step sees from the tensors' addresses.  The capture's warm-up is the span's
first optimizer step itself (the body writes the state, so a warm-up call
cannot be thrown away), so a span of K steps is one eager step and K - 1
replays when it captures, K replays after.  On the CPU the same body runs
``K * accum`` times in a loop.  A capture or replay that fails raises;
nothing falls back to the eager step.  The metrics stay on the device:
``{"loss": (K, accum), "grad_norm": (K, accum), "lr": (K,)}``, ``lr`` the
learning rate each optimizer step's update was scaled with.  A superstep
starts on an optimizer-step boundary (``mini_step == 0``).

Under a mesh (``mesh``, ``strategies``) every rank runs the step on its
rows of the global batch (``parallel/sharding.batch_sharding``), on its
slice of their sequence under ``sp`` and on its heads and channels under
``tp``; the gradients are reduced over the ranks before the clip
(``parallel/sharding.reduce_gradients``), so every rank takes the
one-device step of the global batch.  The metrics are the global batch's on
every rank.

``train_multi_step`` under a mesh runs the same body: on the card the
captured optimizer step holds the mesh's collectives (NCCL, initialised by
the span's first, eager, step before the capture) and the step keys its
graph on the addresses of each rank's local shards; on the CPU (``gloo``)
the body runs in a loop.  :func:`superstep_route` names the route, chosen
by the device before the first dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from progen_tpu_torch.decode.graphs import CapturedProgram
from progen_tpu_torch.parallel.sharding import (
    ParallelPlan,
    batch_mean,
    local,
    parallelize,
    reduce_gradients,
)
from progen_tpu_torch.train.loss import batch_loss, cross_entropy
from progen_tpu_torch.train.optimizer import OptState, Optimizer, Params, global_norm


def superstep_route(device: torch.device | str) -> str:
    """How ``train_multi_step`` advances a span: ``"graph"`` on the card
    (one captured optimizer step replayed, under every mesh and strategy)
    and ``"loop"`` off it (the body in a loop)."""
    return "graph" if torch.device(device).type == "cuda" else "loop"


@dataclasses.dataclass
class TrainState:
    """``step`` counts micro-batches; ``params`` are the model's own
    parameters by ``state_dict`` name (updated in place)."""

    step: int
    params: Params
    opt_state: OptState


@dataclasses.dataclass(frozen=True)
class TrainFunctions:
    """``init_state(seed=None)``, ``train_step(state, batch)``,
    ``eval_step(state, batch)`` and ``train_multi_step(state,
    superbatch)``; ``batch`` is the data pipeline's ``(B, seq_len + 1)``
    int tokens, ``superbatch`` ``(K, accum, B, seq_len + 1)``.
    ``captured_program()`` is the optimizer step's ``CapturedProgram``
    (None until ``train_multi_step`` has captured one on the card);
    ``superstep_route`` is :func:`superstep_route` of the model's
    device."""

    init_state: Callable
    train_step: Callable
    eval_step: Callable
    train_multi_step: Callable | None = None
    captured_program: Callable | None = None
    superstep_route: str = "loop"


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

    def micro_step(state: TrainState, batch: torch.Tensor, scalars: torch.Tensor):
        """The one body of a micro-step: ``scalars`` are the optimizer's
        (``Optimizer.scalars``) for ``state``'s count, on the device."""
        ids, labels = _inputs(batch, plan)
        for p in state.params.values():
            p.grad = None
        loss = batch_loss(model(ids), labels, group=seq_group)
        loss.backward()
        if plan is not None:
            reduce_gradients(plan, state.params)
        grads = {name: p.grad for name, p in state.params.items()}
        metrics = {"loss": global_mean(loss.detach()), "grad_norm": global_norm(grads),
                   "lr": scalars[0]}
        opt_state = optimizer.update(grads, state.opt_state, state.params, scalars)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    def to_device(array: np.ndarray) -> torch.Tensor:
        """A host array on the model's device; on a card from pinned memory
        without waiting (a plain copy from pageable memory would wait for
        the stream)."""
        t = torch.from_numpy(array)
        if model.device.type == "cuda":
            return t.pin_memory().to(model.device, non_blocking=True)
        return t.to(model.device)

    def train_step(state: TrainState, batch: torch.Tensor):
        batch = torch.as_tensor(batch, device=model.device)
        scalars = to_device(optimizer.scalars(state.opt_state.count))
        return micro_step(state, batch, scalars)

    accum = optimizer.grad_accum_every
    captured: dict = {}  # "key" and "program": the captured optimizer step

    def optimizer_step(state: TrainState):
        """One optimizer step of ``state``'s tensors as a body of static
        inputs, ``tokens (accum, B, L + 1)`` and ``scalars (4,)``."""
        def body(tokens, scalars):
            s, rows = state, []
            for a in range(accum):
                s, m = micro_step(s, tokens[a], scalars)
                rows.append(m)
            return {"loss": torch.stack([m["loss"] for m in rows]),
                    "grad_norm": torch.stack([m["grad_norm"] for m in rows]),
                    "lr": scalars[0].clone()}
        return body

    def state_key(state: TrainState, tokens: torch.Tensor) -> tuple:
        """What a captured step is valid for: the tokens' shape and the
        addresses of every tensor the optimizer step reads or writes (a
        DTensor's local shard)."""
        opt = state.opt_state
        tensors = [*state.params.values(), *opt.mu.values(), *opt.nu.values(),
                   *(opt.acc_grads or {}).values()]
        return (tuple(tokens.shape), tokens.dtype,
                tuple(local(t).data_ptr() for t in tensors))

    route = superstep_route(model.device)

    def train_multi_step(state: TrainState, superbatch: torch.Tensor):
        superbatch = torch.as_tensor(superbatch, device=model.device)
        if superbatch.dim() != 4 or superbatch.shape[1] != accum:
            raise ValueError(f"the superbatch must be (K, {accum}, B, L + 1), got "
                             f"{tuple(superbatch.shape)}")
        opt = state.opt_state
        if opt.mini_step != 0:
            raise ValueError(f"a superstep starts on an optimizer-step boundary, the "
                             f"state is at micro-step {opt.mini_step} of {accum}")
        k = superbatch.shape[0]
        scalars = to_device(np.stack([optimizer.scalars(opt.count + i) for i in range(k)]))
        rows = []
        if route == "loop":
            for i in range(k):
                rows.append(optimizer_step(state)(superbatch[i], scalars[i]))
        else:
            key = state_key(state, superbatch[0])
            start = 0
            if captured.get("key") != key:
                captured.clear()  # the old graph and its pool go first
                program = CapturedProgram(optimizer_step(state), superbatch[0], scalars[0],
                                          device=model.device, take_warmup=True)
                captured.update(key=key, program=program)
                rows.append(program.warmup_out)
                program.warmup_out = None
                start = 1
            for i in range(start, k):
                rows.append(captured["program"](superbatch[i], scalars[i]))
        metrics = {"loss": torch.stack([r["loss"] for r in rows]),
                   "grad_norm": torch.stack([r["grad_norm"] for r in rows]),
                   "lr": torch.stack([r["lr"] for r in rows])}
        opt_state = dataclasses.replace(opt, count=opt.count + k)
        return TrainState(state.step + k * accum, state.params, opt_state), metrics

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
                          eval_step=eval_step, train_multi_step=train_multi_step,
                          captured_program=lambda: captured.get("program"),
                          superstep_route=route)
