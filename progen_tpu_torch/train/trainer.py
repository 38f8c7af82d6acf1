"""The training loop of the port (ported from progen_tpu/train/trainer.py, the
per-step path): tfrecords -> the train step -> periodic validation,
sampling and checkpoints -> resume at the exact record cursor.

* ``restore_or_init`` restores the newest checkpoint (a stored model config
  that differs from the requested one raises) or draws fresh weights;
* the epoch/step loop runs ``grad_accum_every`` micro-steps per optimizer
  step and fetches the loss to the host only every ``log_every`` steps;
* hooks at the JAX package's cadences: log, checkpoint, validate, sample;
  the throughput meter is rebased after them and the watchdog beats each
  step and after them;
* a SIGTERM makes the loop save at the next step boundary and return
  ``preempted: True``; ``max_steps`` ends with a save that waits;
* ``run`` retries the loop ``run_attempts`` times: a transient failure
  re-restores from the newest checkpoint.

Traps kept from the JAX package: ``TrainState.step`` counts MICRO-steps,
``global_step = step // grad_accum_every``; the stored cursor grows by the
effective batch and is never wrapped, and the resume skip is the cursor
modulo the corpus unshuffled but the whole cursor shuffled (a seeded
shuffle orders every pass differently).

The port's optimizer updates params, moments and accumulator IN PLACE, so
a background checkpoint first takes a snapshot: a device clone of the state
made before the next step is launched; a thread copies the clone into
pinned host memory on a side stream (after an event that marks the clone
done) and writes it.  A periodic save that finds the previous one still writing is
skipped; an exit or preemption save joins it and writes.  A failed write
surfaces (a ``RetryError`` from the store) when the thread is joined.

Across ranks (``mesh``, a ``core/mesh.MeshConfig``, and ``strategies``
``dp``, ``fsdp``, ``tp`` and ``sp``; one process per card, started by
``torchrun`` or given a process group first): every rank builds the model
from the same seed, then ``parallel/sharding.parallelize`` places it, and
each rank reads
its own batch shard of the records (``process_batch_shards``: ``batch_size``
rows per shard, so the shards' rows together are the global batch, as in
JAX).  Every rank samples, through the meshed sampler on the training
model in its training shardings (``parallel/decode.py``; JAX's sample hook
never gathers the params to one chip), and only rank 0 writes the tracker
and prints; a checkpoint is
gathered one whole tensor at a time into rank 0's host memory and written
by rank 0 alone, in the store's one layout (a packed ``tp`` parameter's
pieces put back in order), so it restores at any world size and without a
mesh.

Before it builds the model the Trainer plans the step's memory
(``train/memory.py``, the JAX Trainer's arguments) and raises the plan's
``check_fits`` error when the plan does not fit the rank's card; there is
no gate off the card, and ``PROGEN_SKIP_MEMORY_CHECK=1`` skips it.  The plan
is ``self.memory_plan`` (None when skipped).

Observability: each loop phase is a span of the process tracer
(``observe/trace.py``, a no-op unless tracing is on) and a flight-recorder
event; each logged step publishes the ``train.*`` health gauges into the
process metrics registry from the host floats the log already fetched.
``statusz_port`` serves ``/healthz /statusz /metricsz /tracez /flightz``
on a loopback port from rank 0 (``observe/statusz.py``; 0 = an ephemeral
port, printed as a JSON line).

:meth:`Trainer.close` stops the statusz server, gives SIGTERM back to the
handler it had before the Trainer took it, and drops the Trainer's model,
step functions and sampler: the caller calls it on every way out.

The superstep (``superstep > 1``, the port of JAX's ``_run_loop_superstep``):
a :class:`~progen_tpu_torch.data.prefetch.SuperbatchStager` stacks each
span's micro-batches, and ``train_multi_step`` advances a SPAN of optimizer
steps at once, on the card as replays of one captured optimizer step
(``train/step.py``).  :func:`superstep_span` sizes each span to end on the
nearest hook boundary, so every log, checkpoint, validation, sample and
epoch boundary fires at the same ``global_step`` as in the per-step loop;
the metrics stay on the device and are fetched once per logged span.  The
first span of an attempt captures the step (the kernels' build and the
capture), under the watchdog's grace; a retry that restores the state
again captures again (the graph holds the state's addresses).  Under a mesh
the superstep runs the meshed step (``train/step.py:superstep_route``: the
captured graph on the card, the body in a loop on the CPU); the first line
the Trainer prints names the route.

Fields of :class:`TrainerConfig` the port does not honour (attention/SGU
implementations other than the port's kernels) are refused by name when set
away from their defaults; so are strategies without a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import sys
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.mesh import (
    MeshConfig,
    initialize_distributed,
    make_mesh,
    mesh_sizes,
    process_batch_shards,
)
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.prefetch import DevicePrefetcher, SuperbatchStager
from progen_tpu_torch.data.tfrecord import iterator_from_tfrecords_folder
from progen_tpu_torch.data.tokenizer import decode_tokens
from progen_tpu_torch.decode.rng import KeySeq
from progen_tpu_torch.decode.sampler import make_sampler
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe.flops import mfu, model_flops_per_token, peak_flops_per_chip
from progen_tpu_torch.observe.meter import ThroughputMeter, profile_trace
from progen_tpu_torch.observe.metrics import get_registry
from progen_tpu_torch.observe.statusz import StatuszServer
from progen_tpu_torch.observe.trace import get_tracer
from progen_tpu_torch.observe.tracker import Tracker
from progen_tpu_torch.parallel.sharding import (
    check_strategies,
    full_tensor,
    validate_tp_divisibility,
)
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.retry import RetryError, default_classifier
from progen_tpu_torch.resilience.watchdog import FlightRecorder, Watchdog
from progen_tpu_torch.train.memory import check_fits, device_hbm_bytes
from progen_tpu_torch.train.memory import plan as memory_plan
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.schedule import make_lr_schedule
from progen_tpu_torch.train.step import TrainState, make_train_functions

# TrainerConfig fields the port refuses away from their defaults
NOT_PORTED = ("attn_impl", "sgu_impl")

# the Trainer's records come from the main thread and the background save's
_STDOUT_LOCK = threading.Lock()


def write_json_line(record: dict) -> None:
    """``record`` as one JSON line on stdout: the line and its newline in one
    write under a lock, so records from two threads never share a line
    (``print`` writes the newline on its own)."""
    line = json.dumps(record) + "\n"
    with _STDOUT_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


def superstep_span(global_step: int, k_max: int, cadences: Sequence[int],
                   remaining: int) -> int:
    """Optimizer steps the next superstep may cover (copied from
    ``progen_tpu/train/trainer.py:superstep_span``): the distance from
    ``global_step`` to the NEAREST hook boundary among ``cadences``
    (every-N step counts; a hook fires when ``global_step % every == 0``),
    capped by ``k_max`` and the ``remaining`` epoch/max_steps budget.

    Always >= 1.  A span never crosses a boundary, and it ENDS exactly on
    the nearest boundary whenever that is within ``k_max`` steps, so every
    hook fires at the same global_step as the per-step loop, never skipped
    and never doubled."""
    span = min(k_max, remaining)
    for every in cadences:
        if every and every > 0:
            span = min(span, every - global_step % every)
    return max(1, span)


@dataclasses.dataclass
class TrainerConfig:
    seed: int = 42
    batch_size: int = 4            # micro-batch
    grad_accum_every: int = 4
    epochs: int = 100
    learning_rate: float = 2e-4
    weight_decay: float = 1e-3
    max_grad_norm: float = 0.5
    validate_every: int = 100
    sample_every: int = 500
    checkpoint_every: int = 1000
    checkpoint_keep_n: int = 500
    prime_length: int = 25
    mixed_precision: bool = True
    # seeded sliding-buffer record shuffle (0 = off); resume is exact
    # because the cursor skip applies to the shuffle's output
    shuffle_buffer: int = 0
    lr_schedule: str = "constant"  # "constant" | "cosine" | "linear"
    warmup_steps: int = 0
    schedule_steps: int | None = None  # decay horizon; defaults to max_steps
    lr_min_ratio: float = 0.1
    # across ranks: a MeshConfig (None: one process, no mesh) and the
    # strategies "dp", "fsdp", "tp", "sp"
    strategies: Sequence[str] = ("dp",)
    mesh: MeshConfig | None = None
    # recompute each block in the backward: "full", "dots" or "attn"
    # (models/progen.py)
    remat: bool = False
    remat_policy: str = "full"
    # not ported: refused by name unless left at these values
    attn_impl: str = "kernel"      # the port's K1 kernels (plain on the CPU)
    sgu_impl: str = "kernel"       # the port's K2 kernels (plain on the CPU)
    # up to this many optimizer steps per train_multi_step (1 = per step);
    # spans shrink to land on hook boundaries
    superstep: int = 1
    # live introspection: /healthz /statusz /metricsz /tracez /flightz on a
    # loopback port of rank 0 (0 = ephemeral; None = off).  The handlers
    # read host state only, never the device
    statusz_port: int | None = None
    # batches made and copied to the device ahead of the step by a worker
    # thread (0 = synchronous).  0 by default, unlike the JAX package's 2:
    # the worker's batch work holds the GIL against the loop's launches, so
    # on the card it hid nothing (PERF.md)
    prefetch_depth: int = 0
    # checkpoint from a device snapshot on a background thread
    background_checkpoint: bool = True
    log_every: int = 10
    sample_top_k: int = 25
    profile_dir: str | None = None
    max_steps: int | None = None
    # one short sampler call before the loop, so the first sample hook
    # does not stall the loop; skipped when no sample hook can fire
    warm_sampler: bool = True
    # tries of the train loop: a transient failure re-restores from the
    # newest checkpoint and continues (1 = fail fast)
    run_attempts: int = 1
    # seconds without a completed step before the watchdog dumps all
    # thread stacks and the flight recorder and exits 42 (None = off)
    watchdog_timeout: float | None = None
    watchdog_dir: str | None = None   # default: the tracker's run dir
    flight_recorder_n: int = 64


def _refuse_unported(cfg: TrainerConfig) -> None:
    defaults = TrainerConfig()
    for name in NOT_PORTED:
        value, default = getattr(cfg, name), getattr(defaults, name)
        if value != default:
            raise ValueError(
                f"TrainerConfig.{name}={value!r} is not ported yet (the port "
                f"supports only {default!r})")
    if cfg.superstep < 1:
        raise ValueError(f"TrainerConfig.superstep={cfg.superstep!r}: must be >= 1")
    if cfg.mesh is None and tuple(cfg.strategies) != ("dp",):
        raise ValueError(f"TrainerConfig.strategies={tuple(cfg.strategies)!r} needs "
                         "TrainerConfig.mesh")


def _map_state(fn, state: TrainState) -> TrainState:
    """``state`` with ``fn`` applied to every tensor of the params, the
    moments and the accumulator."""
    each = lambda d: None if d is None else {k: fn(v) for k, v in d.items()}
    opt = state.opt_state
    return TrainState(state.step, each(state.params), dataclasses.replace(
        opt, mu=each(opt.mu), nu=each(opt.nu), acc_grads=each(opt.acc_grads)))


def _snapshot(state: TrainState) -> TrainState:
    """A copy of ``state`` on its device: the next step updates the live
    tensors in place."""
    with torch.no_grad():
        return _map_state(lambda t: t.detach().clone(), state)


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into pinned host memory on the current stream (the
    caller synchronises it)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


def _gathered_to_host(state: TrainState, keep: bool, pieces) -> TrainState | None:
    """``state`` whole in host memory on the rank that ``keep``s it, None on
    the others; ``pieces(name)``: a packed parameter's pieces (its moments'
    and accumulator's too).  One tensor at a time is gathered and copied out
    (on a card into pinned memory, on the current stream: the caller waits
    for it), so the device holds the shards and one whole tensor, whatever
    the model's size.  Collectives: every rank calls it, at the same step."""
    def whole(name, t):
        t = t.detach()
        out = full_tensor(t, pieces(name))
        if not keep:
            return None
        if out.is_cuda:
            return _pinned_copy(out)
        return out.clone() if out is t else out
    each = lambda d: None if d is None else {k: whole(k, v) for k, v in d.items()}
    opt = state.opt_state
    with torch.no_grad():
        host = TrainState(state.step, each(state.params), dataclasses.replace(
            opt, mu=each(opt.mu), nu=each(opt.nu), acc_grads=each(opt.acc_grads)))
    return host if keep else None


class Trainer:
    def __init__(
        self,
        model_config: ProGenConfig,
        cfg: TrainerConfig,
        data_path: str,
        checkpoint_path: str,
        tracker: Tracker | None = None,
        device: torch.device | str | None = None,
    ):
        _refuse_unported(cfg)
        self.model_config = model_config
        self.cfg = cfg
        self.data_path = data_path
        self.device = resolve_device(device)
        self.mesh = None
        self.rank, self.world = 0, 1
        self.data_shard_count, self.data_shard_index = 1, 0
        if cfg.mesh is not None:
            if not dist.is_initialized():  # torchrun's environment, or one rank
                initialize_distributed(self.device)
            self.mesh = make_mesh(cfg.mesh, self.device.type)
            check_strategies(cfg.strategies, self.mesh)
            # a tensor size that cannot divide the model's sharded dims
            # fails here with the actual mistake
            validate_tp_divisibility(model_config, mesh_sizes(self.mesh)["tensor"],
                                     cfg.strategies)
            seq = mesh_sizes(self.mesh)["seq"]
            if seq > 1 and "sp" not in cfg.strategies:
                raise ValueError(
                    f"mesh has seq axis {seq} but 'sp' is not in strategies "
                    f"{tuple(cfg.strategies)} — the seq devices would replicate "
                    "work; add 'sp' or set MeshConfig(seq=1)")
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            # the batch shards over ('data', 'fsdp'): a seq group's ranks
            # read identical rows
            self.data_shard_count, self.data_shard_index = process_batch_shards(self.mesh)
        self.policy = make_policy(cfg.mixed_precision)
        # fail fast, before anything is placed on the card, on a
        # configuration whose planned memory does not fit the rank's card
        self.memory_plan = None
        if os.environ.get("PROGEN_SKIP_MEMORY_CHECK") != "1":
            self.memory_plan = memory_plan(
                model_config,
                batch_size=cfg.batch_size * self.data_shard_count,
                mesh_shape=mesh_sizes(self.mesh) if self.mesh is not None else None,
                strategies=cfg.strategies, remat=cfg.remat, remat_policy=cfg.remat_policy,
                attn_impl=cfg.attn_impl, sgu_impl=cfg.sgu_impl,
                mixed_precision=cfg.mixed_precision,
                grad_accum_every=cfg.grad_accum_every,
                # the state clone a background save makes (without a mesh: a
                # meshed save gathers one tensor at a time to the host)
                checkpoint_snapshot=cfg.background_checkpoint and self.mesh is None,
                superstep_k=cfg.superstep)
            kind = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else None)
            err = check_fits(self.memory_plan, device_hbm_bytes(self.device),
                             device_kind=kind)
            if err is not None:
                raise ValueError(err)
        self.model = ProGen(model_config, self.policy, device=self.device,
                            seed=cfg.seed, remat=cfg.remat, remat_policy=cfg.remat_policy)
        self.lr_schedule = make_lr_schedule(
            cfg.lr_schedule, cfg.learning_rate, warmup_steps=cfg.warmup_steps,
            decay_steps=cfg.schedule_steps or cfg.max_steps,
            min_lr_ratio=cfg.lr_min_ratio)
        self.optimizer = make_optimizer(
            self.lr_schedule, cfg.weight_decay, cfg.max_grad_norm,
            cfg.grad_accum_every)
        self.fns = make_train_functions(self.model, self.optimizer, mesh=self.mesh,
                                        strategies=cfg.strategies)
        self.store = CheckpointStore(checkpoint_path, cfg.checkpoint_keep_n)
        # one writer: rank 0
        self.tracker = (tracker if self.rank == 0 else None) or Tracker(disabled=True)
        # under a mesh the sampler decodes the training model in its
        # training shardings, never gathered: every rank calls it
        self.sampler = make_sampler(
            self.model, mesh=self.mesh, strategies=cfg.strategies,
            params_shardings=getattr(self.model, "parallel_plan", None))
        self.keys = KeySeq(cfg.seed)
        # 12 sync intervals: long enough to be sustained, short enough to
        # slide past cold-start artifacts
        self.meter = ThroughputMeter(window=12, chips=self.world)
        self._preempt_requested = False
        self._ckpt_thread: threading.Thread | None = None
        self._ckpt_error: BaseException | None = None
        # what each save cost: step, snapshot ms (host and device), the
        # host copy's and the write's seconds, whether it was written
        self.checkpoint_log: list[dict] = []
        self.restore_seconds: float | None = None
        self._recorder = FlightRecorder(cfg.flight_recorder_n)
        # the process tracer (enabled by the entry point): every loop phase
        # is a span as well as a flight-recorder event
        self._tracer = get_tracer()
        self._watchdog: Watchdog | None = None
        self._statusz: StatuszServer | None = None
        self.statusz_port: int | None = None
        if cfg.statusz_port is not None and self.rank == 0:
            self._statusz = StatuszServer(
                role="trainer", port=cfg.statusz_port,
                providers={"health": self._statusz_health,
                           "status": self._statusz_status,
                           "flight": self._recorder.snapshot})
            self.statusz_port = self._statusz.start()
            self._emit(statusz=f"http://127.0.0.1:{self.statusz_port}")
        self._took_sigterm = False
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._request_preempt_checkpoint)
            self._took_sigterm = True
        except ValueError:
            pass  # not the main thread (e.g. under a test runner)

    def close(self) -> None:
        """Release what the Trainer holds beyond its results: stop the
        statusz server, wait for a background save, give SIGTERM back to
        the handler it had before this Trainer (the bound handler held the
        whole Trainer), and drop the model, the step functions, the sampler
        and the optimizer.  A state that ``run()`` returned stays the
        caller's.  Safe to call twice."""
        if self._statusz is not None:
            self._statusz.stop()
            self._statusz = None
        try:
            self._join_checkpoint_thread()
        finally:
            if self._took_sigterm and (signal.getsignal(signal.SIGTERM)
                                       == self._request_preempt_checkpoint):
                try:
                    # None stands for a handler not set from Python:
                    # the default is the nearest
                    signal.signal(signal.SIGTERM, self._prev_sigterm
                                  if self._prev_sigterm is not None else signal.SIG_DFL)
                except ValueError:
                    pass  # not the main thread
            self._took_sigterm = False
            self._prev_sigterm = None
            self.model = self.sampler = None
            self.fns = self.optimizer = None

    def _request_preempt_checkpoint(self, signum=None, frame=None) -> None:
        self._preempt_requested = True

    def _emit(self, **record: Any) -> None:
        if self.rank == 0:
            write_json_line(record)

    def _note_phase(self, name: str, t0: float, **fields: Any) -> None:
        """One loop phase -> a trace span AND a flight-recorder event, so a
        watchdog trip shows the recent phase history whether or not the
        process is tracing (the recorder is always on)."""
        dur = time.perf_counter() - t0
        self._tracer.add(name, t0, dur, **fields)
        self._recorder.record(name, dur_s=round(dur, 6), **fields)

    def _statusz_health(self) -> dict:
        last_step = None
        for e in reversed(self._recorder.snapshot()):
            if e.get("kind") == "step":
                last_step = e
                break
        return {"last_step": last_step,
                "watchdog": self._watchdog is not None,
                "preempt_requested": self._preempt_requested}

    def _statusz_status(self) -> dict:
        return {"model": self.model_config.to_dict(),
                "superstep": self.cfg.superstep,
                "batch_size": self.cfg.batch_size,
                "max_steps": self.cfg.max_steps,
                "recent": self._recorder.snapshot()[-16:]}

    def _publish_train_health(self, log: dict, step: int) -> None:
        """Training-health gauges in the process registry, from the host
        floats of the logged step (no extra device sync): ``train.step``,
        ``train.loss``, ``train.grad_norm``, ``train.lr`` and the
        ``train.nonfinite_steps`` counter."""
        registry = get_registry()
        registry.gauge("train.step").set(step)
        registry.gauge("train.loss").set(log["loss"])
        registry.gauge("train.grad_norm").set(log["grad_norm"])
        registry.gauge("train.lr").set(log["lr"])
        if not (math.isfinite(log["loss"]) and math.isfinite(log["grad_norm"])):
            registry.counter("train.nonfinite_steps").inc()

    def _to_device(self, np_batch) -> torch.Tensor:
        return torch.from_numpy(np.asarray(np_batch)).to(self.device)

    def _warm_sampler(self, global_step: int) -> None:
        """One short sampler call (the prefill and a decode step) before the
        loop when a sample hook can fire in this run, so the first hook does
        not stall the loop on first-launch costs (the kernels' build,
        allocations)."""
        cfg = self.cfg
        next_hook = (global_step // cfg.sample_every + 1) * cfg.sample_every
        if not cfg.warm_sampler or (
                cfg.max_steps is not None and next_hook > cfg.max_steps):
            return
        prime = torch.zeros((1, cfg.prime_length), dtype=torch.long,
                            device=self.device)
        self.sampler(prime, cfg.prime_length + 1,
                     key=torch.zeros(2, dtype=torch.int64), top_k=cfg.sample_top_k)

    def _pieces(self, name: str) -> int:
        """The packed pieces of parameter ``name`` under ``tp`` (1 else)."""
        plan = getattr(self.model, "parallel_plan", None)
        return 1 if plan is None else plan.pieces(name)

    # -- state ---------------------------------------------------------------

    def restore_or_init(self):
        """Returns ``(state, start_seq_index, run_id)``: the newest
        checkpoint when there is one (its model config must equal the
        requested one), else fresh weights drawn from ``cfg.seed``."""
        meta = self.store.restore_meta()
        if meta is None:
            next(self.keys)  # the JAX trainer draws its init key here
            return self.fns.init_state(seed=self.cfg.seed), 0, None
        stored_cfg = ProGenConfig.from_dict(meta["model_config"])
        if stored_cfg != self.model_config:
            raise ValueError(
                "checkpoint model config differs from requested config; "
                f"rebuild the Trainer with the stored config: {stored_cfg}")
        t0 = time.perf_counter()
        state = self.store.restore_state(self.fns.init_state(), pieces=self._pieces)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.restore_seconds = time.perf_counter() - t0
        return state, meta["next_seq_index"], meta.get("run_id")

    # -- loop ----------------------------------------------------------------

    def run(self) -> dict[str, Any]:
        """Up to ``cfg.run_attempts`` tries of the train loop.  A TRANSIENT
        failure (I/O retry exhaustion, an injected fault) re-restores from
        the newest checkpoint, at worst replaying the steps since the last
        save; fatal errors and the last attempt's failure propagate."""
        attempts = max(1, self.cfg.run_attempts)
        for attempt in range(1, attempts + 1):
            try:
                return self._run_attempt()
            except Exception as e:
                transient = isinstance(e, RetryError) or default_classifier(e)
                if attempt >= attempts or not transient:
                    raise
                self._recorder.record("run-retry", attempt=attempt, error=repr(e))
                self._emit(event="run_retry", attempt=attempt, attempts=attempts,
                           error=repr(e))
                try:
                    self._join_checkpoint_thread()
                except Exception:
                    pass  # the save that failed is why we are here

    def _run_attempt(self) -> dict[str, Any]:
        cfg = self.cfg
        seq_len = self.model_config.seq_len
        total_train, get_train = iterator_from_tfrecords_folder(self.data_path, "train")
        total_valid, get_valid = iterator_from_tfrecords_folder(self.data_path, "valid")
        if total_train <= 0:
            raise ValueError(f"no protein sequences found for training in {self.data_path}")
        if total_valid <= 0:
            raise ValueError(f"no protein sequences found for validation in {self.data_path}")

        state, start_seq_index, _ = self.restore_or_init()
        # unshuffled passes are identical, so the wrapped position is an
        # exact skip; a shuffled stream orders each pass differently, so it
        # skips the whole un-wrapped cursor
        epoch_position = start_seq_index % total_train
        skip = start_seq_index if cfg.shuffle_buffer else epoch_position
        # the global effective batch: every batch shard's micro-batches
        effective_batch = cfg.batch_size * cfg.grad_accum_every * self.data_shard_count
        shard = {"process_count": self.data_shard_count,
                 "process_index": self.data_shard_index}

        train_it = get_train(seq_len=seq_len, batch_size=cfg.batch_size, skip=skip,
                             loop=True, shuffle_buffer=cfg.shuffle_buffer,
                             seed=cfg.seed, **shard)
        if cfg.superstep > 1:
            # the stager owns the iterator and stacks each span's
            # micro-batches, copying the next while the replays run
            train_it = SuperbatchStager(train_it, device=self.device,
                                        accum=cfg.grad_accum_every, k_max=cfg.superstep,
                                        depth=max(1, cfg.prefetch_depth))
        elif cfg.prefetch_depth > 0:
            train_it = DevicePrefetcher(train_it, device=self.device,
                                        depth=cfg.prefetch_depth)
        valid_it = get_valid(seq_len=seq_len, batch_size=cfg.batch_size, loop=True,
                             **shard)
        # TrainState.step counts MICRO-steps; global_step optimizer steps
        global_step = state.step // cfg.grad_accum_every
        watchdog = None
        try:
            num_params = sum(p.numel() for p in state.params.values())
            self._emit(params=num_params, seq_len=seq_len, num_sequences=total_train,
                       start_seq_index=start_seq_index,
                       superstep_route=(self.fns.superstep_route if cfg.superstep > 1
                                        else None))
            self._warm_sampler(global_step)
            if cfg.watchdog_timeout:
                out_dir = cfg.watchdog_dir or str(getattr(self.tracker, "_dir", None) or ".")
                watchdog = Watchdog(cfg.watchdog_timeout, out_dir=out_dir,
                                    recorder=self._recorder,
                                    label=f"train from step {global_step}")
                watchdog.start()
            self._watchdog = watchdog
            return self._run_loop(state, train_it, valid_it, total_train,
                                  epoch_position, effective_batch, global_step,
                                  start_seq_index)
        finally:
            if watchdog is not None:
                watchdog.stop()
            self._watchdog = None
            if isinstance(train_it, (DevicePrefetcher, SuperbatchStager)):
                train_it.close()
            # an exception must not abandon the checkpoint thread mid-write
            self._join_checkpoint_thread()

    def _dispatch(self, state, train_it, span: int):
        """``span`` optimizer steps: ``grad_accum_every`` train steps each
        (``span`` is 1), or one ``train_multi_step`` over the stager's next
        superbatch.  Returns the state, the last micro-step's ``loss``,
        ``grad_norm`` and ``lr`` on the device, and the seconds spent waiting
        for data."""
        cfg = self.cfg
        t0 = time.perf_counter()
        if cfg.superstep > 1:
            superbatch = train_it.get(span)
            waited = time.perf_counter() - t0
            state, metrics = self.fns.train_multi_step(state, superbatch)
            return state, {"loss": metrics["loss"][-1, -1],
                           "grad_norm": metrics["grad_norm"][-1, -1],
                           "lr": metrics["lr"][-1]}, waited
        waited = 0.0
        for _ in range(cfg.grad_accum_every):
            tw = time.perf_counter()
            batch = next(train_it)
            if not isinstance(train_it, DevicePrefetcher):
                batch = self._to_device(batch)
            waited += time.perf_counter() - tw
            state, metrics = self.fns.train_step(state, batch)
        return state, metrics, waited

    def _run_loop(self, state, train_it, valid_it, total_train, epoch_position,
                  effective_batch, global_step, seq_cursor):
        """The epoch/step loop.  Each turn advances a span of optimizer
        steps: one step in the per-step loop, up to ``superstep`` in the
        superstep loop (:func:`superstep_span`: a span ends on the nearest
        hook boundary, so every hook fires at the step the per-step loop
        fires it at)."""
        cfg = self.cfg
        seq_len = self.model_config.seq_len
        num_params = sum(p.numel() for p in state.params.values())
        flops_per_token = model_flops_per_token(self.model_config, num_params)
        peak = peak_flops_per_chip(self.device)  # None off the H100 -> mfu not logged
        watchdog = self._watchdog
        cadences = (cfg.log_every, cfg.checkpoint_every, cfg.validate_every,
                    cfg.sample_every)
        last_loss = None
        pending_tokens = pending_steps = meter_steps = 0
        data_wait = 0.0
        since = time.perf_counter()
        first = True

        with profile_trace(cfg.profile_dir):
            for epoch in range(1, cfg.epochs + 1):
                self._emit(epoch=epoch)
                epoch_start = epoch_position if epoch == 1 else 0
                steps_per_epoch = max(1, (total_train - epoch_start) // effective_batch)
                done = 0
                while done < steps_per_epoch:
                    remaining = steps_per_epoch - done
                    if cfg.max_steps is not None:
                        remaining = min(remaining, cfg.max_steps - global_step)
                    span = superstep_span(global_step, cfg.superstep, cadences, remaining)
                    if watchdog is not None:
                        watchdog.beat(f"step {global_step + 1}" if span == 1
                                      else f"steps {global_step + 1}..{global_step + span}")
                    # one inject per optimizer step, before its dispatch
                    for _ in range(span):
                        faults.inject("train.step")
                    # the attempt's first dispatch launches every kernel for
                    # the first time (the build, on the card) and captures
                    # the superstep's graph: a stall the watchdog must not
                    # book as a hang
                    grace = (watchdog.paused() if watchdog is not None and first
                             else contextlib.nullcontext())
                    first = False
                    t0 = time.perf_counter()
                    with grace:
                        state, metrics, waited = self._dispatch(state, train_it, span)
                    data_wait += waited
                    done += span
                    global_step += span
                    self._note_phase("train.step_dispatch", t0, step=global_step, span=span)
                    # monotonic, never wrapped: the stored cursor must name
                    # the position in the multi-epoch STREAM
                    seq_cursor += effective_batch * span
                    pending_tokens += effective_batch * seq_len * span
                    pending_steps += span
                    meter_steps += span

                    will_hook = (global_step % cfg.checkpoint_every == 0
                                 or global_step % cfg.validate_every == 0
                                 or global_step % cfg.sample_every == 0)
                    if global_step % cfg.log_every == 0:
                        t0 = time.perf_counter()
                        # one batched transfer waits for the steps: the
                        # loop's sync point (one copy, not one per metric;
                        # the stack's dtype promotion keeps every value)
                        host = torch.stack(  # graftcheck: disable=host-sync
                            [metrics["loss"], metrics["grad_norm"], metrics["lr"]]).tolist()
                        last_loss = host[0]
                        now = time.perf_counter()
                        self.meter.tick(pending_tokens, steps=meter_steps)
                        log = {"loss": last_loss,
                               "grad_norm": host[1],
                               "lr": host[2],
                               "step_ms": (now - since) / pending_steps * 1e3,
                               "data_wait_ms": data_wait / pending_steps * 1e3}
                        since, pending_tokens, pending_steps, data_wait = now, 0, 0, 0.0
                        meter_steps = 0
                        tps = self.meter.tokens_per_sec_per_chip
                        if tps is not None:
                            log["tokens_per_sec_per_chip"] = tps
                            util = mfu(tps, flops_per_token, peak)
                            if util is not None:
                                log["mfu"] = util
                        self.tracker.log(log, global_step)
                        self._recorder.record("step", step=global_step, **log)
                        self._note_phase("train.log", t0, step=global_step)
                        self._publish_train_health(log, global_step)
                        self._emit(step=global_step, **log)

                    if will_hook and pending_tokens:
                        # sync and tick BEFORE the hooks, so their wall time
                        # is never rated against these steps' tokens: a
                        # barrier, the value is not needed
                        float(metrics["grad_norm"])  # graftcheck: disable=host-sync
                        self.meter.tick(pending_tokens, steps=meter_steps)
                        pending_tokens = meter_steps = 0

                    hooks_ran = False
                    if global_step % cfg.checkpoint_every == 0:
                        t0 = time.perf_counter()
                        self._checkpoint(state, seq_cursor)
                        self._note_phase("train.checkpoint", t0, step=global_step)
                        hooks_ran = True

                    if global_step % cfg.validate_every == 0:
                        t0 = time.perf_counter()
                        vmetrics = self.fns.eval_step(state, self._to_device(next(valid_it)))
                        vloss = float(vmetrics["loss"])  # graftcheck: disable=host-sync
                        self.tracker.log({"valid_loss": vloss}, global_step)
                        self._note_phase("train.validate", t0, step=global_step, loss=vloss)
                        self._emit(step=global_step, valid_loss=vloss)
                        hooks_ran = True

                    if global_step % cfg.sample_every == 0:
                        self._sample_and_log(next(valid_it), global_step)
                        hooks_ran = True

                    if hooks_ran:
                        # hook time is neither training time nor a stall
                        self.meter.rebase()
                        since, pending_steps, data_wait = time.perf_counter(), 0, 0.0
                        if watchdog is not None:
                            watchdog.beat(f"hooks at step {global_step}")

                    if self._preempted(global_step, will_hook or global_step % cfg.log_every == 0):
                        # the process exits right after: the save must commit
                        self._checkpoint(state, seq_cursor, wait=True)
                        self._emit(step=global_step, preempted=True,
                                   next_seq_index=seq_cursor)
                        return {"state": state, "loss": last_loss,
                                "step": global_step, "preempted": True}

                    if cfg.max_steps is not None and global_step >= cfg.max_steps:
                        self._checkpoint(state, seq_cursor, wait=True)
                        return self._finish(state, last_loss, global_step)
        return self._finish(state, last_loss, global_step)

    def _preempted(self, global_step: int, synced: bool) -> bool:
        """A preemption was asked for.  Under a mesh on any rank, so that
        they save together; asked only at steps that wait for the device
        anyway (``synced``: logged or hooked ones), as the vote does."""
        asked = self._preempt_requested or self.store.reached_preemption(global_step)
        if self.mesh is None:
            return asked
        if not synced:
            return False
        flag = torch.tensor([int(asked)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        # the vote's one transfer, at a step that waits for the device anyway
        return bool(flag.item())  # graftcheck: disable=host-sync

    def _finish(self, state, last_loss, global_step: int) -> dict[str, Any]:
        """The full-validation loss at the end of training, logged and
        returned."""
        self._join_checkpoint_thread()
        valid_loss = self.evaluate(state)
        if valid_loss is not None:
            self.tracker.log({"full_valid_loss": valid_loss}, global_step)
            self._emit(step=global_step, full_valid_loss=valid_loss)
        return {"state": state, "loss": last_loss, "step": global_step,
                "valid_loss": valid_loss}

    def evaluate(self, state) -> float | None:
        """Mean per-row loss over the ENTIRE validation split, one pass.
        The final partial batch is zero-padded to the batch size and the
        pad rows are masked out by the step's ``real_rows``, so the mean is
        exact over all records.  Under a mesh each batch shard reads its
        records, every rank takes as many batches as the largest shard
        (all-zero ones past its end) and the sums meet over the shards."""
        cfg = self.cfg
        total_valid, get_valid = iterator_from_tfrecords_folder(self.data_path, "valid")
        if total_valid == 0:
            return None
        it = get_valid(seq_len=self.model_config.seq_len, batch_size=cfg.batch_size,
                       loop=False, process_count=self.data_shard_count,
                       process_index=self.data_shard_index)
        width = self.model_config.seq_len + 1
        loss_sum, rows = 0.0, 0
        per_shard = -(-total_valid // self.data_shard_count)
        for _ in range(-(-per_shard // cfg.batch_size)):
            np_batch = next(it, np.zeros((0, width), np.int32))
            if np_batch.shape[0] < cfg.batch_size:
                pad = np.zeros((cfg.batch_size - np_batch.shape[0], np_batch.shape[1]),
                               np_batch.dtype)
                np_batch = np.concatenate([np_batch, pad])
            metrics = self.fns.eval_step(state, self._to_device(np_batch))
            # one transfer per batch: the per-row losses and the real-row
            # mask (promoted to 0/1) in one copy
            per_row, real = torch.stack(  # graftcheck: disable=host-sync
                [metrics["per_row_loss"], metrics["real_rows"]]).cpu().numpy()
            loss_sum += float((per_row * real).sum())
            rows += int(real.sum())
        if self.mesh is not None:
            sums = torch.tensor([loss_sum, rows], dtype=torch.float64, device=self.device)
            for axis in ("data", "fsdp"):  # a seq group's ranks hold the same rows
                if mesh_sizes(self.mesh)[axis] > 1:
                    dist.all_reduce(sums, group=self.mesh.get_group(axis))
            loss_sum, rows = sums.tolist()  # graftcheck: disable=host-sync
            rows = int(rows)
        return loss_sum / rows if rows else None

    # -- hooks ---------------------------------------------------------------

    def _join_checkpoint_thread(self) -> None:
        """Wait for the background save; re-raise what it raised."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        error, self._ckpt_error = self._ckpt_error, None
        if error is not None:
            raise error

    def _checkpoint(self, state, next_seq_index: int, wait: bool = False) -> None:
        step = state.step
        run_id = self.tracker.run_id
        model_config = self.model_config.to_dict()
        cuda = self.device.type == "cuda"
        in_background = self.cfg.background_checkpoint and not wait
        stats = {"step": step, "background": in_background}
        ready = None  # a card's copy is done when this event is
        if self.mesh is not None:
            # every rank gathers; rank 0 writes its host copy (a snapshot)
            t0 = time.perf_counter()
            state = _gathered_to_host(state, keep=self.rank == 0, pieces=self._pieces)
            stats["gather_host_ms"] = (time.perf_counter() - t0) * 1e3
            if self.rank != 0:
                return
            if cuda:
                ready = torch.cuda.Event()
                ready.record()

        def write(snapshot, stats: dict) -> bool:
            # save() skips a step already in the store, so an exit or
            # preemption save after a same-step periodic one costs nothing
            self._recorder.record("checkpoint-start", step=step,
                                  next_seq_index=next_seq_index)
            t0 = time.perf_counter()
            saved = self.store.save(step, snapshot, next_seq_index=next_seq_index,
                                    model_config=model_config, run_id=run_id)
            stats.update(write_s=time.perf_counter() - t0, saved=bool(saved))
            self.checkpoint_log.append(stats)
            self._recorder.record("checkpoint-done", step=step, saved=bool(saved))
            if saved:
                self._emit(step=step // self.cfg.grad_accum_every, checkpoint=step,
                           next_seq_index=next_seq_index)
            return saved

        if not in_background:
            self._join_checkpoint_thread()
            if ready is not None:
                ready.synchronize()
            write(state, stats)
            return

        # one save in flight at a time (bounds the extra device memory to
        # one snapshot); a PERIODIC save that finds it still writing is
        # skipped, not queued: waiting would stall training on the write
        if self._ckpt_thread is not None and self._ckpt_thread.is_alive():
            self._emit(step=step // self.cfg.grad_accum_every,
                       checkpoint_skipped=step, reason="previous save still writing")
            return
        self._join_checkpoint_thread()
        snapshot = state
        if self.mesh is None:
            t0 = time.perf_counter()
            if cuda:
                begin = torch.cuda.Event(enable_timing=True)
                ready = torch.cuda.Event(enable_timing=True)
                begin.record()
            snapshot = _snapshot(state)
            if cuda:
                ready.record()
            stats["snapshot_host_ms"] = (time.perf_counter() - t0) * 1e3

        def background() -> None:
            try:
                host = snapshot
                t1 = time.perf_counter()
                if cuda and self.mesh is None:
                    # copy into pinned memory on a side stream, after the
                    # clone and nothing else: later steps on the main
                    # stream run meanwhile
                    copy_stream = torch.cuda.Stream(self.device)
                    with torch.cuda.stream(copy_stream):
                        copy_stream.wait_event(ready)
                        host = _map_state(_pinned_copy, snapshot)
                    copy_stream.synchronize()
                    stats["snapshot_device_ms"] = begin.elapsed_time(ready)
                elif ready is not None:
                    ready.synchronize()
                stats["fetch_s"] = time.perf_counter() - t1
                write(host, stats)
            except BaseException as e:  # re-raised by _join_checkpoint_thread
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(target=background,
                                             name="progen-checkpoint", daemon=True)
        self._ckpt_thread.start()

    def _sample_and_log(self, valid_batch, step: int) -> None:
        """Prime with the first ``prime_length`` tokens of a validation row,
        decode to ``seq_len`` on the JAX key chain, log.  Under a mesh every
        rank decodes, in the training shardings, rank 0's prime (each rank
        reads its own validation rows), and rank 0 logs."""
        cfg = self.cfg
        prime = torch.as_tensor(np.asarray(valid_batch[:1, :cfg.prime_length]),
                                dtype=torch.long, device=self.device)
        if self.mesh is not None:
            dist.broadcast(prime, src=0)
        t0 = time.perf_counter()
        sampled = self.sampler(prime, self.model_config.seq_len, key=next(self.keys),
                               top_k=cfg.sample_top_k)
        if self.rank != 0:
            return
        prime_str = decode_tokens(prime[0].cpu().numpy())
        sampled_str = decode_tokens(sampled[0, cfg.prime_length:].cpu().numpy())
        self._note_phase("train.sample", t0, step=step)
        self._emit(step=step, prime=prime_str, sample=sampled_str,
                   sample_s=time.perf_counter() - t0)
        self.tracker.log_sample(prime_str, sampled_str, step)
