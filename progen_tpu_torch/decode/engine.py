"""Continuous-batching serving engine: slots, chunked decode, refill
(ported from progen_tpu/decode/engine.py; method names are kept, so each
has its counterpart there).

The batch-synchronous sampler (``decode/sampler.py``) makes every request
in a batch wait for the slowest one.  This engine serves a request QUEUE
through a fixed set of SLOTS:

* **slots**: a fixed-size batch of per-slot state (sequence row, decode
  caches, position, done flag, RNG key, top-k, temperature).  Slots are
  independent: the decode step takes a ``(S,)`` position vector, so slot 3
  can be at position 900 while slot 4 is at position 12;
* **chunked decode**: ``chunk_size`` single-token steps per dispatch, a
  Python loop with NO host synchronisation inside it (position, done and
  keys are device tensors).  Rows that finish mid-chunk stop advancing; the
  host reads the done flags between chunks only;
* **refill**: between chunks, finished slots are harvested and refilled from
  the queue through the one-pass parallel prefill.  The admit program runs
  the prefill on all ``num_slots`` rows (free rows as 1-token dummy primes),
  at a length bucketed to ``window * 2^k``, so a request's prefill shape
  depends on its bucket alone.

Determinism: each request carries its own seed, and its key chain
(``decode/rng.py``, the JAX key chain) lives in its slot's state and
advances only on its own live steps.  A request's tokens depend only on
(parameters, prime, seed, sampling knobs), never on its slot or on what else
is in flight.

EOS convention: primes are served verbatim (no BOS prepend); generation
stops at the first sampled pad/EOS token (id 0) or after
``max_new_tokens``.

**Paged mode** (``paged=True``): the per-slot SGU gate cache, the one
``max_len``-sized buffer, moves into a global page pool
(``decode/paging.py``).  Pages are allocated as positions advance, freed
(refcounted) at completion, and shared between requests with a common
prompt prefix.  Admission is gated by free PAGES as well as free slots; when
the pool runs dry mid-decode, starved slots are PAUSED (position, key and
sequence freeze, and the step drops their cache writes, so the trajectory is
delayed, never altered), and if every live slot is starved the most recently
admitted one is evicted back to the queue head and replayed from scratch.
The decode step contracts the pool through ``ops/cuda_paged_gate_mix.py``:
on the card the hand-written K3 kernel, or K3-q8 under
``quantize="weights+pages"``; on the CPU the plain version, which is
bit-matched to the dense step.

Robustness: every phase runs behind a named fault-injection point
(``serve.submit`` / ``serve.admit`` / ``serve.prefill`` /
``serve.decode_chunk``, ``serve.verify`` under speculation /
``serve.handoff`` / ``serve.harvest`` / ``serve.page_alloc``).  Each
dispatch works on a COPY of the state it mutates and ``self.state`` is
replaced only on success, so a transient fault is contained by re-running
the dispatch; a fatal fault sheds only the requests whose work was lost, as
typed completions (``FAILED_FAULT``), never as exceptions.  Requests carry
optional deadlines (``SHED_DEADLINE``) and admission is bounded
(``max_queue`` -> ``SHED_QUEUE_FULL``).

One deliberate difference from the JAX engine: that one, on a fault in its
Pallas paged kernel, degrades to the gather version and carries on.  Here a
failing K3 launch raises and is treated like any other decode fault (retried
if transient, else the in-flight batch is shed).  Nothing gives way to the
plain version on the card; ``robustness_counters()["fallback_activations"]``
stays in the record and reads 0.

**Speculative decoding** (``spec=True``): a draft model proposes
``spec_k`` tokens a round and the target verifies them (``decode/spec.py``);
every emitted token is sampled from the target's logits with the slot's own
key chain, so the output is token-identical to plain decoding for any
draft.  A chunk is ``max(1, chunk_size // (spec_k + 1))`` rounds.  Without
``draft_params`` and ``draft_config`` the draft is the target itself (the
IDENTITY draft, sharing its possibly quantized weights); ``draft_params`` is
a ``ProGen`` of the draft config (``models/configs.py:draft_config_for``).
The draft's caches are dense per slot, in paged mode too.

**Disaggregated prefill** (``disagg=True``): prefill runs as its own worker
over FIFO batches of up to ``prefill_batch`` requests sharing a bucket and
produces cache handles into a bounded queue of ``handoff_depth``
(``decode/handoff.py``); the decode stage admits by merging handles into
free slots.  ``step()`` runs the decode chunk before the round's prefill,
so in-flight decode does not wait behind a long prefill.  With
``remote_prefill=True`` the engine is a decode replica of the multi-process
fleet (``serve/``): it never runs a prefill round, and handles arrive
through :meth:`ServingEngine.admit_handle` from another process, over the
handoff's wire format (``decode/handoff.py:deserialize_handle``).

The JAX engine's state is a value and its rejected speculative steps are
merged away; here the caches are written in place, so every step that must
leave a row untouched passes ``write_ok`` and the draft proposes on a clone
of its caches.

**Served workloads** (``workloads/``): a LoRA bank (``lora_bank``) gives
every request a ``tenant``, and each decode and prefill row adds its own
tenant's low-rank delta (tenant 0 is the base model, bit for bit); the bank
composes with dense, paged, 8-bit and disaggregated serving, not with
speculation.  ``submit_embed`` queues an embedding request, served after the
decode chunk by the base model's pooled forward (``decode/prefill.py:
make_embedder``) in FIFO batches of one bucket; it takes no slot.
``submit_fork`` is best-of-N off one prime: on a paged engine with the
prefix cache the followers wait until the leader's prefix pages are
published and are admitted as prefix hits.  A ``logit_mask``
(``workloads/infill.py:ScaffoldSpec``) constrains each generated position.

**Operations**: :meth:`ServingEngine.snapshot` writes the unfinished
requests as host-side JSON (the JAX engine's format, so a snapshot crosses
between the packages) and :meth:`ServingEngine.restore` replays them on a
fresh engine from the prime: a trajectory depends only on (weights, prime,
seed, knobs), so the replay is token-identical.  :func:`run_with_restarts`
serves across engine crashes by snapshot, fresh engine, restore.
:meth:`ServingEngine.reload_weights` swaps the served weights (or the LoRA
bank) in place and bumps ``generation``, which every completion carries.  A
``watchdog`` gets a beat per ``step()`` and is paused around each program's
first dispatch (a bucket's first launches, and the kernels' first-use
build).  Every guarded dispatch feeds ``stage_seconds``, the ``engine.*_s``
histograms of the process metrics registry (``observe/metrics.py``) and the
process tracer (``observe/trace.py``: a no-op unless tracing is on); each
``step()`` refreshes the queue, in-flight and cache gauges.
:meth:`ServingEngine.close` releases the engine's device state.

**Warm-up** (:meth:`ServingEngine.aot_warmup`): every program of the
engine's grid (an admit or prefill-worker program per prime bucket, the
merge, the decode chunk, an embedding program per bucket) becomes one
captured CUDA graph (``decode/graphs.py``), and from then on each dispatch
of a warmed program is one replay, as the JAX engine dispatches its
compiled executables.  An engine that is not warmed runs every program
eagerly, as the JAX engine runs its lazy ``jit``.  The program bodies take
device tensors; the host's numpy arguments are staged by the dispatch (a
copy into a warmed program's static buffers, or onto the device for an
eager call), never inside a body.

**Under a mesh** (``mesh``, ``strategies``, ``params_shardings``: the JAX
engine's names; ``parallel/decode.py``) the engine serves a model that
``parallel/sharding.parallelize`` placed, in its training shardings.  There
is one engine per rank, each fed the same requests in lockstep: every rank
holds the same host state (queue, QoS, pages, prefix index) and decodes
every row, so the tokens come out the same on every rank.  Under ``tp`` the
rings hold the rank's heads and the gate caches or the page pool its
channels; K3 and K3-q8 run at the rank's width.  A draft model of its own
stays whole on every rank with whole caches (JAX constrains only the
target's); the identity draft is the target, in its shardings.  int8
weights take their scales from the whole weights before ``parallelize``
gives each rank its part, and a LoRA bank is the rank's part
(``shard_bank``).  ``reload_weights`` under a mesh builds and places a
model of the engine's own.

A decode replica of the fleet may be a tensor-parallel GROUP of processes
(``serve/worker.py``): one engine per member under a ``tensor`` mesh, fed
in lockstep, each admitting its part of every handle
(``decode/handoff.py:deserialize_handle_sharded``).  Every rank's slot
state other than its rank-width caches is a plain tensor of its own, the
same on every rank, so a host read of it (``_host_fetch``) needs no
collective.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import sys
import time
from collections import deque
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from progen_tpu_torch.compat.convert import params_from_flax, params_to_flax
from progen_tpu_torch.core.precision import Policy
from progen_tpu_torch.decode import rng
from progen_tpu_torch.decode.graphs import CapturedProgram, flatten, unflatten
from progen_tpu_torch.decode.handoff import Handle, HandoffQueue
from progen_tpu_torch.decode.incremental import (
    ProGenDecodeStep,
    ProGenPagedDecodeStep,
    copy_caches,
    init_caches,
    init_gate_pool,
    init_gate_scale,
)
from progen_tpu_torch.decode.paging import (
    DUMP_PAGE,
    NULL_PAGE,
    RESERVED_PAGES,
    PagePool,
    SlotPages,
    pages_for_span,
    prefix_key,
)
from progen_tpu_torch.decode.prefill import (
    harvest_caches,
    harvest_gate_pages,
    make_embedder,
    pad_prime_length,
    prime_buckets,
    scatter_gate_rows,
)
from progen_tpu_torch.decode.qos import QoSQueue
from progen_tpu_torch.decode.sampler import (
    gumbel_topk_sample_batched,
    split_keys_batched,
)
from progen_tpu_torch.decode.spec import check_draft_config, spec_round
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe import metrics as _metrics
from progen_tpu_torch.observe import trace as _obs_trace
from progen_tpu_torch.observe.robustness import RobustnessCounters
from progen_tpu_torch.ops.quant import quantize_params
from progen_tpu_torch.parallel import tensor as tensor_parallel
from progen_tpu_torch.parallel.decode import check_placed, decode_mesh, refresh, shard_bank
from progen_tpu_torch.parallel.sharding import full_tensor, load_placed, parallelize
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.retry import RetryError, default_classifier
from progen_tpu_torch.resilience.watchdog import Watchdog
from progen_tpu_torch.workloads.infill import mask_from_wire, mask_to_wire
from progen_tpu_torch.workloads.lora import cast_bank, validate_lora_bank

EOS_ID = 0

# typed Completion.status values: sheds are COMPLETIONS, not exceptions, so
# callbacks and benchmarks see every request exactly once either way
STATUS_OK = "ok"
SHED_QUEUE_FULL = "shed_queue_full"
SHED_DEADLINE = "shed_deadline"
DRAIN_TIMEOUT = "drain_timeout"  # the fleet's drain answered it at its bound
FAILED_FAULT = "failed_fault"

# consecutive rounds a phase may defer (fatal-fault containment) before the
# engine concludes the fault is permanent and gives up
_MAX_DEFER_STREAK = 16

# constructor arguments of the JAX engine whose modes are not ported yet,
# with the ROADMAP.md item that holds each
_NOT_PORTED = {
    "paged_impl": "an impl switch: the port has none, a CUDA tensor always "
                  "takes the hand-written kernel (PERF.md, the dropped degrade path)",
}


class _ContainedFault(Exception):
    """Internal: a phase failed NON-transiently; the caller sheds the
    affected requests per its containment rule.  ``__cause__`` is the
    underlying fault."""

    def __init__(self, point: str):
        super().__init__(f"non-transient fault at {point}")
        self.point = point


@dataclasses.dataclass
class Request:
    """One generation request.

    ``tokens``: the prime, served verbatim; must be non-empty and leave room
    for at least one new token.  ``top_k=None`` disables top-k;
    ``temperature=0`` is greedy.  ``deadline`` is an absolute
    ``time.perf_counter()`` instant, ``ttl`` a budget in seconds from
    ``submit_time`` (``deadline`` wins); past it the request is shed with a
    ``SHED_DEADLINE`` completion, queued requests before they cost a
    prefill, in-flight ones with their partial tokens.  ``logit_mask`` is an
    optional ``(G, V)`` bool array (``G <= max_new_tokens``) constraining
    generated position ``g`` to its true entries.  ``priority`` picks the
    scheduling class (higher is more urgent; a high-priority arrival may
    preempt a lower-priority in-flight request, whose replay is bit-exact).
    ``tenant`` selects a row of the engine's LoRA bank (0 = the base model;
    nonzero needs a ``lora_bank``).  ``workload`` names the request class
    (``"generate"``, ``"infill"``, ``"embed"``); the engine routes by the
    method a request is submitted through, not by this field.
    """

    uid: Any
    tokens: Sequence[int]
    max_new_tokens: int = 128
    top_k: int | None = None
    temperature: float = 1.0
    seed: int = 0
    deadline: float | None = None
    ttl: float | None = None
    on_complete: Callable[["Completion"], None] | None = None
    submit_time: float = dataclasses.field(default_factory=time.perf_counter)
    logit_mask: Any = None
    tenant: int = 0
    priority: int = 0
    workload: str = "generate"


@dataclasses.dataclass
class Completion:
    """A finished request: ``tokens`` is the generated tail only (EOS
    included when the model emitted one).  ``status`` is ``STATUS_OK`` for
    served requests (``finish_reason`` ``"eos"`` or ``"length"``) or a shed
    type, mirrored into ``finish_reason``.  ``first_token_time`` is the
    instant the admission dispatch returned (None for sheds before it and
    for embeddings).  An embedding completion has ``finish_reason
    "embed"``, no tokens and its ``(dim,)`` f32 ``embedding``.
    ``generation`` is the engine's weight generation when the request
    finished (``reload_weights`` bumps it; 0 for a never-reloaded engine)."""

    uid: Any
    prime: np.ndarray
    tokens: np.ndarray
    finish_reason: str
    submit_time: float
    finish_time: float
    status: str = STATUS_OK
    first_token_time: float | None = None
    embedding: np.ndarray | None = None
    generation: int = 0
    # latency on the WORKER's clock (submit to finish inside the remote
    # engine) for a completion of the multi-process fleet; 0.0 for local
    # completions, whose ``latency`` is that number
    worker_latency: float = 0.0

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def ttft(self) -> float | None:
        """Time to first token, or None when it was never produced."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


def _host_fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Device -> host fetch of small per-slot tensors (waits for the device)."""
    return [t.cpu().numpy() for t in tensors]


def _flat_bank(bank: dict) -> dict:
    """A LoRA bank's tensors under ``layer.site.factor`` keys."""
    return {f"{layer}.{site}.{k}": t for layer, sites in bank.items()
            for site, ts in sites.items() for k, t in ts.items()}


def _whole_state(model: ProGen) -> dict:
    """``model``'s state dict with every tensor whole, in the store's
    layout: a placed model's shards gathered (a collective: every rank
    calls it, in one order)."""
    plan = getattr(model, "parallel_plan", None)
    state = model.state_dict()
    if plan is None:
        return state
    with torch.no_grad():
        return {k: full_tensor(v.detach(), plan.pieces(k)) for k, v in state.items()}


def _merge(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` for rows where ``mask``, else ``old``."""
    return torch.where(mask.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)


def _tree_map(fn: Callable, new, old):
    """``fn(new_leaf, old_leaf)`` over two cache trees of one structure
    (dicts and lists of tensors)."""
    if isinstance(new, dict):
        return {k: _tree_map(fn, v, old[k]) for k, v in new.items()}
    if isinstance(new, list):
        return [_tree_map(fn, n, o) for n, o in zip(new, old)]
    return fn(new, old)


def _on_device(tree, device):
    """``tree`` with every numpy array copied onto ``device`` (its tensors
    are there already): the host staging of an eager dispatch."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [torch.as_tensor(a, device=device) for a in leaves])


# the per-row entries of the slot state besides the caches and ``active``
# (and ``tenant``, under a LoRA bank)
_ROW_KEYS = ("seq", "pos", "start", "stop", "done", "keys", "top_k", "temp",
             "lmask")


class ServingEngine:
    """Slot-based continuous-batching engine over a fixed device batch.

    ``model`` is a ``ProGen`` (its device is the engine's), or a
    ``ProGenConfig`` from which one is built on ``device`` with weights
    drawn from ``seed``.  ``num_slots`` is the most concurrent requests;
    ``chunk_size`` the decode steps per dispatch; ``max_len`` the sequence
    budget per slot (prime + generated, at most ``config.seq_len``).

    ``paged=True``: see the module docstring.  ``num_pages`` counts pool
    pages including the 2 reserved ones (default: the full budget, every
    slot can reach ``max_len``).  ``quantize="weights"`` re-types every
    dense weight and SGU spatial weight to int8 (``ops/quant.py``);
    ``"weights+pages"`` also stores the paged gate cache as 8-bit pages.

    ``max_queue`` bounds admission (overflow sheds the incoming request, or
    the oldest of the lowest class under ``shed_policy="shed-oldest"``);
    ``fault_retries`` is the in-place retries per phase for transient faults
    (exhaustion escapes as :class:`RetryError`); ``qos_weights`` maps tenant
    to relative share for the scheduling queue (``decode/qos.py``), which is
    exact FIFO by default.

    ``spec=True`` (``spec_k``, ``draft_config``, ``draft_params``),
    ``disagg=True`` (``prefill_batch``, ``handoff_depth``, and
    ``remote_prefill``, which needs ``disagg``) and ``lora_bank``
    (``workloads/lora.py``; validated, then cast once to the compute dtype
    on the engine's device; under ``quantize`` the base turns int8 and the
    bank stays full precision): see the module docstring.  ``draft_config``
    without ``draft_params`` draws the draft's weights from ``seed``; an
    explicit draft keeps its own weights (full precision unless given
    quantized), the identity draft the target's.

    ``mesh``, ``strategies`` and ``params_shardings`` (the ``ParallelPlan``
    that ``parallelize`` returned): see the module docstring.  A
    ``ProGenConfig`` with a ``mesh`` builds the model and places it here;
    a given model must be placed on ``mesh`` under ``strategies`` already
    (``parallel/decode.py:check_placed``).

    ``watchdog`` (``resilience/watchdog.py``) gets a beat per ``step()`` and
    is paused around the first dispatch of each program (an admit or
    prefill bucket, the decode chunk, the merge, an embed bucket).  The
    port's compile, the kernels' ``nvcc`` build at first use, happens
    inside such a first dispatch: a program that launches a kernel does so
    on its first dispatch.  :meth:`aot_warmup` captures the grid ahead of
    serving instead (and counts as those first dispatches).
    """

    def __init__(self, model: ProGen | ProGenConfig, *,
                 policy: Policy | None = None, device=None, seed: int = 0,
                 num_slots: int = 8, chunk_size: int = 32,
                 max_len: int | None = None, paged: bool = False,
                 page_size: int = 16, num_pages: int | None = None,
                 prefix_cache: bool = True, max_queue: int | None = None,
                 shed_policy: str = "reject", fault_retries: int = 3,
                 qos_weights: dict | None = None, quantize: str | None = None,
                 spec: bool = False, spec_k: int = 4,
                 draft_config: ProGenConfig | None = None,
                 draft_params: ProGen | None = None, disagg: bool = False,
                 prefill_batch: int | None = None, handoff_depth: int = 2,
                 remote_prefill: bool = False,
                 lora_bank: dict | None = None, watchdog: Watchdog | None = None,
                 mesh=None, strategies=("dp",), params_shardings=None,
                 **not_ported):
        if spec and lora_bank is not None:
            # the draft and commit steps carry no tenant state (as in JAX)
            raise ValueError("lora_bank does not compose with spec=True")
        for name in not_ported:
            if name not in _NOT_PORTED:
                raise TypeError(f"ServingEngine got an unexpected argument {name!r}")
            raise NotImplementedError(
                f"ServingEngine({name}=...): the port does not have "
                f"{_NOT_PORTED[name]}")
        # whether the served model is the engine's own (built here, or the
        # int8 copy under ``quantize``): reload_weights writes only into one
        self._owns_model = isinstance(model, ProGenConfig)
        if isinstance(model, ProGenConfig):
            model = ProGen(model, policy, device=device, seed=seed)
            if mesh is not None:
                parallelize(model, mesh, strategies)
        check_placed(model, mesh, strategies, params_shardings)
        model = model.eval()
        self.config = config = model.config
        self.policy = model.policy
        self.device = model.device
        self.num_slots = num_slots
        self.chunk_size = chunk_size
        self.max_len = min(max_len or config.seq_len, config.seq_len)
        self._queue = QoSQueue(weights=qos_weights)
        self.qos_weights = dict(qos_weights or {})
        self._inflight: dict[int, Request] = {}  # slot -> request
        self._ttft: dict[Any, float] = {}
        # admission recency (slot -> monotone seq): preemption and
        # pool-starvation eviction take the youngest first
        self._admit_seq = 0
        self._admit_order: dict[int, int] = {}
        self.completions: list[Completion] = []
        self.chunks_run = 0
        if shed_policy not in ("reject", "shed-oldest"):
            raise ValueError(f"shed_policy {shed_policy!r}: want 'reject' "
                             f"or 'shed-oldest'")
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.fault_retries = fault_retries
        self._watchdog = watchdog
        # program keys whose first dispatch has run (the watchdog is paused
        # around each key's first one)
        self._compiled_keys: set[tuple] = set()
        # warmed programs by key (aot_warmup): each dispatch is one replay
        self._aot: dict[tuple, CapturedProgram] = {}
        self.robust = RobustnessCounters()
        self._pending: list[Completion] = []   # sheds awaiting step() return
        self._draining = False
        self._defer_streak: dict[str, int] = {}
        # dispatch wall per stage: the host's time in the guarded call.  The
        # device may still be running when a decode chunk's dispatch returns;
        # the harvest that follows waits for it.  embed_s includes the fetch
        # of the vectors, so it holds the device's time too.
        self.stage_seconds = {"prefill_s": 0.0, "merge_s": 0.0,
                              "decode_chunk_s": 0.0, "embed_s": 0.0}
        # the same deltas feed the process tracer (no-op unless enabled)
        # and the process metrics registry's per-stage histograms
        self._tracer = _obs_trace.get_tracer()
        registry = _metrics.get_registry()
        self._stage_hist = {stage: registry.histogram(f"engine.{stage}")
                            for stage in self.stage_seconds}
        self._qos_gauge_keys: set = set()
        # weight generation: bumped by reload_weights(); completions carry
        # the generation current when they finish
        self.generation = 0
        # best-of-N forks (submit_fork): leader uid -> held followers
        self._fork_wait: dict[Any, list[Request]] = {}
        self.fork_groups = 0

        if quantize not in (None, "weights", "weights+pages"):
            raise ValueError(f"quantize {quantize!r}: want None, "
                             f"'weights' or 'weights+pages'")
        if quantize == "weights+pages" and not paged:
            raise ValueError("quantize='weights+pages' requires paged=True "
                             "(the 8-bit gate format is a page format)")
        self.quantize = quantize
        self.gate_dtype = "int8" if quantize == "weights+pages" else "bf16"
        # reload_weights() takes weights in the layout the engine was given
        # (full precision, quantized at the door under ``quantize``)
        self._weights_spec = {k: (tuple(v.shape), v.dtype)
                              for k, v in model.state_dict().items()}
        self._requantize = bool(quantize) and model.weights != "int8"
        if self._requantize:
            model = self._quantize_variables(model)
            self._owns_model = True
        self.model = model
        self.mesh = mesh  # the DeviceMesh the model is placed on (None: unmeshed)
        self._rows = torch.arange(num_slots, device=self.device)
        # decode's view of the mesh (None without one): the rank's heads and
        # channels (``_tensor`` of them) and the tensor group
        self._view = decode_mesh(model)
        self._tensor, self._group = tensor_parallel.tensor_split(self._view)

        self.lora = lora_bank is not None
        self._bank = None
        self.num_tenants = 1
        self._row_keys = _ROW_KEYS
        if self.lora:
            self.num_tenants = validate_lora_bank(config, lora_bank)
            bank = cast_bank(lora_bank, self.policy.compute_dtype, self.device)
            self._bank_spec = {k: (tuple(t.shape), t.dtype) for k, t in _flat_bank(bank).items()}
            self._bank = shard_bank(bank, self._view)
            self._row_keys = _ROW_KEYS + ("tenant",)
        # embeddings: a request class of its own, served by the base model's
        # pooled forward in batches of up to num_slots rows; no slot taken
        self._embed_queue: deque[Request] = deque()
        self.embed_batch = num_slots

        self.spec = spec
        self.draft_whole = False
        if spec:
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            self.spec_k = int(spec_k)
            self._draft = self._draft_model(draft_config, draft_params, seed)
            self.draft_config = self._draft.config
            check_draft_config(config, self.draft_config)
            # the draft's view of the mesh: the target's for the identity
            # draft, none for a draft of its own (whole on every rank)
            self._draft_view = self._view if self._draft is self.model else None
            # a draft of its own keeps whole caches on every rank (what a
            # replica group's member rebuilds from its slabs)
            self.draft_whole = self._draft_view is None
            self._draft_step = ProGenDecodeStep(self._draft, self._draft_view)
            # rounds per chunk: a fully-accepted round advances k + 1
            # positions, so the chunk's budget is kept in emitted tokens
            self._spec_rounds = max(1, chunk_size // (self.spec_k + 1))
            self._max_advance = self._spec_rounds * (self.spec_k + 1)
            # summed on the device; spec_counters() fetches them once
            self._spec_emitted = torch.zeros((), dtype=torch.long, device=self.device)
            self._spec_verify_rounds = torch.zeros((), dtype=torch.long,
                                                   device=self.device)
            self._spec_slot_rounds = torch.zeros((), dtype=torch.long,
                                                 device=self.device)
        else:
            self._max_advance = chunk_size

        self.paged = paged
        if paged:
            self.page_size = page_size
            self.pages_per_row = -(-self.max_len // page_size)
            if num_pages is None:
                num_pages = RESERVED_PAGES + num_slots * self.pages_per_row
            self._pool = PagePool(num_pages, page_size,
                                  prefix_caching=prefix_cache,
                                  gate_dtype=self.gate_dtype)
            self._slot_pages: dict[int, SlotPages] = {}
            self._page_table = np.zeros((num_slots, self.pages_per_row), np.int32)
            self._paused = np.zeros((num_slots,), bool)
            self._host_stop = np.zeros((num_slots,), np.int64)
            self.evictions = 0
            self.pause_events = 0
            self.prefix_hits = 0
            self.prefix_lookups = 0
            self._decode_chunk = (self._decode_chunk_spec_paged_impl if spec
                                  else self._decode_chunk_paged_impl)
            self._admit = self._admit_paged_impl
        else:
            self._decode_chunk = (self._decode_chunk_spec_impl if spec
                                  else self._decode_chunk_impl)
            self._admit = self._admit_impl
        self._bind_model(model, self._view)
        if remote_prefill and not disagg:
            raise ValueError("remote_prefill requires disagg=True")
        self.remote_prefill = remote_prefill
        self.disagg = disagg
        if disagg:
            self.prefill_batch = max(1, min(prefill_batch or num_slots, num_slots))
            self._handoff = HandoffQueue(handoff_depth)
            self._prefill_worker = self._prefill_worker_impl
            self._merge = self._merge_impl
        else:
            self._handoff = None
        self.state = self._init_state()

    def _bind_model(self, model: ProGen, view) -> None:
        """Serve ``model``: the decode step and the embedding program run
        it (the admit programs and the prefill worker read ``self.model``);
        under a mesh, in decode's ``view`` of it (``decode_mesh``)."""
        self.model = model
        self._view = view
        self._step_model = (ProGenPagedDecodeStep(model, n_rows=self.max_len,
                                                  gate_dtype=self.gate_dtype,
                                                  mesh=self._view)
                            if self.paged else ProGenDecodeStep(model, self._view))
        self._embedder = make_embedder(model, self._view)

    def _own_copy(self, state: dict) -> ProGen:
        """A model of the engine's own with the whole weights ``state``
        (the store's layout): a copy of the served one, or under a mesh a
        model placed on it as the served one is (int8 buffers loaded whole
        before ``parallelize`` gives each rank its part)."""
        if self._view is None:
            own = copy.deepcopy(self.model)
            with torch.no_grad():
                own.load_state_dict(state)
            return own
        plan = self.model.parallel_plan
        own = ProGen(self.config, self.policy, device=self.device,
                     weights=self.model.weights)
        own.load_state_dict(state)
        parallelize(own, plan.mesh, plan.strategies)
        return own.eval()

    def _draft_model(self, draft_config, draft_params, seed: int) -> ProGen:
        """The speculative draft: the target itself when neither argument
        is given, a model of ``draft_config`` with weights drawn from
        ``seed``, or the given ``draft_params`` model."""
        if draft_params is None:
            if draft_config is None:
                return self.model  # the identity draft
            return ProGen(draft_config, self.policy, device=self.device,
                          seed=seed).eval()
        if draft_config is not None and draft_config != draft_params.config:
            raise ValueError("draft_config differs from draft_params.config")
        if draft_params.device != self.device:
            raise ValueError(f"the draft is on {draft_params.device}, the "
                             f"target on {self.device}")
        if draft_params.policy.compute_dtype != self.policy.compute_dtype:
            raise ValueError("the draft must compute in the target's dtype "
                             "(the engine keeps its caches)")
        return draft_params.eval()

    # ---------------------------------------------------------------- state

    def _init_state(self) -> dict:
        s, L, dev = self.num_slots, self.max_len, self.device
        caches = init_caches(self.config, s, self.policy, decode_len=L,
                             device=dev, with_sgu=not self.paged, tensor=self._tensor)
        if self.paged:
            caches.pop("sgu_gate")
            caches["sgu_pool"] = init_gate_pool(
                self.config, self._pool.num_pages, self.page_size, self.policy,
                gate_dtype=self.gate_dtype, device=dev, tensor=self._tensor)
            if self.gate_dtype == "int8":
                caches["sgu_pool_scale"] = init_gate_scale(
                    self.config, self._pool.num_pages, self.page_size, device=dev)
        zeros = lambda dtype: torch.zeros(s, dtype=dtype, device=dev)
        # token ids and positions are int32, as the JAX engine holds them
        # (the serving plan prices 4 bytes a position)
        state = {
            "seq": torch.zeros(s, L, dtype=torch.int32, device=dev),
            "caches": caches,
            "pos": zeros(torch.int32),      # index of the newest token
            "start": zeros(torch.int32),    # prime length
            "stop": zeros(torch.int32),     # start + max_new (<= L)
            "active": zeros(torch.bool),
            "done": zeros(torch.bool),
            "keys": rng.key(zeros(torch.long)),  # raw key data (S, 2)
            "top_k": zeros(torch.int32),    # 0 = disabled
            "temp": torch.ones(s, dtype=torch.float32, device=dev),
            # per-slot logit mask indexed by WRITE position; all-true rows
            # are bit-identical to no masking at all
            "lmask": torch.ones(s, L, self.config.num_tokens, dtype=torch.bool,
                                device=dev),
        }
        if self.lora:
            state["tenant"] = zeros(torch.long)  # the row's bank row
        if self.spec:
            # the draft's caches stay DENSE per slot, paged mode included:
            # the draft is small, paging it would buy nothing
            state["draft_caches"] = init_caches(
                self.draft_config, s, self.policy, decode_len=L, device=dev,
                tensor=self._tensor if self._draft_view is not None else 1)
        return state

    @staticmethod
    def _working_copy(state: dict) -> dict:
        """A state whose in-place updates leave ``state`` untouched: the
        buffers a decode chunk writes into are copied, the rest is shared
        (the chunk replaces those entries, it never writes into them)."""
        out = {**state, "seq": state["seq"].clone(),
               "caches": copy_caches(state["caches"])}
        if "draft_caches" in state:
            out["draft_caches"] = copy_caches(state["draft_caches"])
        return out

    def _set_inactive(self, slots) -> None:
        act = self.state["active"].clone()
        act[list(slots)] = False
        self.state = {**self.state, "active": act}

    # ------------------------------------------------------ fault containment

    def _note_stage(self, stage: str, span: str, t0: float, **args) -> None:
        """Fold one guarded dispatch into every observability surface at
        once: ``stage_seconds``, the registry's ``engine.<stage>``
        histogram and the trace ring (a no-op unless tracing is on)."""
        dt = time.perf_counter() - t0
        self.stage_seconds[stage] += dt
        self._stage_hist[stage].observe(dt)
        self._tracer.add(span, t0, dt, **args)

    def _guard(self, point: str, fn: Callable | None = None, *args,
               key: tuple | None = None):
        """Run ``faults.inject(point)`` + ``fn(*args)`` with transient
        faults retried in place (no backoff: the retried work is an
        in-process dispatch on a copy of the state, so re-running it is safe
        and deterministic).  Non-transient faults raise
        :class:`_ContainedFault` for the caller's shed rule; transient
        exhaustion raises :class:`RetryError`.  ``key`` names the program
        ``fn`` dispatches: its first dispatch pauses the watchdog."""
        last: BaseException | None = None
        attempts = max(0, self.fault_retries) + 1
        for attempt in range(attempts):
            try:
                faults.inject(point)
                if fn is None:
                    out = None
                elif (self._watchdog is not None and key is not None
                        and key not in self._compiled_keys):
                    with self._watchdog.paused():
                        out = fn(*args)
                else:
                    out = fn(*args)
                if key is not None:
                    self._compiled_keys.add(key)
                if attempt:
                    self.robust.faults_contained += attempt
                return out
            except Exception as e:
                if not default_classifier(e):
                    raise _ContainedFault(point) from e
                last = e
        raise RetryError(
            f"{point}: transient fault persisted through {attempts} attempt(s)",
            attempts=attempts, elapsed=0.0) from last

    def _defer(self, phase: str, cause: BaseException) -> None:
        """Record one deferred round of ``phase`` (skip the phase this step,
        retry next step).  A streak past ``_MAX_DEFER_STREAK`` means the
        fault is permanent: give up loudly instead of spinning."""
        streak = self._defer_streak.get(phase, 0) + 1
        self._defer_streak[phase] = streak
        if streak > _MAX_DEFER_STREAK:
            raise RuntimeError(
                f"serve.{phase} failed {streak} consecutive rounds: the "
                f"fault is not transient and not shedding") from cause

    def _dispatch(self, key: tuple, body: Callable, *args):
        """Run program ``key``: its captured program once warmed (the
        arguments copied into its static buffers), else ``body`` eagerly on
        the arguments staged onto the device."""
        program = self._aot.get(key)
        if program is not None:
            return program(*args)
        return body(*_on_device(args, self.device))

    def _admit_call(self, *args):
        return self._dispatch(("admit", args[0].shape[1]), self._admit,
                              self.state, *args)

    def _chunk_call(self, *args):
        return self._dispatch(("chunk",), self._decode_chunk, self.state, *args)

    @staticmethod
    def _quantize_state(state: dict) -> dict:
        """The int8 serving state dict of a full-precision ``ProGen`` state
        dict: dense weights and SGU spatial weights become int8 with f32
        scales (``ops/quant.py:quantize_params`` on the flax-layout tree),
        the rest is carried over."""
        tree = params_to_flax(state)

        def tensors(node):
            return {k: tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
                    for k, v in node.items()}

        qtree, scales = quantize_params(tensors(tree))
        return params_from_flax({"params": qtree, "qscale": scales})

    @classmethod
    def _quantize_variables(cls, model: ProGen) -> ProGen:
        """The int8 serving model of a full-precision ``model``: under a
        mesh the scales come from the whole weights (gathered on every
        rank), and the int8 model is placed as ``model`` is."""
        quantized = ProGen(model.config, model.policy, device=model.device,
                           weights="int8")
        quantized.load_state_dict(cls._quantize_state(_whole_state(model)))
        plan = getattr(model, "parallel_plan", None)
        if plan is not None:
            parallelize(quantized, plan.mesh, plan.strategies)
        return quantized.eval()

    # ------------------------------------------------------------- decoding

    def _advance(self, st: dict, live: torch.Tensor, logits: torch.Tensor):
        """Sample each row's next token from ``logits`` and advance the live
        rows of ``st`` one position (the shared tail of every chunk body).
        Returns ``(nxt, done_now)``: the sampled tokens, and the live rows
        whose stop rule fired at this step."""
        rows, pos = self._rows, st["pos"]
        kd, sub = split_keys_batched(st["keys"])
        writepos = (pos + 1).clamp(0, self.max_len - 1)
        # the logit-mask row for the position this step WRITES
        mrow = st["lmask"][rows, writepos]
        nxt = gumbel_topk_sample_batched(sub, logits, st["top_k"], st["temp"],
                                         mask=mrow)
        val = torch.where(live, nxt.int(), st["seq"][rows, writepos])
        st["seq"][rows, writepos] = val
        new_pos = torch.where(live, pos + 1, pos)
        done_now = live & ((val == EOS_ID) | (new_pos + 1 >= st["stop"]))
        st["done"] = st["done"] | done_now
        # a slot's key advances only on its own live steps, so a request's
        # trajectory is independent of its neighbours (and of pauses)
        st["keys"] = torch.where(live[:, None], kd, st["keys"])
        st["pos"] = new_pos
        return nxt, done_now

    @torch.no_grad()
    def _decode_chunk_impl(self, state: dict) -> dict:
        st = self._working_copy(state)
        for _ in range(self.chunk_size):
            live = st["active"] & ~st["done"]
            tok = st["seq"][self._rows, st["pos"]]
            logits, _ = self._step_model(tok, st["pos"], st["caches"],
                                         adapters=self._bank,
                                         tenant=st.get("tenant"))
            self._advance(st, live, logits)
        return st

    def _prefill_rows(self, tokens, lengths, stops, seeds, top_k, temp, tenant,
                      lmask, with_sgu: bool):
        """One parallel forward of ``tokens (S, P_pad)`` (and of the draft's,
        under speculation) and each row's decode state, with no slot state
        in scope: the shared body of both admit programs and the prefill
        worker.  Returns ``(rows, sown)``: ``rows`` holds the ``_ROW_KEYS``
        entries, the harvested ``caches`` (rings, carries and, with
        ``with_sgu``, the dense gate rows) and, under speculation, the
        draft's ``draft_caches``; ``sown`` the target forward's
        intermediates.  ``tenant`` is read under a LoRA bank only.  The
        arguments are device tensors of the host arrays' dtypes
        (``_admit_arrays``)."""
        dev, L = self.device, self.max_len
        tokens, lengths, stops = tokens.long(), lengths.long(), stops.int()
        seeds, top_k, temp = seeds.long(), top_k.int(), temp.float()
        rows = self._rows

        tenant = tenant.long() if self.lora else None
        logits, sown = self.model(tokens, return_cache=True, adapters=self._bank,
                                  tenant=tenant, mesh=self._view)
        caches = harvest_caches(self.config, sown, lengths, self.policy, L,
                                with_sgu=with_sgu)
        last = logits[rows, lengths - 1].float()
        split = rng.split(rng.key(seeds))
        # the first generated token writes at position ``lengths``: its mask
        # row applies here, not in the decode chunk
        first = gumbel_topk_sample_batched(split[:, 1], last, top_k, temp,
                                           mask=lmask[rows, lengths])
        p_pad = tokens.shape[1]
        # p_pad is window-aligned and may overshoot L; real tokens never do
        # (submit enforces prime + 1 <= max_len), so the cut drops pad only
        tok_L = tokens[:, :L] if p_pad >= L else F.pad(tokens, (0, L - p_pad))
        seq = (tok_L * (torch.arange(L, device=dev)[None, :] < lengths[:, None])).int()
        seq[rows, lengths] = first.int()
        lengths = lengths.int()
        out = {"seq": seq, "caches": caches, "pos": lengths, "start": lengths,
               "stop": stops, "done": (first == EOS_ID) | (lengths + 1 >= stops),
               "keys": split[:, 0], "top_k": top_k, "temp": temp, "lmask": lmask}
        if self.lora:
            out["tenant"] = tenant
        if self.spec:
            # one padded prime batch primes both models (they share the
            # window, so the bucket suits both); the draft's gate rows stay
            # dense
            _, dsown = self._draft(tokens, return_cache=True, mesh=self._draft_view)
            out["draft_caches"] = harvest_caches(self.draft_config, dsown,
                                                 lengths, self.policy, L)
        return out, sown

    def _merge_rows(self, state: dict, rows: dict, mask: torch.Tensor,
                    take: Callable) -> dict:
        """The slot state with the rows where ``mask`` taken from ``rows``
        (``take(new, old)`` picks per leaf) and marked active; the target's
        caches are left to the caller."""
        out = {k: take(rows[k], state[k]) for k in self._row_keys}
        out["active"] = state["active"] | mask
        if self.spec:
            out["draft_caches"] = _tree_map(take, rows["draft_caches"],
                                            state["draft_caches"])
        return out

    @torch.no_grad()
    def _admit_impl(self, state, tokens, lengths, stops, seeds, top_k, temp,
                    tenant, mask, lmask) -> dict:
        """Prefill ``tokens (S, P_pad)`` in one parallel forward and merge
        the rows where ``mask`` into ``state`` (rows outside ``mask`` carry
        dummy primes and are discarded).  ``lmask (S, L, V)`` is each row's
        logit mask indexed by write position; ``tenant (S,)`` each row's
        bank row (read under a LoRA bank only)."""
        rows, _ = self._prefill_rows(tokens, lengths, stops, seeds, top_k, temp,
                                     tenant, lmask, with_sgu=True)
        take = lambda new, old: _merge(mask, new, old)
        return {**self._merge_rows(state, rows, mask, take),
                "caches": _tree_map(take, rows["caches"], state["caches"])}

    # -------------------------------------------------------- paged decoding

    _RING_KEYS = ("attn_prev", "ff_prev", "k", "v")

    @torch.no_grad()
    def _decode_chunk_paged_impl(self, state: dict, table, paused) -> dict:
        """Paged twin of ``_decode_chunk_impl``: the page ``table`` and the
        ``paused`` mask ride in as data.  Paused rows run the step but are
        fully masked: sequence, position and key freeze, and the step drops
        their pool, ring and carry writes (``write_ok``)."""
        st = self._working_copy(state)
        for _ in range(self.chunk_size):
            live = st["active"] & ~st["done"] & ~paused
            tok = st["seq"][self._rows, st["pos"]]
            logits, _ = self._step_model(tok, st["pos"], st["caches"], table, live,
                                         self._bank, st.get("tenant"))
            self._advance(st, live, logits)
        return st

    @torch.no_grad()
    def _admit_paged_impl(self, state, tokens, lengths, stops, seeds, top_k,
                          temp, tenant, mask, lmask, wtable) -> dict:
        """Paged twin of ``_admit_impl``: rings and carries harvest and merge
        as in the dense path, but gate rows scatter straight into the page
        pool through the WRITE table (``wtable``: private pages only;
        prefix-shared and dummy rows go to the dump page)."""
        rows, sown = self._prefill_rows(tokens, lengths, stops, seeds, top_k,
                                        temp, tenant, lmask, with_sgu=False)
        take = lambda new, old: _merge(mask, new, old)
        old = state["caches"]
        if self.gate_dtype == "int8":
            pool_new, scale_new = harvest_gate_pages(
                self.config, sown, rows["pos"], old["sgu_pool"], wtable,
                self.policy, pool_scale=old["sgu_pool_scale"], group=self._group)
            pools = {"sgu_pool": pool_new, "sgu_pool_scale": scale_new}
        else:
            pools = {"sgu_pool": harvest_gate_pages(
                self.config, sown, rows["pos"], old["sgu_pool"], wtable,
                self.policy)}
        rings = {k: _tree_map(take, rows["caches"][k], old[k])
                 for k in self._RING_KEYS}
        return {**self._merge_rows(state, rows, mask, take),
                "caches": {**rings, **pools}}

    # --------------------------------------------------- speculative decoding

    def _spec_chunk(self, st: dict, target_step: Callable, paused=None) -> dict:
        """``_spec_rounds`` speculative rounds over the working state ``st``
        (``decode/spec.py``); returns the emitted tokens, the rounds in
        which some slot was live and the live slots over the rounds, summed
        on the device."""
        def draft_step(tok, pos, dc, live):
            return self._draft_step(tok, pos, dc, live)[0]

        emitted = torch.zeros((), dtype=torch.long, device=self.device)
        rounds = torch.zeros((), dtype=torch.long, device=self.device)
        slot_rounds = torch.zeros((), dtype=torch.long, device=self.device)
        for _ in range(self._spec_rounds):
            live0 = st["active"] & ~st["done"]
            if paused is not None:
                live0 = live0 & ~paused
            em = spec_round(st, spec_k=self.spec_k, max_len=self.max_len,
                            target_step=target_step, draft_step=draft_step,
                            advance=self._advance, live0=live0)
            emitted = emitted + em.sum()
            rounds = rounds + live0.any().long()
            slot_rounds = slot_rounds + live0.sum()
        return {"emitted": emitted, "rounds": rounds, "slot_rounds": slot_rounds}

    @torch.no_grad()
    def _decode_chunk_spec_impl(self, state: dict):
        """Speculative twin of ``_decode_chunk_impl``: the chunk is
        ``_spec_rounds`` propose/verify/commit rounds in place of
        ``chunk_size`` single-token target steps.  A verify step that is not
        live writes nothing (``write_ok``), where the JAX chunk merges the
        old caches back.  Returns ``(state, stats)``."""
        st = self._working_copy(state)

        def target_step(tok, pos, caches, live):
            return self._step_model(tok, pos, caches, live)[0]

        return st, self._spec_chunk(st, target_step)

    @torch.no_grad()
    def _decode_chunk_spec_paged_impl(self, state: dict, table, paused):
        """Speculative + paged: every write of a verify step, pool rows
        included, is masked inside the step (``write_ok=live``)."""
        st = self._working_copy(state)

        def target_step(tok, pos, caches, live):
            return self._step_model(tok, pos, caches, table, live)[0]

        return st, self._spec_chunk(st, target_step, paused)

    # ------------------------------------------------- disaggregated serving

    @torch.no_grad()
    def _prefill_worker_impl(self, tokens, lengths, stops, seeds, top_k, temp,
                             tenant, lmask) -> dict:
        """Prefill stage of disaggregated serving: the admit programs' math
        with NO slot state in scope; the product is a handle's state of
        ``(num_slots, ...)`` slabs the merge later gathers into slots.  Gate
        rows stay dense here even in paged mode (the worker cannot know
        which pool pages they will land in; the merge scatters them through
        a row-indexed write table).  Under a LoRA bank the handle carries
        each row's ``tenant``, so the decode side gathers the right
        factors."""
        rows, _ = self._prefill_rows(tokens, lengths, stops, seeds, top_k, temp,
                                     tenant, lmask, with_sgu=True)
        return rows

    @torch.no_grad()
    def _merge_impl(self, state: dict, hstate: dict, src, mask,
                    row_wtable=None) -> dict:
        """Decode-side half of the handoff: gather handle rows into slot
        state.  ``src (S,)`` gives each slot its handle row (any value where
        ``mask`` is false), ``mask (S,)`` the slots being admitted.  A
        gather by a host-inverted mapping, not a scatter of handle rows: no
        duplicate-index hazard, and dead rows vanish for free.  The handle
        is only read, never cloned: its tensors are the sources of the
        gather and are released with the handle once the merge has landed
        (the counterpart of the JAX merge's donation).  In paged mode the
        handle's dense gate slabs scatter into the pool through
        ``row_wtable (S, ppr)``, a handle-ROW-indexed write table (DUMP for
        unused rows), quantized there under 8-bit pages."""
        src = src.long().clamp(0, self.num_slots - 1)
        take = lambda h, old: _merge(mask, h.index_select(0, src), old)
        h_caches, old = hstate["caches"], state["caches"]
        if self.paged:
            gates = h_caches["sgu_gate"]
            if self.gate_dtype == "int8":
                pool, scale = scatter_gate_rows(
                    self.config, gates, hstate["start"], old["sgu_pool"],
                    row_wtable, pool_scale=old["sgu_pool_scale"], group=self._group)
                pools = {"sgu_pool": pool, "sgu_pool_scale": scale}
            else:
                pools = {"sgu_pool": scatter_gate_rows(
                    self.config, gates, hstate["start"], old["sgu_pool"],
                    row_wtable)}
            caches = {**{k: _tree_map(take, h_caches[k], old[k])
                         for k in self._RING_KEYS}, **pools}
        else:
            caches = _tree_map(take, h_caches, old)
        return {**self._merge_rows(state, hstate, mask, take), "caches": caches}

    def _prefill_worker_call(self, *args):
        return self._dispatch(("prefill", args[0].shape[1]), self._prefill_worker,
                              *args)

    def _merge_call(self, hstate, *args):
        return self._dispatch(("merge",), self._merge, self.state, hstate, *args)

    # ----------------------------------------------------------------- API

    def submit(self, request: Request) -> None:
        """Queue a request.  Structural errors (empty prime, no room to
        generate) raise: they are caller bugs.  OPERATIONAL conditions
        (injected faults, expired deadline, full queue) shed the request as
        a typed completion instead."""
        n = len(request.tokens)
        if n < 1:
            raise ValueError(f"request {request.uid!r}: empty prime")
        if n + 1 > self.max_len:
            raise ValueError(
                f"request {request.uid!r}: prime length {n} leaves no room "
                f"for generation (max_len {self.max_len})")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.uid!r}: max_new_tokens must be >= 1")
        if request.logit_mask is not None:
            m = np.asarray(request.logit_mask, bool)
            if m.ndim != 2 or m.shape[1] != self.config.num_tokens:
                raise ValueError(
                    f"request {request.uid!r}: logit_mask must be "
                    f"(G, {self.config.num_tokens}), got {m.shape}")
            if m.shape[0] > request.max_new_tokens:
                raise ValueError(
                    f"request {request.uid!r}: logit_mask has {m.shape[0]} "
                    f"rows but max_new_tokens={request.max_new_tokens}")
            if n + m.shape[0] > self.max_len:
                raise ValueError(
                    f"request {request.uid!r}: mask rows run past max_len "
                    f"{self.max_len} (prime {n} + {m.shape[0]} rows)")
            if not m.any(axis=1).all():
                raise ValueError(
                    f"request {request.uid!r}: logit_mask has an all-False "
                    f"row; every constrained position needs >= 1 allowed token")
            request.logit_mask = m
        tenant = int(request.tenant)
        if tenant != 0 and not self.lora:
            raise ValueError(
                f"request {request.uid!r}: tenant={tenant} but the engine "
                f"was built without a lora_bank")
        if not (0 <= tenant < self.num_tenants):
            raise ValueError(
                f"request {request.uid!r}: tenant {tenant} outside the "
                f"bank's [0, {self.num_tenants})")
        if self.paged:
            stop = min(n + request.max_new_tokens, self.max_len)
            worst = pages_for_span(stop - 1, self.page_size)
            if worst > self._pool.capacity:
                raise ValueError(
                    f"request {request.uid!r}: needs up to {worst} pages "
                    f"but the pool only has {self._pool.capacity}; "
                    f"raise num_pages or lower max_new_tokens")
        try:
            self._guard("serve.submit")
        except (_ContainedFault, RetryError):
            self._shed(request, FAILED_FAULT)
            return
        deadline = self._deadline_of(request)
        if deadline is not None and time.perf_counter() > deadline:
            self._shed(request, SHED_DEADLINE)
            return
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            if self.shed_policy == "shed-oldest":
                # drop the LOWEST class (oldest within it); when the
                # newcomer ranks below everything queued, the newcomer is
                # the victim
                victim = self._queue.shed_victim()
                if victim is not None and victim.priority <= request.priority:
                    self._queue.remove(victim)
                    self._shed(victim, SHED_QUEUE_FULL)
                else:
                    self._shed(request, SHED_QUEUE_FULL)
                    return
            else:
                self._shed(request, SHED_QUEUE_FULL)
                return
        self._queue.append(request)
        self._tracer.event("serve.submit", trace=request.uid,
                           queue=len(self._queue))

    def submit_embed(self, request: Request) -> None:
        """Queue an EMBEDDING request: one prefill-shaped forward of the base
        model, its final hidden state mean-pooled, no decode slot taken.
        The shed rules of :meth:`submit`; ``max_new_tokens``, ``top_k``,
        ``temperature`` and ``seed`` are ignored (nothing is sampled)."""
        n = len(request.tokens)
        if n < 1:
            raise ValueError(f"request {request.uid!r}: empty prime")
        if n > self.config.seq_len:
            raise ValueError(
                f"request {request.uid!r}: prime length {n} exceeds "
                f"seq_len {self.config.seq_len}")
        if request.logit_mask is not None:
            raise ValueError(
                f"request {request.uid!r}: embed requests take no "
                f"logit_mask (nothing is sampled)")
        if int(request.tenant) != 0:
            raise ValueError(
                f"request {request.uid!r}: embed requests run the base "
                f"model (tenant must be 0)")
        try:
            self._guard("serve.submit")
        except (_ContainedFault, RetryError):
            self._shed(request, FAILED_FAULT)
            return
        deadline = self._deadline_of(request)
        if deadline is not None and time.perf_counter() > deadline:
            self._shed(request, SHED_DEADLINE)
            return
        if (self.max_queue is not None
                and len(self._embed_queue) >= self.max_queue):
            if self.shed_policy == "shed-oldest":
                self._shed(self._embed_queue.popleft(), SHED_QUEUE_FULL)
            else:
                self._shed(request, SHED_QUEUE_FULL)
                return
        self._embed_queue.append(request)
        self._tracer.event("serve.submit_embed", trace=request.uid,
                           queue=len(self._embed_queue))

    def submit_fork(self, request: Request, n_samples: int) -> list:
        """Best-of-N: fork ``n_samples`` trajectories off one prime.  Fork
        ``k`` is ``request`` with ``uid + k`` and ``seed + k``, so each
        completion equals that request submitted alone.  The caller owns the
        uid space: ``uid .. uid + n - 1`` must be unused.

        On a paged engine with the prefix cache, and a prime of at least one
        page, the leader (fork 0) is submitted now and the followers are
        held until it leaves the queue (admitted, so its prefix pages are
        published, or shed); they are then admitted as prefix-cache hits, so
        N samples hold one copy of the prime's full pages.  Otherwise every
        fork is submitted at once.  Returns the fork uids in order."""
        if n_samples < 1:
            raise ValueError(f"request {request.uid!r}: n_samples must "
                             f"be >= 1, got {n_samples}")
        if not isinstance(request.uid, int):
            raise ValueError(f"request {request.uid!r}: submit_fork "
                             f"derives fork uids by offset; uid must "
                             f"be an int")
        forks = [dataclasses.replace(request, uid=request.uid + k,
                                     seed=request.seed + k)
                 for k in range(n_samples)]
        self.fork_groups += 1
        share = (self.paged and self._pool.prefix_caching and n_samples > 1
                 and len(request.tokens) >= self.page_size)
        self.submit(forks[0])
        if share:
            self._fork_wait[forks[0].uid] = forks[1:]
        else:
            for f in forks[1:]:
                self.submit(f)
        self._tracer.event("serve.submit_fork", trace=request.uid,
                           n_samples=n_samples)
        return [f.uid for f in forks]

    def forget_ttft(self, uids) -> None:
        """Drop the first-token stamps of requests that leave this engine
        for another (a prefill-only caller hands off and never harvests),
        so the stamp map cannot grow without bound."""
        for u in uids:
            self._ttft.pop(u, None)

    def _release_forks(self) -> None:
        """Submit the held followers of every leader that has left the queue
        (its admission committed the prefix registrations, or it was shed
        and the followers go on unshared).  Runs at the top of
        :meth:`step`, so followers land one admission round behind their
        leader."""
        if not self._fork_wait:
            return
        queued = {r.uid for r in self._queue}
        for uid in [u for u in self._fork_wait if u not in queued]:
            for f in self._fork_wait.pop(uid):
                self.submit(f)

    @property
    def pending(self) -> int:
        return (len(self._queue) + len(self._embed_queue)
                + sum(len(v) for v in self._fork_wait.values()))

    @property
    def embed_pending(self) -> int:
        return len(self._embed_queue)

    @property
    def num_active(self) -> int:
        return len(self._inflight)

    @property
    def has_work(self) -> bool:
        """True while anything remains for ``step()`` to do or report."""
        n = (len(self._queue) + len(self._embed_queue) + len(self._inflight)
             + len(self._pending) + sum(len(v) for v in self._fork_wait.values()))
        if self.disagg:
            n += len(self._handoff)
        return n > 0

    # ---------------------------------------------------------- shedding

    @staticmethod
    def _deadline_of(r: Request) -> float | None:
        if r.deadline is not None:
            return r.deadline
        if r.ttl is not None:
            return r.submit_time + r.ttl
        return None

    def _shed(self, r: Request, status: str, tokens=None) -> Completion:
        """Answer ``r`` with a typed shed completion (the callback fires,
        counters bump); ``tokens`` carries any partial generation an
        in-flight deadline cancellation salvaged."""
        if status == SHED_QUEUE_FULL:
            self.robust.sheds_queue_full += 1
        elif status == SHED_DEADLINE:
            self.robust.sheds_deadline += 1
        else:
            self.robust.failed_faults += 1
        comp = Completion(
            uid=r.uid, prime=np.asarray(r.tokens, np.int32),
            tokens=np.asarray([] if tokens is None else tokens, np.int32),
            finish_reason=status, status=status,
            submit_time=r.submit_time, finish_time=time.perf_counter(),
            first_token_time=self._ttft.pop(r.uid, None),
            generation=self.generation)
        self.completions.append(comp)
        self._pending.append(comp)
        self._tracer.event("serve.shed", trace=r.uid, status=status)
        if r.on_complete is not None:
            r.on_complete(comp)
        return comp

    def _drain_pending(self) -> list[Completion]:
        out, self._pending = self._pending, []
        return out

    def _release_slot(self, slot: int) -> None:
        """Host bookkeeping of a slot whose request leaves without a
        harvest (shed, preempted)."""
        if self.paged:
            self._host_stop[slot] = 0
            self._free_slot_pages(slot)
        else:
            self._admit_order.pop(slot, None)

    def _shed_expired(self) -> None:
        """Shed every queued request past its deadline (before it costs a
        prefill) and cancel expired in-flight slots (their partial tokens
        ride along in the shed completion)."""
        now = time.perf_counter()
        for q in (self._queue, self._embed_queue):
            expired_q = [r for r in q
                         if self._deadline_of(r) is not None
                         and now > self._deadline_of(r)]
            for r in expired_q:
                q.remove(r)
                self._shed(r, SHED_DEADLINE)
        slots = [s for s, r in self._inflight.items()
                 if self._deadline_of(r) is not None
                 and now > self._deadline_of(r)]
        if not slots:
            return
        active, seq, pos, start = _host_fetch(
            self.state["active"], self.state["seq"], self.state["pos"],
            self.state["start"])
        for slot in slots:
            r = self._inflight.pop(slot)
            toks = (seq[slot, start[slot]: pos[slot] + 1].copy()
                    if active[slot] else None)
            self._release_slot(slot)
            self._shed(r, SHED_DEADLINE, tokens=toks)
        self._set_inactive(slots)

    # ----------------------------------------------------------- admission

    def _maybe_preempt(self) -> None:
        """Priority preemption: while the scheduler's head is blocked (no
        free slot, or, paged, no pages for its prime) and some in-flight
        request ranks STRICTLY below it, cancel the victim and re-enqueue it
        through the scheduler.  Victim choice: lowest priority class first,
        then most recently admitted.  Replay from scratch is bit-exact, so
        preemption trades only latency, never tokens."""
        while self._queue and self._inflight:
            head = self._queue[0]
            blocked = len(self._inflight) >= self.num_slots
            if not blocked and self.paged:
                need = pages_for_span(len(head.tokens), self.page_size)
                blocked = not self._pool.can_allocate(need)
            if not blocked:
                return
            victim = min(
                self._inflight,
                key=lambda s: (self._inflight[s].priority,
                               -self._admit_order.get(s, 0)))
            if self._inflight[victim].priority >= head.priority:
                return
            self._preempt_slot(victim)

    def _preempt_slot(self, slot: int) -> None:
        """Cancel ``slot``'s in-flight request for a higher class and
        re-enqueue it THROUGH the scheduler: it keeps its queue seniority
        among same-class peers but waits behind the class that displaced it
        (contrast :meth:`_evict_slot`, whose front-of-queue requeue is the
        pool-starvation replay path)."""
        r = self._inflight.pop(slot)
        self._release_slot(slot)
        self._set_inactive([slot])
        self._queue.append(r)
        self.robust.preemptions += 1
        self._tracer.event("serve.preempt", trace=r.uid, slot=slot)

    def _admit_pending(self) -> None:
        if not self._queue:
            return
        self._maybe_preempt()
        if len(self._inflight) >= self.num_slots:
            return
        try:
            self._guard("serve.admit")
        except _ContainedFault:
            # the admission machinery is poisoned for this round: shed the
            # queue head (a permanently faulting point must not starve the
            # whole queue) and defer the rest
            self._shed(self._queue.popleft(), FAILED_FAULT)
            return
        if self.paged:
            self._admit_pending_paged()
        else:
            self._admit_pending_dense()

    def _build_lmask(self, rows: list) -> np.ndarray:
        """``(S, max_len, V)`` write-position-indexed logit masks for the
        rows being admitted (``rows`` pairs a slot with its request).
        Unconstrained rows stay all-True.  Request row ``g`` constrains the
        token written at absolute position ``len(prime) + g``."""
        lmask = np.ones((self.num_slots, self.max_len, self.config.num_tokens),
                        bool)
        for idx, r in rows:
            if r.logit_mask is not None:
                m = np.asarray(r.logit_mask, bool)
                p = len(r.tokens)
                lmask[idx, p: p + m.shape[0]] = m
        return lmask

    def _admit_arrays(self, p_pad: int) -> dict:
        """The admit program's host arguments, all rows as dummies: a
        1-token prime that stops at once and merges nowhere."""
        s = self.num_slots
        return {"tokens": np.zeros((s, p_pad), np.int32),
                "lengths": np.ones((s,), np.int32),
                "stops": np.full((s,), 2, np.int32),
                "seeds": np.zeros((s,), np.int64),  # uint32 values
                "top_k": np.zeros((s,), np.int32),
                "temp": np.ones((s,), np.float32),
                "tenant": np.zeros((s,), np.int32),
                "mask": np.zeros((s,), bool)}

    def _fill_row(self, a: dict, row: int, r: Request) -> None:
        """Row ``row`` of the admit or prefill-worker arguments ``a`` from
        request ``r``."""
        t = np.asarray(r.tokens, np.int32)
        a["tokens"][row, : len(t)] = t
        a["lengths"][row] = len(t)
        a["stops"][row] = min(len(t) + r.max_new_tokens, self.max_len)
        a["seeds"][row] = int(r.seed) & 0xFFFFFFFF
        a["top_k"][row] = 0 if r.top_k is None else int(r.top_k)
        a["temp"][row] = float(r.temperature)
        a["tenant"][row] = int(r.tenant)

    def _fill_admit_row(self, a: dict, slot: int, r: Request) -> None:
        self._fill_row(a, slot, r)
        a["mask"][slot] = True
        self._inflight[slot] = r
        self._admit_order[slot] = self._admit_seq
        self._admit_seq += 1

    def _bucket(self, batch: list) -> int:
        longest = max(len(r.tokens) for _, r in batch)
        return pad_prime_length(longest, self.config.window_size,
                                self.config.seq_len, bucket=True)

    def _admit_pending_dense(self) -> None:
        free = [i for i in range(self.num_slots) if i not in self._inflight]
        if not free or not self._queue:
            return
        batch: list[tuple[int, Request]] = []
        while free and self._queue:
            batch.append((free.pop(0), self._queue.popleft()))
        a = self._admit_arrays(self._bucket(batch))
        for slot, r in batch:
            self._fill_admit_row(a, slot, r)
        lmask = self._build_lmask(batch)

        p_pad = a["tokens"].shape[1]
        t0 = time.perf_counter()
        try:
            self.state = self._guard(
                "serve.prefill", self._admit_call, *a.values(), lmask,
                key=("admit", p_pad))
            self._note_stage("prefill_s", "serve.admit_prefill", t0,
                             uids=[r.uid for _, r in batch], p_pad=p_pad)
        except _ContainedFault:
            # the batch's prefill never merged: undo the bookkeeping and
            # shed exactly the requests whose work was lost
            for slot, r in batch:
                self._inflight.pop(slot, None)
                self._shed(r, FAILED_FAULT)
        except RetryError:
            # leave the engine consistent: the un-prefilled batch goes back
            # to the queue front in its original order
            for slot, r in reversed(batch):
                self._inflight.pop(slot, None)
                self._queue.appendleft(r)
            raise
        else:
            # the admit program samples each request's first token, so
            # admission success IS first-token time; setdefault keeps the
            # earliest stamp across evict/replay round-trips
            now = time.perf_counter()
            for _, r in batch:
                self._ttft.setdefault(r.uid, now)

    def _admit_pending_paged(self) -> None:
        """FIFO admission gated by free slots AND free pages.  The head of
        the queue is admitted only if the pool can cover its whole prime
        plus the first sampled token WITHOUT prefix sharing (a conservative
        bound; the planning below shares whatever it can); a blocked head
        DEFERS everything behind it."""
        free = [i for i in range(self.num_slots) if i not in self._inflight]
        batch: list[tuple[int, Request]] = []
        reserved = 0
        while free and self._queue:
            r = self._queue[0]
            need = pages_for_span(len(r.tokens), self.page_size)
            if not self._pool.can_allocate(reserved + need):
                break  # head-of-line blocks: deferral, not reordering
            reserved += need
            batch.append((free.pop(0), self._queue.popleft()))
        if not batch:
            return

        p_pad = self._bucket(batch)
        a = self._admit_arrays(p_pad)
        wtable = np.full((self.num_slots, self.pages_per_row), DUMP_PAGE, np.int32)
        pending_prefix: list[tuple[tuple, int]] = []
        planned: list[tuple[int, Request]] = []

        def roll_back(upto: int) -> None:
            for slot, _ in reversed(batch[:upto]):
                self._inflight.pop(slot, None)
                self._host_stop[slot] = 0
                self._free_slot_pages(slot)

        try:
            for slot, r in batch:
                self._fill_admit_row(a, slot, r)
                self._host_stop[slot] = a["stops"][slot]
                self._paused[slot] = False
                # planning allocates (and retains shared) pages: guarded at
                # the SAME point as the chunk-growth allocator.  A contained
                # fault mid-batch rolls back every page planned so far and
                # the deferred registrations (pending_prefix dies here)
                self._guard("serve.page_alloc", self._plan_slot_pages,
                            slot, r, p_pad, wtable, pending_prefix)
                planned.append((slot, r))
        except _ContainedFault:
            j = len(planned)
            roll_back(j + 1)
            # innocents (planned before the fault or never reached) go back
            # to the queue front in order; only the request whose planning
            # faulted is shed
            for r in reversed([r for _, r in batch[:j] + batch[j + 1:]]):
                self._queue.appendleft(r)
            self._shed(batch[j][1], FAILED_FAULT)
            return
        except RetryError:
            roll_back(len(planned) + 1)
            for _, r in reversed(batch):
                self._queue.appendleft(r)
            raise
        lmask = self._build_lmask(batch)

        t0 = time.perf_counter()
        try:
            self.state = self._guard(
                "serve.prefill", self._admit_call, *a.values(), lmask, wtable,
                key=("admit", p_pad))
            self._note_stage("prefill_s", "serve.admit_prefill", t0,
                             uids=[r.uid for _, r in batch], p_pad=p_pad)
        except _ContainedFault:
            # prefill never merged: the planned pages hold nothing.  Free
            # them (no prefix registration was committed, so the index
            # cannot serve a garbage page) and shed the batch
            roll_back(len(batch))
            for _, r in batch:
                self._shed(r, FAILED_FAULT)
            return
        except RetryError:
            roll_back(len(batch))
            for _, r in reversed(batch):
                self._queue.appendleft(r)
            raise
        # prefill landed: NOW the freshly filled full-prefix pages may be
        # published for sharing
        for key, pid in pending_prefix:
            self._pool.register_prefix(key, pid)
        now = time.perf_counter()
        for _, r in batch:
            self._ttft.setdefault(r.uid, now)

    # ------------------------------------------- disaggregated admission

    def _prefill_round(self) -> None:
        """Prefill stage of a disaggregated step: run the worker over a FIFO
        prefix of the queue sharing the head's bucket and push the handle.
        A full handoff queue skips the round entirely (backpressure:
        prefilled caches are the expensive thing to hold, so the wait is
        absorbed by the cheap token queue instead)."""
        if not self._queue or self._handoff.full():
            return
        try:
            self._guard("serve.admit")
        except _ContainedFault:
            # the same livelock breaker as inline admission: shed the head
            self._shed(self._queue.popleft(), FAILED_FAULT)
            return
        p_pad = self._bucket([(0, self._queue[0])])
        batch: list[Request] = []
        while (self._queue and len(batch) < self.prefill_batch
               and self._bucket([(0, self._queue[0])]) == p_pad):
            batch.append(self._queue.popleft())
        a = self._admit_arrays(p_pad)
        del a["mask"]
        for row, r in enumerate(batch):
            self._fill_row(a, row, r)
        # handle-ROW-indexed, like every other slab the worker produces
        lmask = self._build_lmask(list(enumerate(batch)))
        t0 = time.perf_counter()
        try:
            h = self._guard("serve.prefill", self._prefill_worker_call,
                            *a.values(), lmask, key=("prefill", p_pad))
            self._note_stage("prefill_s", "serve.prefill", t0,
                             uids=[r.uid for r in batch], p_pad=p_pad)
        except _ContainedFault:
            for r in batch:
                self._shed(r, FAILED_FAULT)
            return
        except RetryError:
            for r in reversed(batch):
                self._queue.appendleft(r)
            raise
        # the worker samples each request's first token, so the handle
        # landing IS first-token time (the merge only moves sampled state)
        now = time.perf_counter()
        for r in batch:
            self._ttft.setdefault(r.uid, now)
        self._handoff.put(Handle(requests=batch, state=h, p_pad=p_pad))

    def _admit_from_handoff(self) -> None:
        """Decode-side admission: move queued handles into free slots
        through the merge.  The head handle DEFERS (never reorders) while
        slots or pages are short, as inline paged admission does."""
        while self._handoff:
            h = self._handoff.peek()
            now = time.perf_counter()
            expired: list[Request] = []
            live_rows: list[tuple[int, Request]] = []
            for row, r in enumerate(h.requests):
                d = self._deadline_of(r)
                if d is not None and now > d:
                    expired.append(r)
                else:
                    live_rows.append((row, r))
            free = [i for i in range(self.num_slots) if i not in self._inflight]
            if len(free) < len(live_rows):
                return
            if self.paged and live_rows:
                need = sum(pages_for_span(len(r.tokens), self.page_size)
                           for _, r in live_rows)
                if not self._pool.can_allocate(need):
                    return
            self._handoff.get()  # the handle peeked above, now committed
            if live_rows:
                self._merge_handle(h, free, live_rows)
            for r in expired:
                self._shed(r, SHED_DEADLINE)

    def _merge_handle(self, h: Handle, free: list, live_rows: list) -> None:
        """Merge ``live_rows`` of handle ``h`` into the ``free`` slots, in
        order.  A contained fault sheds them; a transient one that persists
        requeues the whole handle at the front and escapes."""
        src = np.zeros((self.num_slots,), np.int32)
        mask = np.zeros((self.num_slots,), bool)
        extra: tuple = ()
        pending_prefix: list[tuple[tuple, int]] = []
        placed: list[tuple[int, Request]] = []
        if self.paged:
            # the merge scatters the handle's dense gate slabs through a
            # handle-ROW-indexed write table; the page plan is slot-indexed,
            # so plan into a slot scratch row and copy it across
            row_wtable = np.full((self.num_slots, self.pages_per_row), DUMP_PAGE,
                                 np.int32)
            scratch = np.full_like(row_wtable, DUMP_PAGE)
        for slot, (row, r) in zip(free, live_rows):
            src[slot] = row
            mask[slot] = True
            self._inflight[slot] = r
            self._admit_order[slot] = self._admit_seq
            self._admit_seq += 1
            placed.append((slot, r))
            if self.paged:
                self._host_stop[slot] = min(len(r.tokens) + r.max_new_tokens,
                                            self.max_len)
                self._paused[slot] = False
                self._plan_slot_pages(slot, r, h.p_pad, scratch, pending_prefix)
                row_wtable[row] = scratch[slot]
        if self.paged:
            extra = (row_wtable,)
        t0 = time.perf_counter()
        try:
            self.state = self._guard("serve.handoff", self._merge_call, h.state,
                                     src, mask, *extra, key=("merge",))
            self._note_stage("merge_s", "serve.merge", t0,
                             uids=[r.uid for _, r in live_rows])
        except (_ContainedFault, RetryError) as e:
            for slot, r in placed:
                self._inflight.pop(slot, None)
                self._release_slot(slot)
                if isinstance(e, _ContainedFault):
                    self._shed(r, FAILED_FAULT)
            if isinstance(e, RetryError):
                # the merge only reads the handle, so it replays whole; its
                # expired rows were not shed yet and replay exactly once
                self._handoff.requeue(h)
                raise
            return
        h.state = {}  # its tensors now live on in the slot state only
        for key, pid in pending_prefix:
            self._pool.register_prefix(key, pid)
        merged = time.perf_counter()
        for _, r in live_rows:
            self._ttft.setdefault(r.uid, merged)

    # ---------------------------------------------------------- embeddings

    def _embed_impl(self, tokens, lengths):
        """The embedding program on one padded bucket: the BASE model (int8
        under ``quantize``), no adapters, no sampling, no slot state."""
        return self._embedder(tokens.long(), lengths.long())

    def _embed_call(self, tokens, lengths):
        return self._dispatch(("embed", tokens.shape[1]), self._embed_impl,
                              tokens, lengths)

    def _embed_round(self) -> None:
        """Serve one batch of embedding requests: a FIFO prefix of the embed
        queue sharing the head's prefill bucket, padded to ``embed_batch``
        rows with 1-token dummies, one pooled forward, completions with the
        ``(dim,)`` vector attached."""
        if not self._embed_queue:
            return
        try:
            self._guard("serve.admit")
        except _ContainedFault:
            self._shed(self._embed_queue.popleft(), FAILED_FAULT)
            return
        bucket = lambda r: self._bucket([(0, r)])
        p_pad = bucket(self._embed_queue[0])
        batch: list[Request] = []
        while (self._embed_queue and len(batch) < self.embed_batch
               and bucket(self._embed_queue[0]) == p_pad):
            batch.append(self._embed_queue.popleft())
        tokens = np.zeros((self.embed_batch, p_pad), np.int32)
        lengths = np.ones((self.embed_batch,), np.int32)  # dummy rows
        for row, r in enumerate(batch):
            tokens[row, : len(r.tokens)] = np.asarray(r.tokens, np.int32)
            lengths[row] = len(r.tokens)
        t0 = time.perf_counter()
        try:
            vecs = self._guard("serve.embed", self._embed_call, tokens, lengths,
                               key=("embed", p_pad))
        except _ContainedFault:
            for r in batch:
                self._shed(r, FAILED_FAULT)
            return
        except RetryError:
            for r in reversed(batch):
                self._embed_queue.appendleft(r)
            raise
        (vecs,) = _host_fetch(vecs)
        self._note_stage("embed_s", "serve.embed", t0,
                         uids=[r.uid for r in batch], p_pad=p_pad)
        now = time.perf_counter()
        for row, r in enumerate(batch):
            comp = Completion(
                uid=r.uid, prime=np.asarray(r.tokens, np.int32),
                tokens=np.zeros((0,), np.int32), finish_reason="embed",
                submit_time=r.submit_time, finish_time=now,
                embedding=vecs[row], generation=self.generation)
            self.completions.append(comp)
            self._pending.append(comp)
            if r.on_complete is not None:
                r.on_complete(comp)

    def run_embed_round(self) -> None:
        """Serve one embedding batch, if one is queued (for a caller that
        drives prefill work without ``step()``); its completions are
        returned by the next ``step()``."""
        self._embed_round()

    def drain_sheds(self) -> list[Completion]:
        """Collect the typed shed completions recorded since the last call
        (submit-time sheds, failed prefill rounds), for a caller that runs
        prefill or embedding rounds without ``step()``."""
        return self._drain_pending()

    # ------------------------------------------------------------- pages

    def _plan_slot_pages(self, slot: int, r: Request, p_pad: int,
                         wtable: np.ndarray,
                         pending_prefix: list[tuple[tuple, int]]) -> None:
        """Build the slot's page list for rows ``[0, P]`` (prime + first
        sampled token): the longest run of prefix-cache hits first, fresh
        private pages for the rest.  Fills the slot's ``_page_table`` row
        and its ``wtable`` row (private pages only: shared pages were filled
        by the request that first computed them and stay read-only).

        Fresh full-prefix pages are NOT registered here: registrations
        collect in ``pending_prefix`` and commit only after the guarded
        prefill dispatch succeeds."""
        ps = self.page_size
        p = len(r.tokens)
        n_pages = p // ps + 1  # decode writes row P before any page grows
        n_full = p // ps       # full pages strictly inside the prime
        shared: list[int] = []
        for j in range(n_full):
            pid = self._pool.lookup_prefix(prefix_key(p_pad, r.tokens,
                                                      (j + 1) * ps))
            if pid is None:
                break
            shared.append(pid)
        fresh = self._pool.allocate(n_pages - len(shared))
        assert fresh is not None, "admission reserved pages conservatively"
        for pid in shared:
            self._pool.retain(pid)
        self.prefix_hits += len(shared)
        self.prefix_lookups += n_full
        pages = shared + fresh
        for j in range(len(shared), n_full):
            pending_prefix.append(
                (prefix_key(p_pad, r.tokens, (j + 1) * ps), pages[j]))
        self._slot_pages[slot] = SlotPages(pages=pages, shared=len(shared))
        self._page_table[slot, :] = NULL_PAGE
        self._page_table[slot, : n_pages] = pages
        wtable[slot, : n_pages] = [DUMP_PAGE] * len(shared) + fresh

    def _free_slot_pages(self, slot: int) -> None:
        sp = self._slot_pages.pop(slot, None)
        if sp is None:
            return
        for pid in sp.pages:
            self._pool.release(pid)
        self._page_table[slot, :] = NULL_PAGE
        self._paused[slot] = False
        self._admit_order.pop(slot, None)

    def _evict_slot(self, slot: int) -> None:
        """Restart preemption: free the slot's pages and push its request
        back to the FRONT of the queue.  Replaying from scratch reproduces
        the identical token prefix."""
        r = self._inflight.pop(slot)
        self._free_slot_pages(slot)
        self._set_inactive([slot])
        self._queue.appendleft(r)
        self.evictions += 1

    def _ensure_chunk_pages(self) -> None:
        """Before each chunk, grow every live slot's page list to cover all
        positions the chunk can write (``[pos, min(pos + chunk, stop) - 1]``).
        Slots the pool cannot cover are PAUSED for this chunk; if the pool
        starves every live slot, the youngest is evicted until someone can
        run."""
        if not self._inflight:
            return
        try:
            self._guard("serve.page_alloc")
        except _ContainedFault as e:
            # contain an allocator fault like pool starvation: pause every
            # live slot for this chunk and retry next round
            self._defer("page_alloc", e)
            for slot in self._inflight:
                if not self._paused[slot]:
                    self.pause_events += 1
                self._paused[slot] = True
            return
        self._defer_streak.pop("page_alloc", None)
        (pos,) = _host_fetch(self.state["pos"])
        for _ in range(len(self._inflight) + 1):
            slots = sorted(self._inflight, key=self._admit_order.__getitem__)
            for slot in slots:
                # last position the chunk can consume: done fires when
                # new_pos + 1 >= stop, so a live slot never consumes past
                # stop - 2; gate rows are written at consumed positions
                last = min(int(pos[slot]) + self._max_advance - 1,
                           int(self._host_stop[slot]) - 2)
                need = pages_for_span(last, self.page_size)
                sp = self._slot_pages[slot]
                delta = need - len(sp.pages)
                if delta <= 0:
                    self._paused[slot] = False
                    continue
                fresh = self._pool.allocate(delta)
                if fresh is None:
                    if not self._paused[slot]:
                        self.pause_events += 1
                    self._paused[slot] = True
                    continue
                base = len(sp.pages)
                sp.pages.extend(fresh)
                self._page_table[slot, base: base + delta] = fresh
                self._paused[slot] = False
            if any(not self._paused[s] for s in self._inflight):
                return
            # every live slot starved: evict the most recently admitted
            victim = max(self._inflight, key=self._admit_order.__getitem__)
            if len(self._inflight) == 1:
                raise RuntimeError(
                    f"page pool too small for any progress: slot {victim} "
                    f"needs pages beyond capacity {self._pool.capacity} "
                    f"with nothing left to evict")
            self._evict_slot(victim)

    # ------------------------------------------------------------ stepping

    def _harvest_done(self) -> list[Completion]:
        try:
            self._guard("serve.harvest")
        except _ContainedFault as e:
            # finished slots stay done-but-active; the next step's harvest
            # picks them up (done rows are masked no-ops in the chunk body)
            self._defer("harvest", e)
            return []
        self._defer_streak.pop("harvest", None)
        t0 = time.perf_counter()
        # two-phase fetch: one small transfer of the per-slot flags gates
        # the call (the common case is "nothing finished"); the sequence
        # buffer only crosses when some slot actually completed
        (flags,) = _host_fetch(torch.stack([self.state["done"],
                                            self.state["active"]]))
        done, active = flags
        ready = [i for i in range(self.num_slots)
                 if done[i] and active[i] and i in self._inflight]
        if not ready:
            return []
        seq, pos, start = _host_fetch(self.state["seq"], self.state["pos"],
                                      self.state["start"])
        out = []
        now = time.perf_counter()
        for i in ready:
            r = self._inflight.pop(i)
            if self.paged:
                self._free_slot_pages(i)
            toks = seq[i, start[i]: pos[i] + 1].astype(np.int32)
            reason = "eos" if (toks.size and toks[-1] == EOS_ID) else "length"
            comp = Completion(
                uid=r.uid, prime=np.asarray(r.tokens, np.int32), tokens=toks,
                finish_reason=reason, submit_time=r.submit_time,
                finish_time=now, first_token_time=self._ttft.pop(r.uid, None),
                generation=self.generation)
            out.append(comp)
            if r.on_complete is not None:
                r.on_complete(comp)
        self._set_inactive(ready)
        self.completions.extend(out)
        self._tracer.add("serve.harvest", t0, time.perf_counter() - t0,
                         uids=[c.uid for c in out])
        return out

    def _dispatch_chunk(self) -> None:
        """Run one guarded decode chunk.  A fatal fault, a failing K3
        launch included, sheds the in-flight batch (``_fail_inflight``) and
        the engine keeps serving; transient exhaustion escapes as
        :class:`RetryError`."""
        if self.paged:
            self._ensure_chunk_pages()
            if not self._inflight:
                return  # everything got evicted back to the queue
            args = (self._page_table.copy(), self._paused.copy())
        else:
            args = ()
        point = "serve.verify" if self.spec else "serve.decode_chunk"
        t0 = time.perf_counter()
        try:
            out = self._guard(point, self._chunk_call, *args, key=("chunk",))
        except _ContainedFault:
            self._fail_inflight()
            return
        self._note_stage("decode_chunk_s", "serve.decode_chunk", t0,
                         uids=[r.uid for r in self._inflight.values()])
        if self.spec:
            out, stats = out
            # summed on the device; spec_counters() fetches them once
            self._spec_emitted = self._spec_emitted + stats["emitted"]
            self._spec_verify_rounds = self._spec_verify_rounds + stats["rounds"]
            self._spec_slot_rounds = self._spec_slot_rounds + stats["slot_rounds"]
        self.state = out
        self.chunks_run += 1

    def _fail_inflight(self) -> None:
        """Shed every in-flight request (``FAILED_FAULT``) after a fatal
        decode fault: the batch's device state can no longer be trusted to
        advance, but queued requests are untouched."""
        slots = sorted(self._inflight)
        for slot in slots:
            r = self._inflight.pop(slot)
            self._release_slot(slot)
            self._shed(r, FAILED_FAULT)
        self._set_inactive(slots)

    def step(self) -> list[Completion]:
        """One engine iteration: shed expired requests, release held fork
        followers, admit queued ones into free slots, decode one chunk,
        harvest newly finished slots, serve one embedding batch.
        The return includes typed SHED completions recorded since the last
        step (queue-full sheds from ``submit()``, for one)."""
        if self.state is None:
            raise RuntimeError("the engine is closed")
        completed = self._drain_pending()
        if self._watchdog is not None:
            self._watchdog.beat("serve.step")
        self._shed_expired()
        self._release_forks()
        if not self._draining:
            if self.disagg:
                self._admit_from_handoff()
            else:
                self._admit_pending()
        completed += self._drain_pending()
        completed += self._harvest_done()  # instant EOS/length at admission
        if self._inflight:
            self._dispatch_chunk()
            completed += self._drain_pending()
            completed += self._harvest_done()
        if self._embed_queue and not self._draining:
            # after the decode chunk, as the disaggregated prefill round:
            # in-flight decode never waits behind prefill-shaped work
            self._embed_round()
            completed += self._drain_pending()
        if self.disagg and not self._draining:
            # prefill AFTER the decode chunk: in-flight decode never waits
            # behind a long prefill; with no slot in flight there is nothing
            # to protect, so admit at once rather than a step later.  A
            # remote-prefill replica never runs the prefill stage: handles
            # arrive through admit_handle() from the transport
            if not self.remote_prefill:
                self._prefill_round()
            if not self._inflight and self._handoff:
                self._admit_from_handoff()
                completed += self._drain_pending()
                completed += self._harvest_done()
        # refresh the per-class and per-tenant gauges once per step, so a
        # registry snapshot carries current depths
        self.qos_status()
        if self.paged:
            self._publish_cache_gauges()
        return completed

    def admit_handle(self, handle: Handle) -> bool:
        """Push a prefill product into the bounded handoff queue beside the
        in-process path; False when the queue is at depth (the caller keeps
        the handle and retries after a ``step()`` frees room)."""
        if not self.disagg:
            raise RuntimeError("admit_handle() requires disagg=True")
        if self._handoff.full():
            return False
        return self._handoff.put(handle)

    def run_prefill_round(self) -> Handle | None:
        """Run one prefill round and POP the handle it produced instead of
        leaving it queued (a prefill-only caller ships it elsewhere); None
        when the queue was empty or the round shed."""
        if not self.disagg:
            raise RuntimeError("run_prefill_round() requires disagg=True")
        before = len(self._handoff)
        self._prefill_round()
        if len(self._handoff) > before:
            return self._handoff.get()
        return None

    def run_until_idle(self, max_chunks: int | None = None) -> list[Completion]:
        """Drain the queue and all in-flight slots; returns completions
        (served and shed) in finish order."""
        out: list[Completion] = []
        chunks0 = self.chunks_run
        while self.has_work:
            out.extend(self.step())
            if (max_chunks is not None
                    and self.chunks_run - chunks0 >= max_chunks):
                raise RuntimeError(
                    f"engine exceeded {max_chunks} chunks without draining "
                    f"({self.num_active} active, {self.pending} pending)")
        return out

    def drain(self, max_chunks: int | None = None) -> list[Completion]:
        """Stop admission and finish all IN-FLIGHT requests.  The queue is
        left intact; returns the completions finished during the drain."""
        self._draining = True
        try:
            out = self._drain_pending()
            chunks0 = self.chunks_run
            while self._inflight or self._pending:
                out.extend(self.step())
                if (max_chunks is not None
                        and self.chunks_run - chunks0 >= max_chunks):
                    raise RuntimeError(
                        f"drain exceeded {max_chunks} chunks with "
                        f"{self.num_active} slot(s) still active")
        finally:
            self._draining = False
        return out

    # ----------------------------------------------------------- lifecycle

    def snapshot(self, path: str | None = None) -> dict:
        """Host-side request state, enough to REPLAY every unfinished request
        on a fresh engine: prime, sampling knobs, seed, logit mask, tenant,
        priority and the remaining deadline budget.  No device cache is
        kept: a trajectory depends only on (weights, prime, seed, knobs), so
        a replay from the prime is token-identical and the snapshot restores
        onto an engine of any shape.  ``generated`` (the tokens so far) is
        for observability, not for resumption.

        In-flight slots come first (one host fetch of the slot state,
        copied), then the handoff queue's requests, the queue, held fork
        followers and embedding requests.  The format is the JAX engine's,
        so a snapshot of either package restores on the other.  With
        ``path`` it is also written as JSON (an atomic rename)."""
        entries = []
        if self._inflight:
            active, seq, pos, start = _host_fetch(
                self.state["active"], self.state["seq"], self.state["pos"],
                self.state["start"])
            for slot in sorted(self._inflight):
                r = self._inflight[slot]
                gen = (seq[slot, start[slot]: pos[slot] + 1].tolist()
                       if active[slot] else [])
                entries.append(self._snap_request(r, gen))
        if self.disagg:
            # handed-off but unmerged requests replay from the prime like
            # queued ones (their caches are rebuilt, token-identical)
            for h in self._handoff:
                for r in h.requests:
                    entries.append(self._snap_request(r, []))
        for r in self._queue:
            entries.append(self._snap_request(r, []))
        for followers in self._fork_wait.values():
            for r in followers:  # held fork followers are queue-like
                entries.append(self._snap_request(r, []))
        for r in self._embed_queue:
            e = self._snap_request(r, [])
            e["workload"] = "embed"
            entries.append(e)
        snap = {"version": 1, "kind": "serving_snapshot", "requests": entries}
        if path is not None:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as fh:
                json.dump(snap, fh)
            os.replace(tmp, path)
        return snap

    def _snap_request(self, r: Request, generated) -> dict:
        entry = {
            "uid": r.uid,
            "tokens": [int(t) for t in r.tokens],
            "max_new_tokens": int(r.max_new_tokens),
            "top_k": None if r.top_k is None else int(r.top_k),
            "temperature": float(r.temperature),
            "seed": int(r.seed),
            "generated": [int(t) for t in generated],
        }
        if r.logit_mask is not None:
            entry["logit_mask"] = mask_to_wire(r.logit_mask)
        if int(r.tenant) != 0:
            entry["tenant"] = int(r.tenant)
        if int(r.priority) != 0:
            entry["priority"] = int(r.priority)
        deadline = self._deadline_of(r)
        if deadline is not None:
            # perf_counter instants do not survive a process restart; the
            # REMAINING budget does
            entry["deadline_remaining"] = max(0.0, deadline - time.perf_counter())
        return entry

    def restore(self, snap, *, on_complete=None) -> int:
        """Resubmit every request of a :meth:`snapshot` (a dict or a JSON
        path) onto this idle engine; returns the number accepted.  Deadlines
        resume with their remaining budget.  Restored requests go through
        ``submit()`` (``submit_embed()`` for embeddings), so queue bounds and
        spent budgets shed exactly as live traffic would."""
        if isinstance(snap, (str, os.PathLike)):
            with open(snap) as fh:
                snap = json.load(fh)
        if snap.get("kind") != "serving_snapshot":
            raise ValueError("not a serving snapshot")
        if (self._inflight or self._queue or self._embed_queue or self._fork_wait
                or (self.disagg and self._handoff)):
            raise RuntimeError("restore() requires an idle engine")
        now = time.perf_counter()
        accepted = 0
        for e in snap["requests"]:
            lmask = None
            if e.get("logit_mask") is not None:
                lmask = mask_from_wire(e["logit_mask"], self.config.num_tokens)
            r = Request(
                uid=e["uid"], tokens=e["tokens"],
                max_new_tokens=e["max_new_tokens"], top_k=e["top_k"],
                temperature=e["temperature"], seed=e["seed"],
                on_complete=on_complete, submit_time=now, logit_mask=lmask,
                tenant=int(e.get("tenant", 0)), priority=int(e.get("priority", 0)))
            if "deadline_remaining" in e:
                r.deadline = now + e["deadline_remaining"]
            if e.get("workload") == "embed":
                r.workload = "embed"
                self.submit_embed(r)
            else:
                self.submit(r)
            accepted += 1
        return accepted

    def reload_weights(self, params=None, lora_bank=None, *,
                       generation: int | None = None) -> int:
        """Swap the served weights in place: no slot is dropped.  ``params``
        is a ``ProGen`` or its state dict, in the layout the engine was given
        (full precision, quantized here under ``quantize`` exactly as at
        construction, so the result is bit-equal to a fresh engine on the
        same weights); ``lora_bank`` a bank of the engine's shape.  The
        weights are written into the engine's own model: a model the caller
        passed in is copied first and keeps its weights.  In-flight
        slots continue on the new weights from their next step.  Under
        speculation only the target is swapped: the identity draft keeps
        the old weights (the JAX engine keeps them as its draft) and the
        engine serves a copy on the new ones, an explicit draft keeps its
        own.  Returns the new generation (``generation`` when given, else
        the old one + 1), which the completions finishing after the swap
        carry.  A swap that rebinds a model, the draft or the bank (rather
        than writing into the tensors served) captures every warmed program
        again before it returns.  Under a mesh every rank calls it with the
        same weights, whole (a placed ``ProGen`` is gathered); each rank
        writes its part into the served model's shards, and a copy, where
        one is kept, is placed on the mesh as the served model is."""
        if params is None and lora_bank is None:
            raise ValueError("reload_weights needs params and/or lora_bank")
        if lora_bank is not None and not self.lora:
            raise ValueError("engine was built without a LoRA bank; the "
                             "bank's shape is baked into its programs")

        def check(new: dict, spec: dict, what: str) -> None:
            if sorted(new) != sorted(spec):
                raise ValueError(f"reload_weights: {what} tree structure "
                                 "does not match the serving tree")
            for k, v in new.items():
                shape, dtype = spec[k]
                if tuple(v.shape) != shape or v.dtype != dtype:
                    raise ValueError(
                        f"reload_weights: {what} leaf mismatch "
                        f"{tuple(v.shape)}/{v.dtype} vs {shape}/{dtype}")

        if params is not None:
            state = _whole_state(params) if isinstance(params, torch.nn.Module) \
                else dict(params)
            check(state, self._weights_spec, "params")
        if lora_bank is not None:
            validate_lora_bank(self.config, lora_bank)
            bank = cast_bank(lora_bank, self.policy.compute_dtype, self.device)
            check(_flat_bank(bank), self._bank_spec, "lora_bank")
        # whether a model, the draft or the bank the programs read is
        # replaced by another tensor (not written in place)
        rebound = lora_bank is not None
        if params is not None:
            if self._requantize:
                state = self._quantize_state(state)
            if not self._owns_model or (self.spec and self._draft is self.model):
                # the caller's model, or the identity draft, keeps the
                # weights it was built on: the engine serves a copy of its own
                own = self._own_copy(state)
                self._bind_model(own, decode_mesh(own))
                self._owns_model = rebound = True
            elif self._view is None:
                with torch.no_grad():
                    self.model.load_state_dict(state)
            else:  # each rank writes its part, the decode view gathers anew
                load_placed(self.model, state)
                refresh(self._view, self.model)
        if lora_bank is not None:
            self._bank = shard_bank(bank, self._view)
        if rebound:
            # a warmed program holds the addresses it was captured with: it
            # is captured again before the first request on the new weights
            for program in self._aot.values():
                program.recapture()
        self.generation = (int(generation) if generation is not None
                           else self.generation + 1)
        return self.generation

    def aot_warmup(self, max_prime: int | None = None, *,
                   embed: bool = False) -> dict:
        """Capture the engine's whole program grid ahead of serving, each
        program as one CUDA graph (``decode/graphs.py``): an admit program
        per prime bucket (``window * 2^k`` up to ``max_prime``, default
        ``max_len - 1``), or a prefill-worker program per bucket and the
        merge when disaggregated, and the decode chunk; with ``embed=True``
        an embedding program per bucket too.  From then on every dispatch
        of those programs is one replay, so serving launches no program
        from Python and builds nothing.  A program already warmed is not
        captured again.  The grid and the return value are the JAX
        method's: ``{"programs": captured now, "seconds": wall}``, but for a
        ``remote_prefill`` replica, which holds no prefill program (its
        merge is captured on a handle of one eager prefill).  On the
        CPU the programs stage their arguments the same way and call their
        bodies (there is no graph).  A capture that fails raises."""
        t0 = time.perf_counter()
        s, L = self.num_slots, self.max_len
        cap = min(max_prime or L - 1, L - 1)
        buckets = prime_buckets(self.config.window_size, self.config.seq_len, cap)
        lmask = np.ones((s, L, self.config.num_tokens), bool)
        # paged: a write table that sends every row to the dump page
        wtable = ((np.full((s, self.pages_per_row), DUMP_PAGE, np.int32),)
                  if self.paged else ())
        programs = 0

        def capture(key, body, *args):
            nonlocal programs
            if key in self._aot:
                return
            self._aot[key] = CapturedProgram(body, *args, device=self.device)
            self._compiled_keys.add(key)
            programs += 1

        paused = (self._watchdog.paused() if self._watchdog is not None
                  else contextlib.nullcontext())
        with paused:
            for p_pad in buckets:
                if embed:
                    capture(("embed", p_pad), self._embed_impl,
                            np.zeros((self.embed_batch, p_pad), np.int32),
                            np.ones((self.embed_batch,), np.int32))
                a = self._admit_arrays(p_pad)
                if self.disagg:
                    # a remote-prefill replica never dispatches a prefill
                    # program, so it holds none of them
                    if not self.remote_prefill:
                        del a["mask"]
                        capture(("prefill", p_pad), self._prefill_worker,
                                *a.values(), lmask)
                    continue
                capture(("admit", p_pad), self._admit, self.state, *a.values(), lmask,
                        *wtable)
            if self.disagg and ("merge",) not in self._aot:
                # the handle's shape does not depend on the bucket (it is
                # harvested to max_len): any bucket's worker makes one
                a = self._admit_arrays(buckets[0])
                del a["mask"]
                handle = self._prefill_worker_call(*a.values(), lmask)
                capture(("merge",), self._merge, self.state, handle,
                        np.zeros((s,), np.int32), np.zeros((s,), bool), *wtable)
            chunk_args = ((self._page_table.copy(), self._paused.copy())
                          if self.paged else ())
            capture(("chunk",), self._decode_chunk, self.state, *chunk_args)
        return {"programs": programs, "seconds": time.perf_counter() - t0}

    def close(self) -> None:
        """Release the engine's device state: the slot state with its caches
        and page pool, queued handles, the captured programs, the models and
        the LoRA bank; and drop the engine's references to its own bound
        methods, so that dropping the last reference to it frees it at
        once.  Host records
        (completions, counters, ``status()``) stay readable; ``step()``
        raises.  Safe to call twice."""
        self.state = None
        self._aot = {}  # the captured graphs, their pools and static buffers
        if self._handoff is not None:
            for h in self._handoff:
                h.state = {}
        for name in ("_decode_chunk", "_admit", "_prefill_worker", "_merge"):
            self.__dict__.pop(name, None)
        self.model = self._draft = self._step_model = self._embedder = None
        self._draft_step = self._bank = self._view = None

    # -------------------------------------------------------------- status

    def status(self) -> dict:
        """Live engine state: HOST bookkeeping only (queues, slot maps,
        counters, stage walls); never waits for the device."""
        active = len(self._inflight)
        return {
            "slots": {"total": self.num_slots, "active": active,
                      "free": self.num_slots - active},
            "queue_depth": len(self._queue),
            "embed_queue_depth": len(self._embed_queue),
            "fork_groups": self.fork_groups,
            "pending_completions": len(self._pending),
            "inflight_uids": sorted(r.uid for r in list(self._inflight.values())),
            "chunks_run": self.chunks_run,
            "paged": self.paged,
            "quantize": self.quantize,
            "disagg": self.disagg,
            "spec": self.spec,
            "lora_tenants": self.num_tenants if self.lora else 0,
            "stage_seconds": {k: round(v, 6)
                              for k, v in self.stage_seconds.items()},
            "qos": self.qos_status(),
            "cache": self.cache_status(),
            "robust": self.robustness_counters(),
        }

    def cache_status(self) -> dict | None:
        """Prefix-cache occupancy and sharing; None on dense engines."""
        if not self.paged:
            return None
        pool = self._pool.stats()
        hits, lookups = self.prefix_hits, self.prefix_lookups
        return {
            "prefix_hits": hits,
            "prefix_lookups": lookups,
            "hit_rate": (hits / lookups) if lookups else 0.0,
            "pages_shared": pool["shared_pages"],
            "cached_pages": pool["cached_pages"],
            "free_pages": pool["free_pages"],
            "capacity": pool["capacity"],
            "fork_groups": self.fork_groups,
        }

    def prefix_digest(self) -> dict | None:
        """Compact advertisement of this engine's cached prefixes for
        routing across engines; None on dense engines, which cache
        nothing."""
        if not self.paged:
            return None
        return self._pool.prefix_digest()

    def _publish_cache_gauges(self) -> None:
        """Mirror the cache counters into registry gauges."""
        registry = _metrics.get_registry()
        registry.gauge("engine.prefix_hits").set(self.prefix_hits)
        registry.gauge("engine.prefix_lookups").set(self.prefix_lookups)
        registry.gauge("engine.prefix_pages_shared").set(self._pool.shared_pages)
        registry.gauge("engine.pool_free_pages").set(self._pool.free_pages)
        registry.gauge("engine.pool_pages_in_use").set(
            self._pool.capacity - self._pool.free_pages)

    def qos_status(self) -> dict:
        """Per-class and per-tenant queue and in-flight occupancy, and the
        scheduler's cumulative tallies.  Also refreshes the labeled registry
        gauges, so a scrape sees current depths."""
        out = dict(self._queue.stats())
        inflight_by_class: dict = {}
        inflight_by_tenant: dict = {}
        for r in list(self._inflight.values()):
            inflight_by_class[r.priority] = inflight_by_class.get(r.priority, 0) + 1
            inflight_by_tenant[r.tenant] = inflight_by_tenant.get(r.tenant, 0) + 1
        out["inflight_by_class"] = inflight_by_class
        out["inflight_by_tenant"] = inflight_by_tenant
        out["preemptions"] = self.robust.preemptions
        self._publish_qos_gauges(out)
        return out

    def _publish_qos_gauges(self, qos: dict) -> None:
        """Mirror the per-class and per-tenant occupancy into labeled
        registry gauges.  Label keys ever seen are set again on every
        refresh, so a drained class reads 0 and not its last value."""
        registry = _metrics.get_registry()
        fresh: set = set()
        for name, label, table in (
                ("engine.queue_depth", "priority", qos["queue_by_class"]),
                ("engine.queue_depth", "tenant", qos["queue_by_tenant"]),
                ("engine.inflight", "priority", qos["inflight_by_class"]),
                ("engine.inflight", "tenant", qos["inflight_by_tenant"])):
            for key, n in table.items():
                gname = _metrics.labeled(name, **{label: key})
                registry.gauge(gname).set(n)
                fresh.add(gname)
        for gname in self._qos_gauge_keys - fresh:
            registry.gauge(gname).set(0)
        self._qos_gauge_keys |= fresh
        registry.gauge("engine.preemptions").set(self.robust.preemptions)

    def robustness_counters(self) -> dict:
        """Shed and containment tallies, faults fired by the armed plan, QoS
        scheduling tallies, and (paged) pool pressure."""
        out = dict(self.robust.as_dict())
        injector = faults.get()
        out["faults_fired"] = injector.fired() if injector is not None else 0
        out["qos"] = self._queue.stats()
        if self.paged:
            out["evictions"] = self.evictions
            out["pause_events"] = self.pause_events
            out["prefix_hits"] = self.prefix_hits
            out["prefix_lookups"] = self.prefix_lookups
            out["fork_groups"] = self.fork_groups
            out["pool"] = self._pool.stats()
        if self.disagg:
            out["handoff"] = self._handoff.stats()
        return out

    def spec_counters(self) -> dict:
        """Speculation counters, ONE device fetch (call it off the hot path:
        the chunks sum the counts on the device).  As the JAX engine's:
        ``accepted_tokens_per_round`` is the tokens emitted, summed over the
        slots, per round in which some slot was live.  The port adds
        ``spec_slot_rounds`` (live slots summed over rounds) and
        ``accepted_tokens_per_slot_round``, the tokens one live slot gains a
        round (1.0: no proposal accepted; ``spec_k + 1``: all)."""
        if not self.spec:
            return {}
        (counts,) = _host_fetch(torch.stack([self._spec_emitted,
                                             self._spec_verify_rounds,
                                             self._spec_slot_rounds]))
        emitted, rounds, slot_rounds = (int(c) for c in counts)
        return {
            "spec_k": self.spec_k,
            "spec_emitted_tokens": emitted,
            "spec_verify_rounds": rounds,
            "spec_slot_rounds": slot_rounds,
            "accepted_tokens_per_slot_round":
                (emitted / slot_rounds) if slot_rounds else 0.0,
            "accepted_tokens_per_round": (emitted / rounds) if rounds else 0.0,
        }


def run_with_restarts(engine_factory, requests=(), *, attempts: int = 3,
                      snapshot_path: str | None = None,
                      max_chunks: int | None = None,
                      classifier=default_classifier) -> list[Completion]:
    """Serve ``requests`` to completion across engine crashes, as the
    trainer's ``run_attempts`` resume loop does for training.

    When a transient failure escapes the engine's in-place containment (a
    :class:`RetryError`, or anything ``classifier`` calls transient), the
    unfinished requests are snapshotted (also to ``snapshot_path``), the
    engine is closed, a FRESH one is built by ``engine_factory()``, the
    snapshot is restored onto it and serving resumes.  Completions
    harvested before a crash are final (the snapshot leaves them out, so
    nothing is served twice); replayed requests are token-identical to an
    uninterrupted run.  Non-transient failures and the last attempt's
    failure re-raise.  Every engine built here is closed on the way out."""
    out: list[Completion] = []
    engine = engine_factory()
    try:
        for r in requests:
            engine.submit(r)
        for attempt in range(1, max(1, attempts) + 1):
            try:
                out.extend(engine.run_until_idle(max_chunks=max_chunks))
                return out
            except Exception as e:
                if attempt >= attempts or not classifier(e):
                    raise
                out.extend(engine.completions[:])
                snap = engine.snapshot(snapshot_path)
                print(f"serving: attempt {attempt} crashed ({e!r}); "
                      f"restarting and replaying {len(snap['requests'])} "
                      f"request(s)", file=sys.stderr, flush=True)
                engine.close()
                engine = engine_factory()
                engine.restore(snap)
        return out
    finally:
        engine.close()
