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
``serve.decode_chunk`` / ``serve.harvest`` / ``serve.page_alloc``).  Each
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

Not ported yet (each raises ``NotImplementedError``): speculative decoding,
disaggregated prefill and handoff, LoRA banks, meshes, the embed endpoint,
``submit_fork``, snapshot/restore, weight reload, warm-up, the watchdog.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from progen_tpu_torch.compat.convert import params_from_flax, params_to_flax
from progen_tpu_torch.core.precision import Policy
from progen_tpu_torch.decode import rng
from progen_tpu_torch.decode.incremental import (
    ProGenDecodeStep,
    ProGenPagedDecodeStep,
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
    pad_prime_length,
)
from progen_tpu_torch.decode.qos import QoSQueue
from progen_tpu_torch.decode.sampler import (
    gumbel_topk_sample_batched,
    split_keys_batched,
)
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe.robustness import RobustnessCounters
from progen_tpu_torch.ops.quant import quantize_params
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.retry import RetryError, default_classifier

EOS_ID = 0

# typed Completion.status values: sheds are COMPLETIONS, not exceptions, so
# callbacks and benchmarks see every request exactly once either way
STATUS_OK = "ok"
SHED_QUEUE_FULL = "shed_queue_full"
SHED_DEADLINE = "shed_deadline"
FAILED_FAULT = "failed_fault"

# consecutive rounds a phase may defer (fatal-fault containment) before the
# engine concludes the fault is permanent and gives up
_MAX_DEFER_STREAK = 16

# constructor arguments of the JAX engine whose modes are not ported yet,
# with the ROADMAP.md item that holds each
_NOT_PORTED = {
    "spec": "speculative decoding (ROADMAP.md Queue 1, engine modes: spec)",
    "draft_config": "speculative decoding (ROADMAP.md Queue 1, engine modes: spec)",
    "draft_params": "speculative decoding (ROADMAP.md Queue 1, engine modes: spec)",
    "spec_k": "speculative decoding (ROADMAP.md Queue 1, engine modes: spec)",
    "disagg": "disaggregated prefill and handoff (ROADMAP.md Queue 1, engine modes: disagg)",
    "prefill_batch": "disaggregated prefill and handoff (ROADMAP.md Queue 1, engine modes: disagg)",
    "handoff_depth": "disaggregated prefill and handoff (ROADMAP.md Queue 1, engine modes: disagg)",
    "remote_prefill": "disaggregated prefill and handoff (ROADMAP.md Queue 1, engine modes: disagg)",
    "lora_bank": "LoRA adapter banks (ROADMAP.md Queue 1, engine modes: lora_bank)",
    "mesh": "meshes and tensor parallelism (ROADMAP.md Queue 1, engine modes: mesh)",
    "strategies": "meshes and tensor parallelism (ROADMAP.md Queue 1, engine modes: mesh)",
    "params_shardings": "meshes and tensor parallelism (ROADMAP.md Queue 1, engine modes: mesh)",
    "watchdog": "the watchdog (ROADMAP.md Queue 1, engine modes: watchdog)",
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
    ``tenant`` must be 0: LoRA banks are not ported.
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


@dataclasses.dataclass
class Completion:
    """A finished request: ``tokens`` is the generated tail only (EOS
    included when the model emitted one).  ``status`` is ``STATUS_OK`` for
    served requests (``finish_reason`` ``"eos"`` or ``"length"``) or a shed
    type, mirrored into ``finish_reason``.  ``first_token_time`` is the
    instant the admission dispatch returned (None for sheds before it)."""

    uid: Any
    prime: np.ndarray
    tokens: np.ndarray
    finish_reason: str
    submit_time: float
    finish_time: float
    status: str = STATUS_OK
    first_token_time: float | None = None

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


def _merge(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` for rows where ``mask``, else ``old``."""
    return torch.where(mask.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)


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
    """

    def __init__(self, model: ProGen | ProGenConfig, *,
                 policy: Policy | None = None, device=None, seed: int = 0,
                 num_slots: int = 8, chunk_size: int = 32,
                 max_len: int | None = None, paged: bool = False,
                 page_size: int = 16, num_pages: int | None = None,
                 prefix_cache: bool = True, max_queue: int | None = None,
                 shed_policy: str = "reject", fault_retries: int = 3,
                 qos_weights: dict | None = None, quantize: str | None = None,
                 **not_ported):
        for name in not_ported:
            if name not in _NOT_PORTED:
                raise TypeError(f"ServingEngine got an unexpected argument {name!r}")
            raise NotImplementedError(
                f"ServingEngine({name}=...): the port does not have "
                f"{_NOT_PORTED[name]}")
        if isinstance(model, ProGenConfig):
            model = ProGen(model, policy, device=device, seed=seed)
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
        self.robust = RobustnessCounters()
        self._pending: list[Completion] = []   # sheds awaiting step() return
        self._draining = False
        self._defer_streak: dict[str, int] = {}
        # dispatch wall per stage: the host's time in the guarded call.  The
        # device may still be running when a decode chunk's dispatch returns;
        # the harvest that follows waits for it.
        self.stage_seconds = {"prefill_s": 0.0, "decode_chunk_s": 0.0}

        if quantize not in (None, "weights", "weights+pages"):
            raise ValueError(f"quantize {quantize!r}: want None, "
                             f"'weights' or 'weights+pages'")
        if quantize == "weights+pages" and not paged:
            raise ValueError("quantize='weights+pages' requires paged=True "
                             "(the 8-bit gate format is a page format)")
        self.quantize = quantize
        self.gate_dtype = "int8" if quantize == "weights+pages" else "bf16"
        if quantize and model.weights != "int8":
            model = self._quantize_variables(model)
        self.model = model
        self._max_advance = chunk_size
        self._rows = torch.arange(num_slots, device=self.device)

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
            self._step_model = ProGenPagedDecodeStep(
                model, n_rows=self.max_len, gate_dtype=self.gate_dtype)
            self._decode_chunk = self._decode_chunk_paged_impl
            self._admit = self._admit_paged_impl
        else:
            self._step_model = ProGenDecodeStep(model)
            self._decode_chunk = self._decode_chunk_impl
            self._admit = self._admit_impl
        self.state = self._init_state()

    # ---------------------------------------------------------------- state

    def _init_state(self) -> dict:
        s, L, dev = self.num_slots, self.max_len, self.device
        caches = init_caches(self.config, s, self.policy, decode_len=L,
                             device=dev, with_sgu=not self.paged)
        if self.paged:
            caches.pop("sgu_gate")
            caches["sgu_pool"] = init_gate_pool(
                self.config, self._pool.num_pages, self.page_size, self.policy,
                gate_dtype=self.gate_dtype, device=dev)
            if self.gate_dtype == "int8":
                caches["sgu_pool_scale"] = init_gate_scale(
                    self.config, self._pool.num_pages, self.page_size, device=dev)
        zeros = lambda dtype: torch.zeros(s, dtype=dtype, device=dev)
        return {
            "seq": torch.zeros(s, L, dtype=torch.long, device=dev),
            "caches": caches,
            "pos": zeros(torch.long),      # index of the newest token
            "start": zeros(torch.long),    # prime length
            "stop": zeros(torch.long),     # start + max_new (<= L)
            "active": zeros(torch.bool),
            "done": zeros(torch.bool),
            "keys": rng.key(zeros(torch.long)),  # raw key data (S, 2)
            "top_k": zeros(torch.long),    # 0 = disabled
            "temp": torch.ones(s, dtype=torch.float32, device=dev),
            # per-slot logit mask indexed by WRITE position; all-true rows
            # are bit-identical to no masking at all
            "lmask": torch.ones(s, L, self.config.num_tokens, dtype=torch.bool,
                                device=dev),
        }

    @staticmethod
    def _working_copy(state: dict) -> dict:
        """A state whose in-place updates leave ``state`` untouched: the
        buffers a decode chunk writes into are copied, the rest is shared
        (the chunk replaces those entries, it never writes into them)."""
        caches = state["caches"]
        copied = {"attn_prev": list(caches["attn_prev"]),
                  "ff_prev": list(caches["ff_prev"]),
                  "k": [t.clone() for t in caches["k"]],
                  "v": [t.clone() for t in caches["v"]]}
        for name in ("sgu_gate", "sgu_pool", "sgu_pool_scale"):
            if name in caches:
                copied[name] = {k: t.clone() for k, t in caches[name].items()}
        return {**state, "seq": state["seq"].clone(), "caches": copied}

    def _set_inactive(self, slots) -> None:
        act = self.state["active"].clone()
        act[list(slots)] = False
        self.state = {**self.state, "active": act}

    # ------------------------------------------------------ fault containment

    def _note_stage(self, stage: str, t0: float) -> None:
        self.stage_seconds[stage] += time.perf_counter() - t0

    def _guard(self, point: str, fn: Callable | None = None, *args):
        """Run ``faults.inject(point)`` + ``fn(*args)`` with transient
        faults retried in place (no backoff: the retried work is an
        in-process dispatch on a copy of the state, so re-running it is safe
        and deterministic).  Non-transient faults raise
        :class:`_ContainedFault` for the caller's shed rule; transient
        exhaustion raises :class:`RetryError`."""
        last: BaseException | None = None
        attempts = max(0, self.fault_retries) + 1
        for attempt in range(attempts):
            try:
                faults.inject(point)
                out = None if fn is None else fn(*args)
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

    def _admit_call(self, *args):
        return self._admit(self.state, *args)

    def _chunk_call(self, *args):
        return self._decode_chunk(self.state, *args)

    @staticmethod
    def _quantize_variables(model: ProGen) -> ProGen:
        """The int8 serving model of a full-precision ``model``: dense
        weights and SGU spatial weights become int8 buffers with f32 scales
        (``ops/quant.py:quantize_params`` on the flax-layout tree), the rest
        is carried over."""
        tree = params_to_flax(model.state_dict())

        def tensors(node):
            return {k: tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
                    for k, v in node.items()}

        qtree, scales = quantize_params(tensors(tree))
        quantized = ProGen(model.config, model.policy, device=model.device,
                           weights="int8")
        quantized.load_state_dict(
            params_from_flax({"params": qtree, "qscale": scales}))
        return quantized.eval()

    # ------------------------------------------------------------- decoding

    def _advance(self, st: dict, live: torch.Tensor, logits: torch.Tensor) -> None:
        """Sample each row's next token from ``logits`` and advance the live
        rows of ``st`` one position (shared tail of both chunk bodies)."""
        rows, pos = self._rows, st["pos"]
        kd, sub = split_keys_batched(st["keys"])
        writepos = (pos + 1).clamp(0, self.max_len - 1)
        # the logit-mask row for the position this step WRITES
        mrow = st["lmask"][rows, writepos]
        nxt = gumbel_topk_sample_batched(sub, logits, st["top_k"], st["temp"],
                                         mask=mrow)
        val = torch.where(live, nxt, st["seq"][rows, writepos])
        st["seq"][rows, writepos] = val
        new_pos = torch.where(live, pos + 1, pos)
        st["done"] = st["done"] | (live & ((val == EOS_ID)
                                           | (new_pos + 1 >= st["stop"])))
        # a slot's key advances only on its own live steps, so a request's
        # trajectory is independent of its neighbours (and of pauses)
        st["keys"] = torch.where(live[:, None], kd, st["keys"])
        st["pos"] = new_pos

    @torch.no_grad()
    def _decode_chunk_impl(self, state: dict) -> dict:
        st = self._working_copy(state)
        for _ in range(self.chunk_size):
            live = st["active"] & ~st["done"]
            tok = st["seq"][self._rows, st["pos"]]
            logits, _ = self._step_model(tok, st["pos"], st["caches"])
            self._advance(st, live, logits)
        return st

    def _prefill(self, state, tokens, lengths, stops, seeds, top_k, temp, mask,
                 lmask, with_sgu: bool):
        """The shared body of both admit programs: one parallel forward of
        ``tokens (S, P_pad)``, the harvested rings and carries, each row's
        first sampled token, and the merged small state (rows outside
        ``mask`` carry dummy primes and are discarded)."""
        dev, L = self.device, self.max_len
        as_t = lambda a, dtype: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        tokens = as_t(tokens, torch.long)
        lengths, stops = as_t(lengths, torch.long), as_t(stops, torch.long)
        seeds, top_k = as_t(seeds.astype(np.int64), torch.long), as_t(top_k, torch.long)
        temp, mask = as_t(temp, torch.float32), as_t(mask, torch.bool)
        lmask = as_t(lmask, torch.bool)
        rows = self._rows

        logits, sown = self.model(tokens, return_cache=True)
        caches_new = harvest_caches(self.config, sown, lengths, self.policy, L,
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
        seq = tok_L * (torch.arange(L, device=dev)[None, :] < lengths[:, None])
        seq[rows, lengths] = first
        done = (first == EOS_ID) | (lengths + 1 >= stops)
        small = {
            "seq": _merge(mask, seq, state["seq"]),
            "pos": _merge(mask, lengths, state["pos"]),
            "start": _merge(mask, lengths, state["start"]),
            "stop": _merge(mask, stops, state["stop"]),
            "active": _merge(mask, torch.ones_like(mask), state["active"]),
            "done": _merge(mask, done, state["done"]),
            "keys": _merge(mask, split[:, 0], state["keys"]),
            "top_k": _merge(mask, top_k, state["top_k"]),
            "temp": _merge(mask, temp, state["temp"]),
            "lmask": _merge(mask, lmask, state["lmask"]),
        }
        old = state["caches"]
        rings = {k: [_merge(mask, n, o) for n, o in zip(caches_new[k], old[k])]
                 for k in self._RING_KEYS}
        return small, rings, caches_new, sown, lengths, mask

    @torch.no_grad()
    def _admit_impl(self, state, tokens, lengths, stops, seeds, top_k, temp,
                    mask, lmask) -> dict:
        """Prefill ``tokens (S, P_pad)`` in one parallel forward and merge
        the rows where ``mask`` into ``state``.  ``lmask (S, L, V)`` is each
        row's logit mask indexed by write position."""
        small, rings, caches_new, _, _, mask = self._prefill(
            state, tokens, lengths, stops, seeds, top_k, temp, mask, lmask,
            with_sgu=True)
        gates = {k: _merge(mask, caches_new["sgu_gate"][k], old)
                 for k, old in state["caches"]["sgu_gate"].items()}
        return {**small, "caches": {**rings, "sgu_gate": gates}}

    # -------------------------------------------------------- paged decoding

    _RING_KEYS = ("attn_prev", "ff_prev", "k", "v")

    @torch.no_grad()
    def _decode_chunk_paged_impl(self, state: dict, table, paused) -> dict:
        """Paged twin of ``_decode_chunk_impl``: the page ``table`` and the
        ``paused`` mask ride in as data.  Paused rows run the step but are
        fully masked: sequence, position and key freeze, and the step drops
        their pool, ring and carry writes (``write_ok``)."""
        table = torch.as_tensor(table, device=self.device)
        paused = torch.as_tensor(paused, device=self.device)
        st = self._working_copy(state)
        for _ in range(self.chunk_size):
            live = st["active"] & ~st["done"] & ~paused
            tok = st["seq"][self._rows, st["pos"]]
            logits, _ = self._step_model(tok, st["pos"], st["caches"], table, live)
            self._advance(st, live, logits)
        return st

    @torch.no_grad()
    def _admit_paged_impl(self, state, tokens, lengths, stops, seeds, top_k,
                          temp, mask, lmask, wtable) -> dict:
        """Paged twin of ``_admit_impl``: rings and carries harvest and merge
        as in the dense path, but gate rows scatter straight into the page
        pool through the WRITE table (``wtable``: private pages only;
        prefix-shared and dummy rows go to the dump page)."""
        small, rings, _, sown, lengths, _ = self._prefill(
            state, tokens, lengths, stops, seeds, top_k, temp, mask, lmask,
            with_sgu=False)
        old = state["caches"]
        wtable = torch.as_tensor(wtable, device=self.device)
        if self.gate_dtype == "int8":
            pool_new, scale_new = harvest_gate_pages(
                self.config, sown, lengths, old["sgu_pool"], wtable,
                self.policy, pool_scale=old["sgu_pool_scale"])
            pools = {"sgu_pool": pool_new, "sgu_pool_scale": scale_new}
        else:
            pools = {"sgu_pool": harvest_gate_pages(
                self.config, sown, lengths, old["sgu_pool"], wtable, self.policy)}
        return {**small, "caches": {**rings, **pools}}

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
        if int(request.tenant) != 0:
            raise ValueError(
                f"request {request.uid!r}: tenant={int(request.tenant)} but "
                f"the engine holds no lora_bank (not ported)")
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

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def num_active(self) -> int:
        return len(self._inflight)

    @property
    def has_work(self) -> bool:
        """True while anything remains for ``step()`` to do or report."""
        return bool(len(self._queue) + len(self._inflight) + len(self._pending))

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
            first_token_time=self._ttft.pop(r.uid, None))
        self.completions.append(comp)
        self._pending.append(comp)
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
        expired_q = [r for r in self._queue
                     if self._deadline_of(r) is not None
                     and now > self._deadline_of(r)]
        for r in expired_q:
            self._queue.remove(r)
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
                "seeds": np.zeros((s,), np.uint32),
                "top_k": np.zeros((s,), np.int32),
                "temp": np.ones((s,), np.float32),
                "mask": np.zeros((s,), bool)}

    def _fill_admit_row(self, a: dict, slot: int, r: Request) -> None:
        t = np.asarray(r.tokens, np.int32)
        a["tokens"][slot, : len(t)] = t
        a["lengths"][slot] = len(t)
        a["stops"][slot] = min(len(t) + r.max_new_tokens, self.max_len)
        a["seeds"][slot] = np.uint32(int(r.seed) & 0xFFFFFFFF)
        a["top_k"][slot] = 0 if r.top_k is None else int(r.top_k)
        a["temp"][slot] = float(r.temperature)
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

        t0 = time.perf_counter()
        try:
            self.state = self._guard(
                "serve.prefill", self._admit_call, *a.values(), lmask)
            self._note_stage("prefill_s", t0)
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
                "serve.prefill", self._admit_call, *a.values(), lmask, wtable)
            self._note_stage("prefill_s", t0)
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
                finish_time=now, first_token_time=self._ttft.pop(r.uid, None))
            out.append(comp)
            if r.on_complete is not None:
                r.on_complete(comp)
        self._set_inactive(ready)
        self.completions.extend(out)
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
        t0 = time.perf_counter()
        try:
            out = self._guard("serve.decode_chunk", self._chunk_call, *args)
        except _ContainedFault:
            self._fail_inflight()
            return
        self._note_stage("decode_chunk_s", t0)
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
        """One engine iteration: shed expired requests, admit queued ones
        into free slots, decode one chunk, harvest newly finished slots.
        The return includes typed SHED completions recorded since the last
        step (queue-full sheds from ``submit()``, for one)."""
        completed = self._drain_pending()
        self._shed_expired()
        if not self._draining:
            self._admit_pending()
        completed += self._drain_pending()
        completed += self._harvest_done()  # instant EOS/length at admission
        if self._inflight:
            self._dispatch_chunk()
            completed += self._drain_pending()
            completed += self._harvest_done()
        return completed

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

    # -------------------------------------------------------------- status

    def status(self) -> dict:
        """Live engine state: HOST bookkeeping only (queues, slot maps,
        counters, stage walls); never waits for the device."""
        active = len(self._inflight)
        return {
            "slots": {"total": self.num_slots, "active": active,
                      "free": self.num_slots - active},
            "queue_depth": len(self._queue),
            "pending_completions": len(self._pending),
            "inflight_uids": sorted(r.uid for r in list(self._inflight.values())),
            "chunks_run": self.chunks_run,
            "paged": self.paged,
            "quantize": self.quantize,
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
        }

    def qos_status(self) -> dict:
        """Per-class and per-tenant queue and in-flight occupancy, and the
        scheduler's cumulative tallies."""
        out = dict(self._queue.stats())
        inflight_by_class: dict = {}
        inflight_by_tenant: dict = {}
        for r in list(self._inflight.values()):
            inflight_by_class[r.priority] = inflight_by_class.get(r.priority, 0) + 1
            inflight_by_tenant[r.tenant] = inflight_by_tenant.get(r.tenant, 0) + 1
        out["inflight_by_class"] = inflight_by_class
        out["inflight_by_tenant"] = inflight_by_tenant
        out["preemptions"] = self.robust.preemptions
        return out

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
            out["pool"] = self._pool.stats()
        return out
