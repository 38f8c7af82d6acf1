"""Serving worker process: ``python -m progen_tpu_torch.serve.worker``
(ported from progen_tpu/serve/worker.py).

    python -m progen_tpu_torch.serve.worker ROLE INDEX PORT SPEC_PATH \\
        [INCARNATION [GENERATION]]

One process per stage instance, spawned by :class:`ServeCluster`; each owns
its own CUDA context (on the one card, every process of the fleet shares
``cuda:0``: the transport is sockets, not NCCL).  The worker connects back
to the router, says hello, builds its engine from the JSON spec file, and
enters its stage loop:

- ``prefill``: requests in -> :meth:`ServingEngine.run_prefill_round` ->
  serialized handle frames out, throttled by an ack credit window (the
  replica acks on admission; unacked handles <= the engine's
  ``handoff_depth``) so prefilled state never piles up un-merged;
- ``decode``: handle frames in -> :func:`deserialize_handle` onto the
  engine's device -> :meth:`ServingEngine.admit_handle`
  (``remote_prefill=True``: the engine NEVER runs its own prefill; prefill
  wall leaves this process entirely) -> completion messages out.

Every process builds bit-identical weights from the same spec (the port's
seeded init, drawn on the CPU, or the same checkpoint), so handles made by
any worker merge into any replica and trajectories depend only on
(weights, prime, seed, knobs): placement is invisible in the tokens.

A payload-CRC-corrupt handle frame is reported home as a typed
``bad_frame`` message (the router replays the named requests); a desynced
stream ends the process, and stage supervision restarts it.

The spec names its device (``"cuda"`` unless the caller asks for
``"cpu"``), resolved by ``core/device.py:resolve_device``: a worker told
``cuda`` that finds no card exits nonzero; it never runs on the CPU on its
own.  A CPU worker runs one thread (as the port's tests do: a test's
workers must not oversubscribe the cores).  At exit the worker prints one
JSON line to its log, ``{"worker_exit": "ROLE:INDEX", "launches": {...},
...}``: the kernel launches it counted from its ready frame on, by counter
(``ops/cuda_*``'s, with their routes), its peak device memory over its
life and its build seconds.  Nothing of it goes on the wire, so the frames
stay JAX's.

A decode replica may also be a multi-process TENSOR-PARALLEL GROUP
(``PROGEN_TPU_TP_GROUP_SIZE``, ``_RANK`` and ``_PORT`` in the environment,
as the JAX package sets them; docs/SERVING.md §13): member 0 is the leader
(role ``decode``), members 1..G-1 are followers (role ``dshard<k>``, same
replica index).  After its hello each member joins the group's private
``torch.distributed`` process group on a fresh TCP store port: NCCL where
every member has a card of its own, gloo where they share ``cuda:0`` (NCCL
refuses two ranks on one card) or run on the CPU, chosen before the group
forms.  A member that cannot join raises, and the driver reaps and
respawns the whole group.  The group's engine runs under a ``tensor=G``
mesh (``("tp",)``, decode under a mesh, ``parallel/decode.py``), its
weights placed rank by rank (:func:`build_engine_from_spec`), and every
step is driven in lockstep by a plan the leader broadcasts
(:func:`_group_decode_loop`).  The JAX-only compilation cache has no
counterpart.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import sys
import time
from collections import deque

import torch

# seconds a group member waits to join its group, and for any collective
# of the group after (a member whose sibling died is reaped by the driver
# before that)
GROUP_TIMEOUT_S = 600.0


def make_spec(config, *, mixed_precision: bool = True, init_seed: int = 0,
              checkpoint_path: str | None = None, draft: str = "identity",
              engine: dict | None = None, draft_config=None,
              heartbeat_s: float = 1.0, trace: dict | None = None,
              statusz: bool = False, lora: dict | None = None,
              aot_warmup: bool = False, warmup_max_prime: int | None = None,
              device: str = "cuda") -> dict:
    """Build the JSON-able worker spec (the JAX package's keys, plus
    ``device``).  ``engine`` holds :class:`ServingEngine` kwargs
    (slots/chunk/paged/spec/..., including ``quantize``: every worker built
    from the spec quantizes the same full-precision weights, so int8
    replicas stay bit-identical to each other); ``disagg`` is implied.
    Weights come from ``checkpoint_path`` (a store of the port's
    ``checkpoint/store.py``) when set, else from the port's seeded init of
    ``init_seed``, identical in every process either way.  ``trace``
    (``{"dir": ..., "capacity"?}``) enables span tracing in every worker;
    each dumps its ring to ``trace_<role>_<index>.json`` in that directory
    at exit.  ``statusz=True`` starts a loopback introspection server in
    every process (driver included) on an ephemeral port; workers report
    their port in the hello frame and the driver surfaces the map on its
    own /statusz.

    ``lora`` (``{"tenants": T, "rank": R, "seed"?, "scale"?}``) gives the
    worker a deterministic adapter bank (``workloads/lora.py:
    random_lora_bank``), identical in every process, so multi-tenant
    handles merge into any replica of the same spec.  ``aot_warmup=True``
    makes the worker capture its whole program grid BEFORE sending its
    ready frame; ``warmup_max_prime`` caps the bucket sweep.  ``device``
    is where every worker runs (``"cuda"``: all on ``cuda:0``)."""
    spec = {
        "config": config.to_dict(),
        "mixed_precision": bool(mixed_precision),
        "init_seed": int(init_seed),
        "checkpoint_path": checkpoint_path,
        "draft": draft,
        "engine": dict(engine or {}),
        "heartbeat_s": float(heartbeat_s),
        "device": str(device),
    }
    if trace:
        spec["trace"] = dict(trace)
    if statusz:
        spec["statusz"] = True
    if lora:
        spec["lora"] = dict(lora)
    if aot_warmup:
        spec["aot_warmup"] = True
        if warmup_max_prime is not None:
            spec["warmup_max_prime"] = int(warmup_max_prime)
    if draft_config is not None:
        spec["draft_config"] = draft_config.to_dict()
    return spec


def _spec_model(spec: dict, cfg, policy, device):
    """The spec's weights in a ``ProGen`` on ``device``: the port's seeded
    init of ``init_seed``, or the checkpoint at ``checkpoint_path``."""
    from progen_tpu_torch.models.progen import ProGen

    model = ProGen(cfg, policy, device=device, seed=int(spec.get("init_seed", 0)))
    if spec.get("checkpoint_path"):
        from progen_tpu_torch.checkpoint.store import CheckpointStore

        store = CheckpointStore(spec["checkpoint_path"])
        params = store.restore_params(map_location=device)
        if params is None:
            raise FileNotFoundError(
                f"no checkpoint in {spec['checkpoint_path']}")
        model.load_state_dict(params)
    return model


def _group_model(spec: dict, cfg, policy, device, group_size: int, quantize):
    """A tensor-parallel group member's model: placed on a ``tensor=G``
    mesh of the group's process group under ``("tp",)``, rank by rank.  The
    whole weights are built on the host (int8 there under ``quantize``,
    their scales the whole weights'), a ``meta`` skeleton is placed on the
    mesh and given the member's device, and ``load_placed`` writes each
    parameter's part into it: no member holds the whole model on its card.
    Returns ``(model, mesh)``."""
    import torch.distributed as dist

    from progen_tpu_torch.core.mesh import MeshConfig, make_mesh
    from progen_tpu_torch.decode.engine import ServingEngine
    from progen_tpu_torch.models.progen import ProGen
    from progen_tpu_torch.parallel.sharding import (
        load_placed,
        parallelize,
        validate_tp_divisibility,
    )

    validate_tp_divisibility(cfg, group_size, strategies=("tp",))
    if not dist.is_initialized() or dist.get_world_size() != group_size:
        raise RuntimeError(
            f"a tensor-parallel group of {group_size} builds its engine inside "
            "its process group: join it first (serve/worker.py:join_group)")
    mesh = make_mesh(MeshConfig(1, 1, group_size, 1), device.type)
    whole = _spec_model(spec, cfg, policy, "cpu")
    if quantize:
        whole = ServingEngine._quantize_variables(whole)
    model = ProGen(cfg, policy, device="meta", weights=whole.weights)
    parallelize(model, mesh, ("tp",))
    model.to_empty(device=device)
    load_placed(model, whole.state_dict())
    return model, mesh


def build_engine_from_spec(spec: dict, *, remote_prefill: bool = False,
                           group_size: int = 1):
    """Construct the ServingEngine a worker spec describes; also used by
    tests and the smoke to build the in-process REFERENCE engine with the
    exact same weight recipe, which makes token identity a hard assert.

    ``group_size > 1`` builds the TP-GROUP flavor, inside the group's
    process group (:func:`join_group`): the engine runs under a
    ``tensor=group_size`` mesh with the ``tp`` rule set, after
    ``validate_tp_divisibility``, on weights placed rank by rank
    (:func:`_group_model`).  Every member calls this with the same spec, so
    the group's weights, like a single-process replica's, depend only on
    (init seed | checkpoint)."""
    from progen_tpu_torch.core.device import resolve_device
    from progen_tpu_torch.core.precision import make_policy
    from progen_tpu_torch.decode.engine import ServingEngine
    from progen_tpu_torch.models.progen import ProGenConfig

    device = resolve_device(spec.get("device", "cuda"))
    cfg = ProGenConfig.from_dict(spec["config"])
    policy = make_policy(bool(spec.get("mixed_precision", True)))
    kw = dict(spec.get("engine", {}))
    if group_size > 1:
        model, kw["mesh"] = _group_model(spec, cfg, policy, device, group_size,
                                         kw.get("quantize"))
        kw["strategies"] = ("tp",)
    else:
        model = _spec_model(spec, cfg, policy, device)
    kw["disagg"] = True
    if kw.get("spec") and "draft_config" in spec:
        kw["draft_config"] = ProGenConfig.from_dict(spec["draft_config"])
    if spec.get("lora"):
        # spec-driven bank: random_lora_bank is deterministic per seed, so
        # every process rebuilds the SAME adapters (as it does the weights)
        from progen_tpu_torch.workloads.lora import random_lora_bank

        lcfg = spec["lora"]
        kw["lora_bank"] = random_lora_bank(
            cfg, int(lcfg["tenants"]), int(lcfg["rank"]),
            seed=int(lcfg.get("seed", 0)),
            scale=float(lcfg.get("scale", 1e-2)), device=device)
    return ServingEngine(model.eval(), remote_prefill=remote_prefill, **kw)


def kernel_launches(since: dict | None = None) -> dict:
    """Every kernel launch counter (``decode/graphs.py:launch_counts``) by
    name, ``"cuda_attention.launches"`` or, for a per-route table,
    ``"cuda_attention.fwd_route_launches.wgmma"``, less its value in
    ``since`` (an earlier :func:`launch_counts` reading)."""
    from progen_tpu_torch.decode.graphs import launch_counts

    since = since or {}
    out = {}
    for key, n in launch_counts().items():
        module, attr, route = key
        name = f"{module.__name__.rsplit('.', 1)[-1]}.{attr}"
        out[name if route is None else f"{name}.{route}"] = n - since.get(key, 0)
    return out


def _completion_to_wire(c) -> dict:
    msg = {
        "type": "completion",
        "uid": c.uid,
        "prime": [int(t) for t in c.prime],
        "tokens": [int(t) for t in c.tokens],
        "finish_reason": c.finish_reason,
        "status": c.status,
        "worker_latency": float(c.latency),
    }
    if c.embedding is not None:
        msg["embedding"] = [float(x) for x in c.embedding]
    return msg


def _drain_inbox(inbox, *, timeout: float):
    """Pull every queued event (blocking up to ``timeout`` for the first);
    returns (messages, router_dead)."""
    out = []
    t = timeout
    while True:
        try:
            item = inbox.get(timeout=t)
        except _queue.Empty:
            return out, False
        t = 0.0
        if item[0] == "dead":
            return out, True
        out.append((item[2], item[3]))  # (header, frame)


def _stats_frame(eng, counters, **extra) -> dict:
    """One stats/metrics frame, sent both as the final flush and in reply to
    a mid-run ``stats_req``: the worker echoes its clock so the driver can
    stamp the snapshot's capture age."""
    from progen_tpu_torch.observe.metrics import get_registry

    msg = {"type": "stats",
           "clock": time.perf_counter(),
           "stage_seconds": eng.stage_seconds,
           "transport": counters.as_dict(),
           "chunks_run": eng.chunks_run,
           # every role reports its robustness + QoS tallies: prefill
           # workers own the fleet's scheduling queues, so their per-class
           # and per-tenant counters are the fleet QoS view
           "robust": eng.robustness_counters(),
           "metrics": get_registry().snapshot()}
    dig = eng.prefix_digest()
    if dig is not None:
        # the cache advertisement rides the stats frame too, so a
        # drain-time flush leaves the router's digest table current
        msg["digest"] = dig
    msg.update(extra)
    return msg


def _prefill_loop(eng, peer, inbox, counters, *, heartbeat_s: float,
                  window: int, incarnation: int = 0,
                  generation: int = 0) -> None:
    from progen_tpu_torch.decode.handoff import request_from_wire, serialize_handle
    from progen_tpu_torch.observe.metrics import get_registry
    from progen_tpu_torch.observe.trace import get_tracer

    tracer = get_tracer()
    unacked: set = set()
    batch_seq = 0
    running = True
    stall_t0 = None  # opened when prefill is blocked on ack credits
    last_hb = time.perf_counter()
    while running or eng.pending:
        idle = not (eng.pending and len(unacked) < window)
        msgs, dead = _drain_inbox(inbox, timeout=0.1 if idle else 0.0)
        if dead:
            return
        for header, _ in msgs:
            t = header.get("type")
            if t == "req":
                eng.submit(request_from_wire(
                    header["req"], vocab=eng.config.num_tokens))
            elif t == "embed_req":
                eng.submit_embed(request_from_wire(
                    header["req"], vocab=eng.config.num_tokens))
            elif t == "ack":
                unacked.discard(header.get("batch_id"))
            elif t == "shutdown":
                running = False
            elif t == "stats_req":
                peer.send_json(_stats_frame(eng, counters))
        # embed traffic shares this worker's prefill-shaped programs but
        # needs no ack credits: completions ship straight home
        while eng.embed_pending:
            eng.run_embed_round()
            for c in eng.drain_sheds():
                peer.send_json(_completion_to_wire(c))
        if eng.pending and len(unacked) >= window:
            if stall_t0 is None:
                stall_t0 = time.perf_counter()
        elif stall_t0 is not None:
            now = time.perf_counter()
            tracer.add("worker.credit_stall", stall_t0, now - stall_t0,
                       queue=eng.pending)
            stall_t0 = None
        for c in eng.drain_sheds():
            peer.send_json(_completion_to_wire(c))
        while eng.pending and len(unacked) < window:
            before = eng.pending
            h = eng.run_prefill_round()
            for c in eng.drain_sheds():
                peer.send_json(_completion_to_wire(c))
            if h is not None:
                # the incarnation nonce keeps a respawned worker's ids
                # (batch_seq restarts at 0) distinct from any the dead
                # incarnation left in the router's bookkeeping
                batch_id = f"{peer.index}.{incarnation}:{batch_seq}"
                batch_seq += 1
                frame = serialize_handle(
                    h, counters=counters,
                    extra_header={"batch_id": batch_id,
                                  "src": peer.index,
                                  "generation": generation,
                                  "trace_ctx": {
                                      "clock": time.perf_counter(),
                                      "src_proc": f"prefill:{peer.index}"}})
                unacked.add(batch_id)
                peer.send_bytes(frame)
                # handed-off requests are harvested by a decode replica,
                # never here: drop their first-token stamps
                eng.forget_ttft(r.uid for r in h.requests)
            elif eng.pending >= before:
                break  # no progress (should not happen; avoid spinning)
        now = time.perf_counter()
        if now - last_hb >= heartbeat_s:
            last_hb = now
            peer.send_json({
                "type": "hb", "queue": eng.pending,
                "unacked": len(unacked),
                "clock": now,
                "stage_seconds": eng.stage_seconds,
                "metrics": get_registry().snapshot()})
    peer.send_json(_stats_frame(eng, counters))


def _decode_loop(eng, peer, inbox, counters, *, heartbeat_s: float) -> None:
    from progen_tpu_torch.decode.handoff import FrameCorrupt, deserialize_handle
    from progen_tpu_torch.observe.metrics import get_registry
    from progen_tpu_torch.observe.trace import get_tracer

    tracer = get_tracer()
    backlog: deque = deque()  # [header, frame, handle|None, recv_clock]
    running = True
    max_backlog = 0
    last_hb = time.perf_counter()
    while running or eng.has_work or backlog:
        idle = not (eng.has_work or backlog)
        msgs, dead = _drain_inbox(inbox, timeout=0.1 if idle else 0.0)
        if dead:
            return
        for header, frame in msgs:
            t = header.get("type")
            if t == "handle":
                backlog.append([header, frame, None, time.perf_counter()])
                max_backlog = max(max_backlog, len(backlog))
            elif t == "shutdown":
                running = False
            elif t == "stats_req":
                peer.send_json(_stats_frame(
                    eng, counters, max_handoff_backlog=max_backlog))
        while backlog:
            entry = backlog[0]
            if entry[2] is None:
                try:
                    entry[2] = deserialize_handle(entry[1], counters=counters,
                                                  device=eng.device)
                except FrameCorrupt:
                    counters.crc_failures += 1
                    backlog.popleft()
                    peer.send_json({
                        "type": "bad_frame",
                        "batch_id": entry[0].get("batch_id"),
                        "uids": [d["uid"] for d in entry[0].get("reqs", [])]})
                    continue
            if not eng.admit_handle(entry[2]):
                break  # handoff at depth: step() below frees it
            backlog.popleft()
            # queue-wait: frame receipt -> successful admission, tagged with
            # the uids the handle header names
            now = time.perf_counter()
            tracer.add("worker.queue_wait", entry[3], now - entry[3],
                       uids=[d["uid"] for d in entry[0].get("reqs", [])],
                       batch_id=entry[0].get("batch_id"))
            peer.send_json({"type": "ack",
                            "batch_id": entry[0].get("batch_id")})
        if eng.has_work:
            for c in eng.step():
                peer.send_json(_completion_to_wire(c))
        now = time.perf_counter()
        if now - last_hb >= heartbeat_s:
            last_hb = now
            hb_msg = {
                "type": "hb", "inflight": eng.num_active,
                "handoff_backlog": len(backlog),
                "clock": now,
                "stage_seconds": eng.stage_seconds,
                "metrics": get_registry().snapshot()}
            dig = eng.prefix_digest()
            if dig is not None:
                hb_msg["digest"] = dig
            peer.send_json(hb_msg)
    peer.send_json(_stats_frame(eng, counters,
                                max_handoff_backlog=max_backlog))


# --- tp-group lockstep ------------------------------------------------
#
# A tp-group engine's programs hold collectives: every member must issue
# the SAME sequence of admit/step calls or the group deadlocks.  The engine
# itself is deterministic (identical inputs in identical order produce
# identical host state on every member), so only the leader's
# nondeterministic inputs (which handle frames arrived, and whether
# shutdown was requested) need broadcasting.  Each loop iteration the
# leader publishes a small JSON plan; everything after it is deterministic
# replay.

_PLAN_BYTES = 16384  # fixed-size plan buffer (a broadcast needs one shape)


def join_group(device: torch.device, group_size: int, group_rank: int,
               port: int) -> torch.device:
    """Join this member's replica group: a private ``torch.distributed``
    process group of ``group_size`` ranks meeting on the loopback TCP store
    at ``port`` (hosted by rank 0; a fresh port per incarnation).  The
    backend is chosen before the group forms, never on a failure: NCCL
    where every member has a card of its own (member ``k`` takes card
    ``k``), gloo where the members share ``cuda:0`` or run on the CPU.
    Raises when the group does not form within :data:`GROUP_TIMEOUT_S`.
    Returns the member's device."""
    import datetime

    import torch.distributed as dist

    backend = "gloo"
    if device.type == "cuda" and torch.cuda.device_count() >= group_size:
        backend = "nccl"
        torch.cuda.set_device(group_rank)
        device = torch.device("cuda", group_rank)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=group_size,
        rank=group_rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return device


def _group_plan_exchange(plan: dict | None) -> dict:
    """Leader -> members broadcast of one lockstep plan dict, as JSON in a
    fixed :data:`_PLAN_BYTES` buffer.  Followers pass ``None``; every
    member returns the leader's plan."""
    import torch.distributed as dist

    from progen_tpu_torch.decode.handoff import group_device

    buf = torch.zeros(_PLAN_BYTES, dtype=torch.uint8)
    if plan is not None:
        raw = json.dumps(plan).encode()
        if len(raw) >= _PLAN_BYTES:
            raise ValueError(
                f"tp-group plan overflows {_PLAN_BYTES}B: {len(raw)}B")
        buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    buf = buf.to(group_device())
    dist.broadcast(buf, src=0)
    return json.loads(bytes(buf.cpu().numpy()).rstrip(b"\x00").decode())


def _group_all_ok(flag: bool) -> bool:
    """Group consensus by an all-gather of every member's vote: True iff
    EVERY member voted True."""
    import torch.distributed as dist

    from progen_tpu_torch.decode.handoff import group_device

    mine = torch.tensor([1 if flag else 0], dtype=torch.int32, device=group_device())
    votes = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(votes, mine)
    return bool(min(int(v.item()) for v in votes) > 0)


def _claim_slab(slabs: dict, batch_id: str, inbox, eng, peer, counters,
                *, deadline_s: float = 120.0):
    """Take ``batch_id``'s slab frame, waiting for late delivery.

    The leader only announces batch ids it has already received, but a
    follower's slab rides a separate TCP stream and may trail the plan
    broadcast.  Returns ``[header, frame, recv_clock]`` or None when the
    router died; a slab that never arrives is a wiring bug, not a transient:
    raise rather than desync the group."""
    deadline = time.perf_counter() + deadline_s
    while batch_id not in slabs:
        msgs, dead = _drain_inbox(inbox, timeout=0.2)
        if dead:
            return None
        for header, frame in msgs:
            t = header.get("type")
            if t == "handle":
                slabs[header.get("batch_id")] = [
                    header, frame, time.perf_counter()]
            elif t == "stats_req":
                peer.send_json(_stats_frame(eng, counters))
            # shutdown is leader-planned; a follower's copy is ignored
        if time.perf_counter() > deadline:
            raise RuntimeError(
                f"tp-group slab for batch {batch_id!r} never arrived")
    return slabs.pop(batch_id)


def _group_decode_loop(eng, peer, inbox, counters, *, heartbeat_s: float,
                       group_rank: int, group_size: int) -> None:
    """Decode loop for one member of a tp-group replica.

    Mirrors :func:`_decode_loop` exactly (same admit-then-step order, same
    at-depth backpressure), but frame arrival and shutdown flow through the
    leader's plan, each slab's parse takes a group vote inside
    :func:`deserialize_handle_sharded` (a batch enters the engine only when
    EVERY member could parse its slab, else the group drops it as one), and
    only the leader speaks results (ack / bad_frame / completion) to the
    router.  Heartbeats and stats stay per-member, tagged with
    ``group_rank`` and ``group_size``: the driver supervises each process."""
    from progen_tpu_torch.decode.handoff import (
        FrameCorrupt,
        SlabDropped,
        deserialize_handle_sharded,
    )
    from progen_tpu_torch.observe.metrics import get_registry
    from progen_tpu_torch.observe.trace import get_tracer

    leader = group_rank == 0
    tag = {"group_rank": group_rank, "group_size": group_size}
    tracer = get_tracer()
    backlog: deque = deque()  # [header, frame, handle|None, recv_clock]
    slabs: dict = {}          # batch_id -> [header, frame, recv_clock]
    announce: list = []       # leader: arrived, not yet planned
    running = True
    max_backlog = 0
    last_hb = time.perf_counter()
    while running or eng.has_work or backlog:
        idle = not (eng.has_work or backlog)
        msgs, dead = _drain_inbox(inbox, timeout=0.1 if idle else 0.0)
        if dead:
            return
        for header, frame in msgs:
            t = header.get("type")
            if t == "handle":
                bid = header.get("batch_id")
                slabs[bid] = [header, frame, time.perf_counter()]
                if leader:
                    announce.append(bid)
            elif t == "shutdown":
                if leader:
                    running = False
            elif t == "stats_req":
                peer.send_json(_stats_frame(
                    eng, counters, max_handoff_backlog=max_backlog, **tag))
        plan = _group_plan_exchange(
            {"admit": announce, "running": running} if leader else None)
        running = bool(plan["running"])
        announce = []
        for bid in plan["admit"]:
            entry = _claim_slab(slabs, bid, inbox, eng, peer, counters)
            if entry is None:
                return
            backlog.append([entry[0], entry[1], None, entry[2]])
            max_backlog = max(max_backlog, len(backlog))
        while backlog:
            entry = backlog[0]
            if entry[2] is None:
                try:
                    entry[2] = deserialize_handle_sharded(
                        entry[1], eng.mesh, counters=counters, device=eng.device,
                        vote=_group_all_ok, draft_whole=eng.draft_whole)
                except FrameCorrupt as e:
                    # some member's slab was corrupt: the whole group drops
                    # the batch, so the engines' states stay identical
                    if not isinstance(e, SlabDropped):
                        counters.crc_failures += 1
                    backlog.popleft()
                    if leader:
                        peer.send_json({
                            "type": "bad_frame",
                            "batch_id": entry[0].get("batch_id"),
                            "uids": [d["uid"] for d in entry[0].get("reqs", [])]})
                    continue
            if not eng.admit_handle(entry[2]):
                break  # handoff at depth: step() below frees it
            backlog.popleft()
            now = time.perf_counter()
            tracer.add("worker.queue_wait", entry[3], now - entry[3],
                       uids=[d["uid"] for d in entry[0].get("reqs", [])],
                       batch_id=entry[0].get("batch_id"))
            if leader:
                peer.send_json({"type": "ack",
                                "batch_id": entry[0].get("batch_id")})
        if eng.has_work:
            for c in eng.step():
                if leader:
                    peer.send_json(_completion_to_wire(c))
        now = time.perf_counter()
        if now - last_hb >= heartbeat_s:
            last_hb = now
            hb_msg = {
                "type": "hb", "inflight": eng.num_active,
                "handoff_backlog": len(backlog),
                "clock": now,
                "stage_seconds": eng.stage_seconds,
                "metrics": get_registry().snapshot(), **tag}
            if leader:
                dig = eng.prefix_digest()
                if dig is not None:
                    hb_msg["digest"] = dig
            peer.send_json(hb_msg)
    peer.send_json(_stats_frame(eng, counters,
                                max_handoff_backlog=max_backlog, **tag))


def main(argv) -> int:
    role, index, port, spec_path = (
        argv[0], int(argv[1]), int(argv[2]), argv[3])
    incarnation = int(argv[4]) if len(argv) > 4 else 0
    generation = int(argv[5]) if len(argv) > 5 else 0
    # tp-group membership (docs/SERVING.md §13): the G member processes of
    # one decode replica form a private torch.distributed group, joined
    # after the hello (so a member that cannot join dies as a known peer)
    group_size = int(os.environ.get("PROGEN_TPU_TP_GROUP_SIZE", "1"))
    group_rank = int(os.environ.get("PROGEN_TPU_TP_GROUP_RANK", "0"))
    with open(spec_path) as fh:
        spec = json.load(fh)

    from progen_tpu_torch.core.device import resolve_device
    from progen_tpu_torch.decode.graphs import launch_counts
    from progen_tpu_torch.observe.trace import (
        configure_tracing,
        get_tracer,
        trace_dump_path,
    )
    from progen_tpu_torch.observe.transport import TransportCounters
    from progen_tpu_torch.serve.transport import Peer, connect

    # a worker told "cuda" on a machine without a card exits here, before
    # its hello: it never runs on the CPU on its own
    device = resolve_device(spec.get("device", "cuda"))
    if device.type == "cpu":
        torch.set_num_threads(1)
    tcfg = spec.get("trace")
    if tcfg:
        configure_tracing(enabled=True, capacity=tcfg.get("capacity"),
                          process=f"{role}:{index}")

    counters = TransportCounters()

    # the introspection server comes up BEFORE the engine build so /healthz
    # answers (phase "building") during the build and the kernels' first
    # use; its port rides the hello frame for the driver's endpoint map
    statusz_srv = None
    holder: dict = {"phase": "connecting"}
    if spec.get("statusz"):
        from progen_tpu_torch.observe.statusz import StatuszServer

        def _health():
            out = {"phase": holder["phase"],
                   "transport": counters.as_dict()}
            eng_ = holder.get("eng")
            if eng_ is not None:
                out["pending"] = eng_.pending
                out["active"] = eng_.num_active
            return out

        def _status():
            eng_ = holder.get("eng")
            return (eng_.status() if eng_ is not None
                    else {"phase": holder["phase"]})

        statusz_srv = StatuszServer(
            role=role, index=index,
            providers={"health": _health, "status": _status})
        statusz_srv.start()

    sock = connect(port)
    peer = Peer(sock, counters)
    peer.role, peer.index = role, index
    # the clock echo lets the driver estimate this process's perf_counter
    # offset, so merged trace timelines are causally ordered
    hello = {"type": "hello", "role": role, "index": index,
             "generation": generation,
             "clock": time.perf_counter()}
    if statusz_srv is not None:
        hello["statusz_port"] = statusz_srv.port
    peer.send_json(hello)

    t0 = time.perf_counter()
    if group_size > 1:
        holder["phase"] = "joining"
        device = join_group(device, group_size, group_rank,
                            int(os.environ["PROGEN_TPU_TP_GROUP_PORT"]))
        print(f"worker {role}:{index} joined its group as rank {group_rank} of "
              f"{group_size} ({torch.distributed.get_backend()})", flush=True)
    print(f"worker {role}:{index} building engine", flush=True)
    holder["phase"] = "building"
    eng = build_engine_from_spec(
        spec, remote_prefill=(role == "decode" or role.startswith("dshard")),
        group_size=group_size)
    eng.generation = generation
    warm = {}
    if spec.get("aot_warmup"):
        # warm-before-routable: the ready frame is what makes a scaled-up
        # worker placeable, so every capture lands before it
        holder["phase"] = "warming"
        warm = eng.aot_warmup(max_prime=spec.get("warmup_max_prime"))
    if group_size > 1:
        # group barrier before ANY member reports ready: the leader's ready
        # frame means the whole replica can run its collectives
        _group_all_ok(True)
    build_s = time.perf_counter() - t0
    print(f"worker {role}:{index} engine ready in {build_s:.1f}s", flush=True)
    holder["eng"] = eng
    holder["phase"] = "serving"
    ready = {"type": "ready", "build_s": build_s, "generation": generation}
    if warm:
        ready["warmup"] = warm
    # the exit line counts the launches of serving, not of the build or
    # the warm-up (a capture's eager warm-up runs the kernels)
    served_from = launch_counts()
    peer.send_json(ready)

    inbox: _queue.Queue = _queue.Queue()
    peer.start_reader(inbox)
    hb = float(spec.get("heartbeat_s", 1.0))
    if role == "prefill":
        window = max(1, int(spec.get("engine", {}).get("handoff_depth", 2)))
        _prefill_loop(eng, peer, inbox, counters,
                      heartbeat_s=hb, window=window,
                      incarnation=incarnation, generation=generation)
    elif group_size > 1:
        _group_decode_loop(eng, peer, inbox, counters, heartbeat_s=hb,
                           group_rank=group_rank, group_size=group_size)
    else:
        _decode_loop(eng, peer, inbox, counters, heartbeat_s=hb)
    if tcfg and tcfg.get("dir"):
        try:
            get_tracer().dump(trace_dump_path(tcfg["dir"], f"{role}:{index}"))
        except OSError as e:
            print(f"worker {role}:{index} trace dump failed: {e}",
                  file=sys.stderr, flush=True)
    on_card = eng.device.type == "cuda"
    print(json.dumps({
        "worker_exit": f"{role}:{index}",
        "device": str(eng.device),
        **({"group_rank": group_rank, "group_size": group_size}
           if group_size > 1 else {}),
        "launches": kernel_launches(served_from),
        "peak_bytes": torch.cuda.max_memory_allocated(eng.device) if on_card else None,
        "build_s": build_s,
        "warmup": warm or None,
        "stage_seconds": eng.stage_seconds,
        "transport": counters.as_dict()}), flush=True)
    print(f"worker {role}:{index} exiting", flush=True)
    if statusz_srv is not None:
        statusz_srv.stop()
    peer.close()
    if group_size > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
