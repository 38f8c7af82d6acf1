"""ServeCluster: spawn, route, supervise the multi-process topology (ported
from progen_tpu/serve/cluster.py).

The cluster lives in the DRIVER process (``sample --serve_procs``, tests,
``chip_smoke.py``) and owns:

- the listener socket plus one :class:`Peer` per worker (reader threads
  push events onto one queue: the transport side, allowed to wait);
- the :class:`Router` policy state (the admission side, which never
  touches a tensor);
- the :class:`StageSupervisor` restart budget.

Failure semantics: a dead stage maps to exactly the requests whose work it
held; those are re-dispatched through the normal path (a replay is
token-identical by per-request seed determinism) or shed as typed
``FAILED_FAULT`` completions when the stage cannot come back.  Survivor
requests never notice.  Corrupt handle frames (payload CRC) are reported by
the replica and replayed the same way.

The workers are ``python -m progen_tpu_torch.serve.worker`` processes with
the repo root on their ``PYTHONPATH``; on the card they all run on
``cuda:0`` (the spec's ``device``), each in its own CUDA context.

The fleet is elastic (``serve/control.py`` drives it): workers join at fresh
indices (warm before they are routable), leave with zero sheds (fenced,
drained, retired), and a new weight GENERATION rolls in beside the old one;
every completion carries the generation that primed it.  With
``tp_group=G > 1`` each decode replica is a tensor-parallel GROUP of ``G``
processes (``serve/worker.py``'s lockstep loop): the driver re-frames each
handle into ``G`` slab frames (``decode/handoff.py:split_handle_frame``),
and the group lives, dies and respawns as one.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from progen_tpu_torch.decode.engine import (
    DRAIN_TIMEOUT,
    FAILED_FAULT,
    SHED_DEADLINE,
    Completion,
    Request,
)
from progen_tpu_torch.decode.handoff import (
    FrameCorrupt,
    request_to_wire,
    split_handle_frame,
    unpack_frame,
)
from progen_tpu_torch.observe import metrics as _metrics
from progen_tpu_torch.observe import trace as _trace
from progen_tpu_torch.observe.transport import TransportCounters
from progen_tpu_torch.resilience.supervise import StageSupervisor
from progen_tpu_torch.serve.router import Router
from progen_tpu_torch.serve.transport import Peer

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent


def _completion_from_wire(header: dict, submit_time: float,
                          finish_time: float) -> Completion:
    """Wire message -> Completion."""
    emb = header.get("embedding")
    return Completion(
        uid=header["uid"],
        prime=np.asarray(header.get("prime", []), np.int32),
        tokens=np.asarray(header.get("tokens", []), np.int32),
        finish_reason=header["finish_reason"],
        submit_time=submit_time, finish_time=finish_time,
        status=header.get("status", "ok"),
        embedding=None if emb is None else np.asarray(emb, np.float32),
        worker_latency=float(header.get("worker_latency", 0.0)))


def _shed_completion(request, status: str, now: float) -> Completion:
    return Completion(
        uid=request.uid,
        prime=np.asarray(list(request.tokens), np.int32),
        tokens=np.asarray([], np.int32),
        finish_reason=status, submit_time=request.submit_time,
        finish_time=now, status=status)


def _deadline_of(request) -> float | None:
    if request.deadline is not None:
        return request.deadline
    if request.ttl is not None:
        return request.submit_time + request.ttl
    return None


def _free_port() -> int:
    """A free loopback port for a tp-group's private ``torch.distributed``
    store (the usual bind-then-close probe; each group incarnation gets a
    fresh one so a respawn never collides with a lingering dead group)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _split_group_frame(frame, group_size: int) -> list:
    """Full handle frame -> per-member slab frames (numpy on the received
    bytes, no tensor).  Validates the frame CRCs: raises
    :class:`FrameCorrupt` on a frame that must not be forwarded."""
    header, payload = unpack_frame(frame)
    return split_handle_frame(header, payload, group_size)


class ServeCluster:
    """N prefill workers + R decode replicas behind one router.

    With ``tp_group=G > 1`` each decode replica is a GROUP of G member
    processes forming one tensor-parallel engine (docs/SERVING.md §13;
    ``serve/worker.py``'s lockstep loop on a private ``torch.distributed``
    group):
    the leader keeps the ``("decode", r)`` key, followers are
    ``("dshard<k>", r)``.  The router still sees ONE replica per group —
    handle frames are split into per-member slabs at relay time, and a
    group lives and dies atomically (any member death fails the whole
    group; respawn brings back all G members on a fresh store port).
    ``G`` must divide the model's tensor-split dims
    (``parallel/sharding.validate_tp_divisibility``), checked before any
    process starts."""

    # class-level default so bare stand-ins built around __new__ (test
    # fixtures, controlz fakes) read as ungrouped fleets
    tp_group = 1

    def __init__(self, spec: dict, *, prefill_procs: int = 1,
                 replicas: int = 1, supervisor: StageSupervisor | None = None,
                 spawn_timeout: float = 300.0, stale_after: float = 300.0,
                 log_dir: str | None = None, route_by_cache: bool = True,
                 tp_group: int = 1):
        self.tp_group = max(1, int(tp_group))
        if self.tp_group > 1:
            from progen_tpu_torch.models.progen import ProGenConfig
            from progen_tpu_torch.parallel.sharding import validate_tp_divisibility

            validate_tp_divisibility(ProGenConfig.from_dict(spec["config"]),
                                     self.tp_group)
        self.spec = spec
        self.prefill_procs = prefill_procs
        self.replicas = replicas
        self.supervisor = supervisor or StageSupervisor(max_restarts=1)
        self.stale_after = stale_after
        self.counters = TransportCounters()  # router-side, all peers
        self.router = Router(prefill_procs, replicas,
                             route_by_cache=route_by_cache)
        self._ttft: dict = {}                # uid -> driver-clock TTFT (s)
        self._cache_counts: dict = {}        # replica -> (hits, lookups)
        self.completions: dict = {}          # uid -> Completion
        self._new: list[Completion] = []
        self._events: _queue.Queue = _queue.Queue()
        self._peers: dict = {}               # (role, idx) -> Peer
        self._procs: dict = {}               # (role, idx) -> Popen
        self._incarnations: dict = {}        # (role, idx) -> spawn count
        self._handled_dead: set = set()
        self._respawning: set = set()
        self._parked_uids: list = []
        # elastic control-plane state: the fleet and its weights are
        # MUTABLE — see add_worker/fence_worker/retire_worker and
        # begin_generation (serve/control.py drives these)
        self.generation = 0                  # current weight generation
        self._worker_gen: dict = {}          # (role, idx) -> generation
        self._worker_spec: dict = {}         # (role, idx) -> spec Path
        self._retiring: set = set()          # planned exits (no restart)
        self._pending_routable: set = set()  # spawned, awaiting ready
        self._next_idx = {"prefill": prefill_procs, "decode": replicas}
        self._worker_stats: dict = {}
        self._stats_age: dict = {}           # (role, idx) -> capture clock
        self._hb: dict = {}
        self._clock_offsets: dict = {}       # (role, idx) -> min offset (s)
        self._statusz_ports: dict = {}       # (role, idx) -> loopback port
        self._tracer = _trace.get_tracer()
        registry = _metrics.get_registry()
        self._lat = registry.histogram("cluster.latency_s")
        # goodput accounting: served vs typed-shed completions — the two
        # counters the ratio-kind SLO specs divide
        self._ok_ctr = registry.counter("cluster.completions_ok")
        self._shed_ctr = registry.counter("cluster.completions_shed")
        self._shutting_down = False
        # live introspection plane (spec["statusz"]): the driver serves
        # the FLEET view — per-worker registry snapshots (riding the
        # heartbeat/stats frames already) merged bucket-for-bucket with
        # its own registry, plus multi-window SLO burn rates
        self._statusz = None
        self._statusz_providers: dict = {}
        self._slo = None
        self._slo_last = 0.0
        if spec.get("statusz"):
            from progen_tpu_torch.observe.slo import BurnRateTracker, SLOSpec
            from progen_tpu_torch.observe.statusz import StatuszServer

            self._slo = BurnRateTracker((
                SLOSpec(name="latency_p95_2s", target=0.95,
                        metric="cluster.latency_s", threshold_s=2.0),
                SLOSpec(name="goodput", target=0.99, kind="ratio"),
            ))
            self._statusz_providers.update({
                "health": self._statusz_health,
                "status": self._statusz_status,
                "metrics": self.fleet_metrics})
            self._statusz = StatuszServer(
                role="driver", providers=self._statusz_providers)
            self._statusz.start()

        self._tmp = tempfile.TemporaryDirectory(prefix="progen_serve_")
        self.log_dir = Path(log_dir) if log_dir else Path(self._tmp.name)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._spec_path = Path(self._tmp.name) / "spec.json"
        self._spec_path.write_text(json.dumps(spec))
        self._spec_paths = {0: self._spec_path}  # generation -> spec file
        for i in range(prefill_procs):
            self._worker_gen[("prefill", i)] = 0
        for i in range(replicas):
            for key in self._group_members(i):
                self._worker_gen[key] = 0

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(prefill_procs + replicas * self.tp_group + 4)
        self.port = self._listener.getsockname()[1]
        self._accepting = True
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True, name="serve-accept")
        self._acceptor.start()

        try:
            for i in range(prefill_procs):
                self._spawn("prefill", i)
            for i in range(replicas):
                if self.tp_group > 1:
                    self._spawn_group(i)
                else:
                    self._spawn("decode", i)
            self._wait_workers(spawn_timeout)
        except Exception:
            self.shutdown(collect_stats=False)
            raise

    # ------------------------------------------------------------- processes

    def _worker_env(self) -> dict:
        """The driver's environment with the repo root first on
        ``PYTHONPATH`` (a worker runs ``-m progen_tpu_torch.serve.worker``
        from the root)."""
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_REPO_ROOT)] + ([env["PYTHONPATH"]]
                                 if env.get("PYTHONPATH") else []))
        return env

    def _spawn(self, role: str, idx: int,
               group: tuple | None = None) -> None:
        # the incarnation nonce rides in every batch id the worker
        # mints: a respawn restarts batch_seq at 0, and without the
        # nonce its ids would collide with the dead incarnation's
        # entries still in the router's bookkeeping
        inc = self._incarnations.get((role, idx), 0)
        self._incarnations[(role, idx)] = inc + 1
        # a worker is pinned to the spec AND generation it was created
        # under — a respawn during a rolling swap must come back on the
        # same weights, or its replays would cross generations
        gen = self._worker_gen.setdefault((role, idx), self.generation)
        spec_path = self._worker_spec.get(
            (role, idx), self._spec_paths.get(gen, self._spec_path))
        log_path = self.log_dir / f"{role}_{idx}.log"
        log = open(log_path, "a")
        env = self._worker_env()
        if group is not None:
            size, rank, gport = group
            env["PROGEN_TPU_TP_GROUP_SIZE"] = str(size)
            env["PROGEN_TPU_TP_GROUP_RANK"] = str(rank)
            env["PROGEN_TPU_TP_GROUP_PORT"] = str(gport)
        proc = subprocess.Popen(
            [sys.executable, "-m", "progen_tpu_torch.serve.worker",
             role, str(idx), str(self.port), str(spec_path),
             str(inc), str(gen)],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=str(_REPO_ROOT))
        log.close()
        self._procs[(role, idx)] = proc

    def _group_members(self, idx: int) -> list:
        """Member keys of decode replica ``idx``, leader first (a
        one-element list when tp-grouping is off)."""
        return [("decode", idx)] + [(f"dshard{k}", idx)
                                    for k in range(1, self.tp_group)]

    def _is_group_role(self, role) -> bool:
        return self.tp_group > 1 and isinstance(role, str) and (
            role == "decode" or role.startswith("dshard"))

    def _spawn_group(self, idx: int) -> None:
        """Spawn ALL member processes of tp-group replica ``idx``; the
        group coordinator port is allocated fresh per incarnation."""
        gport = _free_port()
        for rank, (role, _) in enumerate(self._group_members(idx)):
            self._spawn(role, idx, group=(self.tp_group, rank, gport))

    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = Peer(sock, self.counters)
            peer.start_reader(self._events)

    def _log_tail(self, role: str, idx: int, n: int = 30) -> str:
        path = self.log_dir / f"{role}_{idx}.log"
        try:
            lines = path.read_text().splitlines()
        except OSError:
            return "<no log>"
        return "\n".join(lines[-n:])

    def _wait_workers(self, timeout: float) -> None:
        """Pump until every spawned worker said hello."""
        deadline = time.perf_counter() + timeout
        want = self.prefill_procs + self.replicas * self.tp_group
        while len(self._peers) < want:
            if time.perf_counter() > deadline:
                raise RuntimeError(
                    f"cluster handshake timed out: {len(self._peers)}/"
                    f"{want} workers connected")
            for (role, idx), proc in self._procs.items():
                if proc.poll() is not None and (role, idx) not in self._peers:
                    raise RuntimeError(
                        f"worker {role}:{idx} exited rc={proc.returncode} "
                        f"before hello\n--- log tail ---\n"
                        f"{self._log_tail(role, idx)}")
            self._pump(0.2)

    def wait_ready(self, timeout: float = 600.0) -> None:
        """Pump until every live worker sent its ready frame (its engine
        built, and warmed under the spec's ``aot_warmup``); a worker that
        dies first raises with its log's tail.  Requests may be submitted
        before: they queue on the workers."""
        deadline = time.perf_counter() + timeout
        while not all(p.ready for p in self._peers.values()):
            for (role, idx), proc in self._procs.items():
                if (proc.poll() is not None
                        and (role, idx) not in self._handled_dead):
                    raise RuntimeError(
                        f"worker {role}:{idx} exited rc={proc.returncode} "
                        f"before ready\n--- log tail ---\n"
                        f"{self._log_tail(role, idx)}")
            if time.perf_counter() > deadline:
                raise RuntimeError(f"workers not ready after {timeout}s")
            self._pump(0.1)

    def kill_worker(self, role: str, idx: int) -> None:
        """SIGKILL a stage instance (chaos testing)."""
        proc = self._procs.get((role, idx))
        if proc is not None and proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)

    # ------------------------------------------------------- elastic verbs
    # The control plane (serve/control.py) mutates fleet membership and
    # weights through these.  Indices are allocated monotonically and
    # NEVER reused: batch ids stay unique, supervision budgets stay per
    # physical instance, and a retired index can't alias a future one.

    def begin_generation(self, spec: dict) -> int:
        """Register a new weight generation (new checkpoint / LoRA bank
        in ``spec``); workers spawned afterwards serve it.  Existing
        workers keep their own generation — the swap is a rolling
        replace, not an in-place reload."""
        gen = self.generation + 1
        path = Path(self._tmp.name) / f"spec_gen{gen}.json"
        path.write_text(json.dumps(spec))
        self._spec_paths[gen] = path
        self.generation = gen
        self._tracer.event("cluster.generation", generation=gen)
        return gen

    def add_worker(self, role: str, *, generation: int | None = None,
                   warm: bool = True) -> int:
        """Spawn one more stage instance at a fresh index.  The worker
        is NOT routable until its ready frame arrives (with ``warm``,
        the spec forces :meth:`ServingEngine.aot_warmup` before ready —
        warm-before-routable, so scale-up capacity never serves cold).
        Returns the new index; :meth:`wait_routable` blocks on it."""
        gen = self.generation if generation is None else int(generation)
        idx = self._next_idx[role]
        self._next_idx[role] = idx + 1
        key = (role, idx)
        grouped = role == "decode" and self.tp_group > 1
        member_keys = self._group_members(idx) if grouped else [key]
        for k in member_keys:
            self._worker_gen[k] = gen
        if warm:
            base_path = self._spec_paths.get(gen, self._spec_path)
            warm_path = Path(self._tmp.name) / f"spec_gen{gen}_warm.json"
            if not warm_path.exists():
                wspec = json.loads(base_path.read_text())
                wspec["aot_warmup"] = True
                warm_path.write_text(json.dumps(wspec))
            for k in member_keys:
                self._worker_spec[k] = warm_path
        # only the LEADER key gates routability: its ready frame sits
        # behind the group barrier, so leader-ready means group-ready
        self._pending_routable.add(key)
        if role == "prefill":
            self.prefill_procs += 1
        else:
            self.replicas += 1
        self._tracer.event("cluster.scale_up", role=role, idx=idx,
                           generation=gen)
        if grouped:
            self._spawn_group(idx)
        else:
            self._spawn(role, idx)
        return idx

    def wait_routable(self, role: str, idx: int,
                      timeout: float = 300.0) -> None:
        """Pump until the scaled-up worker's ready frame made it
        routable (raises on timeout or if it died before ready without
        a restart grant)."""
        key = (role, idx)
        deadline = time.perf_counter() + timeout
        while key in self._pending_routable:
            if time.perf_counter() > deadline:
                raise RuntimeError(
                    f"worker {role}:{idx} not routable after {timeout}s"
                    f"\n--- log tail ---\n{self._log_tail(role, idx)}")
            proc = self._procs.get(key)
            if (proc is not None and proc.poll() is not None
                    and key in self._handled_dead
                    and key not in self._respawning):
                raise RuntimeError(
                    f"worker {role}:{idx} died before ready\n"
                    f"--- log tail ---\n{self._log_tail(role, idx)}")
            self._pump(0.1)

    def fence_worker(self, role: str, idx: int) -> None:
        """Stop routing NEW work to a stage instance; its in-flight
        work continues (the drain half of retire/swap)."""
        self.router.fence_worker(role, idx)
        self._tracer.event("cluster.fence", role=role, idx=idx)

    def retire_worker(self, role: str, idx: int, *,
                      timeout: float = 120.0) -> None:
        """Gracefully remove a stage instance with ZERO sheds: fence it,
        send shutdown (the worker loop finishes every queued request and
        ships the results before exiting), then wait for its EOF — the
        dead-peer path sees the planned exit, requeues any leftovers
        through the replay machinery, and removes it everywhere.  On
        timeout the worker is killed; its uids still replay."""
        key = (role, idx)
        self.router.fence_worker(role, idx)
        self._tracer.event("cluster.retire", role=role, idx=idx,
                           generation=self._worker_gen.get(key, 0))
        if key in self._handled_dead and key not in self._respawning:
            # already dead with no respawn in flight: nothing to drain
            self._finalize_retire(role, idx)
            return
        self._retiring.add(key)
        told: set = set()  # peer objects already sent shutdown
        deadline = time.perf_counter() + timeout
        killed = False
        while key in self._retiring:
            peer = self._peers.get(key)
            if peer is not None and peer.alive and id(peer) not in told:
                # covers the initial send AND a respawn that raced the
                # retire (its fresh peer needs the shutdown too)
                told.add(id(peer))
                peer.send_json({"type": "shutdown"})
            if not killed and time.perf_counter() > deadline:
                killed = True
                self.kill_worker(role, idx)
            elif killed and time.perf_counter() > deadline + 10.0:
                # no EOF arrived (e.g. the worker never connected):
                # finalize the bookkeeping directly
                self._finalize_retire(role, idx)
                break
            self._pump(0.05)

    def _finalize_retire(self, role: str, idx: int) -> None:
        """Remove a retired instance from every bookkeeping structure;
        any uids it still held replay through the normal path (typed
        sheds only if the whole stage is gone)."""
        key = (role, idx)
        self._retiring.discard(key)
        self._pending_routable.discard(key)
        if role == "decode":
            for bid in self.router.unacked_batches(idx):
                self._return_credit(bid)
        affected = self.router.fail_worker(role, idx)
        self.router.retire_worker(role, idx)
        self.supervisor.forget(role, idx)
        self._worker_spec.pop(key, None)
        self._worker_gen.pop(key, None)
        if role == "decode" and self.tp_group > 1:
            # followers share the leader's fate: drop their pins too
            for k in self._group_members(idx)[1:]:
                self._worker_spec.pop(k, None)
                self._worker_gen.pop(k, None)
        if role == "prefill":
            self.prefill_procs -= 1
        else:
            self.replicas -= 1
        self._tracer.event("cluster.retired", role=role, idx=idx,
                           replayed=len(affected))
        now = time.perf_counter()
        for uid in affected:
            self._dispatch(uid, now)

    # -------------------------------------------------------------- frontend

    def submit(self, request: Request) -> None:
        """Route one request to a prefill worker; deadline- and
        availability-sheds produce typed completions, never raises for
        operational conditions (mirrors ``ServingEngine.submit``)."""
        if request.uid in self.router.requests:
            raise ValueError(f"duplicate uid {request.uid!r}")
        self._pump(0.0)
        now = time.perf_counter()
        self.router.requests[request.uid] = request
        self.router.submit_times[request.uid] = now
        self._dispatch(request.uid, now)
        self._tracer.add("cluster.submit", now,
                         time.perf_counter() - now, trace=request.uid)

    def submit_embed(self, request: Request) -> None:
        """Route one EMBEDDING request.  Embed traffic is its own request
        class: it rides a prefill worker's engine (prefill-shaped
        forward, no decode slots, no handle), so the router's prefill
        stage bookkeeping covers its whole lifecycle — completion,
        requeue-on-death, shedding all reuse the generate paths."""
        request.workload = "embed"
        self.submit(request)

    def _dispatch(self, uid, now: float) -> None:
        request = self.router.requests[uid]
        deadline = _deadline_of(request)
        if deadline is not None and now > deadline:
            self._shed(uid, SHED_DEADLINE, now)
            return
        w = self.router.pick_prefill(
            priority=getattr(request, "priority", 0))
        if w is None:
            if any(k[0] == "prefill" for k in self._respawning):
                self._parked_uids.append(uid)
                return
            self._shed(uid, FAILED_FAULT, now)
            return
        self.router.assign_prefill(uid, request, w, now)
        self._tracer.event("cluster.place", trace=uid, worker=w)
        peer = self._peers.get(("prefill", w))
        if peer is None or not peer.alive:
            # raced a death the event queue has not surfaced yet; the
            # dead-peer path will pick the uid up via fail_worker
            return
        kind = "embed_req" if getattr(request, "workload",
                                      "generate") == "embed" else "req"
        peer.send_json({"type": kind,
                        "req": request_to_wire(request, now=now)})

    def _shed(self, uid, status: str, now: float) -> None:
        request = self.router.requests[uid]
        if not self.router.complete(uid):
            return
        comp = _shed_completion(request, status, now)
        comp.generation = self.router.generation_of(uid)
        self.completions[uid] = comp
        self._new.append(comp)
        self._shed_ctr.inc()

    def poll(self, timeout: float = 0.0) -> list[Completion]:
        """Process transport events for up to ``timeout`` seconds;
        returns completions that arrived since the last poll."""
        self._pump(timeout)
        out, self._new = self._new, []
        return out

    @property
    def pending(self) -> int:
        return len(self.router.requests) - len(self.router.completed)

    def drain(self, timeout: float = 600.0) -> list[Completion]:
        """Block until every submitted request has completed (served or
        typed-shed); returns ALL completions sorted by uid.

        ``timeout`` is a hard bound: past it every still-open request is
        answered with a typed ``DRAIN_TIMEOUT`` completion instead of
        raising — a wedged worker can no longer stall drain (and thus
        retire/scale-down, which requires bounded drain) forever.  The
        exactly-once contract holds: a late real completion for a
        timed-out uid is dropped by the router's dedup."""
        deadline = time.perf_counter() + timeout
        while self.pending > 0:
            if time.perf_counter() > deadline:
                now = time.perf_counter()
                stuck = [uid for uid in self.router.requests
                         if uid not in self.router.completed]
                for uid in stuck:
                    self._shed(uid, DRAIN_TIMEOUT, now)
                self._tracer.event("cluster.drain_timeout",
                                   timeout_s=timeout, shed=len(stuck))
                break
            self._pump(0.1)
        # freshness flush: ask every live worker for a stats/metrics
        # frame NOW, so post-drain stats() reflects the drained state
        # rather than the last pre-drain heartbeat snapshot
        t_req = time.perf_counter()
        live = [k for k, p in self._peers.items() if p.alive]
        for k in live:
            self._peers[k].send_json({"type": "stats_req"})
        flush_deadline = min(deadline, t_req + 5.0)
        while any(self._stats_age.get(k, -1.0) < t_req for k in live
                  if self._peers.get(k) is not None
                  and self._peers[k].alive):
            if time.perf_counter() > flush_deadline:
                break
            self._pump(0.05)
        return [self.completions[uid] for uid in self.router.requests
                if uid in self.completions]

    # ------------------------------------------------------------ event loop

    def _pump(self, timeout: float) -> None:
        block = timeout > 0.0
        deadline = time.perf_counter() + timeout
        while True:
            try:
                if block:
                    wait = max(0.0, deadline - time.perf_counter())
                    ev = self._events.get(timeout=wait) if wait else \
                        self._events.get_nowait()
                else:
                    ev = self._events.get_nowait()
            except _queue.Empty:
                break
            block = False  # block at most once per pump
            self._handle_event(ev)
        self._check_stale()

    def _handle_event(self, ev) -> None:
        kind, peer = ev[0], ev[1]
        if kind == "dead":
            self._on_peer_dead(peer, ev[2])
            return
        header, frame = ev[2], ev[3]
        t = header.get("type")
        if t == "hello":
            self._on_hello(peer, header)
        elif t == "hb":
            self._note_clock(peer.role, peer.index, header.get("clock"))
            header["age_clock"] = time.perf_counter()
            self._hb[(peer.role, peer.index)] = header
            if peer.role == "decode" and "digest" in header:
                self._note_cache_frame(peer.index, header,
                                       header["age_clock"])
        elif t == "ready":
            # staleness starts here: until ready, the worker is inside its
            # engine build (and warm-up), which sends no heartbeats
            peer.ready = True
            key = (peer.role, peer.index)
            if key in self._pending_routable:
                # warm-before-routable: a scaled-up worker joins the
                # routable set only now — its compiles are behind it
                self._pending_routable.discard(key)
                self.router.add_worker(
                    peer.role, peer.index,
                    self._worker_gen.get(key, 0))
                self._tracer.event(
                    "cluster.routable", role=peer.role, idx=peer.index,
                    generation=self._worker_gen.get(key, 0))
                parked, self._parked_uids = self._parked_uids, []
                now = time.perf_counter()
                for uid in parked:
                    self._dispatch(uid, now)
        elif t == "handle":
            self._on_handle(peer, header, frame)
        elif t == "ack":
            self._return_credit(header.get("batch_id"))
        elif t == "bad_frame":
            # payload CRC failed at the replica: typed recovery — the
            # batch's credit goes home and the named requests replay
            # through the normal path
            self._return_credit(header.get("batch_id"))
            now = time.perf_counter()
            for uid in self.router.requeue(header.get("uids", [])):
                self._dispatch(uid, now)
        elif t == "completion":
            uid = header.get("uid")
            if self.router.complete(uid):
                now = time.perf_counter()
                submit = self.router.submit_times.get(uid, 0.0)
                comp = _completion_from_wire(header, submit, now)
                # a uid's generation is the one that PRIMED it (router
                # bookkeeping), not whatever the cluster serves now —
                # in-flight requests finish on their own generation
                comp.generation = self.router.generation_of(uid)
                ttft = self._ttft.pop(uid, None)
                if ttft is not None and submit:
                    comp.first_token_time = submit + ttft
                self.completions[uid] = comp
                self._new.append(comp)
                # the one end-to-end latency code path
                self._lat.observe(now - submit if submit else 0.0)
                if header.get("status", "ok") == "ok":
                    self._ok_ctr.inc()
                else:
                    self._shed_ctr.inc()
                self._tracer.event("cluster.done", trace=uid,
                                   latency_s=now - submit)
        elif t == "stats":
            self._note_clock(peer.role, peer.index, header.get("clock"))
            self._worker_stats[(peer.role, peer.index)] = header
            self._stats_age[(peer.role, peer.index)] = time.perf_counter()
            if peer.role == "decode" and "digest" in header:
                self._note_cache_frame(
                    peer.index, header,
                    self._stats_age[(peer.role, peer.index)])

    def _on_hello(self, peer: Peer, header: dict) -> None:
        role, idx = header.get("role"), header.get("index", -1)
        peer.role, peer.index = role, idx
        self._peers[(role, idx)] = peer
        if header.get("statusz_port"):
            self._statusz_ports[(role, idx)] = header["statusz_port"]
        # a dead-but-not-yet-restarted stage is visible here before the
        # supervisor acts: up{role,idx} flips 0 in _on_peer_dead and back
        # to 1 on the respawn's hello — mirrored as a tracer event so
        # fleet-membership transitions land on the merged timeline
        _metrics.get_registry().gauge(
            _metrics.labeled("cluster.up", role=role, idx=idx)).set(1.0)
        self._tracer.event("cluster.up", role=role, idx=idx, up=1,
                           generation=header.get("generation", 0))
        self._note_clock(role, idx, header.get("clock"))
        if (role, idx) in self._respawning:
            self._respawning.discard((role, idx))
            self._handled_dead.discard((role, idx))
            if self._is_group_role(role):
                # a tp-group revives as a unit, keyed by its leader:
                # only when the LAST member's hello lands (the group
                # engine needs every member for its collectives)
                if (("decode", idx) not in self._pending_routable
                        and not any(k in self._respawning
                                    for k in self._group_members(idx))):
                    self.router.revive_worker("decode", idx)
                    parked, self._parked_uids = self._parked_uids, []
                    now = time.perf_counter()
                    for uid in parked:
                        self._dispatch(uid, now)
            elif (role, idx) not in self._pending_routable:
                # a pre-ready scale-up respawn stays out of the routable
                # set until its own ready frame (warm-before-routable)
                self.router.revive_worker(role, idx)
                parked, self._parked_uids = self._parked_uids, []
                now = time.perf_counter()
                for uid in parked:
                    self._dispatch(uid, now)

    def _note_cache_frame(self, idx: int, header: dict, at: float) -> None:
        """Feed a decode worker's cache advertisement into the router's
        digest table, mirror its cache gauges as per-worker LABELED
        driver metrics, and refresh the derived fleet hit-rate gauge —
        so the driver's /statusz shows the fleet cache picture without
        a bench run."""
        self.router.note_digest(idx, header["digest"], at)
        m = header.get("metrics") or {}
        registry = _metrics.get_registry()
        vals = {}
        for name in ("engine.prefix_hits", "engine.prefix_lookups",
                     "engine.prefix_pages_shared",
                     "engine.pool_free_pages",
                     "engine.pool_pages_in_use"):
            snap = m.get(name)
            if isinstance(snap, dict) and "value" in snap:
                vals[name] = snap["value"]
                registry.gauge(_metrics.labeled(
                    name, role="decode", idx=idx)).set(snap["value"])
        if "engine.prefix_lookups" in vals:
            self._cache_counts[idx] = (
                vals.get("engine.prefix_hits", 0.0),
                vals["engine.prefix_lookups"])
        hits = sum(h for h, _ in self._cache_counts.values())
        lookups = sum(n for _, n in self._cache_counts.values())
        registry.gauge("cluster.fleet_prefix_hit_rate").set(
            (hits / lookups) if lookups else 0.0)

    def cache_stats(self) -> dict:
        """Fleet cache view for records and /statusz: summed per-replica
        hit counters, the router's routing tallies, and the per-replica
        cache VALUE the scale-down policy consumes."""
        hits = sum(h for h, _ in self._cache_counts.values())
        lookups = sum(n for _, n in self._cache_counts.values())
        return {
            "fleet_prefix_hits": hits,
            "fleet_prefix_lookups": lookups,
            "fleet_prefix_hit_rate": (hits / lookups) if lookups else 0.0,
            "route_by_cache": self.router.route_by_cache,
            "cache_routed": self.router.cache_routed,
            "cache_fallback": self.router.cache_fallback,
            "cache_overridden": self.router.cache_overridden,
            "replica_cache_value": self.router.cache_summary(
                time.perf_counter()),
        }

    def _note_clock(self, role, idx, clock) -> None:
        """Refine the (role, idx) worker's perf_counter offset from a
        clock echo: offset = driver_receive - worker_send overestimates
        the true offset by one network delay, so the MINIMUM over all
        echoes is the tightest causally-safe estimate (driver->worker
        ordering is preserved; docs/OBSERVABILITY.md)."""
        if clock is None:
            return
        off = time.perf_counter() - clock
        prev = self._clock_offsets.get((role, idx))
        if prev is None or off < prev:
            self._clock_offsets[(role, idx)] = off

    def _return_credit(self, batch_id) -> None:
        """Relay one ack credit to the prefill worker that produced
        ``batch_id``.  Called on replica admission AND on every path
        that drops or requeues a noted batch instead (bad frame, dead
        replica, no replica to forward to) — otherwise the producer's
        unacked window leaks a slot per event and the worker stops
        producing handles after ``handoff_depth`` of them.  The router
        yields each batch's credit exactly once, so the drop paths and
        a late replica ack cannot double-grant."""
        src = self.router.ack(batch_id)
        if src is None:
            return
        p = self._peers.get(("prefill", src))
        if p is not None and p.alive:
            p.send_json({"type": "ack", "batch_id": batch_id})

    def _on_handle(self, peer: Peer, header: dict, frame: bytes) -> None:
        t0 = time.perf_counter()
        batch_id = header.get("batch_id")
        uids = [d["uid"] for d in header.get("reqs", [])]
        self.router.note_handle(batch_id, uids, peer.index)
        # routing tags the producer stamped on the handle: another clock
        # echo to tighten the producer's offset estimate, plus two
        # desync tripwires (identity and weight generation) that surface
        # in the trace rather than changing routing — the connection and
        # the router's own bookkeeping stay authoritative
        tc = header.get("trace_ctx") or {}
        self._note_clock("prefill", peer.index, tc.get("clock"))
        src = header.get("src")
        if src is not None and src != peer.index:
            self._tracer.event("handle.src_mismatch", batch_id=batch_id,
                               claimed=src, connection=peer.index)
        gen = header.get("generation")
        noted_gen = self.router.batch_generation(batch_id)
        if gen is not None and noted_gen is not None and gen != noted_gen:
            self._tracer.event("handle.generation_skew", batch_id=batch_id,
                               header_generation=gen, noted=noted_gen)
        # the handle carries each request's first sampled token, so its
        # arrival is the driver-observed TTFT (submit and arrival are
        # both driver clock — no cross-process correction needed); a
        # replayed handle keeps the first stamp, when the token first
        # existed
        for uid in uids:
            st = self.router.submit_times.get(uid)
            if st is not None:
                self._ttft.setdefault(uid, t0 - st)
        # per-generation placement: state primed on gen-G weights may
        # only decode on a gen-G replica (swap correctness/determinism)
        tokens_batch = [self.router.requests[uid].tokens
                        for uid in uids if uid in self.router.requests]
        r = self.router.pick_replica(
            self.router.batch_generation(batch_id),
            tokens_batch=tokens_batch, now=t0)
        if r is None:
            # this batch will never reach replica admission: return its
            # credit before parking/shedding the member requests
            self._return_credit(batch_id)
            now = time.perf_counter()
            if any(k[0] == "decode" for k in self._respawning):
                # replica stage is coming back: send the requests back
                # through prefill once it does
                self._parked_uids.extend(self.router.requeue(uids))
            else:
                for uid in self.router.requeue(uids):
                    self._shed(uid, FAILED_FAULT, now)
            return
        if self.tp_group > 1:
            # tp-group relay re-frames rather than relaying verbatim, so
            # the driver validates the CRCs a lone replica would have —
            # a corrupt frame takes the bad_frame path without being
            # forwarded (the group must never see mismatched slabs)
            try:
                slabs = _split_group_frame(frame, self.tp_group)
            except FrameCorrupt:
                self._return_credit(batch_id)
                now = time.perf_counter()
                for uid in self.router.requeue(uids):
                    self._dispatch(uid, now)
                return
            self.router.forward(batch_id, r, t0)
            for k, member in enumerate(self._group_members(r)):
                mp = self._peers.get(member)
                if mp is not None and mp.alive:
                    mp.send_bytes(slabs[k])
        else:
            self.router.forward(batch_id, r, t0)
            rp = self._peers.get(("decode", r))
            if rp is not None and rp.alive:
                rp.send_bytes(frame)  # verbatim relay: payload zero-copy
        self._tracer.add("cluster.relay", t0, time.perf_counter() - t0,
                         uids=uids, batch_id=batch_id, replica=r)

    def _on_peer_dead(self, peer: Peer, reason: str) -> None:
        if peer.role is None or self._shutting_down:
            return
        key = (peer.role, peer.index)
        if key in self._handled_dead:
            return
        self._handled_dead.add(key)
        _metrics.get_registry().gauge(
            _metrics.labeled("cluster.up", role=peer.role,
                             idx=peer.index)).set(0.0)
        self._tracer.event("cluster.up", role=peer.role, idx=peer.index,
                           up=0, reason=reason)
        proc = self._procs.get(key)
        if proc is not None and proc.poll() is None:
            proc.kill()
        peer.close()
        if self._peers.get(key) is peer:
            del self._peers[key]

        if self._is_group_role(peer.role):
            self._on_group_member_dead(peer, reason)
            return

        if key in self._retiring:
            # planned exit (retire/scale-down/swap): not a failure — no
            # restart budget burned, no respawn; leftovers replay
            self._finalize_retire(peer.role, peer.index)
            return

        if peer.role == "decode":
            # batches forwarded to the dead replica but never admitted:
            # their acks will never arrive, so return each credit now
            for bid in self.router.unacked_batches(peer.index):
                self._return_credit(bid)
        affected = self.router.fail_worker(peer.role, peer.index)
        if self.supervisor.request_restart(peer.role, peer.index, reason):
            self._respawning.add(key)
            self._parked_uids.extend(
                u for u in affected if u not in self._parked_uids)
            self._spawn(peer.role, peer.index)
            # a live sibling can absorb parked work right away
            now = time.perf_counter()
            if (peer.role == "prefill" and self.router.prefill_alive) or \
                    (peer.role == "decode" and self.router.prefill_alive):
                parked, self._parked_uids = self._parked_uids, []
                for uid in parked:
                    self._dispatch(uid, now)
        else:
            now = time.perf_counter()
            for uid in affected:
                self._dispatch(uid, now)  # sheds if the stage is gone

    def _reap_member(self, key) -> None:
        """Kill/close one tp-group member as part of its group's fate
        (the member's own EOF event later early-returns on
        ``_handled_dead``)."""
        self._handled_dead.add(key)
        proc = self._procs.get(key)
        if proc is not None and proc.poll() is None:
            proc.kill()
        p = self._peers.pop(key, None)
        if p is not None:
            p.close()
        _metrics.get_registry().gauge(
            _metrics.labeled("cluster.up", role=key[0],
                             idx=key[1])).set(0.0)

    def _on_group_member_dead(self, peer: Peer, reason: str) -> None:
        """A tp-group lives and dies ATOMICALLY: one member gone means
        the group's collectives can never complete again, so every
        sibling is killed, the router fails the ONE replica the group
        was, and supervision decides ONE restart for all G members (on
        a fresh private coordinator port)."""
        r = peer.index
        if ("decode", r) in self._retiring:
            # planned drain: members exit together, but their EOFs race.
            # Followers' EOFs are noted (handled_dead) and ignored; the
            # LEADER's EOF — last to matter, it ships the final stats —
            # finalizes the whole group.
            if peer.role != "decode":
                return
            for k in self._group_members(r)[1:]:
                self._reap_member(k)
            self._finalize_retire("decode", r)
            return
        for k in self._group_members(r):
            if k != (peer.role, peer.index):
                self._reap_member(k)
                self._tracer.event("cluster.up", role=k[0], idx=k[1],
                                   up=0, reason=f"group fate: {reason}")
        # batches forwarded to the dead group but never admitted: their
        # acks will never arrive, so return each credit now
        for bid in self.router.unacked_batches(r):
            self._return_credit(bid)
        affected = self.router.fail_worker("decode", r)
        if self.supervisor.request_restart("decode", r, reason):
            for k in self._group_members(r):
                self._respawning.add(k)
            self._parked_uids.extend(
                u for u in affected if u not in self._parked_uids)
            self._spawn_group(r)
            now = time.perf_counter()
            if self.router.prefill_alive:
                parked, self._parked_uids = self._parked_uids, []
                for uid in parked:
                    self._dispatch(uid, now)
        else:
            now = time.perf_counter()
            for uid in affected:
                self._dispatch(uid, now)  # sheds if the stage is gone

    def _check_stale(self) -> None:
        if self._shutting_down:
            return
        now = time.perf_counter()
        registry = _metrics.get_registry()
        for (role, idx), hb in list(self._hb.items()):
            seen = hb.get("age_clock")
            if seen is not None:
                # per-worker heartbeat staleness as a typed gauge: a
                # wedged-but-connected stage shows a growing age here
                # before the stale_after trip
                registry.gauge(_metrics.labeled(
                    "cluster.worker_age_s", role=role, idx=idx)
                ).set(round(now - seen, 3))
        if self._slo is not None and now - self._slo_last >= 1.0:
            self._slo_last = now
            self._slo.sample(now, self.fleet_metrics())
        for key, peer in list(self._peers.items()):
            # a peer is exempt until its "ready" frame: the engine build
            # sends no heartbeats, and a slow build (the kernels' first
            # use, a warm-up) must not burn restart budget on a healthy
            # worker (a build that dies still EOFs its socket)
            if not peer.ready:
                continue
            if peer.alive and now - peer.last_seen > self.stale_after:
                self._events.put(("dead", peer,
                                  f"heartbeat stale > {self.stale_after}s"))
                peer.alive = False

    # --------------------------------------------------------------- teardown

    def shutdown(self, *, collect_stats: bool = True,
                 timeout: float = 30.0) -> dict:
        """Stop the fleet: shutdown messages, final stats collection,
        join (then kill) every child.  Returns :meth:`stats`."""
        self._shutting_down = True
        t_stop = time.perf_counter()
        for peer in list(self._peers.values()):
            if peer.alive:
                peer.send_json({"type": "shutdown"})
        if collect_stats:
            deadline = t_stop + timeout
            want = set(self._peers)
            # wait for stats CAPTURED AFTER the shutdown message — a
            # drain-time stats_req snapshot must not satisfy this, or the
            # final flush (complete transport totals) would be skipped
            while any(self._stats_age.get(k, -1.0) < t_stop for k in want):
                if time.perf_counter() > deadline:
                    break
                self._pump(0.1)
        self._accepting = False
        try:
            self._listener.close()
        except OSError:
            pass
        for key, proc in self._procs.items():
            if proc.poll() is None:
                try:
                    proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
        for peer in list(self._peers.values()):
            peer.close()
        if self._statusz is not None:
            self._statusz.stop()
        self.dump_trace()
        out = self.stats()
        self._tmp.cleanup()
        return out

    def dump_trace(self) -> str | None:
        """Write the driver's span ring (with the per-worker clock
        offsets as merge metadata) into the spec's trace dir; returns
        the dump path, or None when tracing is off."""
        tcfg = self.spec.get("trace")
        tracer = self._tracer
        if not (tcfg and tcfg.get("dir") and tracer.enabled):
            return None
        tracer.set_meta(offsets={
            f"{role}:{idx}": off
            for (role, idx), off in self._clock_offsets.items()})
        try:
            return tracer.dump(
                _trace.trace_dump_path(tcfg["dir"], tracer.process))
        except OSError as e:
            print(f"cluster: trace dump failed: {e}", file=sys.stderr)
            return None

    # ------------------------------------------------------------- statusz

    def register_statusz_provider(self, name: str, fn) -> None:
        """Expose an extra provider on the driver's statusz server (the
        control plane registers ``control`` here for ``/controlz``).
        No-op when the introspection plane is off."""
        self._statusz_providers[name] = fn

    def fleet_metrics(self) -> dict:
        """Fleet-merged registry snapshot: the driver's own registry plus
        the freshest per-worker snapshot (final stats frame or heartbeat,
        whichever arrived later) — counters/gauges summed, histograms
        merged bucket-for-bucket.  This is what the driver's /metricsz
        serves and what the SLO burn-rate tracker samples."""
        snaps = [_metrics.get_registry().snapshot()]
        for key in set(self._worker_stats) | set(self._hb):
            st = self._worker_stats.get(key)
            hb = self._hb.get(key)
            st_t = self._stats_age.get(key, -1.0)
            hb_t = hb.get("age_clock", -1.0) if hb else -1.0
            pick = st if st_t >= hb_t else hb
            if pick and isinstance(pick.get("metrics"), dict):
                snaps.append(pick["metrics"])
        return _metrics.merge_snapshots(snaps)

    def _statusz_health(self) -> dict:
        now = time.perf_counter()
        peers = {}
        for (role, idx), peer in sorted(self._peers.items()):
            hb = self._hb.get((role, idx), {})
            seen = hb.get("age_clock")
            peers[f"{role}:{idx}"] = {
                "alive": peer.alive,
                "ready": peer.ready,
                "hb_age_s": (round(now - seen, 3)
                             if seen is not None else None),
            }
        return {"pending": self.pending, "peers": peers,
                "supervision": self.supervisor.stats()}

    def _statusz_status(self) -> dict:
        out = self.stats()
        # the fleet-wide view: per-worker registries merged into the
        # driver's (stats() alone reports the driver registry only)
        out["metrics"] = self.fleet_metrics()
        if self._slo is not None:
            # a scrape is a sample point: push the fresh fleet view so
            # the lifetime/burn numbers reflect this instant, not the
            # last 1s-cadence _check_stale tick (a concurrent sample
            # from the serving thread at worst 503s the scrape, which
            # the client retries)
            now = time.perf_counter()
            self._slo.sample(now, out["metrics"])
            out["slo"] = self._slo.evaluate(now)
        return out

    # ------------------------------------------------------------------ stats

    def stats(self) -> dict:
        """Aggregated cluster record fields: router policy state, the
        per-worker stats messages (stage seconds, transport counters,
        queue depths), the router's own transport counters, and the
        supervision history."""
        now = time.perf_counter()
        total = TransportCounters()
        total.merge(self.counters)
        per_worker = {}
        for (role, idx), st in sorted(self._worker_stats.items()):
            entry = {k: v for k, v in st.items() if k != "type"}
            # monotonic age of this snapshot: 0.0s means "captured just
            # now" (the drain/shutdown flush), large means stale
            captured = self._stats_age.get((role, idx))
            if captured is not None:
                entry["age_s"] = round(now - captured, 3)
            per_worker[f"{role}:{idx}"] = entry
            if "transport" in st:
                total.merge(st["transport"])
        heartbeats = {}
        for (role, idx), hb in sorted(self._hb.items()):
            entry = {k: v for k, v in hb.items() if k != "type"}
            seen = entry.pop("age_clock", None)
            if seen is not None:
                entry["age_s"] = round(now - seen, 3)
            heartbeats[f"{role}:{idx}"] = entry
        statusz_ports = {}
        if self._statusz is not None:
            statusz_ports["driver"] = self._statusz.port
        for (role, idx), p in sorted(self._statusz_ports.items()):
            statusz_ports[f"{role}:{idx}"] = p
        return {
            "topology": {"prefill_procs": self.prefill_procs,
                         "replicas": self.replicas,
                         "tp_group": self.tp_group,
                         "generation": self.generation,
                         "retiring": sorted(
                             f"{r}:{i}" for r, i in self._retiring),
                         "pending_routable": sorted(
                             f"{r}:{i}"
                             for r, i in self._pending_routable)},
            **({"statusz_ports": statusz_ports} if statusz_ports else {}),
            "router": self.router.stats(),
            "cache": self.cache_stats(),
            "router_transport": self.counters.as_dict(),
            "transport_total": total.as_dict(),
            "workers": per_worker,
            "heartbeats": heartbeats,
            "metrics": _metrics.get_registry().snapshot(),
            "clock_offsets": {
                f"{role}:{idx}": round(off, 6)
                for (role, idx), off in sorted(self._clock_offsets.items())},
            "supervision": self.supervisor.stats(),
        }
