"""The port's multi-process disaggregated serving against the JAX package's
(``tests/test_serve_multiproc.py``'s cases, run on the port): the router's
placement, credits and failure bookkeeping, stage supervision, the
cluster's event handlers on fake peers, and REAL clusters of
``progen_tpu_torch.serve.worker`` processes on the CPU.  The workers load
the JAX init's parameters (``init_seed=7``, carried across with
``compat/convert.py`` and written with the port's checkpoint store by this
module), and their tokens must equal the JAX package's single-process
disaggregated engine's, greedy and sampled, dense and paged; killed stages
replay token-identically or shed typed, never raise."""

import json
import queue as _q

import jax
import jax.numpy as jnp
import pytest
import torch

from progen_tpu.decode.engine import Request as JaxRequest
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.parallel import unbox
from progen_tpu.serve import worker as jax_worker
from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.engine import FAILED_FAULT, Request
from progen_tpu_torch.models import ProGen, ProGenConfig
from progen_tpu_torch.observe import metrics as _metrics
from progen_tpu_torch.observe import trace as _trace
from progen_tpu_torch.observe.transport import TransportCounters
from progen_tpu_torch.resilience.supervise import StageSupervisor
from progen_tpu_torch.serve import cluster as cluster_mod
from progen_tpu_torch.serve.cluster import ServeCluster
from progen_tpu_torch.serve.router import Router
from progen_tpu_torch.serve.worker import make_spec
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.step import make_train_functions

pytestmark = pytest.mark.multiproc

torch.set_num_threads(1)

# tests/test_serve_multiproc.py:35-46
KW = dict(num_tokens=32, dim=16, seq_len=24, depth=2, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE_KW = dict(num_slots=4, chunk_size=4, max_len=24, prefill_batch=2,
                 handoff_depth=2)
VARIANT_KW = {
    "dense": {},
    "paged": dict(paged=True, page_size=4, num_pages=32),
}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The JAX worker's weights of ``init_seed=7`` (its own init call),
    carried across and written as step 0 of a port checkpoint store."""
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    flax = unbox(jax.jit(model.init)(jax.random.key(7),
                                     jnp.zeros((1, JAX_CFG.seq_len), jnp.int32)))
    port = ProGen(CFG, make_policy(False), device="cpu")
    port.load_state_dict(params_from_flax(flax))
    state = make_train_functions(port, make_optimizer(1e-3)).init_state()
    path = tmp_path_factory.mktemp("ckpt") / "store"
    CheckpointStore(str(path)).save(0, state, next_seq_index=0,
                                    model_config=CFG.to_dict())
    return str(path)


def _spec(checkpoint, variant="dense"):
    return make_spec(CFG, mixed_precision=False, checkpoint_path=checkpoint,
                     device="cpu", engine={**ENGINE_KW, **VARIANT_KW[variant]})


def _requests(n=4, start=0, cls=Request):
    """Mixed greedy (odd uid) and sampled (even uid) requests."""
    return [
        cls(uid=i, tokens=[1 + i, 2, 3], max_new_tokens=6,
            top_k=(None if i % 2 else 8),
            temperature=(0.0 if i % 2 else 1.0), seed=100 + i)
        for i in range(start, start + n)
    ]


_REFERENCE_CACHE: dict = {}


def _run_reference(variant="dense", n=4):
    """The JAX package's single-process disaggregated engine
    (``build_engine_from_spec`` of its own spec, ``init_seed=7``): the
    token-identity oracle."""
    key = (variant, n)
    if key not in _REFERENCE_CACHE:
        spec = jax_worker.make_spec(JAX_CFG, mixed_precision=False, init_seed=7,
                                    engine={**ENGINE_KW, **VARIANT_KW[variant]})
        eng = jax_worker.build_engine_from_spec(spec)
        for r in _requests(n, cls=JaxRequest):
            eng.submit(r)
        _REFERENCE_CACHE[key] = {
            c.uid: [int(t) for t in c.tokens] for c in eng.run_until_idle() if c.ok}
    return _REFERENCE_CACHE[key]


# ------------------------------------------------------------- router policy


def test_router_least_loaded_placement():
    rt = Router(2, 2)
    reqs = {i: Request(uid=i, tokens=[1], max_new_tokens=10 * (i + 1))
            for i in range(4)}
    assert rt.pick_prefill() == 0
    rt.assign_prefill(0, reqs[0], 0, now=0.0)
    assert rt.pick_prefill() == 1          # least queued
    rt.assign_prefill(1, reqs[1], 1, now=0.0)
    rt.assign_prefill(2, reqs[2], rt.pick_prefill(), now=0.0)
    assert rt.prefill_load == {0: 2, 1: 1}

    rt.note_handle("0:0", [0, 2], src=0)
    assert rt.prefill_load[0] == 0
    assert rt.pick_replica() == 0
    rt.forward("0:0", 0)
    assert rt.outstanding[0] == 10 + 30    # sum of max_new_tokens
    assert rt.pick_replica() == 1          # least outstanding TOKENS
    rt.note_handle("1:0", [1], src=1)
    rt.forward("1:0", rt.pick_replica())
    assert rt.outstanding[1] == 20
    assert rt.ack("0:0") == 0 and rt.ack("nope") is None

    assert rt.complete(0) is True
    assert rt.complete(0) is False         # duplicate dropped
    assert rt.outstanding[0] == 30
    assert rt.stats()["completed"] == 1


def test_router_fail_worker_maps_dead_stage_to_exact_uids():
    rt = Router(2, 2)
    reqs = {i: Request(uid=i, tokens=[1], max_new_tokens=4) for i in range(5)}
    for i in range(4):
        rt.assign_prefill(i, reqs[i], i % 2, now=0.0)
    rt.note_handle("0:0", [0], src=0)
    rt.forward("0:0", 1)
    rt.complete(0)
    # prefill 0 now holds only uid 2; uid 0 completed, 1/3 are on worker 1
    assert rt.fail_worker("prefill", 0) == [2]
    assert rt.pick_prefill() == 1
    # replica 1 held nothing live; kill the replica stage entirely
    rt.assign_prefill(4, reqs[4], 1, now=0.0)
    rt.note_handle("1:0", [4], src=1)
    rt.forward("1:0", 0)
    assert rt.fail_worker("decode", 0) == [4]
    assert rt.outstanding[0] == 0
    rt.fail_worker("decode", 1)
    assert rt.pick_replica() is None       # whole stage down
    rt.revive_worker("decode", 0)
    assert rt.pick_replica() == 0


def test_router_batch_credit_and_pruning():
    """A batch yields exactly ONE credit ever, and its entry is pruned once
    acked and every member uid resolved."""
    rt = Router(1, 1)
    reqs = {i: Request(uid=i, tokens=[1], max_new_tokens=4) for i in range(2)}
    for i in range(2):
        rt.assign_prefill(i, reqs[i], 0, now=0.0)
    rt.note_handle("0.0:0", [0, 1], src=0)
    rt.forward("0.0:0", 0)
    assert rt.unacked_batches(0) == ["0.0:0"]
    assert rt.ack("0.0:0") == 0
    assert rt.ack("0.0:0") is None          # second ack: no double grant
    assert rt.unacked_batches(0) == []
    assert "0.0:0" in rt.batches            # member uids still open
    rt.complete(0)
    rt.complete(1)
    assert rt.batches == {}                 # acked + resolved -> pruned
    assert rt.stats()["open_batches"] == 0

    # requeue resolves membership too (bad frame / dead stage), and the
    # credit can come back through the drop path instead of an ack
    r = Request(uid="x", tokens=[1], max_new_tokens=4)
    rt.assign_prefill("x", r, 0, now=1.0)
    rt.note_handle("0.0:1", ["x"], src=0)
    rt.forward("0.0:1", 0)
    assert rt.requeue(["x"]) == ["x"]
    assert "0.0:1" in rt.batches            # credit not yet returned
    assert rt.ack("0.0:1") == 0
    assert rt.batches == {}


# ---------------------------------------- cluster handler logic (fake peers)


class _FakePeer:
    """Transport stand-in: records every frame the cluster sends."""

    def __init__(self, role, index):
        self.role, self.index = role, index
        self.alive, self.ready = True, True
        self.last_seen = 1e18    # never stale
        self.sent = []

    def send_json(self, obj):
        self.sent.append(obj)

    def send_bytes(self, frame):
        self.sent.append(("bytes", frame))

    def close(self):
        self.alive = False

    def reqs(self):
        return [m for m in self.sent if isinstance(m, dict) and m.get("type") == "req"]

    def acks(self):
        return [m for m in self.sent if isinstance(m, dict) and m.get("type") == "ack"]


def _bare_cluster(prefill=1, replicas=1, max_restarts=0):
    """A ServeCluster with fake peers and no subprocesses: drives the event
    handlers directly (the real fleet's paths are the subprocess tests
    below)."""
    c = ServeCluster.__new__(ServeCluster)
    c.prefill_procs, c.replicas = prefill, replicas
    c.supervisor = StageSupervisor(max_restarts=max_restarts)
    c.stale_after = 1e9
    c.counters = TransportCounters()
    c.router = Router(prefill, replicas)
    c.completions, c._new = {}, []
    c._events = _q.Queue()
    c._peers, c._procs, c._incarnations = {}, {}, {}
    c._handled_dead, c._respawning = set(), set()
    c._parked_uids, c._worker_stats, c._hb = [], {}, {}
    c._stats_age, c._clock_offsets = {}, {}
    c._ttft, c._cache_counts = {}, {}
    c.generation = 0
    c._worker_gen = {("prefill", i): 0 for i in range(prefill)}
    c._worker_gen.update({("decode", i): 0 for i in range(replicas)})
    c._worker_spec = {}
    c._retiring, c._pending_routable = set(), set()
    c._next_idx = {"prefill": prefill, "decode": replicas}
    c._spec_paths = {}
    c._statusz_providers = {}
    c._tracer = _trace.get_tracer()
    c._lat = _metrics.get_registry().histogram("cluster.latency_s")
    c._ok_ctr = _metrics.get_registry().counter("cluster.completions_ok")
    c._shed_ctr = _metrics.get_registry().counter("cluster.completions_shed")
    c._statusz = None
    c._statusz_ports = {}
    c._slo, c._slo_last = None, 0.0
    c._shutting_down = False
    c._spawn = lambda role, idx: None    # supervision grants don't fork
    for i in range(prefill):
        c._peers[("prefill", i)] = _FakePeer("prefill", i)
    for i in range(replicas):
        c._peers[("decode", i)] = _FakePeer("decode", i)
    return c


def _handle_header(uid=0, batch_id="0.0:0"):
    return {"type": "handle", "batch_id": batch_id, "src": 0, "reqs": [{"uid": uid}]}


def test_bad_frame_returns_credit_and_replays():
    """A payload-CRC shed refunds the producer's ack credit AND replays the
    named requests."""
    c = _bare_cluster()
    pw, dw = c._peers[("prefill", 0)], c._peers[("decode", 0)]
    c.submit(Request(uid=0, tokens=[1, 2], max_new_tokens=4))
    assert len(pw.reqs()) == 1
    c._handle_event(("frame", pw, _handle_header(), b"<frame>"))
    assert dw.sent[-1] == ("bytes", b"<frame>")     # relayed verbatim
    c._handle_event(("frame", dw, {"type": "bad_frame",
                                   "batch_id": "0.0:0", "uids": [0]}, b""))
    assert pw.acks() == [{"type": "ack", "batch_id": "0.0:0"}]
    assert len(pw.reqs()) == 2                       # replayed
    assert pw.reqs()[1]["req"]["uid"] == 0
    assert c.router.batches == {}                    # entry pruned


def test_replica_death_returns_unacked_credits():
    c = _bare_cluster(max_restarts=1)
    pw, dw = c._peers[("prefill", 0)], c._peers[("decode", 0)]
    for uid in (0, 1):
        c.submit(Request(uid=uid, tokens=[1 + uid], max_new_tokens=4))
    c._handle_event(("frame", pw, _handle_header(uid=0, batch_id="0.0:0"), b"f0"))
    c._handle_event(("frame", pw, _handle_header(uid=1, batch_id="0.0:1"), b"f1"))
    assert c.router.unacked_batches(0) == ["0.0:0", "0.0:1"]
    c._handle_event(("dead", dw, "killed"))
    assert sorted(a["batch_id"] for a in pw.acks()) == ["0.0:0", "0.0:1"]
    assert c.router.unacked_batches(0) == []
    assert len(pw.reqs()) == 4                       # both uids replayed
    assert c.router.batches == {}


def test_no_replica_sheds_typed_and_returns_credit():
    c = _bare_cluster(max_restarts=0)
    pw, dw = c._peers[("prefill", 0)], c._peers[("decode", 0)]
    c._handle_event(("dead", dw, "killed"))          # restart denied
    c.submit(Request(uid=0, tokens=[1], max_new_tokens=4))
    c._handle_event(("frame", pw, _handle_header(), b"f"))
    assert pw.acks() == [{"type": "ack", "batch_id": "0.0:0"}]
    assert c.completions[0].status == FAILED_FAULT
    assert c.router.batches == {}
    assert c.supervisor.stats()["denied"] == 1


def test_stale_check_exempts_peers_until_ready():
    c = _bare_cluster()
    c.stale_after = 0.0                              # everything is late
    pw = c._peers[("prefill", 0)]
    pw.ready, pw.last_seen = False, 0.0              # mid-build
    c._check_stale()
    assert c._events.empty() and pw.alive
    c._handle_event(("frame", pw, {"type": "ready", "build_s": 1.0}, b""))
    assert pw.ready
    c._check_stale()                                 # now staleness applies
    assert c._events.get_nowait()[0] == "dead"


def test_spawn_passes_incarnation_nonce(monkeypatch, tmp_path):
    class _FakeProc:
        pid, returncode = 0, None

        def poll(self):
            return None

    cmds = []
    monkeypatch.setattr(cluster_mod.subprocess, "Popen",
                        lambda cmd, **kw: cmds.append(cmd) or _FakeProc())
    c = _bare_cluster()
    c.log_dir, c.port = tmp_path, 1
    c._spec_path = tmp_path / "spec.json"
    ServeCluster._spawn(c, "prefill", 0)
    ServeCluster._spawn(c, "prefill", 0)             # the respawn
    ServeCluster._spawn(c, "decode", 0)              # independent counter
    # argv tail is (incarnation, generation)
    assert [cmd[-2] for cmd in cmds] == ["0", "1", "0"]
    assert [cmd[-1] for cmd in cmds] == ["0", "0", "0"]
    assert cmds[0][1:3] == ["-m", "progen_tpu_torch.serve.worker"]
    assert c._incarnations == {("prefill", 0): 2, ("decode", 0): 1}


def test_connect_clears_timeout():
    import socket as _socket

    from progen_tpu_torch.serve.transport import connect

    lst = _socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    try:
        sock = connect(lst.getsockname()[1], timeout=10.0)
        srv, _ = lst.accept()
        try:
            assert sock.gettimeout() is None
        finally:
            sock.close()
            srv.close()
    finally:
        lst.close()


def test_supervisor_budget_and_crash_loop_guard():
    sup = StageSupervisor(max_restarts=1)
    assert sup.request_restart("prefill", 0, "eof") is True
    assert sup.request_restart("prefill", 0, "eof") is False  # budget spent
    assert sup.request_restart("decode", 0) is True   # per-instance budget
    st = sup.stats()
    assert st["restarts"] == {"prefill:0": 1, "decode:0": 1}
    assert st["denied"] == 1
    loop = StageSupervisor(max_restarts=5, min_interval_s=3600.0)
    assert loop.request_restart("prefill", 1) is True
    assert loop.request_restart("prefill", 1) is False  # crash-looping


# -------------------------------------------------- real 2-process clusters


def _drain_cluster(spec, n=4, **cluster_kw):
    cluster = ServeCluster(spec, **cluster_kw)
    try:
        for r in _requests(n):
            cluster.submit(r)
        done = cluster.drain(timeout=300.0)
    finally:
        stats = cluster.shutdown()
    return done, stats


@pytest.mark.parametrize("variant", ["dense", "paged"])
def test_cluster_token_identity(checkpoint, variant, tmp_path):
    """A real fleet of worker processes (1 prefill + 1 decode replica):
    tokens identical to the JAX package's single-process engine, greedy AND
    sampled, and the decode replica never pays prefill wall time."""
    reference = _run_reference(variant)
    done, stats = _drain_cluster(_spec(checkpoint, variant), log_dir=str(tmp_path))
    assert {c.uid: [int(t) for t in c.tokens] for c in done if c.ok} == reference
    assert all(c.ok for c in done)
    dstats = stats["workers"]["decode:0"]
    assert dstats["stage_seconds"]["prefill_s"] == 0.0
    assert dstats["stage_seconds"]["merge_s"] > 0
    assert dstats["stage_seconds"]["decode_chunk_s"] > 0
    assert stats["workers"]["prefill:0"]["stage_seconds"]["prefill_s"] > 0
    tt = stats["transport_total"]
    assert tt["frames_out"] > 0 and tt["bytes_out"] > 0
    assert tt["ser_s"] > 0 and tt["de_s"] > 0
    assert tt["crc_failures"] == 0 and tt["desyncs"] == 0
    # each worker's exit line (on the CPU the plain versions run: no launch)
    exits = {}
    for log in tmp_path.glob("*.log"):
        for line in log.read_text().splitlines():
            if line.startswith('{"worker_exit"'):
                exits[log.stem] = json.loads(line)
    assert set(exits) == {"prefill_0", "decode_0"}
    for line in exits.values():
        assert line["device"] == "cpu" and not any(line["launches"].values())


@pytest.mark.slow  # a respawn pays a second worker start
def test_cluster_kill_prefill_worker_replays(checkpoint, tmp_path):
    """SIGKILL the only prefill worker mid-run: the supervisor respawns it
    and every request completes OK, token-identical."""
    reference = _run_reference(n=6)
    cluster = ServeCluster(_spec(checkpoint),
                           supervisor=StageSupervisor(max_restarts=2),
                           log_dir=str(tmp_path))
    try:
        for r in _requests(6):
            cluster.submit(r)
        while not any(cluster.router.outstanding.values()):
            cluster.poll(0.05)
        assert any(cluster.router.prefill_load.values())
        cluster.kill_worker("prefill", 0)
        done = cluster.drain(timeout=300.0)
    finally:
        stats = cluster.shutdown()
    assert len(done) == 6 and all(c.ok for c in done)
    assert {c.uid: [int(t) for t in c.tokens] for c in done} == reference
    assert stats["supervision"]["restarts"].get("prefill:0", 0) >= 1


@pytest.mark.slow  # a respawn pays a second decode engine build
def test_cluster_kill_decode_replica_replays(checkpoint, tmp_path):
    reference = _run_reference(n=6)
    cluster = ServeCluster(_spec(checkpoint),
                           supervisor=StageSupervisor(max_restarts=2),
                           log_dir=str(tmp_path))
    try:
        for r in _requests(6):
            cluster.submit(r)
        while not any(cluster.router.outstanding.values()):
            cluster.poll(0.05)
        cluster.kill_worker("decode", 0)
        done = cluster.drain(timeout=300.0)
    finally:
        stats = cluster.shutdown()
    assert len(done) == 6 and all(c.ok for c in done)
    assert {c.uid: [int(t) for t in c.tokens] for c in done} == reference
    assert stats["supervision"]["restarts"].get("decode:0", 0) >= 1


def test_cluster_decode_stage_down_sheds_typed(checkpoint, tmp_path):
    """Kill the only decode replica at zero restart budget, then submit MORE
    batches than the prefill credit window: every request comes back as a
    typed failed_fault completion (each undeliverable batch's credit is
    refunded, so the prefill worker keeps producing)."""
    cluster = ServeCluster(_spec(checkpoint),
                           supervisor=StageSupervisor(max_restarts=0),
                           log_dir=str(tmp_path))
    try:
        cluster.kill_worker("decode", 0)
        for r in _requests(6):
            cluster.submit(r)
        done = cluster.drain(timeout=300.0)
    finally:
        stats = cluster.shutdown()
    assert sorted(c.uid for c in done) == list(range(6))
    assert all(c.status == "failed_fault" for c in done)
    assert stats["supervision"]["denied"] >= 1


def test_cluster_kill_prefill_worker_sheds_typed(checkpoint, tmp_path):
    """The same chaos with a zero restart budget: affected requests come
    back as typed failed_fault COMPLETIONS (exactly once, no raise);
    survivors stay token-identical to the reference."""
    reference = _run_reference(n=6)
    cluster = ServeCluster(_spec(checkpoint),
                           supervisor=StageSupervisor(max_restarts=0),
                           log_dir=str(tmp_path))
    try:
        for r in _requests(6):
            cluster.submit(r)
        while not any(c.ok for c in cluster.completions.values()):
            cluster.poll(0.1)
        cluster.kill_worker("prefill", 0)
        # a second wave submitted AFTER the kill can only resolve once the
        # cluster has processed the death (restart denied -> typed shed)
        for r in _requests(6, start=6):
            cluster.submit(r)
        done = cluster.drain(timeout=300.0)
    finally:
        stats = cluster.shutdown()
    assert len(done) == 12                     # every uid answered once
    assert sorted(c.uid for c in done) == list(range(12))
    ok = [c for c in done if c.ok]
    assert ok, "at least the pre-kill completion must survive"
    for c in ok:
        assert c.uid < 6                       # no prefill stage left
        assert [int(t) for t in c.tokens] == reference[c.uid]
    for c in done:
        if not c.ok:
            assert c.status == "failed_fault"
    assert stats["supervision"]["denied"] >= 1
