"""The port's elastic serving control plane against the JAX package's
(``tests/test_elastic.py``'s 13 cases, run on the port, with their marks):
policy determinism, hysteresis, cooldown and bounds, the router's
generation-aware placement, typed drain timeouts, ``ControlPlane`` tick
mechanics against a fake fleet, the ``/controlz`` endpoint, and REAL
multi-process clusters of ``progen_tpu_torch.serve.worker`` processes on
the CPU (loading JAX's ``init_seed=7`` weights): scale-down and scale-up
round trips, a rolling LoRA swap that drops nothing and tags every
completion with the weight generation that primed it, chaos (SIGKILL
mid-swap) and the autoscale burst.  Every real fleet's tokens equal the
JAX package's single-process engine's."""

import json
import math
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from progen_tpu_torch.decode.engine import DRAIN_TIMEOUT
from progen_tpu_torch.observe.statusz import StatuszServer
from progen_tpu_torch.resilience.supervise import StageSupervisor
from progen_tpu_torch.serve.cluster import ServeCluster
from progen_tpu_torch.serve.control import ControlPlane, _worst_burns
from progen_tpu_torch.serve.policy import BurnRatePolicy, PolicyInputs
from progen_tpu_torch.serve.router import Router
from tests.test_torch_serve_multiproc import (  # noqa: F401  (the fixture)
    _bare_cluster,
    _requests,
    _run_reference,
    _spec,
    checkpoint,
)

pytestmark = pytest.mark.elastic

torch.set_num_threads(1)


def _inputs(now, *, prefill=1, replicas=1, burn=0.0, queue=None,
            outstanding=None, parked=0):
    return PolicyInputs(
        now=now, prefill_workers=prefill, decode_replicas=replicas,
        burn_rates={"latency": burn}, prefill_queue=queue or {},
        replica_outstanding=outstanding or {}, queued_uids=parked)


def _tokens(done) -> dict:
    return {c.uid: [int(t) for t in c.tokens] for c in done}


# ------------------------------------------------------------------ policy


def test_policy_burn_thresholds_and_hysteresis():
    """Burn above up_burn scales up; the band between down_burn and up_burn
    holds steady (hysteresis); below down_burn scales down."""
    pol = BurnRatePolicy(min_prefill=1, max_prefill=2, cooldown_s=5.0)
    out = pol.decide(_inputs(0.0, burn=3.0))
    assert [(d.action, d.role, d.cause) for d in out] == [
        ("scale_up", "prefill", "burn_rate")]
    assert out[0].observed == 3.0 and out[0].threshold == pol.up_burn
    # cooldown: same pressure 2s later is ignored
    assert pol.decide(_inputs(2.0, prefill=2, burn=3.0)) == []
    # hysteresis band: burn between down (0.5) and up (2.0) -> no action
    assert pol.decide(_inputs(6.0, prefill=2, burn=1.0)) == []
    # quiet: below down_burn with an empty queue -> scale back down
    out = pol.decide(_inputs(12.0, prefill=2, burn=0.2))
    assert [(d.action, d.role) for d in out] == [("scale_down", "prefill")]


def test_policy_queue_depth_scales_both_stages():
    pol = BurnRatePolicy(up_queue_per_worker=4.0, cooldown_s=1.0)
    out = pol.decide(_inputs(0.0, queue={0: 3}, parked=2, outstanding={0: 9}))
    assert [(d.action, d.role, d.cause) for d in out] == [
        ("scale_up", "prefill", "queue_depth"),
        ("scale_up", "decode", "outstanding")]
    # parked uids count toward the prefill backlog: (3 + 2) / 1 workers
    assert out[0].observed == 5.0
    # burn alone never scales decode while it sits idle (pressure < 1)
    pol2 = BurnRatePolicy(cooldown_s=1.0)
    out = pol2.decide(_inputs(0.0, burn=math.inf))
    assert [(d.role) for d in out] == ["prefill"]


def test_policy_bounds_are_hard_and_config_validates():
    pol = BurnRatePolicy(min_prefill=2, max_prefill=2,
                         min_replicas=1, max_replicas=1, cooldown_s=0.0)
    # at max: even infinite burn cannot scale up
    assert pol.decide(_inputs(0.0, prefill=2, burn=math.inf,
                              outstanding={0: 99})) == []
    # at min: a dead-idle fleet cannot scale below the floor
    assert pol.decide(_inputs(1.0, prefill=2, burn=0.0)) == []
    with pytest.raises(ValueError):
        BurnRatePolicy(min_prefill=0)
    with pytest.raises(ValueError):
        BurnRatePolicy(min_prefill=3, max_prefill=2)
    with pytest.raises(ValueError):
        BurnRatePolicy(up_burn=1.0, down_burn=1.0)


def test_policy_is_deterministic_in_inputs():
    """Same PolicyInputs sequence -> same decisions, fresh instance or
    replayed: time enters only through inputs.now."""
    seq = [
        _inputs(0.0, queue={0: 9}),
        _inputs(1.0, prefill=2, queue={0: 9}),
        _inputs(20.0, prefill=2),
        _inputs(40.0, prefill=2, burn=5.0, outstanding={0: 3}),
    ]
    kw = dict(max_prefill=3, max_replicas=3, cooldown_s=5.0)
    a, b = BurnRatePolicy(**kw), BurnRatePolicy(**kw)
    da = [a.decide(i) for i in seq]
    assert da == [b.decide(i) for i in seq]
    assert any(da)  # the sequence actually exercises decisions


def test_worst_burns_picks_fastest_window():
    res = [
        {"name": "latency", "burn_rate": 0.2,
         "windows": {"10s": {"burn_rate": None},
                     "60s": {"burn_rate": 1.5},
                     "300s": {"burn_rate": 0.3}}},
        {"name": "goodput", "burn_rate": "inf", "windows": {}},
        {"name": "nodata", "burn_rate": None, "windows": {}},
    ]
    assert _worst_burns(res) == {"latency": 1.5, "goodput": math.inf}


# ------------------------------------------------------------------ router


def test_router_generation_aware_placement():
    """A handle primed on gen-G weights must decode on a gen-G replica;
    fences stop placement without touching in-flight bookkeeping."""
    r = Router(1, 1)
    r.add_worker("prefill", 1, generation=1)
    r.add_worker("decode", 1, generation=1)
    assert r.pick_replica(generation=0) == 0
    assert r.pick_replica(generation=1) == 1
    r.fence_worker("decode", 0)
    assert r.pick_replica(generation=0) is None     # fenced: not placeable
    assert r.pick_replica(generation=1) == 1

    ra, rb = _requests(2)
    r.assign_prefill(ra.uid, ra, 0, 0.0)
    r.assign_prefill(rb.uid, rb, 1, 0.0)
    assert r.generation_of(ra.uid) == 0 and r.generation_of(rb.uid) == 1
    r.note_handle("p1:0", [rb.uid], 1)
    assert r.batch_generation("p1:0") == 1
    assert r.generation_in_flight(0) == 1
    assert r.generation_in_flight(1) == 1
    assert r.complete(rb.uid) is True
    assert r.generation_in_flight(1) == 0
    assert r.complete(rb.uid) is False              # exactly-once dedup

    # retire removes membership, generation, and load bookkeeping
    r.fence_worker("prefill", 0)
    r.retire_worker("prefill", 0)
    assert 0 not in r.prefill_alive and 0 not in r.prefill_gen
    assert r.pick_prefill() == 1


# ----------------------------------------------------- typed drain timeout


def test_drain_timeout_sheds_typed_exactly_once():
    """A wedged worker cannot stall drain: past the deadline every open uid
    is answered with a typed drain_timeout completion, and a late real
    completion is dropped by the dedup."""
    c = _bare_cluster()
    for r in _requests(2):
        c.submit(r)
    peer = c._peers[("prefill", 0)]
    assert len(peer.reqs()) == 2        # routed before the fake wedge
    done = c.drain(timeout=0.05)
    assert sorted(x.uid for x in done) == [0, 1]
    assert all(x.status == DRAIN_TIMEOUT and not x.ok for x in done)
    assert c.pending == 0
    assert c.router.complete(0) is False  # late completion: deduped


# ---------------------------------------------------- control plane ticks


def test_control_plane_tick_fake_fleet():
    """gather -> decide -> execute -> journal against a fake cluster: queue
    pressure triggers a scale-up, cooldown holds it, a lone survivor is
    never retired, and the journal records cause and observed value."""
    c = _bare_cluster(prefill=1, replicas=1)
    calls = []
    c.add_worker = lambda role, **kw: (calls.append(("up", role)), 7)[1]
    c.retire_worker = lambda role, idx, **kw: calls.append(("down", role, idx))
    # empty SLO spec set: burn-driven paths stay off (the process-global
    # metrics registry carries state from other tests)
    cp = ControlPlane(c, BurnRatePolicy(
        min_prefill=1, max_prefill=2, min_replicas=1, max_replicas=2,
        up_queue_per_worker=2.0, cooldown_s=10.0), slo_specs=())
    assert c._statusz_providers["control"] == cp.controlz

    for r in _requests(3):
        c.submit(r)
    added = cp.tick(now=100.0)           # backlog 3/worker >= 2
    assert calls == [("up", "prefill")]
    assert [e["event"] for e in added] == ["scale_up"]
    assert added[0]["role"] == "prefill" and added[0]["idx"] == 7
    assert added[0]["cause"] == "queue_depth" and added[0]["observed"] == 3.0

    assert cp.tick(now=101.0) == []      # cooldown holds
    assert calls == [("up", "prefill")]

    # drained: backlog 0.  prefill_procs says 2 but only one live router
    # instance -> the victim picker refuses to orphan the stage
    for uid in list(c.router.requests):
        c.router.complete(uid)
    c.router.prefill_load[0] = 0
    c.prefill_procs = 2
    assert cp.tick(now=120.0) == []
    assert calls == [("up", "prefill")]

    # second instance live: now the least-loaded one retires
    c.router.add_worker("prefill", 1)
    added = cp.tick(now=140.0)
    assert calls[-1] == ("down", "prefill", 0)
    assert [e["event"] for e in added] == ["scale_down"]

    z = cp.controlz()
    assert z["ticks"] == 4 and z["policy"]["max_prefill"] == 2
    assert [e["event"] for e in z["journal"]] == ["scale_up", "scale_down"]
    assert z["fleet"]["worker_generations"] == {"decode:0": 0, "prefill:0": 0}


def test_controlz_endpoint_live_registration():
    """/controlz 404s until a control plane registers its provider: statusz
    holds the provider dict by reference, so late registration (a
    ControlPlane attached after the server started) just works."""
    providers = {}
    srv = StatuszServer(role="driver", providers=providers)
    port = srv.start()
    url = f"http://127.0.0.1:{port}/controlz"
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url, timeout=5)
        assert err.value.code == 404
        providers["control"] = lambda: {"ticks": 3, "journal": []}
        body = json.loads(urllib.request.urlopen(url, timeout=5).read())
        assert body == {"ticks": 3, "journal": []}
    finally:
        srv.stop()


# ------------------------------------------------- real 2..4-process fleets


@pytest.mark.multiproc
def test_scale_round_trip_token_identity(checkpoint, tmp_path):
    """Scale up mid-stream (warm-before-routable), then retire the ORIGINAL
    instances so the scaled-up workers carry the tail: every request
    completes OK and token-identical to the JAX single-process engine;
    elasticity is invisible to results."""
    reference = _run_reference(n=8)
    cluster = ServeCluster(_spec(checkpoint), log_dir=str(tmp_path))
    try:
        reqs = _requests(8)
        for r in reqs[:4]:
            cluster.submit(r)
        p_idx = cluster.add_worker("prefill")
        d_idx = cluster.add_worker("decode")
        assert (("prefill", p_idx) in cluster._pending_routable
                and ("decode", d_idx) in cluster._pending_routable)
        cluster.wait_routable("prefill", p_idx, timeout=300.0)
        cluster.wait_routable("decode", d_idx, timeout=300.0)
        assert cluster.prefill_procs == 2 and cluster.replicas == 2
        for r in reqs[4:6]:
            cluster.submit(r)
        # scale back down: drain + retire the originals, zero sheds
        cluster.retire_worker("prefill", 0)
        cluster.retire_worker("decode", 0)
        assert cluster.prefill_procs == 1 and cluster.replicas == 1
        assert sorted(cluster.router.prefill_alive) == [p_idx]
        assert sorted(cluster.router.replica_alive) == [d_idx]
        for r in reqs[6:]:
            cluster.submit(r)
        done = cluster.drain(timeout=300.0)
    finally:
        stats = cluster.shutdown()
    assert sorted(c.uid for c in done) == list(range(8))
    assert all(c.ok for c in done)
    assert _tokens(done) == reference
    topo = stats["topology"]
    assert topo["prefill_procs"] == 1 and topo["replicas"] == 1
    assert topo["retiring"] == [] and topo["pending_routable"] == []
    # retire released the supervision budget entries with the instance
    assert "prefill:0" not in stats["supervision"].get("restarts", {})


@pytest.mark.multiproc
def test_rolling_lora_swap_drops_nothing(checkpoint, tmp_path):
    """swap_weights mid-stream: requests primed before the swap finish on
    generation 0, requests after it carry generation 1, nothing is
    dropped, and tokens stay identical to the reference (the swapped-in
    LoRA bank is inert for untenanted requests: the swap machinery itself
    must not perturb results)."""
    reference = _run_reference(n=6)
    cluster = ServeCluster(_spec(checkpoint), log_dir=str(tmp_path))
    control = ControlPlane(cluster, slo_specs=())
    try:
        reqs = _requests(6)
        for r in reqs[:3]:
            cluster.submit(r)
        gen = control.swap_weights(lora={"tenants": 2, "rank": 2, "seed": 0})
        assert gen == 1 and cluster.generation == 1
        # the whole surviving fleet serves the new generation, at the same
        # size the swap started from
        assert cluster.prefill_procs == 1 and cluster.replicas == 1
        assert set(cluster.router.prefill_gen.values()) == {1}
        assert set(cluster.router.replica_gen.values()) == {1}
        assert cluster.router.generation_in_flight(0) == 0
        for r in reqs[3:]:
            cluster.submit(r)
        done = cluster.drain(timeout=300.0)
    finally:
        cluster.shutdown()
    assert sorted(c.uid for c in done) == list(range(6))
    assert all(c.ok for c in done)      # zero drops across the swap
    assert _tokens(done) == reference
    gens = {c.uid: c.generation for c in done}
    assert all(gens[u] == 0 for u in range(3)), gens    # primed pre-swap
    assert all(gens[u] == 1 for u in range(3, 6)), gens  # primed post-swap
    events = [e["event"] for e in control.journal]
    assert events[0] == "swap_begin" and events[-1] == "swap_done"
    assert events.count("swap_roll") == 2    # one decode up, one prefill roll
    assert control.swaps == 1


@pytest.mark.slow  # four worker builds + a respawn
@pytest.mark.multiproc
@pytest.mark.chaos
def test_chaos_kill_during_rolling_swap(checkpoint, tmp_path):
    """SIGKILL the old prefill worker WHILE swap_weights is rolling the
    fleet: the supervisor respawns it pinned to its original generation,
    replayed requests finish on the weights that primed them, the swap
    still completes, and every uid is answered exactly once,
    token-identical."""
    reference = _run_reference(n=6)
    sup = StageSupervisor(max_restarts=2)
    cluster = ServeCluster(_spec(checkpoint), supervisor=sup, log_dir=str(tmp_path))
    control = ControlPlane(cluster, slo_specs=())
    try:
        for r in _requests(6):
            cluster.submit(r)
        # fire mid-swap: 2s in, the swap is still warming the new-gen decode
        # replica, so the old prefill holds live work when it dies
        assassin = threading.Timer(
            2.0, lambda: cluster._procs[("prefill", 0)].kill())
        assassin.start()
        try:
            gen = control.swap_weights(lora={"tenants": 2, "rank": 2, "seed": 0})
        finally:
            assassin.cancel()
        assert gen == 1
        done = cluster.drain(timeout=300.0)
    finally:
        cluster.shutdown()
    assert sorted(c.uid for c in done) == list(range(6))   # exactly once
    assert all(c.ok for c in done)
    assert _tokens(done) == reference
    # every completion decoded on the generation that primed it
    assert set(c.generation for c in done) <= {0, 1}
    # the kill really landed: a restart was granted for the old prefill
    # (retire later forgets its budget COUNT, but the event log stays)
    assert any(e.role == "prefill" and e.index == 0 and e.granted
               and e.reason != "retired" for e in sup.events)


@pytest.mark.slow  # autoscale round trip pays an extra warm worker build
@pytest.mark.multiproc
def test_autoscale_burst_up_then_down(checkpoint, tmp_path):
    """E2E autoscale: a queued burst trips the scale-up on the very first
    tick (well inside one cooldown), the fleet serves everything
    token-identically, and once the backlog subsides the policy walks the
    fleet back down to the floor."""
    reference = _run_reference(n=8)
    cluster = ServeCluster(_spec(checkpoint), log_dir=str(tmp_path))
    policy = BurnRatePolicy(min_prefill=1, max_prefill=2,
                            min_replicas=1, max_replicas=1,
                            up_queue_per_worker=3.0, cooldown_s=1.0)
    control = ControlPlane(cluster, policy, slo_specs=())
    try:
        for r in _requests(8):
            cluster.submit(r)
        added = control.tick()      # first tick after the burst
        assert [e["event"] for e in added] == ["scale_up"]
        assert added[0]["role"] == "prefill"
        assert added[0]["cause"] == "queue_depth"
        assert cluster.prefill_procs == 2

        done = []
        while cluster.pending:
            done.extend(cluster.poll(0.1))
            control.tick()
        # backlog gone: keep ticking until the fleet is back at the floor
        # (the scale-up worker must first finish warming: the victim picker
        # skips pending-routable instances)
        deadline = time.perf_counter() + 180.0
        while cluster.prefill_procs > 1:
            assert time.perf_counter() < deadline, "never scaled down"
            cluster.poll(0.1)
            control.tick()
    finally:
        cluster.shutdown()
    assert sorted(c.uid for c in done) == list(range(8))
    assert all(c.ok for c in done)
    assert _tokens(done) == reference
    events = [e["event"] for e in control.journal]
    assert events[0] == "scale_up" and events[-1] == "scale_down"
    assert control.controlz()["fleet"]["prefill_procs"] == 1
