"""The port's fleet-wide prefix cache against the JAX package's
(``tests/test_fleetcache.py``'s 12 cases, run on the port): digest
advertisement over the wire, cache-aware router placement
(longest-prefix affinity, staleness fallback, load-imbalance spill),
shared-prefix request forking (the port engine's forks token-identical to
the JAX engine's independent submits, dense AND paged, with clean pool
refcounts after), the control plane's cache-valued scale-down victim
selection, and a REAL 3-process cluster of port workers exercising the
full digest -> route -> hit loop, its tokens the JAX single-process
engine's.

The contract under test everywhere: placement is a PERFORMANCE hint.
Tokens depend only on (weights, prime, seed, knobs), never on which replica
decoded them or whether a prefix page was shared."""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxEngine
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.parallel import unbox
from progen_tpu.serve import worker as jax_worker
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.paging import PagePool, prefix_key, token_span_digest
from progen_tpu_torch.models import ProGen
from progen_tpu_torch.serve.cluster import ServeCluster
from progen_tpu_torch.serve.control import ControlPlane
from progen_tpu_torch.serve.router import Router
from progen_tpu_torch.serve.worker import make_spec
from tests.test_torch_serve_multiproc import (  # noqa: F401  (the fixture)
    CFG,
    JAX_CFG,
    checkpoint,
)

pytestmark = pytest.mark.fleetcache

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained():
    """JAX's f32 init of seed 7 (its fixture's), and the port model holding
    the same parameters."""
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    params = unbox(model.init(jax.random.key(7),
                              jnp.zeros((2, JAX_CFG.seq_len), jnp.int32)))
    port = ProGen(CFG, make_policy(False), device="cpu")
    port.load_state_dict(params_from_flax(params))
    return model, params, port.eval()


# --------------------------------------------------- digest wire roundtrip


def test_digest_wire_roundtrip():
    """PagePool.prefix_digest survives a JSON round-trip and installs into
    the router's digest table with refcounts and pool pressure intact: the
    digest rides heartbeat frames as parsed JSON, so the wire form IS the
    contract."""
    pool = PagePool(10, 4)
    toks = [3, 1, 4, 1, 5, 9, 2, 6]
    pids = pool.allocate(2)
    pool.register_prefix(prefix_key(8, toks, 4), pids[0])
    pool.register_prefix(prefix_key(8, toks, 8), pids[1])
    pool.retain(pids[0])  # an extra in-flight sharer on the first page

    wire = json.loads(json.dumps(pool.prefix_digest()))
    r = Router(1, 2)
    r.note_digest(1, wire, now=0.0)

    ent = r.replica_digest[1]
    assert ent["page_size"] == 4
    assert ent["free"] == pool.free_pages
    assert ent["cached"] == 2 and ent["capacity"] == pool.capacity
    # keys collapse to (upto, digest): the prefill bucket is dropped
    assert ent["keys"] == {
        (4, token_span_digest(toks, 4)): 3,
        (8, token_span_digest(toks, 8)): 2,
    }
    assert 0 not in r.replica_digest  # only the advertising replica


def _digest_for(tokens, n_pages, *, page_size=4, ref=2):
    """Synthetic wire digest: the first ``n_pages`` full prime pages of
    ``tokens``, each at refcount ``ref``."""
    keys = [[16, (j + 1) * page_size,
             token_span_digest(tokens, (j + 1) * page_size), ref]
            for j in range(n_pages)]
    return {"page_size": page_size, "keys": keys, "free": 4,
            "cached": len(keys), "capacity": 8}


# ----------------------------------------------------- router placement


def test_router_longest_prefix_wins():
    """Among fresh digests the replica holding the longest CONTIGUOUS cached
    run of the batch's prime wins, not the most-loaded-with-anything one."""
    r = Router(1, 3)
    toks_a = list(range(1, 13))  # 3 full pages
    toks_b = [7] * 12
    r.note_digest(0, _digest_for(toks_a, 1), now=0.0)
    r.note_digest(1, _digest_for(toks_a, 3), now=0.0)
    r.note_digest(2, _digest_for(toks_b, 3), now=0.0)  # wrong prime
    assert r.pick_replica(tokens_batch=[toks_a], now=1.0) == 1
    assert r.cache_routed == 1 and r.cache_fallback == 0


def test_router_stale_digest_falls_back_to_load():
    """Past digest_ttl a digest scores 0: placement degrades to
    least-outstanding and the fallback counter says so."""
    r = Router(1, 2, digest_ttl=5.0)
    toks = list(range(1, 9))
    r.note_digest(1, _digest_for(toks, 2), now=0.0)
    r.outstanding.update({0: 0, 1: 6})
    # fresh: affinity beats load
    assert r.pick_replica(tokens_batch=[toks], now=1.0) == 1
    assert r.cache_routed == 1
    # stale: load-only, the old holder loses
    assert r.pick_replica(tokens_batch=[toks], now=100.0) == 0
    assert r.cache_fallback == 1


def test_router_imbalance_guard_spills_to_least_loaded():
    """Affinity must never serialize the fleet onto one hot replica: a cache
    holder more than cache_imbalance_tokens ahead of the least-loaded
    replica is overridden."""
    r = Router(1, 2, cache_imbalance_tokens=8)
    toks = list(range(1, 9))
    r.note_digest(0, _digest_for(toks, 2), now=0.0)
    r.outstanding.update({0: 20, 1: 0})
    assert r.pick_replica(tokens_batch=[toks], now=0.5) == 1
    assert r.cache_overridden == 1
    # within the guard band the holder keeps its affinity
    r.outstanding.update({0: 4, 1: 0})
    assert r.pick_replica(tokens_batch=[toks], now=0.5) == 0
    assert r.cache_routed == 1


# ------------------------------------------------------- request forking

_PRIME = [3, 1, 4, 1, 5, 9, 2, 6]  # two full pages at page_size=4


def _fork_base(uid=0, cls=Request):
    # sampled (not greedy) so the per-fork seed offset is load-bearing: fork
    # k must reproduce seed+k exactly, not just "some tokens"
    return cls(uid=uid, tokens=list(_PRIME), max_new_tokens=6,
               top_k=8, temperature=0.9, seed=100)


def _run_forked(port, n, **kw):
    eng = ServingEngine(port, **kw)
    uids = eng.submit_fork(_fork_base(), n)
    comps = eng.run_until_idle(max_chunks=300)
    return eng, uids, {c.uid: c.tokens.tolist() for c in comps}


@pytest.fixture(scope="module")
def independent_ref(trained):
    """Four independent submits of the fork family (uid+k / seed+k) on the
    JAX package's plain dense engine.  A trajectory depends only on
    (weights, prime, seed, knobs), so this ONE reference is the oracle for
    every fork test below: dense, paged and tight-pool alike."""
    model, params, _ = trained
    eng = JaxEngine(JAX_CFG, params, policy=jax_policy(False), num_slots=4,
                    chunk_size=4, max_len=24)
    base = _fork_base(cls=JaxRequest)
    for k in range(4):
        eng.submit(dataclasses.replace(base, uid=k, seed=base.seed + k))
    comps = eng.run_until_idle(max_chunks=300)
    return {c.uid: c.tokens.tolist() for c in comps}


def test_fork_token_identity_dense(trained, independent_ref):
    eng, uids, forked = _run_forked(trained[2], 3, num_slots=4, chunk_size=4,
                                    max_len=24)
    assert uids == [0, 1, 2] and set(forked) == {0, 1, 2}
    assert forked == {u: independent_ref[u] for u in forked}
    # distinct seeds actually diverged (the test would otherwise pass on an
    # engine that ignored the fork seeds entirely)
    assert len({tuple(v) for v in forked.values()}) > 1
    assert eng.fork_groups == 1


def test_fork_token_identity_paged_shares_prefix(trained, independent_ref):
    """Paged forks share the prime's pages through the prefix cache, and
    are STILL token-identical to independent submits."""
    eng, uids, forked = _run_forked(trained[2], 3, num_slots=4, chunk_size=4,
                                    max_len=24, paged=True, page_size=4,
                                    num_pages=32)
    assert set(forked) == {0, 1, 2}
    assert forked == {u: independent_ref[u] for u in forked}
    # the followers were admitted as cache hits on the leader's pages
    assert eng.prefix_hits >= 2 * (len(_PRIME) // 4)
    assert eng.prefix_lookups >= eng.prefix_hits


def test_fork_refcounts_clean_after_completion(trained):
    """After every fork drains, all page references unwind: nothing in
    flight, nothing leaked; free + cached covers the whole pool."""
    eng, _, forked = _run_forked(trained[2], 4, num_slots=4, chunk_size=4,
                                 max_len=24, paged=True, page_size=4, num_pages=32)
    assert len(forked) == 4
    pool = eng._pool
    assert pool.shared_pages == 0
    assert pool.free_pages + pool.cached_pages == pool.capacity


def test_fork_refcounts_clean_under_eviction_pressure(trained, independent_ref):
    """A pool too small to hold every fork's pages at once forces pauses and
    prefix-cache evictions mid-group; tokens still match the
    independent-submit oracle and the accounting still closes."""
    eng, _, forked = _run_forked(trained[2], 4, num_slots=2, chunk_size=4,
                                 max_len=24, paged=True, page_size=4, num_pages=14)
    assert len(forked) == 4
    assert forked == independent_ref
    pool = eng._pool
    assert pool.shared_pages == 0
    assert pool.free_pages + pool.cached_pages == pool.capacity


# ------------------------------------------- cache-valued scale-down


def _control_plane(router):
    class _Cluster:
        pass

    c = _Cluster()
    c.router = router
    c._pending_routable = set()
    cp = ControlPlane.__new__(ControlPlane)
    cp.cluster = c
    return cp


def test_scale_down_never_retires_sole_hot_holder():
    """The only live holder of an actively-shared prefix is never the
    victim; among the rest, lowest cache value (duplicated or cold pages)
    with load as tie-break goes first."""
    r = Router(1, 3)
    cp = _control_plane(r)
    now = time.perf_counter()
    hot = list(range(1, 9))
    r.note_digest(0, _digest_for(hot, 2, ref=3), now=now)  # sole + hot
    r.note_digest(1, _digest_for([7] * 8, 2, ref=1), now=now)
    r.note_digest(2, _digest_for([7] * 8, 2, ref=1), now=now)  # duplicate
    r.outstanding.update({0: 0, 1: 5, 2: 9})
    # replicas 1 and 2 tie on value (same duplicated pages): load breaks it
    assert cp._pick_victim("decode") == 1


def test_scale_down_all_stale_degrades_to_load_only():
    """No fresh digest anywhere: contents unknown, the pre-cache
    least-outstanding rule applies."""
    r = Router(1, 3)
    cp = _control_plane(r)
    now = time.perf_counter()
    r.note_digest(0, _digest_for(list(range(1, 9)), 2, ref=3),
                  now=now - 100.0)  # long expired
    r.outstanding.update({0: 4, 1: 9, 2: 2})
    assert cp._pick_victim("decode") == 2


def test_scale_down_prefers_stale_over_sole_hot():
    """Every FRESH replica is the sole holder of a hot prefix: a stale-digest
    replica (contents unknown, not known-precious) is sacrificed on load
    alone; with no stale replica either, nothing is safely evictable."""
    now = time.perf_counter()
    r = Router(1, 2)
    cp = _control_plane(r)
    r.note_digest(0, _digest_for(list(range(1, 9)), 2, ref=2), now=now)
    # replica 1 never advertised -> stale
    r.outstanding.update({0: 3, 1: 7})
    assert cp._pick_victim("decode") == 1

    r2 = Router(1, 2)
    cp2 = _control_plane(r2)
    r2.note_digest(0, _digest_for(list(range(1, 9)), 2, ref=2), now=now)
    r2.note_digest(1, _digest_for([7] * 8, 2, ref=2), now=now)
    assert cp2._pick_victim("decode") is None

    r3 = Router(1, 1)  # a fleet of one is never scaled to zero
    assert _control_plane(r3)._pick_victim("decode") is None


# --------------------------------------------- real 3-process cluster


@pytest.mark.multiproc
def test_cluster_cache_aware_routing_end_to_end(checkpoint, tmp_path):
    """Real subprocess fleet (1 prefill + 2 paged decode replicas), six
    same-prime requests: digests and the optimistic overlay make later
    batches cache-route to the prime's holder, the fleet counts prefix hits,
    and every completion is token-identical to the JAX single-process
    engine: placement changed, tokens did not."""
    engine = dict(num_slots=4, chunk_size=4, max_len=24, prefill_batch=2,
                  handoff_depth=2, paged=True, page_size=4, num_pages=32)
    reqs = [dict(uid=i, tokens=list(_PRIME), max_new_tokens=4, top_k=None,
                 temperature=0.0, seed=100 + i) for i in range(6)]
    ref_eng = jax_worker.build_engine_from_spec(jax_worker.make_spec(
        JAX_CFG, mixed_precision=False, init_seed=7, engine=engine))
    for r in reqs:
        ref_eng.submit(JaxRequest(**r))
    reference = {c.uid: [int(t) for t in c.tokens]
                 for c in ref_eng.run_until_idle() if c.ok}

    spec = make_spec(CFG, mixed_precision=False, checkpoint_path=checkpoint,
                     device="cpu", engine=engine)
    cluster = ServeCluster(spec, prefill_procs=1, replicas=2, log_dir=str(tmp_path))
    try:
        # wave 1 primes the cache; placement has nothing to match yet
        for r in reqs[:2]:
            cluster.submit(Request(**r))
        cluster.drain(timeout=300.0)
        # wait for a heartbeat to advertise the now-cached prime pages
        # (cadence ~1 s); before that the router can only fall back
        deadline = time.perf_counter() + 60.0
        while (not any(e["keys"] for e in cluster.router.replica_digest.values())
               and time.perf_counter() < deadline):
            cluster.poll(0.05)
        assert any(e["keys"] for e in cluster.router.replica_digest.values())
        # wave 2 must route to an advertised holder of the prime
        for r in reqs[2:]:
            cluster.submit(Request(**r))
        done = cluster.drain(timeout=300.0)
    finally:
        stats = cluster.shutdown()

    assert all(c.ok for c in done)
    assert {c.uid: [int(t) for t in c.tokens] for c in done} == reference

    router = stats["router"]
    # first placement had nothing to match; after that the prime's holder
    # is known (optimistic overlay or advertised digest)
    assert router["cache_routed"] >= 1
    assert router["replicas_with_digest"]  # heartbeats advertised
    cache = stats["cache"]
    assert cache["fleet_prefix_lookups"] >= cache["fleet_prefix_hits"] > 0
    assert 0.0 < cache["fleet_prefix_hit_rate"] <= 1.0
