"""The port's disaggregated prefill against the JAX package's, on the CPU in
f32 with the parameters of the JAX init carried over: ``HandoffQueue`` (a
bounded FIFO whose ``requeue`` is unbounded at the front) behaves as the
JAX one it was copied from, ``scatter_gate_rows`` writes the JAX pool into
full-precision and 8-bit pools, and the engine with ``disagg=True``, dense
and paged, and with ``spec=True`` too, gives the JAX engine's tokens and
statuses and the port's plain engine's tokens.  A transient fault at the
merge replays the handle, a transient prefill fault is retried, and a fatal
one sheds exactly its batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Handle as JaxHandle
from progen_tpu.decode import HandoffQueue as JaxHandoffQueue
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxServingEngine
from progen_tpu.decode import scatter_gate_rows as jax_scatter_gate_rows
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.parallel import unbox
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode import Handle, HandoffQueue, scatter_gate_rows
from progen_tpu_torch.decode.engine import (
    FAILED_FAULT,
    STATUS_OK,
    Request,
    ServingEngine,
)
from progen_tpu_torch.decode.paging import DUMP_PAGE
from progen_tpu_torch.models import ProGen, ProGenConfig
from progen_tpu_torch.resilience import RetryError, faults

torch.set_num_threads(1)

KW = dict(num_tokens=32, dim=16, seq_len=24, depth=3, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE = dict(num_slots=2, chunk_size=4, max_len=20)
PAGED = dict(paged=True, page_size=4)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    tokens = jnp.zeros((2, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(7), tokens))


@pytest.fixture(scope="module")
def model(flax_params):
    m = ProGen(CFG, make_policy(False), device="cpu")
    m.load_state_dict(params_from_flax(flax_params))
    return m.eval()


@pytest.fixture(autouse=True)
def no_fault_plan():
    faults.reset()
    yield
    faults.reset()


def _requests(n=5, *, seed=0, max_new=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(1, 9))
        sampled = i % 2 == 1
        out.append(dict(uid=i, tokens=rng.integers(1, CFG.num_tokens, p).tolist(),
                        max_new_tokens=max_new, top_k=5 if sampled else None,
                        temperature=0.8 if sampled else 0.0, seed=100 + i))
    return out


def _run(model, requests, **kw):
    eng = ServingEngine(model, **kw)
    for r in requests:
        eng.submit(Request(**r))
    comps = eng.run_until_idle(max_chunks=300)
    return eng, {c.uid: (c.tokens.tolist(), c.status) for c in comps}


def _run_jax(params, requests, **kw):
    eng = JaxServingEngine(JAX_CFG, params, policy=jax_policy(False), **kw)
    for r in requests:
        eng.submit(JaxRequest(**r))
    comps = eng.run_until_idle(max_chunks=300)
    return eng, {c.uid: (c.tokens.tolist(), c.status) for c in comps}


# ------------------------------------------------------ handoff semantics


@pytest.mark.parametrize("queue, handle", [(HandoffQueue, Handle),
                                           (JaxHandoffQueue, JaxHandle)],
                         ids=["port", "jax"])
def test_handoff_queue_is_a_bounded_fifo(queue, handle):
    q = queue(depth=2)
    assert not q and len(q) == 0 and not q.full()
    a, b, c = (handle(requests=[object()] * n, state={}, p_pad=8) for n in (1, 2, 1))
    assert q.put(a) and q.put(b)
    assert q.full()
    assert not q.put(c)  # at depth: refused, counted
    assert q.stats()["rejects"] == 1
    assert q.num_requests() == 3 and list(q) == [a, b]
    assert q.peek() is a
    assert q.get() is a and q.get() is b  # FIFO
    assert q.stats() == {"depth": 2, "queued": 0, "puts": 2, "gets": 2, "rejects": 1}


def test_handoff_requeue_is_unbounded_at_the_front():
    q = HandoffQueue(depth=1)
    a, b = (Handle(requests=[object()], state={}, p_pad=8) for _ in range(2))
    assert q.put(a)
    q.requeue(b)  # full, but a requeue is allowed
    assert len(q) == 2 and q.full()
    assert q.get() is b  # front: replayed before newer work
    assert q.stats()["puts"] == 1 and q.stats()["rejects"] == 0
    for depth in (0, -1):
        with pytest.raises(ValueError, match="depth"):
            HandoffQueue(depth)
        with pytest.raises(ValueError, match="depth"):
            JaxHandoffQueue(depth)


def test_handoff_queue_copy_is_pinned_to_the_jax_one():
    """The same seeded run of puts, gets, requeues and peeks on both queues:
    the same order of handles out and the same stats after every call."""
    rng = np.random.default_rng(5)
    port, ref = HandoffQueue(3), JaxHandoffQueue(3)
    made = 0
    for _ in range(200):
        op = rng.choice(["put", "get", "requeue", "peek"])
        if op in ("put", "requeue"):
            made += 1
            n = int(rng.integers(1, 4))
            args = ([made] * n, {}, 8)
            got = getattr(port, op)(Handle(*args))
            want = getattr(ref, op)(JaxHandle(*args))
            assert got == want
        elif len(ref):
            got, want = getattr(port, op)(), getattr(ref, op)()
            assert got.requests == want.requests
        assert port.stats() == ref.stats() and port.full() == ref.full()
        assert port.num_requests() == ref.num_requests()
        assert [h.requests for h in port] == [h.requests for h in ref]


# ------------------------------------------------------- scatter_gate_rows


@pytest.mark.parametrize("gate_dtype", ["bf16", "int8"])
def test_scatter_gate_rows_matches_jax(gate_dtype):
    """Three handle rows of dense gate slabs (one a dummy, one sharing its
    first page) into a pool of 12 pages of 4 rows: every page but the dump
    page equals the JAX pool; the given pool is left as it was."""
    rng = np.random.default_rng(3)
    n_rows, half, ps = 20, 16, 4
    gates = {"2": rng.normal(size=(3, n_rows, half)).astype(np.float32)}
    lengths = np.asarray([9, 1, 14], np.int32)
    wtable = np.full((3, 5), DUMP_PAGE, np.int32)
    wtable[0, :3] = [2, 3, 4]
    wtable[2, :4] = [DUMP_PAGE, 5, 6, 7]  # page 0 shared: read-only
    if gate_dtype == "int8":
        pool = rng.integers(-127, 128, size=(12, ps, half)).astype(np.int8)
        scale = rng.random(size=(12, ps)).astype(np.float32)
        jpool, jscale = jax_scatter_gate_rows(
            JAX_CFG, {k: jnp.asarray(v) for k, v in gates.items()},
            jnp.asarray(lengths), {"2": jnp.asarray(pool)}, jnp.asarray(wtable),
            pool_scale={"2": jnp.asarray(scale)})
        t_pool = {"2": torch.from_numpy(pool.copy())}
        t_scale = {"2": torch.from_numpy(scale.copy())}
        got, got_scale = scatter_gate_rows(
            CFG, {k: torch.from_numpy(v) for k, v in gates.items()},
            torch.from_numpy(lengths), t_pool, torch.from_numpy(wtable),
            pool_scale=t_scale)
        assert torch.equal(t_scale["2"], torch.from_numpy(scale))
        keep = [p for p in range(12) if p != DUMP_PAGE]
        np.testing.assert_allclose(got_scale["2"].numpy()[keep],
                                   np.asarray(jscale["2"])[keep], rtol=1e-7)
    else:
        pool = rng.normal(size=(12, ps, half)).astype(np.float32)
        jpool = jax_scatter_gate_rows(
            JAX_CFG, {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in gates.items()},
            jnp.asarray(lengths), {"2": jnp.asarray(pool).astype(jnp.bfloat16)},
            jnp.asarray(wtable))
        t_pool = {"2": torch.from_numpy(pool).to(torch.bfloat16)}
        got = scatter_gate_rows(
            CFG, {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in gates.items()},
            torch.from_numpy(lengths), t_pool, torch.from_numpy(wtable))
        assert torch.equal(t_pool["2"], torch.from_numpy(pool).to(torch.bfloat16))
    keep = [p for p in range(12) if p != DUMP_PAGE]
    mine = got["2"].float().numpy()[keep]
    theirs = np.asarray(jpool["2"]).astype(np.float32)[keep]
    np.testing.assert_array_equal(mine, theirs)
    assert got["2"].dtype == t_pool["2"].dtype
    # the rows landed where the table says, and nothing else moved
    before = t_pool["2"].float().numpy()
    written = {2, 3, 4, 5, 6, 7}
    for p in set(keep) - written:
        np.testing.assert_array_equal(got["2"].float().numpy()[p], before[p])


# ------------------------------------------------- the engine against JAX


@pytest.fixture(scope="module")
def plain(model):
    requests = _requests()
    return {"dense": _run(model, requests, **ENGINE)[1],
            "paged": _run(model, requests, **ENGINE, **PAGED)[1]}


DISAGG_CASES = {
    "dense": (dict(disagg=True, handoff_depth=2), "dense"),
    "paged": (dict(disagg=True, **PAGED), "paged"),
    "spec-dense": (dict(disagg=True, spec=True, spec_k=2), "dense"),
    "spec-paged": (dict(disagg=True, spec=True, spec_k=2, **PAGED), "paged"),
}


@pytest.mark.parametrize("case", sorted(DISAGG_CASES))
def test_disagg_engine_matches_jax_engine(flax_params, model, plain, case):
    """Prefill through the worker, the handoff queue and the merge changes
    WHEN requests are admitted, never WHAT they decode: the JAX engine's
    tokens and statuses (and acceptance counters under spec), and the port's
    plain engine's tokens."""
    kw, mode = DISAGG_CASES[case]
    jeng, want = _run_jax(flax_params, _requests(), **ENGINE, **kw)
    eng, got = _run(model, _requests(), **ENGINE, **kw)
    assert set(got) == set(range(5)) and all(s == STATUS_OK for _, s in got.values())
    assert got == want
    assert got == plain[mode]
    stats = eng.robustness_counters()["handoff"]
    assert stats == jeng.robustness_counters()["handoff"]
    assert stats["puts"] == stats["gets"] > 0 and stats["rejects"] == 0
    assert eng.stage_seconds["merge_s"] > 0 and eng.stage_seconds["prefill_s"] > 0
    assert eng.status()["disagg"] and not eng.has_work
    if kw.get("spec"):
        counters = eng.spec_counters()
        assert {k: counters[k] for k in jeng.spec_counters()} == jeng.spec_counters()
        assert counters["accepted_tokens_per_slot_round"] > 1.0
    if kw.get("paged"):
        assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity


def test_disagg_paged_with_8bit_pages_quantizes_at_the_merge(model):
    """With 8-bit pages the handle's slabs arrive in the compute dtype and
    quantize at the pool boundary: the tokens are the inline q8 engine's."""
    kw = {**ENGINE, **PAGED, "quantize": "weights+pages"}
    _, want = _run(model, _requests(), **kw)
    eng, got = _run(model, _requests(), **kw, disagg=True, spec=True, spec_k=2)
    assert got == want
    assert eng.state["caches"]["sgu_pool"]["2"].dtype == torch.int8


def test_the_handoff_api_prefills_and_admits_handles(model, plain):
    """``run_prefill_round`` pops the handle it made, ``admit_handle`` takes
    it back (refused at depth), and the merged slots finish as the plain
    engine's."""
    eng = ServingEngine(model, **ENGINE, disagg=True, handoff_depth=1)
    for r in _requests(2):
        eng.submit(Request(**r))
    h = eng.run_prefill_round()  # request 1 has another bucket: a batch of one
    assert isinstance(h, Handle) and [r.uid for r in h.requests] == [0]
    assert len(eng._handoff) == 0 and eng.pending == 1
    assert eng.admit_handle(h) and not eng.admit_handle(h)
    assert eng.run_prefill_round() is None  # the queue is at depth: no round
    done = {c.uid: (c.tokens.tolist(), c.status) for c in eng.run_until_idle(max_chunks=50)}
    assert done == {u: plain["dense"][u] for u in (0, 1)}
    assert h.state == {}  # the merge took its tensors
    with pytest.raises(RuntimeError, match="disagg"):
        ServingEngine(model, **ENGINE).run_prefill_round()


# ------------------------------------------------------------------ faults


def test_a_transient_merge_fault_replays_the_handle(model, plain):
    faults.configure("serve.handoff:io_error:at=1", seed=2)
    eng, got = _run(model, _requests(), **ENGINE, disagg=True)
    assert got == plain["dense"]
    assert eng.robust.faults_contained >= 1 and eng.robust.failed_faults == 0


def test_a_persisting_merge_fault_requeues_the_handle_whole(model, plain):
    faults.configure("serve.handoff:io_error:times=9")
    eng = ServingEngine(model, **ENGINE, **PAGED, disagg=True, fault_retries=1)
    for r in _requests(3):
        eng.submit(Request(**r))
    with pytest.raises(RetryError):
        for _ in range(3):
            eng.step()
    assert eng.num_active == 0 and len(eng._handoff) == 1
    assert eng._pool.free_pages == eng._pool.capacity
    faults.reset()
    done = {c.uid: (c.tokens.tolist(), c.status) for c in eng.run_until_idle(max_chunks=50)}
    assert done == {u: plain["dense"][u] for u in range(3)}


def test_transient_prefill_and_verify_faults_change_no_token(model, plain):
    faults.configure("serve.prefill:unavailable:at=1;serve.verify:io_error:at=2", seed=3)
    eng, got = _run(model, _requests(), **ENGINE, spec=True, spec_k=2, disagg=True)
    assert got == plain["dense"]
    assert eng.robust.faults_contained >= 2 and eng.robust.failed_faults == 0


def test_a_fatal_prefill_fault_sheds_exactly_its_batch(flax_params, model, plain):
    """The first prefill round's batch is request 0 alone (request 1 has
    another bucket): a fatal fault there sheds it, and only it, as the JAX
    engine does under the same plan; the others decode as without it."""
    from progen_tpu.resilience import faults as jax_faults

    kw = {**ENGINE, **PAGED, "disagg": True}
    jax_faults.configure("serve.prefill:fatal:at=1")
    try:
        _, want = _run_jax(flax_params, _requests(), **kw)
    finally:
        jax_faults.configure("")
    faults.configure("serve.prefill:fatal:at=1")
    eng, got = _run(model, _requests(), **kw)
    assert got == want
    assert {u: s for u, (_, s) in got.items()} == {
        0: FAILED_FAULT, 1: STATUS_OK, 2: STATUS_OK, 3: STATUS_OK, 4: STATUS_OK}
    assert {u: got[u] for u in range(1, 5)} == {u: plain["paged"][u] for u in range(1, 5)}
    assert eng.robust.failed_faults == 1
    assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity
