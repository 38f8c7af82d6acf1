"""The port's continuous-batching ``ServingEngine`` against the JAX
package's, on the CPU in f32, with the parameters of the JAX init carried
over: the same requests give token-identical completions and finish
reasons, greedy and sampled (top-k 8, temperature 0.9), dense and paged.
Then the port's own contracts: paged == dense exactly, a tight pool pauses
and evicts and changes no token, a paused row keeps its later tokens, the
prefix cache shares pages, admission defers, sheds arrive as typed
completions, faults are retried or shed, and quantized serving agrees with
the JAX engine's."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxServingEngine
from progen_tpu.decode.incremental import ProGenPagedDecodeStep as JaxPagedStep
from progen_tpu.decode.incremental import init_caches as jax_init_caches
from progen_tpu.decode.incremental import init_gate_pool as jax_init_gate_pool
from progen_tpu.decode.incremental import init_gate_scale as jax_init_gate_scale
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.ops.quant import quantize_params as jax_quantize_params
from progen_tpu.parallel import unbox
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode import engine as engine_module
from progen_tpu_torch.decode.engine import (
    FAILED_FAULT,
    SHED_DEADLINE,
    SHED_QUEUE_FULL,
    STATUS_OK,
    Request,
    ServingEngine,
)
from progen_tpu_torch.decode.incremental import (
    ProGenPagedDecodeStep,
    init_caches,
    init_gate_pool,
    init_gate_scale,
)
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.resilience import RetryError, faults
from progen_tpu_torch.workloads import random_lora_bank

torch.set_num_threads(1)

KW = dict(num_tokens=32, dim=16, seq_len=24, depth=3, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE = dict(num_slots=3, chunk_size=4, max_len=20)
PAGED = dict(paged=True, page_size=4)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    tokens = jnp.zeros((2, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(7), tokens))


@pytest.fixture(scope="module")
def model(flax_params):
    return _port(flax_params)


@pytest.fixture(autouse=True)
def no_fault_plan():
    faults.reset()
    yield
    faults.reset()


def _port(params, mixed=False, weights="bf16"):
    m = ProGen(CFG, make_policy(mixed), device="cpu", weights=weights)
    m.load_state_dict(params_from_flax(params))
    return m.eval()


def _requests(n, *, seed=0, max_new=8, mode="mixed"):
    """``mode``: greedy, sampled (top-k 8, temperature 0.9), or alternating."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(1, 9))
        greedy = mode == "greedy" or (mode == "mixed" and i % 2 == 0)
        out.append(dict(uid=i, tokens=rng.integers(1, CFG.num_tokens, p).tolist(),
                        max_new_tokens=max_new, top_k=None if greedy else 8,
                        temperature=0.0 if greedy else 0.9, seed=100 + i))
    return out


def _run(model, requests, **kw):
    eng = ServingEngine(model, **kw)
    for r in requests:
        eng.submit(Request(**r))
    comps = eng.run_until_idle(max_chunks=300)
    return eng, {c.uid: (c.tokens.tolist(), c.finish_reason) for c in comps}


def _run_jax(params, requests, **kw):
    eng = JaxServingEngine(JAX_CFG, params, policy=jax_policy(False), **kw)
    for r in requests:
        eng.submit(JaxRequest(**r))
    comps = eng.run_until_idle(max_chunks=300)
    return {c.uid: (c.tokens.tolist(), c.finish_reason) for c in comps}


# ------------------------------------------------------------- against JAX


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_matches_jax_engine_token_for_token(flax_params, model, paged):
    """Nine requests through three slots (so slots are reused), greedy and
    sampled side by side: completions and finish reasons are JAX's."""
    kw = {**ENGINE, **(PAGED if paged else {})}
    requests = _requests(9, seed=1)
    want = _run_jax(flax_params, requests, **kw)
    eng, got = _run(model, requests, **kw)
    assert set(got) == set(range(9))
    assert got == want
    assert {reason for _, reason in got.values()} <= {"eos", "length"}
    assert any(len(t) > 1 for t, _ in got.values())
    sampled = [got[i][0] for i in range(1, 9, 2)]
    greedy_again = _run(model, [dict(r, temperature=0.0, top_k=None)
                                for r in requests], **kw)[1]
    assert any(greedy_again[i][0] != t for i, t in zip(range(1, 9, 2), sampled)), \
        "sampling never left the greedy path: the noise is not applied"


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_paged_engine_matches_dense_engine_exactly(model, mode):
    requests = _requests(7, mode=mode)
    _, dense = _run(model, requests, **ENGINE)
    eng, paged = _run(model, requests, **ENGINE, **PAGED)
    assert paged == dense and set(paged) == set(range(7))
    assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity
    assert eng.cache_status()["capacity"] == 3 * 5 and eng.status()["paged"]


def test_tight_pool_pauses_and_evicts_and_changes_no_token(model):
    requests = _requests(7, mode="mixed")
    _, dense = _run(model, requests, **ENGINE)
    eng, paged = _run(model, requests, **ENGINE, **PAGED, num_pages=8,
                      prefix_cache=False)
    assert paged == dense
    assert eng.pause_events > 0 and eng.evictions > 0
    assert eng._pool.free_pages == eng._pool.capacity
    counters = eng.robustness_counters()
    assert counters["pause_events"] == eng.pause_events
    assert counters["fallback_activations"] == 0


def test_a_row_paused_for_a_chunk_keeps_its_later_tokens(model):
    """Slot 1 is paused for the second chunk: its row runs the step, and
    every write of it is dropped.  Its tokens, and its neighbours', are those
    of the undisturbed run."""
    requests = _requests(3, mode="mixed", max_new=12)
    _, want = _run(model, requests, **ENGINE, **PAGED)
    eng = ServingEngine(model, **ENGINE, **PAGED)
    ensure = eng._ensure_chunk_pages
    paused_chunks = []

    def pause_slot_one():
        ensure()
        if eng.chunks_run == 1 and 1 in eng._inflight:
            eng._paused[1] = True
            paused_chunks.append(int(eng.state["pos"][1]))

    eng._ensure_chunk_pages = pause_slot_one
    for r in requests:
        eng.submit(Request(**r))
    eng.step()
    eng.step()
    assert paused_chunks and int(eng.state["pos"][1]) == paused_chunks[0]  # frozen
    comps = eng.run_until_idle(max_chunks=300)
    got = {c.uid: (c.tokens.tolist(), c.finish_reason) for c in eng.completions}
    assert got == want and len(comps) >= 1


def test_paged_step_drops_every_write_of_a_row_that_is_not_live(model):
    step = ProGenPagedDecodeStep(model, n_rows=20)
    caches = init_caches(CFG, 2, model.policy, decode_len=20, device="cpu",
                         with_sgu=False)
    caches["sgu_pool"] = init_gate_pool(CFG, 2 + 10, 4, model.policy, device="cpu")
    table = torch.tensor([[2, 3, 0, 0, 0], [4, 5, 0, 0, 0]], dtype=torch.int32)
    live = torch.tensor([True, True])
    for pos in range(3):
        step(torch.tensor([3 + pos, 7 + pos]), pos, caches, table, live)
    before = {k: [t.clone() for t in caches[k]] for k in ("attn_prev", "ff_prev", "k", "v")}
    pool_before = caches["sgu_pool"]["2"].clone()
    step(torch.tensor([9, 9]), 3, caches, table, torch.tensor([True, False]))
    for name, old in before.items():
        for new, was in zip(caches[name], old):
            assert torch.equal(new[1], was[1]), name       # row 1: nothing moved
            assert not torch.equal(new[0], was[0]), name   # row 0: advanced
    pool = caches["sgu_pool"]["2"]
    assert torch.equal(pool[[0, 4, 5]], pool_before[[0, 4, 5]])
    assert not torch.equal(pool[2], pool_before[2])  # row 0 wrote position 3


def test_prefix_cache_shares_pages(model):
    prime = [int(t) for t in np.random.default_rng(3).integers(1, CFG.num_tokens, 9)]
    requests = [dict(uid=i, tokens=prime, max_new_tokens=6, top_k=None,
                     temperature=0.0, seed=i) for i in range(3)]
    eng, by_uid = _run(model, requests, num_slots=1, chunk_size=4, max_len=20, **PAGED)
    # one slot: the 2nd and 3rd request share the first's two full prefix pages
    assert eng.prefix_hits == 4 and eng.prefix_lookups == 6
    assert len({tuple(t) for t, _ in by_uid.values()}) == 1
    assert eng._pool.cached_pages == 2
    assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity
    assert eng.cache_status()["hit_rate"] == pytest.approx(4 / 6)


def test_admission_defers_on_exhaustion(model):
    requests = [dict(uid=i, tokens=[3, 4, 5, 6, 7], max_new_tokens=6, top_k=None,
                     temperature=0.0, seed=i) for i in range(3)]
    eng = ServingEngine(model, num_slots=3, chunk_size=4, max_len=16, **PAGED,
                        num_pages=2 + 4, prefix_cache=False)
    for r in requests:
        eng.submit(Request(**r))
    eng.step()
    assert 1 <= eng.num_active < 3 and eng.pending >= 1
    comps = eng.run_until_idle(max_chunks=300)
    assert sorted(c.uid for c in eng.completions) == [0, 1, 2]
    assert len({tuple(c.tokens) for c in eng.completions}) == 1 and comps
    assert eng._pool.free_pages == eng._pool.capacity


def test_submit_refuses_what_can_never_run(model):
    eng = ServingEngine(model, num_slots=1, chunk_size=4, max_len=20, **PAGED,
                        num_pages=2 + 2)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(uid=0, tokens=list(range(1, 9)), max_new_tokens=10))
    with pytest.raises(ValueError, match="empty prime"):
        eng.submit(Request(uid=1, tokens=[]))
    with pytest.raises(ValueError, match="no room"):
        eng.submit(Request(uid=2, tokens=[1] * 20))
    with pytest.raises(ValueError, match="lora_bank"):
        eng.submit(Request(uid=3, tokens=[1, 2], tenant=1))
    with pytest.raises(ValueError, match="logit_mask"):
        eng.submit(Request(uid=4, tokens=[1, 2], logit_mask=np.ones((2, 5), bool)))


def test_a_request_depends_on_nothing_but_itself(model):
    """The same request alone, amid others in another slot, dense and paged:
    the same tokens (its key chain lives in its slot and advances only on its
    own live steps)."""
    probe = dict(uid=99, tokens=[5, 9, 2, 7], max_new_tokens=10, top_k=8,
                 temperature=0.9, seed=4242)
    _, alone = _run(model, [probe], **ENGINE)
    crowd = _requests(6, seed=5, mode="sampled")
    for kw in (ENGINE, {**ENGINE, **PAGED}):
        _, mixed = _run(model, crowd[:4] + [probe] + crowd[4:], **kw)
        assert mixed[99] == alone[99]
    other_seed = _run(model, [dict(probe, seed=4243)], **ENGINE)[1]
    assert other_seed[99] != alone[99]


def test_logit_mask_constrains_greedy_and_sampled_rows(model):
    allowed = np.zeros((5, CFG.num_tokens), bool)
    allowed[:, [4, 11, 19]] = True
    requests = [dict(uid=i, tokens=[3, 8, 1], max_new_tokens=7, top_k=None if i else 8,
                     temperature=0.0 if i else 1.0, seed=i, logit_mask=allowed)
                for i in range(2)]
    _, got = _run(model, requests, **ENGINE)
    for tokens, _ in got.values():
        assert set(tokens[:5]) <= {4, 11, 19} and len(tokens) == 7


# ------------------------------------------------------------------- sheds


def test_max_queue_and_deadline_sheds_arrive_as_typed_completions(model):
    seen = []
    eng = ServingEngine(model, **ENGINE, max_queue=2)
    base = dict(tokens=[1, 2, 3], max_new_tokens=4, temperature=0.0,
                on_complete=seen.append)
    for uid in range(3):
        eng.submit(Request(uid=uid, **base))
    eng.submit(Request(uid=3, deadline=time.perf_counter() - 1.0, **base))
    assert [c.status for c in seen] == [SHED_QUEUE_FULL, SHED_DEADLINE]
    assert seen[0].uid == 2 and seen[0].tokens.size == 0 and not seen[0].ok
    done = eng.run_until_idle(max_chunks=50)
    assert sorted((c.uid, c.status) for c in done) == [
        (0, STATUS_OK), (1, STATUS_OK), (2, SHED_QUEUE_FULL), (3, SHED_DEADLINE)]
    assert eng.robust.sheds_queue_full == 1 and eng.robust.sheds_deadline == 1

    oldest = ServingEngine(model, **ENGINE, max_queue=1, shed_policy="shed-oldest")
    oldest.submit(Request(uid=0, **base))
    oldest.submit(Request(uid=1, **base))
    assert [(c.uid, c.status) for c in oldest.completions] == [(0, SHED_QUEUE_FULL)]
    with pytest.raises(ValueError, match="shed_policy"):
        ServingEngine(model, **ENGINE, shed_policy="drop")


def test_an_in_flight_request_past_its_deadline_is_shed_with_its_tokens(model):
    eng = ServingEngine(model, **ENGINE, **PAGED)
    eng.submit(Request(uid=0, tokens=[1, 2, 3], max_new_tokens=15, temperature=0.0,
                       ttl=3600.0))
    eng.submit(Request(uid=1, tokens=[4, 5], max_new_tokens=15, temperature=0.0))
    eng.step()
    eng._inflight[0].ttl = -1.0  # now it has expired, mid-decode
    eng.run_until_idle(max_chunks=50)
    by_uid = {c.uid: c for c in eng.completions}
    assert by_uid[0].status == SHED_DEADLINE and 1 <= len(by_uid[0].tokens) <= 6
    assert by_uid[1].status == STATUS_OK
    assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity


def test_priority_preempts_and_replays_bit_exactly(model):
    low = [dict(uid=i, tokens=[2 + i, 5, 9], max_new_tokens=12, top_k=8,
                temperature=0.9, seed=i) for i in range(3)]
    _, want = _run(model, low, **ENGINE)
    eng = ServingEngine(model, **ENGINE)
    for r in low:
        eng.submit(Request(**r))
    eng.step()
    eng.submit(Request(uid=7, tokens=[1, 1], max_new_tokens=3, temperature=0.0,
                       priority=5))
    done = eng.run_until_idle(max_chunks=100)
    got = {c.uid: (c.tokens.tolist(), c.finish_reason) for c in done}
    assert eng.robust.preemptions == 1 and eng.qos_status()["preemptions"] == 1
    assert {u: got[u] for u in want} == want and got[7][1] in ("eos", "length")


# ------------------------------------------------------------------ faults


def test_a_transient_decode_fault_is_retried_in_place(model):
    requests = _requests(4, mode="mixed")
    _, want = _run(model, requests, **ENGINE, **PAGED)
    faults.configure("serve.decode_chunk:io_error:times=2")
    eng, got = _run(model, requests, **ENGINE, **PAGED)
    assert got == want
    assert eng.robust.faults_contained == 2 and eng.robust.failed_faults == 0
    assert eng.robustness_counters()["faults_fired"] == 2


def test_a_fatal_decode_fault_sheds_the_batch_and_serving_goes_on(model):
    requests = _requests(5, mode="greedy")
    _, want = _run(model, requests, **ENGINE, **PAGED)
    faults.configure("serve.decode_chunk:fatal:at=1")
    eng, got = _run(model, requests, **ENGINE, **PAGED)
    shed = {u for u, (_, reason) in got.items() if reason == FAILED_FAULT}
    assert shed == {0, 1, 2} and eng.robust.failed_faults == 3
    assert {u: got[u] for u in (3, 4)} == {u: want[u] for u in (3, 4)}
    assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity
    assert eng.robustness_counters()["fallback_activations"] == 0


def test_transient_exhaustion_escapes_and_leaves_the_queue_whole(model):
    faults.configure("serve.prefill:unavailable:times=9")
    eng = ServingEngine(model, **ENGINE, fault_retries=1)
    for r in _requests(2):
        eng.submit(Request(**r))
    with pytest.raises(RetryError):
        eng.step()
    assert eng.num_active == 0 and [r.uid for r in eng._queue] == [0, 1]
    faults.reset()
    assert len(eng.run_until_idle(max_chunks=50)) == 2


def test_a_fatal_prefill_fault_sheds_exactly_its_batch(model):
    faults.configure("serve.prefill:fatal:at=1;serve.submit:fatal:at=6")
    eng = ServingEngine(model, **ENGINE, **PAGED)
    for r in _requests(6, mode="greedy"):
        eng.submit(Request(**r))
    done = eng.run_until_idle(max_chunks=100)
    status = {c.uid: c.status for c in done}
    assert [status[u] for u in range(6)] == [FAILED_FAULT] * 3 + [STATUS_OK] * 2 + [FAILED_FAULT]
    assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity


def test_modes_that_are_not_ported_are_refused_by_name(model):
    for name in ("remote_prefill", "paged_impl"):
        with pytest.raises(NotImplementedError, match=name):
            ServingEngine(model, **ENGINE, **{name: True})
    for name in ("mesh", "strategies", "params_shardings"):  # ported: accepted
        assert name not in engine_module._NOT_PORTED
    with pytest.raises(ValueError, match="not placed"):  # a mesh needs a placed model
        ServingEngine(model, **ENGINE, mesh=True)
    assert "watchdog" not in engine_module._NOT_PORTED  # ported: accepted
    assert ServingEngine(model, **ENGINE, watchdog=None)._watchdog is None
    with pytest.raises(NotImplementedError, match="remote_prefill"):
        ServingEngine(model, **ENGINE, disagg=True, remote_prefill=True)
    for name in ("spec", "disagg"):  # ported: accepted
        eng = ServingEngine(model, **ENGINE, **{name: True})
        assert getattr(eng, name) and eng.status()[name]
        assert name not in engine_module._NOT_PORTED
    eng = ServingEngine(model, **ENGINE,  # ported: accepted
                        lora_bank=random_lora_bank(CFG, 2, 1, device="cpu"))
    assert eng.lora and eng.status()["lora_tenants"] == 2
    assert "lora_bank" not in engine_module._NOT_PORTED
    with pytest.raises(TypeError, match="slots"):
        ServingEngine(model, **ENGINE, slots=3)
    with pytest.raises(ValueError, match="paged=True"):
        ServingEngine(model, **ENGINE, quantize="weights+pages")
    with pytest.raises(ValueError, match="quantize"):
        ServingEngine(model, **ENGINE, quantize="int4")
    # ported: present and not refused (tests/test_torch_graphs.py holds it
    # to the JAX engine's)
    assert ServingEngine(model, **ENGINE).aot_warmup(max_prime=1)["programs"] == 2
    for ported in ("submit_fork", "submit_embed", "run_embed_round", "snapshot",
                   "restore", "reload_weights", "drain_sheds", "forget_ttft",
                   "prefix_digest", "close", "aot_warmup"):
        assert hasattr(ServingEngine, ported)
    assert sorted(engine_module._NOT_PORTED) == sorted(set(engine_module._NOT_PORTED))


def test_engine_builds_its_model_from_a_config():
    eng = ServingEngine(CFG, device="cpu", seed=3, **ENGINE)
    eng.submit(Request(uid=0, tokens=[1, 2, 3], max_new_tokens=5, temperature=0.0))
    (comp,) = eng.run_until_idle(max_chunks=20)
    assert comp.ok and comp.ttft is not None and comp.latency >= comp.ttft
    assert eng.status()["slots"] == {"total": 3, "active": 0, "free": 3}
    assert eng.stage_seconds["prefill_s"] > 0
    assert (eng.stage_seconds["decode_chunk_s"] > 0) == (eng.chunks_run > 0)


# ------------------------------------------------------ quantized and bf16


def _fresh_paged_caches(policy, gate_dtype, rows=2):
    caches = init_caches(CFG, rows, policy, decode_len=20, device="cpu", with_sgu=False)
    caches["sgu_pool"] = init_gate_pool(CFG, 2 + 10, 4, policy, gate_dtype=gate_dtype,
                                        device="cpu")
    if gate_dtype == "int8":
        caches["sgu_pool_scale"] = init_gate_scale(CFG, 2 + 10, 4, device="cpu")
    return caches


def _fresh_jax_paged_caches(policy, gate_dtype, rows=2):
    caches = jax_init_caches(JAX_CFG, rows, policy, decode_len=20, with_sgu=False)
    caches.pop("sgu_gate")
    caches["sgu_pool"] = jax_init_gate_pool(JAX_CFG, 2 + 10, 4, policy,
                                            gate_dtype=gate_dtype)
    if gate_dtype == "int8":
        caches["sgu_pool_scale"] = jax_init_gate_scale(JAX_CFG, 2 + 10, 4)
    return caches


def _teacher_forced_paged_logits(flax_variables, model, mixed, weights, gate_dtype,
                                 steps):
    """``steps`` paged decode steps of both packages from fresh caches on the
    same tokens; returns (port logits, JAX logits), each ``(steps, 2, V)``."""
    tokens = np.random.default_rng(6).integers(1, CFG.num_tokens, size=(steps, 2))
    table = np.asarray([[2, 3, 4, 0, 0], [5, 6, 7, 0, 0]], np.int32)
    jstep = JaxPagedStep(config=JAX_CFG, n_rows=20, policy=jax_policy(mixed),
                         impl="xla", weights=weights, gate_dtype=gate_dtype)
    japply = jax.jit(jstep.apply)
    jcaches = _fresh_jax_paged_caches(jax_policy(mixed), gate_dtype)
    step = ProGenPagedDecodeStep(model, n_rows=20, gate_dtype=gate_dtype)
    caches = _fresh_paged_caches(model.policy, gate_dtype)
    live = np.asarray([True, True])
    got, want = [], []
    for pos in range(steps):
        jl, jcaches = japply(flax_variables, jnp.asarray(tokens[pos], jnp.int32),
                             jnp.full((2,), pos, jnp.int32), jcaches,
                             jnp.asarray(table), jnp.asarray(live))
        tl, caches = step(torch.from_numpy(tokens[pos]), pos, caches,
                          torch.from_numpy(table), torch.from_numpy(live))
        want.append(np.asarray(jl, np.float32))
        got.append(tl.float().numpy())
    return np.stack(got), np.stack(want)


def test_quantized_paged_step_matches_jax(flax_params):
    """int8 weights and 8-bit pages, f32 compute: the first step's logits at
    1e-4, and six steps on."""
    qtree, scales = jax_quantize_params(flax_params["params"])
    variables = {"params": qtree, "qscale": scales}
    model = _port(jax.tree.map(np.array, variables), weights="int8")
    got, want = _teacher_forced_paged_logits(variables, model, False, "int8", "int8", 6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_bf16_paged_step_is_within_the_bf16_bar_of_jax(flax_params):
    model = _port(flax_params, mixed=True)
    got, want = _teacher_forced_paged_logits(flax_params, model, True, "bf16", "bf16", 6)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_quantized_engine_matches_the_jax_quantized_engine(flax_params, model):
    """``quantize="weights+pages"``: greedy tokens against the JAX engine's
    at the JAX package's accuracy gate, 0.98 (on these requests every token
    is equal), and against the port's full-precision engine."""
    requests = _requests(6, mode="greedy", seed=2)
    kw = {**ENGINE, **PAGED, "quantize": "weights+pages"}
    want = _run_jax(flax_params, requests, **kw)
    eng, got = _run(model, requests, **kw)
    assert eng.model.weights == "int8" and eng.gate_dtype == "int8"
    assert eng.state["caches"]["sgu_pool"]["2"].dtype == torch.int8
    pairs = [(a, b) for u in want for a, b in zip(got[u][0], want[u][0])]
    share = sum(a == b for a, b in pairs) / sum(len(t) for t, _ in want.values())
    assert share >= 0.98, share
    assert share == 1.0, share  # the share on these requests
    _, full = _run(model, requests, **ENGINE, **PAGED)
    same = sum(a == b for u in full for a, b in zip(got[u][0], full[u][0]))
    assert same / sum(len(t) for t, _ in full.values()) >= 0.5
    weights_only = _run(model, requests, **ENGINE, quantize="weights")[0]
    assert weights_only.model.weights == "int8" and weights_only.gate_dtype == "bf16"
