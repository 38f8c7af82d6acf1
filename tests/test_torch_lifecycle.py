"""The serving engine's resume and operations on the CPU, f32, with the JAX
init's parameters carried across (``compat/convert.py``), each held to the
JAX engine's tokens on the same requests:

* the JAX package's gates run again on the port: snapshot mid-run, restore
  on a fresh engine and replay (``tests/test_chaos_serving.py``; under
  8-bit pages ``tests/test_quant.py``; under speculation and with handles
  in the handoff queue ``tests/test_spec_decode.py``); a crash after the
  retries are spent; ``run_with_restarts`` over an injected transient
  fault, two engines built; the watchdog beating through a chaos run;
  priorities through a snapshot (``tests/test_qos.py``); a mask, a tenant
  and an embedding through a snapshot (``tests/test_workloads.py``); a
  reload that re-quantizes (``tests/test_quant.py``);
* after the same steps the port's ``snapshot()`` equals the JAX engine's
  (``deadline_remaining`` within 0.5 s) dense, paged, speculative,
  disaggregated and with a bank, a mask and an embedding; a snapshot the
  JAX engine wrote restores on the port to JAX's tokens;
* ``reload_weights`` gives a fresh engine's tokens on the new weights (the
  8-bit engine's weights bit-equal to a fresh one's), stamps
  ``generation``, checks its input as JAX does, and under speculation
  leaves the identity draft on the old weights, so the acceptance counters
  are JAX's;
* ``close()``: no strong reference to a closed, deleted engine's or
  Trainer's model survives ``gc.collect()`` (a failing wandb init that
  keeps its traceback included);
* the sample CLI's restart-and-replay, snapshot and trace flags."""

import dataclasses
import gc
import json
import sys
import time
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxServingEngine
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.parallel import unbox
from progen_tpu.workloads import ScaffoldSpec as JaxScaffoldSpec
from progen_tpu.workloads import lora as jax_lora
from progen_tpu_torch import sample
from progen_tpu_torch.compat.convert import bank_from_numpy, params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.decode import run_with_restarts
from progen_tpu_torch.decode.engine import STATUS_OK, Request, ServingEngine
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe import tracker as tracker_mod
from progen_tpu_torch.observe.tracker import Tracker
from progen_tpu_torch.resilience import RetryError, Watchdog, faults
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig
from progen_tpu_torch.workloads import ScaffoldSpec

torch.set_num_threads(1)

# tests/test_chaos_serving.py's CFG
KW = dict(num_tokens=32, dim=16, seq_len=24, depth=3, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE = dict(num_slots=2, chunk_size=4, max_len=20)
MODES = {
    "dense": {},
    "paged": dict(paged=True, page_size=4),
    "q8": dict(paged=True, page_size=4, quantize="weights+pages"),
    "spec": dict(spec=True, spec_k=2),
    "disagg": dict(disagg=True),
}
# tests/test_workloads.py's CFG (two layers, both gMLP) and engine
WL_KW = dict(num_tokens=32, dim=16, depth=2, seq_len=64, window_size=8, heads=2,
             dim_head=8, ff_mult=2)
WL_CFG, WL_JAX_CFG = ProGenConfig(**WL_KW), JaxConfig(**WL_KW)
WL_ENGINE = dict(num_slots=4, max_len=32, chunk_size=4)


@pytest.fixture(autouse=True)
def no_fault_plan():
    faults.reset()
    yield
    faults.reset()


def _flax(cfg, seed):
    model = JaxProGen(config=cfg, policy=jax_policy(False))
    tokens = jnp.zeros((2, cfg.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(seed), tokens))


def _port(cfg, params):
    m = ProGen(cfg, make_policy(False), device="cpu")
    m.load_state_dict(params_from_flax(params))
    return m.eval()


@pytest.fixture(scope="module")
def flax_params():
    return _flax(JAX_CFG, 7)


@pytest.fixture(scope="module")
def flax_params1():
    """Another draw: the weights a reload swaps in."""
    return _flax(JAX_CFG, 11)


@pytest.fixture(scope="module")
def model(flax_params):
    return _port(CFG, flax_params)


def _requests(n=5, *, mixed=True, max_new=8):
    """The JAX gates' requests: primes of 1-8 tokens from seed 0; with
    ``mixed`` the odd ones sampled (top-k 5, temperature 0.8)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        p = int(rng.integers(1, 9))
        sampled = mixed and i % 2 == 1
        out.append(dict(uid=i, tokens=rng.integers(1, CFG.num_tokens, p).tolist(),
                        max_new_tokens=max_new, top_k=5 if sampled else None,
                        temperature=0.8 if sampled else 0.0, seed=100 + i))
    return out


def _jax_engine(params, **kw):
    return JaxServingEngine(JAX_CFG, params, policy=jax_policy(False), **kw)


def _submit(engine, cls, reqs):
    for r in reqs:
        engine.submit(cls(**r))
    return engine


def _out(comps):
    return {c.uid: (c.tokens.tolist(), c.status) for c in comps}


_CLEAN: dict = {}


def _jax_clean(flax_params, mode, mixed=True):
    """The JAX engine's uninterrupted run of the five requests in ``mode``."""
    key = (mode, mixed, id(flax_params))
    if key not in _CLEAN:
        eng = _submit(_jax_engine(flax_params, **ENGINE, **MODES[mode]), JaxRequest,
                      _requests(mixed=mixed))
        _CLEAN[key] = _out(eng.run_until_idle(max_chunks=300))
    return _CLEAN[key]


# --------------------------------------------- the JAX package's gates, ported


@pytest.mark.parametrize("mode", sorted(MODES))
def test_snapshot_restore_midrun_parity(flax_params, model, tmp_path, mode):
    """Snapshot after two steps (some finished, some mid-decode, some
    queued; under ``disagg`` some handed off), restore on a fresh engine:
    the completions before plus the replay equal the JAX engine's
    uninterrupted run."""
    kw = {**ENGINE, **MODES[mode]}
    mixed = mode != "q8"  # the quant gate's requests are greedy
    eng = _submit(ServingEngine(model, **kw), Request, _requests(mixed=mixed))
    for _ in range(2):
        eng.step()
    path = str(tmp_path / "snap.json")
    eng.snapshot(path)
    pre = _out(eng.completions)
    fresh = ServingEngine(model, **kw)
    assert fresh.restore(path) == 5 - len(pre)
    post = _out(fresh.run_until_idle(max_chunks=300))
    assert {**pre, **post} == _jax_clean(flax_params, mode, mixed)


def test_crash_consistent_after_retry_exhaustion(flax_params, model):
    """A transient fault past the retry budget raises RetryError, and the
    engine stays consistent: its snapshot replays on a fresh engine."""
    faults.configure("serve.decode_chunk:unavailable:at=2", seed=0)
    eng = _submit(ServingEngine(model, **ENGINE, fault_retries=0), Request, _requests())
    with pytest.raises(RetryError):
        eng.run_until_idle(max_chunks=300)
    faults.configure("")
    pre = _out(eng.completions)
    fresh = ServingEngine(model, **ENGINE)
    fresh.restore(eng.snapshot())
    post = _out(fresh.run_until_idle(max_chunks=300))
    assert {**pre, **post} == _jax_clean(flax_params, "dense")


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_run_with_restarts_replays_token_identical(flax_params, model, tmp_path, mode):
    """The restart-and-replay loop: a crash mid-stream builds a fresh engine
    from the snapshot (written to ``snapshot_path``); the merged output is
    the JAX engine's uninterrupted run; every engine built is closed."""
    built = []

    def factory():
        built.append(ServingEngine(model, **ENGINE, **MODES[mode], fault_retries=0))
        return built[-1]

    faults.configure("serve.decode_chunk:unavailable:at=2", seed=0)
    path = tmp_path / "crash.json"
    comps = run_with_restarts(factory, [Request(**r) for r in _requests()],
                              attempts=3, max_chunks=300, snapshot_path=str(path))
    assert _out(comps) == _jax_clean(flax_params, mode)
    assert len(built) == 2  # the first engine and one rebuild
    assert all(e.state is None for e in built)
    snap = json.loads(path.read_text())
    assert snap["kind"] == "serving_snapshot" and snap["requests"]


def test_run_with_restarts_reraises_fatal_and_exhaustion(model):
    faults.configure("serve.decode_chunk:unavailable:times=50", seed=0)
    built = []

    def factory():
        built.append(ServingEngine(model, **ENGINE, fault_retries=0))
        return built[-1]

    with pytest.raises(RetryError):
        run_with_restarts(factory, [Request(**r) for r in _requests(2)], attempts=2)
    assert len(built) == 2 and all(e.state is None for e in built)
    faults.configure("serve.decode_chunk:unavailable:at=1", seed=0)
    built.clear()
    with pytest.raises(RetryError):  # a classifier that calls nothing transient
        run_with_restarts(factory, [Request(**r) for r in _requests(2)],
                          classifier=lambda e: False)
    assert len(built) == 1 and built[0].state is None


def test_watchdog_beats_through_serve_steps(model, tmp_path):
    """The engine beats the watchdog each step and pauses it around each
    program's first dispatch: a healthy chaos run never trips it."""
    exits = []
    wd = Watchdog(timeout=30.0, out_dir=str(tmp_path), exit_fn=exits.append,
                  poll_interval=0.05)
    wd.start()
    try:
        faults.configure("serve.decode_chunk:io_error:at=1", seed=0)
        eng = _submit(ServingEngine(model, **ENGINE, watchdog=wd), Request, _requests(3))
        comps = eng.run_until_idle(max_chunks=300)
        beat = wd._last_beat
    finally:
        wd.stop()
    assert len(comps) == 3 and not wd.tripped and not exits
    assert wd._last_note == "serve.step" and beat > 0
    assert ("chunk",) in eng._compiled_keys
    assert any(k[0] == "admit" for k in eng._compiled_keys)


def test_watchdog_is_paused_around_cold_dispatches_only(model):
    """The first dispatch of each program key runs paused; a warm one
    does not."""
    pauses = []

    class Recording(Watchdog):
        def paused(self):
            pauses.append(True)
            return super().paused()

    wd = Recording(timeout=30.0, exit_fn=lambda code: None)
    eng = _submit(ServingEngine(model, **ENGINE, watchdog=wd), Request, _requests(5))
    eng.run_until_idle(max_chunks=300)
    assert len(pauses) == len(eng._compiled_keys) < eng.chunks_run


def test_priority_survives_snapshot_restore(flax_params, model):
    """tests/test_qos.py: a priority rides the snapshot, and the replay is
    the JAX engine's."""
    reqs = _requests(3)
    reqs[1]["priority"] = 2

    def run(cls, eng_fn):
        eng = eng_fn(num_slots=1, chunk_size=4, max_len=20)
        eng.submit(cls(**reqs[0]))
        eng.step()
        eng.submit(cls(**reqs[1]))
        eng.submit(cls(**reqs[2]))
        return eng

    eng = run(Request, lambda **kw: ServingEngine(model, **kw))
    snap = eng.snapshot()
    fresh = ServingEngine(model, num_slots=1, chunk_size=4, max_len=20)
    fresh.restore(snap)
    by_uid = {r.uid: r for r in fresh._queue}
    assert by_uid[1].priority == 2 and by_uid[2].priority == 0
    want = {c.uid: c.tokens.tolist() for c in eng.run_until_idle(max_chunks=200)}
    got = {c.uid: c.tokens.tolist() for c in fresh.run_until_idle(max_chunks=200)}
    assert got == want
    jax_eng = run(JaxRequest, lambda **kw: _jax_engine(flax_params, **kw))
    assert jax_eng.snapshot() == _without_deadlines(snap)
    assert {c.uid: c.tokens.tolist() for c in jax_eng.run_until_idle(max_chunks=200)} == want


def test_reload_weights_requantizes(flax_params, model):
    """tests/test_quant.py: ``reload_weights`` takes full-precision weights
    and quantizes them at the door, so a reloaded engine replays its
    completions (the JAX engine's)."""
    kw = {**ENGINE, "num_slots": 3, "quantize": "weights"}
    eng = _submit(ServingEngine(model, **kw), Request, _requests(6, mixed=False))
    first = _out(eng.run_until_idle(max_chunks=300))
    assert eng.reload_weights(params=model.state_dict()) == 1
    again = _submit(eng, Request, _requests(6, mixed=False)).run_until_idle(max_chunks=300)
    assert _out(again) == first
    assert all(c.generation == 1 for c in again)
    jax_eng = _submit(_jax_engine(flax_params, **kw), JaxRequest, _requests(6, mixed=False))
    assert _out(jax_eng.run_until_idle(max_chunks=300)) == first


@pytest.fixture(scope="module")
def wl_params():
    return _flax(WL_JAX_CFG, 0)


@pytest.fixture(scope="module")
def wl_model(wl_params):
    return _port(WL_CFG, wl_params)


@pytest.fixture(scope="module")
def jax_bank():
    return jax_lora.random_lora_bank(WL_JAX_CFG, num_tenants=4, rank=2, seed=3, scale=0.5)


SCAFFOLD = dict(template=[1, 2, None, 7, None, (5, 6), 9], alphabet=[3, 4, 5, 6, 7, 8, 9, 10])


def _wl_submit(eng, request_cls, scaffold_cls, extra=0, deadline=None):
    """tests/test_workloads.py's snapshot traffic: a masked request on
    tenant 2, an embedding; here also a priority, a ``deadline`` (an
    absolute instant, 600 s ahead by default: one instant for two engines
    keeps their remaining budgets comparable) and ``extra`` more requests
    on tenants 0-3 (past the four slots, some stay queued)."""
    deadline = time.perf_counter() + 600.0 if deadline is None else deadline
    scaffold = scaffold_cls(vocab=WL_CFG.num_tokens, **SCAFFOLD)
    eng.submit(request_cls(uid="snap", seed=7, top_k=3, tenant=2, priority=1,
                           **scaffold.request_kwargs()))
    eng.submit(request_cls(uid="late", tokens=[4, 5, 6], max_new_tokens=6, seed=9,
                           tenant=1, deadline=deadline))
    eng.submit_embed(request_cls(uid="esnap", tokens=[1, 2, 3], max_new_tokens=1))
    for i in range(extra):
        eng.submit(request_cls(uid=f"x{i}", tokens=[1 + i % 5, 2, 3], max_new_tokens=12,
                               temperature=0.9, seed=200 + i, tenant=i % 4))
    return eng


def _wl_out(comps):
    return {c.uid: (c.prime.tolist(), c.tokens.tolist(), c.finish_reason) for c in comps}


def test_snapshot_roundtrip_mask_tenant_embed(wl_params, wl_model, jax_bank):
    """tests/test_workloads.py: a mask, a tenant and an embedding ride the
    snapshot; the restored run equals a fresh one, and both equal the JAX
    engine's (the embedding at 1e-5)."""
    bank = bank_from_numpy(jax_bank)
    mk = lambda: ServingEngine(wl_model, **WL_ENGINE, lora_bank=bank)
    snap = _wl_submit(mk(), Request, ScaffoldSpec).snapshot()
    restored = mk()
    assert restored.restore(snap) == 3
    out_r = restored.run_until_idle()
    out_f = _wl_submit(mk(), Request, ScaffoldSpec).run_until_idle()
    assert _wl_out(out_r) == _wl_out(out_f)
    emb = lambda out: [c.embedding for c in out if c.uid == "esnap"][0]
    assert np.array_equal(emb(out_r), emb(out_f))
    jax_eng = JaxServingEngine(WL_JAX_CFG, wl_params, policy=jax_policy(False),
                               **WL_ENGINE, lora_bank=jax_bank)
    out_j = _wl_submit(jax_eng, JaxRequest, JaxScaffoldSpec).run_until_idle()
    assert _wl_out(out_r) == _wl_out(out_j)
    np.testing.assert_allclose(emb(out_r), emb(out_j), rtol=1e-5, atol=1e-5)


# ------------------------------------------------- the snapshot against JAX's


def _without_deadlines(snap):
    return {**snap, "requests": [{k: v for k, v in e.items() if k != "deadline_remaining"}
                                 for e in snap["requests"]]}


def _assert_same_snapshot(got, want):
    assert _without_deadlines(got) == _without_deadlines(want)
    for g, w in zip(got["requests"], want["requests"]):
        assert ("deadline_remaining" in g) == ("deadline_remaining" in w)
        if "deadline_remaining" in g:
            assert abs(g["deadline_remaining"] - w["deadline_remaining"]) < 0.5


@pytest.mark.parametrize("mode", ["dense", "paged", "spec", "disagg"])
@pytest.mark.parametrize("steps", [1, 2])
def test_snapshot_equals_the_jax_engines(flax_params, model, mode, steps):
    """After the same steps, the port's snapshot is the JAX engine's:
    in-flight rows first with their tokens so far, then handed-off, queued
    requests; a deadline as its remaining budget (both snapshots taken
    together, against one deadline)."""
    reqs = _requests(7)
    reqs[5]["deadline"] = time.perf_counter() + 300.0
    reqs[6]["priority"] = 1
    ours = _submit(ServingEngine(model, **ENGINE, **MODES[mode]), Request, reqs)
    theirs = _submit(_jax_engine(flax_params, **ENGINE, **MODES[mode]), JaxRequest, reqs)
    for _ in range(steps):
        ours.step()
        theirs.step()
    got, want = ours.snapshot(), theirs.snapshot()
    _assert_same_snapshot(got, want)
    assert json.loads(json.dumps(got)) == got
    # (the deadline and the priority put requests 5 and 6 first: EDF and
    # the priority class preempt, so after two steps they are served)
    left = [e.get("deadline_remaining") for e in got["requests"]]
    assert all(d is None or 200 < d <= 300 for d in left)
    # rows in flight: after the first step (disaggregated, after the second:
    # its first step prefills only)
    if steps == (2 if mode == "disagg" else 1):
        assert any(e["generated"] for e in got["requests"])


def test_snapshot_with_bank_mask_and_embed_equals_the_jax_engines(wl_params, wl_model,
                                                                  jax_bank):
    bank = bank_from_numpy(jax_bank)
    deadline = time.perf_counter() + 600.0
    ours = _wl_submit(ServingEngine(wl_model, **WL_ENGINE, lora_bank=bank, paged=True,
                                    page_size=8, num_pages=64), Request, ScaffoldSpec, 5,
                      deadline)
    theirs = _wl_submit(JaxServingEngine(WL_JAX_CFG, wl_params, policy=jax_policy(False),
                                         **WL_ENGINE, lora_bank=jax_bank, paged=True,
                                         page_size=8, num_pages=64),
                        JaxRequest, JaxScaffoldSpec, 5, deadline)
    # before a step: the mask, the tenant, the priority, the deadline and the
    # embedding all wait in the queues
    _assert_same_snapshot(ours.snapshot(), theirs.snapshot())
    first = ours.snapshot()["requests"]
    assert [e.get("workload") for e in first].count("embed") == 1
    masked = [e for e in first if e["uid"] == "snap"][0]
    assert masked["logit_mask"] and masked["tenant"] == 2 and masked["priority"] == 1
    ours.step()
    theirs.step()
    got, want = ours.snapshot(), theirs.snapshot()
    _assert_same_snapshot(got, want)
    assert got["requests"] and any(e["generated"] for e in got["requests"])


def test_a_jax_snapshot_restores_on_the_port(flax_params, model, tmp_path):
    """A snapshot file the JAX engine wrote after two steps restores on the
    port: JAX's completions before it plus the port's replay equal JAX's
    uninterrupted run."""
    eng = _submit(_jax_engine(flax_params, **ENGINE), JaxRequest, _requests())
    eng.step()
    eng.step()
    path = str(tmp_path / "jax_snap.json")
    eng.snapshot(path)
    pre = _out(eng.completions)
    fresh = ServingEngine(model, **ENGINE, paged=True, page_size=4)  # any shape
    assert fresh.restore(path) == 5 - len(pre)
    post = _out(fresh.run_until_idle(max_chunks=300))
    assert {**pre, **post} == _jax_clean(flax_params, "dense")


def test_restore_refuses_a_busy_engine(model):
    snap = {"version": 1, "kind": "serving_snapshot", "requests": []}
    with pytest.raises(ValueError, match="not a serving snapshot"):
        ServingEngine(model, **ENGINE).restore({"kind": "other"})
    busy = _submit(ServingEngine(model, **ENGINE), Request, _requests(1))
    with pytest.raises(RuntimeError, match="idle engine"):
        busy.restore(snap)
    # a live handoff queue counts as work
    eng = _submit(ServingEngine(model, **ENGINE, disagg=True), Request, _requests(5))
    eng.step()
    eng.step()
    assert len(eng._handoff) > 0
    eng._inflight.clear()
    while eng._queue:
        eng._queue.popleft()
    with pytest.raises(RuntimeError, match="idle engine"):
        eng.restore(snap)


# ------------------------------------------------------------- reload_weights


@pytest.mark.parametrize("mode", ["dense", "paged", "q8"])
def test_reload_gives_a_fresh_engines_tokens(flax_params, flax_params1, model, mode):
    """From weights P0 to P1 at idle: the tokens are a fresh engine's on P1
    (and the JAX engine's after the same reload), every completion carries
    generation 1; under 8-bit weights the serving weights are bit-equal to
    a fresh engine's."""
    kw = {**ENGINE, **MODES[mode]}
    new = params_from_flax(flax_params1)
    eng = _submit(ServingEngine(model, **kw), Request, _requests())
    before = eng.run_until_idle(max_chunks=300)
    assert all(c.generation == 0 for c in before)
    assert eng.reload_weights(params=new) == 1 and eng.generation == 1
    got = _submit(eng, Request, _requests()).run_until_idle(max_chunks=300)
    assert all(c.generation == 1 for c in got)
    fresh = ServingEngine(_port(CFG, flax_params1), **kw)
    want = _submit(fresh, Request, _requests()).run_until_idle(max_chunks=300)
    assert _out(got) == _out(want)
    if mode == "q8":
        for k, v in fresh.model.state_dict().items():
            assert torch.equal(eng.model.state_dict()[k], v), k
    jax_eng = _jax_engine(flax_params, **kw)
    assert jax_eng.reload_weights(params=flax_params1) == 1
    jax_got = _submit(jax_eng, JaxRequest, _requests()).run_until_idle(max_chunks=300)
    assert _out(got) == _out(jax_got)
    assert [c.generation for c in got] == [c.generation for c in jax_got]
    # the weights went into the engine's own model, not the caller's
    for k, v in params_from_flax(flax_params).items():
        assert torch.equal(model.state_dict()[k], v), k


def test_reload_under_spec_keeps_the_draft_and_jax_counters(flax_params, flax_params1,
                                                            model):
    """Under speculation with the identity draft a reload swaps the target
    only (the JAX engine keeps the old tree as its draft): the tokens are
    the new weights' and ``spec_counters()`` are JAX's."""
    kw = {**ENGINE, **MODES["spec"]}
    eng = ServingEngine(_port(CFG, flax_params), **kw)
    eng.reload_weights(params=params_from_flax(flax_params1))
    assert eng._draft is not eng.model
    got = _submit(eng, Request, _requests()).run_until_idle(max_chunks=300)
    jax_eng = _jax_engine(flax_params, **kw)
    jax_eng.reload_weights(params=flax_params1)
    want = _submit(jax_eng, JaxRequest, _requests()).run_until_idle(max_chunks=300)
    assert _out(got) == _out(want)
    fresh = _submit(ServingEngine(_port(CFG, flax_params1), **ENGINE), Request,
                    _requests()).run_until_idle(max_chunks=300)
    assert _out(got) == _out(fresh)
    ours, theirs = eng.spec_counters(), jax_eng.spec_counters()
    for k in ("spec_k", "spec_emitted_tokens", "spec_verify_rounds",
              "accepted_tokens_per_round"):
        assert ours[k] == theirs[k], k


def test_reload_checks_its_input_as_jax_does(flax_params, model, jax_bank, wl_model):
    eng = ServingEngine(model, **ENGINE)
    with pytest.raises(ValueError, match="needs params and/or lora_bank"):
        eng.reload_weights()
    with pytest.raises(ValueError, match="without a LoRA bank"):
        eng.reload_weights(lora_bank=bank_from_numpy(jax_bank))
    state = params_from_flax(flax_params)
    with pytest.raises(ValueError, match="params tree structure does not match"):
        eng.reload_weights(params={k: v for k, v in state.items() if k != "embed.weight"})
    bad = {**state, "embed.weight": state["embed.weight"][:, :8]}
    with pytest.raises(ValueError, match="params leaf mismatch"):
        eng.reload_weights(params=bad)
    with pytest.raises(ValueError, match="params leaf mismatch"):
        eng.reload_weights(params={**state, "embed.weight": state["embed.weight"].double()})
    assert eng.generation == 0
    assert eng.reload_weights(params=model, generation=7) == 7
    banked = ServingEngine(wl_model, **WL_ENGINE, lora_bank=bank_from_numpy(jax_bank))
    assert banked.reload_weights(lora_bank=bank_from_numpy(jax_bank)) == 1
    with pytest.raises(ValueError):
        banked.reload_weights(lora_bank={"attn0": {}})


# ---------------------------------------------------------------------- close


def test_a_closed_deleted_engine_leaves_no_reference(flax_params):
    for kw in ({}, MODES["q8"], MODES["spec"], MODES["disagg"]):
        model = _port(CFG, flax_params)
        ref = weakref.ref(next(model.parameters()))
        eng = _submit(ServingEngine(model, **ENGINE, **kw), Request, _requests(3))
        eng.step()
        eng.close()
        eng.close()  # twice is fine
        assert eng.status()["chunks_run"] >= 0  # host records stay readable
        with pytest.raises(RuntimeError, match="closed"):
            eng.step()
        del eng, model
        gc.collect()
        assert ref() is None, kw


@pytest.fixture
def failing_wandb(monkeypatch):
    """A wandb whose init fails and keeps the exception (and so its
    traceback and every frame below it), as a real one without a login
    may."""
    kept = []

    def init(**kwargs):
        try:
            raise RuntimeError("no login")
        except RuntimeError as e:
            kept.append(e)
            raise

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    yield kept
    kept.clear()


def test_a_closed_deleted_trainer_leaves_no_reference(tmp_path, failing_wandb):
    """The holders found: the Trainer's SIGTERM handler (a bound method)
    and, through a failing wandb init's kept traceback, the frame that built
    the Tracker; ``close()`` gives SIGTERM back and the Tracker inits wandb
    on a thread of its own."""
    d = tmp_path / "data"
    d.mkdir()
    rng = np.random.default_rng(0)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 30), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 8, "train"), [mk() for _ in range(8)])
    write_tfrecord(d / shard_filename(0, 2, "valid"), [mk() for _ in range(2)])
    tcfg = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=16,
                        global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)

    def run():
        trainer = Trainer(tcfg, TrainerConfig(
            batch_size=2, grad_accum_every=1, validate_every=1000, sample_every=1000,
            checkpoint_every=1, mixed_precision=False, log_every=1, max_steps=2,
            statusz_port=0), str(d), str(tmp_path / "ck"),
            tracker=Tracker(out_dir=str(tmp_path / "runs")), device="cpu")
        out = trainer.run()
        ref = weakref.ref(next(iter(out["state"].params.values())))
        trainer.close()
        return ref

    ref = run()
    gc.collect()
    assert failing_wandb, "the fake wandb was not called"
    assert ref() is None
    assert tracker_mod._wandb_or_none() is sys.modules["wandb"]


# ------------------------------------------------------------------------ CLI


def test_sample_cli_restarts_snapshots_and_traces(tmp_path, capsys):
    """``--serve`` through ``run_with_restarts``: a transient fault past the
    engine's retries writes the snapshot and replays on a fresh engine, and
    the answer equals a run without the fault; ``--trace`` writes a merged
    trace holding the engine's spans."""
    base = ["--serve", "--config", "default", "--seed", "0", "--prime", "MKV|MALWTR|M",
            "--top_k", "25", "--seq_len", "24", "--slots", "2", "--chunk", "4",
            "--paged", "--page_size", "4", "--device", "cpu"]
    want = sample.main(base)
    capsys.readouterr()
    faults.configure("serve.decode_chunk:unavailable:times=4", seed=0)
    snap = tmp_path / "snap.json"
    got = sample.main(base + ["--serve_attempts", "2", "--snapshot_path", str(snap),
                              "--trace", "--trace_out", str(tmp_path / "traces")])
    captured = capsys.readouterr()
    assert "restarting and replaying" in captured.err
    strip = lambda recs: [{k: v for k, v in r.items() if k != "latency_s"} for r in recs]
    assert strip(got) == strip(want)
    assert json.loads(snap.read_text())["kind"] == "serving_snapshot"
    lines = [json.loads(line) for line in captured.out.splitlines()]
    trace_file = [line["trace"] for line in lines if "trace" in line][0]
    names = {e["name"] for e in json.load(open(trace_file))["traceEvents"]}
    assert {"serve.submit", "serve.admit_prefill", "serve.decode_chunk"} <= names


def test_sample_cli_refuses_aot_warmup(capsys):
    """``--aot_warmup`` without ``--serve`` is refused (it warms the
    engine); with ``--serve`` the engine is warmed (one admit program for
    the one bucket, 512, and the decode chunk) and answers as an unwarmed
    engine does."""
    with pytest.raises(SystemExit):
        sample.main(["--aot_warmup", "--config", "default", "--device", "cpu"])
    base = ["--serve", "--config", "default", "--device", "cpu", "--prime", "MKV|MALWTR|M",
            "--seq_len", "24", "--slots", "2", "--chunk", "4"]
    want = sample.main(base)
    capsys.readouterr()
    got = sample.main(["--serve", "--aot_warmup", "--config", "default", "--device", "cpu",
                       *base[5:]])
    assert "aot warmup: 2 programs in" in capsys.readouterr().err
    strip = lambda recs: [{k: v for k, v in r.items() if k != "latency_s"} for r in recs]
    assert strip(got) == strip(want) and len(got) == 3
