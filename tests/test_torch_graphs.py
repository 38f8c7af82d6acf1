"""``ServingEngine.aot_warmup`` and its captured programs
(``decode/graphs.py``) on the CPU, f32, with the JAX init's parameters
carried across (``compat/convert.py``):

* the JAX package's gates run again on the port: a warmed engine covers
  the grid (admits per bucket + the chunk) and its tokens equal the JAX
  engine's clean run (``tests/test_chaos_serving.py``); a warm-up with the
  embedding programs serves generate and embed traffic
  (``tests/test_workloads.py``);
* ``programs`` equals the JAX ``aot_warmup``'s for the same arguments,
  dense, paged, speculative, disaggregated and with a LoRA bank, and a
  warmed port engine's tokens equal a warmed JAX engine's;
* a program whose body raises leaves ``self.state``'s tensors unchanged,
  bit for bit; after ``restore``, admissions into a running engine and
  ``reload_weights`` a warmed engine answers as an unwarmed one, and a
  reload that rebinds what the programs read captures them again;
* the staging itself: argument trees flatten and rebuild, numpy arrays
  are copied in with their dtypes, a call of another structure or shape
  raises, a call never writes its caller's tensors nor returns the
  program's own buffers, and the launch counters advance on each call of
  a program as on an eager call.

On the CPU a program has no graph: it stages its arguments as on the card
and calls its body on the static buffers (the card's replay is held to the
eager engine in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

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
from progen_tpu.workloads import lora as jax_lora
from progen_tpu_torch.compat.convert import bank_from_numpy, params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode import engine as engine_module
from progen_tpu_torch.decode import graphs
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.graphs import CapturedProgram, flatten, unflatten
from progen_tpu_torch.decode.paging import DUMP_PAGE
from progen_tpu_torch.decode.prefill import prime_buckets
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.ops import cuda_attention, cuda_paged_gate_mix, cuda_sgu
from progen_tpu_torch.resilience import faults

torch.set_num_threads(1)

# tests/test_chaos_serving.py's CFG and engine
KW = dict(num_tokens=32, dim=16, seq_len=24, depth=3, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE = dict(num_slots=2, chunk_size=4, max_len=20)
# tests/test_workloads.py's CFG (two layers, both gMLP) and engine
WL_KW = dict(num_tokens=32, dim=16, depth=2, seq_len=64, window_size=8, heads=2,
             dim_head=8, ff_mult=2)
WL_CFG, WL_JAX_CFG = ProGenConfig(**WL_KW), JaxConfig(**WL_KW)
WL_ENGINE = dict(num_slots=4, max_len=32, chunk_size=4)
PAGED = dict(paged=True, page_size=4)
MODES = {
    "dense": {},
    "paged": PAGED,
    "q8": dict(**PAGED, quantize="weights+pages"),
    "spec": dict(spec=True, spec_k=2),
    "spec_paged": dict(**PAGED, spec=True, spec_k=2),
    "disagg": dict(disagg=True),
    "disagg_paged": dict(**PAGED, disagg=True),
    "lora": dict(lora_bank=True),
    "lora_paged": dict(**PAGED, lora_bank=True),
}


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


@pytest.fixture(scope="module")
def jax_bank():
    return jax_lora.random_lora_bank(JAX_CFG, num_tenants=3, rank=2, seed=3, scale=0.5)


def _requests(n=5, *, mixed=False, lora=False):
    """tests/test_chaos_serving.py's requests (primes of 1-8 tokens from
    seed 0, greedy); with ``mixed`` the odd ones sampled, with ``lora``
    tenants 0-2 in turn."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        p = int(rng.integers(1, 9))
        sampled = mixed and i % 2 == 1
        r = dict(uid=i, tokens=rng.integers(1, CFG.num_tokens, p).tolist(),
                 max_new_tokens=8, top_k=5 if sampled else None,
                 temperature=0.8 if sampled else 0.0, seed=100 + i)
        if lora:
            r["tenant"] = i % 3
        out.append(r)
    return out


def _serve(engine, cls, requests):
    for r in requests:
        engine.submit(cls(**r))
    return {c.uid: (c.tokens.tolist(), c.status)
            for c in engine.run_until_idle(max_chunks=300)}


def _engines(mode, flax_params, model, jax_bank):
    """The JAX engine and the port's in ``mode``, on the same weights."""
    kw = dict(MODES[mode])
    jkw = dict(kw)
    if kw.pop("lora_bank", False):
        jkw["lora_bank"] = jax_bank
        kw["lora_bank"] = bank_from_numpy(jax_bank)
    jax_engine = JaxServingEngine(JAX_CFG, flax_params, policy=jax_policy(False),
                                  **ENGINE, **jkw)
    return jax_engine, ServingEngine(model, **ENGINE, **kw)


def _state_leaves(engine) -> list[torch.Tensor]:
    return flatten(engine.state)[0]


# --------------------------------------------- the JAX package's gates, ported


def test_aot_warmup_covers_grid_and_changes_nothing(flax_params, model):
    """tests/test_chaos_serving.py:351: the grid is every admit bucket and
    the chunk, and the warmed engine's tokens are the JAX engine's clean
    (unwarmed) run's."""
    eng = ServingEngine(model, **ENGINE)
    stats = eng.aot_warmup()
    buckets = prime_buckets(CFG.window_size, CFG.seq_len, eng.max_len - 1)
    assert stats["programs"] == len(buckets) + 1  # admits + the chunk
    assert set(stats) == {"programs", "seconds"} and stats["seconds"] >= 0
    assert set(eng._aot) == {("admit", b) for b in buckets} | {("chunk",)}
    assert eng._compiled_keys == set(eng._aot)
    clean = _serve(JaxServingEngine(JAX_CFG, flax_params, policy=jax_policy(False),
                                    **ENGINE), JaxRequest, _requests())
    assert _serve(eng, Request, _requests()) == clean
    assert eng.aot_warmup()["programs"] == 0  # a warmed key is not captured again


def test_aot_warmup_with_embed():
    """tests/test_workloads.py:361: embedding programs warmed beside the
    admits; generate traffic gives the JAX engine's tokens, the embed
    request is answered (its vector bit-equal to an unwarmed engine's)."""
    flax_params = _flax(WL_JAX_CFG, 0)
    model = _port(WL_CFG, flax_params)
    requests = [dict(uid=f"r{i}", tokens=[1 + (i % 5), 2, 3 + i % 3], max_new_tokens=8,
                     top_k=4 if i % 2 else None, temperature=0.9, seed=100 + i)
                for i in range(4)]
    jax_engine = JaxServingEngine(WL_JAX_CFG, flax_params, policy=jax_policy(False),
                                  **WL_ENGINE)
    dense_base = _serve(jax_engine, JaxRequest, requests)

    def run(warm):
        eng = ServingEngine(model, **WL_ENGINE)
        info = eng.aot_warmup(max_prime=16, embed=True) if warm else None
        for r in requests:
            eng.submit(Request(**r))
        eng.submit_embed(Request(uid="ew", tokens=[1, 2, 3], max_new_tokens=1))
        return info, eng.run_until_idle()

    info, out = run(True)
    assert info["programs"] == 5  # 2 buckets x (embed + admit) + the chunk
    gen = {c.uid: (c.tokens.tolist(), c.status) for c in out if c.finish_reason != "embed"}
    assert gen == dense_base
    assert [c.uid for c in out if c.finish_reason == "embed"] == ["ew"]
    _, cold = run(False)
    vec = lambda comps: [c.embedding for c in comps if c.uid == "ew"][0]
    assert np.array_equal(vec(out), vec(cold))


@pytest.mark.parametrize("max_prime,embed", [(5, False), (None, True)],
                         ids=["buckets_4_8", "full_grid_embed"])
@pytest.mark.parametrize("mode", ["dense", "paged", "spec", "disagg_paged", "lora"])
def test_programs_and_tokens_equal_the_jax_engines(flax_params, model, jax_bank, mode,
                                                   max_prime, embed):
    """The same engine arguments give the JAX ``aot_warmup``'s program
    count (and 0 on a second call), and the warmed engines the same
    tokens and statuses."""
    jax_engine, eng = _engines(mode, flax_params, model, jax_bank)
    want = jax_engine.aot_warmup(max_prime, embed=embed)["programs"]
    assert eng.aot_warmup(max_prime, embed=embed)["programs"] == want
    assert eng.aot_warmup(max_prime, embed=embed)["programs"] == 0
    assert eng._compiled_keys == set(eng._aot) == set(jax_engine._aot)
    requests = _requests(mixed=True, lora=mode.startswith("lora"))
    if max_prime is not None:  # primes of the warmed buckets only
        requests = [r for r in requests if len(r["tokens"]) <= 8]
    assert _serve(eng, Request, requests) == _serve(jax_engine, JaxRequest, requests)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_warmed_engine_answers_as_an_unwarmed_one(model, jax_bank, mode):
    """Every mode: the grid is warmed and serves the unwarmed engine's
    tokens, nine requests through two slots (admissions into a running
    engine), and again after the engine went idle."""
    kw = dict(MODES[mode])
    if kw.pop("lora_bank", False):
        kw["lora_bank"] = bank_from_numpy(jax_bank)
    requests = _requests(9, mixed=True, lora="lora_bank" in kw)
    cold = ServingEngine(model, **ENGINE, **kw)
    warm = ServingEngine(model, **ENGINE, **kw)
    warm.aot_warmup()
    for _ in range(2):
        assert _serve(warm, Request, requests) == _serve(cold, Request, requests)


# ------------------------------------------------------ state and operations


def test_a_program_whose_body_raises_leaves_the_state_unchanged(model, monkeypatch):
    """A fault mid-body (the decode step on its third call, the paged
    admit after its forward) leaves every tensor of ``self.state`` as it
    was, bit for bit; a transient one is retried and the run gives the
    unfaulted tokens."""
    eng = ServingEngine(model, **ENGINE, **PAGED)
    eng.aot_warmup()
    requests = _requests(4, mixed=True)
    for r in requests:
        eng.submit(Request(**r))
    eng.step()
    before = [t.clone() for t in _state_leaves(eng)]
    held = _state_leaves(eng)
    step, calls = eng._step_model, []

    def failing_step(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device fault mid-chunk")
        return step(*args, **kwargs)

    monkeypatch.setattr(eng, "_step_model", failing_step)
    with pytest.raises(RuntimeError, match="mid-chunk"):
        eng._chunk_call(eng._page_table.copy(), eng._paused.copy())
    assert len(calls) == 3
    assert all(a is b for a, b in zip(_state_leaves(eng), held))
    assert all(torch.equal(a, b) for a, b in zip(_state_leaves(eng), before))

    def failing_harvest(*args, **kwargs):
        raise RuntimeError("device fault after the forward")

    monkeypatch.setattr(engine_module, "harvest_gate_pages", failing_harvest)
    a = eng._admit_arrays(4)
    lmask = np.ones((2, eng.max_len, CFG.num_tokens), bool)
    wtable = np.full((2, eng.pages_per_row), DUMP_PAGE, np.int32)
    with pytest.raises(RuntimeError, match="after the forward"):
        eng._admit_call(*a.values(), lmask, wtable)
    assert all(torch.equal(a, b) for a, b in zip(_state_leaves(eng), before))
    monkeypatch.undo()

    # a transient fault inside the body: retried in place, tokens unchanged
    want = _serve(ServingEngine(model, **ENGINE, **PAGED), Request, requests)
    eng = ServingEngine(model, **ENGINE, **PAGED)
    eng.aot_warmup()
    step, calls = eng._step_model, []

    def flaky_step(*args, **kwargs):
        calls.append(1)
        if len(calls) == 6:
            raise ConnectionError("transient device fault")
        return step(*args, **kwargs)

    eng._step_model = flaky_step
    assert _serve(eng, Request, requests) == want
    assert eng.robust.faults_contained == 1


def test_restore_onto_a_warmed_engine(model, tmp_path):
    """A snapshot taken mid-run restores onto a warmed engine and replays
    to an unwarmed engine's answers."""
    kw = {**ENGINE, **PAGED}
    src = ServingEngine(model, **kw)
    for r in _requests(mixed=True):
        src.submit(Request(**r))
    for _ in range(2):
        src.step()
    snap = src.snapshot()
    pre = {c.uid: (c.tokens.tolist(), c.status) for c in src.completions}
    out = {}
    for warm in (True, False):
        eng = ServingEngine(model, **kw)
        if warm:
            eng.aot_warmup()
        eng.restore(snap)
        out[warm] = {**pre, **{c.uid: (c.tokens.tolist(), c.status)
                               for c in eng.run_until_idle(max_chunks=300)}}
    assert out[True] == out[False]


@pytest.mark.parametrize("mode,owned,recaptures", [
    ("dense", False, True),        # the caller's model: copied, so rebound
    ("dense", True, False),        # the engine's own: written in place
    ("spec", True, True),          # the identity draft gets a copy: rebound
    ("lora", True, True),          # a new bank: rebound
])
def test_reload_on_a_warmed_engine(flax_params1, model, jax_bank, monkeypatch, mode,
                                   owned, recaptures):
    """After ``reload_weights`` a warmed engine answers as an unwarmed one
    on the new weights; a reload that rebinds what the programs read (a
    copied model, the identity draft's copy, a new bank) captures every
    warmed program again, one that writes into the served tensors none."""
    kw = dict(MODES[mode])
    lora = kw.pop("lora_bank", False)
    if lora:
        kw["lora_bank"] = bank_from_numpy(jax_bank)
    new_bank = bank_from_numpy(jax_lora.random_lora_bank(JAX_CFG, num_tenants=3, rank=2,
                                                         seed=5, scale=0.5))
    p1 = params_from_flax(flax_params1)
    captures = []
    real = CapturedProgram.recapture
    monkeypatch.setattr(CapturedProgram, "recapture",
                        lambda self: (captures.append(self), real(self)))
    requests = _requests(mixed=True, lora=lora)
    out = {}
    for warm in (True, False):
        # owned: the engine builds its model (weights from seed 0)
        eng = ServingEngine(CFG if owned else model, **ENGINE, **kw,
                            device="cpu", policy=make_policy(False))
        if warm:
            eng.aot_warmup()
        first = _serve(eng, Request, requests)
        captures.clear()
        eng.reload_weights(p1, lora_bank=new_bank if lora else None)
        assert len(captures) == (len(eng._aot) if recaptures else 0)
        out[warm] = (first, _serve(eng, Request, requests))
    assert out[True] == out[False]
    assert out[True][0] != out[True][1]


def test_close_drops_the_programs(model):
    eng = ServingEngine(model, **ENGINE, **PAGED)
    eng.aot_warmup()
    assert eng._aot
    eng.close()
    assert eng._aot == {} and eng.state is None


# ---------------------------------------------------------- captured programs


def test_trees_flatten_with_sorted_keys_and_rebuild():
    tree = {"b": [torch.ones(2), torch.zeros(1)], "a": (np.arange(3), None, 4),
            "c": {"y": torch.full((1,), 2.0), "x": "text"}}
    leaves, spec = flatten(tree)
    assert [tuple(t.shape) for t in leaves] == [(3,), (2,), (1,), (1,)]
    rebuilt = unflatten(spec, leaves)
    assert list(rebuilt) == ["a", "b", "c"] and rebuilt["a"][1:] == (None, 4)
    assert rebuilt["c"]["x"] == "text" and rebuilt["b"][0] is leaves[1]
    assert flatten({"c": tree["c"], "a": tree["a"], "b": tree["b"]})[1] == spec
    assert flatten({**tree, "a": (np.arange(3), None, 5)})[1] != spec


def test_a_program_stages_copies_and_never_aliases():
    """Numpy arguments are copied in with their dtypes; a call returns
    fresh tensors (never the static buffers, never its arguments) and
    writes no tensor its caller holds; another structure, shape or dtype
    raises."""
    seen = []

    def body(state, table, flag):
        seen.append((state["x"], table))
        out = {"x": state["x"], "y": state["x"] * 2 + table.long().sum()}
        state["x"].add_(0)  # a body may touch its (static) inputs
        return out, [flag]

    x = torch.arange(4.0)
    prog = CapturedProgram(body, {"x": x}, np.zeros((2,), np.int32), np.array(True),
                           device="cpu")
    assert not prog.captured and prog.launches == {}
    got, (flag,) = prog({"x": x + 1}, np.array([1, 2], np.int32), np.array(False))
    static_x, static_table = seen[-1]
    assert static_table.dtype == torch.int32 and static_table.tolist() == [1, 2]
    assert torch.equal(got["x"], x + 1) and torch.equal(got["y"], (x + 1) * 2 + 3)
    assert got["x"].data_ptr() not in (static_x.data_ptr(), x.data_ptr())
    assert flag.dtype == torch.bool and not bool(flag)
    again, _ = prog({"x": x}, np.array([0, 0], np.int32), np.array(True))
    assert torch.equal(got["x"], x + 1)  # the first answer survives the second call
    assert torch.equal(again["x"], x) and torch.equal(x, torch.arange(4.0))
    with pytest.raises(ValueError, match="structure"):
        prog({"x": x, "z": x}, np.zeros((2,), np.int32), np.array(True))
    with pytest.raises(ValueError, match="captured for"):
        prog({"x": torch.arange(5.0)}, np.zeros((2,), np.int32), np.array(True))
    with pytest.raises(ValueError, match="captured for"):
        prog({"x": x}, np.zeros((2,), np.int64), np.array(True))


def test_launch_counters_advance_on_each_call_as_on_an_eager_one(monkeypatch):
    """A body that counts like the kernel wrappers: every call of the
    program advances the counters as an eager call does.  The replay's
    bookkeeping (a capture's counts taken back, added again per replay)
    round-trips, also after a per-route dict was replaced."""
    monkeypatch.setattr(cuda_paged_gate_mix, "launches", 0)
    monkeypatch.setattr(cuda_sgu, "launches", 0)
    monkeypatch.setattr(cuda_attention, "fwd_route_launches", {"wgmma": 0, "wmma": 0})

    def body(x):
        cuda_paged_gate_mix.launches += 2
        cuda_sgu.launches += 1
        cuda_attention.fwd_route_launches["wgmma"] += 12
        return x + 1

    counts = lambda: (cuda_paged_gate_mix.launches, cuda_sgu.launches,
                      cuda_attention.fwd_route_launches["wgmma"])
    body(torch.zeros(3))
    eager = counts()
    prog = CapturedProgram(body, torch.zeros(3), device="cpu")
    assert counts() == eager  # building a program on the CPU runs nothing
    for k in range(1, 4):
        prog(torch.zeros(3))
        assert counts() == tuple(n * (k + 1) for n in eager)

    before = graphs.launch_counts()
    body(torch.zeros(3))
    delta = graphs.counts_since(before)
    assert delta == {(cuda_paged_gate_mix, "launches", None): 2,
                     (cuda_sgu, "launches", None): 1,
                     (cuda_attention, "fwd_route_launches", "wgmma"): 12}
    graphs.add_counts(delta, sign=-1)
    assert graphs.launch_counts() == before
    cuda_attention.fwd_route_launches = {"wgmma": 0, "wmma": 0}  # a reset
    graphs.add_counts(delta)
    assert cuda_attention.fwd_route_launches == {"wgmma": 12, "wmma": 0}
