"""The port's speculative decoding against the JAX package's, on the CPU in
f32 with the parameters of the JAX init carried over: the acceptance rule,
the draft-config contract and ``draft_config_for``, the dense step's
``write_ok`` (a row it masks writes nothing, the port's stand-in for the JAX
engine's merge of the old caches), and the engine with ``spec=True``, dense
and paged, full precision and 8-bit pages, with the identity draft and with
a ``draft_config_for`` draft and with a noisy copy of the target (rounds
that end at every step): the JAX engine's tokens, statuses and
``spec_counters()``, and the port's plain engine's tokens; a transient
``serve.verify`` fault is retried in place and changes no token."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxServingEngine
from progen_tpu.decode import check_draft_config as jax_check_draft_config
from progen_tpu.decode import spec_acceptance as jax_spec_acceptance
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.models import draft_config_for as jax_draft_config_for
from progen_tpu.models.configs import CONFIGS as JAX_CONFIGS
from progen_tpu.parallel import unbox
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode import check_draft_config, spec_acceptance
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.incremental import ProGenDecodeStep, init_caches
from progen_tpu_torch.models import CONFIGS, ProGen, ProGenConfig, draft_config_for
from progen_tpu_torch.resilience import faults

torch.set_num_threads(1)

# tests/test_spec_decode.py's CFG: f32, three layers, a gMLP tail of one
KW = dict(num_tokens=32, dim=16, seq_len=24, depth=3, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE = dict(num_slots=2, chunk_size=4, max_len=20)
PAGED = dict(paged=True, page_size=4)
JAX_COUNTERS = ("spec_k", "spec_emitted_tokens", "spec_verify_rounds",
                "accepted_tokens_per_round")


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    tokens = jnp.zeros((2, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(7), tokens))


@pytest.fixture(scope="module")
def flax_draft():
    """A different, quarter-width draft with its own random weights: its
    proposals rarely match, so nearly every round rejects early."""
    dcfg = jax_draft_config_for(JAX_CFG)
    model = JaxProGen(config=dcfg, policy=jax_policy(False))
    tokens = jnp.zeros((2, CFG.seq_len), jnp.int32)
    return dcfg, unbox(jax.jit(model.init)(jax.random.key(99), tokens))


@pytest.fixture(scope="module")
def flax_perturbed(flax_params):
    """A draft of the target's config whose weights are the target's plus
    seeded noise of a tenth of each tensor's spread: it agrees with the
    target on about half of its proposals, so rounds end at every step."""
    rng = np.random.default_rng(1)

    def noisy(a):
        a = np.asarray(a)
        return a + 0.1 * a.std() * rng.standard_normal(a.shape).astype(np.float32)

    return JAX_CFG, jax.tree.map(noisy, flax_params)


@pytest.fixture(scope="module")
def model(flax_params):
    return _port(CFG, flax_params)


@pytest.fixture(autouse=True)
def no_fault_plan():
    faults.reset()
    yield
    faults.reset()


def _port(config, params):
    m = ProGen(config, make_policy(False), device="cpu")
    m.load_state_dict(params_from_flax(params))
    return m.eval()


def _requests(n=5, *, seed=0, max_new=8):
    """tests/test_spec_decode.py's requests: greedy and sampled (top-k 5,
    temperature 0.8) in turns, each its own seed."""
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


# ------------------------------------------------------- acceptance rule


@pytest.mark.parametrize("sampled, proposed, done", [
    ([[5, 6, 7]], [[5, 6]], [[False, False, False]]),      # all accepted + bonus
    ([[5, 6, 7]], [[4, 6]], [[False, False, False]]),      # first mismatch
    ([[5, 6, 7, 8]], [[5, 9, 7]], [[False] * 4]),          # mid mismatch
    ([[5, 6, 7]], [[5, 6]], [[True, False, False]]),       # done cuts a match
    ([[5, 6, 7]], [[5, 6]], [[False, True, False]]),
    ([[5, 6, 7], [1, 2, 3]], [[5, 6], [9, 2]], [[False] * 3, [False] * 3]),
], ids=["full", "first-miss", "mid-miss", "done-0", "done-1", "batched"])
def test_spec_acceptance_matches_jax_on_the_hand_cases(sampled, proposed, done):
    live, emitted = spec_acceptance(sampled, proposed, done)
    jlive, jemitted = jax_spec_acceptance(sampled, proposed, done)
    np.testing.assert_array_equal(live, jlive)
    np.testing.assert_array_equal(emitted, jemitted)
    assert live[..., 0].all()  # step 0 is the target's own sample


def test_spec_acceptance_matches_jax_on_random_rounds():
    rng = np.random.default_rng(11)
    for k in (1, 2, 4, 7):
        sampled = rng.integers(0, 3, size=(6, 5, k + 1))
        proposed = rng.integers(0, 3, size=(6, 5, k))
        done = rng.random(size=(6, 5, k + 1)) < 0.2
        live, emitted = spec_acceptance(sampled, proposed, done)
        jlive, jemitted = jax_spec_acceptance(sampled, proposed, done)
        np.testing.assert_array_equal(live, jlive)
        np.testing.assert_array_equal(emitted, jemitted)
        assert (emitted >= 1).all() and (emitted <= k + 1).all()
    with pytest.raises(ValueError):
        spec_acceptance([[1, 2]], [[1, 2]], [[False, False]])


@pytest.mark.parametrize("field, value", [(None, None), ("num_tokens", 64),
                                          ("window_size", 8), ("seq_len", 48),
                                          ("dim", 64), ("depth", 1)])
def test_check_draft_config_matches_jax(field, value):
    draft, jdraft = draft_config_for(CFG), jax_draft_config_for(JAX_CFG)
    if field is not None:
        draft = dataclasses.replace(draft, **{field: value})
        jdraft = dataclasses.replace(jdraft, **{field: value})
    try:
        jax_check_draft_config(JAX_CFG, jdraft)
    except ValueError as e:
        with pytest.raises(ValueError, match=field) as got:
            check_draft_config(CFG, draft)
        assert str(got.value) == str(e)
    else:
        check_draft_config(CFG, draft)  # capacity knobs are free


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_draft_config_for_matches_jax(name):
    got = dataclasses.asdict(draft_config_for(CONFIGS[name]))
    want = dataclasses.asdict(jax_draft_config_for(JAX_CONFIGS[name]))
    assert got == {k: want[k] for k in got}
    assert got["depth"] == min(2, CONFIGS[name].depth) and got["global_mlp_depth"] == 1
    narrow = draft_config_for(CONFIGS[name], dim=32, depth=1, heads=1, dim_head=16)
    jnarrow = jax_draft_config_for(JAX_CONFIGS[name], dim=32, depth=1, heads=1,
                                   dim_head=16)
    assert dataclasses.asdict(narrow) == {k: dataclasses.asdict(jnarrow)[k]
                                          for k in dataclasses.asdict(narrow)}


# ------------------------------------------------------- the dense write_ok


def test_dense_step_with_write_ok_false_writes_nothing(model):
    step = ProGenDecodeStep(model)
    caches = init_caches(CFG, 2, model.policy, decode_len=20, device="cpu")
    for pos in range(5):  # past a window, so the ring has been walked
        step(torch.tensor([3 + pos, 7 + pos]), pos, caches)

    def snapshot():
        return {k: ([t.clone() for t in v] if isinstance(v, list)
                    else {i: t.clone() for i, t in v.items()})
                for k, v in caches.items()}

    before = snapshot()
    step(torch.tensor([9, 9]), 5, caches, torch.tensor([False, False]))
    for name, old in before.items():
        new = caches[name]
        pairs = zip(new, old) if isinstance(old, list) else \
            ((new[i], old[i]) for i in old)
        for a, b in pairs:
            assert torch.equal(a, b), name  # rings, carries, gate cache
    assert caches["sgu_gate"], "the config has a gMLP layer"
    logits, _ = step(torch.tensor([9, 9]), 5, caches, torch.tensor([True, False]))
    for name, old in before.items():
        new = caches[name]
        pairs = zip(new, old) if isinstance(old, list) else \
            ((new[i], old[i]) for i in old)
        for a, b in pairs:
            assert torch.equal(a[1], b[1]), name       # row 1: nothing moved
            assert not torch.equal(a[0], b[0]), name   # row 0: advanced
    # the masked row's live twin: the same logits as an unmasked step
    fresh = {k: ([t.clone() for t in v] if isinstance(v, list)
                 else {i: t.clone() for i, t in v.items()}) for k, v in before.items()}
    want, _ = step(torch.tensor([9, 9]), 5, fresh)
    assert torch.equal(logits[0], want[0])


# ------------------------------------------------- the engine against JAX


@pytest.fixture(scope="module")
def plain(model):
    """The port's plain engine in each mode: every spec case must equal it."""
    requests = _requests()
    quantized = {**ENGINE, **PAGED, "quantize": "weights+pages"}
    return {"dense": _run(model, requests, **ENGINE)[1],
            "paged": _run(model, requests, **ENGINE, **PAGED)[1],
            "paged_q8": _run(model, requests, **quantized)[1]}


# case: (engine arguments, the plain engine's mode, the draft: None for the
# identity draft, "small" for draft_config_for's, "perturbed" for the noisy
# target)
SPEC_CASES = {
    "identity-dense": (dict(spec=True, spec_k=3), "dense", None),
    "draft-dense": (dict(spec=True, spec_k=3), "dense", "small"),
    "perturbed-dense": (dict(spec=True, spec_k=3), "dense", "perturbed"),
    "identity-paged": (dict(spec=True, spec_k=2, **PAGED), "paged", None),
    "perturbed-paged": (dict(spec=True, spec_k=2, **PAGED), "paged", "perturbed"),
    "identity-paged-q8": (dict(spec=True, spec_k=2, quantize="weights+pages", **PAGED),
                          "paged_q8", None),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_engine_matches_jax_engine(flax_params, flax_draft, flax_perturbed, model,
                                        plain, case):
    """Greedy and sampled requests through two slots: the completions, their
    statuses and the acceptance counters are the JAX engine's, and the
    tokens are the port's plain engine's in the same mode."""
    kw, mode, draft = SPEC_CASES[case]
    kw = {**ENGINE, **kw}
    jkw, tkw = dict(kw), dict(kw)
    with_draft = draft is not None
    if with_draft:
        dcfg, dparams = flax_draft if draft == "small" else flax_perturbed
        jkw.update(draft_config=dcfg, draft_params=dparams)
        tkw.update(draft_params=_port(ProGenConfig(**dataclasses.asdict(dcfg)), dparams))
    jeng, want = _run_jax(flax_params, _requests(), **jkw)
    eng, got = _run(model, _requests(), **tkw)
    assert set(got) == set(range(5)) and all(s == "ok" for _, s in got.values())
    assert got == want
    assert got == plain[mode]
    counters = eng.spec_counters()
    assert {k: counters[k] for k in JAX_COUNTERS} == jeng.spec_counters()
    assert counters["spec_verify_rounds"] > 0
    if draft == "small":
        assert eng.draft_config == draft_config_for(CFG)
    elif draft == "perturbed":
        # rounds end early and late: the commit's live masks are exercised
        assert 1.0 < counters["accepted_tokens_per_slot_round"] < kw["spec_k"] + 1
    else:
        # the identity draft accepts everything: more than one token a round
        assert eng._draft is eng.model
        assert counters["accepted_tokens_per_slot_round"] > 1.0
    if with_draft:
        assert eng._draft is not eng.model and eng._draft.weights == "bf16"
    if "quantize" in kw:
        assert eng.model.weights == "int8" and eng._draft.weights == "int8"
    assert eng.status()["spec"] and not eng.status()["disagg"]


def test_spec_chunk_advances_by_rounds_of_k_plus_one(model):
    eng = ServingEngine(model, **{**ENGINE, "chunk_size": 12}, spec=True, spec_k=3,
                        **PAGED)
    assert eng._spec_rounds == 3 and eng._max_advance == 12
    small = ServingEngine(model, **ENGINE, spec=True, spec_k=5)
    assert small._spec_rounds == 1 and small._max_advance == 6
    assert set(small.state["draft_caches"]) == {"attn_prev", "ff_prev", "k", "v",
                                                "sgu_gate"}
    assert ServingEngine(model, **ENGINE).spec_counters() == {}
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(model, **ENGINE, spec=True, spec_k=0)
    with pytest.raises(ValueError, match="lora_bank"):
        ServingEngine(model, **ENGINE, spec=True, lora_bank={})
    bad = dataclasses.replace(draft_config_for(CFG), window_size=8)
    with pytest.raises(ValueError, match="window_size"):
        ServingEngine(model, **ENGINE, spec=True, draft_config=bad)


def test_a_failed_chunk_leaves_the_draft_caches_untouched(model):
    """The chunk works on a copy of the state, the draft's caches included:
    a chunk that faults after running leaves ``engine.state`` as it was."""
    eng = ServingEngine(model, **ENGINE, spec=True, spec_k=2)
    for r in _requests(2):
        eng.submit(Request(**r))
    eng._admit_pending()
    before = {k: [t.clone() for t in v] for k, v in eng.state["draft_caches"].items()
              if isinstance(v, list)}
    gate = {k: t.clone() for k, t in eng.state["draft_caches"]["sgu_gate"].items()}
    out, stats = eng._decode_chunk(eng.state)
    assert int(stats["emitted"]) > 0
    for name, old in before.items():
        for a, b in zip(eng.state["draft_caches"][name], old):
            assert torch.equal(a, b), name
    for i, t in gate.items():
        assert torch.equal(eng.state["draft_caches"]["sgu_gate"][i], t)
    assert not all(torch.equal(a, b) for a, b in
                   zip(out["draft_caches"]["k"], eng.state["draft_caches"]["k"]))


def test_a_transient_verify_fault_is_retried_in_place(model, plain):
    faults.configure("serve.verify:io_error:at=2", seed=1)
    eng, got = _run(model, _requests(), **ENGINE, spec=True, spec_k=2)
    assert got == plain["dense"]
    assert eng.robust.faults_contained >= 1 and eng.robust.failed_faults == 0
    faults.configure("serve.decode_chunk:fatal:at=1")  # not the spec chunk's point
    assert _run(model, _requests(), **ENGINE, spec=True, spec_k=2)[1] == plain["dense"]
