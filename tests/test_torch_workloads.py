"""The port's served workloads against the JAX package's, on the CPU in f32
with the JAX init's parameters carried across (``compat/convert.py``):

* the LoRA bank's shape rules, its validation errors, ``bank_from_trained``
  and ``adapter_bank_bytes`` for every config;
* ``apply_lora``: tenant 0 keeps the base bits (a ``-0.0`` survives), the
  delta is JAX's; the forward and the dense and paged decode steps with a
  JAX bank give JAX's logits;
* ``make_embedder`` gives JAX's vectors;
* the copied ``ScaffoldSpec`` and the mask wire codec equal the originals;
* the engine: the JAX engine's tokens and statuses under an all-pass mask,
  a scaffold, speculation under a mask, a zero-adapter tenant 0, four
  tenants in one batch (dense, paged, 8-bit pages, disaggregated),
  ``submit_embed`` beside generate traffic and ``submit_fork`` (dense and
  paged, the followers admitted as prefix hits);
* the CLI's ``--embed`` and ``--infill``.

f32 values are held at 1e-5, whole-model logits at 1e-4; tokens exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxServingEngine
from progen_tpu.decode.incremental import ProGenDecodeStep as JaxDecodeStep
from progen_tpu.decode.incremental import ProGenPagedDecodeStep as JaxPagedStep
from progen_tpu.decode.incremental import init_caches as jax_init_caches
from progen_tpu.decode.incremental import init_gate_pool as jax_init_gate_pool
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.models import draft_config_for as jax_draft_config_for
from progen_tpu.models.configs import CONFIGS as JAX_CONFIGS
from progen_tpu.models.progen import apply_lora as jax_apply_lora
from progen_tpu.models.progen import lora_delta as jax_lora_delta
from progen_tpu.parallel import unbox
from progen_tpu.workloads import ScaffoldSpec as JaxScaffoldSpec
from progen_tpu.workloads import make_embedder as jax_make_embedder
from progen_tpu.workloads import mask_from_wire as jax_mask_from_wire
from progen_tpu.workloads import mask_to_wire as jax_mask_to_wire
from progen_tpu.workloads import lora as jax_lora
from progen_tpu_torch import sample
from progen_tpu_torch.compat.convert import bank_from_numpy, params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.engine import STATUS_OK, Request, ServingEngine
from progen_tpu_torch.decode.incremental import (
    ProGenDecodeStep,
    ProGenPagedDecodeStep,
    init_caches,
    init_gate_pool,
)
from progen_tpu_torch.decode.prefill import make_embedder
from progen_tpu_torch.models import CONFIGS, ProGen, ProGenConfig, draft_config_for
from progen_tpu_torch.models.progen import apply_lora, lora_delta
from progen_tpu_torch.workloads import (
    WORKLOADS,
    ScaffoldSpec,
    adapter_bank_bytes,
    bank_from_trained,
    bank_num_tenants,
    init_lora_bank,
    lora_sites,
    mask_from_wire,
    mask_to_wire,
    random_lora_bank,
    tenant_ids,
    validate_lora_bank,
)

torch.set_num_threads(1)

# tests/test_workloads.py's CFG, in f32: two layers, both gMLP
KW = dict(num_tokens=32, dim=16, depth=2, seq_len=64, window_size=8, heads=2,
          dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE = dict(num_slots=4, max_len=32, chunk_size=4)
PAGED = dict(paged=True, num_pages=64, page_size=8)
F32 = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    tokens = jnp.zeros((1, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(0), tokens))


@pytest.fixture(scope="module")
def model(flax_params):
    m = ProGen(CFG, make_policy(False), device="cpu")
    m.load_state_dict(params_from_flax(flax_params))
    return m.eval()


@pytest.fixture(scope="module")
def jax_bank():
    """tests/test_workloads.py's bank: four tenants at rank 2, scale 0.5."""
    return jax_lora.random_lora_bank(JAX_CFG, num_tenants=4, rank=2, seed=3, scale=0.5)


@pytest.fixture(scope="module")
def bank(jax_bank):
    return bank_from_numpy(jax_bank)


def _requests(n=4, mnt=8):
    """tests/test_workloads.py's requests."""
    return [dict(uid=f"r{i}", tokens=[1 + (i % 5), 2, 3 + i % 3], max_new_tokens=mnt,
                 top_k=4 if i % 2 else None, temperature=0.9, seed=100 + i)
            for i in range(n)]


def _out(comps):
    return {c.uid: (c.prime.tolist(), c.tokens.tolist(), c.finish_reason, c.status)
            for c in comps}


def _run(model, requests, **kw):
    eng = ServingEngine(model, **ENGINE, **kw)
    for r in requests:
        eng.submit(Request(**r))
    return eng, _out(eng.run_until_idle(max_chunks=200))


def _run_jax(params, requests, **kw):
    eng = JaxServingEngine(JAX_CFG, params, policy=jax_policy(False), **ENGINE, **kw)
    for r in requests:
        eng.submit(JaxRequest(**r))
    return _out(eng.run_until_idle(max_chunks=200))


def _with_tenants(requests, tenants=(0, 1, 2, 3)):
    return [{**r, "tenant": tenants[i % len(tenants)]} for i, r in enumerate(requests)]


@pytest.fixture(scope="module")
def dense_base(model):
    return _run(model, _requests())[1]


@pytest.fixture(scope="module")
def jax_lora_multi(flax_params, jax_bank):
    return _run_jax(flax_params, _with_tenants(_requests()), lora_bank=jax_bank)


# ---------------------------------------------------------------- the bank


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lora_sites_and_bank_bytes_match_jax(name):
    cfg, jcfg = CONFIGS[name], JAX_CONFIGS[name]
    assert lora_sites(cfg) == jax_lora.lora_sites(jcfg)
    for t, r in ((1, 1), (4, 8), (3, 16)):
        assert adapter_bank_bytes(cfg, t, r) == jax_lora.adapter_bank_bytes(jcfg, t, r)
        assert (adapter_bank_bytes(cfg, t, r, bytes_per_el=2)
                == jax_lora.adapter_bank_bytes(jcfg, t, r, bytes_per_el=2))
    # a bank of the right shapes validates on both sides, to the same T
    zeros = {layer: {site: {"a": np.zeros((3, din, 2), np.float32),
                            "b": np.zeros((3, 2, dout), np.float32)}
                     for site, (din, dout) in sites.items()}
             for layer, sites in jax_lora.lora_sites(jcfg).items()}
    assert validate_lora_bank(cfg, bank_from_numpy(zeros)) == 3
    assert jax_lora.validate_lora_bank(jcfg, zeros) == 3


def test_small_bank_bytes_and_sgu_site():
    small = CONFIGS["small"]
    assert adapter_bank_bytes(small, 4, 8) == 10_485_760
    assert lora_sites(small)["ff11"]["sgu"] == (2048, 2048)
    assert sorted(lora_sites(small)) == sorted(
        [f"attn{i}" for i in range(12)] + ["ff10", "ff11"])


def _errors(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("fault", ["layers", "sites", "a_shape", "b_rank"])
def test_validate_lora_bank_errors_match_jax(jax_bank, fault):
    bad = jax.tree.map(np.asarray, jax_bank)
    if fault == "layers":
        bad["attn7"] = bad["attn0"]
    elif fault == "sites":
        bad["attn0"] = {"qkv": bad["attn0"]["qkv"]}
    elif fault == "a_shape":
        bad["ff1"]["sgu"]["a"] = bad["ff1"]["sgu"]["a"][:, :-1]
    else:
        bad["attn1"]["out"]["b"] = bad["attn1"]["out"]["b"][:, :1]
    want = _errors(lambda: jax_lora.validate_lora_bank(JAX_CFG, bad))
    assert _errors(lambda: validate_lora_bank(CFG, bank_from_numpy(bad))) == want


def test_bank_from_trained_matches_jax():
    rng = np.random.default_rng(4)
    trained = [{layer: {site: {"a": rng.normal(size=(din, 3)).astype(np.float32),
                               "b": rng.normal(size=(3, dout)).astype(np.float32)}
                        for site, (din, dout) in sites.items()}
                for layer, sites in jax_lora.lora_sites(JAX_CFG).items()}
               for _ in range(2)]
    want = jax_lora.bank_from_trained(JAX_CFG, 3, trained, scale=0.25)
    got = bank_from_trained(CFG, 3, [jax.tree.map(torch.from_numpy, t) for t in trained],
                            scale=0.25)
    assert bank_num_tenants(got) == 3 and list(tenant_ids(got)) == [1, 2]
    for layer, sites in want.items():
        for site, f in sites.items():
            for k in ("a", "b"):
                assert got[layer][site][k].dtype == torch.float32
                np.testing.assert_array_equal(got[layer][site][k].numpy(), np.asarray(f[k]))


def test_port_banks_have_the_jax_layout_and_a_zero_base_row():
    init = init_lora_bank(CFG, 3, 4, seed=1, device="cpu")
    rand = random_lora_bank(CFG, 3, 4, seed=1, device="cpu")
    assert validate_lora_bank(CFG, init) == validate_lora_bank(CFG, rand) == 3
    jinit = jax_lora.init_lora_bank(JAX_CFG, 3, 4, seed=1)
    for layer, sites in jinit.items():
        for site, f in sites.items():
            for k in ("a", "b"):
                assert tuple(init[layer][site][k].shape) == f[k].shape
                assert not init[layer][site][k][0].any() and not rand[layer][site][k][0].any()
            assert not init[layer][site]["b"].any() and rand[layer][site]["b"][1:].all()
            din = f["a"].shape[1]
            a = init[layer][site]["a"][1:]
            assert torch.equal(a, rand[layer][site]["a"][1:])
            assert abs(float(a.std()) * din ** 0.5 - 1.0) < 0.5  # std d_in ** -0.5
    again = random_lora_bank(CFG, 3, 4, seed=1, device="cpu")
    assert all(torch.equal(again[l][s]["b"], rand[l][s]["b"]) for l in rand for s in rand[l])
    with pytest.raises(ValueError, match="num_tenants"):
        init_lora_bank(CFG, 0, 4, device="cpu")
    assert WORKLOADS == ("generate", "infill", "embed", "lora")


# ------------------------------------------------------- apply_lora, model


def test_apply_lora_keeps_tenant_zero_bits_and_matches_jax():
    rng = np.random.default_rng(0)
    site = {"a": rng.normal(size=(3, 5, 2)).astype(np.float32),
            "b": rng.normal(size=(3, 2, 4)).astype(np.float32)}
    site["a"][0] = site["b"][0] = 0.0
    tsite = {k: torch.from_numpy(v) for k, v in site.items()}
    tenant = np.asarray([0, 2, 1, 0])
    for shape in ((4, 5), (4, 6, 5)):
        x = rng.normal(size=shape).astype(np.float32)
        base = rng.normal(size=shape[:-1] + (4,)).astype(np.float32)
        base[0].flat[0] = -0.0
        base[3].flat[1] = -0.0
        got = apply_lora(torch.from_numpy(base), torch.from_numpy(x), tsite,
                         torch.from_numpy(tenant)).numpy()
        want = np.asarray(jax_apply_lora(jnp.asarray(base), jnp.asarray(x), site,
                                         jnp.asarray(tenant)))
        np.testing.assert_allclose(got, want, **F32)
        # tenant-0 rows ARE the base, sign of zero included
        assert got[0].tobytes() == base[0].tobytes() and got[3].tobytes() == base[3].tobytes()
        assert np.signbit(got[0].flat[0]) and np.signbit(got[3].flat[1])
        delta = lora_delta(torch.from_numpy(x), tsite, torch.from_numpy(tenant)).numpy()
        np.testing.assert_allclose(
            delta, np.asarray(jax_lora_delta(jnp.asarray(x), site, jnp.asarray(tenant))),
            **F32)


def test_forward_with_a_jax_bank_gives_jax_logits(flax_params, model, jax_bank, bank):
    tokens = np.random.default_rng(1).integers(1, CFG.num_tokens, size=(4, 16))
    tenant = np.asarray([0, 1, 2, 3])
    want = jax.jit(JaxProGen(config=JAX_CFG, policy=jax_policy(False)).apply)(
        flax_params, jnp.asarray(tokens), jax_bank, jnp.asarray(tenant))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), adapters=bank, tenant=torch.from_numpy(tenant))
        plain = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    # the tenant-0 row is the bankless model's, bit for bit
    assert torch.equal(got[0], plain[0]) and not torch.equal(got[1], plain[1])
    with pytest.raises(ValueError, match="tenant"):
        model(torch.from_numpy(tokens), adapters=bank)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_steps_with_a_jax_bank_give_jax_logits(flax_params, model, jax_bank,
                                                      bank, paged):
    """Twelve teacher-forced steps from fresh caches, four rows of tenants
    0-3: every step's logits at 1e-4; the tenant-0 row equals the bankless
    step's bits."""
    steps, rows = 12, 4
    tokens = np.random.default_rng(2).integers(1, CFG.num_tokens, size=(steps, rows))
    tenant = np.asarray([0, 1, 2, 3])
    pol, jpol = make_policy(False), jax_policy(False)
    table = np.arange(2, 2 + 4 * 2, dtype=np.int32).reshape(rows, 2)
    live = np.ones(rows, bool)
    if paged:
        jstep = JaxPagedStep(config=JAX_CFG, n_rows=16, policy=jpol, impl="xla")
        jcaches = jax_init_caches(JAX_CFG, rows, jpol, decode_len=16, with_sgu=False)
        jcaches.pop("sgu_gate")
        jcaches["sgu_pool"] = jax_init_gate_pool(JAX_CFG, 10, 8, jpol)
        extra_j = (jnp.asarray(table), jnp.asarray(live))
    else:
        jstep = JaxDecodeStep(config=JAX_CFG, policy=jpol)
        jcaches = jax_init_caches(JAX_CFG, rows, jpol, decode_len=16)
        extra_j = ()
    japply = jax.jit(jstep.apply)

    def port_caches():
        caches = init_caches(CFG, rows, pol, decode_len=16, device="cpu", with_sgu=not paged)
        if paged:
            caches["sgu_pool"] = init_gate_pool(CFG, 10, 8, pol, device="cpu")
        return caches

    if paged:
        step = ProGenPagedDecodeStep(model, n_rows=16)
        extra = (torch.from_numpy(table), torch.from_numpy(live))
    else:
        step, extra = ProGenDecodeStep(model), ()
    caches, plain_caches = port_caches(), port_caches()
    t = torch.from_numpy(tenant)
    for pos in range(steps):
        tok = tokens[pos]
        jl, jcaches = japply(flax_params, jnp.asarray(tok), jnp.full((rows,), pos, jnp.int32),
                             jcaches, *extra_j, jax_bank, jnp.asarray(tenant))
        tl, caches = step(torch.from_numpy(tok), pos, caches, *extra, adapters=bank, tenant=t)
        pl, plain_caches = step(torch.from_numpy(tok), pos, plain_caches, *extra)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        assert torch.equal(tl[0], pl[0])


def test_make_embedder_gives_jax_vectors(flax_params, model):
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, CFG.num_tokens, size=(3, 16)).astype(np.int32)
    lengths = np.asarray([4, 16, 9], np.int32)
    want = jax_make_embedder(JAX_CFG, policy=jax_policy(False))(
        flax_params, jnp.asarray(tokens), jnp.asarray(lengths))
    embed = make_embedder(model)
    got = embed(torch.from_numpy(tokens), torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and got.shape == (3, CFG.dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the pad tail never contributes: a row alone at its own bucket agrees
    alone = embed(torch.from_numpy(tokens[:1, :8]), torch.tensor([4]))
    np.testing.assert_allclose(alone.numpy()[0], got.numpy()[0], **F32)
    for bad in (12, 72):  # not a multiple of the window, past seq_len
        with pytest.raises(ValueError, match="padded prime length"):
            embed(torch.zeros(1, bad, dtype=torch.long), torch.tensor([1]))


# ----------------------------------------------------------- scaffolds


TEMPLATES = [
    dict(template=[1, 2, None, 7, None, (5, 6), 9], vocab=32,
         alphabet=[3, 4, 5, 6, 7, 8, 9, 10]),
    dict(template=[0, None, None, (1, 2, 3)], vocab=8),
    dict(template=[4, 4, 4, 2, [1, 1, 7]], vocab=8, alphabet=None),
]
BAD_TEMPLATES = [
    dict(template=[None, 3], vocab=8), dict(template=[1, 2, 3], vocab=8),
    dict(template=[1], vocab=8), dict(template=[1, ()], vocab=8),
    dict(template=[1, 99], vocab=8), dict(template=[1, None], vocab=8, alphabet=[9]),
    dict(template=[1, (3, 12)], vocab=8),
]


@pytest.mark.parametrize("spec", TEMPLATES, ids=range(len(TEMPLATES)))
def test_scaffold_copy_equals_the_original(spec):
    got, want = ScaffoldSpec(**spec), JaxScaffoldSpec(**spec)
    assert got.prime() == want.prime() and got.max_new_tokens == want.max_new_tokens
    np.testing.assert_array_equal(got.logit_mask(), want.logit_mask())
    kw, jkw = got.request_kwargs(), want.request_kwargs()
    assert kw.keys() == jkw.keys() and kw["tokens"] == jkw["tokens"]
    np.testing.assert_array_equal(kw["logit_mask"], jkw["logit_mask"])
    n = len(spec["template"]) + 3
    np.testing.assert_array_equal(got.full_mask(n), want.full_mask(n))
    rows = mask_to_wire(got.logit_mask())
    assert rows == jax_mask_to_wire(want.logit_mask())
    np.testing.assert_array_equal(mask_from_wire(rows, spec["vocab"]),
                                  jax_mask_from_wire(rows, spec["vocab"]))


@pytest.mark.parametrize("spec", BAD_TEMPLATES, ids=range(len(BAD_TEMPLATES)))
def test_scaffold_copy_refuses_what_the_original_refuses(spec):
    assert _errors(lambda: ScaffoldSpec(**spec)) == _errors(lambda: JaxScaffoldSpec(**spec))


def test_mask_wire_codec_equals_the_original():
    allpass = np.ones((4, 8), bool)
    assert mask_to_wire(allpass) is None and jax_mask_to_wire(allpass) is None
    assert mask_to_wire(None) is None and mask_from_wire(None, 8) is None
    m = np.random.default_rng(5).random((6, 8)) < 0.4
    m[:, 0] = True
    m[2] = True
    assert mask_to_wire(m) == jax_mask_to_wire(m)
    np.testing.assert_array_equal(mask_from_wire(mask_to_wire(m), 8), m)


# -------------------------------------------------------- engine: infill


@pytest.fixture(scope="module")
def scaffold():
    return dict(template=[1, 2, None, 7, None, (5, 6), 9], vocab=CFG.num_tokens,
                alphabet=[3, 4, 5, 6, 7, 8, 9, 10])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_an_all_pass_mask_is_bit_identical_to_none(model, paged):
    kw = PAGED if paged else {}
    want = _run(model, _requests(), **kw)[1]
    masked = [{**r, "logit_mask": np.ones((r["max_new_tokens"], CFG.num_tokens), bool)}
              for r in _requests()]
    assert _run(model, masked, **kw)[1] == want


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "greedy"])
def test_a_scaffold_is_enforced_with_the_jax_engines_tokens(flax_params, model, scaffold,
                                                            sampled):
    kw = (dict(top_k=6, temperature=1.1, seed=42) if sampled
          else dict(top_k=None, temperature=0.0, seed=0))
    spec = ScaffoldSpec(**scaffold)
    req = [dict(uid="inf", **kw, **spec.request_kwargs())]
    got = _run(model, req)[1]
    jreq = [dict(uid="inf", **kw, **JaxScaffoldSpec(**scaffold).request_kwargs())]
    assert got == _run_jax(flax_params, jreq)
    gen = got["inf"][1]
    m = spec.logit_mask()
    assert all(m[g, t] for g, t in enumerate(gen[:m.shape[0]]))
    assert gen[1] == 7 and (len(gen) < 4 or gen[3] in (5, 6))


def test_speculation_under_a_mask_keeps_the_plain_tokens(flax_params, model, scaffold):
    kw = dict(seed=42, top_k=6, temperature=1.1, **ScaffoldSpec(**scaffold).request_kwargs())
    plain = _run(model, [dict(uid="inf", **kw)])[1]
    dcfg = draft_config_for(CFG)
    jdcfg = jax_draft_config_for(JAX_CFG)
    jdraft = unbox(jax.jit(JaxProGen(config=jdcfg, policy=jax_policy(False)).init)(
        jax.random.key(1), jnp.zeros((1, dcfg.seq_len), jnp.int32)))
    draft = ProGen(dcfg, make_policy(False), device="cpu")
    draft.load_state_dict(params_from_flax(jdraft))
    got = _run(model, [dict(uid="inf", **kw)], spec=True, spec_k=2,
               draft_params=draft.eval())[1]
    jkw = dict(kw, **JaxScaffoldSpec(**scaffold).request_kwargs())
    want = _run_jax(flax_params, [dict(uid="inf", **jkw)], spec=True, spec_k=2,
                    draft_params=jdraft, draft_config=jdcfg)
    assert got == plain == want


# ----------------------------------------------------------- engine: lora


def test_a_zero_adapter_tenant_zero_is_the_bankless_engine(model, bank, dense_base):
    assert _run(model, _requests(), lora_bank=bank)[1] == dense_base


@pytest.mark.parametrize("mode", ["dense", "paged", "paged_q8", "disagg", "disagg_paged"])
def test_four_tenants_in_one_batch_give_the_jax_engines_tokens(flax_params, model, jax_bank,
                                                               bank, jax_lora_multi,
                                                               dense_base, mode):
    kw = {"dense": {}, "paged": PAGED, "disagg": dict(disagg=True),
          "disagg_paged": dict(PAGED, disagg=True),
          "paged_q8": dict(PAGED, quantize="weights+pages")}[mode]
    eng, got = _run(model, _with_tenants(_requests()), lora_bank=bank, **kw)
    assert eng.lora and eng.num_tenants == 4 and eng.status()["lora_tenants"] == 4
    want = (jax_lora_multi if mode in ("dense", "paged", "disagg", "disagg_paged")
            else _run_jax(flax_params, _with_tenants(_requests()), lora_bank=jax_bank, **kw))
    assert got == want
    if mode != "paged_q8":
        # tenant 0 is the base model; the adapters move the others
        assert got["r0"] == dense_base["r0"]
        assert any(got[f"r{i}"] != dense_base[f"r{i}"] for i in (1, 2, 3))


def test_the_bank_is_cast_once_and_stays_full_precision_under_int8(model, bank):
    eng = ServingEngine(model, **ENGINE, **PAGED, quantize="weights+pages", lora_bank=bank)
    assert eng.model.weights == "int8"
    site = eng._bank["ff1"]["sgu"]
    assert site["a"].dtype == torch.float32
    assert torch.equal(site["b"], bank["ff1"]["sgu"]["b"])
    assert eng.state["tenant"].dtype == torch.long


# ------------------------------------------------------ engine: embeddings


def test_submit_embed_is_the_embedder_and_leaves_generate_alone(flax_params, model, dense_base):
    got, jgot = {}, {}
    eng = ServingEngine(model, **ENGINE)
    jeng = JaxServingEngine(JAX_CFG, flax_params, policy=jax_policy(False), **ENGINE)
    primes = [[1 + i, 2, 3, 4 + i] for i in range(3)] + [list(range(1, 20))]
    for e, R, sink in ((eng, Request, got), (jeng, JaxRequest, jgot)):
        for i, p in enumerate(primes):
            e.submit_embed(R(uid=f"e{i}", tokens=p, max_new_tokens=1,
                             on_complete=lambda c, s=sink: s.__setitem__(c.uid, c)))
        for r in _requests(2):
            e.submit(R(**r))
    assert eng.pending == 6 and eng.embed_pending == 4 and eng.has_work
    comps = eng.run_until_idle(max_chunks=100)
    jeng.run_until_idle(max_chunks=100)
    embeds = [c for c in comps if c.finish_reason == "embed"]
    assert len(embeds) == 4 and eng.stage_seconds["embed_s"] > 0
    for c in embeds:
        assert c.ok and c.embedding.shape == (CFG.dim,) and c.embedding.dtype == np.float32
        assert c.tokens.size == 0
        np.testing.assert_allclose(c.embedding, jgot[c.uid].embedding, **F32)
    gen = _out([c for c in comps if c.finish_reason != "embed"])
    assert gen == {u: dense_base[u] for u in ("r0", "r1")}
    # bit for bit the standalone embedder on the same bucket
    t = np.zeros((4, 8), np.int64)
    lengths = np.ones(4, np.int64)
    for i, p in enumerate(primes[:3]):
        t[i, :4], lengths[i] = p, 4
    ref = make_embedder(model)(torch.from_numpy(t), torch.from_numpy(lengths))
    for i in range(3):
        assert np.array_equal(ref[i].numpy(), got[f"e{i}"].embedding)


def test_workload_validation_errors_match_jax(flax_params, model, bank, jax_bank):
    eng = ServingEngine(model, **ENGINE)
    jeng = JaxServingEngine(JAX_CFG, flax_params, policy=jax_policy(False), **ENGINE)
    leng = ServingEngine(model, **ENGINE, lora_bank=bank)
    cases = [
        ("submit", dict(uid="x", tokens=[1], max_new_tokens=2, tenant=1)),
        ("submit", dict(uid="x", tokens=[1], max_new_tokens=2,
                        logit_mask=np.ones((4, CFG.num_tokens), bool))),
        ("submit", dict(uid="x", tokens=[1], max_new_tokens=2,
                        logit_mask=np.zeros((2, CFG.num_tokens), bool))),
        ("submit", dict(uid="x", tokens=[1], max_new_tokens=2,
                        logit_mask=np.ones((2, 7), bool))),
        ("submit_embed", dict(uid="x", tokens=[1], max_new_tokens=1,
                              logit_mask=np.ones((1, CFG.num_tokens), bool))),
        ("submit_embed", dict(uid="x", tokens=[], max_new_tokens=1)),
        ("submit_embed", dict(uid="x", tokens=[1] * 65, max_new_tokens=1)),
        ("submit_embed", dict(uid="x", tokens=[1, 2], tenant=1)),
    ]
    for method, kw in cases:
        # the port writes the JAX messages' dashes as semicolons
        want = _errors(lambda: getattr(jeng, method)(JaxRequest(**kw))).replace(" — ", "; ")
        assert _errors(lambda: getattr(eng, method)(Request(**kw))) == want
    with pytest.raises(ValueError, match=r"outside the bank's \[0, 4\)"):
        leng.submit(Request(uid="x", tokens=[1], max_new_tokens=2, tenant=4))
    with pytest.raises(ValueError, match="spec=True"):
        ServingEngine(model, **ENGINE, lora_bank=bank, spec=True)
    bad = dict(bank, attn0={"qkv": bank["attn0"]["qkv"]})
    with pytest.raises(ValueError, match="sites"):
        ServingEngine(model, **ENGINE, lora_bank=bad)
    with pytest.raises(ValueError, match="n_samples"):
        eng.submit_fork(Request(uid=1, tokens=[1]), 0)
    with pytest.raises(ValueError, match="uid must be an int"):
        eng.submit_fork(Request(uid="f", tokens=[1]), 2)
    assert not eng.has_work and eng.pending == 0


def test_an_embed_past_its_deadline_or_over_the_queue_is_shed(model):
    eng = ServingEngine(model, **ENGINE, max_queue=1)
    eng.submit_embed(Request(uid=0, tokens=[1, 2], ttl=-1.0))
    eng.submit_embed(Request(uid=1, tokens=[1, 2]))
    eng.submit_embed(Request(uid=2, tokens=[1, 2]))
    out = {c.uid: c.status for c in eng.run_until_idle(max_chunks=10)}
    assert out == {0: "shed_deadline", 1: STATUS_OK, 2: "shed_queue_full"}


# ------------------------------------------------------------ engine: fork


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fork_k_is_its_request_alone_with_seed_plus_k(flax_params, model, paged):
    kw = dict(paged=True, page_size=4) if paged else {}
    prime = list(range(1, 11))  # two full pages of 4
    base = dict(tokens=prime, max_new_tokens=6, top_k=4, temperature=0.9, seed=7)
    eng = ServingEngine(model, **ENGINE, **kw)
    uids = eng.submit_fork(Request(uid=10, **base), 4)
    assert uids == [10, 11, 12, 13] and eng.fork_groups == 1
    assert eng.pending == 4 and len(eng._queue) == (1 if paged else 4)
    forks = _out(eng.run_until_idle(max_chunks=100))
    alone = _run(model, [dict(base, uid=10 + k, seed=7 + k) for k in range(4)], **kw)[1]
    assert forks == alone
    jeng = JaxServingEngine(JAX_CFG, flax_params, policy=jax_policy(False), **ENGINE, **kw)
    jeng.submit_fork(JaxRequest(uid=10, **base), 4)
    assert forks == _out(jeng.run_until_idle(max_chunks=100))
    assert len({tuple(v[1]) for v in forks.values()}) > 1
    if paged:
        # the leader's two prefix pages are shared by its three followers
        assert eng.prefix_hits == 3 * 2 == jeng.prefix_hits
        assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity


def test_forks_share_the_leaders_pages_while_in_flight(model):
    eng = ServingEngine(model, **ENGINE, paged=True, page_size=4)
    no_eos = np.ones((20, CFG.num_tokens), bool)
    no_eos[:, 0] = False  # nobody finishes within the two steps looked at
    eng.submit_fork(Request(uid=0, tokens=list(range(1, 11)), max_new_tokens=20,
                            temperature=0.0, logit_mask=no_eos), 3)
    eng.step()  # the leader is admitted and its pages published
    assert sorted(eng._inflight) == [0] and eng.pending == 2
    eng.step()  # the followers are released, then admitted as hits
    pages = [eng._slot_pages[s] for s in sorted(eng._inflight)]
    assert len(pages) == 3 and all(p.pages[:2] == pages[0].pages[:2] for p in pages)
    assert [p.shared for p in pages] == [0, 2, 2]
    # each prefix page: the index's reference and one per fork in flight
    assert [eng._pool._ref[pid] for pid in pages[0].pages[:2]] == [4, 4]
    assert eng._pool.stats()["shared_pages"] == 3 * 2
    eng.run_until_idle(max_chunks=100)
    assert eng._pool.free_pages + eng._pool.cached_pages == eng._pool.capacity


# -------------------------------------------------------------------- CLI


def test_cli_embed_and_infill_rules():
    for argv, what in ((["--embed"], "add --serve"), (["--infill", "M?"], "add --serve"),
                       (["--serve", "--embed", "--infill", "M?"], "ONE of")):
        with pytest.raises(SystemExit):
            sample.parse_args(argv)
    spec = sample.scaffold_from_template("MK?[ILV]G", 256)
    assert spec.prime() == [0, 78, 76] and spec.max_new_tokens == 3
    m = spec.logit_mask()
    assert m[0].all() and set(np.flatnonzero(m[1])) == {74, 77, 87}
    assert list(np.flatnonzero(m[2])) == [72]


@pytest.mark.parametrize("mode", ["embed", "infill"])
def test_cli_serves_embed_and_infill_on_the_cpu(mode, capsys):
    args = ["--serve", "--config", "default", "--seq_len", "24", "--slots", "2",
            "--chunk", "4", "--device", "cpu"]
    if mode == "embed":
        records = sample.main(args + ["--embed", "--prime", "MKV|MALWTR"])
        assert [len(r["embedding"]) for r in records] == [128, 128]
        assert "[embed, dim=128" in capsys.readouterr().out
    else:
        records = sample.main(args + ["--infill", "MKV??[ILV]G?", "--num_samples", "2",
                                      "--paged", "--page_size", "4"])
        assert len(records) == 2
        for r in records:
            toks = r["tokens"]
            assert r["status"] == STATUS_OK and 1 <= len(toks) <= 5
            if len(toks) > 2:
                assert chr(toks[2] - 1) in "ILV"
            if len(toks) > 3:
                assert chr(toks[3] - 1) == "G"
