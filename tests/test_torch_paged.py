"""The port's paged-serving pieces against the JAX package's, on the CPU in
f32: bucketed prime lengths, the gate-page harvest, the plain paged gate mix
(against JAX's Pallas kernel in interpret mode and its gather version, 1e-5,
the bar of tests/test_paged.py), the gate-row scatter, int8 quantization
(codes equal, scales at 1e-7), the int8 model, and the copied page pool and
scheduling queue, each pinned to the original on one scripted sequence."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import harvest_gate_pages as jax_harvest_gate_pages
from progen_tpu.decode import init_gate_pool as jax_init_gate_pool
from progen_tpu.decode import paging as jax_paging
from progen_tpu.decode import qos as jax_qos
from progen_tpu.decode.incremental import init_gate_scale as jax_init_gate_scale
from progen_tpu.decode.prefill import pad_prime_length as jax_pad_prime_length
from progen_tpu.decode.prefill import prime_buckets as jax_prime_buckets
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.ops import quant as jax_quant
from progen_tpu.ops.pallas_paged_attention import paged_gate_mix as jax_paged_gate_mix
from progen_tpu.ops.pallas_paged_attention import write_gate_row as jax_write_gate_row
from progen_tpu.parallel import unbox
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode import paging, qos
from progen_tpu_torch.decode.incremental import init_gate_pool, init_gate_scale
from progen_tpu_torch.decode.prefill import (
    harvest_caches,
    harvest_gate_pages,
    pad_prime_length,
    prime_buckets,
)
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.ops import cuda_paged_gate_mix, quant
from progen_tpu_torch.ops import paged_gate_mix as plain_paged

torch.set_num_threads(1)

KW = dict(num_tokens=32, dim=16, seq_len=24, depth=3, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
NULL_PAGE, DUMP_PAGE = paging.NULL_PAGE, paging.DUMP_PAGE
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    tokens = jnp.zeros((2, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(7), tokens))


def _port(params, weights="bf16"):
    model = ProGen(CFG, make_policy(False), device="cpu", weights=weights)
    model.load_state_dict(params_from_flax(params))
    return model.eval()


# ------------------------------------------------------------ prime buckets


@pytest.mark.parametrize("window,seq_len", [(4, 24), (256, 1024)])
def test_pad_prime_length_matches_jax_for_every_prime(window, seq_len):
    for bucket in (False, True):
        for p in range(1, seq_len + 1):
            assert pad_prime_length(p, window, seq_len, bucket=bucket) == \
                jax_pad_prime_length(p, window, seq_len, bucket=bucket), (p, bucket)
    for bad in (0, seq_len + 1):
        with pytest.raises(ValueError):
            pad_prime_length(bad, window, seq_len, bucket=True)


@pytest.mark.parametrize("window,seq_len", [(4, 24), (256, 1024)])
def test_prime_buckets_match_jax(window, seq_len):
    for max_prime in (None, 1, window, window + 1, seq_len // 2, seq_len - 1):
        assert prime_buckets(window, seq_len, max_prime) == \
            jax_prime_buckets(window, seq_len, max_prime)
    assert prime_buckets(256, 1024) == [256, 512, 1024]


# ------------------------------------------------------------------ harvest


def _prefill_case():
    lengths = np.asarray([5, 8, 1])
    rng = np.random.default_rng(0)
    toks = np.zeros((3, 8), np.int32)
    for b, p in enumerate(lengths):
        toks[b, :p] = rng.integers(1, CFG.num_tokens, p)
    ps = 4
    ppr = -(-CFG.seq_len // ps)
    table = np.full((3, ppr), NULL_PAGE, np.int32)
    wtable = np.full((3, ppr), DUMP_PAGE, np.int32)
    nxt = 2
    for b, p in enumerate(lengths):
        n = paging.pages_for_span(int(p) - 1, ps)
        table[b, :n] = wtable[b, :n] = range(nxt, nxt + n)
        nxt += n
    return toks, lengths, ps, ppr, table, wtable


def test_harvest_gate_pages_matches_contiguous_and_jax(flax_params):
    """Gate rows scattered into pool pages and gathered back through the page
    table equal the dense contiguous harvest bit for bit, and the pool
    equals JAX's at 1e-5 (the dump page aside: it holds whichever pad row
    was written last)."""
    toks, lengths, ps, ppr, table, wtable = _prefill_case()
    model = _port(flax_params)
    policy = model.policy
    with torch.no_grad():
        _, sown = model(torch.from_numpy(toks).long(), return_cache=True)
    t_lengths = torch.from_numpy(lengths)
    dense = harvest_caches(CFG, sown, t_lengths, policy, CFG.seq_len)
    empty = init_gate_pool(CFG, 2 + 3 * ppr, ps, policy, device="cpu")
    pool = harvest_gate_pages(CFG, sown, t_lengths, empty, torch.from_numpy(wtable),
                              policy)
    assert all(not t.any() for t in empty.values())  # the input pool is untouched
    rings = harvest_caches(CFG, sown, t_lengths, policy, CFG.seq_len, with_sgu=False)
    assert rings["sgu_gate"] == {} and len(rings["k"]) == CFG.depth

    jmodel = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    _, varz = jmodel.apply(flax_params, jnp.asarray(toks), mutable=["cache"])
    jpool = jax_init_gate_pool(JAX_CFG, 2 + 3 * ppr, ps, jax_policy(False))
    jpool = jax_harvest_gate_pages(JAX_CFG, varz["cache"], jnp.asarray(lengths),
                                   jpool, jnp.asarray(wtable), jax_policy(False))
    assert set(pool) == set(jpool) == {"2"}
    for key, layer in pool.items():
        rows = layer.numpy()[table].reshape(3, ppr * ps, -1)[:, :CFG.seq_len]
        np.testing.assert_array_equal(rows, dense["sgu_gate"][key].numpy())
        assert not layer[NULL_PAGE].any()
        keep = [p for p in range(layer.shape[0]) if p != DUMP_PAGE]
        np.testing.assert_allclose(layer.numpy()[keep], np.asarray(jpool[key])[keep],
                                   **F32)


def test_harvest_clamps_a_prefill_that_overshoots_the_table(flax_params):
    """``P_pad`` 24 against a table spanning 16 rows: the overshooting rows
    are pad rows and go to the dump page."""
    model = _port(flax_params)
    toks = np.zeros((1, 24), np.int64)
    toks[0, :6] = np.arange(1, 7)
    with torch.no_grad():
        _, sown = model(torch.from_numpy(toks), return_cache=True)
    pool = init_gate_pool(CFG, 2 + 4, 4, model.policy, device="cpu")
    wtable = torch.tensor([[2, 3, DUMP_PAGE, DUMP_PAGE]], dtype=torch.int32)
    out = harvest_gate_pages(CFG, sown, torch.tensor([6]), pool, wtable, model.policy)
    gate = sown["ff2"]["sgu"]["gate"][0]
    np.testing.assert_array_equal(out["2"][2].numpy(), gate[:4].numpy())
    np.testing.assert_array_equal(out["2"][3, :2].numpy(), gate[4:6].numpy())
    assert not out["2"][3, 2:].any() and not out["2"][4:].any()


def test_harvest_gate_pages_quantized_matches_jax(flax_params):
    """With ``pool_scale``: JAX's own gate rows through both harvests give
    equal int8 codes and scales."""
    toks, lengths, ps, ppr, table, wtable = _prefill_case()
    jmodel = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    _, varz = jmodel.apply(flax_params, jnp.asarray(toks), mutable=["cache"])
    jpool = jax_init_gate_pool(JAX_CFG, 2 + 3 * ppr, ps, jax_policy(False), "int8")
    jscale = jax_init_gate_scale(JAX_CFG, 2 + 3 * ppr, ps)
    jpool, jscale = jax_harvest_gate_pages(
        JAX_CFG, varz["cache"], jnp.asarray(lengths), jpool, jnp.asarray(wtable),
        jax_policy(False), pool_scale=jscale)

    gate = torch.from_numpy(np.array(varz["cache"]["ff2"]["sgu"]["gate"][0]))
    sown = {"ff2": {"sgu": {"gate": gate}}}
    policy = make_policy(False)
    pool = init_gate_pool(CFG, 2 + 3 * ppr, ps, policy, gate_dtype="int8", device="cpu")
    scale = init_gate_scale(CFG, 2 + 3 * ppr, ps, device="cpu")
    assert pool["2"].dtype == torch.int8 and bool((scale["2"] == 1).all())
    pool, scale = harvest_gate_pages(CFG, sown, torch.from_numpy(lengths), pool,
                                     torch.from_numpy(wtable), policy, pool_scale=scale)
    keep = [p for p in range(pool["2"].shape[0]) if p != DUMP_PAGE]
    np.testing.assert_array_equal(pool["2"].numpy()[keep], np.asarray(jpool["2"])[keep])
    np.testing.assert_allclose(scale["2"].numpy()[keep], np.asarray(jscale["2"])[keep],
                               rtol=1e-7, atol=0)
    with pytest.raises(ValueError):
        init_gate_pool(CFG, 8, 4, policy, gate_dtype="fp8", device="cpu")


# ---------------------------------------------------------- paged gate mix


def _mix_case(seed):
    rng = np.random.default_rng(seed)
    n, d, ps, B = 24, 8, 4, 3
    ppr = n // ps
    num_pages = 2 + B * ppr
    weights = rng.normal(size=(n, n)).astype(np.float32)
    biases = rng.normal(size=(n, 1)).astype(np.float32)
    pool = rng.normal(size=(num_pages, ps, d)).astype(np.float32)
    pool[NULL_PAGE] = 0.0
    pos = np.asarray([0, 7, n - 1], np.int32)
    table = np.full((B, ppr), NULL_PAGE, np.int32)
    for b in range(B):
        need = int(pos[b]) // ps + 1
        table[b, :need] = 2 + b * ppr + np.arange(need)
    return weights, biases, pool, table, pos, n


@pytest.mark.parametrize("seed", [0, 3])
def test_paged_gate_mix_matches_jax_pallas_and_xla(seed):
    """Ragged positions, partly-NULL tables, stale rows past each position:
    the plain version against JAX's Pallas kernel (interpret mode) and its
    gather version."""
    weights, biases, pool, table, pos, n = _mix_case(seed)
    got = cuda_paged_gate_mix.paged_gate_mix(
        *(torch.from_numpy(a) for a in (weights, biases, pool, table, pos)), n_rows=n)
    assert got.dtype == torch.float32 and got.shape == (3, 8)
    for impl in ("pallas", "xla"):
        want = jax_paged_gate_mix(*(jnp.asarray(a) for a in
                                    (weights, biases, pool, table, pos)),
                                  n_rows=n, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", ["w8_p8", "w8_f32", "f32_p8"])
def test_paged_gate_mix_q8_matches_jax_pallas(seed, case):
    weights, biases, pool, table, pos, n = _mix_case(seed)
    wq, ws = quant.np_quantize_w(weights, channel_axis=0)
    pq, pscale = (np.asarray(a) for a in jax_quant.quantize_rows(jnp.asarray(pool)))
    w, p, w_scale, pool_scale = {
        "w8_p8": (wq, pq, ws, pscale), "w8_f32": (wq, pool, ws, None),
        "f32_p8": (weights, pq, None, pscale)}[case]
    as_t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    as_j = lambda a: None if a is None else jnp.asarray(a)
    got = cuda_paged_gate_mix.paged_gate_mix(
        as_t(w), as_t(biases), as_t(p), as_t(table), as_t(pos), n_rows=n,
        w_scale=as_t(w_scale), pool_scale=as_t(pool_scale))
    for impl in ("pallas", "xla"):
        want = jax_paged_gate_mix(as_j(w), as_j(biases), as_j(p), as_j(table),
                                  as_j(pos), n_rows=n, impl=impl,
                                  w_scale=as_j(w_scale), pool_scale=as_j(pool_scale))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # and close to the full-precision mix: one int8 step of each operand
    full = plain_paged.paged_gate_mix(as_t(weights), as_t(biases), as_t(pool),
                                      as_t(table), as_t(pos), n_rows=n)
    assert float((got - full).abs().max()) < 0.25


def test_reserved_pages_are_named_alike():
    assert (plain_paged.NULL_PAGE, plain_paged.DUMP_PAGE) == (NULL_PAGE, DUMP_PAGE)
    assert (NULL_PAGE, DUMP_PAGE, paging.RESERVED_PAGES) == \
        (jax_paging.NULL_PAGE, jax_paging.DUMP_PAGE, jax_paging.RESERVED_PAGES)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scale"])
def test_write_gate_row_matches_jax(scaled):
    """Live rows land in their page; a row that is not live and a row whose
    table entry is NULL go to the dump page; with ``scale`` the row is
    quantized on the way."""
    rng = np.random.default_rng(1)
    ps, d, B = 4, 8, 4
    pool = rng.normal(size=(8, ps, d)).astype(np.float32)
    table = np.asarray([[2, 3], [4, NULL_PAGE], [5, 6], [7, NULL_PAGE]], np.int32)
    pos = np.asarray([5, 6, 2, 1], np.int32)      # row 1's page is NULL
    ok = np.asarray([True, True, False, True])    # row 2 is not live
    gate = rng.normal(size=(B, d)).astype(np.float32)
    if scaled:
        pool = rng.integers(-127, 128, size=pool.shape).astype(np.int8)
        scale = rng.random((8, ps)).astype(np.float32)
        want_pool, want_scale = jax_write_gate_row(
            jnp.asarray(pool), jnp.asarray(table), jnp.asarray(pos), jnp.asarray(gate),
            jnp.asarray(ok), scale=jnp.asarray(scale))
        t_pool, t_scale = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
        got_pool, got_scale = cuda_paged_gate_mix.write_gate_row(
            t_pool, torch.from_numpy(table), torch.from_numpy(pos),
            torch.from_numpy(gate), torch.from_numpy(ok), scale=t_scale)
        assert got_pool is t_pool and got_scale is t_scale  # in place
    else:
        want_pool = jax_write_gate_row(
            jnp.asarray(pool), jnp.asarray(table), jnp.asarray(pos), jnp.asarray(gate),
            jnp.asarray(ok))
        got_pool = cuda_paged_gate_mix.write_gate_row(
            torch.from_numpy(pool.copy()), torch.from_numpy(table),
            torch.from_numpy(pos), torch.from_numpy(gate), torch.from_numpy(ok))
    keep = [p for p in range(8) if p != DUMP_PAGE]  # two rows race for the dump
    np.testing.assert_array_equal(got_pool.numpy()[keep], np.asarray(want_pool)[keep])
    np.testing.assert_array_equal(got_pool.numpy()[[0, 4, 5, 6]], pool[[0, 4, 5, 6]])
    if scaled:
        np.testing.assert_allclose(got_scale.numpy()[keep],
                                   np.asarray(want_scale)[keep], rtol=1e-7)
        np.testing.assert_array_equal(got_pool[3, 1].numpy(),
                                      quant.np_quantize_w(gate[:1], 0)[0][0])
    else:
        np.testing.assert_array_equal(got_pool[3, 1].numpy(), gate[0])
        np.testing.assert_array_equal(got_pool[7, 1].numpy(), gate[3])


# ------------------------------------------------------------- quantization


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_w_and_rows_match_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(12, 20)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel keeps scale 1
    w[5] = 0.0
    for axis in (-1, 0):
        q, s = quant.quantize_w(torch.from_numpy(w), channel_axis=axis)
        jq, js = jax_quant.quantize_w(jnp.asarray(w), channel_axis=axis)
        nq, ns = quant.np_quantize_w(w, channel_axis=axis)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(q.numpy(), nq)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
        np.testing.assert_allclose(s.numpy(), ns, rtol=1e-7)
        back = quant.dequantize_w(q, s, channel_axis=axis).numpy()
        np.testing.assert_allclose(back, quant.np_dequantize_w(nq, ns, axis), rtol=1e-7)
        assert np.abs(back - w).max() <= ns.max() / 2 + 1e-7
    rows = rng.normal(size=(3, 5, 16)).astype(np.float32)
    rows[1, 2] = 0.0
    q, s = quant.quantize_rows(torch.from_numpy(rows))
    jq, js = jax_quant.quantize_rows(jnp.asarray(rows))
    assert s.shape == (3, 5) and float(s[1, 2]) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    assert quant.QMAX == jax_quant.QMAX == 127.0 and int(q.min()) >= -127


def test_int8_matmul_matches_jax_and_numpy():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 7, 12)).astype(np.float32)
    w = rng.normal(size=(12, 20)).astype(np.float32)
    q, s = quant.np_quantize_w(w)
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    want = jax_quant.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), quant.np_int8_matmul(x, q, s), **F32)
    bf = quant.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(q),
                           torch.from_numpy(s))
    assert bf.dtype == torch.float32
    np.testing.assert_allclose(bf.numpy(), np.asarray(want), rtol=0.05, atol=0.05)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_quantize_params_matches_jax(flax_params):
    """Every dense kernel but ``to_logits`` per output channel,
    ``spatial_weights`` per row; the rest passes through."""
    params = flax_params["params"]
    jq, js = jax_quant.quantize_params(params)
    as_t = lambda tree: {k: as_t(v) if isinstance(v, dict)
                         else torch.from_numpy(np.array(v)) for k, v in tree.items()}
    q, s = quant.quantize_params(as_t(params))
    want_q, want_s = dict(_flat(jq)), dict(_flat(js))
    got_q, got_s = dict(_flat(q)), dict(_flat(s))
    assert set(got_q) == set(want_q) and set(got_s) == set(want_s)
    for path, leaf in got_q.items():
        assert str(leaf.dtype).split(".")[-1] == str(want_q[path].dtype), path
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want_q[path]))
    for path, leaf in got_s.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want_s[path]), rtol=1e-7)
    assert got_q[("to_logits", "kernel")].dtype == torch.float32
    assert got_q[("attn0", "to_qkv", "kernel")].dtype == torch.int8
    assert got_s[("ff2", "sgu", "spatial_weights_scale")].shape == (CFG.seq_len,)
    assert ("to_logits", "kernel_scale") not in got_s


def test_int8_model_matches_jax_on_jax_quantized_params(flax_params):
    """JAX's ``quantize_params`` output, carried over by ``params_from_flax``,
    drives the port's ``weights="int8"`` model to JAX's logits; quantized
    tensors are buffers, not parameters."""
    qtree, scales = jax_quant.quantize_params(flax_params["params"])
    variables = {"params": qtree, "qscale": scales}
    numpy_tree = jax.tree.map(np.asarray, variables)
    model = _port(numpy_tree, weights="int8")
    tokens = np.random.default_rng(3).integers(1, CFG.num_tokens, size=(2, 16))
    jmodel = JaxProGen(config=JAX_CFG, policy=jax_policy(False), weights="int8")
    want = jmodel.apply(variables, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    names = {n for n, _ in model.named_parameters()}
    buffers = dict(model.named_buffers())
    assert "attn.0.to_qkv.weight" not in names and "ff.2.sgu.spatial_weights" not in names
    assert buffers["attn.0.to_qkv.weight"].dtype == torch.int8
    assert buffers["ff.2.sgu.spatial_weights"].dtype == torch.int8
    assert "to_logits.weight" in names  # the head stays full precision
    full = _port(flax_params)
    with torch.no_grad():
        ref = full(torch.from_numpy(tokens))
    assert 0 < float((got - ref).abs().max()) < 0.1  # quantized, and close
    with pytest.raises(ValueError, match="weights mode"):
        ProGen(CFG, make_policy(False), device="cpu", weights="fp8")


# --------------------------------------------- the copied host-side modules


def _pool_script(mod):
    """One scripted life of a page pool; returns everything observed."""
    seen = []
    pool = mod.PagePool(2 + 6, 4)
    toks = list(range(1, 17))
    keys = [mod.prefix_key(16, toks, u) for u in (4, 8, 12)]
    a = pool.allocate(3)
    seen.append(("alloc", a, pool.free_pages, pool.capacity))
    for k, p in zip(keys, a):
        pool.register_prefix(k, p)
    pool.retain(a[0])
    seen.append(("shared", pool.shared_pages, pool.refcount(a[0])))
    for p in a:
        pool.release(p)
    pool.release(a[0])
    seen.append(("cached", pool.cached_pages, pool.free_pages,
                 pool.can_allocate(6), pool.can_allocate(7)))
    seen.append(("lookup", [pool.lookup_prefix(k) for k in (keys[1], keys[0])]))
    b = pool.allocate(5)  # reclaims cached pages, least recently used first
    seen.append(("alloc2", b, pool.cached_pages,
                 [pool.lookup_prefix(k) for k in keys]))
    seen.append(("none", pool.allocate(9), pool.allocate(0)))
    for p in b:
        pool.release(p)
    seen.append(("stats", pool.stats(), sorted(pool.prefix_digest())))
    seen.append(("span", [mod.pages_for_span(r, 4) for r in (-1, 0, 3, 4, 15)],
                 mod.prefix_key(16, toks, 8) == mod.prefix_key(24, toks, 8),
                 mod.token_span_digest(toks, 8)))
    for bad in (lambda: pool.release(b[0]), lambda: pool.retain(mod.NULL_PAGE),
                lambda: mod.PagePool(2, 4), lambda: mod.PagePool(8, 4, gate_dtype="x")):
        try:
            bad()
            seen.append("no error")
        except ValueError:
            seen.append("ValueError")
    return seen


def test_copied_page_pool_behaves_as_the_original():
    assert _pool_script(paging) == _pool_script(jax_paging)


@dataclasses.dataclass
class _Req:
    uid: int
    priority: int = 0
    tenant: int = 0
    deadline: float | None = None
    ttl: float | None = None
    submit_time: float = 0.0


def _queue_script(mod):
    """One scripted life of the scheduling queue; returns the service order
    and the tallies."""
    seen = []
    q = mod.QoSQueue(weights={1: 3.0, 2: 1.0, 3: 0.0})
    reqs = [_Req(0), _Req(1, tenant=1), _Req(2, tenant=2), _Req(3, tenant=1),
            _Req(4, priority=2), _Req(5, tenant=1, deadline=5.0),
            _Req(6, tenant=1, ttl=1.0, submit_time=2.0), _Req(7, tenant=3),
            _Req(8, tenant=2), _Req(9, tenant=1), _Req(10, priority=-1)]
    for r in reqs:
        q.append(r)
    seen.append(("len", len(q), bool(q), q[0].uid, [r.uid for r in q]))
    seen.append(("victim", q.shed_victim().uid))
    q.remove(reqs[8])
    seen.append(("pop", [q.popleft().uid for _ in range(4)]))
    q.appendleft(reqs[8])  # a replay goes to the very front
    q.append(reqs[4])      # a preempted request keeps its seniority
    seen.append(("peek", q[0].uid, len(q)))
    seen.append(("drain", [q.popleft().uid for _ in range(len(q))]))
    seen.append(("empty", len(q), bool(q), q.stats()))
    fifo = mod.QoSQueue()
    for r in reqs[:4]:
        fifo.append(_Req(r.uid))
    seen.append(("fifo", [fifo.popleft().uid for _ in range(4)]))
    return seen


def test_copied_scheduling_queue_behaves_as_the_original():
    assert _queue_script(qos) == _queue_script(jax_qos)
