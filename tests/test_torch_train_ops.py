"""The port's backward ops against the JAX package's, on the same
numpy-seeded inputs: the windowed-attention backward (plain and through
``cuda_attention.local_attention``'s autograd on the CPU) against
``jax.vjp`` of the XLA op and the Pallas ``_backward_ext`` in the
interpreter, and the SGU backward against ``jax.vjp`` of the interpreted
Pallas op and of the XLA composition.  f32 is held at rtol/atol 1e-5; bf16
at 0.05 relative plus 2e-2 of the gradient's largest magnitude, since the
gradients' size depends on the shape.  Also: the backward wrappers raise on
CUDA tensors they cannot take (misaligned ones too), and never fall back;
the attention backward's route for every shipped config; and the Hopper
kernels' tile walk against the visibility mask."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from progen_tpu.ops import local_attention as jax_local_attention
from progen_tpu.ops.pallas_attention import _backward_ext, _forward_ext
from progen_tpu.ops.pallas_sgu import pallas_spatial_gate
from progen_tpu.ops.sgu import spatial_gate as jax_spatial_gate
from progen_tpu_torch import kernels
from progen_tpu_torch.kernels import ablate
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.ops.local_attention import local_attention, local_attention_bwd

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _bf16_close(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0.05,
                               atol=2e-2 * float(np.abs(want).max()))


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_attention_grads(q, k, v, do, wsz, scale):
    """(XLA vjp, interpreted Pallas backward) of windowed attention."""
    _, vjp = jax.vjp(lambda q, k, v: jax_local_attention(
        q, k, v, window_size=wsz, scale=scale), q, k, v)
    xla = vjp(do)
    pad = [(0, 0), (0, 0), (wsz, 0), (0, 0)]
    k_ext, v_ext = jnp.pad(k, pad), jnp.pad(v, pad)
    out, lse = _forward_ext(q, k_ext, v_ext, wsz, scale, True)
    dq, dk_ext, dv_ext = _backward_ext(q, k_ext, v_ext, out, lse, do, wsz,
                                       scale, True)
    return xla, (dq, dk_ext[:, :, wsz:], dv_ext[:, :, wsz:])


ATTN_CASES = [
    (2, 2, 32, 16, 8),    # four windows, wsz < a 64-row tile
    (1, 2, 16, 32, 16),   # a single window: the phantom window only
    (2, 1, 128, 32, 64),
]


@pytest.mark.parametrize("b,h,n,d,wsz", ATTN_CASES)
def test_attention_backward_matches_jax_and_pallas(b, h, n, d, wsz):
    rng = np.random.default_rng(n + wsz)
    q, k, v, do = (rng.normal(size=(b, h, n, d)).astype(np.float32)
                   for _ in range(4))
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    out, lse = local_attention(tq, tk, tv, window_size=wsz, return_lse=True)
    plain = local_attention_bwd(tq, tk, tv, out, lse, tdo, wsz, scale)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    cuda_attention.local_attention(*leaves, wsz, scale).backward(tdo)
    autograd = [t.grad for t in leaves]
    for reference in _jax_attention_grads(q, k, v, do, wsz, scale):
        for got_plain, got_auto, want in zip(plain, autograd, reference):
            np.testing.assert_allclose(_np(got_plain), _np(want), **F32)
            np.testing.assert_allclose(_np(got_auto), _np(want), **F32)


def test_attention_backward_phantom_window_counts_in_lse():
    """Window 0's rows take the forward's lse, which holds the phantom
    window's zero logits: a phantom-free lse gives other gradients."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 1, 16, 16)).astype(np.float32))
                   for _ in range(4))
    out, lse = local_attention(q, k, v, window_size=8, return_lse=True)
    sim = torch.einsum("bhid,bhjd->bhij", q[:, :, :8], k[:, :, :8]) * 16 ** -0.5
    own_only = torch.logsumexp(sim.masked_fill(
        ~torch.ones(8, 8, dtype=torch.bool).tril(), -1e10), dim=-1)
    assert float((lse[..., :8] - own_only).min()) > 0.1
    bad = lse.clone()
    bad[..., :8] = own_only
    good = local_attention_bwd(q, k, v, out, lse, do, 8)
    worse = local_attention_bwd(q, k, v, out, bad, do, 8)
    assert not torch.allclose(good[0], worse[0], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("b,h,n,d,wsz", [(2, 2, 32, 16, 8)])
def test_attention_backward_bf16_matches_pallas(b, h, n, d, wsz):
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.normal(size=(b, h, n, d)).astype(np.float32)
                   for _ in range(4))
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(t).bfloat16() for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = cuda_attention.local_attention(*leaves, wsz, scale)
    out.backward(tdo)
    j = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do)]
    _, pallas = _jax_attention_grads(*j, wsz, scale)
    for leaf, want in zip(leaves, pallas):
        assert leaf.grad.dtype == torch.bfloat16
        _bf16_close(leaf.grad, want)


def _sgu_inputs(rng, b, n, d):
    res, gate, dout = (rng.normal(size=(b, n, d)).astype(np.float32)
                       for _ in range(3))
    w = rng.normal(0, 0.05, size=(n, n)).astype(np.float32)
    bias = rng.normal(size=(n, 1)).astype(np.float32)
    return res, gate, w, bias, dout


def _port_sgu_grads(res, gate, w, bias, dout, dtype=torch.float32):
    leaves = [torch.from_numpy(t).to(dtype).requires_grad_()
              for t in (res, gate, w, bias)]
    cuda_sgu.gated_mix(*leaves).backward(torch.from_numpy(dout).to(dtype))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("n", [64, 100])  # 100: not a multiple of a tile
def test_sgu_backward_matches_jax_and_pallas(n):
    rng = np.random.default_rng(n)
    res, gate, w, bias, dout = _sgu_inputs(rng, 2, n, 16)
    got = _port_sgu_grads(res, gate, w, bias, dout)
    args = [jnp.asarray(t) for t in (res, gate, w, bias)]
    _, vjp = jax.vjp(lambda *a: pallas_spatial_gate(*a, interpret=True), *args)
    pallas = vjp(jnp.asarray(dout))
    _, vjp = jax.vjp(lambda r, g, w, b: r * jax_spatial_gate(g, w, b), *args)
    xla = vjp(jnp.asarray(dout))
    for reference in (pallas, xla):
        for g, want in zip(got, reference):
            np.testing.assert_allclose(_np(g), _np(want), **F32)
    assert torch.count_nonzero(torch.triu(got[2], 1)) == 0


def test_sgu_backward_bf16_matches_pallas():
    rng = np.random.default_rng(5)
    res, gate, w, bias, dout = _sgu_inputs(rng, 2, 64, 16)
    got = _port_sgu_grads(res, gate, w, bias, dout, torch.bfloat16)
    args = [jnp.asarray(t, jnp.bfloat16) for t in (res, gate, w, bias)]
    _, vjp = jax.vjp(lambda *a: pallas_spatial_gate(*a, interpret=True), *args)
    for g, want in zip(got, vjp(jnp.asarray(dout, jnp.bfloat16))):
        assert g.dtype == torch.bfloat16
        _bf16_close(g, want)
    assert torch.count_nonzero(torch.triu(got[2], 1)) == 0


def test_backward_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 2, 16, 32)).astype(np.float32))
                   for _ in range(4))
    res, gate, dout = (torch.from_numpy(rng.normal(size=(2, 16, 8)).astype(np.float32))
                       for _ in range(3))
    w = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
    before = (cuda_attention.dq_launches, cuda_attention.dkv_launches,
              cuda_sgu.dgate_launches, cuda_sgu.dw_launches)
    out, lse = cuda_attention.local_attention_fwd(q, k, v, 8)
    for got, want in zip(cuda_attention.local_attention_bwd(q, k, v, out, lse, do, 8),
                         local_attention_bwd(q, k, v, out, lse, do, 8)):
        assert torch.equal(got, want)
    assert torch.equal(cuda_sgu.spatial_gate_dgate(w, dout, res),
                       torch.einsum("bmd,mn->bnd", dout * res, torch.tril(w)))
    assert torch.count_nonzero(torch.triu(cuda_sgu.spatial_gate_dw(dout, res, gate), 1)) == 0
    assert (cuda_attention.dq_launches, cuda_attention.dkv_launches,
            cuda_sgu.dgate_launches, cuda_sgu.dw_launches) == before


def _fake_cuda(*shapes, dtype=torch.float32):
    with FakeTensorMode():
        return [torch.empty(*s, device="cuda", dtype=dtype) for s in shapes]


def test_backward_wrappers_raise_on_cuda_tensors_without_a_build(monkeypatch):
    monkeypatch.setattr(kernels, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(cuda_attention, "_fns", {})
    monkeypatch.setattr(cuda_sgu, "_fns", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR / "absent")
    q, lse, rows, w = _fake_cuda((1, 2, 16, 32), (1, 2, 16), (2, 16, 8), (16, 16))
    before = (cuda_attention.dq_launches, cuda_attention.dkv_launches,
              cuda_sgu.dgate_launches, cuda_sgu.dw_launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_attention.local_attention_bwd(q, q, q, q, lse, q, 8)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_sgu.spatial_gate_dgate(w, rows, rows)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_sgu.spatial_gate_dw(rows, rows, rows)
    assert (cuda_attention.dq_launches, cuda_attention.dkv_launches,
            cuda_sgu.dgate_launches, cuda_sgu.dw_launches) == before


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    q, lse, bad_lse, rows, w, w8, odd = _fake_cuda(
        (1, 2, 16, 32), (1, 2, 16), (1, 2, 8), (2, 16, 8), (16, 16), (8, 8),
        (2, 16, 12))
    q48, = _fake_cuda((1, 2, 16, 48))
    q16, rows16 = _fake_cuda((1, 2, 16, 32), (2, 16, 8), dtype=torch.float16)
    with pytest.raises(ValueError, match="dim_head"):
        cuda_attention.local_attention_bwd(q48, q48, q48, q48, lse, q48, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_attention.local_attention_bwd(q16, q16, q16, q16, lse, q16, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_attention.local_attention_bwd(q, q, q, q, lse, q16, 8)
    with pytest.raises(ValueError, match="divisible"):
        cuda_attention.local_attention_bwd(q, q, q, q, lse, q, 5)
    with pytest.raises(ValueError, match="lse"):
        cuda_attention.local_attention_bwd(q, q, q, q, bad_lse, q, 8)
    with pytest.raises(ValueError, match="lse and D"):
        cuda_attention.local_attention_bwd_dq(q, q, q, q, lse, bad_lse, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_attention.local_attention_bwd_dkv(q, q, q, q16, lse, lse, 8)
    cpu = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_attention.local_attention_bwd_dq(cpu, cpu, cpu, cpu, cpu[..., 0], cpu[..., 0], 8)
    with pytest.raises(ValueError, match="d % 8"):
        cuda_sgu.spatial_gate_dgate(w, odd, odd)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_sgu.spatial_gate_dw(rows16, rows16, rows16)
    with pytest.raises(ValueError, match="one shape"):
        cuda_sgu.spatial_gate_dw(rows, rows, odd)
    with pytest.raises(ValueError, match="weights"):
        cuda_sgu.spatial_gate_dgate(w8, rows, rows)


def _misaligned_cuda(shape, dtype):
    """A contiguous fake CUDA view one element past a 16-byte boundary."""
    numel = int(np.prod(shape))
    with FakeTensorMode():
        base = torch.empty(numel + 1, device="cuda", dtype=dtype)
        return base.as_strided(shape, torch.empty(shape).stride(), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgu_backward_wrappers_refuse_misaligned_tensors(dtype):
    rows, w = _fake_cuda((2, 16, 8), (16, 16), dtype=dtype)
    bad_rows = _misaligned_cuda((2, 16, 8), dtype)
    bad_w = _misaligned_cuda((16, 16), dtype)
    assert bad_rows.is_contiguous() and bad_rows.data_ptr() % 16 != 0
    before = cuda_sgu.dgate_launches, cuda_sgu.dw_launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_sgu.spatial_gate_dgate(w, rows, bad_rows)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_sgu.spatial_gate_dgate(bad_w, rows, rows)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_sgu.spatial_gate_dw(rows, rows, bad_rows)
    assert (cuda_sgu.dgate_launches, cuda_sgu.dw_launches) == before


@pytest.mark.parametrize("batch,d", [(1, 8), (1, 520), (8, 2048), (2, 8192)])
@pytest.mark.parametrize("n", [100, 1000, 1024, 4096])
@pytest.mark.parametrize("sms", [1, 132])
def test_dw_split_covers_the_reduction_axis_once(batch, d, n, sms):
    """B * d in {8, 520, 16384}: every (batch row, channel) pair lies in
    exactly one split's steps, no split is empty, and the blocks fill the
    SMs without a second wave where the axis is long enough."""
    splits, ranges = cuda_sgu.dw_split(batch, n, d, sms)
    chunks = -(-d // cuda_sgu.DW_STEP)
    seen = np.zeros((batch, d), dtype=int)
    for steps in ranges:
        assert len(steps) > 0
        for j in steps:
            c0 = (j % chunks) * cuda_sgu.DW_STEP
            seen[j // chunks, c0:c0 + cuda_sgu.DW_STEP] += 1
    assert (seen == 1).all()
    assert splits == len(ranges)
    side = -(-n // cuda_sgu.DW_TILE)
    tiles = side * (side + 1) // 2
    assert tiles * splits <= max(sms, tiles)
    assert splits == min(batch * chunks, max(1, sms // tiles))
    assert cuda_sgu.dw_workspace_numel(n, splits) == splits * tiles * 128 * 128


def test_dw_split_at_progen_small_is_one_wave_of_three_splits():
    splits, ranges = cuda_sgu.dw_split(8, 1024, 2048, 132)
    assert splits == 3 and [len(r) for r in ranges] == [85, 85, 86]
    assert cuda_sgu.dw_workspace_numel(1024, splits) * 4 == 7_077_888


@pytest.mark.parametrize("n", [64, 100, 130])
def test_dgate_weights_are_padded_to_16_byte_rows(n):
    w = torch.from_numpy(np.random.default_rng(n).normal(size=(n, n)).astype(np.float32))
    padded = cuda_sgu._padded_weights(w)
    assert padded.shape == (n, -(-n // 8) * 8)
    assert torch.equal(padded[:, :n], w)
    assert not padded[:, n:].any()
    if n % 8 == 0:
        assert padded is w


def test_resource_report_needs_nvcc(monkeypatch):
    monkeypatch.setattr(kernels, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.resource_report("sgu_bwd")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_bwd_route_of_every_shipped_config(config, dtype):
    """bf16 takes the Hopper kernels wherever dim_head is 64 or 128 and the
    window a multiple of 128 (every config but ``default``); f32 always
    takes the WMMA kernels."""
    c = CONFIGS[config]
    want = "wgmma" if dtype == torch.bfloat16 and config != "default" else "wmma"
    assert cuda_attention.bwd_route(dtype, c.dim_head, c.window_size) == want


@pytest.mark.parametrize("dtype,d,wsz,want", [
    (torch.bfloat16, 32, 256, "wmma"),    # dim_head 32
    (torch.bfloat16, 128, 8, "wmma"),     # windows under one block of rows
    (torch.bfloat16, 128, 40, "wmma"),
    (torch.bfloat16, 64, 64, "wmma"),
    (torch.bfloat16, 128, 192, "wmma"),   # not a multiple of 128
    (torch.bfloat16, 64, 128, "wgmma"),   # the smallest window taken
    (torch.bfloat16, 128, 384, "wgmma"),
    (torch.float32, 128, 256, "wmma"),    # f32: the comparison path
    (torch.float32, 64, 512, "wmma"),
])
def test_bwd_route_of_odd_shapes(dtype, d, wsz, want):
    assert cuda_attention.bwd_route(dtype, d, wsz) == want


def _visible(n, wsz):
    """(query, real key) visibility: own window up to the query, and all of
    the previous window (window 0's is the phantom, which has no real keys)."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return (j <= i) & (j >= (i // wsz - 1) * wsz)


@pytest.mark.parametrize("side", ["dq", "dkv"])
@pytest.mark.parametrize("n,wsz", [(256, 128), (256, 256), (1024, 128), (1024, 256),
                                   (1024, 512), (2048, 128), (2048, 256), (2048, 512)])
def test_k1_bwd_tile_walk_covers_each_visible_pair_once(n, wsz, side):
    """The Hopper kernels' tile walk, the diagonal tiles masked, visits every
    visible (query, real key) pair exactly once and no other, never reaches
    past the sequence, and does real_visible's count of pairs."""
    import chip_smoke

    seen = np.zeros((n, n), dtype=int)  # [query, key]
    tri = np.tril(np.ones((64, 64), dtype=int))  # [query, key]: key <= query
    pairs = cuda_attention.k1_bwd_tiles(n, wsz, side)
    for r0, t0, kind in pairs:
        assert kind in ("full", "diagonal", "skipped")
        assert 0 <= t0 and t0 + 64 <= n and r0 + 64 <= n
        if kind == "skipped":
            continue
        tile = np.ones((64, 64), dtype=int) if kind == "full" else tri
        if side == "dq":  # rows are queries, the streamed tile keys
            seen[r0:r0 + 64, t0:t0 + 64] += tile
        else:             # rows are keys, the streamed tile queries
            seen[t0:t0 + 64, r0:r0 + 64] += tile
    visible = _visible(n, wsz)
    assert seen.max() == 1
    assert (seen.astype(bool) == visible).all()
    assert int(seen.sum()) == chip_smoke.real_visible(n, wsz)
    assert len(pairs) % 2 == 0  # both warpgroups of a block meet every tile


def test_k1_bwd_tile_walk_at_progen_small():
    """88 of 96 (warpgroup, tile) pairs per (b, h) do work at n = 1024,
    wsz = 256 on either side; 44 of them are diagonal or full in dq's own
    window."""
    for side in ("dq", "dkv"):
        kinds = [kind for _, _, kind in cuda_attention.k1_bwd_tiles(1024, 256, side)]
        assert len(kinds) == 96
        assert kinds.count("skipped") == 8 and kinds.count("diagonal") == 16


@pytest.mark.parametrize("route,dtype,d,wsz", [
    ("wgmma", torch.bfloat16, 128, 128),
    ("wgmma", torch.bfloat16, 64, 256),
    ("wmma", torch.float32, 128, 128),
    ("wmma", torch.bfloat16, 32, 64),
])
@pytest.mark.parametrize("bad", ["q", "do", "lse"])
def test_attention_backward_wrappers_refuse_misaligned_tensors(route, dtype, d, wsz, bad):
    """TMA copies and 16-byte loads need 16-byte-aligned tensors: a view one
    element off is refused before any launch, on either route."""
    assert cuda_attention.bwd_route(dtype, d, wsz) == route
    shape = (1, 2, 256, d)
    q, = _fake_cuda(shape, dtype=dtype)
    lse, = _fake_cuda(shape[:3])
    args = {"q": q, "do": q, "lse": lse}
    args[bad] = _misaligned_cuda(shape[:3] if bad == "lse" else shape,
                                 torch.float32 if bad == "lse" else dtype)
    assert args[bad].is_contiguous() and args[bad].data_ptr() % 16 != 0
    before = (cuda_attention.dq_launches, cuda_attention.dkv_launches,
              dict(cuda_attention.bwd_route_launches))
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_attention.local_attention_bwd_dq(args["q"], q, q, args["do"], args["lse"],
                                              lse, wsz)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_attention.local_attention_bwd_dkv(args["q"], q, q, args["do"], args["lse"],
                                               lse, wsz)
    assert (cuda_attention.dq_launches, cuda_attention.dkv_launches,
            cuda_attention.bwd_route_launches) == before


def check_ablation_applies(source: str, variant: str) -> None:
    """An ablation finds every place it edits in the kernels' source (a
    source edit that moves one fails here, not on the card), and only the
    whole source comes back unchanged."""
    start, _, variants = ablate.SOURCES[source]
    text = (kernels.CSRC / f"{source}.cu").read_text()
    part = ablate.variant_source(source, variant).split(start, 1)[1]
    assert (part == text.split(start, 1)[1]) == (variant == "whole")
    for edit in variants[variant]:
        new, count = (edit[1], edit[2]) if isinstance(edit[2], int) else (edit[2], 1)
        assert part.count(new) >= count


@pytest.mark.parametrize("variant", sorted(ablate.SOURCES["local_attention_bwd"][2]))
def test_k1_bwd_ablation_variants_apply_to_the_source(variant):
    """Each ablation of the Hopper K1 backward applies to its source."""
    check_ablation_applies("local_attention_bwd", variant)
