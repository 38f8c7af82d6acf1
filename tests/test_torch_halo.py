"""K1 with a halo, the port of ``pallas_local_attention_ext``
(``progen_tpu/ops/pallas_attention.py:258``): the plain version
(``ops/local_attention.py``) and the autograd function the model calls
(``ops/cuda_attention.LocalAttentionFn``, which takes the plain version on
a CPU tensor) against the JAX function in interpret mode, forward and VJP
(``dq``, ``dk_ext``, ``dv_ext``), at the context-parallel cases' shapes
(``tests/test_context_parallel.py:21``), f32 at 1e-5 and bf16 at 0.05.
Also: no halo gives the plain version's output from before the halo
existed bit for bit (the code of that version is copied below), a zero
halo equals no halo, the split-sequence identity (two halves, the right
one haloed by the left one's last window, give the whole sequence's out,
dq, dk and dv), and the Hopper kernels' halo walks (``k1_fwd_tiles``,
``k1_bwd_tiles``) meet every visible pair once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from progen_tpu.ops.pallas_attention import pallas_local_attention_ext
from progen_tpu_torch.ops import cuda_attention
from progen_tpu_torch.ops.local_attention import (
    ATTN_MASK_VALUE,
    local_attention,
    local_attention_bwd,
    window_mask,
)

torch.set_num_threads(1)

CASES = [(32, 8), (64, 8), (32, 4)]
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5), "bf16": (torch.bfloat16, jnp.bfloat16, 0.05)}
B, H, D = 2, 3, 8


def _inputs(n, wsz, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, n, D)).astype(np.float32) for _ in range(4))
    kh, vh = (rng.normal(size=(B, H, wsz, D)).astype(np.float32) for _ in range(2))
    return {name: torch.from_numpy(a).to(dtype) for name, a in
            zip(("q", "k", "v", "do", "kh", "vh"), (q, k, v, do, kh, vh))}


def _jax_ext(t, wsz, jdtype):
    """JAX's forward and VJP on the extended keys ``[halo ‖ k]``."""
    j = {name: jnp.asarray(x.float().numpy(), jdtype) for name, x in t.items()}
    k_ext = jnp.concatenate([j["kh"], j["k"]], axis=2)
    v_ext = jnp.concatenate([j["vh"], j["v"]], axis=2)
    f = lambda q, ke, ve: pallas_local_attention_ext(q, ke, ve, wsz, D ** -0.5, True)
    out, vjp = jax.vjp(f, j["q"], k_ext, v_ext)
    return [np.asarray(x, np.float32) for x in (out, *vjp(j["do"]))]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,wsz", CASES)
def test_the_twin_with_a_halo_matches_jax_forward_and_vjp(n, wsz, dtype):
    tdtype, jdtype, tol = DTYPES[dtype]
    t = _inputs(n, wsz, tdtype)
    out, dq, dk_ext, dv_ext = _jax_ext(t, wsz, jdtype)
    got, lse = local_attention(t["q"], t["k"], t["v"], window_size=wsz, return_lse=True,
                               k_halo=t["kh"], v_halo=t["vh"])
    _close(got, out, tol)
    gq, gk, gv, gkh, gvh = local_attention_bwd(t["q"], t["k"], t["v"], got, lse, t["do"], wsz,
                                               k_halo=t["kh"], v_halo=t["vh"])
    _close(gq, dq, tol)
    _close(torch.cat([gkh, gk], 2), dk_ext, tol)
    _close(torch.cat([gvh, gv], 2), dv_ext, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,wsz", CASES)
def test_the_autograd_function_returns_the_halos_gradients(n, wsz, dtype):
    """``LocalAttentionFn`` on CPU tensors: the VJP with respect to q, k,
    v and the halo is JAX's ``(dq, dk_ext, dv_ext)``."""
    tdtype, jdtype, tol = DTYPES[dtype]
    t = _inputs(n, wsz, tdtype, seed=1)
    out, dq, dk_ext, dv_ext = _jax_ext(t, wsz, jdtype)
    leaves = {name: t[name].clone().requires_grad_() for name in ("q", "k", "v", "kh", "vh")}
    got = cuda_attention.local_attention(leaves["q"], leaves["k"], leaves["v"], wsz,
                                         k_halo=leaves["kh"], v_halo=leaves["vh"])
    got.backward(t["do"])
    _close(got.detach(), out, tol)
    _close(leaves["q"].grad, dq, tol)
    _close(torch.cat([leaves["kh"].grad, leaves["k"].grad], 2), dk_ext, tol)
    _close(torch.cat([leaves["vh"].grad, leaves["v"].grad], 2), dv_ext, tol)


def _before_the_halo(q, k, v, do, wsz):
    """The plain version as it was before the halo: forward (out, lse) and
    backward (dq, dk, dv), the phantom window a zero pad."""
    def pair(t):
        t = F.pad(t, (0, 0, 0, 0, 1, 0))
        return torch.cat((t[..., :-1, :, :], t[..., 1:, :, :]), dim=-2)

    b, h, n, d = q.shape
    w, scale = n // wsz, d ** -0.5
    qw, dow = q.reshape(b, h, w, wsz, d), do.reshape(b, h, w, wsz, d)
    kw, vw = pair(k.reshape(b, h, w, wsz, d)), pair(v.reshape(b, h, w, wsz, d))
    sim = torch.einsum("bhwid,bhwjd->bhwij", qw.float(), kw.float()) * scale
    sim = sim.masked_fill(~window_mask(wsz), ATTN_MASK_VALUE)
    attn = torch.softmax(sim, dim=-1).to(vw.dtype)
    out = torch.einsum("bhwij,bhwjd->bhwid", attn.float(), vw.float())
    out = out.to(vw.dtype).reshape(b, h, n, d)
    lse = torch.logsumexp(sim, dim=-1)
    dd = (do.float() * out.float()).sum(-1).reshape(b, h, w, wsz, 1)
    p = torch.exp(sim - lse.reshape(b, h, w, wsz, 1))
    ds = p * (torch.einsum("bhwid,bhwjd->bhwij", dow.float(), vw.float()) - dd)
    dq = torch.einsum("bhwij,bhwjd->bhwid", ds.to(k.dtype).float(), kw.float()) * scale
    dkw = torch.einsum("bhwij,bhwid->bhwjd", ds.to(q.dtype).float(), qw.float())
    dvw = torch.einsum("bhwij,bhwid->bhwjd", p.to(do.dtype).float(), dow.float())

    def fold(t):
        own, prev = t[..., wsz:, :], t[..., :wsz, :]
        return own + F.pad(prev[:, :, 1:], (0, 0, 0, 0, 0, 1))

    return (out, lse.reshape(b, h, n), dq.to(q.dtype).reshape(b, h, n, d),
            (fold(dkw) * scale).to(k.dtype).reshape(b, h, n, d),
            fold(dvw).to(v.dtype).reshape(b, h, n, d))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,wsz", CASES)
def test_no_halo_is_the_plain_version_from_before_bit_for_bit(n, wsz, dtype):
    t = _inputs(n, wsz, DTYPES[dtype][0], seed=2)
    want = _before_the_halo(t["q"], t["k"], t["v"], t["do"], wsz)
    out, lse = local_attention(t["q"], t["k"], t["v"], window_size=wsz, return_lse=True)
    grads = local_attention_bwd(t["q"], t["k"], t["v"], out, lse, t["do"], wsz)
    assert len(grads) == 3
    for got, ref in zip((out, lse, *grads), want):
        assert torch.equal(got, ref)
    # a zero halo is the phantom window, bit for bit
    zeros = torch.zeros_like(t["kh"])
    out0, lse0 = local_attention(t["q"], t["k"], t["v"], window_size=wsz, return_lse=True,
                                 k_halo=zeros, v_halo=zeros)
    assert torch.equal(out0, out) and torch.equal(lse0, lse)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,wsz", CASES)
def test_split_sequence_identity(n, wsz, dtype):
    """Two halves, the right one haloed by the left one's last window,
    give the whole sequence's out, and their gradients (the right half's
    halo gradient added to the left half's last window) the whole's dq, dk
    and dv: what ``sp`` does across two ranks."""
    tdtype, _, tol = DTYPES[dtype]
    t = _inputs(n, wsz, tdtype, seed=3)
    half = n // 2
    whole, lse = local_attention(t["q"], t["k"], t["v"], window_size=wsz, return_lse=True)
    want = local_attention_bwd(t["q"], t["k"], t["v"], whole, lse, t["do"], wsz)
    left = {name: t[name][:, :, :half] for name in ("q", "k", "v", "do")}
    right = {name: t[name][:, :, half:] for name in ("q", "k", "v", "do")}
    out_l, lse_l = local_attention(left["q"], left["k"], left["v"], window_size=wsz,
                                   return_lse=True)
    kh, vh = left["k"][:, :, -wsz:], left["v"][:, :, -wsz:]
    out_r, lse_r = local_attention(right["q"], right["k"], right["v"], window_size=wsz,
                                   return_lse=True, k_halo=kh, v_halo=vh)
    _close(torch.cat([out_l, out_r], 2), whole.float().numpy(), tol)
    dq_l, dk_l, dv_l = local_attention_bwd(left["q"], left["k"], left["v"], out_l, lse_l,
                                           left["do"], wsz)
    dq_r, dk_r, dv_r, dkh, dvh = local_attention_bwd(right["q"], right["k"], right["v"],
                                                     out_r, lse_r, right["do"], wsz,
                                                     k_halo=kh, v_halo=vh)
    dk_l, dv_l = dk_l.clone(), dv_l.clone()
    dk_l[:, :, -wsz:] += dkh
    dv_l[:, :, -wsz:] += dvh
    for got, ref in zip((torch.cat([dq_l, dq_r], 2), torch.cat([dk_l, dk_r], 2),
                         torch.cat([dv_l, dv_r], 2)), want):
        _close(got, ref.float().numpy(), tol)


def test_a_halo_of_another_shape_is_refused():
    t = _inputs(32, 8, torch.float32)
    with pytest.raises(ValueError, match="halo"):
        local_attention(t["q"], t["k"], t["v"], window_size=8, k_halo=t["kh"][:, :, :4],
                        v_halo=t["vh"][:, :, :4])
    with pytest.raises(ValueError, match="together"):
        cuda_attention.local_attention(t["q"], t["k"], t["v"], 8, k_halo=t["kh"])


def _visible_ext(n, wsz):
    """[query, key + wsz]: query i sees keys of its own window up to i and
    all of the previous one, the halo being window -1."""
    i = np.arange(n)[:, None]
    e = np.arange(-wsz, n)[None, :]
    return (e <= i) & (e >= (i // wsz - 1) * wsz)


@pytest.mark.parametrize("n,wsz", [(256, 128), (512, 128), (1024, 256), (2048, 512)])
def test_the_halo_walks_meet_every_visible_pair_once(n, wsz):
    """K1-fwd's and K1-dq's blocks of window 0 stream the halo's tiles
    first, and K1-dkv's halo blocks stream window 0's queries: with the
    diagonal tiles masked, every visible (query, key) pair of the extended
    keys is met once by each of the three, and no other."""
    tri = np.tril(np.ones((64, 64), dtype=int))
    for side in ("fwd", "dq", "dkv"):
        seen = np.zeros((n, n + wsz), dtype=int)
        if side == "fwd":
            walk = [p for _, w in cuda_attention.k1_fwd_tiles(n, wsz, halo=True) for p in w]
        else:
            walk = cuda_attention.k1_bwd_tiles(n, wsz, side, halo=True)
        for r0, t0, kind in walk:
            if kind == "skipped":
                continue
            tile = np.ones((64, 64), dtype=int) if kind == "full" else tri
            if side == "dkv":
                assert -wsz <= r0 and 0 <= t0 and t0 + 64 <= n
                seen[t0:t0 + 64, r0 + wsz:r0 + wsz + 64] += tile
            else:
                assert -wsz <= t0 and t0 + 64 <= n
                seen[r0:r0 + 64, t0 + wsz:t0 + wsz + 64] += tile
        assert seen.max() == 1, side
        assert (seen.astype(bool) == _visible_ext(n, wsz)).all(), side
