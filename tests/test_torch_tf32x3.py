"""The design of K1's f32 route on the tensor cores (``"tf32x3"``: K1-fwd,
K1-dq and K1-dkv, ``kernels/csrc/attention_tf32x3.cuh``), checked on the
CPU.

The kernels form every f32 product as three TF32 products: each operand
``x`` split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, rounded as
``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero, 10 mantissa
bits), and ``a.b = lo_a.hi_b + hi_a.lo_b + hi_a.hi_b`` summed in f32.  Here
that rounding and that split are emulated in torch, and put in place of
every product of the plain K1-fwd, K1-dq and K1-dkv
(``ops/local_attention.py``, whose twins stay plain f32): the emulated
results, at 2 windows of 64 and ``dim_head`` 64, with and without a halo,
against JAX's ``pallas_local_attention`` and its VJP in the Pallas
interpreter, at the port's f32 bars (``out`` and ``lse`` 1e-4; ``dq``,
``dk`` and ``dv`` 1e-4 of their largest magnitude plus 1e-4 relative, and
an RMS error within 1e-4 of their RMS, ``chip_smoke.py``'s ``TOL_GRAD`` and
``TOL_GRAD_RMS``).  One TF32 product alone misses those bars.  K1-dq's f32
tile walk (32-key tiles, warps of 16 rows) meets every visible pair once.
The route functions are pinned for every shipped config, in f32 and bf16.

At ``dim_head`` 32 (ProGen-default) K1-fwd and K1-dkv take their own f32
design (``attention_tf32x3.cuh``'s ``d32``: blocks of 64 rows, four warps
of 16, each warp's own operand split once and held): it is emulated as it
walks (``k1_fwd_tiles`` and ``k1_bwd_tiles`` with the D-32 blocks, the
online softmax tile by tile), every product 3xTF32, against JAX's kernels
and VJP in the interpreter at 2 windows of 128, with and without a halo;
and its walks meet every visible pair once.

K2's f32 route (K2-fwd, K2-dgate and K2-dW, ``sgu_fwd.cu`` and
``sgu_bwd.cu``) the same way: the kernels' own plans emulated (K2-fwd's and
K2-dgate's tile walks at 32-deep steps, ``cuda_sgu.k2_fwd_tiles`` and
``k2_dgate_tiles``; K2-dW's split ranges and their ordered sum,
``cuda_sgu.dw_split``) with every product 3xTF32, against JAX's
``pallas_spatial_gate`` and its VJP in the Pallas interpreter: ``out`` at
1e-4, ``dW`` and ``d_gate`` at the scaled f32 bar, and at least 10x under
the error of one TF32 product a product.  The K2 route functions are
pinned for both dtypes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.ops.pallas_attention import _forward_ext, pallas_local_attention_ext
from progen_tpu.ops.pallas_sgu import pallas_spatial_gate
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.ops.local_attention import (
    ATTN_MASK_VALUE,
    concat_previous_window,
    window_mask,
)

torch.set_num_threads(1)

B, H, N, WSZ, D = 2, 2, 128, 64, 64   # 2 windows of 64, dim_head 64
TOL = 1e-4                             # the port's f32 bar


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (half an ulp added to the magnitude, the 13 low bits
    cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels form it: three TF32 products, the small ones
    first, summed in f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one TF32 product."""
    return tf32(a) @ tf32(b)


def emulated_fwd(q, k, v, mm, k_halo=None, v_halo=None):
    """The plain K1-fwd (``local_attention``) with its two products through
    ``mm``: ``(out, lse)``."""
    b, h, n, d = q.shape
    w = n // WSZ
    qw = q.reshape(b, h, w, WSZ, d)
    kw = concat_previous_window(k.reshape(b, h, w, WSZ, d), k_halo)
    vw = concat_previous_window(v.reshape(b, h, w, WSZ, d), v_halo)
    sim = mm(qw, kw.transpose(-1, -2)) * d ** -0.5
    sim = sim.masked_fill(~window_mask(WSZ), ATTN_MASK_VALUE)
    out = mm(torch.softmax(sim, dim=-1), vw).reshape(b, h, n, d)
    return out, torch.logsumexp(sim, dim=-1).reshape(b, h, n)


def emulated_dkv(q, k, v, do, out, lse, mm, k_halo=None, v_halo=None):
    """The plain K1-dkv (``local_attention_bwd``'s dk and dv) with its four
    products through ``mm``: ``(dk, dv)``, with a halo ``(dk, dv, dk_halo,
    dv_halo)``."""
    b, h, n, d = q.shape
    w, scale = n // WSZ, d ** -0.5
    qw = q.reshape(b, h, w, WSZ, d)
    dow = do.reshape(b, h, w, WSZ, d)
    kw = concat_previous_window(k.reshape(b, h, w, WSZ, d), k_halo)
    vw = concat_previous_window(v.reshape(b, h, w, WSZ, d), v_halo)
    dd = (do * out).sum(-1).reshape(b, h, w, WSZ, 1)
    sim = mm(kw, qw.transpose(-1, -2)).transpose(-1, -2) * scale    # s^T = k.q^T
    sim = sim.masked_fill(~window_mask(WSZ), ATTN_MASK_VALUE)
    p = torch.exp(sim - lse.reshape(b, h, w, WSZ, 1))
    dp = mm(vw, dow.transpose(-1, -2)).transpose(-1, -2)            # dp^T = v.dout^T
    ds = p * (dp - dd)
    dkw = mm(ds.transpose(-1, -2), qw)                               # ds^T.q
    dvw = mm(p.transpose(-1, -2), dow)                               # p^T.dout

    def fold(t):  # key window m: its own half of query window m, the previous of m + 1
        own, prev = t[..., WSZ:, :], t[..., :WSZ, :]
        return own + torch.nn.functional.pad(prev[:, :, 1:], (0, 0, 0, 0, 0, 1))

    dk = (fold(dkw) * scale).reshape(b, h, n, d)
    dv = fold(dvw).reshape(b, h, n, d)
    if k_halo is None:
        return dk, dv
    return dk, dv, dkw[:, :, 0, :WSZ] * scale, dvw[:, :, 0, :WSZ]


def emulated_dq(q, k, v, do, out, lse, mm, k_halo=None, v_halo=None):
    """The plain K1-dq (``local_attention_bwd``'s dq) with its three
    products through ``mm``: s = q.k^T, dp = dout.v^T and ds.k."""
    b, h, n, d = q.shape
    w, scale = n // WSZ, d ** -0.5
    qw = q.reshape(b, h, w, WSZ, d)
    dow = do.reshape(b, h, w, WSZ, d)
    kw = concat_previous_window(k.reshape(b, h, w, WSZ, d), k_halo)
    vw = concat_previous_window(v.reshape(b, h, w, WSZ, d), v_halo)
    dd = (do * out).sum(-1).reshape(b, h, w, WSZ, 1)
    sim = mm(qw, kw.transpose(-1, -2)) * scale
    sim = sim.masked_fill(~window_mask(WSZ), ATTN_MASK_VALUE)
    p = torch.exp(sim - lse.reshape(b, h, w, WSZ, 1))
    ds = p * (mm(dow, vw.transpose(-1, -2)) - dd)
    return (mm(ds, kw) * scale).reshape(b, h, n, d)


def _inputs(halo: bool, seed: int = 0, shape=(B, H, N, D), wsz: int = WSZ) -> dict:
    rng = np.random.default_rng(seed)
    names = ["q", "k", "v", "do"] + (["kh", "vh"] if halo else [])
    shapes = [shape] * 4 + [(*shape[:2], wsz, shape[3])] * 2
    return {name: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for name, s in zip(names, shapes)}


def _jax(t: dict, wsz: int = WSZ) -> dict:
    """JAX's forward (out, lse) and VJP (dq, dk, dv and the halo's) in the
    Pallas interpreter, on ``[halo or the phantom zeros ‖ k]``."""
    j = {name: jnp.asarray(x.numpy()) for name, x in t.items()}
    b, h, _, d = j["q"].shape
    front = [(j["kh"], j["vh"])] if "kh" in j else [(jnp.zeros((b, h, wsz, d)),) * 2]
    k_ext = jnp.concatenate([front[0][0], j["k"]], axis=2)
    v_ext = jnp.concatenate([front[0][1], j["v"]], axis=2)
    _, lse = _forward_ext(j["q"], k_ext, v_ext, wsz, d ** -0.5, True)
    f = lambda q, ke, ve: pallas_local_attention_ext(q, ke, ve, wsz, d ** -0.5, True)
    out, vjp = jax.vjp(f, j["q"], k_ext, v_ext)
    dq, dk_ext, dv_ext = vjp(j["do"])
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk_ext[:, :, wsz:],
           "dv": dv_ext[:, :, wsz:]}
    if "kh" in j:
        got.update(dk_halo=dk_ext[:, :, :wsz], dv_halo=dv_ext[:, :, :wsz])
    return {name: torch.from_numpy(np.array(x, np.float32)) for name, x in got.items()}


def _emulated(t: dict, mm) -> dict:
    halo = (t["kh"], t["vh"]) if "kh" in t else (None, None)
    out, lse = emulated_fwd(t["q"], t["k"], t["v"], mm, *halo)
    dq = emulated_dq(t["q"], t["k"], t["v"], t["do"], out, lse, mm, *halo)
    grads = emulated_dkv(t["q"], t["k"], t["v"], t["do"], out, lse, mm, *halo)
    return {"out": out, "lse": lse, "dq": dq,
            **dict(zip(("dk", "dv", "dk_halo", "dv_halo"), grads))}


def _misses(got: dict, want: dict) -> dict:
    """Each output's largest error over its bar (above 1 misses): ``out``
    and ``lse`` at 1e-4 absolute plus 1e-4 relative; the gradients at 1e-4
    of their largest magnitude plus 1e-4 relative, and their RMS error over
    1e-4 of their RMS."""
    ratios = {}
    for name, w in want.items():
        err = (got[name] - w).abs()
        floor = TOL * (w.abs().max() if name not in ("out", "lse") else 1.0)
        ratios[name] = float((err / (floor + TOL * w.abs())).max())
        if name not in ("out", "lse"):
            rms = lambda x: float(x.pow(2).mean().sqrt())
            ratios[name + "_rms"] = rms(got[name] - w) / (TOL * rms(w))
    return ratios


@pytest.mark.parametrize("halo", [False, True])
def test_three_tf32_products_meet_the_f32_bars(halo):
    """K1-fwd, K1-dq and K1-dkv with every product 3xTF32 against JAX's f32
    kernels: every output within the port's f32 bars."""
    t = _inputs(halo)
    ratios = _misses(_emulated(t, mm3), _jax(t))
    assert len(ratios) == (12 if halo else 8)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("halo", [False, True])
def test_one_tf32_product_misses_the_f32_bars(halo):
    """The same with one TF32 product a product: some output misses."""
    t = _inputs(halo)
    ratios = _misses(_emulated(t, mm1), _jax(t))
    assert max(ratios.values()) > 1.0, ratios


def test_the_tf32_rounding_is_cvt_rna():
    """To nearest with ties away from zero, at 10 mantissa bits: 1 + 2^-11
    (a tie) goes up to 1 + 2^-10, as does its negative in magnitude; just
    under a tie goes down; a TF32 value is kept; the split is exact."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -20,
                      1 + 3 * one_ulp, 3.0, 0.0, 1e-30])
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 3 * one_ulp, 3.0, 0.0,
                         float(tf32(torch.tensor([1e-30])))])
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    hi, lo = split(r)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert ((r - hi).abs() <= r.abs() * 2.0 ** -11).all()
    assert ((r - hi - lo).abs() <= r.abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_k1_routes_of_every_shipped_config(name, dtype):
    """Every config but ``default`` (dim_head 32) has dim_head 64 or 128
    and a window that is a multiple of 128, ``default`` dim_head 32 and a
    window of 512: bf16 takes ``wgmma`` for all three kernels, f32
    ``tf32x3`` for all three (at dim_head 32 their own 64-row kernels)."""
    c = CONFIGS[name]
    assert (c.dim_head in (64, 128) and c.window_size % 128 == 0) == (name != "default")
    if name == "default":
        assert c.dim_head == 32 and c.window_size % 128 == 0
    if dtype == torch.bfloat16:
        want = ("wgmma", "wgmma", "wgmma")
    else:
        want = ("tf32x3", "tf32x3", "tf32x3")
    got = tuple(route(dtype, c.dim_head, c.window_size) for route in (
        cuda_attention.fwd_route, cuda_attention.dq_route, cuda_attention.dkv_route))
    assert got == want


def _visible(n, wsz, halo):
    """(query, key) visibility, keys in extended coordinates (key e is
    position e - wsz): the query's own window up to it and all of the
    previous one (window 0's: the halo, or the phantom, which K1-dq does
    not walk)."""
    i = np.arange(n)[:, None]
    e = np.arange(n + wsz)[None, :]
    seen = (e - wsz <= i) & (e - wsz >= (i // wsz - 1) * wsz)
    return seen & ((e >= wsz) | halo)


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("n,wsz", [(256, 128), (1024, 256), (1024, 512), (2048, 512)])
def test_k1_dq_f32_walk_covers_each_visible_pair_once(n, wsz, halo):
    """K1-dq's tf32x3 walk: 32-key tiles from the previous window's first
    (the halo's, at t0 < 0) to the block's last row, met by eight warps of
    16 rows; the diagonal tiles masked, it sees every visible (query, key)
    pair once and no other, and its blocks are K1-fwd's (launched longest
    walk first)."""
    tile, rows = cuda_attention.TF32X3_BWD_TILE, cuda_attention.TF32X3_WARP_ROWS
    seen = np.zeros((n, n + wsz), dtype=int)  # [query, extended key]
    q_idx = np.arange(rows)[:, None]
    k_idx = np.arange(tile)[None, :]
    walk = cuda_attention.k1_bwd_tiles(n, wsz, "dq", halo=halo, tile=tile, rows=rows)
    for r0, t0, kind in walk:
        assert (-wsz if halo else 0) <= t0 and t0 + tile <= n and r0 + rows <= n
        if kind == "skipped":
            assert t0 > r0 + rows - 1
            continue
        mask = np.ones((rows, tile), dtype=int)
        if kind == "diagonal":
            mask = (t0 + k_idx <= r0 + q_idx).astype(int)
        else:
            assert t0 + tile <= r0
        seen[r0:r0 + rows, wsz + t0:wsz + t0 + tile] += mask
    assert seen.max() == 1
    assert (seen.astype(bool) == _visible(n, wsz, halo)).all()
    blocks = sorted({r0 - r0 % 128 for r0, _, _ in walk})
    assert blocks == sorted(b0 for b0, _ in cuda_attention.k1_fwd_tiles(n, wsz, halo))
    assert len(walk) % (128 // rows) == 0  # all eight warps of a block meet every tile


# -- K1-fwd and K1-dkv at dim_head 32 (ProGen-default) on "tf32x3" ------------

N32, WSZ32, D32 = 256, 128, 32   # 2 windows of 128, dim_head 32
LOG2E = 1.4426950408889634
D32_FWD = dict(block=cuda_attention.D32_ROWS, rows=cuda_attention.TF32X3_WARP_ROWS,
               tile=cuda_attention.D32_KEYS)
D32_DKV = dict(block=cuda_attention.D32_ROWS, rows=cuda_attention.TF32X3_WARP_ROWS,
               tile=cuda_attention.TF32X3_BWD_TILE)


def _rows_of(t, halo, r0, rows):
    """Rows ``[r0, r0 + rows)`` of k or v in extended coordinates: from the
    halo where ``r0 < 0``."""
    return halo[:, :, halo.shape[2] + r0:halo.shape[2] + r0 + rows] if r0 < 0 \
        else t[:, :, r0:r0 + rows]


def emulated_fwd_d32(q, k, v, wsz, k_halo=None, v_halo=None):
    """The dim_head-32 K1-fwd as it walks (``k1_fwd_tiles`` with the D-32
    blocks): per warp of 16 rows and per 64-key tile in walk order, s = q.k^T
    through ``mm3`` (q's split is the same every tile, held or not), the
    diagonal tile masked, the online softmax in log2 units, o += p.v through
    ``mm3``; the phantom window's wsz zero logits added at the end."""
    b, h, n, d = q.shape
    scale2 = d ** -0.5 * LOG2E
    halo = k_halo is not None
    out, lse = torch.empty_like(q), torch.empty(b, h, n)
    for b0, walk in cuda_attention.k1_fwd_tiles(n, wsz, halo, **D32_FWD):
        for r0 in range(b0, b0 + D32_FWD["block"], D32_FWD["rows"]):
            rows = D32_FWD["rows"]
            phantom = b0 < wsz and not halo
            mx = torch.full((b, h, rows, 1), 0.0 if phantom else -1e30)
            den = torch.zeros(b, h, rows, 1)
            acc = torch.zeros(b, h, rows, d)
            for r, t0, kind in walk:
                if r != r0 or kind == "skipped":
                    continue
                tile = D32_FWD["tile"]
                s = mm3(q[:, :, r0:r0 + rows], _rows_of(k, k_halo, t0, tile).transpose(-1, -2))
                s = s * scale2
                if kind == "diagonal":
                    seen = (t0 + torch.arange(tile))[None, :] <= (r0 + torch.arange(rows))[:, None]
                    s = s.masked_fill(~seen, -float("inf"))
                top = torch.maximum(mx, s.amax(-1, keepdim=True))
                alpha = torch.exp2(mx - top)
                mx = top
                p = torch.exp2(s - mx)
                den = den * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + mm3(p, _rows_of(v, v_halo, t0, tile))
            if phantom:
                den = den + wsz * torch.exp2(-mx)
            out[:, :, r0:r0 + rows] = acc / den
            lse[:, :, r0:r0 + rows] = (mx * np.log(2.0) + torch.log(den))[..., 0]
    return out, lse


def emulated_dkv_d32(q, k, v, do, out, lse, wsz, k_halo=None, v_halo=None):
    """The dim_head-32 K1-dkv as it walks (``k1_bwd_tiles(side="dkv")``
    with the D-32 blocks): per warp of 16 keys and per 32-query tile in
    walk order, s^T = k.q^T and dp^T = v.dout^T through ``mm3``, p^T and
    ds^T with the diagonal tiles masked, dv += p^T.dout and dk += ds^T.q
    through ``mm3``; dk scaled once.  ``(dk, dv)``, with a halo also
    ``(dk_halo, dv_halo)``."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    halo = k_halo is not None
    dd = (do * out).sum(-1)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dk_h = torch.zeros_like(k_halo) if halo else None
    dv_h = torch.zeros_like(v_halo) if halo else None
    rows, tile = D32_DKV["rows"], D32_DKV["tile"]
    for r0, i0, kind in cuda_attention.k1_bwd_tiles(
            n, wsz, "dkv", halo, blocks=cuda_attention.k1_dkv_blocks(n, wsz, halo), **D32_DKV):
        if kind == "skipped":
            continue
        kr, vr = _rows_of(k, k_halo, r0, rows), _rows_of(v, v_halo, r0, rows)
        qt, dot = q[:, :, i0:i0 + tile], do[:, :, i0:i0 + tile]
        st = mm3(kr, qt.transpose(-1, -2))
        dpt = mm3(vr, dot.transpose(-1, -2))
        p = torch.exp2(st * (scale * LOG2E) - lse[:, :, None, i0:i0 + tile] * LOG2E)
        if kind == "diagonal" and r0 >= 0:
            user = (i0 + torch.arange(tile))[None, :] >= (r0 + torch.arange(rows))[:, None]
            p = p * user
        ds = p * (dpt - dd[:, :, None, i0:i0 + tile])
        gk, gv = (dk_h, dv_h) if r0 < 0 else (dk, dv)
        at = slice(wsz + r0, wsz + r0 + rows) if r0 < 0 else slice(r0, r0 + rows)
        gv[:, :, at] += mm3(p, dot)
        gk[:, :, at] += mm3(ds, qt)
    grads = (dk * scale, dv)
    return grads + ((dk_h * scale, dv_h) if halo else ())


@pytest.mark.parametrize("halo", [False, True])
def test_the_d32_design_meets_the_f32_bars(halo):
    """K1-fwd and K1-dkv at dim_head 32 as their f32 kernels walk and
    compute, every product 3xTF32, against JAX's f32 kernels and VJP:
    ``out`` and ``lse`` at 1e-4, dk and dv (and the halo's) at the scaled
    bars and their RMS."""
    t = _inputs(halo, seed=32, shape=(B, H, N32, D32), wsz=WSZ32)
    hal = (t["kh"], t["vh"]) if halo else (None, None)
    out, lse = emulated_fwd_d32(t["q"], t["k"], t["v"], WSZ32, *hal)
    grads = emulated_dkv_d32(t["q"], t["k"], t["v"], t["do"], out, lse, WSZ32, *hal)
    want = _jax(t, WSZ32)
    del want["dq"]  # K1-dq at dim_head 32 stays on "wmma"
    got = {"out": out, "lse": lse, **dict(zip(("dk", "dv", "dk_halo", "dv_halo"), grads))}
    ratios = _misses(got, want)
    assert len(ratios) == (10 if halo else 6)
    assert max(ratios.values()) <= 1.0, ratios


def _covered(walk, n, wsz, rows, tile, side):
    """How often each (query, extended key) pair is met by ``walk``'s
    (r0, t0, kind) entries; the diagonal tiles masked as the kernels mask
    them, a skipped tile holding no visible pair."""
    seen = np.zeros((n, n + wsz), dtype=int)
    a, c = np.arange(rows)[:, None], np.arange(tile)[None, :]
    for r0, t0, kind in walk:
        if side == "fwd":   # rows are queries, the tile keys
            query, key = r0 + a + 0 * c, t0 + c + 0 * a
        else:               # rows are keys, the tile queries
            query, key = t0 + c + 0 * a, r0 + a + 0 * c
        visible = key <= query
        if kind == "skipped":
            assert not visible.any()
            continue
        if kind == "full":
            assert visible.all()
        np.add.at(seen, (query[visible], wsz + key[visible]), 1)
    return seen


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("n,wsz", [(256, 128), (1024, 512), (2048, 512)])
def test_the_d32_walks_cover_each_visible_pair_once(n, wsz, halo):
    """K1-fwd's dim_head-32 walk (64-row blocks, four warps of 16, 64-key
    tiles) and K1-dkv's (64-key blocks, four warps of 16 keys, 32-query
    tiles) each meet every visible (query, key) pair once and no other,
    every query row or key row in one block; without a halo both launch
    their blocks longest walk first (with one, window 0's blocks, or the
    halo's, come last, as long as others)."""
    fwd = cuda_attention.k1_fwd_tiles(n, wsz, halo, **D32_FWD)
    lengths = [len(walk) for _, walk in fwd]
    assert halo or lengths == sorted(lengths, reverse=True)
    assert sorted(b0 for b0, _ in fwd) == list(range(0, n, 64))
    walk = [entry for _, w in fwd for entry in w]
    seen = _covered(walk, n, wsz, 16, 64, "fwd")
    assert seen.max() == 1 and (seen.astype(bool) == _visible(n, wsz, halo)).all()

    blocks = cuda_attention.k1_dkv_blocks(n, wsz, halo)
    assert sorted(blocks) == list(range(-wsz if halo else 0, n, 64))
    ends = [wsz if b0 < 0 else min((b0 // wsz + 2) * wsz, n) - b0 for b0 in blocks]
    assert halo or ends == sorted(ends, reverse=True)
    walk = cuda_attention.k1_bwd_tiles(n, wsz, "dkv", halo, blocks=blocks, **D32_DKV)
    assert list(dict.fromkeys(r0 - r0 % 64 for r0, _, _ in walk)) == blocks
    seen = _covered(walk, n, wsz, 16, 32, "dkv")
    assert seen.max() == 1 and (seen.astype(bool) == _visible(n, wsz, halo)).all()


# -- K2: K2-fwd, K2-dgate and K2-dW on "tf32x3" -------------------------------

K2_ROWS = 64        # a 64-row half of a K2-fwd block (a row of four warps)


def emulated_k2_fwd(res, gate, w, bias, mm):
    """K2-fwd as the f32 kernel walks it: per block of
    ``cuda_sgu.k2_fwd_tiles(..., FWD_STEP_TF32X3)`` and per step of each
    64-row half, ``W[rows, k0:k0 + 32] . gate[k0:k0 + 32, channels]``
    through ``mm``, W's entries k > m zeroed on a diagonal step, nothing on
    a skipped one; then ``res * (acc + b)``."""
    batch, n, d = gate.shape
    step = cuda_sgu.FWD_STEP_TF32X3
    rows_pad = -(-n // cuda_sgu.FWD_ROWS) * cuda_sgu.FWD_ROWS
    kpad = rows_pad + step
    wz = torch.zeros(rows_pad, kpad)
    wz[:n, :n] = w
    gz = torch.zeros(batch, kpad, d)
    gz[:, :n] = gate
    acc = torch.zeros(batch, rows_pad, d)
    m_idx = torch.arange(K2_ROWS)[:, None]
    k_idx = torch.arange(step)[None, :]
    for b, _, c0, walk in cuda_sgu.k2_fwd_tiles(batch, n, d, step):
        cols = slice(c0, c0 + cuda_sgu.FWD_COLS)
        for r0, k0, kind in walk:
            if kind == "skipped":
                continue
            tile = wz[r0:r0 + K2_ROWS, k0:k0 + step]
            if kind == "diagonal":
                tile = tile * (k0 + k_idx <= r0 + m_idx)
            else:
                assert k0 + step <= r0
            acc[b, r0:r0 + K2_ROWS, cols] += mm(tile, gz[b, k0:k0 + step, cols])
    return res * (acc[:, :n] + bias)


def emulated_k2_dw(dout, res, gate, mm, sms):
    """K2-dW as the f32 kernel splits it: ``cuda_sgu.dw_split(...,
    "tf32x3")``'s ranges of 32-channel steps, each split's partial
    ``sum_j dmix_j . gate_j^T`` through ``mm`` (``dmix = dout * res``
    rounded to f32 first), the partials summed in split order, the strict
    upper triangle 0."""
    batch, n, d = gate.shape
    step = cuda_sgu.DW_PLAN["tf32x3"][0]
    chunks = -(-d // step)
    splits, ranges = cuda_sgu.dw_split(batch, n, d, sms, "tf32x3")
    dmix = dout * res
    partials = []
    for steps in ranges:
        part = torch.zeros(n, n)
        for j in steps:
            b, c0 = j // chunks, (j % chunks) * step
            part += mm(dmix[b, :, c0:c0 + step], gate[b, :, c0:c0 + step].T)
        partials.append(part)
    total = partials[0]
    for part in partials[1:]:
        total = total + part
    return torch.tril(total), splits


def emulated_k2_dgate(w, dout, res, mm):
    """K2-dgate as the f32 kernel walks it: per block of
    ``cuda_sgu.k2_dgate_tiles`` and per step of each 64-row half,
    ``W[i0:i0 + 32, rows]^T . dmix[i0:i0 + 32, channels]`` through ``mm``
    (``dmix = dout * res`` rounded to f32), W's entries j > i zeroed on a
    diagonal step, nothing on a skipped one."""
    batch, n, d = dout.shape
    step = cuda_sgu.DGATE_STEP
    rows_pad = -(-n // cuda_sgu.DGATE_ROWS) * cuda_sgu.DGATE_ROWS
    ipad = rows_pad + step
    wz = torch.zeros(ipad, rows_pad)
    wz[:n, :n] = w
    dmix = torch.zeros(batch, ipad, d)
    dmix[:, :n] = dout * res
    acc = torch.zeros(batch, rows_pad, d)
    j_idx = torch.arange(K2_ROWS)[:, None]
    i_idx = torch.arange(step)[None, :]
    for b, _, c0, walk in cuda_sgu.k2_dgate_tiles(batch, n, d):
        cols = slice(c0, c0 + cuda_sgu.DGATE_COLS)
        for r0, i0, kind in walk:
            if kind == "skipped":
                continue
            tile = wz[i0:i0 + step, r0:r0 + K2_ROWS].T  # (64 j, 32 i)
            if kind == "diagonal":
                tile = tile * (i0 + i_idx >= r0 + j_idx)
            else:
                assert i0 >= r0 + K2_ROWS
            acc[b, r0:r0 + K2_ROWS, cols] += mm(tile, dmix[b, i0:i0 + step, cols])
    return acc[:, :n]


def _k2_inputs(n: int, d: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = {name: rng.normal(size=(B, n, d)).astype(np.float32)
         for name in ("res", "gate", "dout")}
    t["w"] = rng.normal(0, 0.05, size=(n, n)).astype(np.float32)
    t["b"] = rng.normal(size=(n, 1)).astype(np.float32)
    return {name: torch.from_numpy(x) for name, x in t.items()}


def _k2_jax(t: dict) -> dict:
    """JAX's K2 forward and its VJP's d_gate and dW, the Pallas kernels in
    the interpreter, f32."""
    args = [jnp.asarray(t[name].numpy()) for name in ("res", "gate", "w", "b")]
    f = lambda *a: pallas_spatial_gate(*a, interpret=True)
    out, vjp = jax.vjp(f, *args)
    _, dgate, dw, _ = vjp(jnp.asarray(t["dout"].numpy()))
    return {name: torch.from_numpy(np.array(x, np.float32))
            for name, x in (("out", out), ("dgate", dgate), ("dw", dw))}


def _k2_ratios(got: dict, want: dict) -> dict:
    """Each output's error over its bar (above 1 misses): ``out`` 1e-4
    absolute plus 1e-4 relative; ``dw`` 1e-4 of its largest magnitude plus
    1e-4 relative, and its RMS error over 1e-4 of its RMS."""
    err = (got["out"] - want["out"]).abs()
    ratios = {"out": float((err / (TOL + TOL * want["out"].abs())).max())}
    w = want["dw"]
    err = (got["dw"] - w).abs()
    ratios["dw"] = float((err / (TOL * w.abs().max() + TOL * w.abs())).max())
    rms = lambda x: float(x.pow(2).mean().sqrt())
    ratios["dw_rms"] = rms(got["dw"] - w) / (TOL * rms(w))
    return ratios


K2_SHAPES = [(256, 64), (200, 136), (128, 256)]  # (n, d): whole tiles, ragged n and d


@pytest.mark.parametrize("n,d", K2_SHAPES)
def test_k2_three_tf32_products_meet_the_f32_bars(n, d):
    """K2-fwd through its f32 tile walk and K2-dW through its split plan,
    every product 3xTF32, against JAX's f32 kernels: within the bars, and
    at least 10x under one TF32 product's error in each output."""
    t = _k2_inputs(n, d, seed=n + d)
    want = _k2_jax(t)
    got, one = {}, {}
    for mm, into in ((mm3, got), (mm1, one)):
        into["out"] = emulated_k2_fwd(t["res"], t["gate"], t["w"], t["b"], mm)
        into["dw"], splits = emulated_k2_dw(t["dout"], t["res"], t["gate"], mm, sms=4)
    assert splits > 1  # the ordered sum of more than one partial
    ratios = _k2_ratios(got, want)
    assert max(ratios.values()) <= 1.0, ratios
    for name in ("out", "dw"):
        err3 = float((got[name] - want[name]).abs().max())
        err1 = float((one[name] - want[name]).abs().max())
        assert 10 * err3 <= err1, (name, err3, err1)
    assert not torch.triu(got["dw"], 1).any()


def _scaled_ratios(got: torch.Tensor, want: torch.Tensor, name: str) -> dict:
    """A gradient's error over the scaled f32 bar (1e-4 of its largest
    magnitude plus 1e-4 relative) and its RMS error over 1e-4 of its RMS."""
    err = (got - want).abs()
    rms = lambda x: float(x.pow(2).mean().sqrt())
    return {name: float((err / (TOL * want.abs().max() + TOL * want.abs())).max()),
            name + "_rms": rms(got - want) / (TOL * rms(want))}


@pytest.mark.parametrize("n,d", [(100, 520), (1000, 520), (256, 64)])
def test_k2_dgate_three_tf32_products_meet_the_f32_bars(n, d):
    """K2-dgate through its f32 tile walk, every product 3xTF32, against
    the d_gate of JAX's f32 kernels' VJP: within the scaled bars, and at
    least 10x under one TF32 product's error."""
    t = _k2_inputs(n, d, seed=n + d + 1)
    want = _k2_jax(t)["dgate"]
    got = emulated_k2_dgate(t["w"], t["dout"], t["res"], mm3)
    one = emulated_k2_dgate(t["w"], t["dout"], t["res"], mm1)
    ratios = _scaled_ratios(got, want, "dgate")
    assert max(ratios.values()) <= 1.0, ratios
    assert max(_scaled_ratios(one, want, "dgate").values()) > 1.0
    err3, err1 = float((got - want).abs().max()), float((one - want).abs().max())
    assert 10 * err3 <= err1, (err3, err1)


@pytest.mark.parametrize("batch,n,d", [(2, 256, 256), (2, 1000, 256), (3, 100, 520),
                                       (1, 60, 16), (1, 1000, 520), (4, 1024, 2048)])
def test_k2_dgate_f32_walk_covers_the_triangle_once(batch, n, d):
    """At 32-deep steps of positions i each 64-row half's walk meets every
    (64 j, 32 i) tile with some i >= j exactly once, the two per half that
    cross the diagonal masked, none wholly above it (i < j); every step
    reads rows of W inside [j0, n); the blocks run longest walk first."""
    step = cuda_sgu.DGATE_STEP
    blocks = cuda_sgu.k2_dgate_tiles(batch, n, d)
    lengths = [len(walk) for _, _, _, walk in blocks]
    assert lengths == sorted(lengths, reverse=True)
    halves = -(-n // 64)
    want = {(hf, i0 // step): ("diagonal" if i0 < 64 * hf + 64 else "full")
            for hf in range(halves) for i0 in range(0, n, step) if i0 + step > 64 * hf}
    col_tiles = -(-d // 128)
    assert len(blocks) == batch * -(-n // 128) * col_tiles
    for b in range(batch):
        for ct in range(col_tiles):
            got = {}
            for bb, j0, c0, walk in blocks:
                if (bb, c0) != (b, 128 * ct):
                    continue
                for r0, i0, kind in walk:
                    assert j0 <= i0 < n
                    if kind == "skipped":
                        assert i0 + step <= r0
                        continue
                    if r0 >= n:
                        continue
                    key = (r0 // 64, i0 // step)
                    assert key not in got
                    got[key] = kind
            assert got == want


@pytest.mark.parametrize("batch,n,d", [(2, 256, 256), (2, 1000, 256), (3, 100, 520),
                                       (1, 60, 16), (4, 1024, 2048)])
def test_k2_fwd_f32_walk_covers_the_triangle_once(batch, n, d):
    """At 32-deep steps each 64-row half's walk meets every (64 m, 32 k)
    tile of the lower triangle exactly once, the two per half that cross
    the diagonal masked, none above it; the blocks are the bf16 route's, in
    its longest-first order."""
    step = cuda_sgu.FWD_STEP_TF32X3
    blocks = cuda_sgu.k2_fwd_tiles(batch, n, d, step)
    assert [blk[:3] for blk in blocks] == [blk[:3] for blk in cuda_sgu.k2_fwd_tiles(batch, n, d)]
    lengths = [len(walk) for _, _, _, walk in blocks]
    assert lengths == sorted(lengths, reverse=True)
    halves = -(-n // 64)
    want = {(h, k): ("diagonal" if 64 * h <= step * k < 64 * h + 64 else "full")
            for h in range(halves) for k in range(-(-min(64 * h + 64, n) // step))}
    col_tiles = -(-d // 128)
    for b in range(batch):
        for ct in range(col_tiles):
            got = {}
            for bb, m0, c0, walk in blocks:
                if (bb, c0) != (b, 128 * ct):
                    continue
                for r0, k0, kind in walk:
                    assert 0 <= k0 < n
                    if kind == "skipped" or r0 >= n:
                        continue
                    key = (r0 // 64, k0 // step)
                    assert key not in got
                    got[key] = kind
            assert got == want


@pytest.mark.parametrize("batch,d", [(1, 8), (1, 520), (8, 2048), (2, 8192)])
@pytest.mark.parametrize("n", [100, 1000, 1024, 4096])
@pytest.mark.parametrize("sms", [1, 132])
def test_k2_dw_f32_split_covers_the_reduction_axis_once(batch, d, n, sms):
    """f32 K2-dW's plan: 32-channel steps, every (batch row, channel) pair
    in exactly one split, no split empty, and the blocks at two an SM in
    one wave where the axis is long enough."""
    step, per_sm = cuda_sgu.DW_PLAN["tf32x3"]
    splits, ranges = cuda_sgu.dw_split(batch, n, d, sms, "tf32x3")
    chunks = -(-d // step)
    seen = np.zeros((batch, chunks * step), dtype=int)
    for steps in ranges:
        assert len(steps) > 0
        for j in steps:
            c0 = (j % chunks) * step
            seen[j // chunks, c0:c0 + step] += 1
    assert (seen == 1).all() and splits == len(ranges)
    side = -(-n // cuda_sgu.DW_TILE)
    tiles = side * (side + 1) // 2
    assert tiles * splits <= max(per_sm * sms, tiles)
    assert splits == min(batch * chunks, max(1, per_sm * sms // tiles))


def test_k2_dw_f32_plan_at_progen_small():
    """B 8, n 1024, d 2048 on 132 SMs: 512 steps of 32 channels in 7
    splits, 252 blocks (two an SM), a 16.5 MB workspace."""
    splits, ranges = cuda_sgu.dw_split(8, 1024, 2048, 132, "tf32x3")
    assert splits == 7 and [len(r) for r in ranges] == [73, 73, 73, 73, 73, 73, 74]
    assert 36 * splits == 252
    assert cuda_sgu.dw_workspace_numel(1024, splits) * 4 == 16_515_072


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (torch.float32, ("tf32x3", "tf32x3", "tf32x3")),
])
def test_the_k2_routes_of_each_dtype(dtype, want):
    """K2-fwd, K2-dgate and K2-dW: bf16 on ``wgmma``; f32 on ``tf32x3``;
    each route its own C entry."""
    got = (cuda_sgu.fwd_route(dtype), cuda_sgu.dgate_route(dtype), cuda_sgu.dw_route(dtype))
    assert got == want
    for counter, route in zip((cuda_sgu.fwd_route_launches, cuda_sgu.dgate_route_launches,
                               cuda_sgu.dw_route_launches), got):
        assert route in counter and route in cuda_sgu.SUFFIX
