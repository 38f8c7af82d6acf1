"""K1-dq at ``dim_head`` 32 (ProGen-default: the training CLI's default run
in f32 and ``train --mixed_precision`` in bf16) on its Hopper routes,
checked on the CPU.

The kernels (``local_attention_bwd.cu``'s ``local_attention_dq_d32_*``)
cannot run here, so their arithmetic is emulated in torch as they walk:
K1-fwd's 64-row blocks in launch order (``k1_fwd_tiles``), key tiles (64
keys in bf16, 32 in f32) from the previous window's first (the halo's) to
the block's last row, a tile that reaches past a row group's first row
masked, one wholly after it skipped; per tile s = q.k^T and dp = dout.v^T,
p = 2^(s scale log2 e - lse log2 e), ds = p (dp - D), dq += ds.k, dq scaled
once.  In bf16
(one warpgroup of 64 rows) the operands are bf16 with f32 sums and ds is
rounded to bf16 before ds.k; in f32 (four warps of 16 rows) every product
is three TF32 products (``mm3``: q's and dout's split is the same at every
tile, held or not).  The emulation, given JAX's forward (out and lse), is
held against JAX's Pallas VJP in the interpreter at ProGen-default's head
and window (B 1, H 1, L 1024, window 512), with and without a halo: bf16 at
0.05 and f32 at 1e-5 of dq's largest magnitude plus as much relative, and
its RMS error within the bar of dq's RMS.  The walks meet every visible
(query, key) pair once, each block launched once, longest walk first; the
wrapper picks the routes' entries before a launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from progen_tpu.ops.pallas_attention import _forward_ext, pallas_local_attention_ext
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.ops import cuda_attention
from tests.test_torch_d32_bf16 import bf16
from tests.test_torch_fwd_kernels import _Picked, _pick
from tests.test_torch_tf32x3 import _covered, _rows_of, _visible, mm3

torch.set_num_threads(1)

DEFAULT = CONFIGS["default"]
B, H, N, WSZ, D = 1, 1, DEFAULT.seq_len, DEFAULT.window_size, DEFAULT.dim_head
LOG2E = 1.4426950408889634
BAR = {torch.bfloat16: 0.05, torch.float32: 1e-5}
# rows of a block's row group (bf16 one warpgroup of 64, f32 four warps of
# 16) and keys of a streamed tile
GROUP_ROWS = {torch.bfloat16: cuda_attention.D32_ROWS,
              torch.float32: cuda_attention.TF32X3_WARP_ROWS}
TILE = {torch.bfloat16: cuda_attention.D32_KEYS, torch.float32: cuda_attention.TF32X3_BWD_TILE}


def walk(n: int, wsz: int, halo: bool, dtype) -> list[tuple[int, list]]:
    """K1-dq's blocks at dim_head 32 in launch order and their walks:
    K1-fwd's blocks (``k1_fwd_tiles`` with the D-32 blocks) and the tiles
    of ``dtype``'s kernel."""
    return cuda_attention.k1_fwd_tiles(n, wsz, halo, block=cuda_attention.D32_ROWS,
                                       rows=GROUP_ROWS[dtype], tile=TILE[dtype])


def emulated_dq(q, k, v, do, out, lse, wsz, dtype, k_halo=None, v_halo=None):
    """K1-dq's dim_head-32 kernel of ``dtype`` as it walks: per row group
    and per key tile it meets, s = q.k^T and dp = dout.v^T (bf16: bf16
    operands, f32 sums; f32: ``mm3``), p in log2 units with the diagonal
    tiles masked,
    ds = p (dp - D) in f32, dq += ds.k (bf16: ds rounded to bf16 first;
    f32: ``mm3``); dq scaled once (bf16: rounded to bf16 once)."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    mm = (lambda a, c: a @ c) if dtype == torch.bfloat16 else mm3
    cast = bf16 if dtype == torch.bfloat16 else (lambda x: x)
    dd = (do * out).sum(-1)  # D = rowsum(dout * out) in f32
    rows, tile = GROUP_ROWS[dtype], TILE[dtype]
    dq = torch.zeros_like(q)
    for _, steps in walk(n, wsz, k_halo is not None, dtype):
        for r0, t0, kind in steps:
            if kind == "skipped":
                continue
            kt, vt = _rows_of(k, k_halo, t0, tile), _rows_of(v, v_halo, t0, tile)
            s = mm(q[:, :, r0:r0 + rows], kt.transpose(-1, -2))
            dp = mm(do[:, :, r0:r0 + rows], vt.transpose(-1, -2))
            p = torch.exp2(s * (scale * LOG2E) - lse[:, :, r0:r0 + rows, None] * LOG2E)
            if kind == "diagonal":
                seen = (t0 + torch.arange(tile))[None, :] <= (r0 + torch.arange(rows))[:, None]
                p = p * seen
            ds = p * (dp - dd[:, :, r0:r0 + rows, None])
            dq[:, :, r0:r0 + rows] += mm(cast(ds), kt)
    return cast(dq * scale)


def _inputs(dtype, halo: bool, seed: int) -> dict:
    """q, k, v, dout and the halo's k and v from numpy (bf16: rounded to
    bf16, held in f32)."""
    rng = np.random.default_rng(seed)
    names = ["q", "k", "v", "do"] + (["kh", "vh"] if halo else [])
    shapes = [(B, H, N, D)] * 4 + [(B, H, WSZ, D)] * 2
    cast = bf16 if dtype == torch.bfloat16 else (lambda x: x)
    return {name: cast(torch.from_numpy(rng.normal(size=s).astype(np.float32)))
            for name, s in zip(names, shapes)}


def _jax(t: dict, dtype) -> dict:
    """JAX's forward (out, lse) and dq from the VJP, in the Pallas
    interpreter, on ``[halo or the phantom zeros ‖ k]``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = {name: jnp.asarray(x.numpy(), jdt) for name, x in t.items()}
    zeros = jnp.zeros((B, H, WSZ, D), jdt)
    k_ext = jnp.concatenate([j.get("kh", zeros), j["k"]], axis=2)
    v_ext = jnp.concatenate([j.get("vh", zeros), j["v"]], axis=2)
    _, lse = _forward_ext(j["q"], k_ext, v_ext, WSZ, D ** -0.5, True)
    f = lambda q: pallas_local_attention_ext(q, k_ext, v_ext, WSZ, D ** -0.5, True)
    out, vjp = jax.vjp(f, j["q"])
    dq, = vjp(j["do"])
    return {name: torch.from_numpy(np.array(x, np.float32))
            for name, x in (("out", out), ("lse", lse), ("dq", dq))}


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_d32_dq_design_meets_its_bar(dtype, halo):
    """K1-dq at dim_head 32 as its kernel of ``dtype`` walks and computes,
    from JAX's forward, against JAX's dq: within the bar of dq's largest
    magnitude plus the bar relative, and an RMS error within the bar of
    dq's RMS (bf16 0.05, f32 1e-5).  Prints the share of each bar used."""
    t = _inputs(dtype, halo, seed=25)
    want = _jax(t, dtype)
    hal = (t["kh"], t["vh"]) if halo else (None, None)
    got = emulated_dq(t["q"], t["k"], t["v"], t["do"], want["out"], want["lse"], WSZ, dtype,
                      *hal)
    w, bar = want["dq"], BAR[dtype]
    err = (got - w).abs()
    share = float((err / (bar * float(w.abs().max()) + bar * w.abs())).max())
    rms = lambda x: float(x.pow(2).mean().sqrt())
    rms_share = rms(got - w) / (bar * rms(w))
    print(f"dq {dtype} halo={halo}: {share:.3f} of the bar, {rms_share:.3f} of the RMS bar")
    assert share <= 1.0 and rms_share <= 1.0, (share, rms_share)


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("n,wsz", [(256, 128), (1024, 512), (2048, 512)])
def test_the_d32_dq_walks_cover_each_visible_pair_once(n, wsz, halo):
    """K1-dq's dim_head-32 walk on both routes (64-row blocks of four warps
    and 32-key tiles in f32, of one warpgroup and 64-key tiles in bf16; the
    block's last tile ends at its last row) meets every visible (query,
    key) pair once and no other; each block is launched once and, without a
    halo, longest walk first (with one, window 0's blocks come last, as
    long as the others); the walk is ``k1_bwd_tiles(side="dq")``'s over the
    D-32 blocks in that order."""
    for dtype, rows in GROUP_ROWS.items():
        tile = TILE[dtype]
        blocks = walk(n, wsz, halo, dtype)
        b0s = [b0 for b0, _ in blocks]
        assert sorted(b0s) == list(range(0, n, cuda_attention.D32_ROWS))
        lengths = [len(steps) for _, steps in blocks]
        assert halo or lengths == sorted(lengths, reverse=True)
        steps = [entry for _, s in blocks for entry in s]
        for b0, s in blocks:
            assert s[-1][1] == b0 + cuda_attention.D32_ROWS - tile
            assert all(kind == "full" for _, t0, kind in s if t0 < b0)
        assert steps == cuda_attention.k1_bwd_tiles(
            n, wsz, "dq", halo, tile=tile, rows=rows, block=cuda_attention.D32_ROWS,
            blocks=b0s)
        seen = _covered(steps, n, wsz, rows, tile, "fwd")
        assert seen.max() == 1 and (seen.astype(bool) == _visible(n, wsz, halo)).all()


@pytest.mark.parametrize("dtype,name", [
    (torch.bfloat16, "local_attention_bwd_dq_wgmma"),
    (torch.float32, "local_attention_bwd_dq_tf32x3")])
def test_the_d32_dq_wrapper_picks_its_route(monkeypatch, dtype, name):
    """At ProGen-default's head and window a CUDA launch of K1-dq picks its
    Hopper entry (``route="wmma"`` the first kernel's), before any launch
    and any count."""
    monkeypatch.setattr(cuda_attention, "_kernel_fn", _pick)
    with FakeTensorMode():
        q = torch.empty(4, DEFAULT.heads, N, D, device="cuda", dtype=dtype)
        lse = torch.empty(4, DEFAULT.heads, N, device="cuda")
    before = cuda_attention.dq_launches, dict(cuda_attention.dq_route_launches)
    for route, picked in ((None, name), ("wmma", "local_attention_bwd_dq")):
        with pytest.raises(_Picked, match=f"^{picked}$"):
            cuda_attention.local_attention_bwd_dq(q, q, q, q, lse, lse, WSZ, route=route)
    assert (cuda_attention.dq_launches, cuda_attention.dq_route_launches) == before
