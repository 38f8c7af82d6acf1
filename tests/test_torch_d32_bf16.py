"""K1-fwd and K1-dkv in bf16 at ``dim_head`` 32 (ProGen-default: the sample
CLI, which computes in bf16, and ``train --mixed_precision``) on their
Hopper route (``"wgmma"``, ``kernels/csrc/attention_wgmma.cuh``'s ``d32``),
checked on the CPU.

The kernels cannot run here, so their arithmetic is emulated in torch as
they walk: blocks of 64 rows (one warpgroup) in launch order, 64-row tiles
of the other side, bf16 operands with f32 sums, the online softmax in log2
units (``exp2`` with the scale folded in), p rounded to bf16 before p.v;
K1-dkv in one pass, p and ds rounded to bf16 before p^T.dout and ds^T.q,
dk scaled once.  The emulation is held against JAX's Pallas kernels in the
interpreter and their VJP at ProGen-default's head and window (B 1, H 1,
L 1024, window 512), with and without a halo, at the bf16 bar of 0.05.
The walks meet every visible (query, key) pair once, longest walk first
(the routes are pinned for every shipped config and dtype in
``test_torch_tf32x3.py``); and one
``--mixed_precision`` step of the training CLI at ProGen-default (batch 1,
the plain versions on the CPU) gives JAX's bf16 step's loss at 0.05
relative, on the same parameters and rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.ops.pallas_attention import _forward_ext, pallas_local_attention_ext
from progen_tpu.train import make_optimizer as jax_make_optimizer
from progen_tpu.train import make_train_functions as jax_make_train_functions
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.ops import cuda_attention
from progen_tpu_torch.train import cli
from tests.test_torch_tf32x3 import _covered, _rows_of, _visible

torch.set_num_threads(1)

DEFAULT = CONFIGS["default"]
B, H, N, WSZ, D = 1, 1, DEFAULT.seq_len, DEFAULT.window_size, DEFAULT.dim_head
TOL = 0.05                     # the port's bf16 bar on the CPU
LOG2E = 1.4426950408889634
ROWS = cuda_attention.D32_ROWS  # rows of a block, and of a streamed tile
FWD_WALK = dict(block=ROWS, rows=ROWS, tile=cuda_attention.D32_KEYS)
DKV_WALK = dict(block=ROWS, rows=ROWS, tile=cuda_attention.BWD_TILE)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even) and held in f32."""
    return x.to(torch.bfloat16).float()


def emulated_fwd(q, k, v, wsz, k_halo=None, v_halo=None):
    """K1-fwd's bf16 dim_head-32 kernel as it walks (``k1_fwd_tiles`` with
    64-row blocks of one warpgroup): per 64-key tile in walk order s = q.k^T
    (bf16 operands, f32 sums), the diagonal tile masked, the online softmax
    in log2 units, p rounded to bf16 and o += p.v in f32, the denominator
    summed from the unrounded p; the phantom window's wsz zero logits added
    at the end.  ``(out, lse)``: out rounded to bf16 once, lse in f32."""
    b, h, n, d = q.shape
    scale2 = d ** -0.5 * LOG2E
    halo = k_halo is not None
    out, lse = torch.empty(b, h, n, d), torch.empty(b, h, n)
    rows, tile = FWD_WALK["rows"], FWD_WALK["tile"]
    for b0, walk in cuda_attention.k1_fwd_tiles(n, wsz, halo, **FWD_WALK):
        phantom = b0 < wsz and not halo
        mx = torch.full((b, h, rows, 1), 0.0 if phantom else -1e30)
        den = torch.zeros(b, h, rows, 1)
        acc = torch.zeros(b, h, rows, d)
        for r0, t0, kind in walk:
            assert r0 == b0 and kind != "skipped"
            s = q[:, :, b0:b0 + rows] @ _rows_of(k, k_halo, t0, tile).transpose(-1, -2)
            s = s * scale2
            if kind == "diagonal":
                seen = (t0 + torch.arange(tile))[None, :] <= (b0 + torch.arange(rows))[:, None]
                s = s.masked_fill(~seen, -float("inf"))
            top = torch.maximum(mx, s.amax(-1, keepdim=True))
            alpha = torch.exp2(mx - top)
            mx = top
            p = torch.exp2(s - mx)
            den = den * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + bf16(p) @ _rows_of(v, v_halo, t0, tile)
        if phantom:
            den = den + wsz * torch.exp2(-mx)
        out[:, :, b0:b0 + rows] = bf16(acc / den)
        lse[:, :, b0:b0 + rows] = (mx * np.log(2.0) + torch.log(den))[..., 0]
    return out, lse


def emulated_dkv(q, k, v, do, out, lse, wsz, k_halo=None, v_halo=None):
    """K1-dkv's bf16 dim_head-32 kernel as it walks (``k1_bwd_tiles`` over
    ``k1_dkv_blocks``, 64-key blocks of one warpgroup, 64-query tiles), in
    one pass: s^T = k.q^T and dp^T = v.dout^T (bf16 operands, f32 sums),
    p^T = 2^(s^T scale log2 e - lse log2 e) with the diagonal tile masked,
    ds^T = p^T (dp^T - D) in f32, then dv += bf16(p^T).dout and
    dk += bf16(ds^T).q; dk scaled once, both rounded to bf16 once.
    ``(dk, dv)``, with a halo also ``(dk_halo, dv_halo)``."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    halo = k_halo is not None
    dd = (do * out).sum(-1)  # D = rowsum(dout * out) in f32, from the bf16 out
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dk_h = torch.zeros_like(k_halo) if halo else None
    dv_h = torch.zeros_like(v_halo) if halo else None
    rows, tile = DKV_WALK["rows"], DKV_WALK["tile"]
    for r0, i0, kind in cuda_attention.k1_bwd_tiles(
            n, wsz, "dkv", halo, blocks=cuda_attention.k1_dkv_blocks(n, wsz, halo),
            **DKV_WALK):
        assert kind != "skipped"
        kr, vr = _rows_of(k, k_halo, r0, rows), _rows_of(v, v_halo, r0, rows)
        qt, dot = q[:, :, i0:i0 + tile], do[:, :, i0:i0 + tile]
        st, dpt = kr @ qt.transpose(-1, -2), vr @ dot.transpose(-1, -2)
        p = torch.exp2(st * (scale * LOG2E) - lse[:, :, None, i0:i0 + tile] * LOG2E)
        if kind == "diagonal":
            assert r0 == i0
            user = (i0 + torch.arange(tile))[None, :] >= (r0 + torch.arange(rows))[:, None]
            p = p * user
        ds = p * (dpt - dd[:, :, None, i0:i0 + tile])
        gk, gv = (dk_h, dv_h) if r0 < 0 else (dk, dv)
        at = slice(wsz + r0, wsz + r0 + rows) if r0 < 0 else slice(r0, r0 + rows)
        gv[:, :, at] += bf16(p) @ dot
        gk[:, :, at] += bf16(ds) @ qt
    grads = (bf16(dk * scale), bf16(dv))
    return grads + ((bf16(dk_h * scale), bf16(dv_h)) if halo else ())


def _inputs(halo: bool, seed: int) -> dict:
    """bf16 values (held in f32) of q, k, v, dout and the halo's k and v."""
    rng = np.random.default_rng(seed)
    names = ["q", "k", "v", "do"] + (["kh", "vh"] if halo else [])
    shapes = [(B, H, N, D)] * 4 + [(B, H, WSZ, D)] * 2
    return {name: bf16(torch.from_numpy(rng.normal(size=s).astype(np.float32)))
            for name, s in zip(names, shapes)}


def _jax(t: dict) -> dict:
    """JAX's bf16 forward (out, lse) and VJP (dk, dv and the halo's) in the
    Pallas interpreter, on ``[halo or the phantom zeros ‖ k]``."""
    j = {name: jnp.asarray(x.numpy(), jnp.bfloat16) for name, x in t.items()}
    zeros = jnp.zeros((B, H, WSZ, D), jnp.bfloat16)
    k_ext = jnp.concatenate([j.get("kh", zeros), j["k"]], axis=2)
    v_ext = jnp.concatenate([j.get("vh", zeros), j["v"]], axis=2)
    _, lse = _forward_ext(j["q"], k_ext, v_ext, WSZ, D ** -0.5, True)
    f = lambda q, ke, ve: pallas_local_attention_ext(q, ke, ve, WSZ, D ** -0.5, True)
    out, vjp = jax.vjp(f, j["q"], k_ext, v_ext)
    _, dk_ext, dv_ext = vjp(j["do"])
    got = {"out": out, "lse": lse, "dk": dk_ext[:, :, WSZ:], "dv": dv_ext[:, :, WSZ:]}
    if "kh" in j:
        got.update(dk_halo=dk_ext[:, :, :WSZ], dv_halo=dv_ext[:, :, :WSZ])
    return {name: torch.from_numpy(np.array(x, np.float32)) for name, x in got.items()}


@pytest.mark.parametrize("halo", [False, True])
def test_the_bf16_d32_design_meets_the_bf16_bar(halo):
    """K1-fwd and K1-dkv at dim_head 32 as their bf16 kernels walk and
    compute, against JAX's bf16 Pallas kernels and VJP in the interpreter:
    ``out`` and ``lse`` within 0.05 absolute plus 0.05 relative, dk and dv
    (and the halo's) within 0.05 of their largest magnitude plus 0.05
    relative, and their RMS error within 0.05 of their RMS."""
    t = _inputs(halo, seed=24)
    hal = (t["kh"], t["vh"]) if halo else (None, None)
    out, lse = emulated_fwd(t["q"], t["k"], t["v"], WSZ, *hal)
    grads = emulated_dkv(t["q"], t["k"], t["v"], t["do"], out, lse, WSZ, *hal)
    got = {"out": out, "lse": lse, **dict(zip(("dk", "dv", "dk_halo", "dv_halo"), grads))}
    want = _jax(t)
    assert got.keys() == want.keys() and len(got) == (6 if halo else 4)
    for name, w in want.items():
        scale = float(w.abs().max()) if name not in ("out", "lse") else 1.0
        err = (got[name] - w).abs()
        assert bool((err <= TOL * scale + TOL * w.abs()).all()), (name, float(err.max()))
        if name not in ("out", "lse"):
            rms = lambda x: float(x.pow(2).mean().sqrt())
            assert rms(got[name] - w) <= TOL * rms(w), name


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("n,wsz", [(256, 128), (1024, 512), (2048, 512), (1024, 256)])
def test_the_bf16_d32_walks_cover_each_visible_pair_once(n, wsz, halo):
    """K1-fwd's bf16 dim_head-32 walk (64-row blocks of one warpgroup,
    64-key tiles, the diagonal tile last) and K1-dkv's (64-key blocks,
    64-query tiles, the diagonal tile first) each meet every visible
    (query, key) pair once and no other, every row in one block; without a
    halo both launch their blocks longest walk first (with one, window 0's
    blocks, or the halo's, come last)."""
    fwd = cuda_attention.k1_fwd_tiles(n, wsz, halo, **FWD_WALK)
    lengths = [len(walk) for _, walk in fwd]
    assert halo or lengths == sorted(lengths, reverse=True)
    assert sorted(b0 for b0, _ in fwd) == list(range(0, n, ROWS))
    for b0, walk in fwd:
        assert [kind for _, _, kind in walk] == ["full"] * (len(walk) - 1) + ["diagonal"]
        assert walk[-1][1] == b0
    seen = _covered([e for _, w in fwd for e in w], n, wsz, ROWS, ROWS, "fwd")
    assert seen.max() == 1 and (seen.astype(bool) == _visible(n, wsz, halo)).all()

    blocks = cuda_attention.k1_dkv_blocks(n, wsz, halo)
    ends = [wsz if b0 < 0 else min((b0 // wsz + 2) * wsz, n) - b0 for b0 in blocks]
    assert halo or ends == sorted(ends, reverse=True)
    walk = cuda_attention.k1_bwd_tiles(n, wsz, "dkv", halo, blocks=blocks, **DKV_WALK)
    assert list(dict.fromkeys(r0 for r0, _, _ in walk)) == blocks
    for b0 in blocks:
        kinds = [(t0, kind) for r0, t0, kind in walk if r0 == b0]
        assert all(kind == "full" for _, kind in kinds[1:])
        assert kinds[0] == ((0, "full") if b0 < 0 else (b0, "diagonal"))
    seen = _covered(walk, n, wsz, ROWS, ROWS, "dkv")
    assert seen.max() == 1 and (seen.astype(bool) == _visible(n, wsz, halo)).all()


def test_a_mixed_precision_cli_step_gives_jaxs_bf16_loss(monkeypatch, capsys):
    """``python -m progen_tpu_torch.train --mixed_precision --batch_size 1
    --grad_accum_every 1 --max_steps 1`` at ProGen-default on the CPU (the
    plain versions of the kernels), its model holding JAX's initial
    parameters (carried across by ``params_from_flax``), against JAX's bf16
    train step on the same row: the printed loss within 0.05 relative."""
    c = DEFAULT
    j_model = JaxProGen(config=c, policy=jax_policy(True))
    j_fns = jax_make_train_functions(j_model, jax_make_optimizer(),
                                     jnp.zeros((1, c.seq_len), jnp.int32))
    j_state = j_fns.init_state(jax.random.key(3))
    params = params_from_flax(jax.device_get(j_state.params))
    made = cli.ProGen

    def with_jax_params(*args, **kwargs):
        model = made(*args, **kwargs)
        model.load_state_dict(params)
        return model

    monkeypatch.setattr(cli, "ProGen", with_jax_params)
    seed = 5
    records = cli.main(["--mixed_precision", "--batch_size", "1", "--grad_accum_every", "1",
                        "--max_steps", "1", "--log_every", "1", "--wandb_off",
                        "--seed", str(seed), "--device", "cpu"])
    assert capsys.readouterr().out.count('"loss"') == len(records) == 1
    row = synthetic_uniref_batch(np.random.default_rng(seed), 1, c.seq_len)
    _, j_metrics = j_fns.train_step(j_state, jnp.asarray(row))
    want = float(j_metrics["loss"])
    assert np.isfinite(records[0]["loss"])
    assert abs(records[0]["loss"] - want) <= TOL * abs(want), (records[0]["loss"], want)
