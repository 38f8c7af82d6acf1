#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of progen-tpu (``progen_tpu_torch``) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without its last line:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: the hand-written CUDA kernels, built from ``kernels/csrc`` by nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   ProGen-small shapes, with CUDA-event times of the kernel, the plain
   version and one PyTorch library call computing the same function;
4. main path: ProGen-small (weights drawn from a seed, bf16 compute) serves
   four primes through the chunked sampler (one parallel prefill through the
   kernels, then cached decode steps); the kernels' launch counts over that
   run, prefill logits through the kernels against the plain versions, the
   cached decode step against the parallel forward in f32, and the bf16
   decode against the f32 answer beside the bf16 forward;
5. the ``kernels`` line; then the card's ``nvidia-smi`` name and power limit
   and, last, ``{"ok": true, "device": {...}}``.

There is no CPU fallback: without CUDA the script fails.  It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from progen_tpu_torch import kernels
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tokenizer import encode_tokens
from progen_tpu_torch.decode.prefill import pad_prime_length
from progen_tpu_torch.decode.sampler import (
    make_chunked_sampler,
    teacher_forced_logits,
)
from progen_tpu_torch.models.configs import SMALL
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.ops.local_attention import (
    concat_previous_window,
    local_attention,
    window_mask,
)
from progen_tpu_torch.ops.sgu import gated_mix

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Tolerances, as atol = rtol.  One kernel: f32 differs from the plain
# version only in summation order (up to 1024 products per sum).  In bf16
# the outputs round to bf16 in different places (K1 rounds unnormalised
# probabilities, the plain version normalised ones).  K2's outputs are O(1)
# and are held at the JAX package's bf16 bar (tests/test_pallas_attention.py);
# K1's are an average of ~384 values, typically ~0.08, so its bf16 ``out``
# is held at 1e-2, a few bf16 ulps of its largest outputs.  Whole-model
# logits after 12 layers: f32 at 1e-3; bf16 at twice the one-kernel bar,
# since every layer adds its own bf16 rounding differences to the residual
# stream.
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
TOL_ATTN_OUT = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_MODEL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
# How much farther from the f32 answer the bf16 decode may be than the bf16
# parallel forward (two paths with equal bf16 rounding sit at a ratio ~1).
DECODE_VS_FORWARD_RATIO = 1.5
SEED = 0
PRIME_LENGTHS = (37, 200, 300, 511)
SAMPLES_PER_PRIME = 2
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """Max abs/rel error and whether ``|got - want| <= tol + tol*|want|``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return {
        "max_abs_err": float(diff.max()),
        "max_rel_err": float((diff / want.abs().clamp_min(1e-6)).max()),
        "tol": tol,
        "ok": bool((diff <= tol + tol * want.abs()).all()),
    }


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels against their plain versions ----------------------------


def attention_case(gen, b, h, n, d, wsz, dtype):
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    torch.cuda.synchronize()
    ref_out, ref_lse = local_attention(q, k, v, window_size=wsz,
                                       return_lse=True)
    res_out = compare(out, ref_out, TOL_ATTN_OUT[dtype])
    res_lse = compare(lse, ref_lse, TOL[torch.float32])
    fields = {"shape": [b, h, n, d], "window": wsz, "dtype": str(dtype),
              "out": res_out, "lse": res_lse}
    emit("kernel_check", kernel="local_attention_fwd", **fields)
    require(res_out["ok"] and res_lse["ok"],
            f"local_attention_fwd disagrees with its plain version: {fields}")
    return (q, k, v), max(res_out["max_abs_err"], res_lse["max_abs_err"])


def sgu_case(gen, b, n, d, weights, dtype):
    res, gate = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                 for _ in range(2))
    if weights == "init":  # the model's init scale U(+-1e-3/n): mix ~ bias
        w = (torch.rand(n, n, device="cuda", generator=gen) * 2 - 1) * (1e-3 / n)
    else:  # N(0, 0.05): a mix far from the bias
        w = torch.randn(n, n, device="cuda", generator=gen) * 0.05
    w = w.to(dtype)
    bias = torch.ones(n, 1, device="cuda", dtype=dtype)
    out = cuda_sgu.spatial_gate_fwd(res, gate, w, bias)
    torch.cuda.synchronize()
    result = compare(out, gated_mix(res, gate, w, bias), TOL[dtype])
    fields = {"shape": [b, n, d], "weights": weights, "dtype": str(dtype),
              "out": result}
    emit("kernel_check", kernel="sgu_fwd", **fields)
    require(result["ok"], f"sgu_fwd disagrees with its plain version: {fields}")
    return (res, gate, w, bias), result["max_abs_err"]


def check_kernels() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    c = SMALL
    d, h, wsz = c.dim_head, c.heads, c.window_size
    rows = []

    # K1: ProGen-small prefill of four full-length rows, the single-window
    # phantom case, and the largest prefill the main path runs (B=2, L=512)
    errs = []
    timed = None
    for dtype in (torch.bfloat16, torch.float32):
        inputs, err = attention_case(gen, 4, h, c.seq_len, d, wsz, dtype)
        if dtype == torch.bfloat16:
            timed, timed_err = inputs, err
        errs.append(err)
        errs.append(attention_case(gen, 4, h, wsz, d, wsz, dtype)[1])
        errs.append(attention_case(gen, SAMPLES_PER_PRIME, h, 2 * wsz, d, wsz,
                                   dtype)[1])
    q, k, v = timed
    b, _, n, _ = q.shape
    w = n // wsz
    qw = q.reshape(b, h * w, wsz, d)
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d)).reshape(b, h * w, 2 * wsz, d)
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d)).reshape(b, h * w, 2 * wsz, d)
    mask = window_mask(wsz, q.device)
    ms = time_ms(lambda: cuda_attention.local_attention_fwd(q, k, v, wsz))
    plain_ms = time_ms(lambda: local_attention(q, k, v, window_size=wsz,
                                               return_lse=True))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qw, kw, vw, attn_mask=mask, scale=d ** -0.5))
    esize = q.element_size()
    visible = sum(wsz + (i % wsz) + 1 for i in range(n))  # keys per (b, h)
    flops = 4.0 * d * visible * b * h
    nbytes = 4.0 * b * h * n * d * esize + 4.0 * b * h * n
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    rows.append({
        "name": "local_attention_fwd", "route": "cuda",
        "source": "progen_tpu_torch/kernels/csrc/local_attention_fwd.cu",
        "replaces": "progen_tpu/ops/pallas_attention.py:65",
        "launches": None, "max_abs_err": timed_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "timed_shape": [b, h, n, d], "timed_dtype": str(q.dtype),
        "max_abs_err_all_checks": max(errs),
    })
    emit("kernel_time", **rows[-1])

    # K2: ProGen-small gMLP layer (n = seq_len, d = hidden/2) at the init
    # scale and at N(0, 0.05), a ragged n, and the main path's largest prefill
    half = c.dim * c.ff_mult // 2
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        errs.append(sgu_case(gen, 4, c.seq_len, half, "init", dtype)[1])
        inputs, err = sgu_case(gen, 4, c.seq_len, half, "normal", dtype)
        if dtype == torch.bfloat16:
            timed, timed_err = inputs, err
        errs.append(err)
        errs.append(sgu_case(gen, 4, 1000, half, "normal", dtype)[1])
        errs.append(sgu_case(gen, SAMPLES_PER_PRIME, 2 * wsz, half, "normal",
                             dtype)[1])
    res, gate, wts, bias = timed
    b, n, dd = gate.shape
    ms = time_ms(lambda: cuda_sgu.spatial_gate_fwd(res, gate, wts, bias))
    plain_ms = time_ms(lambda: gated_mix(res, gate, wts, bias))
    library_ms = time_ms(
        lambda: res * (torch.matmul(torch.tril(wts), gate) + bias).to(res.dtype))
    esize = gate.element_size()
    tri = n * (n + 1) / 2
    flops = 2.0 * b * dd * tri + 2.0 * b * n * dd
    nbytes = (3.0 * b * n * dd + tri + n) * esize
    bound_ms, bound_by = bound(nbytes, flops, gate.dtype)
    rows.append({
        "name": "sgu_fwd", "route": "cuda",
        "source": "progen_tpu_torch/kernels/csrc/sgu_fwd.cu",
        "replaces": "progen_tpu/ops/pallas_sgu.py:128",
        "launches": None, "max_abs_err": timed_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "timed_shape": [b, n, dd], "timed_dtype": str(gate.dtype),
        "max_abs_err_all_checks": max(errs),
    })
    emit("kernel_time", **rows[-1])
    return rows


# -- phase 4: the main path ---------------------------------------------------


def plain_versions():
    """Patch each kernel wrapper to its plain version (the reference run)."""
    def attention(q, k, v, window_size, scale=None):
        return local_attention(q, k, v, window_size=window_size, scale=scale,
                               return_lse=True)
    return (mock.patch.object(cuda_attention, "local_attention_fwd", attention),
            mock.patch.object(cuda_sgu, "spatial_gate_fwd", gated_mix))


def serve(model) -> dict:
    """Answer the primes through the chunked sampler; returns what was run.
    The launch counts are set to 0 just before and read just after."""
    c = model.config
    rng = np.random.default_rng(SEED)
    primes = ["".join(rng.choice(list(AMINO), size=p)) for p in PRIME_LENGTHS]
    sampler = make_chunked_sampler(model, chunk_size=64)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    prefill_s = []
    steps = [0]
    prefill, step = sampler.prefill, sampler.step

    def timed_prefill(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return out

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    sampler.prefill, sampler.step = timed_prefill, counted_step
    answers = []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_attention.launches = 0
    cuda_sgu.launches = 0
    t0 = time.perf_counter()
    for text in primes:
        tokens = torch.tensor([encode_tokens(text)] * SAMPLES_PER_PRIME,
                              device="cuda")
        before = cuda_attention.launches, cuda_sgu.launches
        seq = sampler(tokens, c.seq_len, generator=gen, top_k=25,
                      add_bos=True, temperature=1.0)
        answers.append((text, seq, sampler.last_num_chunks,
                        [cuda_attention.launches - before[0],
                         cuda_sgu.launches - before[1]]))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"local_attention_fwd": cuda_attention.launches,
                "sgu_fwd": cuda_sgu.launches}
    peak = torch.cuda.max_memory_allocated()

    for (text, seq, chunks, per_prefill), secs in zip(answers, prefill_s):
        p = len(text) + 1  # + BOS
        require(tuple(seq.shape) == (SAMPLES_PER_PRIME, c.seq_len),
                f"sample shape {tuple(seq.shape)}")
        require(bool(((seq >= 0) & (seq < c.num_tokens)).all()),
                "sampled token out of the vocabulary")
        want = torch.tensor(encode_tokens(text), device="cuda")
        require(bool((seq[:, 1:p] == want).all()), "prime not kept in the sample")
        require(per_prefill == [c.depth, c.global_mlp_depth],
                f"one prefill launched the kernels {per_prefill} times")
        emit("answer", prime_len=len(text), launches=per_prefill,
             p_pad=pad_prime_length(p, c.window_size, c.seq_len),
             chunks=chunks, prefill_ms=secs * 1e3,
             sample=[int(t) for t in seq[0, p:p + 16]])
    prefills = len(primes)
    want = {"local_attention_fwd": c.depth * prefills,
            "sgu_fwd": c.global_mlp_depth * prefills}
    require(launches == want, f"kernel launches {launches}, want {want}")
    decode_s = total_s - sum(prefill_s)
    tokens = steps[0] * SAMPLES_PER_PRIME
    return {"launches": launches, "prefills": prefills,
            "prefill_ms": [s * 1e3 for s in prefill_s],
            "decode_steps": steps[0], "decode_tokens": tokens,
            "decode_tokens_per_s": tokens / decode_s, "total_s": total_s,
            "peak_bytes": peak}


def check_prefill_against_plain(model) -> dict:
    """Prefill last-logits through the kernels vs through the plain
    versions, on the card, at the longest prime's padded length, in the
    model's compute dtype."""
    c = model.config
    rng = np.random.default_rng(SEED + 1)
    p = PRIME_LENGTHS[-1] + 1
    p_pad = pad_prime_length(p, c.window_size, c.seq_len)
    tokens = torch.tensor(rng.integers(1, c.num_tokens, size=(2, p_pad)),
                          device="cuda")
    lengths = torch.tensor([p, p // 2], device="cuda")
    prefill = make_chunked_sampler(model).prefill
    got, _ = prefill(tokens, lengths, decode_len=c.seq_len)
    attn_patch, sgu_patch = plain_versions()
    with attn_patch, sgu_patch:
        want, _ = prefill(tokens, lengths, decode_len=c.seq_len)
    result = compare(got, want, TOL_MODEL[model.policy.compute_dtype])
    result["dtype"] = str(model.policy.compute_dtype)
    result["max_abs_logit"] = float(want.abs().max())
    require(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    require(result["ok"], f"kernel prefill disagrees with plain: {result}")
    return result


def decode_tokens(c) -> torch.Tensor:
    """Two rows of two windows of tokens, for the decode checks."""
    rng = np.random.default_rng(SEED + 2)
    return torch.tensor(rng.integers(1, c.num_tokens, size=(2, 2 * c.window_size)),
                        device="cuda")


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got - want).float()
    return {"max_abs_err": float(diff.abs().max()),
            "rms_err": float(diff.pow(2).mean().sqrt())}


def check_decode_against_forward(model) -> dict:
    """At f32, the cached decode step (plain PyTorch) reproduces the
    parallel forward (through the kernels' f32 path) position by position,
    over two windows at ProGen-small width."""
    tokens = decode_tokens(model.config)
    with torch.no_grad():
        parallel = model(tokens)
    stepped = teacher_forced_logits(model, tokens)
    result = {**errors(stepped, parallel), "tol": TOL_MODEL[torch.float32],
              "tokens": list(tokens.shape),
              "max_abs_logit": float(parallel.abs().max())}
    require(result["max_abs_err"] <= result["tol"],
            f"decode step disagrees with the forward: {result}")
    return result


def check_bf16_decode_against_f32(model, reference) -> dict:
    """The main path's bf16 decode step against the f32 answer.

    The bf16 decode and the bf16 parallel forward round in different places,
    so neither is the other's reference; the f32 parallel forward of the
    same weights (``reference``, checked above against its decode and the
    plain versions) is.  The bf16 decode must stay as close to it as the
    bf16 forward does, within half again, in RMS and in max error."""
    require(all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  reference.parameters())),
            "the f32 reference does not hold the bf16 model's weights")
    tokens = decode_tokens(model.config)
    with torch.no_grad():
        want = reference(tokens)
        parallel = model(tokens)
    stepped = teacher_forced_logits(model, tokens)
    require(bool(torch.isfinite(stepped).all()), "non-finite decode logits")
    fwd, dec = errors(parallel, want), errors(stepped, want)
    result = {"tokens": list(tokens.shape), "dtype": str(model.policy.compute_dtype),
              "forward_vs_f32": fwd, "decode_vs_f32": dec,
              "decode_vs_forward": errors(stepped, parallel),
              "max_ratio": DECODE_VS_FORWARD_RATIO,
              "max_abs_logit": float(want.abs().max())}
    require(all(dec[k] <= DECODE_VS_FORWARD_RATIO * fwd[k] for k in dec),
            f"bf16 decode is farther from the f32 answer than the bf16 forward: {result}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_name_power()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.stdout.strip().splitlines()[-1],
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = kernels.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=built)

    rows = check_kernels()

    model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED).eval()
    served = serve(model)
    emit("main_path", config="small", params=sum(p.numel() for p in model.parameters()),
         **served)
    emit("prefill_vs_plain", **check_prefill_against_plain(model))
    reference = ProGen(SMALL, make_policy(False), device="cuda", seed=SEED).eval()
    emit("prefill_vs_plain", **check_prefill_against_plain(reference))
    emit("decode_vs_forward", **check_decode_against_forward(reference))
    emit("bf16_decode_vs_f32", **check_bf16_decode_against_f32(model, reference))
    del model, reference

    for row in rows:
        row["launches"] = served["launches"][row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
