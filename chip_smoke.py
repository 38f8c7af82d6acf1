#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of progen-tpu (``progen_tpu_torch``) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without its last line:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: the hand-written CUDA kernels, built from ``kernels/csrc`` by nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   ProGen-small shapes (serving shapes for the forward kernels, training
   shapes for the backward ones), with CUDA-event times of the kernel, the
   plain version and one PyTorch library call computing the same function;
   K1-dq and K1-dkv also at the phantom window alone, ProGen-tiny's head,
   ProGen-base's window, a window of 128 (all on the Hopper "wgmma" route
   in bf16) and on the WMMA route (f32, dim_head 32, a window of 64), each
   run twice for the same bits and held to the route it must take; K2-dgate
   and K2-dW also at batch 1, n = 1000, n = 100 and d = 520, each run twice
   for the same bits;
4. serving path: ProGen-small (weights drawn from a seed, bf16 compute)
   serves four primes through the chunked sampler (one parallel prefill
   through the kernels, then cached decode steps); the kernels' launch
   counts over that run, prefill logits through the kernels against the
   plain versions, the cached decode step against the parallel forward in
   f32, and the bf16 decode against the f32 answer beside the bf16 forward;
5. training path: ProGen-small (bf16 compute, f32 parameters) takes
   optimizer steps on synthetic rows through ``train/step.py``, with every
   kernel's launches per step (every K1 backward launch on the Hopper
   kernels), a finite and falling loss, step time,
   tokens/s, MFU and peak memory; then one f32 step through the kernels
   against the same step through the plain versions (loss and every
   gradient), and the parameters after three steps;
6. paged gate mix: K3 and K3-q8 against their plain versions at the
   engine's shapes (8 rows at ragged positions, partly-NULL tables, garbage
   in the dump page and past each row's position; f32, bf16 and int8 pools,
   int8 weights; a page size that overhangs the weight square);
7. engine path: ProGen-small (bf16) answers 12 requests through the
   continuous-batching ``ServingEngine`` with 8 slots, dense, paged and
   paged with 8-bit pages, then paged again with a pool small enough to
   force pauses and evictions; each run's launch counts (K3 or K3-q8 twice
   per decode step, K1-fwd/K2-fwd 12/2 per admit program), pages returned,
   prefix-cache hits, tokens/s and peak memory; 32 teacher-forced paged
   steps through K3 and K3-q8 against the same steps through the plain
   version; and, in f32 and greedy, the paged engine's tokens against the
   dense engine's;
8. the ``kernels`` line; then the card's ``nvidia-smi`` name and power limit
   and, last, ``{"ok": true, "device": {...}}``.

Every earlier phase runs at the depth and the step count it always had;
the whole takes about four minutes on an H100, the build included.

There is no CPU fallback: without CUDA the script fails.  It imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
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
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.data.tokenizer import encode_tokens
from progen_tpu_torch.decode import incremental
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.prefill import pad_prime_length
from progen_tpu_torch.decode.sampler import (
    make_chunked_sampler,
    teacher_forced_logits,
)
from progen_tpu_torch.models.configs import SMALL
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.ops import cuda_attention, cuda_paged_gate_mix, cuda_sgu
from progen_tpu_torch.ops import paged_gate_mix as plain_paged
from progen_tpu_torch.observe.flops import H100_PEAK_BF16_FLOPS, mfu, model_flops_per_token
from progen_tpu_torch.ops.local_attention import (
    concat_previous_window,
    local_attention,
    local_attention_bwd,
    window_mask,
)
from progen_tpu_torch.ops.quant import quantize_rows, quantize_w
from progen_tpu_torch.ops.sgu import gated_mix, spatial_gate_dgate, spatial_gate_dw
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.step import make_train_functions

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
# The backward kernels' gradients are sums of up to B*d = 16384 terms
# (K2-dW) whose size grows with the shape, so they are held at
# tol * max|plain| + tol * |plain|: an f32 sum of many O(1) terms carries
# an absolute rounding error of its largest partial sums, not of each
# output; bf16 also rounds p, ds and dout * res before the second products
# (a bf16 ulp, 0.4%, in other places than the plain version's einsums).
TOL_GRAD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# That bar alone lets a kernel drop part of its work: one of K2-dW's 256
# channel steps is ~0.06 of its RMS per element, under 2e-2 of the largest
# entry.  So the RMS error is also held at 1e-2 of the plain version's RMS
# in bf16 (both sides round the same bf16 operands; they differ in
# summation order and in a rare bf16 rounding flip) and 1e-4 in f32.
TOL_GRAD_RMS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The f32 train step through the kernels against the plain versions:
# every gradient leaf at 1e-3 of its largest magnitude (12 layers of
# summation-order differences), the loss at 1e-4 relative; after three
# Adam steps each leaf's update (p3 - p0) at 1e-2 of its RMS, and no
# element farther than 6 * lr (a gradient element within rounding of zero
# may take Adam's +-lr step either way).
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_UPDATE_RMS = 1e-2
TRAIN_BATCH = 8
TRAIN_STEPS = 12    # optimizer steps of the training path (accumulation 1)
TRAIN_WARMUP = 2    # steps left out of the median step time
TRAIN_LR = 2e-4
# How much farther from the f32 answer the bf16 decode may be than the bf16
# parallel forward (two paths with equal bf16 rounding sit at a ratio ~1).
DECODE_VS_FORWARD_RATIO = 1.5
# The paged gate mix and its plain version multiply the same f32 values (a
# bf16 or int8 operand widens exactly) and differ only in the order of up to
# 1024 additions: every case, whatever the pool's and the weights' types, is
# held at 1e-5 * (1 + |plain|), the JAX package's bar for its own kernel
# (tests/test_paged.py); 3.1e-6 measured on an H100, on outputs up to 6.5.
TOL_PAGED = 1e-5
PAGED_POS = (0, 15, 16, 300, 511, 777, 1022, 1023)
ENGINE_SLOTS = 8
ENGINE_CHUNK = 32
ENGINE_PAGE = 16
ENGINE_REQUESTS = 12
ENGINE_TIGHT_PAGES = 2 + 96    # pool pages of the tight run, 2 reserved
ENGINE_TOKEN_MATCH = 0.98      # the JAX package's accuracy gate (bench_serving.py)
SPIN_CYCLES = 40_000_000       # ~20 ms of device spin ahead of a timed run
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
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, after warm-up.
    The stream first spins for ~20 ms, so the host has every call enqueued
    before the first one starts: a kernel that runs shorter than the host
    takes to launch it would otherwise be timed at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
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


def close_scaled(got: torch.Tensor, want: torch.Tensor, dtype) -> dict:
    """``compare`` with ``TOL_GRAD * max|want|`` added to the absolute bar,
    and the RMS error held at ``TOL_GRAD_RMS`` of the plain version's RMS."""
    tol = TOL_GRAD[dtype]
    want = want.float()
    scale = float(want.abs().max())
    result = compare(got, want, tol)
    diff = got.float() - want
    rms_want = float(want.pow(2).mean().sqrt())
    rms_err = float(diff.pow(2).mean().sqrt())
    result["ok"] = (bool((diff.abs() <= tol * scale + tol * want.abs()).all())
                    and rms_err <= TOL_GRAD_RMS[dtype] * rms_want)
    result.update(max_abs_want=scale, rms_err=rms_err, rms_want=rms_want,
                  tol_rms=TOL_GRAD_RMS[dtype])
    return result


def real_visible(n: int, wsz: int) -> int:
    """Visible (query, key) pairs per (b, h), the phantom window's left out:
    the backward kernels' work (phantom keys are zeros: nothing to dq, and
    their dk/dv are dropped)."""
    return sum(min(wsz + i % wsz + 1, i + 1) for i in range(n))


def attention_bwd_case(gen, b, h, n, d, wsz, dtype, route):
    """K1-dq and K1-dkv against the plain backward; ``route`` is the one the
    shape must take (``cuda_attention.bwd_route``), and a second run must
    give the same bits (no atomics)."""
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    dd = (do.float() * out.float()).sum(-1)
    before = dict(cuda_attention.bwd_route_launches)
    dq = cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz)
    dk, dv = cuda_attention.local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz)
    torch.cuda.synchronize()
    routed = {r: cuda_attention.bwd_route_launches[r] - before[r] for r in before}
    want = local_attention_bwd(q, k, v, out, lse, do, wsz)
    res = {name: close_scaled(g, w, dtype)
           for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    again = (cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz),
             *cuda_attention.local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz))
    same = all(torch.equal(a, g) for a, g in zip(again, (dq, dk, dv)))
    fields = {"shape": [b, h, n, d], "window": wsz, "dtype": str(dtype),
              "route": cuda_attention.bwd_route(dtype, d, wsz), "want_route": route,
              "launches_by_route": routed, **res, "second_run_same_bits": same}
    emit("kernel_check", kernel="local_attention_bwd", **fields)
    require(all(r["ok"] for r in res.values()) and same
            and routed == {"wgmma": 0, "wmma": 0, route: 2},
            f"local_attention_bwd disagrees with its plain version: {fields}")
    return (q, k, v, do, out, lse, dd), res


def sgu_bwd_case(gen, b, n, d, dtype):
    res, gate, dout = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
    w = (torch.randn(n, n, device="cuda", generator=gen) * 0.05).to(dtype)
    dgate = cuda_sgu.spatial_gate_dgate(w, dout, res)
    dw = cuda_sgu.spatial_gate_dw(dout, res, gate)
    torch.cuda.synchronize()
    checks = {"dgate": close_scaled(dgate, spatial_gate_dgate(w, dout, res), dtype),
              "dw": close_scaled(dw, spatial_gate_dw(dout, res, gate), dtype)}
    upper = int(torch.count_nonzero(torch.triu(dw, 1)))
    # no atomics and a fixed order of every sum: a second run, same bits
    same = (torch.equal(cuda_sgu.spatial_gate_dgate(w, dout, res), dgate)
            and torch.equal(cuda_sgu.spatial_gate_dw(dout, res, gate), dw))
    fields = {"shape": [b, n, d], "dtype": str(dtype), **checks,
              "dw_nonzero_above_diagonal": upper, "second_run_same_bits": same}
    emit("kernel_check", kernel="sgu_bwd", **fields)
    require(checks["dgate"]["ok"] and checks["dw"]["ok"] and upper == 0 and same,
            f"sgu_bwd disagrees with its plain version: {fields}")
    return (res, gate, dout, w), checks


# K1's backward cases (b, h, n, d, wsz): in bf16 the first five take the
# Hopper kernels (the "wgmma" route), the last two the WMMA kernels; f32
# takes the WMMA kernels at the training shape and the phantom window.
K1_BWD_CASES = (
    (TRAIN_BATCH, 8, 1024, 128, 256),   # ProGen-small's training shape
    (2, 8, 256, 128, 256),              # one window: the phantom window only
    (2, 8, 1024, 64, 256),              # ProGen-tiny's head
    (1, 12, 2048, 128, 512),            # ProGen-base's window
    (1, 3, 512, 128, 128),              # the smallest window the route takes
    (2, 3, 1024, 32, 512),              # ProGen-default's head: WMMA
    (2, 8, 1024, 128, 64),              # a window under 128: WMMA
)
K1_BWD_F32_CASES = K1_BWD_CASES[:2]


def check_backward_kernels() -> list[dict]:
    """K1-dq, K1-dkv, K2-dgate and K2-dW against their plain versions, at
    the training path's shapes, the single-window phantom case and other
    configs' heads and windows (K1), a ragged n and d (K2), in bf16 and f32;
    timed in bf16 at the training shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    c = SMALL
    d, h, wsz, b = c.dim_head, c.heads, c.window_size, TRAIN_BATCH
    rows = []

    errs = {"dq": [], "dk": [], "dv": []}
    for dtype, cases in ((torch.bfloat16, K1_BWD_CASES),
                         (torch.float32, K1_BWD_F32_CASES)):
        for case in cases:
            route = ("wgmma" if dtype == torch.bfloat16 and case[4] % 128 == 0
                     and case[3] in (64, 128) else "wmma")
            inputs, res = attention_bwd_case(gen, *case, dtype, route)
            if dtype == torch.bfloat16 and case == K1_BWD_CASES[0]:
                timed, timed_res = inputs, res
            for name in errs:
                errs[name].append(res[name]["max_abs_err"])
    q, k, v, do, out, lse, dd = timed
    n = q.shape[2]
    ms_dq = time_ms(lambda: cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz))
    ms_dkv = time_ms(lambda: cuda_attention.local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz))
    plain_ms = time_ms(lambda: local_attention_bwd(q, k, v, out, lse, do, wsz), iters=5)
    library_ms = sdpa_backward_ms(q, k, v, do, wsz)
    esize = q.element_size()
    pairs = real_visible(n, wsz) * b * h
    vec = b * h * n * d * esize       # one (B, H, L, D) tensor
    rowvec = 4.0 * b * h * n          # one (B, H, L) f32 tensor
    for name, ms, flops, nbytes, line, grads in (
            ("local_attention_bwd_dq", ms_dq, 6.0 * d * pairs, 5 * vec + 2 * rowvec,
             126, ("dq",)),
            ("local_attention_bwd_dkv", ms_dkv, 8.0 * d * pairs, 6 * vec + 2 * rowvec,
             152, ("dk", "dv"))):
        bound_ms, bound_by = bound(nbytes, flops, q.dtype)
        rows.append({
            "name": name, "route": "cuda",
            "bwd_route": cuda_attention.bwd_route(q.dtype, d, wsz),
            "source": "progen_tpu_torch/kernels/csrc/local_attention_bwd.cu",
            "replaces": f"progen_tpu/ops/pallas_attention.py:{line}",
            "launches": None,
            "max_abs_err": max(timed_res[g]["max_abs_err"] for g in grads),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "plain_and_library_compute": "dq, dk and dv in one call",
            "timed_shape": [b, h, n, d], "timed_dtype": str(q.dtype),
            "bytes": nbytes, "flops": flops,
            "max_abs_err_all_checks": max(e for g in grads for e in errs[g]),
        })
        emit("kernel_time", **rows[-1])

    half = c.dim * c.ff_mult // 2
    errs = {"dgate": [], "dw": []}
    # besides the training shape: batch 1, a ragged n, n = 100 (under one
    # tile, W padded to 16-byte rows), d = 520 (a ragged channel step)
    edges = ((1, c.seq_len, half), (b, 1000, half), (3, 100, 520), (2, 1000, 520))
    for dtype in (torch.bfloat16, torch.float32):
        inputs, res = sgu_bwd_case(gen, b, c.seq_len, half, dtype)
        if dtype == torch.bfloat16:
            timed, timed_res = inputs, res
        for name in errs:
            errs[name].append(res[name]["max_abs_err"])
        for shape in edges:
            edge = sgu_bwd_case(gen, *shape, dtype)[1]
            for name in errs:
                errs[name].append(edge[name]["max_abs_err"])
    res, gate, dout, w = timed
    b, n, dd_ = gate.shape
    esize = gate.element_size()
    tri = n * (n + 1) / 2
    flops = 2.0 * b * dd_ * tri + 1.0 * b * n * dd_
    dmix_flat = lambda: (dout * res).transpose(0, 1).reshape(n, b * dd_)
    gate_flat = gate.transpose(0, 1).reshape(n, b * dd_)
    for name, fn, plain, library, nbytes, line in (
            ("sgu_bwd_dgate", lambda: cuda_sgu.spatial_gate_dgate(w, dout, res),
             lambda: spatial_gate_dgate(w, dout, res),
             lambda: torch.matmul(torch.tril(w).T, dout * res),
             (3.0 * b * n * dd_ + tri) * esize, 150),
            ("sgu_bwd_dw", lambda: cuda_sgu.spatial_gate_dw(dout, res, gate),
             lambda: spatial_gate_dw(dout, res, gate),
             lambda: torch.tril(dmix_flat() @ gate_flat.T),
             (3.0 * b * n * dd_ + n * n) * esize, 170)):
        key = name.split("_")[-1]
        bound_ms, bound_by = bound(nbytes, flops, gate.dtype)
        rows.append({
            "name": name, "route": "cuda",
            "source": "progen_tpu_torch/kernels/csrc/sgu_bwd.cu",
            "replaces": f"progen_tpu/ops/pallas_sgu.py:{line}",
            "launches": None, "max_abs_err": timed_res[key]["max_abs_err"],
            "ms": time_ms(fn), "plain_ms": time_ms(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": time_ms(library),
            "timed_shape": [b, n, dd_], "timed_dtype": str(gate.dtype),
            "bytes": nbytes, "flops": flops, "max_abs_err_all_checks": max(errs[key]),
        })
        if key == "dw":  # the split reduction's plan and workspace at this shape
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            splits, _ = cuda_sgu.dw_split(b, n, dd_, sms)
            rows[-1].update(splits=splits, sms=sms,
                            workspace_bytes=4 * cuda_sgu.dw_workspace_numel(n, splits))
        emit("kernel_time", **rows[-1])
    return rows


def sdpa_backward_ms(q, k, v, do, wsz) -> float:
    """One backward of ``scaled_dot_product_attention`` on the masked
    ``[prev ‖ own]`` layout, dq, dk and dv together."""
    b, h, n, d = q.shape
    w = n // wsz
    qw = q.reshape(b, h * w, wsz, d).detach().requires_grad_()
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d)).reshape(
        b, h * w, 2 * wsz, d).detach().requires_grad_()
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d)).reshape(
        b, h * w, 2 * wsz, d).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qw, kw, vw, attn_mask=window_mask(wsz, q.device),
                                         scale=d ** -0.5)
    dow = do.reshape(b, h * w, wsz, d)
    return time_ms(lambda: torch.autograd.grad(out, (qw, kw, vw), dow,
                                               retain_graph=True))


# -- phase 4: the serving path ------------------------------------------------


def plain_versions():
    """Patch each kernel wrapper to its plain version (the reference run)."""
    def attention(q, k, v, window_size, scale=None):
        return local_attention(q, k, v, window_size=window_size, scale=scale,
                               return_lse=True)
    return (mock.patch.object(cuda_attention, "local_attention_fwd", attention),
            mock.patch.object(cuda_sgu, "spatial_gate_fwd", gated_mix))


def plain_backward_versions():
    """Patch each backward kernel wrapper to its plain version."""
    return (mock.patch.object(cuda_attention, "local_attention_bwd", local_attention_bwd),
            mock.patch.object(cuda_sgu, "spatial_gate_dgate", spatial_gate_dgate),
            mock.patch.object(cuda_sgu, "spatial_gate_dw", spatial_gate_dw))


COUNTERS = {
    "local_attention_fwd": (cuda_attention, "launches"),
    "local_attention_bwd_dq": (cuda_attention, "dq_launches"),
    "local_attention_bwd_dkv": (cuda_attention, "dkv_launches"),
    "sgu_fwd": (cuda_sgu, "launches"),
    "sgu_bwd_dgate": (cuda_sgu, "dgate_launches"),
    "sgu_bwd_dw": (cuda_sgu, "dw_launches"),
    "paged_gate_mix": (cuda_paged_gate_mix, "launches"),
    "paged_gate_mix_q8": (cuda_paged_gate_mix, "q8_launches"),
}


def reset_counts() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counts() -> dict[str, int]:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


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
    reset_counts()
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
    launches = read_counts()
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
    want = {name: 0 for name in COUNTERS}
    want.update(local_attention_fwd=c.depth * prefills,
                sgu_fwd=c.global_mlp_depth * prefills)
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


# -- phase 5: the training path -----------------------------------------------


def train_batches(c, batch: int, steps: int, seed: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(synthetic_uniref_batch(rng, batch, c.seq_len)).cuda()
            for _ in range(steps)]


def train(model) -> dict:
    """TRAIN_STEPS optimizer steps of ``model`` on synthetic rows through
    ``train/step.py``; the launch counts are set to 0 just before and read
    just after."""
    c = model.config
    fns = make_train_functions(model.train(), make_optimizer(TRAIN_LR))
    state = fns.init_state()
    batches = train_batches(c, TRAIN_BATCH, TRAIN_STEPS, SEED)
    losses, grad_norms, step_s = [], [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    cuda_attention.bwd_route_launches = {"wgmma": 0, "wmma": 0}
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = fns.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        grad_norms.append(float(metrics["grad_norm"]))
    torch.cuda.synchronize()
    launches = read_counts()
    routes = dict(cuda_attention.bwd_route_launches)
    peak = torch.cuda.max_memory_allocated()

    per_step = {"local_attention_fwd": c.depth, "local_attention_bwd_dq": c.depth,
                "local_attention_bwd_dkv": c.depth, "sgu_fwd": 2 * c.global_mlp_depth,
                "sgu_bwd_dgate": c.global_mlp_depth, "sgu_bwd_dw": c.global_mlp_depth}
    want = {name: per_step.get(name, 0) * TRAIN_STEPS for name in COUNTERS}
    require(launches == want, f"training launches {launches}, want {want}")
    # every K1 backward launch of the bf16 step on the Hopper kernels
    want_routes = {"wgmma": 2 * c.depth * TRAIN_STEPS, "wmma": 0}
    require(routes == want_routes, f"K1 backward routes {routes}, want {want_routes}")
    require(all(np.isfinite(losses)) and all(np.isfinite(grad_norms)),
            f"non-finite training loss or grad norm: {losses}, {grad_norms}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    step_ms = float(np.median(step_s[TRAIN_WARMUP:])) * 1e3
    tokens = TRAIN_BATCH * c.seq_len
    params = sum(p.numel() for p in model.parameters())
    rate = tokens / (step_ms / 1e3)
    return {"launches": launches, "launches_per_step": per_step,
            "k1_bwd_launches_by_route": routes,
            "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq_len": c.seq_len,
            "params": params, "losses": losses, "grad_norms": grad_norms,
            "step_ms_median": step_ms, "step_ms": [s * 1e3 for s in step_s],
            "tokens_per_s": rate,
            "mfu": mfu(rate, model_flops_per_token(c, params)),
            "mfu_peak_flops": H100_PEAK_BF16_FLOPS, "peak_bytes": peak}


def check_train_against_plain() -> dict:
    """At f32, ProGen-small, batch 2: one train step through the kernels
    against the same step through the plain versions (loss and every
    gradient leaf), then each leaf's update after three steps."""
    c = SMALL
    batches = train_batches(c, 2, 3, SEED + 4)
    runs = []
    for plain in (False, True):
        model = ProGen(c, make_policy(False), device="cuda", seed=SEED)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        fns = make_train_functions(model, make_optimizer(TRAIN_LR))
        state = fns.init_state()
        patches = (*plain_versions(), *plain_backward_versions()) if plain else ()
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            losses, grads = [], None
            for batch in batches:
                state, metrics = fns.train_step(state, batch)
                losses.append(float(metrics["loss"]))
                if grads is None:
                    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        updates = {n: p.detach() - p0[n] for n, p in model.named_parameters()}
        runs.append((losses, grads, updates))
        del model, state, fns, p0
    (losses, grads, updates), (want_losses, want_grads, want_updates) = runs

    grad_err = {}
    for name, g in grads.items():
        scale = float(want_grads[name].abs().max())
        grad_err[name] = float((g - want_grads[name]).abs().max()) / max(scale, 1e-30)
    update_err, update_max = {}, 0.0
    for name, u in updates.items():
        diff = u - want_updates[name]
        rms = float(want_updates[name].pow(2).mean().sqrt())
        update_err[name] = float(diff.pow(2).mean().sqrt()) / max(rms, 1e-30)
        update_max = max(update_max, float(diff.abs().max()))
    loss_err = abs(losses[0] - want_losses[0]) / abs(want_losses[0])
    worst_grad = max(grad_err, key=grad_err.get)
    worst_update = max(update_err, key=update_err.get)
    result = {"dtype": "torch.float32", "batch": 2, "steps": 3,
              "losses": losses, "plain_losses": want_losses,
              "loss_rel_err": loss_err, "loss_tol": TOL_TRAIN_LOSS,
              "grad_leaves": len(grad_err), "worst_grad_leaf": worst_grad,
              "worst_grad_rel_err": grad_err[worst_grad], "grad_tol": TOL_TRAIN_GRAD,
              "worst_update_leaf": worst_update,
              "worst_update_rms_rel_err": update_err[worst_update],
              "update_rms_tol": TOL_TRAIN_UPDATE_RMS,
              "update_max_abs_err": update_max, "update_max_tol": 6 * TRAIN_LR}
    require(loss_err <= TOL_TRAIN_LOSS and grad_err[worst_grad] <= TOL_TRAIN_GRAD
            and update_err[worst_update] <= TOL_TRAIN_UPDATE_RMS
            and update_max <= 6 * TRAIN_LR,
            f"the train step through the kernels disagrees with plain: {result}")
    return result

# -- phase 6: the paged gate mix against its plain version --------------------


def paged_case(gen, n, d, ps, pos, pool_dtype) -> dict:
    """A pool of random rows (garbage in the dump page and in every row past
    a request's position; page 0 zeros), tables that name random pages up to
    each row's last page and NULL beyond, and the int8 twins of the weights
    (per row) and of the pool (per pool row)."""
    batch = len(pos)
    ppr = -(-n // ps)
    num_pages = 2 + batch * ppr
    pool = torch.randn(num_pages, ps, d, device="cuda", generator=gen)
    pool[0] = 0.0
    perm = (torch.randperm(num_pages - 2, device="cuda", generator=gen) + 2).int()
    table = torch.zeros(batch, ppr, dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos):
        used = p // ps + 1
        table[b, :used] = perm[b * ppr: b * ppr + used]
    w = torch.randn(n, n, device="cuda", generator=gen) * 0.05
    bias = torch.randn(n, 1, device="cuda", generator=gen)
    wq, ws = quantize_w(w, channel_axis=0)
    pq, pscale = quantize_rows(pool)
    return {"w": w, "bias": bias, "pool": pool.to(pool_dtype), "table": table,
            "pos": torch.tensor(pos, dtype=torch.int32, device="cuda"),
            "wq": wq, "ws": ws, "pq": pq, "pscale": pscale, "n": n, "d": d,
            "ps": ps, "rows_read": sum(p + 1 for p in pos)}


PAGED_VARIANTS = {
    # name -> (weights, pool, w_scale, pool_scale) keys of a paged case
    "f32_w": ("w", "pool", None, None),
    "int8_w_int8_pool": ("wq", "pq", "ws", "pscale"),
    "int8_w_bf16_pool": ("wq", "pool", "ws", None),
    "f32_w_int8_pool": ("w", "pq", None, "pscale"),
}


def paged_args(case: dict, variant: str):
    w, pool, ws, pscale = PAGED_VARIANTS[variant]
    return ((case[w], case["bias"], case[pool], case["table"], case["pos"]),
            {"n_rows": case["n"], "w_scale": case[ws] if ws else None,
             "pool_scale": case[pscale] if pscale else None})


def paged_check(case: dict, variant: str, kernel: str) -> float:
    args, kwargs = paged_args(case, variant)
    got = cuda_paged_gate_mix.paged_gate_mix(*args, **kwargs)
    torch.cuda.synchronize()
    want = plain_paged.paged_gate_mix(*args, **kwargs)
    diff = (got - want).abs()
    ok = bool((diff <= TOL_PAGED * (1 + want.abs())).all())
    fields = {"variant": variant, "pool_dtype": str(args[2].dtype),
              "shape": {"B": len(case["pos"]), "n": case["n"], "d": case["d"],
                        "page_size": case["ps"]},
              "max_abs_err": float(diff.max()), "max_abs_out": float(want.abs().max()),
              "tol": TOL_PAGED, "ok": ok}
    emit("kernel_check", kernel=kernel, **fields)
    require(bool(torch.isfinite(got).all()) and ok,
            f"{kernel} disagrees with its plain version: {fields}")
    return fields["max_abs_err"]


def paged_row(name: str, line: int, case: dict, variant: str, errs: list) -> dict:
    """Times of one variant of the paged gate mix at the engine's shapes,
    beside its bytes bound: the pool rows, weights and scales that THIS
    run's positions make it read, each once, plus the table, the positions,
    the bias entries and the f32 output."""
    args, kwargs = paged_args(case, variant)
    w, bias, pool, table, pos = args
    batch, d, n, rows = len(case["pos"]), case["d"], case["n"], case["rows_read"]
    nbytes = (rows * d * pool.element_size() + rows * w.element_size()
              + table.numel() * 4 + batch * 4 + batch * 4 + batch * d * 4)
    if kwargs["pool_scale"] is not None:
        nbytes += rows * 4
    if kwargs["w_scale"] is not None:
        nbytes += batch * 4
    flops = 2.0 * rows * d
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)  # f32 FMAs

    def library():
        # gather the rows, then one batched product
        dt = torch.float32 if pool.dtype == torch.int8 else pool.dtype
        rows_ = pool[table.long()].reshape(batch, -1, d)[:, :n].to(dt)
        if kwargs["pool_scale"] is not None:
            rows_ = rows_ * kwargs["pool_scale"][table.long()].reshape(batch, -1)[:, :n, None]
        w_rows = w[pos.long()].float()
        if kwargs["w_scale"] is not None:
            w_rows = w_rows * kwargs["w_scale"][pos.long()][:, None]
        w_rows = w_rows * (torch.arange(n, device="cuda")[None, :] <= pos[:, None])
        return torch.bmm(w_rows[:, None, :].to(dt), rows_)[:, 0].float() + bias[pos.long()]

    ms = time_ms(lambda: cuda_paged_gate_mix.paged_gate_mix(*args, **kwargs))
    row = {
        "name": name, "route": "cuda",
        "source": "progen_tpu_torch/kernels/csrc/paged_gate_mix.cu",
        "replaces": f"progen_tpu/ops/pallas_paged_attention.py:{line}",
        "launches": None, "max_abs_err": errs[0], "ms": ms,
        "plain_ms": time_ms(lambda: plain_paged.paged_gate_mix(*args, **kwargs)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library),
        "library": "gather + torch.bmm",
        "timed_shape": {"B": batch, "n": n, "d": d, "page_size": case["ps"],
                        "pos": list(case["pos"].tolist())},
        "timed_dtype": f"weights {w.dtype}, pool {pool.dtype}",
        "bytes": nbytes, "flops": flops, "max_abs_err_all_checks": max(errs),
    }
    emit("kernel_time", **row)
    return row


def check_paged_kernels() -> list[dict]:
    """K3 and K3-q8 against the plain paged gate mix at the engine's shapes
    (ProGen-small: n = seq_len, d = hidden / 2, page 16, 8 rows at ragged
    positions) and at page 24 with n = 1000 (the pages overhang the weight
    square); timed at the engine's shapes with a bf16 pool (K3) and with
    int8 weights and an int8 pool (K3-q8)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    c = SMALL
    half = c.dim * c.ff_mult // 2
    ragged = (0, 23, 24, 300, 511, 777, 998, 999)
    cases = {dt: paged_case(gen, c.seq_len, half, ENGINE_PAGE, PAGED_POS, dt)
             for dt in (torch.bfloat16, torch.float32)}
    overhang = {dt: paged_case(gen, 1000, half, 24, ragged, dt)
                for dt in (torch.bfloat16, torch.float32)}
    k3 = [paged_check(case, "f32_w", "paged_gate_mix")
          for case in (cases[torch.bfloat16], cases[torch.float32],
                       overhang[torch.bfloat16], overhang[torch.float32])]
    q8 = [paged_check(case, variant, "paged_gate_mix_q8")
          for variant in ("int8_w_int8_pool", "int8_w_bf16_pool", "f32_w_int8_pool")
          for case in (cases[torch.bfloat16], overhang[torch.bfloat16])]
    return [paged_row("paged_gate_mix", 54, cases[torch.bfloat16], "f32_w", k3),
            paged_row("paged_gate_mix_q8", 81, cases[torch.bfloat16],
                      "int8_w_int8_pool", q8)]


# -- phase 7: the engine path -------------------------------------------------


def engine_requests(c, greedy: bool = False) -> list[dict]:
    """12 requests from the seed: prime lengths 37-511, ``max_new_tokens``
    64-192, half greedy and half top-k 25 at temperature 1, each its own
    seed.  Requests 8 and 9 share their first 256 residues with requests 0
    and 1 (one long-prime pair each side of the first admission), so the
    paged engine's prefix cache has something to find."""
    rng = np.random.default_rng(SEED + 6)
    out = []
    for i in range(ENGINE_REQUESTS):
        n = int(rng.integers(257, 512)) if i in (0, 1, 8, 9) else int(rng.integers(37, 512))
        tokens = [0] + encode_tokens("".join(rng.choice(list(AMINO), size=n - 1)))
        out.append({"uid": i, "tokens": tokens,
                    "max_new_tokens": int(rng.integers(64, 193)),
                    "top_k": None if i % 2 == 0 else 25,
                    "temperature": 0.0 if (greedy or i % 2 == 0) else 1.0,
                    "seed": 1000 + i})
    for late, early in ((8, 0), (9, 1)):
        out[late]["tokens"][:256] = out[early]["tokens"][:256]
    return out


def run_engine(phase: str, model, requests: list[dict], **engine_kwargs):
    """Answer ``requests`` through a ``ServingEngine`` over ``model``; the
    launch counts are set to 0 just before and read just after.  Checks what
    every engine run must show; returns (tokens by uid, launches, engine)."""
    c = model.config
    engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                           max_len=c.seq_len, page_size=ENGINE_PAGE, **engine_kwargs)
    admits = [0]
    admit = engine._admit

    def counted_admit(*args):
        admits[0] += 1
        return admit(*args)

    engine._admit = counted_admit
    gc.collect()  # an engine holds bound methods of itself: free the last one's state
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(Request(**r))
    done = engine.run_until_idle(max_chunks=400)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    require(sorted(comp.uid for comp in done) == list(range(len(requests))),
            f"{phase}: not every request was answered exactly once")
    require(all(comp.status == "ok" for comp in done),
            f"{phase}: statuses {[comp.status for comp in done]}")
    by_uid = {comp.uid: comp for comp in done}
    for r in requests:
        toks = by_uid[r["uid"]].tokens
        require(1 <= len(toks) <= r["max_new_tokens"]
                and bool(((toks >= 0) & (toks < c.num_tokens)).all()),
                f"{phase}: request {r['uid']} got {len(toks)} tokens")
    steps = engine.chunks_run * ENGINE_CHUNK
    paged = engine_kwargs.get("paged", False)
    q8 = engine_kwargs.get("quantize") == "weights+pages"
    want = {name: 0 for name in COUNTERS}
    want.update(local_attention_fwd=c.depth * admits[0],
                sgu_fwd=c.global_mlp_depth * admits[0])
    if paged:
        want["paged_gate_mix_q8" if q8 else "paged_gate_mix"] = c.global_mlp_depth * steps
    require(launches == want, f"{phase}: kernel launches {launches}, want {want}")
    generated = sum(len(comp.tokens) for comp in done)
    fields = {"config": "small", "dtype": str(model.policy.compute_dtype),
              "requests": len(requests), "slots": ENGINE_SLOTS, "chunk": ENGINE_CHUNK,
              "launches": launches, "admit_programs": admits[0],
              "chunks_run": engine.chunks_run, "decode_steps": steps,
              "generated_tokens": generated, "total_s": total_s,
              "tokens_per_s": generated / total_s,
              "stage_seconds": dict(engine.stage_seconds),
              "finish_reasons": sorted(comp.finish_reason for comp in done),
              "latency_s_median": float(np.median([comp.latency for comp in done])),
              "peak_bytes": peak, **{k: v for k, v in engine_kwargs.items()}}
    if paged:
        cache = engine.cache_status()
        require(cache["free_pages"] + cache["cached_pages"] == cache["capacity"],
                f"{phase}: pages were not all returned: {cache}")
        fields.update(cache=cache, pause_events=engine.pause_events,
                      evictions=engine.evictions)
    require(engine.robustness_counters()["fallback_activations"] == 0,
            f"{phase}: a fallback was activated")
    emit(phase, **fields)
    return {u: comp.tokens.tolist() for u, comp in by_uid.items()}, launches, engine


def token_match(got: dict, want: dict) -> float:
    """Share of ``want``'s tokens that ``got`` has at the same place."""
    same = sum(a == b for u in want for a, b in zip(got[u], want[u]))
    return same / sum(len(v) for v in want.values())


def check_engine_steps_against_plain(model, quantize) -> dict:
    """From one admitted state of the paged engine, 32 teacher-forced decode
    steps through the paged kernel against the same steps with the mix
    swapped for its plain version: every step's logits."""
    c = model.config
    engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                           max_len=c.seq_len, paged=True, page_size=ENGINE_PAGE,
                           quantize=quantize)
    for r in engine_requests(c)[:ENGINE_SLOTS]:
        engine.submit(Request(**r))
    engine._admit_pending()
    engine._ensure_chunk_pages()
    require(not engine._paused.any(), "the full pool paused a slot")
    table = torch.as_tensor(engine._page_table, device="cuda")
    live = torch.ones(ENGINE_SLOTS, dtype=torch.bool, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    forced = torch.tensor(rng.integers(1, c.num_tokens, size=(ENGINE_CHUNK, ENGINE_SLOTS)),
                          device="cuda")
    runs = []
    for plain in (False, True):
        st = engine._working_copy(engine.state)
        patch = (mock.patch.object(incremental, "paged_gate_mix",
                                   plain_paged.paged_gate_mix)
                 if plain else contextlib.nullcontext())
        reset_counts()
        with patch:
            logits = [engine._step_model(forced[j], st["pos"] + j, st["caches"],
                                         table, live)[0] for j in range(ENGINE_CHUNK)]
        counts = read_counts()
        key = "paged_gate_mix_q8" if quantize else "paged_gate_mix"
        require(counts[key] == (0 if plain else c.global_mlp_depth * ENGINE_CHUNK),
                f"engine_vs_plain launched {counts}")
        runs.append(torch.stack(logits))
    got, want = runs
    dtype = model.policy.compute_dtype
    result = compare(got, want, TOL_MODEL[dtype])
    result.update(dtype=str(dtype), quantize=quantize, steps=ENGINE_CHUNK,
                  rows=ENGINE_SLOTS, max_abs_logit=float(want.abs().max()),
                  positions=[int(p) for p in engine.state["pos"]])
    require(bool(torch.isfinite(got).all()), "non-finite engine logits")
    require(result["ok"], f"paged steps through the kernel disagree with plain: {result}")
    return result


def check_paged_engine_against_dense(reference) -> dict:
    """In f32 and greedy, the 12 requests through the paged engine (K3)
    against the dense engine: the only difference is K3's summation order.
    Reports the share of equal tokens and, at the first difference, the
    margin between the two best logits there."""
    c = reference.config
    requests = engine_requests(c, greedy=True)
    dense, _, _ = run_engine("engine_dense_f32", reference, requests)
    paged, _, _ = run_engine("engine_paged_f32", reference, requests, paged=True)
    share = token_match(paged, dense)
    result = {"dtype": "torch.float32", "token_match": share,
              "min_token_match": ENGINE_TOKEN_MATCH, "first_difference": None}
    for r in requests:
        a, b = paged[r["uid"]], dense[r["uid"]]
        at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if at is None:
            continue
        prefix = r["tokens"] + b[:at]
        p_pad = pad_prime_length(len(prefix), c.window_size, c.seq_len)
        tokens = torch.tensor([prefix + [0] * (p_pad - len(prefix))], device="cuda")
        with torch.no_grad():
            top = reference(tokens)[0, len(prefix) - 1].float().topk(2).values
        result["first_difference"] = {
            "uid": r["uid"], "generated_index": at, "paged": a[at], "dense": b[at],
            "top2_logit_margin": float(top[0] - top[1])}
        break
    require(share >= ENGINE_TOKEN_MATCH, f"paged engine vs dense engine: {result}")
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

    rows = check_kernels() + check_backward_kernels() + check_paged_kernels()

    model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED).eval()
    served = serve(model)
    emit("main_path", config="small", params=sum(p.numel() for p in model.parameters()),
         **served)
    emit("prefill_vs_plain", **check_prefill_against_plain(model))
    reference = ProGen(SMALL, make_policy(False), device="cuda", seed=SEED).eval()
    emit("prefill_vs_plain", **check_prefill_against_plain(reference))
    emit("decode_vs_forward", **check_decode_against_forward(reference))
    emit("bf16_decode_vs_f32", **check_bf16_decode_against_f32(model, reference))

    requests = engine_requests(SMALL)
    engine_launches = {}
    _, engine_launches["engine_dense"], _ = run_engine("engine_dense", model, requests)
    full, engine_launches["engine_paged"], engine = run_engine(
        "engine_paged", model, requests, paged=True)
    require(engine.prefix_hits > 0, "the prefix cache found nothing to share")
    _, engine_launches["engine_paged_q8"], engine = run_engine(
        "engine_paged_q8", model, requests, paged=True, quantize="weights+pages")
    require(engine.prefix_hits > 0, "the prefix cache found nothing to share (q8)")
    tight, engine_launches["engine_tight_pool"], engine = run_engine(
        "engine_tight_pool", model, requests, paged=True, num_pages=ENGINE_TIGHT_PAGES)
    require(engine.pause_events > 0 and engine.evictions > 0,
            f"the tight pool did not pause and evict: {engine.pause_events} pauses, "
            f"{engine.evictions} evictions")
    share = token_match(tight, full)
    emit("engine_tight_vs_full", token_match=share, min_token_match=ENGINE_TOKEN_MATCH)
    require(share >= ENGINE_TOKEN_MATCH, "pauses and evictions changed the tokens")
    del engine
    emit("engine_vs_plain", **check_engine_steps_against_plain(model, None))
    emit("engine_vs_plain", **check_engine_steps_against_plain(model, "weights+pages"))
    emit("engine_vs_plain", **check_engine_steps_against_plain(reference, None))
    emit("engine_paged_vs_dense", **check_paged_engine_against_dense(reference))
    del model, reference
    gc.collect()

    model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED)
    trained = train(model)
    emit("train", config="small", dtype="bf16 compute, f32 params", **trained)
    del model
    emit("train_vs_plain", **check_train_against_plain())

    for row in rows:
        by_path = {"serve": served["launches"][row["name"]],
                   "train": trained["launches"][row["name"]],
                   **{phase: counts[row["name"]]
                      for phase, counts in engine_launches.items()}}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
