"""Where the time of the Hopper kernels goes: each kernel built with one part
of its work removed (or, for ``overlap``, done in another order), timed
beside the whole at ProGen-small's shapes in bf16: the K1 backward kernels
at the training shape (B = 8, H = 8, L = 1024, D = 128, window 256), K1-fwd
and K2-fwd (n = 1024, d = 2048) at the serving shape B = 4 and the
training shape B = 8, K3 and K3-q8 at the engine's (8 rows at ragged
positions, n = 1024, d = 2048, page 16; a bf16 pool, and int8 weights with
an int8 pool), warm in L2 and cold.

    python -m progen_tpu_torch.kernels.ablate [local_attention_bwd
                                               local_attention_fwd sgu_fwd
                                               paged_gate_mix]

Variants, made from the source by text substitution (each substitution
checked; the results are wrong, only the times count, except ``overlap``'s):

- K1-dq and K1-dkv (``local_attention_bwd.cu``): ``whole``; ``no_exp``
  (p = s * scale - lse, without the exponential); ``no_first`` (no first
  products: s, dp and their transposes stay 0); ``no_second`` (p and ds are
  formed and dropped); ``ring_only`` (the consumers wait for each tile and
  release it, and compute nothing: the TMA ring, the resident tiles and the
  epilogue alone).
- K1-fwd (``local_attention_fwd.cu``): ``whole``; ``no_exp`` (p = the
  scaled logit minus the running max, without the exponential);
  ``ring_only``; and two designs tried, whose results are right:
  ``overlap`` (tile t+1's q.k^T issued before tile t's softmax, so the
  tensor cores run it while the warpgroup forms p) and ``in_order`` (the
  blocks launched in row order, not longest walk first).
- K2-fwd (``sgu_fwd.cu``): ``whole``; ``no_epilogue`` (res's tile is
  stored as it arrived: no bias, cast or product); ``ring_only`` (no
  diagonal mask and no products); and three designs tried, whose results
  are right: ``in_order`` (blocks in (batch row, row tile, channel tile)
  order, not longest walk first), ``batch_major`` (batch row by batch row,
  longest walk first within each) and ``one_block`` (a producer warpgroup
  and 4 stages: one block an SM, the first design).
- K3 and K3-q8 on the bulk route (``paged_gate_mix.cu``): ``whole``;
  ``copies_only`` (the ring fills and drains, no products); ``no_sum``
  (each split writes its partial, no cross-block sum); ``one_split`` (the
  row walk not split: one block per (batch row, slab) walks every row, the
  design without load balance; its results are right); ``launch_only``
  (every block exits at once: the launch of the grid); ``no_ticket`` (each
  cluster's sum goes out as it is: no workspace, fence or ticket); designs
  tried, whose results are right: ``i2f`` (int8 widened by the conversion
  unit), ``no_cluster`` (clusters of one block: every split's sum meets the
  others through the ticket, the first design), ``cluster_4`` (clusters of
  4), ``int8_split_32`` (an int8 pool's splits as long as a bf16 pool's),
  ``split_16`` (bf16 splits of 16 rows), ``split_64`` and ``split_128``
  (splits twice as long, and of 128 rows), ``narrow_128`` (splits of 128
  rows, slabs of 1024 bytes, four consumer groups); and ``simt``, the
  first kernel, from the whole library.  Each is timed warm (``time_ms``) and cold
  (``time_ms_cold``: behind a 256 MB write, so L2 holds none of its
  inputs), and its largest distance from the plain version is reported.

Prints the card's name and power limit, then one JSON line per variant of
what ptxas says of its Hopper kernels (registers, spill stores, and any
"Potential Performance Loss" note, such as serialised ``wgmma``s), then one
JSON line of CUDA-event times (ms, ``chip_smoke.time_ms``'s and
``chip_smoke.time_ms_cold``'s methods) per kernel, variant and shape.  Needs a card and nvcc; builds into
``kernels/_build/``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from progen_tpu_torch import kernels
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.ops import paged_gate_mix as plain_paged
from progen_tpu_torch.ops.quant import quantize_rows, quantize_w

SPIN_CYCLES = 40_000_000
WINDOW = 256
HEADS, SEQ, DIM_HEAD = 8, 1024, 128
SGU_N, SGU_D = 1024, 2048
PAGED_N, PAGED_D, PAGED_PAGE = 1024, 2048, 16
PAGED_POS = (0, 15, 16, 300, 511, 777, 1022, 1023)
FLUSH_BYTES = 256 << 20   # written before each cold call: five times L2

# inserted before the K1 backward kernels, inside the source's own
# anonymous namespace
BWD_STUBS = """
template <int D>
__device__ __forceinline__ void no_scores(float (&)[32], const unsigned char*,
                                          const unsigned char*) {}
template <int D>
__device__ __forceinline__ void no_accumulate(float (&)[D / 2], const uint32_t (&p)[4][4],
                                              const unsigned char*) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    asm volatile("" ::"r"(p[k][0]), "r"(p[k][1]), "r"(p[k][2]), "r"(p[k][3]));
  }
}
"""

# K1-fwd's consumer loop, from its first line to its last, and the
# overlapped loop that replaces it in the ``overlap`` variant: two score
# fragments in turn, tile t+1's scores in flight while tile t's p is formed
FWD_LOOP_START = """  for (int it = 0; it < tiles; ++it) {
    const int s = it % STAGES, t0 = first + TROWS * it;"""
FWD_LOOP_END = """    if (tid == 0) mbar_arrive(&empty[s]);  // a skipping warpgroup arrives too
  }
"""
FWD_OVERLAP = """  // warpgroup 0 skips the last tile, warpgroup 1 none; a stage is released
  // once the p.v of its tile is done, and the last one not at all
  const int mine = tiles - (group == 0 ? 1 : 0);
  auto ring = [&](int it) { return smem + S::RING + (it % STAGES) * S::STAGE; };
  auto step = [&](float (&sc)[32], float (&nx)[32], int it) {
    const int kind = dq_kind(r0, first + TROWS * it);
    if (it + 1 < mine) {
      mbar_wait_or_trap(&full[(it + 1) % STAGES], ((it + 1) / STAGES) & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) nx[i] = 0.0f;
      wgmma_fence();
      scores<D>(nx, qs, ring(it + 1));
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_operands(sc);
    fence_operands(acc);
    if (it > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    float top[2] = {mx[0], mx[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 4 * i + 2 * h + x;
          const int r = lr + 8 * h, c = 8 * i + 2 * (lane % 4) + x;
          const float v = (kind == FULL || c <= r) ? sc[e] * scale2 : -INFINITY;
          sc[e] = v;
          top[h] = fmaxf(top[h], v);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 1));
      top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 2));
      alpha[h] = exp2f(mx[h] - top[h]);
      mx[h] = top[h];
      den[h] *= alpha[h];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(sc[4 * i + 2 * h] - mx[h]);
        const float p1 = exp2f(sc[4 * i + 2 * h + 1] - mx[h]);
        den[h] += p0 + p1;
        a_slot(pa, i, h) = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= alpha[0];
      acc[4 * i + 1] *= alpha[0];
      acc[4 * i + 2] *= alpha[1];
      acc[4 * i + 3] *= alpha[1];
    }
    wgmma_fence();
    accumulate<D>(acc, pa, ring(it) + S::TILE);
    wgmma_commit();
  };
  float sa[32], sb[32];
  mbar_wait_or_trap(&full[0], 0);
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = 0.0f;
  wgmma_fence();
  scores<D>(sa, qs, ring(0));
  wgmma_commit();
  for (int it = 0; it < mine; it += 2) {
    step(sa, sb, it);
    if (it + 1 < mine) step(sb, sa, it + 1);
  }
  wgmma_wait<0>();
  fence_operands(acc);
"""

# inserted before the bulk K3 kernel, in the source's anonymous namespace:
# int8 widened by the conversion unit (the ``i2f`` variant)
PAGED_STUBS = """
__device__ __forceinline__ void widen4_i2f(uint32_t word, float* x) {
  const char4 c = *reinterpret_cast<const char4*>(&word);
  x[0] = static_cast<float>(c.x);
  x[1] = static_cast<float>(c.y);
  x[2] = static_cast<float>(c.z);
  x[3] = static_cast<float>(c.w);
}
"""

# where the bulk K3's splits start to meet, and what the ``no_sum`` variant
# puts before it: each split's sum goes out as it is
CLUSTER_SUM = "  // The cluster's splits meet: block `rank` sums its share of the slab's"
NO_SUM = """  if (true) {
    if (owner) {
      const size_t c0 = static_cast<size_t>(slab0) / sizeof(PT) + static_cast<size_t>(t) * CH;
#pragma unroll
      for (int q = 0; q < CH; q += 4) store4(out + static_cast<size_t>(b) * d + c0 + q, acc, q, 0.0f);
    }
    return;
  }
"""

# K2-fwd's blocks ordered batch row by batch row, longest walk first within
# each
BATCH_MAJOR = ("block_tile(blockIdx.x, batch, row_tiles, col_tiles, b, mi, ct);",
               "ct = blockIdx.x % col_tiles;"
               " mi = row_tiles - 1 - (blockIdx.x / col_tiles) % row_tiles;"
               " b = blockIdx.x / (col_tiles * row_tiles);", 1)

# source -> (the text the Hopper kernels start at, stubs, variants); a
# variant is a list of (text, replacement, occurrences after the start), or
# of (start, end, replacement) spans
SOURCES = {
    "local_attention_bwd": ("// K1-dq, bf16: block", BWD_STUBS, {
        "whole": [],
        "no_exp": [("exp2f(", "(", 3)],
        "no_first": [("scores<D>(", "no_scores<D>(", 5)],
        "no_second": [("accumulate<D>(", "no_accumulate<D>(", 3)],
        "ring_only": [("if (kind != SKIPPED) {", "if (false) {", 3)],
    }),
    "local_attention_fwd": ("// K1-fwd, bf16: block", "", {
        "whole": [],
        "no_exp": [("exp2f(", "(", 4)],
        "ring_only": [("if (kind != SKIPPED) {", "if (false) {", 1)],
        "overlap": [(FWD_LOOP_START, FWD_LOOP_END, FWD_OVERLAP)],
        "in_order": [("block_row(blockIdx.x / bh, seq, wsz)", "(blockIdx.x / bh) * ROWS", 1)],
    }),
    "sgu_fwd": ("namespace fw {", "", {
        "whole": [],
        "no_epilogue": [("*at = __floats2bfloat162_rn(",
                         "if (false) *at = __floats2bfloat162_rn(", 1)],
        "ring_only": [("if (kind == DIAGONAL) {", "if (false) {", 1),
                      ("if (kind != SKIPPED) {", "if (false) {", 1)],
        "in_order": [("block_tile(blockIdx.x, batch, row_tiles, col_tiles, b, mi, ct);",
                      "ct = blockIdx.x % col_tiles; mi = (blockIdx.x / col_tiles) % row_tiles;"
                      " b = blockIdx.x / (col_tiles * row_tiles);", 1)],
        "batch_major": [BATCH_MAJOR],
        "one_block": [("constexpr int STAGES = 2;", "constexpr int STAGES = 4;", 1),
                      ("constexpr int THREADS = 288;", "constexpr int THREADS = 384;", 1),
                      ("__launch_bounds__(fw::THREADS, 2)", "__launch_bounds__(fw::THREADS, 1)",
                       1)],
    }),
    "paged_gate_mix": ("namespace bk {", PAGED_STUBS, {
        "whole": [],
        "i2f": [("widen4(u[k], x + 4 * k)", "widen4_i2f(u[k], x + 4 * k)", 1)],
        "launch_only": [("if (cl >= live_clusters) return;", "if (true) return;", 1)],
        "no_ticket": [("  if (live_clusters == 1) return;\n  named_sync(1, CONSUMERS);",
                       "  if (true) return;\n  named_sync(1, CONSUMERS);", 1)],
        "split_16": [("constexpr int SPLIT_ROWS = 32;", "constexpr int SPLIT_ROWS = 16;", 1)],
        "copies_only": [("if ((mask >> j) & 1u) {", "if (false) {", 1)],
        "no_sum": [(CLUSTER_SUM, NO_SUM + CLUSTER_SUM, 1)],
        "one_split": [("constexpr int SPLIT_ROWS = 32;", "constexpr int SPLIT_ROWS = 1 << 20;",
                       1),
                      ("constexpr int SPLIT_ROWS_8 = 16;",
                       "constexpr int SPLIT_ROWS_8 = 1 << 20;", 1)],
        "no_cluster": [("constexpr int CLUSTER = 8;", "constexpr int CLUSTER = 1;", 1)],
        "cluster_4": [("constexpr int CLUSTER = 8;", "constexpr int CLUSTER = 4;", 1)],
        "int8_split_32": [("constexpr int SPLIT_ROWS_8 = 16;", "constexpr int SPLIT_ROWS_8 = 32;",
                           1)],
        "split_16": [("constexpr int SPLIT_ROWS = 32;", "constexpr int SPLIT_ROWS = 16;", 1)],
        "split_64": [("constexpr int SPLIT_ROWS = 32;", "constexpr int SPLIT_ROWS = 64;", 1),
                     ("constexpr int SPLIT_ROWS_8 = 16;", "constexpr int SPLIT_ROWS_8 = 32;", 1)],
        "split_128": [("constexpr int SPLIT_ROWS = 32;", "constexpr int SPLIT_ROWS = 128;", 1),
                      ("constexpr int SPLIT_ROWS_8 = 16;", "constexpr int SPLIT_ROWS_8 = 128;",
                       1)],
        "narrow_128": [("constexpr int SPLIT_ROWS = 32;", "constexpr int SPLIT_ROWS = 128;", 1),
                       ("constexpr int SPLIT_ROWS_8 = 16;", "constexpr int SPLIT_ROWS_8 = 128;",
                        1),
                       ("constexpr int SLAB_BYTES = 2048;", "constexpr int SLAB_BYTES = 1024;",
                        1),
                       ("constexpr int GROUPS = 2;", "constexpr int GROUPS = 4;", 1)],
    }),
}
# source -> its entry points and their tensor-pointer counts (and, for the
# paged gate mix, its int counts)
ENTRIES = {
    "local_attention_bwd": (("local_attention_bwd_dq_wgmma", 7),
                            ("local_attention_bwd_dkv_wgmma", 8)),
    "local_attention_fwd": (("local_attention_fwd_wgmma", 5),),
    "sgu_fwd": (("sgu_fwd_wgmma", 5),),
    "paged_gate_mix": (("paged_gate_mix_bulk", 8, 8), ("paged_gate_mix_q8_bulk", 10, 9),
                       ("paged_gate_mix", 6, 7), ("paged_gate_mix_q8", 8, 8)),
}
# the element types of the paged gate mix's template arguments, mangled
PAGED_TYPES = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}


def variant_source(source: str, variant: str) -> str:
    start, stubs, variants = SOURCES[source]
    src = (kernels.CSRC / f"{source}.cu").read_text()
    head, part = src.split(start, 1)
    for edit in variants[variant]:
        if len(edit) == 3 and isinstance(edit[2], int):
            old, new, count = edit
            found = part.count(old)
            if found != count:
                raise RuntimeError(f"{source} {variant}: {old!r} occurs {found} times, "
                                   f"not {count}")
            part = part.replace(old, new)
        else:
            first, last, new = edit
            if part.count(first) != 1:
                raise RuntimeError(f"{source} {variant}: the span's start is not unique")
            before, after = part.split(first, 1)
            if last not in after:
                raise RuntimeError(f"{source} {variant}: the span has no end")
            part = before + new + after.split(last, 1)[1]
    return head + stubs + start + part


def kernel_key(line: str) -> str | None:
    """The Hopper kernel a ptxas line names, with its dim_head or its
    element types (``paged_gate_mix_bulk_kernel<int8,int8,scaled>``)."""
    if entry := re.search(r"\d([a-z][a-z_]*_wgmma_kernel)(ILi(\d+)E)?", line):
        return entry.group(1) + (f"<{entry.group(3)}>" if entry.group(3) else "")
    if entry := re.search(r"\d(paged_gate_mix(?:_bulk)?_kernel)I((?:f|a|13__nv_bfloat16)+)"
                          r"Lb([01])E", line):
        types = [PAGED_TYPES[t] for t in re.findall(r"f|a|13__nv_bfloat16", entry.group(2))]
        return f"{entry.group(1)}<{','.join(types + ['scaled'] * (entry.group(3) == '1'))}>"
    return None


def ptxas_summary(report: str) -> dict:
    """Registers and spill stores of each Hopper kernel in a ``-Xptxas -v``
    report, keyed by :func:`kernel_key`, and its performance notes."""
    kernels_seen, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = kernel_key(line)
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            kernels_seen.setdefault(name, {})["spill_stores"] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels_seen.setdefault(name, {})["registers"] = int(m.group(1))
    notes = sorted({line.split(":", 1)[-1].strip() for line in report.splitlines()
                    if "Performance Loss" in line})
    return {"kernels": kernels_seen, "notes": notes}


def build(variants: list[tuple[str, str]]) -> dict[tuple[str, str], tuple]:
    """Build every (source, variant), one nvcc each, all started together;
    returns the library and ptxas's summary of each."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, variant in variants:
        src = kernels.BUILD_DIR / f"ablate_{source}_{variant}.cu"
        src.write_text(variant_source(source, variant))
        procs[source, variant] = (src, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-I", str(kernels.CSRC), "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (source, variant), (src, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{report}")
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        for name, n_tensors, *n_ints in ENTRIES[source]:
            fn = getattr(lib, name)
            tail = ([ctypes.c_int] * n_ints[0] + [ctypes.c_void_p] if n_ints
                    else [ctypes.c_int] * 4 + [ctypes.c_void_p] if source == "sgu_fwd"
                    else [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.argtypes = [ctypes.c_void_p] * n_tensors + tail
            fn.restype = ctypes.c_int
        libs[source, variant] = (lib, ptxas_summary(report))
    return libs


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_cold(fn, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` with L2 cold: each of ``iters``
    calls follows a write of a 256 MB buffer (five times L2) and has its own
    event pair; all are enqueued behind a ~20 ms device spin, so the host's
    pace does not enter.  ``chip_smoke.time_ms_cold``'s method."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    for i, (start, end) in enumerate(pairs):
        flush.fill_(i & 1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs]))


def check(err: int) -> None:
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")


def attention_inputs(gen, batch: int):
    shape = (batch, HEADS, SEQ, DIM_HEAD)
    return [torch.randn(*shape, device="cuda", generator=gen).bfloat16() for _ in range(4)]


def time_bwd(lib, gen) -> list[dict]:
    q, k, v, do = attention_inputs(gen, 8)
    out, lse = cuda_attention.local_attention_fwd(q, k, v, WINDOW)
    dd = (do.float() * out.float()).sum(-1)
    grads = [torch.empty_like(q) for _ in range(3)]
    args = [t.data_ptr() for t in (q, k, v, do, lse, dd)]
    rest = (8 * HEADS, SEQ, DIM_HEAD, WINDOW, DIM_HEAD ** -0.5, 1,
            torch.cuda.current_stream().cuda_stream)
    return [{"shape": list(q.shape), "window": WINDOW,
             "dq_ms": time_ms(lambda: check(lib.local_attention_bwd_dq_wgmma(
                 *args, grads[0].data_ptr(), *rest))),
             "dkv_ms": time_ms(lambda: check(lib.local_attention_bwd_dkv_wgmma(
                 *args, grads[1].data_ptr(), grads[2].data_ptr(), *rest)))}]


def time_fwd(lib, gen) -> list[dict]:
    rows = []
    for batch in (4, 8):
        q, k, v, _ = attention_inputs(gen, batch)
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                batch * HEADS, SEQ, DIM_HEAD, WINDOW, DIM_HEAD ** -0.5, 1,
                torch.cuda.current_stream().cuda_stream)
        check(lib.local_attention_fwd_wgmma(*args))
        want_out, want_lse = cuda_attention.local_attention_fwd(q, k, v, WINDOW)
        rows.append({"shape": list(q.shape), "window": WINDOW,
                     "ms": time_ms(lambda: check(lib.local_attention_fwd_wgmma(*args))),
                     "same_as_whole": torch.equal(out, want_out)
                     and torch.equal(lse, want_lse)})
    return rows


def time_sgu(lib, gen) -> list[dict]:
    rows = []
    for batch in (4, 8):
        res, gate = (torch.randn(batch, SGU_N, SGU_D, device="cuda", generator=gen).bfloat16()
                     for _ in range(2))
        w = (torch.randn(SGU_N, SGU_N, device="cuda", generator=gen) * 0.05).bfloat16()
        bias = torch.ones(SGU_N, 1, device="cuda", dtype=torch.bfloat16)
        out = torch.empty_like(gate)
        args = (res.data_ptr(), gate.data_ptr(), w.data_ptr(), bias.data_ptr(),
                out.data_ptr(), batch, SGU_N, SGU_D, 1, torch.cuda.current_stream().cuda_stream)
        check(lib.sgu_fwd_wgmma(*args))
        rows.append({"shape": [batch, SGU_N, SGU_D],
                     "ms": time_ms(lambda: check(lib.sgu_fwd_wgmma(*args))),
                     "same_as_whole": torch.equal(
                         out, cuda_sgu.spatial_gate_fwd(res, gate, w, bias))})
    return rows


def paged_inputs(gen) -> dict:
    """The engine's shapes at ProGen-small: 8 rows at ``PAGED_POS``, tables
    naming random pages up to each row's last, a bf16 pool and the int8
    twins of the weights (per row) and the pool (per pool row)."""
    batch, ppr = len(PAGED_POS), PAGED_N // PAGED_PAGE
    num_pages = 2 + batch * ppr
    pool = torch.randn(num_pages, PAGED_PAGE, PAGED_D, device="cuda", generator=gen)
    perm = (torch.randperm(num_pages - 2, device="cuda", generator=gen) + 2).int()
    table = torch.zeros(batch, ppr, dtype=torch.int32, device="cuda")
    for b, p in enumerate(PAGED_POS):
        table[b, :p // PAGED_PAGE + 1] = perm[b * ppr: b * ppr + p // PAGED_PAGE + 1]
    w = torch.randn(PAGED_N, PAGED_N, device="cuda", generator=gen) * 0.05
    wq, ws = quantize_w(w, channel_axis=0)
    pq, pscale = quantize_rows(pool)
    return {"w": w, "bias": torch.randn(PAGED_N, 1, device="cuda", generator=gen),
            "pool": pool.bfloat16(), "table": table,
            "pos": torch.tensor(PAGED_POS, dtype=torch.int32, device="cuda"),
            "wq": wq, "ws": ws, "pq": pq, "pscale": pscale}


def time_paged(lib, gen, variant: str) -> list[dict]:
    """K3 (bf16 pool) and K3-q8 (int8 weights, int8 pool) of this variant's
    library on the bulk route, and, from the whole library, on the first
    kernel's simt route: warm and cold times and the largest distance from the plain
    version."""
    c = paged_inputs(gen)
    plan = (ctypes.c_int * 6)()
    lib.paged_gate_mix_bulk_plan(plan)
    slab_bytes, cluster = plan[2], plan[5]
    batch, ppr = c["table"].shape
    num_pages = c["pool"].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    shape = (batch, PAGED_N, PAGED_D, PAGED_PAGE, ppr, num_pages)
    rows = []
    for kernel, pool, scales, dtypes in (
            ("paged_gate_mix", c["pool"], (), (1,)),
            ("paged_gate_mix_q8", c["pq"], (c["ws"], c["pscale"]), (2, 2))):
        w = c["w"] if kernel == "paged_gate_mix" else c["wq"]
        split_rows = plan[1] if pool.element_size() == 1 else plan[0]
        splits = -(-min(PAGED_N, ppr * PAGED_PAGE) // (split_rows * cluster)) * cluster
        slabs = -(-PAGED_D * pool.element_size() // slab_bytes)
        out = torch.empty(batch, PAGED_D, device="cuda")
        partials = torch.empty(batch, splits // cluster, PAGED_D, device="cuda")
        tickets = torch.zeros(batch * slabs * cluster, dtype=torch.int32, device="cuda")
        head = [t.data_ptr() for t in (w, c["bias"], pool, c["table"], c["pos"], *scales,
                                       out)]
        bulk = getattr(lib, f"{kernel}_bulk")
        simt = getattr(lib, kernel)
        launches = {"bulk": lambda: check(bulk(*head, partials.data_ptr(),
                                               tickets.data_ptr(), *shape, splits,
                                               *dtypes, stream))}
        if variant == "whole":
            launches["simt"] = lambda: check(simt(*head, *shape, *dtypes, stream))
        want = plain_paged.paged_gate_mix(w, c["bias"], pool, c["table"], c["pos"],
                                          n_rows=PAGED_N, w_scale=c["ws"] if scales else None,
                                          pool_scale=c["pscale"] if scales else None)
        for route, fn in launches.items():
            fn()
            torch.cuda.synchronize()
            rows.append({"kernel": kernel, "route": route, "pool": str(pool.dtype),
                         **({"variant": "simt"} if route == "simt" else {}),
                         "splits": splits, "ms": time_ms(fn), "ms_cold": time_ms_cold(fn),
                         "max_abs_err_vs_plain": float((out - want).abs().max())})
    return rows


TIMERS = {"local_attention_bwd": time_bwd, "local_attention_fwd": time_fwd,
          "sgu_fwd": time_sgu, "paged_gate_mix": time_paged}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    sources = argv or list(SOURCES)
    libs = build([(s, v) for s in sources for v in SOURCES[s][2]])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (source, variant), (_, ptxas) in libs.items():
        print(json.dumps({"source": source, "variant": variant, "ptxas": ptxas}), flush=True)
    for (source, variant), (lib, _) in libs.items():
        timer = TIMERS[source]
        for row in (timer(lib, gen, variant) if source == "paged_gate_mix"
                    else timer(lib, gen)):
            print(json.dumps({"source": source, "variant": variant, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
