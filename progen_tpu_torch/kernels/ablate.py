"""Where the time of the Hopper K1 backward kernels goes: each kernel built
with one part of its step removed, timed at ProGen-small's training shape
(B = 8, H = 8, L = 1024, D = 128, window 256, bf16) beside the whole.

    python -m progen_tpu_torch.kernels.ablate

Variants of ``csrc/local_attention_bwd.cu`` (made by text substitution,
each substitution checked; the results are wrong, only the times count):

- ``whole``: the source as it is;
- ``no_exp``: p = s * scale - lse, without the exponential;
- ``no_first``: no first products (s, dp and their transposes stay 0);
- ``no_second``: no second products (p and ds are formed and dropped);
- ``ring_only``: the consumers wait for each tile and release it, and
  compute nothing: the TMA ring, the resident tiles and the epilogue alone.

Prints the card's name and power limit, then one JSON line of CUDA-event
times (ms, ``chip_smoke.time_ms``'s method) per variant.  Needs a card and
nvcc; builds into ``kernels/_build/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from progen_tpu_torch import kernels
from progen_tpu_torch.ops import cuda_attention

SOURCE = kernels.CSRC / "local_attention_bwd.cu"
SHAPE = (8, 8, 1024, 128)
WINDOW = 256
SPIN_CYCLES = 40_000_000

# inserted before the kernels, inside the source's own anonymous namespace
STUBS = """
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
KERNELS_START = "// K1-dq, bf16: block"

# name -> (text, replacement, occurrences in the wgmma kernels)
VARIANTS = {
    "whole": [],
    "no_exp": [("exp2f(", "(", 3)],
    "no_first": [("scores<D>(", "no_scores<D>(", 5)],
    "no_second": [("accumulate<D>(", "no_accumulate<D>(", 3)],
    "ring_only": [("if (kind != SKIPPED) {", "if (false) {", 3)],
}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    head, kernels_part = src.split(KERNELS_START, 1)
    for old, new, count in VARIANTS[name]:
        found = kernels_part.count(old)
        if found != count:
            raise RuntimeError(f"{name}: {old!r} occurs {found} times, not {count}")
        kernels_part = kernels_part.replace(old, new)
    return head + STUBS + KERNELS_START + kernels_part


def build(name: str) -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / f"ablate_{name}.cu"
    src.write_text(variant_source(name))
    out = src.with_suffix(".so")
    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                           "-o", str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, n_tensors in ((lib.local_attention_bwd_dq_wgmma, 7),
                          (lib.local_attention_bwd_dkv_wgmma, 8)):
        fn.argtypes = ([ctypes.c_void_p] * n_tensors + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


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


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    libs = {name: build(name) for name in VARIANTS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, n, d = SHAPE
    q, k, v, do = (torch.randn(*SHAPE, device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    out, lse = cuda_attention.local_attention_fwd(q, k, v, WINDOW)
    dd = (do.float() * out.float()).sum(-1)
    grads = [torch.empty_like(q) for _ in range(3)]
    args = [t.data_ptr() for t in (q, k, v, do, lse, dd)]
    rest = (b * h, n, d, WINDOW, d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)

    def launch(fn, *outs):
        err = fn(*args, *(g.data_ptr() for g in outs), *rest)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    for name, lib in libs.items():
        row = {"variant": name, "shape": list(SHAPE), "window": WINDOW,
               "dq_ms": time_ms(lambda: launch(lib.local_attention_bwd_dq_wgmma, grads[0])),
               "dkv_ms": time_ms(lambda: launch(lib.local_attention_bwd_dkv_wgmma,
                                                grads[1], grads[2]))}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
