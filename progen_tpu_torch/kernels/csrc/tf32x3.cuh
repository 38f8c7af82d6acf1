// f32 products on the tensor cores to close to f32 accuracy (3xTF32), shared
// by the port's f32 "tf32x3" routes: K1-fwd, K1-dq and K1-dkv
// (attention_tf32x3.cuh adds what is about attention), K2-fwd (sgu_fwd.cu),
// K2-dgate and K2-dW (sgu_bwd.cu).  mma.sync m16n8k8 with operands streamed through
// a cp.async ring into padded f32 rows of shared memory.
//
// The split.  An f32 operand x is hi = tf32(x) and lo = tf32(x - hi), each
// rounded to nearest with ties away from zero (cvt.rna, 10 mantissa bits);
// a.b is then lo_a.hi_b + hi_a.lo_b + hi_a.hi_b accumulated in f32 (the
// small products first), which leaves out lo_a.lo_b (about 2^-22 of a.b)
// and the rounding of lo (about 2^-11 of lo, 2^-22 of x).  One TF32 product
// alone keeps 2^-11 of each operand: about 5e-4 relative, over the port's
// f32 bar of 1e-4.  CUTLASS's OpMultiplyAddFastF32 is the same idea.
//
// Where the split happens: in registers, as each fragment is loaded from
// shared memory (three instructions a value), so shared memory holds each
// f32 tile once, as it arrived.  mma.sync needs no operand layout: every
// fragment is read with plain 32-bit loads from rows padded so that a
// warp's 32 reads fall in 32 distinct banks (see each loader).
//
// Fragments of mma.m16n8k8 .tf32 (row.col), for lane l, g = l / 4,
// t = l % 4: A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8) b0 (k = t, n = g), b1 (k = t + 4, n = g);
// C (16 x 8) c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t), c3 (g + 8, 2 t + 1).
// A second product whose A operand is a first product's result takes its k
// index permuted: A column t is column 2 t of the result, column t + 4 is
// 2 t + 1 (a = {c0, c2, c1, c3}), and B reads the rows of the same columns
// (load_b_cols).  A sum over k does not depend on its order.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace progen {
namespace tf32x3 {

// A (16 x 8) and B (8 x 8) fragments, split.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a.b[i] for i < N, each to close to f32 accuracy: the small
// products first, then the large, term by term across the N products, so
// that consecutive mma's are independent (three on one accumulator in a
// row would each wait for the last).
template <int N>
__device__ __forceinline__ void mma3(float (*d)[4], const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.hi, b[i].hi);
}

// A from 16 rows of a row-major f32 tile: `m` points at (row 0, column k0).
// Rows ld = 4 (mod 32) words apart: the 32 reads fall in distinct banks.
__device__ __forceinline__ void load_a(FragA& f, const float* m, int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  split(m[g * ld + t], f.hi[0], f.lo[0]);
  split(m[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split(m[g * ld + t + 4], f.hi[2], f.lo[2]);
  split(m[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
}

// A = M^T for a row-major (k, m) tile M whose rows are A's k (M-major, as
// K2-dgate reads W^T): `m` points at (row k0, column m0).  Rows ld = 8
// (mod 32) words apart put the 32 reads in distinct banks (8 t + g).
__device__ __forceinline__ void load_a_km(FragA& f, const float* m, int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  split(m[t * ld + g], f.hi[0], f.lo[0]);
  split(m[t * ld + g + 8], f.hi[1], f.lo[1]);
  split(m[(t + 4) * ld + g], f.hi[2], f.lo[2]);
  split(m[(t + 4) * ld + g + 8], f.hi[3], f.lo[3]);
}

// A from a first product's C fragment (16 x 8), k permuted as above.
__device__ __forceinline__ void a_from_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// B = M^T for a row-major tile M whose rows are B's columns (K-major, as
// q.k^T reads k): `m` points at (row n0, column k0); ld = 4 (mod 32).
__device__ __forceinline__ void load_b_rows(FragB& f, const float* m, int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  split(m[g * ld + t], f.hi[0], f.lo[0]);
  split(m[g * ld + t + 4], f.hi[1], f.lo[1]);
}

// B = M for a row-major tile M whose rows are B's k (N-major, as p.v reads
// v), with k permuted to match a_from_c: `m` points at (row k0, column n0).
__device__ __forceinline__ void load_b_cols(FragB& f, const float* m, int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  split(m[2 * t * ld + g], f.hi[0], f.lo[0]);
  split(m[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
}

// B = M for a row-major (k, n) tile M (N-major) whose A operand came from
// memory (load_a), k in order: rows t and t + 4.  `m` points at (row k0,
// column n0); rows ld = 8 (mod 32) words apart put the 32 reads in distinct
// banks (8 t + g).
__device__ __forceinline__ void load_b_kn(FragB& f, const float* m, int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  split(m[t * ld + g], f.hi[0], f.lo[0]);
  split(m[(t + 4) * ld + g], f.hi[1], f.lo[1]);
}

// Rows [0, N) of a (rows, D) f32 matrix from `src` into shared memory rows
// of D + 4 words, by a block of THREADS threads in 16-byte cp.async copies
// (the caller commits the group).
template <int D, int N, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src) {
  constexpr int LD = D + 4, CHUNKS = D / 4;
  for (int i = threadIdx.x; i < N * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    progen::hopper::cp_async_16(dst + r * LD + c, src + static_cast<size_t>(r) * D + c);
  }
}

// One 16-byte cp.async that reads `src` when `valid` and writes zeros
// otherwise (src-size 0: nothing is read, `src` need only be an address).
__device__ __forceinline__ void cp_async_16_or_zero(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   progen::hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// A (ROWS, COLS) f32 tile at (r0, c0) of a row-major matrix whose rows are
// `ld` elements apart, into shared memory rows of LDS words, by a block of
// THREADS threads in 16-byte cp.async copies: rows >= rows_valid and
// columns >= cols_valid (a multiple of 4, or past COLS) are zero-filled
// and not read.  The caller commits the group.
template <int ROWS, int COLS, int LDS, int THREADS>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src,
                                          size_t ld, int r0, int c0, int rows_valid,
                                          int cols_valid) {
  constexpr int CHUNKS = COLS / 4;
  static_assert(ROWS * CHUNKS % THREADS == 0, "every thread copies as many chunks");
#pragma unroll
  for (int u = 0; u < ROWS * CHUNKS / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool valid = r0 + r < rows_valid && c0 + c < cols_valid;
    const float* from = valid ? src + static_cast<size_t>(r0 + r) * ld + c0 + c : src;
    cp_async_16_or_zero(dst + r * LDS + c, from, valid);
  }
}

}  // namespace tf32x3
}  // namespace progen
