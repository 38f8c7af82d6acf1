// The causal SGU kernels' shared tile machinery: a 64 x 128 output tile
// per block of 4 warps, accumulated over 64-deep steps from a (64, 64)
// tile A and a (64, 128) tile B in shared memory (C += A . B), on the
// tensor cores through WMMA in bf16 and by FMA loops in f32.
#pragma once

#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

namespace progen {
namespace sgu {

using namespace nvcuda;

constexpr int TM = 64;    // output rows per block (positions m)
constexpr int TN = 128;   // output columns per block (channels)
constexpr int TK = 64;    // positions k per step; equal to TM so tiles align
constexpr int THREADS = 128;

template <typename T>
struct Layout {
  static constexpr int LDW = TK + Pad<T>::v;  // W tile rows (T)
  static constexpr int LDG = TN + Pad<T>::v;  // gate tile rows (T)
  static constexpr int LDC = TN + 4;          // f32 result rows
  static constexpr size_t w = 0;
  static constexpr size_t g = w + sizeof(T) * TM * LDW;
  static constexpr size_t c = g + sizeof(T) * TK * LDG;
  static constexpr size_t bytes = c + sizeof(float) * TM * LDC;
};

// Accumulators: bf16 keeps WMMA fragments (warp w: rows 16w.., all TN
// columns); f32 keeps an 8x8 register tile (rows rg + 8i, columns cg + 16j).
template <typename T> struct Acc;

template <> struct Acc<bf16> {
  using L = Layout<bf16>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[TN / 16];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) wmma::fill_fragment(f[j], 0.0f);
  }
  __device__ void step(const bf16* ws, const bf16* gs) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ws + warp * 16 * L::LDW + kk, L::LDW);
#pragma unroll
      for (int j = 0; j < TN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, gs + kk * L::LDG + j * 16, L::LDG);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ void store(float* cs) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) {
      wmma::store_matrix_sync(cs + warp * 16 * L::LDC + j * 16, f[j], L::LDC,
                              wmma::mem_row_major);
    }
  }
};

template <> struct Acc<float> {
  using L = Layout<float>;
  float f[8][8];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) f[i][j] = 0.0f;
  }
  __device__ void step(const float* ws, const float* gs) {
    const int rg = threadIdx.x / 16;
    const int cg = threadIdx.x % 16;
    for (int k = 0; k < TK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ws[(rg + 8 * i) * L::LDW + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = gs[k * L::LDG + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) f[i][j] += a[i] * b[j];
    }
  }
  __device__ void store(float* cs) {
    const int rg = threadIdx.x / 16;
    const int cg = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cs[(rg + 8 * i) * L::LDC + cg + 16 * j] = f[i][j];
  }
};

}  // namespace sgu
}  // namespace progen
