// The windowed-attention kernels' shared tile machinery: a block of 4 warps
// owns 64 rows (16 a warp) of width D and streams tiles of BN rows of the
// other side through shared memory; each warp forms its rows' products with
// a streamed tile, on the tensor cores through WMMA (16x16x16, f32
// accumulate) in bf16 and by FMA loops in f32 (two lanes a row).
#pragma once

#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

namespace progen {
namespace attention {

using namespace nvcuda;

constexpr int BM = 64;              // rows a block owns
constexpr int WARPS = BM / 16;      // one warp per 16 rows
constexpr int THREADS = WARPS * 32;

// Shared-memory row strides, in elements, for a block that owns BM rows of
// width D and streams tiles of BN rows; every region a kernel lays out from
// them is a multiple of 32 bytes, so WMMA fragment pointers stay 256-bit
// aligned.
template <typename T, int D, int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int LDT = D + Pad<T>::v;   // q, k, v, dout rows (T)
  static constexpr int LDS = BN + 4;          // score rows (f32)
  static constexpr int LDP = BN + Pad<T>::v;  // probability rows (T)
  static constexpr int LDO = D + 4;           // f32 accumulator rows
};

// Copy rows [r0, r0 + ROWS) of a (rows, D) matrix into shared memory with
// 16-byte vectors; rows outside [0, rows) are zeros.
template <typename T, int D, int ROWS>
__device__ void load_rows(T* dst, const T* src, int r0, int rows) {
  constexpr int LDT = D + Pad<T>::v;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    const int g = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < rows) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(g) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

// S[16 rows of this warp][BN] = A_rows . B_tile^T (f32), over D.
template <int D, int BN>
__device__ void warp_dot_t(const bf16* a, const bf16* b, float* s, int warp) {
  using L = Tile<bf16, D, BN>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[L::BN / 16];
#pragma unroll
  for (int j = 0; j < L::BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + warp * 16 * L::LDT + kk, L::LDT);
#pragma unroll
    for (int j = 0; j < L::BN / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + j * 16 * L::LDT + kk, L::LDT);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < L::BN / 16; ++j) {
    wmma::store_matrix_sync(s + warp * 16 * L::LDS + j * 16, acc[j], L::LDS,
                            wmma::mem_row_major);
  }
}

template <int D, int BN>
__device__ void warp_dot_t(const float* a, const float* b, float* s, int warp) {
  using L = Tile<float, D, BN>;
  const int lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1);
  const int h = lane & 1;  // this lane's columns: h, h + 2, h + 4, ...
  float acc[L::BN / 2];
#pragma unroll
  for (int j = 0; j < L::BN / 2; ++j) acc[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float av = a[r * L::LDT + d];
#pragma unroll
    for (int j = 0; j < L::BN / 2; ++j) acc[j] += av * b[(h + 2 * j) * L::LDT + d];
  }
#pragma unroll
  for (int j = 0; j < L::BN / 2; ++j) s[r * L::LDS + h + 2 * j] = acc[j];
}

// O[16 rows of this warp][D] += P_rows . B_tile, O f32 in shared memory.
template <int D, int BN>
__device__ void warp_accumulate(const bf16* p, const bf16* b, float* o, int warp) {
  using L = Tile<bf16, D, BN>;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* out = o + warp * 16 * L::LDO + j * 16;
    wmma::load_matrix_sync(acc, out, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < L::BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, p + warp * 16 * L::LDP + kk, L::LDP);
      wmma::load_matrix_sync(fb, b + kk * L::LDT + j * 16, L::LDT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out, acc, L::LDO, wmma::mem_row_major);
  }
}

template <int D, int BN>
__device__ void warp_accumulate(const float* p, const float* b, float* o, int warp) {
  using L = Tile<float, D, BN>;
  const int lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1);
  const int h = lane & 1;  // this lane's columns: h, h + 2, h + 4, ...
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = o[r * L::LDO + h + 2 * j];
  for (int c = 0; c < L::BN; ++c) {
    const float pv = p[r * L::LDP + c];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] += pv * b[c * L::LDT + h + 2 * j];
  }
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[r * L::LDO + h + 2 * j] = acc[j];
}

}  // namespace attention
}  // namespace progen
