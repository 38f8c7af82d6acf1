// Ragged paged gate mix for Hopper (sm_90a): the decode step's spatial-gate
// contraction over gate rows that live in a global page pool.
//
// Replaces the TPU kernels progen_tpu/ops/pallas_paged_attention.py:
// _mix_kernel (launched by _pallas_mix) and _mix_kernel_q8 (launched by
// _pallas_mix_q8).  For batch row b at position pos_b:
//
//   out[b] = sum_{i <= pos_b} W[pos_b, i] * pool[table[b, i / ps], i % ps]
//            + bias[pos_b]
//
// with W (n, n), bias (n, 1) f32, pool (num_pages, ps, d), table (B, ppr)
// int32, pos (B,) int32, out (B, d) f32.  The q8 entry point takes W as int8
// with one f32 scale per weight ROW and/or the pool as int8 with one f32
// scale per pool ROW; both are widened to f32 and scaled before the product,
// as the TPU kernel does, so nothing 8-bit passes through device memory at a
// higher precision.  The full-precision entry point is its own instantiation
// and never multiplies by a scale.
//
// What bounds it on this card: the bytes.  At ProGen-small with 8 rows near
// position 1023 it reads 8 x 1024 x 2048 bf16 pool values (33.6 MB) for 0.03
// GFLOP, about one flop per byte against the H100's ~295.
//
// Design.  The TPU grid (B, pages_per_row) with a carried accumulator and
// skipped pages becomes one block per (batch row, 128-channel tile) that
// loops over the row's own pos_b + 1 pool rows and nothing else: a short
// request costs what it holds.  pos and the table are plain int32 loads.
// The loop bound is the causal mask: rows past pos_b are never read, so a
// stale row in a reused page, or garbage in the write-sink page, cannot reach
// the sum, and W is never read at a column >= n even when ppr * ps > n.  A
// table entry outside the pool is skipped.  Within a block each of 16 warps
// takes every 16th pool row; a lane loads 4 neighbouring channels (16 bytes
// of f32, 8 of bf16, 4 of int8) and keeps 4 f32 sums; the warps' partial
// sums meet in shared memory, and the bias is added in f32 in the epilogue.
// The summation order therefore differs from the plain version's.  Nothing
// is pipelined or split across blocks along the row axis: later work.

#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

using progen::bf16;

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 4;            // channels per lane
constexpr int TILE = 32 * VEC;    // channels per block

__device__ __forceinline__ float weight_f(float x) { return x; }
__device__ __forceinline__ float weight_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void load4(const float* p, float (&x)[VEC]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&x)[VEC]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[VEC]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = static_cast<float>(v.x); x[1] = static_cast<float>(v.y);
  x[2] = static_cast<float>(v.z); x[3] = static_cast<float>(v.w);
}

template <typename WT, typename PT, bool SCALED>
__global__ void __launch_bounds__(THREADS)
paged_gate_mix_kernel(const WT* __restrict__ w, const float* __restrict__ bias,
                      const PT* __restrict__ pool, const int* __restrict__ table,
                      const int* __restrict__ pos, const float* __restrict__ w_scale,
                      const float* __restrict__ pool_scale, float* __restrict__ out,
                      int n, int d, int ps, int ppr, int num_pages) {
  __shared__ float part[WARPS][TILE];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * TILE + lane * VEC;
  const int p = pos[b];
  const int row = min(max(p, 0), n - 1);           // weight row and bias entry
  const int last = min(min(p, n - 1), ppr * ps - 1);  // pool rows 0..last count
  const int* trow = table + static_cast<size_t>(b) * ppr;
  const WT* wrow = w + static_cast<size_t>(row) * n;
  float ws = 1.0f;
  if (SCALED && w_scale != nullptr) ws = w_scale[row];

  float acc[VEC] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c < d) {
#pragma unroll 4
    for (int i = warp; i <= last; i += WARPS) {
      const int page = trow[i / ps];
      if (static_cast<unsigned>(page) >= static_cast<unsigned>(num_pages)) continue;
      const size_t r = static_cast<size_t>(page) * ps + (i % ps);
      float wv = weight_f(wrow[i]);
      if (SCALED) wv *= ws;
      float x[VEC];
      load4(pool + r * d + c, x);
      if (SCALED && pool_scale != nullptr) {
        const float s = pool_scale[r];
#pragma unroll
        for (int k = 0; k < VEC; ++k) x[k] *= s;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wv, x[k], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) part[warp][lane * VEC + k] = acc[k];
  __syncthreads();

  const int col = blockIdx.x * TILE + threadIdx.x;
  if (threadIdx.x < TILE && col < d) {
    float sum = 0.0f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) sum += part[wi][threadIdx.x];
    out[static_cast<size_t>(b) * d + col] = sum + bias[row];
  }
}

template <typename WT, typename PT, bool SCALED>
cudaError_t launch(const void* w, const void* bias, const void* pool, const void* table,
                   const void* pos, const void* w_scale, const void* pool_scale, void* out,
                   int batch, int n, int d, int ps, int ppr, int num_pages,
                   cudaStream_t stream) {
  dim3 grid((d + TILE - 1) / TILE, batch);
  paged_gate_mix_kernel<WT, PT, SCALED><<<grid, THREADS, 0, stream>>>(
      static_cast<const WT*>(w), static_cast<const float*>(bias),
      static_cast<const PT*>(pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<const float*>(w_scale),
      static_cast<const float*>(pool_scale), static_cast<float*>(out), n, d, ps, ppr,
      num_pages);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int d, int ps, int ppr, int num_pages) {
  return batch <= 0 || batch > 65535 || n <= 0 || d <= 0 || d % VEC != 0 || ps <= 0 ||
         ppr <= 0 || num_pages <= 0;
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16, 2 = int8.  All tensors contiguous;
// d must be a multiple of 4.  Each returns the CUDA error code of the launch
// (0 = ok).

// K3: w (n, n) f32, bias (n, 1) f32, pool (num_pages, ps, d) f32 or bf16,
// table (batch, ppr) int32, pos (batch,) int32, out (batch, d) f32.
extern "C" int paged_gate_mix(const void* w, const void* bias, const void* pool,
                              const void* table, const void* pos, void* out, int batch,
                              int n, int d, int ps, int ppr, int num_pages,
                              int pool_dtype, void* stream) {
  if (bad_shape(batch, n, d, ps, ppr, num_pages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (pool_dtype == 0) {
    err = launch<float, float, false>(w, bias, pool, table, pos, nullptr, nullptr, out,
                                      batch, n, d, ps, ppr, num_pages, s);
  } else if (pool_dtype == 1) {
    err = launch<float, bf16, false>(w, bias, pool, table, pos, nullptr, nullptr, out,
                                     batch, n, d, ps, ppr, num_pages, s);
  }
  return static_cast<int>(err);
}

// K3-q8: as K3, with w f32 or int8 (then w_scale (n,) f32, else null) and the
// pool f32, bf16 or int8 (then pool_scale (num_pages, ps) f32, else null); at
// least one side is int8.
extern "C" int paged_gate_mix_q8(const void* w, const void* bias, const void* pool,
                                 const void* table, const void* pos, const void* w_scale,
                                 const void* pool_scale, void* out, int batch, int n, int d,
                                 int ps, int ppr, int num_pages, int w_dtype,
                                 int pool_dtype, void* stream) {
  if (bad_shape(batch, n, d, ps, ppr, num_pages) ||
      (w_dtype == 2) != (w_scale != nullptr) ||
      (pool_dtype == 2) != (pool_scale != nullptr) ||
      (w_dtype != 2 && pool_dtype != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define PROGEN_Q8_CASE(WD, PD, WT, PT)                                                   \
  if (w_dtype == WD && pool_dtype == PD) {                                               \
    err = launch<WT, PT, true>(w, bias, pool, table, pos, w_scale, pool_scale, out,      \
                               batch, n, d, ps, ppr, num_pages, s);                      \
  }
  PROGEN_Q8_CASE(2, 2, int8_t, int8_t)
  PROGEN_Q8_CASE(2, 1, int8_t, bf16)
  PROGEN_Q8_CASE(2, 0, int8_t, float)
  PROGEN_Q8_CASE(0, 2, float, int8_t)
#undef PROGEN_Q8_CASE
  return static_cast<int>(err);
}
