// Windowed causal local attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel progen_tpu/ops/pallas_attention.py:_fwd_kernel
// (launched by _forward_ext).  Query row i of window w = i / wsz attends the
// keys of window w-1 (all of them) and of its own window up to i, scaled by
// `scale`, with an f32 softmax; window 0's previous window is the phantom
// zero window, whose wsz zero logits count in the softmax denominator and
// whose zero values add nothing.  Writes out (B*H, L, D) in the input dtype
// and the per-row logsumexp lse (B*H, L) in f32, which the backward needs.
//
// What bounds it on this card: at ProGen-small (D = 128, wsz = 256) a row
// does 4*D*(wsz + i%wsz + 1) flops, ~196k on average, over 4*D*2 bytes of
// q/k/v/out in bf16: ~190 flops per byte, under the H100's ~295 flops/byte
// ridge, so the bound is the bytes, if not by much.
//
// Design: flash-style.  One block of 4 warps per (b*h, 64 query rows); each
// warp owns 16 rows.  The block walks 64-key tiles over the extended key
// range [window start of its first row - wsz, its last row] in the zero-
// padded layout of the TPU kernel, but the padding is never materialised:
// a key tile row before position 0 is loaded as zeros (the phantom window).
// Keys above a row's diagonal are skipped rather than filled with -1e10;
// the two are exact equals, since every row keeps at least wsz visible
// logits and exp(-1e10 - max) is 0 in f32.  Scores go to shared memory, the
// online softmax runs per row in f32 (two lanes per row), and the f32 output
// accumulator stays in shared memory so that the row rescale is plain
// indexing.  bf16 runs QK^T and PV on the tensor cores through WMMA
// (16x16x16, f32 accumulate); f32 runs FMA loops, for the comparisons.
// Nothing is pipelined: making it fast (wgmma, TMA, a register-resident
// accumulator) is later work.

#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using progen::bf16;
using progen::from_f;
using progen::Pad;

constexpr int BM = 64;              // query rows per block
constexpr int BN = 64;              // keys per tile
constexpr int WARPS = BM / 16;      // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float M_INIT = -1e30f;    // finite, so exp(M_INIT - M_INIT) = 1

// Shared-memory layout, in elements; every region is a multiple of 32 bytes
// so that WMMA fragment pointers stay 256-bit aligned.
template <typename T, int D>
struct Layout {
  static constexpr int LDT = D + Pad<T>::v;   // q, k, v rows (T)
  static constexpr int LDP = BN + Pad<T>::v;  // probability rows (T)
  static constexpr int LDS = BN + 4;          // score rows (f32)
  static constexpr int LDO = D + 4;           // output accumulator rows (f32)
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(T) * BM * LDT;
  static constexpr size_t v = k + sizeof(T) * BN * LDT;
  static constexpr size_t p = v + sizeof(T) * BN * LDT;
  static constexpr size_t s = p + sizeof(T) * BM * LDP;
  static constexpr size_t o = s + sizeof(float) * BM * LDS;
  static constexpr size_t l = o + sizeof(float) * BM * LDO;
  static constexpr size_t bytes = l + sizeof(float) * BM;
};

// Copy rows [r0, r0 + 64) of a (rows, D) matrix into shared memory with
// 16-byte vectors; rows outside [0, rows) are zeros.
template <typename T, int D>
__device__ void load_rows(T* dst, const T* src, int r0, int rows) {
  constexpr int LDT = Layout<T, D>::LDT;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += THREADS) {
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

// S[16 rows of this warp][64 keys] = Q_rows . K_tile^T (unscaled, f32).
template <int D>
__device__ void warp_scores(const bf16* qs, const bf16* ks, float* ss, int warp) {
  using L = Layout<bf16, D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, qs + warp * 16 * L::LDT + kk, L::LDT);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, ks + j * 16 * L::LDT + kk, L::LDT);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::store_matrix_sync(ss + warp * 16 * L::LDS + j * 16, acc[j], L::LDS,
                            wmma::mem_row_major);
  }
}

template <int D>
__device__ void warp_scores(const float* qs, const float* ks, float* ss, int warp) {
  using L = Layout<float, D>;
  const int lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1);
  const int h = lane & 1;  // this lane's keys: h, h + 2, h + 4, ...
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float qv = qs[r * L::LDT + d];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] += qv * ks[(h + 2 * j) * L::LDT + d];
  }
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) ss[r * L::LDS + h + 2 * j] = acc[j];
}

// O[16 rows of this warp][D] += P_rows . V_tile.
template <int D>
__device__ void warp_accumulate(const bf16* ps, const bf16* vs, float* os, int warp) {
  using L = Layout<bf16, D>;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* out = os + warp * 16 * L::LDO + j * 16;
    wmma::load_matrix_sync(acc, out, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, ps + warp * 16 * L::LDP + kk, L::LDP);
      wmma::load_matrix_sync(b, vs + kk * L::LDT + j * 16, L::LDT);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out, acc, L::LDO, wmma::mem_row_major);
  }
}

template <int D>
__device__ void warp_accumulate(const float* ps, const float* vs, float* os, int warp) {
  using L = Layout<float, D>;
  const int lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1);
  const int h = lane & 1;  // this lane's columns: h, h + 2, h + 4, ...
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = os[r * L::LDO + h + 2 * j];
  for (int c = 0; c < BN; ++c) {
    const float pv = ps[r * L::LDP + c];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] += pv * vs[c * L::LDT + h + 2 * j];
  }
#pragma unroll
  for (int j = 0; j < D / 2; ++j) os[r * L::LDO + h + 2 * j] = acc[j];
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
local_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int seq, int wsz, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  T* ps = reinterpret_cast<T*>(smem + L::p);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* os = reinterpret_cast<float*>(smem + L::o);
  float* ls = reinterpret_cast<float*>(smem + L::l);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * D;

  load_rows<T, D>(qs, q + base, q0, seq);
  for (int idx = threadIdx.x; idx < BM * L::LDO; idx += THREADS) os[idx] = 0.0f;

  // this lane's query row and its visible keys, in extended coordinates
  // (extended key e is sequence position e - wsz; e < wsz is the phantom)
  const int r = warp * 16 + (lane >> 1);
  const int h = lane & 1;
  const int i = q0 + r;
  const bool live = i < seq;
  const int lo = (i / wsz) * wsz;
  const int hi = i + wsz;
  float m_i = M_INIT;
  float l_i = 0.0f;

  const int k_first = (q0 / wsz) * wsz;
  const int k_last = min(q0 + BM, seq) - 1 + wsz;
  for (int kt = k_first; kt <= k_last; kt += BN) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_rows<T, D>(ks, k + base, kt - wsz, seq);
    load_rows<T, D>(vs, v + base, kt - wsz, seq);
    __syncthreads();

    warp_scores<D>(qs, ks, ss, warp);
    __syncwarp();

    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int c = h + 2 * j;
      const int e = kt + c;
      if (live && e >= lo && e <= hi) tile_max = fmaxf(tile_max, ss[r * L::LDS + c] * scale);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m_i, tile_max);
    const float alpha = expf(m_i - m_new);
    float tile_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int c = h + 2 * j;
      const int e = kt + c;
      float p = 0.0f;
      if (live && e >= lo && e <= hi) p = expf(ss[r * L::LDS + c] * scale - m_new);
      ps[r * L::LDP + c] = from_f<T>(p);
      tile_sum += p;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    l_i = l_i * alpha + tile_sum;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) os[r * L::LDO + h + 2 * j] *= alpha;
    __syncwarp();

    warp_accumulate<D>(ps, vs, os, warp);
  }

  __syncwarp();
  if (h == 0) {
    ls[r] = l_i;
    if (live) lse[static_cast<size_t>(blockIdx.y) * seq + i] = m_i + logf(l_i);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    const int g = q0 + row;
    if (g >= seq) break;
    const float denom = ls[row];
    for (int c = lane; c < D; c += 32) {
      out[base + static_cast<size_t>(g) * D + c] = from_f<T>(os[row * L::LDO + c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int bh, int seq, int wsz, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::bytes;
  auto kernel = local_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BM - 1) / BM, bh);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), seq, wsz, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, void* lse,
                     int bh, int seq, int dim_head, int wsz, float scale,
                     cudaStream_t stream) {
  switch (dim_head) {
    case 32: return launch<T, 32>(q, k, v, out, lse, bh, seq, wsz, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, seq, wsz, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, seq, wsz, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (bh, seq, dim_head) contiguous, dtype 0 = float32, 1 = bfloat16;
// lse: (bh, seq) float32.  Returns the CUDA error code of the launch (0 = ok).
extern "C" int local_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int bh, int seq,
                                   int dim_head, int wsz, float scale, int dtype,
                                   void* stream) {
  if (bh <= 0 || seq <= 0 || wsz <= 0 || seq % wsz != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, out, lse, bh, seq, dim_head, wsz, scale, s);
  } else if (dtype == 1) {
    err = dispatch<bf16>(q, k, v, out, lse, bh, seq, dim_head, wsz, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
