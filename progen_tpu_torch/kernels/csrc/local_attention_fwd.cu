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

#include "attention_tile.cuh"
#include "common.cuh"

namespace {

using namespace nvcuda;
using progen::bf16;
using progen::from_f;
using progen::Pad;
using namespace progen::attention;

constexpr int BN = 64;              // keys per tile
constexpr float M_INIT = -1e30f;    // finite, so exp(M_INIT - M_INIT) = 1

// Shared-memory layout, in bytes from the start.
template <typename T, int D>
struct Layout : Tile<T, D, BN> {
  using L = Tile<T, D, BN>;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(T) * BM * L::LDT;
  static constexpr size_t v = k + sizeof(T) * BN * L::LDT;
  static constexpr size_t p = v + sizeof(T) * BN * L::LDT;
  static constexpr size_t s = p + sizeof(T) * BM * L::LDP;
  static constexpr size_t o = s + sizeof(float) * BM * L::LDS;
  static constexpr size_t l = o + sizeof(float) * BM * L::LDO;
  static constexpr size_t bytes = l + sizeof(float) * BM;
};

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

  load_rows<T, D, BM>(qs, q + base, q0, seq);
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
    load_rows<T, D, BN>(ks, k + base, kt - wsz, seq);
    load_rows<T, D, BN>(vs, v + base, kt - wsz, seq);
    __syncthreads();

    warp_dot_t<D, BN>(qs, ks, ss, warp);
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

    warp_accumulate<D, BN>(ps, vs, os, warp);
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
