// Windowed causal local attention, backward, for Hopper (sm_90a).
//
// local_attention_bwd_dq replaces progen_tpu/ops/pallas_attention.py:
// _dq_kernel and local_attention_bwd_dkv replaces _dkv_kernel (both
// launched by _backward_ext).  With the forward's per-row f32 logsumexp lse
// and D = rowsum(dout * out) in f32 (computed outside, as the TPU package
// does), the probabilities are recomputed as p = exp(s * scale - lse) and
//   ds = p * (dout . v^T - D),
//   dq = scale * ds . k,   dk = scale * ds^T . q,   dv = p^T . dout,
// with p cast to dout's dtype and ds to q's (k's) dtype before the second
// products, every product accumulated in f32 and each gradient cast once
// (pallas_attention.py:136-149, 171-191).  Query row i sees the keys of its
// own window up to i and all of the previous one; window 0's previous
// window is the phantom zero window, whose zero logits are in the forward's
// lse.  Its keys add nothing to dq (they are zeros) and its dk/dv are
// dropped (jnp.pad's VJP drops them), so the kernels write (B*H, L, D)
// gradients of the real keys only.
//
// What bounds them on this card: at ProGen-small (B = 8, H = 8, L = 1024,
// D = 128, wsz = 256) each reads q, k, v, dout (and writes one or two
// gradients) once, ~84-101 MB in bf16, for ~19-26 GFLOP of visible-key
// work: ~230-260 flops per byte, under the H100's ~295 flops/byte ridge, so
// the bound is the bytes, if not by much.
//
// Design: one block of 4 warps owns 64 rows, each warp 16 of them: query
// rows for dq, key rows for dkv.  The block streams tiles of the other
// side (keys for dq, queries for dkv; 64 rows in bf16, 32 in f32, so the
// f32 tiles fit in shared memory at D = 128) and skips the tiles that no
// row of the block sees; visibility is decided per element, since a 64-row
// tile can straddle windows when wsz < 64.  Both products of a step
// (s = q.k^T and dp = dout.v^T, or their transposes for dkv) go to shared
// memory in f32, p and ds are formed per element, and the f32 gradient
// accumulators stay in shared memory.  bf16 runs the products on the tensor
// cores through WMMA (16x16x16, f32 accumulate); f32 runs FMA loops, for
// the comparisons.  Nothing is pipelined: wgmma, TMA and register-resident
// accumulators are later work.

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

// Rows of the other side streamed per step: 64 in bf16, 32 in f32, so the
// f32 tiles fit in shared memory at D = 128.
template <typename T> struct Stream { static constexpr int v = 64; };
template <> struct Stream<float> { static constexpr int v = 32; };

template <typename T, int D>
using BwdTile = Tile<T, D, Stream<T>::v>;

// Write rows [r0, r0 + BM) of a (rows, D) gradient from the f32 accumulator,
// times `mul`, cast once.  Each warp writes the 16 rows it accumulated.
template <typename T, int D>
__device__ void store_rows(T* dst, const float* o, int r0, int rows, float mul, int warp) {
  using L = BwdTile<T, D>;
  const int lane = threadIdx.x & 31;
  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    const int g = r0 + row;
    if (g >= rows) break;
    for (int c = lane; c < D; c += 32) {
      dst[static_cast<size_t>(g) * D + c] = from_f<T>(o[row * L::LDO + c] * mul);
    }
  }
}

// -- dq -----------------------------------------------------------------------

template <typename T, int D>
struct DqLayout {
  using L = BwdTile<T, D>;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + sizeof(T) * BM * L::LDT;
  static constexpr size_t k = dout + sizeof(T) * BM * L::LDT;
  static constexpr size_t v = k + sizeof(T) * L::BN * L::LDT;
  static constexpr size_t s = v + sizeof(T) * L::BN * L::LDT;
  static constexpr size_t dp = s + sizeof(float) * BM * L::LDS;
  static constexpr size_t ds = dp + sizeof(float) * BM * L::LDS;
  static constexpr size_t o = ds + sizeof(T) * BM * L::LDP;
  static constexpr size_t bytes = o + sizeof(float) * BM * L::LDO;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
local_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          T* __restrict__ dq, int seq, int wsz, float scale) {
  using L = BwdTile<T, D>;
  using S = DqLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + S::q);
  T* dos = reinterpret_cast<T*>(smem + S::dout);
  T* ks = reinterpret_cast<T*>(smem + S::k);
  T* vs = reinterpret_cast<T*>(smem + S::v);
  float* ss = reinterpret_cast<float*>(smem + S::s);
  float* dps = reinterpret_cast<float*>(smem + S::dp);
  T* dss = reinterpret_cast<T*>(smem + S::ds);
  float* os = reinterpret_cast<float*>(smem + S::o);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seq;
  const size_t base = row0 * D;

  load_rows<T, D, BM>(qs, q + base, q0, seq);
  load_rows<T, D, BM>(dos, dout + base, q0, seq);
  for (int idx = threadIdx.x; idx < BM * L::LDO; idx += THREADS) os[idx] = 0.0f;

  // this lane's query row and its visible keys, in extended coordinates
  // (extended key e is sequence position e - wsz; e < wsz is the phantom)
  const int r = warp * 16 + (lane >> 1);
  const int h = lane & 1;
  const int i = q0 + r;
  const bool live = i < seq;
  const int lo = (i / wsz) * wsz;
  const int hi = i + wsz;
  const float lse_i = live ? lse[row0 + i] : 0.0f;
  const float dd_i = live ? dd[row0 + i] : 0.0f;

  const int k_first = (q0 / wsz) * wsz;
  const int k_last = min(q0 + BM, seq) - 1 + wsz;
  for (int kt = k_first; kt <= k_last; kt += L::BN) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_rows<T, D, L::BN>(ks, k + base, kt - wsz, seq);
    load_rows<T, D, L::BN>(vs, v + base, kt - wsz, seq);
    __syncthreads();

    warp_dot_t<D, L::BN>(qs, ks, ss, warp);
    warp_dot_t<D, L::BN>(dos, vs, dps, warp);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < L::BN / 2; ++j) {
      const int c = h + 2 * j;
      const int e = kt + c;
      float ds = 0.0f;
      if (live && e >= lo && e <= hi) {
        const float p = expf(ss[r * L::LDS + c] * scale - lse_i);
        ds = p * (dps[r * L::LDS + c] - dd_i);
      }
      dss[r * L::LDP + c] = from_f<T>(ds);
    }
    __syncwarp();
    warp_accumulate<D, L::BN>(dss, ks, os, warp);
  }
  __syncwarp();
  store_rows<T, D>(dq + base, os, q0, seq, scale, warp);
}

// -- dk, dv -------------------------------------------------------------------

template <typename T, int D>
struct DkvLayout {
  using L = BwdTile<T, D>;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + sizeof(T) * BM * L::LDT;
  static constexpr size_t q = v + sizeof(T) * BM * L::LDT;
  static constexpr size_t dout = q + sizeof(T) * L::BN * L::LDT;
  static constexpr size_t s = dout + sizeof(T) * L::BN * L::LDT;
  static constexpr size_t dp = s + sizeof(float) * BM * L::LDS;
  static constexpr size_t p = dp + sizeof(float) * BM * L::LDS;
  static constexpr size_t ds = p + sizeof(T) * BM * L::LDP;
  static constexpr size_t dk = ds + sizeof(T) * BM * L::LDP;
  static constexpr size_t dv = dk + sizeof(float) * BM * L::LDO;
  static constexpr size_t lse = dv + sizeof(float) * BM * L::LDO;
  static constexpr size_t dd = lse + sizeof(float) * L::BN;
  static constexpr size_t bytes = dd + sizeof(float) * L::BN;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
local_attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dd,
                           T* __restrict__ dk, T* __restrict__ dv, int seq, int wsz,
                           float scale) {
  using L = BwdTile<T, D>;
  using S = DkvLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + S::k);
  T* vs = reinterpret_cast<T*>(smem + S::v);
  T* qs = reinterpret_cast<T*>(smem + S::q);
  T* dos = reinterpret_cast<T*>(smem + S::dout);
  float* ss = reinterpret_cast<float*>(smem + S::s);
  float* dps = reinterpret_cast<float*>(smem + S::dp);
  T* ps = reinterpret_cast<T*>(smem + S::p);
  T* dss = reinterpret_cast<T*>(smem + S::ds);
  float* dks = reinterpret_cast<float*>(smem + S::dk);
  float* dvs = reinterpret_cast<float*>(smem + S::dv);
  float* lses = reinterpret_cast<float*>(smem + S::lse);
  float* dds = reinterpret_cast<float*>(smem + S::dd);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BM;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seq;
  const size_t base = row0 * D;

  load_rows<T, D, BM>(ks, k + base, k0, seq);
  load_rows<T, D, BM>(vs, v + base, k0, seq);
  for (int idx = threadIdx.x; idx < BM * L::LDO; idx += THREADS) {
    dks[idx] = 0.0f;
    dvs[idx] = 0.0f;
  }

  // this lane's key row j: its users are the queries i >= j of its own
  // window (causal) and every query of the next window
  const int r = warp * 16 + (lane >> 1);
  const int h = lane & 1;
  const int j = k0 + r;
  const bool live = j < seq;
  const int i_end_j = (j / wsz + 2) * wsz;

  const int i_end = min(((min(k0 + BM, seq) - 1) / wsz + 2) * wsz, seq);
  for (int it = k0; it < i_end; it += L::BN) {
    __syncthreads();  // every warp is done with the previous q/dout tile
    load_rows<T, D, L::BN>(qs, q + base, it, seq);
    load_rows<T, D, L::BN>(dos, dout + base, it, seq);
    for (int idx = threadIdx.x; idx < L::BN; idx += THREADS) {
      const int g = it + idx;
      lses[idx] = g < seq ? lse[row0 + g] : 0.0f;
      dds[idx] = g < seq ? dd[row0 + g] : 0.0f;
    }
    __syncthreads();

    warp_dot_t<D, L::BN>(ks, qs, ss, warp);    // s^T: key rows x query columns
    warp_dot_t<D, L::BN>(vs, dos, dps, warp);  // dp^T
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < L::BN / 2; ++jj) {
      const int c = h + 2 * jj;
      const int i = it + c;
      float p = 0.0f;
      float ds = 0.0f;
      if (live && i < seq && i >= j && i < i_end_j) {
        p = expf(ss[r * L::LDS + c] * scale - lses[c]);
        ds = p * (dps[r * L::LDS + c] - dds[c]);
      }
      ps[r * L::LDP + c] = from_f<T>(p);
      dss[r * L::LDP + c] = from_f<T>(ds);
    }
    __syncwarp();
    warp_accumulate<D, L::BN>(ps, dos, dvs, warp);
    warp_accumulate<D, L::BN>(dss, qs, dks, warp);
  }
  __syncwarp();
  store_rows<T, D>(dk + base, dks, k0, seq, scale, warp);
  store_rows<T, D>(dv + base, dvs, k0, seq, 1.0f, warp);
}

// -- launch -------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dd, void* dq, int bh, int seq,
                      int wsz, float scale, cudaStream_t stream) {
  constexpr size_t bytes = DqLayout<T, D>::bytes;
  auto kernel = local_attention_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BM - 1) / BM, bh);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dq), seq, wsz, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dd, void* dk, void* dv, int bh,
                       int seq, int wsz, float scale, cudaStream_t stream) {
  constexpr size_t bytes = DkvLayout<T, D>::bytes;
  auto kernel = local_attention_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BM - 1) / BM, bh);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dk), static_cast<T*>(dv), seq,
      wsz, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* dd, void* dq, int bh, int seq,
                        int dim_head, int wsz, float scale, cudaStream_t s) {
  switch (dim_head) {
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, dd, dq, bh, seq, wsz, scale, s);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, dd, dq, bh, seq, wsz, scale, s);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, dd, dq, bh, seq, wsz, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dd, void* dk, void* dv, int bh,
                         int seq, int dim_head, int wsz, float scale, cudaStream_t s) {
  switch (dim_head) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s);
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int seq, int wsz) {
  return bh <= 0 || bh > 65535 || seq <= 0 || wsz <= 0 || seq % wsz != 0;
}

}  // namespace

// q, k, v, dout, dq: (bh, seq, dim_head) contiguous, dtype 0 = float32,
// 1 = bfloat16; lse (the forward's) and dd = rowsum(dout * out): (bh, seq)
// float32.  Returns the CUDA error code of the launch (0 = ok).
extern "C" int local_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dd,
                                      void* dq, int bh, int seq, int dim_head, int wsz,
                                      float scale, int dtype, void* stream) {
  if (bad_shape(bh, seq, wsz)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dq<float>(q, k, v, dout, lse, dd, dq, bh, seq, dim_head, wsz, scale, s);
  } else if (dtype == 1) {
    err = dispatch_dq<bf16>(q, k, v, dout, lse, dd, dq, bh, seq, dim_head, wsz, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As above, writing dk and dv, (bh, seq, dim_head) each, of the real keys.
extern "C" int local_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dd,
                                       void* dk, void* dv, int bh, int seq, int dim_head,
                                       int wsz, float scale, int dtype, void* stream) {
  if (bad_shape(bh, seq, wsz)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dkv<float>(q, k, v, dout, lse, dd, dk, dv, bh, seq, dim_head, wsz,
                              scale, s);
  } else if (dtype == 1) {
    err = dispatch_dkv<bf16>(q, k, v, dout, lse, dd, dk, dv, bh, seq, dim_head, wsz,
                             scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
