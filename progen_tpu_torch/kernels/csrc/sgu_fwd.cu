// Causal spatial gating unit, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel progen_tpu/ops/pallas_sgu.py:_fwd_kernel
// (launched by _forward):  out = res * cast(tril(W) . gate + b)  over
// res, gate (B, n, d), W (n, n), b (n, 1), all in the compute dtype.  The
// product accumulates in f32, b is added in f32, the sum is cast to the
// compute dtype and only then multiplied by res: the TPU epilogue's order
// (pallas_sgu.py:144-147), so the mixed tensor never reaches device memory.
//
// What bounds it on this card: at ProGen-small (n = 1024, d = 2048) a batch
// row does n(n+1) d ~ 2.1 GFLOP over ~14 MB (res, gate, out and the lower
// triangle of W), ~150 flops per byte in bf16, under the H100's ~295
// flops/byte ridge, so the bound is the bytes, if only just.
//
// Design: one block of 4 warps per (64 output rows, 128 columns, batch row).
// A row tile walks only the column tiles k <= its own (the causal triangle;
// the TPU's paired-row rectangle grid exists only for its sequential grid),
// and the tril predicate zeroes W above the diagonal as the tile is loaded,
// which only ever bites in the diagonal tile.  Ragged n is zero-filled at
// the edge.  bf16 multiplies on the tensor cores through WMMA (16x16x16,
// f32 accumulate in registers); f32 runs FMA loops with an 8x8 register
// tile per thread, for the comparisons.  Nothing is pipelined: wgmma and
// TMA are later work.

#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"
#include "sgu_tile.cuh"

namespace {

using namespace nvcuda;
using progen::bf16;
using progen::from_f;
using progen::Pad;
using progen::to_f;
using namespace progen::sgu;

template <typename T>
__global__ void __launch_bounds__(THREADS)
sgu_fwd_kernel(const T* __restrict__ res, const T* __restrict__ gate,
               const T* __restrict__ w, const T* __restrict__ bias,
               T* __restrict__ out, int n, int d) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem + L::w);
  T* gs = reinterpret_cast<T*>(smem + L::g);
  float* cs = reinterpret_cast<float*>(smem + L::c);

  const int c0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const size_t batch = static_cast<size_t>(blockIdx.z) * n * d;
  constexpr int VEC = 16 / sizeof(T);
  const T zero = from_f<T>(0.0f);

  Acc<T> acc;
  acc.zero();
  const int k_end = min(m0 + TM, n);  // causal: columns k < k_end only
  for (int k0 = 0; k0 < k_end; k0 += TK) {
    __syncthreads();  // every warp is done with the previous tiles
    for (int idx = threadIdx.x; idx < TM * TK; idx += THREADS) {
      const int r = idx / TK, c = idx % TK;
      const int m = m0 + r, k = k0 + c;
      ws[r * L::LDW + c] = (m < n && k <= m) ? w[static_cast<size_t>(m) * n + k] : zero;
    }
    for (int idx = threadIdx.x; idx < TK * (TN / VEC); idx += THREADS) {
      const int r = idx / (TN / VEC), c = (idx % (TN / VEC)) * VEC;
      const int k = k0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < n && c0 + c < d) {
        val = *reinterpret_cast<const uint4*>(gate + batch + static_cast<size_t>(k) * d + c0 + c);
      }
      *reinterpret_cast<uint4*>(gs + r * L::LDG + c) = val;
    }
    __syncthreads();
    acc.step(ws, gs);
  }
  acc.store(cs);
  __syncthreads();

  for (int idx = threadIdx.x; idx < TM * TN; idx += THREADS) {
    const int r = idx / TN, c = idx % TN;
    const int m = m0 + r, col = c0 + c;
    if (m < n && col < d) {
      const size_t at = batch + static_cast<size_t>(m) * d + col;
      const T mixed = from_f<T>(cs[r * L::LDC + c] + to_f(bias[m]));
      out[at] = from_f<T>(to_f(res[at]) * to_f(mixed));
    }
  }
}

template <typename T>
cudaError_t launch(const void* res, const void* gate, const void* w, const void* b,
                   void* out, int batch, int n, int d, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T>::bytes;
  auto kernel = sgu_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((d + TN - 1) / TN, (n + TM - 1) / TM, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(res), static_cast<const T*>(gate), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), n, d);
  return cudaGetLastError();
}

}  // namespace

// res, gate, out: (batch, n, d) contiguous; w: (n, n); b: (n, 1); all of one
// dtype, 0 = float32, 1 = bfloat16; d must be a multiple of 8.  Returns the
// CUDA error code of the launch (0 = ok).
extern "C" int sgu_fwd(const void* res, const void* gate, const void* w, const void* b,
                       void* out, int batch, int n, int d, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(res, gate, w, b, out, batch, n, d, s);
  } else if (dtype == 1) {
    err = launch<bf16>(res, gate, w, b, out, batch, n, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
