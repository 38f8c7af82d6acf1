// Causal spatial gating unit, backward, for Hopper (sm_90a): the gradients
// of out = res * cast(tril(W) . gate + b) that the TPU computes in kernels.
//
// sgu_bwd_dgate replaces progen_tpu/ops/pallas_sgu.py:_dgate_kernel
// (launched by _backward_dgate):  d_gate = tril(W)^T . (dout * res), with
// dout * res rounded to the compute dtype before the f32 product
// (pallas_sgu.py:162) and the sum cast once to dout's dtype.
//
// sgu_bwd_dw replaces pallas_sgu.py:_dw_kernel (launched by _backward_dw):
// d_W = tril(sum_b (dout * res)_b . gate_b^T), the batch a reduction axis
// inside the kernel, the sum in f32 and cast once to W's dtype, the whole
// strict upper triangle exactly 0 (pallas_sgu.py:298-300).
//
// d_res is the forward kernel with dout in place of res and d_b a plain
// reduction, as in the TPU package (pallas_sgu.py:316-335).
//
// What bounds them on this card: at ProGen-small (B = 8, n = 1024,
// d = 2048) each reads dout, res and gate or W once (~100 MB in bf16) for
// ~17 GFLOP of triangle work, ~170 flops per byte, under the H100's ~295
// flops/byte ridge: the bytes, if only just.
//
// Design: the forward's tiles (sgu_tile.cuh).  dgate takes one block per
// (64 gate rows, 128 channels, batch row); the block walks the row tiles
// i >= its own of W, loading each W tile transposed with the tril applied
// and dout * res rounded as it is loaded, so the product never reaches
// device memory.  dW takes one block per (64, 64) tile of the lower
// triangle and loops over the batch and 64-channel steps, so the batch sum
// stays in registers and no atomics are needed; a block of the strict upper
// triangle only writes zeros, and a diagonal block zeroes its upper half.
// bf16 multiplies on the tensor cores through WMMA, f32 by FMA loops.
// Nothing is pipelined: wgmma and TMA are later work.

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

// dout * res for the VEC elements of one 16-byte vector, each product
// rounded to T (an f32 product of two bf16 values is exact, so this is the
// correctly rounded bf16 product).
template <typename T>
__device__ __forceinline__ uint4 mul_vec(uint4 a, uint4 b) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
  uint4 out;
  T* z = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int e = 0; e < VEC; ++e) z[e] = from_f<T>(to_f(x[e]) * to_f(y[e]));
  return out;
}

// Copy a (ROWS, COLS) tile of dout * res (or of one tensor, when b is
// null) starting at (r0, c0) of a (rows, d) matrix into shared memory with
// row stride ld; out-of-range rows and columns are zeros.
template <typename T, int ROWS, int COLS>
__device__ void load_tile(T* dst, int ld, const T* a, const T* b, int r0, int c0,
                          int rows, int d) {
  constexpr int VEC = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < ROWS * (COLS / VEC); idx += THREADS) {
    const int r = idx / (COLS / VEC);
    const int c = (idx % (COLS / VEC)) * VEC;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && c0 + c < d) {
      const size_t at = static_cast<size_t>(row) * d + c0 + c;
      val = *reinterpret_cast<const uint4*>(a + at);
      if (b != nullptr) val = mul_vec<T>(val, *reinterpret_cast<const uint4*>(b + at));
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// -- d_gate -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
sgu_dgate_kernel(const T* __restrict__ w, const T* __restrict__ dout,
                 const T* __restrict__ res, T* __restrict__ dgate, int n, int d) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem + L::w);
  T* gs = reinterpret_cast<T*>(smem + L::g);
  float* cs = reinterpret_cast<float*>(smem + L::c);

  const int c0 = blockIdx.x * TN;
  const int j0 = blockIdx.y * TM;  // output rows: gate positions
  const size_t batch = static_cast<size_t>(blockIdx.z) * n * d;
  const T zero = from_f<T>(0.0f);

  Acc<T> acc;
  acc.zero();
  // causal: gate row j is read by rows i >= j of W, so the tiles from the
  // diagonal down
  for (int i0 = j0; i0 < n; i0 += TK) {
    __syncthreads();  // every warp is done with the previous tiles
    // ws[r][c] = W[i0 + c][j0 + r] on and below the diagonal, else 0
    for (int idx = threadIdx.x; idx < TM * TK; idx += THREADS) {
      const int r = idx % TM, c = idx / TM;
      const int i = i0 + c, j = j0 + r;
      ws[r * L::LDW + c] = (i < n && j <= i) ? w[static_cast<size_t>(i) * n + j] : zero;
    }
    load_tile<T, TK, TN>(gs, L::LDG, dout + batch, res + batch, i0, c0, n, d);
    __syncthreads();
    acc.step(ws, gs);
  }
  acc.store(cs);
  __syncthreads();

  for (int idx = threadIdx.x; idx < TM * TN; idx += THREADS) {
    const int r = idx / TN, c = idx % TN;
    const int j = j0 + r, col = c0 + c;
    if (j < n && col < d) {
      dgate[batch + static_cast<size_t>(j) * d + col] = from_f<T>(cs[r * L::LDC + c]);
    }
  }
}

// -- d_W ----------------------------------------------------------------------

constexpr int DT = 64;  // d_W tile: rows m and columns k
constexpr int DK = 64;  // channels per step

template <typename T>
struct DwLayout {
  static constexpr int LD = DK + Pad<T>::v;  // dmix and gate tile rows (T)
  static constexpr int LDC = DT + 4;         // f32 result rows
  static constexpr size_t a = 0;
  static constexpr size_t b = a + sizeof(T) * DT * LD;
  static constexpr size_t c = b + sizeof(T) * DT * LD;
  static constexpr size_t bytes = c + sizeof(float) * DT * LDC;
};

// C[m][k] += sum_c A[m][c] * B[k][c] over one DK step.  bf16: warp w holds
// rows 16w.. in WMMA fragments; f32: an 8x4 register tile per thread (rows
// rg + 8i, columns cg + 16j).
template <typename T> struct DwAcc;

template <> struct DwAcc<bf16> {
  using L = DwLayout<bf16>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[DT / 16];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < DT / 16; ++j) wmma::fill_fragment(f[j], 0.0f);
  }
  __device__ void step(const bf16* as, const bf16* bs) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int kk = 0; kk < DK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, as + warp * 16 * L::LD + kk, L::LD);
#pragma unroll
      for (int j = 0; j < DT / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, bs + j * 16 * L::LD + kk, L::LD);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ void store(float* cs) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < DT / 16; ++j) {
      wmma::store_matrix_sync(cs + warp * 16 * L::LDC + j * 16, f[j], L::LDC,
                              wmma::mem_row_major);
    }
  }
};

template <> struct DwAcc<float> {
  using L = DwLayout<float>;
  float f[8][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
  }
  __device__ void step(const float* as, const float* bs) {
    const int rg = threadIdx.x / 16;
    const int cg = threadIdx.x % 16;
    for (int k = 0; k < DK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[(rg + 8 * i) * L::LD + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[(cg + 16 * j) * L::LD + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) f[i][j] += a[i] * b[j];
    }
  }
  __device__ void store(float* cs) {
    const int rg = threadIdx.x / 16;
    const int cg = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(rg + 8 * i) * L::LDC + cg + 16 * j] = f[i][j];
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
sgu_dw_kernel(const T* __restrict__ dout, const T* __restrict__ res,
              const T* __restrict__ gate, T* __restrict__ dw, int batch, int n,
              int d) {
  using L = DwLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem + L::a);
  T* bs = reinterpret_cast<T*>(smem + L::b);
  float* cs = reinterpret_cast<float*>(smem + L::c);

  const int k0 = blockIdx.x * DT;  // columns: gate positions
  const int m0 = blockIdx.y * DT;  // rows: output positions
  const T zero = from_f<T>(0.0f);

  if (k0 > m0) {  // a tile of the strict upper triangle: exact zeros
    for (int idx = threadIdx.x; idx < DT * DT; idx += THREADS) {
      const int m = m0 + idx / DT, k = k0 + idx % DT;
      if (m < n && k < n) dw[static_cast<size_t>(m) * n + k] = zero;
    }
    return;
  }

  DwAcc<T> acc;
  acc.zero();
  for (int b = 0; b < batch; ++b) {
    const size_t off = static_cast<size_t>(b) * n * d;
    for (int c0 = 0; c0 < d; c0 += DK) {
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<T, DT, DK>(as, L::LD, dout + off, res + off, m0, c0, n, d);
      load_tile<T, DT, DK>(bs, L::LD, gate + off, nullptr, k0, c0, n, d);
      __syncthreads();
      acc.step(as, bs);
    }
  }
  acc.store(cs);
  __syncthreads();

  for (int idx = threadIdx.x; idx < DT * DT; idx += THREADS) {
    const int r = idx / DT, c = idx % DT;
    const int m = m0 + r, k = k0 + c;
    if (m < n && k < n) {
      dw[static_cast<size_t>(m) * n + k] = k <= m ? from_f<T>(cs[r * L::LDC + c]) : zero;
    }
  }
}

template <typename T>
cudaError_t launch_dgate(const void* w, const void* dout, const void* res, void* dgate,
                         int batch, int n, int d, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T>::bytes;
  auto kernel = sgu_dgate_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((d + TN - 1) / TN, (n + TM - 1) / TM, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(dout), static_cast<const T*>(res),
      static_cast<T*>(dgate), n, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* dout, const void* res, const void* gate, void* dw,
                      int batch, int n, int d, cudaStream_t stream) {
  constexpr size_t bytes = DwLayout<T>::bytes;
  auto kernel = sgu_dw_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = (n + DT - 1) / DT;
  dim3 grid(tiles, tiles);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(res), static_cast<const T*>(gate),
      static_cast<T*>(dw), batch, n, d);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int d) {
  return batch <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || batch > 65535;
}

}  // namespace

// w: (n, n); dout, res, dgate: (batch, n, d) contiguous; one dtype, 0 =
// float32, 1 = bfloat16; d a multiple of 8.  Returns the CUDA error code of
// the launch (0 = ok).
extern "C" int sgu_bwd_dgate(const void* w, const void* dout, const void* res,
                             void* dgate, int batch, int n, int d, int dtype,
                             void* stream) {
  if (bad_shape(batch, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dgate<float>(w, dout, res, dgate, batch, n, d, s);
  } else if (dtype == 1) {
    err = launch_dgate<bf16>(w, dout, res, dgate, batch, n, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dout, res, gate: (batch, n, d) contiguous; dw: (n, n); one dtype, as
// above.  Returns the CUDA error code of the launch (0 = ok).
extern "C" int sgu_bwd_dw(const void* dout, const void* res, const void* gate,
                          void* dw, int batch, int n, int d, int dtype,
                          void* stream) {
  if (bad_shape(batch, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dw<float>(dout, res, gate, dw, batch, n, d, s);
  } else if (dtype == 1) {
    err = launch_dw<bf16>(dout, res, gate, dw, batch, n, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
