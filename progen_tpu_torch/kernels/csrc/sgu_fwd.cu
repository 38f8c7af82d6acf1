// Causal spatial gating unit, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel progen_tpu/ops/pallas_sgu.py:_fwd_kernel
// (launched by _forward):  out = res * cast(tril(W) . gate + b)  over
// res, gate (B, n, d), W (n, n), b (n, 1), all in the compute dtype.  The
// product accumulates in f32, b is added in f32, the sum is cast to the
// compute dtype and only then multiplied by res: the TPU epilogue's order
// (pallas_sgu.py:144-147), so the mixed tensor never reaches device memory.
// W's upper triangle is not zero in the model's parameters: the kernel
// masks it.
//
// What bounds it on this card: at ProGen-small (n = 1024, d = 2048) a batch
// row does n(n+1) d ~ 2.1 GFLOP over ~14 MB (res, gate, out and the lower
// triangle of W), ~150 flops per byte in bf16, under the H100's ~295
// flops/byte ridge, so the bound is the bytes (0.0153 ms at B = 4), if only
// just (8.6 GFLOP, 0.0087 ms at the bf16 peak).
//
// Three routes, under their own extern "C" names; cuda_sgu.fwd_route picks
// one from the dtype before the launch (bf16 "wgmma", f32 "tf32x3"):
//
// "wgmma" (sgu_fwd_wgmma, bf16): K2-dgate's machinery (sgu_bwd.cu) pointed
// the other way.  288 threads: two consumer warpgroups of 64 output rows m
// and a producer warp whose one thread issues the copies.  A block owns one
// (batch row, 128 rows m, 128 channels) output tile and walks the 64-deep k
// steps of the triangle only, k < m0 + 128: a ring of 2 stages of
// 128-byte-swizzled TMA tiles, W's two (64 m, 64 k) boxes (the K-major A
// operand of each warpgroup) and gate's two (64 k, 64 channels) boxes (the
// N-major B operand).  wgmma m64n128k16 runs from shared memory, f32
// accumulators in registers; the stage of step t is released when step
// t + 1's products are issued.  A warpgroup's diagonal step has the strict
// upper part (k > m) of its W box zeroed in shared memory, then
// fence.proxy.async, as K2-dgate does; the step after it is skipped.  res's
// (128, 128) tile arrives by TMA during the walk.  The epilogue runs in
// registers, in the TPU's order, bf16(f32 acc + f32(b[m])) then the bf16
// product with res, written in place over res's tile and stored with
// 16-byte stores.  Two blocks fit an SM (94 registers a thread, 99,368 B
// of shared memory each), so one block's epilogue and prologue run beside
// the other's products (kernels.ablate times it against one block of four
// stages and a producer warpgroup, variant one_block).  Work per row
// tile grows along the triangle, from 2 to 2 n / 128 steps, so blocks run
// longest first (cuda_sgu.k2_fwd_tiles mirrors the order).  Ragged n is
// zero-filled by TMA; W's rows must be ceil8(n) elements apart (the wrapper
// pads W), d % 8 == 0 and 16-byte-aligned tensors are required.  Each
// output element is written once: no atomics, the same bits every run.
//
// "tf32x3" (sgu_fwd_tf32x3, f32): the product on the tensor cores to close
// to f32 accuracy as three TF32 products (tf32x3.cuh), so its bound is
// 3 x FLOPs / 495 TFLOP/s (0.104 ms at B = 8), not the bytes.  256 threads,
// two blocks an SM; a block owns the bf16 route's (batch row, 128 rows m,
// 128 channels) tile in the same longest-first order (fw::block_tile) and
// walks the 32-deep k steps of the triangle, k < min(m0 + 128, n): a ring
// of 2 cp.async stages, W's (128 m, 32 k) tile in rows of 36 words and
// gate's (32 k, 128 channels) tile in rows of 136 (so that the (k, n) B
// loads, rows t and t + 4, fall in distinct banks), rows past n and
// channels past d zero-filled.  Each warp owns 64 rows x 32 channels: per
// 8-deep slice it splits 4 B fragments and, one at a time, 4 A fragments,
// each feeding 12 mma.sync m16n8k8 (three products on four accumulators),
// so a split value feeds 4 (A) or 12 (B) products.  A warp's steps wholly
// below its rows' diagonal run unmasked; the two that cross it (k0 = r0,
// r0 + 32) zero W's entries k > m in registers as the fragments load; the
// steps past its rows are skipped.  The epilogue runs in registers in the
// TPU's order, res * (acc + b[m]), one 8-byte store of each pair of output
// elements.  No atomics: the same bits every run.  W's rows must be ceil8(n)
// elements apart (the wrapper pads W), d % 8 == 0, 16-byte-aligned tensors.
//
// "fma" (sgu_fwd, f32: the first kernel, timed beside tf32x3): one block
// of 4 warps per (64 output rows, 128 columns, batch row) walking the
// column tiles k <= its own; the tril predicate zeroes W above the
// diagonal as the tile is loaded; FMA loops with an 8x8 register tile per
// thread.  Nothing is pipelined.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "sgu_tile.cuh"
#include "tf32x3.cuh"

namespace {

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

// -- bf16 on Hopper: a TMA ring into wgmma (the "wgmma" route) ----------------

namespace fw {

using namespace progen::hopper;

constexpr int ROWS = 128;              // output rows m per block, 64 per warpgroup
constexpr int COLS = 128;              // channels per block
constexpr int STEP = 64;               // positions k per stage
constexpr int BOX = 64 * 64 * 2;       // one (64, 64) bf16 TMA box, 8 KB
constexpr int W = 0;                   // stage: W boxes of rows m0, m0 + 64
constexpr int G = 2 * BOX;             // gate boxes of channels c0, c0 + 64
constexpr int STAGE = 4 * BOX;
constexpr int STAGES = 2;
constexpr int RES = STAGES * STAGE;    // res: box 2 g + h = rows m0 + 64 g, channels c0 + 64 h
constexpr int BARS = RES + 4 * BOX;
constexpr int THREADS = 288;           // warpgroups 0-1 consume, a warp produces
constexpr size_t SMEM = 1024 + BARS + (2 * STAGES + 1) * sizeof(uint64_t);

enum Kind { FULL = 0, DIAGONAL = 1, SKIPPED = 2 };

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Block blk of the longest-first order (mirrored by cuda_sgu.k2_fwd_tiles):
// channel tile ct fastest, then batch row b, then row tile mi from the last
// (the longest walk) to the first.
__device__ __forceinline__ void block_tile(int blk, int batch, int row_tiles, int col_tiles,
                                           int& b, int& mi, int& ct) {
  ct = blk % col_tiles;
  const int rest = blk / col_tiles;
  b = rest % batch;
  mi = row_tiles - 1 - rest / batch;
}

// Byte offset of element (row r, column c) of a (64, 64) box in the 128-byte
// swizzle (16-byte chunk j of row r at j ^ (r % 8)).
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

}  // namespace fw

__global__ void __launch_bounds__(fw::THREADS, 2)
sgu_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap gate_map,
                     const __grid_constant__ CUtensorMap res_map,
                     const bf16* __restrict__ bias, bf16* __restrict__ out, int batch, int n,
                     int d, int row_tiles, int col_tiles) {
  using namespace fw;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  int b, mi, ct;
  block_tile(blockIdx.x, batch, row_tiles, col_tiles, b, mi, ct);
  const int m0 = mi * ROWS, c0 = ct * COLS;
  const int steps = ceil_div(min(m0 + ROWS, n), STEP);  // k < min(m0 + 128, n)
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread keeps the ring full
    if (tid == 0) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES, k0 = it * STEP;
        mbar_wait_or_trap(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(buf + W, &w_map, &full[s], k0, m0);
        tma_load_2d(buf + W + BOX, &w_map, &full[s], k0, m0 + 64);
        tma_load_3d(buf + G, &gate_map, &full[s], c0, k0, b);
        tma_load_3d(buf + G + BOX, &gate_map, &full[s], c0 + 64, k0, b);
        if (it == 0) {  // res's tile, behind the first stage
          mbar_expect_tx(resident, 4 * BOX);
          for (int x = 0; x < 4; ++x) {
            tma_load_3d(smem + RES + x * BOX, &res_map, resident, c0 + 64 * (x % 2),
                        m0 + 64 * (x / 2), b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows r0 = m0 + 64 wg.., all 128 channels
  const int r0 = m0 + 64 * wg;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % STAGES, k0 = it * STEP;
    const int kind = k0 < r0 ? FULL : (k0 == r0 ? DIAGONAL : SKIPPED);
    mbar_wait_or_trap(&full[s], (it / STAGES) & 1);
    unsigned char* buf = smem + s * STAGE;
    unsigned char* wbox = buf + W + wg * BOX;
    if (kind == DIAGONAL) {
      // W[m][k] = 0 for k > m: row q = m - r0 and column k - r0 of the box
      uint4* v16 = reinterpret_cast<uint4*>(wbox);
#pragma unroll
      for (int v = tid; v < BOX / 16; v += 128) {
        const int q = v / 8, col0 = ((v % 8) ^ (q % 8)) * 8;
        if (col0 + 7 <= q) continue;
        uint4 val = v16[v];
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          if (col0 + x > q) e[x] = from_f<bf16>(0.0f);
        }
        v16[v] = val;
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
    }
    if (kind != SKIPPED) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STEP / 16; ++kk) {
        wgmma_m64n128k16<0, 1>(acc, sw128_desc(wbox + 32 * kk, 16, 1024),
                               sw128_desc(buf + G + 2048 * kk, BOX, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
    } else {
      wgmma_wait<0>();
    }
    if (it > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // epilogue: thread t holds rows lr, lr + 8 of the warpgroup's 64, columns
  // 8 i + 2 (t % 4) and the next; out = bf16(res * bf16(acc + b[m])),
  // written over res's tile in place, then stored
  mbar_wait_or_trap(resident, 0);
  const int lane = tid % 32;
  const int lr = 16 * (tid / 32) + lane / 4;
  float bm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + lr + 8 * h;
    bm[h] = m < n ? to_f(bias[m]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    unsigned char* box = smem + RES + (2 * wg + col / 64) * BOX;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162* at =
          reinterpret_cast<__nv_bfloat162*>(box + swizzled(lr + 8 * h, col % 64));
      const __nv_bfloat162 r = *at;
      const bf16 mixed0 = __float2bfloat16(acc[4 * i + 2 * h] + bm[h]);
      const bf16 mixed1 = __float2bfloat16(acc[4 * i + 2 * h + 1] + bm[h]);
      *at = __floats2bfloat162_rn(__bfloat162float(r.x) * __bfloat162float(mixed0),
                                  __bfloat162float(r.y) * __bfloat162float(mixed1));
    }
  }
  named_sync(1 + wg, 128);
  for (int v = tid; v < 64 * (COLS / 8); v += 128) {
    const int q = v / (COLS / 8), chunk = v % (COLS / 8);
    const int m = r0 + q, c = c0 + 8 * chunk;
    if (m < n && c < d) {
      const unsigned char* box = smem + RES + (2 * wg + chunk / 8) * BOX;
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * n + m) * d + c) =
          *reinterpret_cast<const uint4*>(box + swizzled(q, 8 * (chunk % 8)));
    }
  }
}

cudaError_t launch_wgmma(const void* res, const void* gate, const void* w, const void* b,
                         void* out, int batch, int n, int d, cudaStream_t stream) {
  using namespace progen::hopper;
  CUtensorMap w_map, gate_map, res_map;
  if (!bf16_square_map(&w_map, w, n) || !bf16_rows_map(&gate_map, gate, batch, n, d, 64) ||
      !bf16_rows_map(&res_map, res, batch, n, d, 64)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(sgu_fwd_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(fw::SMEM));
  if (err != cudaSuccess) return err;
  const int row_tiles = fw::ceil_div(n, fw::ROWS), col_tiles = fw::ceil_div(d, fw::COLS);
  sgu_fwd_wgmma_kernel<<<batch * row_tiles * col_tiles, fw::THREADS, fw::SMEM, stream>>>(
      w_map, gate_map, res_map, static_cast<const bf16*>(b), static_cast<bf16*>(out), batch,
      n, d, row_tiles, col_tiles);
  return cudaGetLastError();
}


// -- f32 on the tensor cores: 3xTF32 from a cp.async ring (the "tf32x3" route)

namespace f3 {

namespace t3 = progen::tf32x3;

constexpr int ROWS = 128;                // output rows m per block, 64 per warp row
constexpr int COLS = 128;                // channels per block, 32 per warp column
constexpr int STEP = 32;                 // positions k per stage
constexpr int THREADS = 256;             // 8 warps: 2 (rows) x 4 (channels)
constexpr int RING = 2;                  // cp.async stages
constexpr int LDW = STEP + 4;            // W tile rows, words: A loads in distinct banks
constexpr int LDG = COLS + 8;            // gate tile rows, words: (k, n) B loads likewise
constexpr int W_WORDS = ROWS * LDW;
constexpr int STAGE_WORDS = W_WORDS + STEP * LDG;
constexpr size_t SMEM = sizeof(float) * RING * STAGE_WORDS;  // 71,680 B

// A from 16 rows of W's tile with W[m][k] = 0 for k > m: `diag` is the
// fragment's first row m less its first column k.
__device__ __forceinline__ void load_a_tril(t3::FragA& f, const float* m, int ld, int diag) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const float x0 = t <= g + diag ? m[g * ld + t] : 0.0f;
  const float x1 = t <= g + 8 + diag ? m[(g + 8) * ld + t] : 0.0f;
  const float x2 = t + 4 <= g + diag ? m[g * ld + t + 4] : 0.0f;
  const float x3 = t + 4 <= g + 8 + diag ? m[(g + 8) * ld + t + 4] : 0.0f;
  t3::split(x0, f.hi[0], f.lo[0]);
  t3::split(x1, f.hi[1], f.lo[1]);
  t3::split(x2, f.hi[2], f.lo[2]);
  t3::split(x3, f.hi[3], f.lo[3]);
}

}  // namespace f3

__global__ void __launch_bounds__(f3::THREADS, 2)
sgu_fwd_tf32x3_kernel(const float* __restrict__ res, const float* __restrict__ gate,
                      const float* __restrict__ w, const float* __restrict__ bias,
                      float* __restrict__ out, int batch, int n, int d, int ldw,
                      int row_tiles, int col_tiles) {
  using namespace f3;
  extern __shared__ __align__(16) float smem_f[];

  int b, row_tile, col_tile;
  fw::block_tile(blockIdx.x, batch, row_tiles, col_tiles, b, row_tile, col_tile);
  const int m0 = row_tile * ROWS, c0 = col_tile * COLS;
  const int steps = fw::ceil_div(min(m0 + ROWS, n), STEP);  // k < min(m0 + 128, n)
  const float* g_rows = gate + static_cast<size_t>(b) * n * d;

  auto load = [&](int it) {  // step it into its stage
    float* ws = smem_f + (it % RING) * STAGE_WORDS;
    const int k0 = it * STEP;
    t3::copy_tile<ROWS, STEP, LDW, THREADS>(ws, w, ldw, m0, k0, n, n);
    t3::copy_tile<STEP, COLS, LDG, THREADS>(ws + W_WORDS, g_rows, d, k0, c0, n, d);
  };
  for (int s = 0; s < RING - 1; ++s) {
    if (s < steps) load(s);
    progen::hopper::cp_async_commit();  // empty groups keep the count
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = m0 + 64 * (warp / 4);  // the warp's first row m
  const int wc = 32 * (warp % 4);       // its first channel in the tile
  // a warp whose rows or channels all lie past the edge computes nothing
  const bool idle = r0 >= n || c0 + wc >= d;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int it = 0; it < steps; ++it) {
    progen::hopper::cp_async_wait<RING - 2>();  // step it has landed (this thread's part)
    __syncthreads();  // every part has; every warp is done with step it - 1's stage
    if (it + RING - 1 < steps) load(it + RING - 1);
    progen::hopper::cp_async_commit();
    const int k0 = it * STEP;
    if (idle || k0 >= r0 + 64) continue;  // past the warp's rows: all zero
    const float* ws = smem_f + (it % RING) * STAGE_WORDS;
    const float* gs = ws + W_WORDS + wc;
    const float* wr = ws + (r0 - m0) * LDW;
    if (k0 + STEP <= r0) {  // wholly below the diagonal
#pragma unroll
      for (int kk = 0; kk < STEP / 8; ++kk) {
        t3::FragB bf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) t3::load_b_kn(bf[j], gs + 8 * kk * LDG + 8 * j, LDG);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          t3::FragA af;
          t3::load_a(af, wr + 16 * i * LDW + 8 * kk, LDW);
          t3::mma3<4>(acc[i], af, bf);
        }
      }
    } else {  // crossing it: W[m][k] = 0 for k > m
#pragma unroll
      for (int kk = 0; kk < STEP / 8; ++kk) {
        t3::FragB bf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) t3::load_b_kn(bf[j], gs + 8 * kk * LDG + 8 * j, LDG);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int diag = r0 + 16 * i - (k0 + 8 * kk);
          if (diag + 15 < 0) continue;  // every k of the slice is past every row
          t3::FragA af;
          load_a_tril(af, wr + 16 * i * LDW + 8 * kk, LDW, diag);
          t3::mma3<4>(acc[i], af, bf);
        }
      }
    }
  }
  progen::hopper::cp_async_wait<0>();

  // epilogue: element (i, j, 2 h + x) is row r0 + 16 i + g + 8 h, channel
  // c0 + wc + 8 j + 2 t + x; out = res * (acc + b[m]), the TPU's order
  if (idle) return;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 16 * i + g + 8 * h;
      if (m >= n) continue;
      const float bm = bias[m];
      const size_t row = (static_cast<size_t>(b) * n + m) * d;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + wc + 8 * j + 2 * t;
        if (c >= d) continue;
        const float2 r = *reinterpret_cast<const float2*>(res + row + c);
        *reinterpret_cast<float2*>(out + row + c) =
            make_float2(r.x * (acc[i][j][2 * h] + bm), r.y * (acc[i][j][2 * h + 1] + bm));
      }
    }
  }
}

cudaError_t launch_tf32x3(const void* res, const void* gate, const void* w, const void* b,
                          void* out, int batch, int n, int d, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sgu_fwd_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(f3::SMEM));
  if (err != cudaSuccess) return err;
  const int row_tiles = fw::ceil_div(n, f3::ROWS), col_tiles = fw::ceil_div(d, f3::COLS);
  sgu_fwd_tf32x3_kernel<<<batch * row_tiles * col_tiles, f3::THREADS, f3::SMEM, stream>>>(
      static_cast<const float*>(res), static_cast<const float*>(gate),
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(out),
      batch, n, d, (n + 7) / 8 * 8, row_tiles, col_tiles);
  return cudaGetLastError();
}

}  // namespace

// The fma route of K2-fwd: res, gate, out (batch, n, d) contiguous; w
// (n, n); b (n, 1); float32 only (dtype 0); d must be a multiple of 8.
// Returns the CUDA error code of the launch (0 = ok).
extern "C" int sgu_fwd(const void* res, const void* gate, const void* w, const void* b,
                       void* out, int batch, int n, int d, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || batch > 65535 || dtype != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<float>(res, gate, w, b, out, batch, n, d,
                                        static_cast<cudaStream_t>(stream)));
}

// The wgmma route of K2-fwd: bfloat16 only (dtype 1); res, gate, out
// (batch, n, d) contiguous, w (n, n) with rows ceil8(n) elements apart, b
// (n, 1); d a multiple of 8, every pointer 16-byte aligned.  Returns the
// CUDA error code of the launch (0 = ok).
extern "C" int sgu_fwd_wgmma(const void* res, const void* gate, const void* w,
                             const void* b, void* out, int batch, int n, int d, int dtype,
                             void* stream) {
  if (batch <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || dtype != 1 ||
      static_cast<long long>(batch) * ((n + 127) / 128) * ((d + 127) / 128) > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_wgmma(res, gate, w, b, out, batch, n, d,
                                       static_cast<cudaStream_t>(stream)));
}

// The tf32x3 route of K2-fwd: float32 only (dtype 0); res, gate, out
// (batch, n, d) contiguous, w (n, n) with rows ceil8(n) elements apart, b
// (n, 1); d a multiple of 8, every pointer 16-byte aligned.  Returns the
// CUDA error code of the launch (0 = ok).
extern "C" int sgu_fwd_tf32x3(const void* res, const void* gate, const void* w,
                              const void* b, void* out, int batch, int n, int d, int dtype,
                              void* stream) {
  if (batch <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || dtype != 0 ||
      static_cast<long long>(batch) * ((n + 127) / 128) * ((d + 127) / 128) > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_tf32x3(res, gate, w, b, out, batch, n, d,
                                        static_cast<cudaStream_t>(stream)));
}
