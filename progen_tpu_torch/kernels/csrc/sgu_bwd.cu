// Causal spatial gating unit, backward, for Hopper (sm_90a): the gradients
// of out = res * cast(tril(W) . gate + b) that the TPU computes in kernels.
//
// sgu_bwd_dgate_wgmma (bf16), sgu_bwd_dgate_tf32x3 (f32) and sgu_bwd_dgate
// (f32, the first kernel) replace progen_tpu/ops/pallas_sgu.py:_dgate_kernel
// (launched by _backward_dgate):  d_gate = tril(W)^T . (dout * res), with
// dout * res rounded to the compute dtype before the f32 product
// (pallas_sgu.py:162) and the sum cast once to dout's dtype.
//
// sgu_bwd_dw_wgmma (bf16), sgu_bwd_dw_tf32x3 (f32) and sgu_bwd_dw (f32, the
// first kernel) replace pallas_sgu.py:_dw_kernel (launched by
// _backward_dw): d_W = tril(sum_b (dout * res)_b . gate_b^T), the sum in
// f32 and cast once to W's dtype, the whole strict upper triangle exactly 0
// (pallas_sgu.py:298-300).
//
// Each route has its own extern "C" name; cuda_sgu.dgate_route and
// dw_route pick one from the dtype before the launch (bf16 "wgmma", f32
// "tf32x3"), and none falls back to another.
//
// d_res is the forward kernel with dout in place of res and d_b a plain
// reduction, as in the TPU package (pallas_sgu.py:316-335).
//
// What bounds them on this card: at ProGen-small (B = 8, n = 1024,
// d = 2048, bf16) each reads dout, res and gate or W once and writes its
// result once, 101.7 MB (d_gate) and 102.8 MB (d_W), for 17.2 GFLOP of
// triangle work: ~170 flops per byte, under the H100's ~295 flops/byte
// ridge, so the bytes, 0.030 ms.  The first versions were bound by neither:
// synchronous loads, WMMA and one wave of 136 blocks walking 256 steps
// each (d_W), or 64-row tiles re-reading ~700 MB from L2 with W stored
// transposed element by element (d_gate), at 3% and 8% of the bound.
//
// Design of the bf16 path, both kernels: 384 threads, two consumer
// warpgroups and a producer warpgroup of which one thread issues the
// copies.  The producer keeps a ring of 4 stages of 128-byte-swizzled tiles
// in flight with TMA (cp.async.bulk.tensor, mbarrier complete_tx); each
// consumer forms dout * res in place over its share of a stage (two tiles
// copied with one swizzle multiply in the same layout), rounds it to bf16,
// fences it for the async proxy (fence.proxy.async) and runs
// wgmma.mma_async m64n128k16 from shared memory, f32 accumulators in
// registers; one stage's products overlap the next stage's arrival and
// dmix.
//  - d_W, C = A . B^T over K = B * d: one 128 x 128 tile of the lower
//    triangle per block, both operands K-major (channels contiguous).  The
//    (batch, channel) axis is split in `splits` contiguous ranges of
//    64-channel steps, so tiles * splits blocks fill the SMs in one wave
//    (36 x 3 = 108 at ProGen-small); the blocks of one split run side by
//    side over the same batch rows, so those rows are read from device
//    memory about once and re-read from L2.  Each block writes its f32
//    partial tile to a workspace (7.1 MB written and read at ProGen-small);
//    sgu_dw_reduce_kernel sums the splits in a fixed order, casts, and
//    writes every entry of d_W, the strict upper triangle as 0.  No atomics:
//    the bits do not change from run to run.
//  - d_gate[b] = tril(W)^T . dmix[b]: one block per (batch row, 128 gate
//    rows j, 128 channels), blocks of one batch row next to each other (its
//    dmix and W stay in L2) and the longest rows of the triangle first
//    within it.  W's (i, j) tiles come in j-contiguous and feed wgmma as an
//    M-major A operand; dmix is an N-major B operand.  The one diagonal tile
//    of each warpgroup has its strict upper part (j > i) zeroed in shared
//    memory before use; the tiles above it are skipped.  The result is
//    staged in shared memory and written in 16-byte stores.
// W's rows are ceil8(n) elements apart (the wrapper pads W when n % 8 != 0:
// TMA needs 16-byte strides); d % 8 == 0 and 16-byte-aligned tensors are
// required.
//
// f32 d_W on the tensor cores (the "tf32x3" route): every product as three
// TF32 products (tf32x3.cuh), so the bound is 3 x FLOPs / 495 TFLOP/s
// (0.104 ms at ProGen-small, B = 8), and the bf16 route's split reduction:
// one 128 x 128 tile of the lower triangle per block, the (batch, channel)
// axis in `splits` ranges of 32-channel steps so that tiles * splits blocks
// fill the SMs at two blocks an SM (7 splits, 252 blocks at ProGen-small),
// the f32 partials into the workspace and the same ordered sum
// (sgu_dw_reduce_kernel<float>): no atomics, the same bits every run.  256
// threads; a ring of 2 cp.async stages of dout's, res's and gate's (128,
// 32) tiles in rows of 36 words, rows past n and channels past d
// zero-filled.  Each warp owns 64 rows m x 32 columns k: per 8-deep slice
// it splits 4 B fragments of gate (load_b_rows, K-major) and, one at a
// time, 4 A fragments of dout * res, the product formed in f32 as the
// fragment loads (rounded to f32 before it is split, as JAX forms dmix),
// each A feeding 12 mma.sync.  In a diagonal tile the two warps whose
// columns all lie past their rows skip the products and write zeros.
//
// f32 d_gate on the tensor cores (the "tf32x3" route): every product as
// three TF32 products, so the bound is 3 x FLOPs / 495 TFLOP/s (0.104 ms at
// ProGen-small, B = 8).  K2-fwd's f32 kernel (sgu_fwd.cu, namespace f3)
// with the triangle's two axes swapped: 256 threads, two blocks an SM; a
// block owns (batch row, 128 gate rows j, 128 channels), the row tiles in
// longest-walk-first order (dg3::block_tile, mirrored by
// cuda_sgu.k2_dgate_tiles), and walks the 32-deep steps of positions i
// from j0 to n through a ring of 2 cp.async stages: W's (32 i, 128 j) tile
// as it lies in W, and dout's and res's (32 i, 128 channels) tiles, all in
// rows of 136 words, rows past n and channels past d zero-filled.  Each
// warp owns 64 rows j x 32 channels: per 8-deep slice it splits 4 B
// fragments of dout * res (the product rounded to f32 as the fragment
// loads, then split, as JAX forms dmix) and, one at a time, 4 A fragments
// of W^T read M-major (load_a_km), each feeding 12 mma.sync.  A warp's
// steps wholly past its rows' diagonal run unmasked; the two that cross it
// (i0 = r0, r0 + 32) zero W's entries j > i in registers as the fragments
// load; the steps before its rows are skipped.  Each output element is
// written once, from registers: no atomics, the same bits every run.
//
// The f32 "fma" kernels (K2-dgate's and K2-dW's first, timed beside
// tf32x3) keep FMA loops over the forward's tiles (sgu_tile.cuh), one
// block per d_gate or d_W tile.

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
using namespace progen::hopper;
using namespace progen::sgu;

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

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

// -- bf16 d_W: split reduction over (batch, channel) ---------------------------

namespace dwk {
constexpr int TILE = 128;                    // d_W tile: rows m, columns k
constexpr int STEP = 64;                     // channels per step: one swizzle row
constexpr int OPERAND = TILE * STEP * 2;     // one (128, 64) bf16 tile, 16 KB
constexpr int STAGE = 3 * OPERAND;           // dout, res, gate
constexpr int STAGES = 4;
constexpr int THREADS = 384;                 // warpgroups 0-1 consume, 2 produces
constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
}  // namespace dwk

// Block (tile t, split s), t = mi (mi + 1) / 2 + ki over the lower triangle
// (ki <= mi), blockIdx.x = s * tiles + t; split s takes the 64-channel
// steps [s * steps / splits, (s + 1) * steps / splits) of the
// (batch, channel) axis, step j reading batch row j / chunks, channels
// (j % chunks) * 64 on.  Writes its f32 partial tile to
// work[(s * tiles + t) * 128 * 128 ...], row-major.
__global__ void __launch_bounds__(dwk::THREADS, 1)
sgu_dw_partial_kernel(const __grid_constant__ CUtensorMap dout_map,
                      const __grid_constant__ CUtensorMap res_map,
                      const __grid_constant__ CUtensorMap gate_map,
                      float* __restrict__ work, int tiles, int chunks, int steps,
                      int splits) {
  using namespace dwk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int t = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  int mi = 0;
  while ((mi + 1) * (mi + 2) / 2 <= t) ++mi;
  const int ki = t - mi * (mi + 1) / 2;
  const int first = static_cast<int>(static_cast<long long>(split) * steps / splits);
  const int last = static_cast<int>(static_cast<long long>(split + 1) * steps / splits);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread keeps the ring full
    if (tid == 0) {
      for (int j = first; j < last; ++j) {
        const int it = j - first, s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + s * STAGE;
        const int b = j / chunks, c0 = (j % chunks) * STEP;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_3d(buf, &dout_map, &full[s], c0, mi * TILE, b);
        tma_load_3d(buf + OPERAND, &res_map, &full[s], c0, mi * TILE, b);
        tma_load_3d(buf + 2 * OPERAND, &gate_map, &full[s], c0, ki * TILE, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg.. of the tile, all 128 columns
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const int rows = wg * (OPERAND / 2);  // byte offset of its 64 rows
  for (int j = first; j < last; ++j) {
    const int it = j - first, s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    unsigned char* buf = smem + s * STAGE;
    uint4* a = reinterpret_cast<uint4*>(buf + rows);
    const uint4* r = reinterpret_cast<const uint4*>(buf + OPERAND + rows);
#pragma unroll
    for (int v = tid; v < OPERAND / 2 / 16; v += 128) a[v] = mul_vec<bf16>(a[v], r[v]);
    fence_proxy_async();
    named_sync(1 + wg, 128);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < STEP / 16; ++k) {
      wgmma_m64n128k16<0, 0>(acc, sw128_desc(buf + rows + 32 * k, 16, 1024),
                             sw128_desc(buf + 2 * OPERAND + 32 * k, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: free its stage
    if (it > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();

  float* out = work + (static_cast<size_t>(split) * tiles + t) * TILE * TILE;
  const int lane = tid % 32;
  const int row = wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + row * TILE + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(out + (row + 8) * TILE + col) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// d_W[m][k] = T(sum over splits s, in order, of the partials), 0 where
// k > m; one thread per 4 neighbouring entries of a row.
template <typename T>
__global__ void sgu_dw_reduce_kernel(const float* __restrict__ work, T* __restrict__ dw,
                                     int n, int tiles, int splits) {
  using dwk::TILE;
  const int quads = (n + 3) / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * quads) return;
  const int m = static_cast<int>(idx / quads);
  const int k0 = static_cast<int>(idx % quads) * 4;  // k0..k0+3 lie in one tile
  const int mi = m / TILE, ki = k0 / TILE;
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (ki <= mi) {
    const float* p = work + static_cast<size_t>(mi * (mi + 1) / 2 + ki) * TILE * TILE +
                     (m % TILE) * TILE + k0 % TILE;
    for (int s = 0; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(
          p + static_cast<size_t>(s) * tiles * TILE * TILE);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
  }
  const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
  T* row = dw + static_cast<size_t>(m) * n;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + e;
    if (k < n) row[k] = from_f<T>(k <= m ? vals[e] : 0.0f);
  }
}

template <typename T>
cudaError_t launch_dw_reduce(const void* work, void* dw, int n, int tiles, int splits,
                             cudaStream_t stream) {
  const long long quads = static_cast<long long>(n) * ((n + 3) / 4);
  sgu_dw_reduce_kernel<T><<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(work), static_cast<T*>(dw), n, tiles, splits);
  return cudaGetLastError();
}

// -- f32 d_W on the tensor cores: 3xTF32 (the "tf32x3" route) ------------------

namespace dw3 {
namespace t3 = progen::tf32x3;
constexpr int TILE = 128;                  // d_W tile: rows m, columns k
constexpr int STEP = 32;                   // channels per step
constexpr int THREADS = 256;               // 8 warps: 2 (rows m) x 4 (columns k)
constexpr int STAGES = 2;
constexpr int LD = STEP + 4;               // tile rows, words: loads in distinct banks
constexpr int OPERAND = TILE * LD;         // words of one (128, 32) tile
constexpr int STAGE = 3 * OPERAND;         // dout, res, gate
constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;  // 110,592 B

// A from 16 rows of dout's and res's tiles: (dout * res) rounded to f32,
// then split.
__device__ __forceinline__ void load_a_mul(t3::FragA& f, const float* a, const float* r,
                                           int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int at[4] = {g * ld + t, (g + 8) * ld + t, g * ld + t + 4, (g + 8) * ld + t + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) t3::split(a[at[e]] * r[at[e]], f.hi[e], f.lo[e]);
}
}  // namespace dw3

// Block (tile t, split s) as the bf16 kernel's: t = mi (mi + 1) / 2 + ki,
// blockIdx.x = s * tiles + t, split s takes the 32-channel steps
// [s * steps / splits, (s + 1) * steps / splits), step j reading batch row
// j / chunks, channels (j % chunks) * 32 on.  Writes its f32 partial tile
// to work[(s * tiles + t) * 128 * 128 ...], row-major.
__global__ void __launch_bounds__(dw3::THREADS, 2)
sgu_dw_tf32x3_kernel(const float* __restrict__ dout, const float* __restrict__ res,
                     const float* __restrict__ gate, float* __restrict__ work, int n, int d,
                     int tiles, int chunks, int steps, int splits) {
  using namespace dw3;
  extern __shared__ __align__(16) float smem_f[];

  const int t = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  int mi = 0;
  while ((mi + 1) * (mi + 2) / 2 <= t) ++mi;
  const int ki = t - mi * (mi + 1) / 2;
  const int m0 = mi * TILE, k0 = ki * TILE;
  const int first = static_cast<int>(static_cast<long long>(split) * steps / splits);
  const int last = static_cast<int>(static_cast<long long>(split + 1) * steps / splits);

  auto load = [&](int j) {  // step j into its stage
    float* st = smem_f + ((j - first) % STAGES) * STAGE;
    const size_t off = static_cast<size_t>(j / chunks) * n * d;
    const int c0 = (j % chunks) * STEP;
    t3::copy_tile<TILE, STEP, LD, THREADS>(st, dout + off, d, m0, c0, n, d);
    t3::copy_tile<TILE, STEP, LD, THREADS>(st + OPERAND, res + off, d, m0, c0, n, d);
    t3::copy_tile<TILE, STEP, LD, THREADS>(st + 2 * OPERAND, gate + off, d, k0, c0, n, d);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (first + s < last) load(first + s);
    progen::hopper::cp_async_commit();  // empty groups keep the count
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = 64 * (warp / 4);  // the warp's first row m in the tile
  const int wc = 32 * (warp % 4);  // its first column k
  // nothing to compute: every column past every row (in a diagonal tile),
  // or rows or columns all past n
  const bool idle = (mi == ki && wc > wr + 63) || m0 + wr >= n || k0 + wc >= n;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int j = first; j < last; ++j) {
    progen::hopper::cp_async_wait<STAGES - 2>();  // step j has landed (this thread's part)
    __syncthreads();  // every part has; every warp is done with step j - 1's stage
    if (j + STAGES - 1 < last) load(j + STAGES - 1);
    progen::hopper::cp_async_commit();
    if (idle) continue;
    const float* st = smem_f + ((j - first) % STAGES) * STAGE;
    const float* as = st + wr * LD;
    const float* rs = st + OPERAND + wr * LD;
    const float* gs = st + 2 * OPERAND + wc * LD;
#pragma unroll
    for (int kk = 0; kk < STEP / 8; ++kk) {
      t3::FragB bf[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) t3::load_b_rows(bf[c], gs + 8 * c * LD + 8 * kk, LD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        t3::FragA af;
        load_a_mul(af, as + 16 * i * LD + 8 * kk, rs + 16 * i * LD + 8 * kk, LD);
        t3::mma3<4>(acc[i], af, bf);
      }
    }
  }
  progen::hopper::cp_async_wait<0>();

  // element (i, c, 2 h + x): row wr + 16 i + g + 8 h, column wc + 8 c + 2 t + x
  float* out = work + (static_cast<size_t>(split) * tiles + t) * TILE * TILE;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float2*>(out + (wr + 16 * i + g + 8 * h) * TILE + wc + 8 * c + 2 * q) =
            make_float2(acc[i][c][2 * h], acc[i][c][2 * h + 1]);
      }
}

// -- bf16 d_gate ----------------------------------------------------------------

namespace dgk {
constexpr int ROWS = 128;                  // gate rows j per block, 64 per warpgroup
constexpr int COLS = 128;                  // channels per block
constexpr int STEP = 64;                   // positions i per step
constexpr int BOX = 64 * 64 * 2;           // one (64, 64) bf16 box, 8 KB
constexpr int W = 0;                       // stage layout: W boxes j0, j0 + 64
constexpr int DOUT = 2 * BOX;              // dout boxes c0, c0 + 64
constexpr int RES = 4 * BOX;               // res boxes c0, c0 + 64
constexpr int STAGE = 6 * BOX;
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int LDO = COLS + 8;              // epilogue rows in shared memory (bf16)
constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
static_assert(2 * 64 * LDO * 2 <= STAGES * STAGE, "the epilogue reuses the ring");
}  // namespace dgk

// Block blk = (b * row_tiles + jt) * col_tiles + ct: gate rows j0 = 128 jt..,
// channels c0 = 128 ct.., batch row b; walks positions i from j0 to n.
__global__ void __launch_bounds__(dgk::THREADS, 1)
sgu_dgate_kernel(const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap dout_map,
                 const __grid_constant__ CUtensorMap res_map, bf16* __restrict__ dgate,
                 int n, int d, int row_tiles, int col_tiles) {
  using namespace dgk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int ct = blockIdx.x % col_tiles;
  const int jt = (blockIdx.x / col_tiles) % row_tiles;
  const int b = blockIdx.x / (col_tiles * row_tiles);
  const int j0 = jt * ROWS, c0 = ct * COLS;
  const int steps = ceil_div(n - j0, STEP);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    if (tid == 0) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES, i0 = j0 + it * STEP;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(buf + W, &w_map, &full[s], j0, i0);
        tma_load_2d(buf + W + BOX, &w_map, &full[s], j0 + 64, i0);
        tma_load_3d(buf + DOUT, &dout_map, &full[s], c0, i0, b);
        tma_load_3d(buf + DOUT + BOX, &dout_map, &full[s], c0 + 64, i0, b);
        tma_load_3d(buf + RES, &res_map, &full[s], c0, i0, b);
        tma_load_3d(buf + RES + BOX, &res_map, &full[s], c0 + 64, i0, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns gate rows j0 + 64 wg.., all 128 channels
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const int diag = j0 + 64 * wg;  // its first row; rows j see positions i >= j
  for (int it = 0; it < steps; ++it) {
    const int s = it % STAGES, i0 = j0 + it * STEP;
    mbar_wait(&full[s], (it / STAGES) & 1);
    unsigned char* buf = smem + s * STAGE;
    // dmix over the whole (64, 128) tile, shared by the two warpgroups
    uint4* a = reinterpret_cast<uint4*>(buf + DOUT);
    const uint4* r = reinterpret_cast<const uint4*>(buf + RES);
#pragma unroll
    for (int v = threadIdx.x; v < 2 * BOX / 16; v += 256) a[v] = mul_vec<bf16>(a[v], r[v]);
    if (i0 == diag) {
      // the diagonal tile: W[i][j] = 0 for j > i, row i - i0 and column
      // j - diag of the swizzled box (16-byte chunk c of row q at c ^ (q % 8))
      uint4* wbox = reinterpret_cast<uint4*>(buf + W + wg * BOX);
#pragma unroll
      for (int v = tid; v < BOX / 16; v += 128) {
        const int q = v / 8, col0 = ((v % 8) ^ (q % 8)) * 8;
        if (col0 + 7 <= q) continue;
        uint4 val = wbox[v];
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          if (col0 + x > q) e[x] = from_f<bf16>(0.0f);
        }
        wbox[v] = val;
      }
    }
    fence_proxy_async();
    named_sync(1, 256);
    if (i0 >= diag) {  // the tiles above the diagonal tile are all zero
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < STEP / 16; ++k) {
        wgmma_m64n128k16<1, 1>(acc, sw128_desc(buf + W + wg * BOX + 2048 * k, BOX, 1024),
                               sw128_desc(buf + DOUT + 2048 * k, BOX, 1024), 1);
      }
      wgmma_commit();
    }
    wgmma_wait<1>();
    if (it > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  named_sync(1, 256);  // both warpgroups are done with the ring: reuse it

  bf16* staged = reinterpret_cast<bf16*>(smem) + wg * 64 * LDO;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(staged + row * LDO + col) =
        __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(staged + (row + 8) * LDO + col) =
        __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
  named_sync(2 + wg, 128);
  for (int v = tid; v < 64 * (COLS / 8); v += 128) {
    const int q = v / (COLS / 8), c = c0 + (v % (COLS / 8)) * 8;
    const int j = diag + q;
    if (j < n && c < d) {
      *reinterpret_cast<uint4*>(dgate + (static_cast<size_t>(b) * n + j) * d + c) =
          *reinterpret_cast<const uint4*>(staged + q * LDO + (v % (COLS / 8)) * 8);
    }
  }
}

// -- f32 d_gate on the tensor cores: 3xTF32 (the "tf32x3" route) --------------

namespace dg3 {
namespace t3 = progen::tf32x3;
constexpr int ROWS = 128;                  // gate rows j per block, 64 per warp row
constexpr int COLS = 128;                  // channels per block, 32 per warp column
constexpr int STEP = 32;                   // positions i per stage
constexpr int THREADS = 256;               // 8 warps: 2 (rows j) x 4 (channels)
constexpr int STAGES = 2;
constexpr int LD = 128 + 8;                // tile rows, words: (k, m) and (k, n) loads
                                           // in distinct banks
constexpr int OPERAND = STEP * LD;         // words of one (32, 128) tile
constexpr int STAGE = 3 * OPERAND;         // W, dout, res
constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;  // 104,448 B

// Block blk of the longest-first order (mirrored by cuda_sgu.k2_dgate_tiles):
// channel tile ct fastest, then batch row b, then row tile jt from the first
// (the longest walk, j0 = 0 to n) to the last.
__device__ __forceinline__ void block_tile(int blk, int batch, int col_tiles, int& b, int& jt,
                                           int& ct) {
  ct = blk % col_tiles;
  const int rest = blk / col_tiles;
  b = rest % batch;
  jt = rest / batch;
}

// A = W^T from W's (i, j) tile with W[i][j] = 0 for j > i: `diag` is the
// fragment's first row j less its first column i (load_a_km's reads).
__device__ __forceinline__ void load_a_km_triu(t3::FragA& f, const float* m, int ld,
                                               int diag) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const float x0 = t >= g + diag ? m[t * ld + g] : 0.0f;
  const float x1 = t >= g + 8 + diag ? m[t * ld + g + 8] : 0.0f;
  const float x2 = t + 4 >= g + diag ? m[(t + 4) * ld + g] : 0.0f;
  const float x3 = t + 4 >= g + 8 + diag ? m[(t + 4) * ld + g + 8] : 0.0f;
  t3::split(x0, f.hi[0], f.lo[0]);
  t3::split(x1, f.hi[1], f.lo[1]);
  t3::split(x2, f.hi[2], f.lo[2]);
  t3::split(x3, f.hi[3], f.lo[3]);
}

// B = dout * res from their (k, n) tiles (load_b_kn's reads): the product
// rounded to f32, then split.
__device__ __forceinline__ void load_b_kn_mul(t3::FragB& f, const float* a, const float* r,
                                              int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int at0 = t * ld + g, at1 = (t + 4) * ld + g;
  t3::split(a[at0] * r[at0], f.hi[0], f.lo[0]);
  t3::split(a[at1] * r[at1], f.hi[1], f.lo[1]);
}
}  // namespace dg3

__global__ void __launch_bounds__(dg3::THREADS, 2)
sgu_dgate_tf32x3_kernel(const float* __restrict__ w, const float* __restrict__ dout,
                        const float* __restrict__ res, float* __restrict__ dgate, int batch,
                        int n, int d, int ldw, int col_tiles) {
  using namespace dg3;
  extern __shared__ __align__(16) float smem_f[];

  int b, jt, ct;
  block_tile(blockIdx.x, batch, col_tiles, b, jt, ct);
  const int j0 = jt * ROWS, c0 = ct * COLS;
  const int steps = ceil_div(n - j0, STEP);  // positions i from j0 to n
  const size_t off = static_cast<size_t>(b) * n * d;

  auto load = [&](int it) {  // step it into its stage
    float* st = smem_f + (it % STAGES) * STAGE;
    const int i0 = j0 + it * STEP;
    t3::copy_tile<STEP, ROWS, LD, THREADS>(st, w, ldw, i0, j0, n, n);
    t3::copy_tile<STEP, COLS, LD, THREADS>(st + OPERAND, dout + off, d, i0, c0, n, d);
    t3::copy_tile<STEP, COLS, LD, THREADS>(st + 2 * OPERAND, res + off, d, i0, c0, n, d);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    progen::hopper::cp_async_commit();  // empty groups keep the count
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = j0 + 64 * (warp / 4);  // the warp's first row j
  const int wc = 32 * (warp % 4);       // its first channel in the tile
  // a warp whose rows or channels all lie past the edge computes nothing
  const bool idle = r0 >= n || c0 + wc >= d;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int it = 0; it < steps; ++it) {
    progen::hopper::cp_async_wait<STAGES - 2>();  // step it has landed (this thread's part)
    __syncthreads();  // every part has; every warp is done with step it - 1's stage
    if (it + STAGES - 1 < steps) load(it + STAGES - 1);
    progen::hopper::cp_async_commit();
    const int i0 = j0 + it * STEP;
    if (idle || i0 + STEP <= r0) continue;  // before the warp's rows: all zero
    const float* st = smem_f + (it % STAGES) * STAGE;
    const float* ws = st + (r0 - j0);
    const float* as = st + OPERAND + wc;
    const float* rs = st + 2 * OPERAND + wc;
    if (i0 >= r0 + 64) {  // wholly past the diagonal
#pragma unroll
      for (int kk = 0; kk < STEP / 8; ++kk) {
        t3::FragB bf[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          load_b_kn_mul(bf[c], as + 8 * kk * LD + 8 * c, rs + 8 * kk * LD + 8 * c, LD);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          t3::FragA af;
          t3::load_a_km(af, ws + 8 * kk * LD + 16 * i, LD);
          t3::mma3<4>(acc[i], af, bf);
        }
      }
    } else {  // crossing it: W[i][j] = 0 for j > i
#pragma unroll
      for (int kk = 0; kk < STEP / 8; ++kk) {
        t3::FragB bf[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          load_b_kn_mul(bf[c], as + 8 * kk * LD + 8 * c, rs + 8 * kk * LD + 8 * c, LD);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int diag = r0 + 16 * i - (i0 + 8 * kk);
          if (diag > 7) continue;  // every row of the fragment is past every i of the slice
          t3::FragA af;
          load_a_km_triu(af, ws + 8 * kk * LD + 16 * i, LD, diag);
          t3::mma3<4>(acc[i], af, bf);
        }
      }
    }
  }
  progen::hopper::cp_async_wait<0>();

  // element (i, c, 2 h + x): row r0 + 16 i + g + 8 h, channel
  // c0 + wc + 8 c + 2 t + x
  if (idle) return;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = r0 + 16 * i + g + 8 * h;
      if (j >= n) continue;
      float* row = dgate + off + static_cast<size_t>(j) * d;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + wc + 8 * c + 2 * t;
        if (col >= d) continue;
        *reinterpret_cast<float2*>(row + col) =
            make_float2(acc[i][c][2 * h], acc[i][c][2 * h + 1]);
      }
    }
  }
}

// -- f32: FMA loops over the forward's tiles, for the comparisons --------------

// Copy a (ROWS, COLS) tile of dout * res (or of one tensor, when b is
// null) starting at (r0, c0) of a (rows, d) matrix into shared memory with
// row stride ld; out-of-range rows and columns are zeros.
template <int ROWS, int COLS>
__device__ void load_tile(float* dst, int ld, const float* a, const float* b, int r0,
                          int c0, int rows, int d) {
  for (int idx = threadIdx.x; idx < ROWS * (COLS / 4); idx += THREADS) {
    const int r = idx / (COLS / 4);
    const int c = (idx % (COLS / 4)) * 4;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && c0 + c < d) {
      const size_t at = static_cast<size_t>(row) * d + c0 + c;
      val = *reinterpret_cast<const uint4*>(a + at);
      if (b != nullptr) val = mul_vec<float>(val, *reinterpret_cast<const uint4*>(b + at));
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
sgu_dgate_f32_kernel(const float* __restrict__ w, const float* __restrict__ dout,
                     const float* __restrict__ res, float* __restrict__ dgate, int n,
                     int ldw, int d) {
  using L = Layout<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem + L::w);
  float* gs = reinterpret_cast<float*>(smem + L::g);
  float* cs = reinterpret_cast<float*>(smem + L::c);

  const int c0 = blockIdx.x * TN;
  const int j0 = blockIdx.y * TM;  // output rows: gate positions
  const size_t batch = static_cast<size_t>(blockIdx.z) * n * d;

  Acc<float> acc;
  acc.zero();
  // causal: gate row j is read by rows i >= j of W, so the tiles from the
  // diagonal down
  for (int i0 = j0; i0 < n; i0 += TK) {
    __syncthreads();  // every warp is done with the previous tiles
    // ws[r][c] = W[i0 + c][j0 + r] on and below the diagonal, else 0
    for (int idx = threadIdx.x; idx < TM * TK; idx += THREADS) {
      const int r = idx % TM, c = idx / TM;
      const int i = i0 + c, j = j0 + r;
      ws[r * L::LDW + c] = (i < n && j <= i) ? w[static_cast<size_t>(i) * ldw + j] : 0.0f;
    }
    load_tile<TK, TN>(gs, L::LDG, dout + batch, res + batch, i0, c0, n, d);
    __syncthreads();
    acc.step(ws, gs);
  }
  acc.store(cs);
  __syncthreads();

  for (int idx = threadIdx.x; idx < TM * TN; idx += THREADS) {
    const int r = idx / TN, c = idx % TN;
    const int j = j0 + r, col = c0 + c;
    if (j < n && col < d) dgate[batch + static_cast<size_t>(j) * d + col] = cs[r * L::LDC + c];
  }
}

constexpr int DT = 64;  // f32 d_W tile: rows m and columns k
constexpr int DK = 64;  // channels per step

struct DwLayout {
  static constexpr int LD = DK + Pad<float>::v;  // dmix and gate tile rows
  static constexpr int LDC = DT + 4;             // result rows
  static constexpr size_t a = 0;
  static constexpr size_t b = a + sizeof(float) * DT * LD;
  static constexpr size_t c = b + sizeof(float) * DT * LD;
  static constexpr size_t bytes = c + sizeof(float) * DT * LDC;
};

// One block per (64, 64) tile of d_W; the batch and channel loops inside, an
// 8x4 register tile per thread (rows rg + 8i, columns cg + 16j).
__global__ void __launch_bounds__(THREADS)
sgu_dw_f32_kernel(const float* __restrict__ dout, const float* __restrict__ res,
                  const float* __restrict__ gate, float* __restrict__ dw, int batch,
                  int n, int d) {
  using L = DwLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem + L::a);
  float* bs = reinterpret_cast<float*>(smem + L::b);
  float* cs = reinterpret_cast<float*>(smem + L::c);

  const int k0 = blockIdx.x * DT;  // columns: gate positions
  const int m0 = blockIdx.y * DT;  // rows: output positions
  if (k0 > m0) {  // a tile of the strict upper triangle: exact zeros
    for (int idx = threadIdx.x; idx < DT * DT; idx += THREADS) {
      const int m = m0 + idx / DT, k = k0 + idx % DT;
      if (m < n && k < n) dw[static_cast<size_t>(m) * n + k] = 0.0f;
    }
    return;
  }

  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;
  float f[8][4] = {};
  for (int b = 0; b < batch; ++b) {
    const size_t off = static_cast<size_t>(b) * n * d;
    for (int c0 = 0; c0 < d; c0 += DK) {
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<DT, DK>(as, L::LD, dout + off, res + off, m0, c0, n, d);
      load_tile<DT, DK>(bs, L::LD, gate + off, nullptr, k0, c0, n, d);
      __syncthreads();
      for (int k = 0; k < DK; ++k) {
        float x[8], y[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = as[(rg + 8 * i) * L::LD + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = bs[(cg + 16 * j) * L::LD + k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] += x[i] * y[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[(rg + 8 * i) * L::LDC + cg + 16 * j] = f[i][j];
  __syncthreads();

  for (int idx = threadIdx.x; idx < DT * DT; idx += THREADS) {
    const int r = idx / DT, c = idx % DT;
    const int m = m0 + r, k = k0 + c;
    if (m < n && k < n) {
      dw[static_cast<size_t>(m) * n + k] = k <= m ? cs[r * L::LDC + c] : 0.0f;
    }
  }
}

// -- launchers -------------------------------------------------------------------

int ceil8(int n) { return (n + 7) / 8 * 8; }

cudaError_t launch_dgate_bf16(const void* w, const void* dout, const void* res, void* dgate,
                              int batch, int n, int d, cudaStream_t stream) {
  CUtensorMap w_map, dout_map, res_map;
  if (!bf16_square_map(&w_map, w, n) ||
      !bf16_rows_map(&dout_map, dout, batch, n, d, dgk::STEP) ||
      !bf16_rows_map(&res_map, res, batch, n, d, dgk::STEP)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(sgu_dgate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dgk::SMEM));
  if (err != cudaSuccess) return err;
  const int row_tiles = ceil_div(n, dgk::ROWS), col_tiles = ceil_div(d, dgk::COLS);
  sgu_dgate_kernel<<<batch * row_tiles * col_tiles, dgk::THREADS, dgk::SMEM, stream>>>(
      w_map, dout_map, res_map, static_cast<bf16*>(dgate), n, d, row_tiles, col_tiles);
  return cudaGetLastError();
}

cudaError_t launch_dgate_f32(const void* w, const void* dout, const void* res, void* dgate,
                             int batch, int n, int d, cudaStream_t stream) {
  constexpr size_t bytes = Layout<float>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      sgu_dgate_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(d, TN), ceil_div(n, TM), batch);
  sgu_dgate_f32_kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(dout),
      static_cast<const float*>(res), static_cast<float*>(dgate), n, ceil8(n), d);
  return cudaGetLastError();
}

cudaError_t launch_dgate_tf32x3(const void* w, const void* dout, const void* res,
                                void* dgate, int batch, int n, int d, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sgu_dgate_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dg3::SMEM));
  if (err != cudaSuccess) return err;
  const int row_tiles = ceil_div(n, dg3::ROWS), col_tiles = ceil_div(d, dg3::COLS);
  sgu_dgate_tf32x3_kernel<<<batch * row_tiles * col_tiles, dg3::THREADS, dg3::SMEM, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(dout),
      static_cast<const float*>(res), static_cast<float*>(dgate), batch, n, d, ceil8(n),
      col_tiles);
  return cudaGetLastError();
}

cudaError_t launch_dw_bf16(const void* dout, const void* res, const void* gate, void* work,
                           void* dw, int batch, int n, int d, int splits,
                           cudaStream_t stream) {
  const int side = ceil_div(n, dwk::TILE);
  const int tiles = side * (side + 1) / 2;
  const int chunks = ceil_div(d, dwk::STEP);
  const int steps = batch * chunks;
  if (splits < 1 || splits > steps) return cudaErrorInvalidValue;
  CUtensorMap dout_map, res_map, gate_map;
  if (!bf16_rows_map(&dout_map, dout, batch, n, d, dwk::TILE) ||
      !bf16_rows_map(&res_map, res, batch, n, d, dwk::TILE) ||
      !bf16_rows_map(&gate_map, gate, batch, n, d, dwk::TILE)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(sgu_dw_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dwk::SMEM));
  if (err != cudaSuccess) return err;
  sgu_dw_partial_kernel<<<tiles * splits, dwk::THREADS, dwk::SMEM, stream>>>(
      dout_map, res_map, gate_map, static_cast<float*>(work), tiles, chunks, steps, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_reduce<bf16>(work, dw, n, tiles, splits, stream);
}

cudaError_t launch_dw_tf32x3(const void* dout, const void* res, const void* gate, void* work,
                             void* dw, int batch, int n, int d, int splits,
                             cudaStream_t stream) {
  const int side = ceil_div(n, dw3::TILE);
  const int tiles = side * (side + 1) / 2;
  const int chunks = ceil_div(d, dw3::STEP);
  const int steps = batch * chunks;
  if (splits < 1 || splits > steps) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sgu_dw_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dw3::SMEM));
  if (err != cudaSuccess) return err;
  sgu_dw_tf32x3_kernel<<<tiles * splits, dw3::THREADS, dw3::SMEM, stream>>>(
      static_cast<const float*>(dout), static_cast<const float*>(res),
      static_cast<const float*>(gate), static_cast<float*>(work), n, d, tiles, chunks, steps,
      splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_reduce<float>(work, dw, n, tiles, splits, stream);
}

cudaError_t launch_dw_f32(const void* dout, const void* res, const void* gate, void* dw,
                          int batch, int n, int d, cudaStream_t stream) {
  constexpr size_t bytes = DwLayout::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      sgu_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = ceil_div(n, DT);
  sgu_dw_f32_kernel<<<dim3(tiles, tiles), THREADS, bytes, stream>>>(
      static_cast<const float*>(dout), static_cast<const float*>(res),
      static_cast<const float*>(gate), static_cast<float*>(dw), batch, n, d);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int d) {
  return batch <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || batch > 65535;
}

}  // namespace

// The wgmma route of K2-dgate: bfloat16 only (dtype 1); w (n, n) with rows
// ceil8(n) elements apart; dout, res, dgate (batch, n, d) contiguous; d a
// multiple of 8, every pointer 16-byte aligned.  Returns the CUDA error code
// of the launch (0 = ok).
extern "C" int sgu_bwd_dgate_wgmma(const void* w, const void* dout, const void* res,
                                   void* dgate, int batch, int n, int d, int dtype,
                                   void* stream) {
  if (bad_shape(batch, n, d) || dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dgate_bf16(w, dout, res, dgate, batch, n, d,
                                            static_cast<cudaStream_t>(stream)));
}

// The tf32x3 route of K2-dgate: float32 only (dtype 0), the same layout.
extern "C" int sgu_bwd_dgate_tf32x3(const void* w, const void* dout, const void* res,
                                    void* dgate, int batch, int n, int d, int dtype,
                                    void* stream) {
  if (bad_shape(batch, n, d) || dtype != 0 ||
      static_cast<long long>(batch) * ceil_div(n, dg3::ROWS) * ceil_div(d, dg3::COLS) >
          0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_dgate_tf32x3(w, dout, res, dgate, batch, n, d,
                                              static_cast<cudaStream_t>(stream)));
}

// The fma route of K2-dgate: float32 only (dtype 0), the same layout.
extern "C" int sgu_bwd_dgate(const void* w, const void* dout, const void* res, void* dgate,
                             int batch, int n, int d, int dtype, void* stream) {
  if (bad_shape(batch, n, d) || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dgate_f32(w, dout, res, dgate, batch, n, d,
                                           static_cast<cudaStream_t>(stream)));
}

// The fma route of K2-dW: dout, res, gate (batch, n, d) contiguous; dw
// (n, n); float32 only (dtype 0).  Returns the CUDA error code of the
// launch (0 = ok).
extern "C" int sgu_bwd_dw(const void* dout, const void* res, const void* gate,
                          void* dw, int batch, int n, int d, int dtype,
                          void* stream) {
  if (bad_shape(batch, n, d) || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_dw_f32(dout, res, gate, dw, batch, n, d, static_cast<cudaStream_t>(stream)));
}

// The wgmma (bfloat16) and tf32x3 (float32) routes of K2-dW, over `splits`
// ranges of the (batch, channel) axis: dout, res, gate (batch, n, d)
// contiguous, 16-byte aligned, d a multiple of 8; work an f32 workspace of
// splits * T * 128 * 128 entries, T = t (t + 1) / 2 and t = ceil(n / 128);
// dw (n, n) in the inputs' dtype.  1 <= splits <= batch * ceil(d / step),
// step 64 (wgmma) or 32 (tf32x3).  Two launches: the partial products,
// then their sum.  Return the CUDA error code (0 = ok).
extern "C" int sgu_bwd_dw_wgmma(const void* dout, const void* res, const void* gate,
                                void* work, void* dw, int batch, int n, int d,
                                int splits, void* stream) {
  if (bad_shape(batch, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dw_bf16(dout, res, gate, work, dw, batch, n, d, splits,
                                         static_cast<cudaStream_t>(stream)));
}

extern "C" int sgu_bwd_dw_tf32x3(const void* dout, const void* res, const void* gate,
                                 void* work, void* dw, int batch, int n, int d,
                                 int splits, void* stream) {
  if (bad_shape(batch, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dw_tf32x3(dout, res, gate, work, dw, batch, n, d, splits,
                                           static_cast<cudaStream_t>(stream)));
}
