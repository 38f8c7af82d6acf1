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
// gradients) once, 84.4 and 101.2 MB in bf16, for 16.1 and 21.5 GFLOP of
// visible-key work: ~190-210 flops per byte, under the H100's ~295
// flops/byte ridge, so the bound is the bytes, if not by much.  The 64-row
// tiles execute ~10% more (the diagonal tiles' masked half).
//
// Two routes, chosen before the launch by cuda_attention.bwd_route from the
// dtype, dim_head and window alone, each under its own extern "C" names:
//
// "wgmma" (local_attention_bwd_{dq,dkv}_wgmma): bf16, dim_head 64 or 128,
// windows that are multiples of 128 (every shipped config but `default`).
// A block of three warpgroups owns 128 rows of one window: query rows for
// dq, key rows for dkv.  One producer thread keeps their own tiles resident
// in shared memory (q and dout, or k and v) and streams 64-row tiles of the
// other side (k and v, or q, dout and the tile's lse and D) through a
// 4-stage ring of 128-byte-swizzled TMA copies.  Each of the two consumer
// warpgroups owns 64 rows: it runs the first products of a step (s and dp,
// or their transposes) as wgmma from shared memory into registers, forms p
// and ds in registers, and runs the second products (ds.k; p^T.dout,
// ds^T.q) as wgmma with p or ds as the register A operand, the f32
// gradient in registers for the whole walk.  K1-dkv makes two passes over
// its query tiles, dv first, then dk: both accumulators (128 registers) and
// a step's s^T and dp^T (64) spilled in one pass, even with setmaxnreg
// giving the consumers 240, while each pass fits the 168 a thread that
// three warpgroups get without it.  A
// (row tile, streamed tile) pair is full, diagonal (the causal mask in
// registers) or skipped, and only the tiles some warpgroup sees are loaded.
// Every output element is written by one block, once: no atomics, the same
// bits every run.
//
// "wmma" (local_attention_bwd_{dq,dkv}): f32 (the comparison path),
// dim_head 32 and the other windows.  One block of 4 warps owns 64 rows,
// each warp 16 of them.  The block streams tiles of the other side (64 rows
// in bf16, 32 in f32, so the f32 tiles fit in shared memory at D = 128) and
// skips the tiles that no row of the block sees; visibility is decided per
// element, since a 64-row tile can straddle windows when wsz < 64.  Both
// products of a step go to shared memory in f32, p and ds are formed per
// element, and the f32 gradient accumulators stay in shared memory.  bf16
// runs the products through WMMA (16x16x16, f32 accumulate); f32 runs FMA
// loops.

#include <cuda.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>

#include <cstdint>

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace nvcuda;
using progen::bf16;
using progen::from_f;
using progen::Pad;
using namespace progen::attention;
using namespace progen::hopper;

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

// -- bf16 on Hopper: a TMA ring into wgmma (the "wgmma" route) ----------------

namespace wg {

using namespace progen::attention::wgmma;

constexpr int ROWV = 2 * TROWS * 4;  // K1-dkv: a tile's 64 lse and 64 D values

// Shared memory: each consumer warpgroup's two resident 64-row tiles (q and
// dout for dq, k and v for dkv), then the ring's stages of two streamed
// tiles (k and v, or q and dout), then K1-dkv's per-stage lse and D, then the
// barriers.  A 64-row tile is D / 64 boxes of 64 columns, each 128-byte
// swizzled (rows of 128 bytes, 8-row atoms of 1024 bytes).
template <int D>
struct Layout {
  static constexpr int TILE = (D / 64) * BOX;
  static constexpr int RES = 0;
  static constexpr int RING = RES + 2 * 2 * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int ROWVALS = RING + STAGES * STAGE;
  static constexpr int BARS = ROWVALS + STAGES * ROWV;
  static constexpr size_t SMEM = 1024 + BARS + (2 * STAGES + 1) * sizeof(uint64_t);
  static constexpr int LDO = D + 8;  // epilogue rows (bf16), staged in the resident tiles
  static_assert(TROWS * LDO * 2 <= 2 * TILE, "the epilogue fits the warpgroup's tiles");
};

// Write a warpgroup's 64 x D f32 accumulator, times `mul`, cast once, to
// rows `row`.. of `dst`: staged as bf16 in `stage` (the warpgroup's own
// resident tiles, free once its products are done), then 16-byte stores.
template <int D>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, const float (&acc)[D / 2],
                                           float mul, size_t row, unsigned char* stage,
                                           int named) {
  constexpr int LDO = Layout<D>::LDO;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int lr = 16 * (tid / 32) + lane / 4;
  bf16* st = reinterpret_cast<bf16*>(stage);
  named_sync(named, 128);  // every warp of the warpgroup is done with the tiles
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(st + lr * LDO + col) =
        __floats2bfloat162_rn(acc[4 * i] * mul, acc[4 * i + 1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(st + (lr + 8) * LDO + col) =
        __floats2bfloat162_rn(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
  }
  named_sync(named, 128);
  for (int v = tid; v < TROWS * (D / 8); v += 128) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + (row + r) * D + c) =
        *reinterpret_cast<const uint4*>(st + r * LDO + c);
  }
}

// Write a warpgroup's 64 x D f32 accumulator, times `mul`, cast once, to
// rows `row`.. of `dst` straight from the fragment (bf16 pairs), where no
// shared memory is free to stage it.
template <int D>
__device__ __forceinline__ void store_fragment(bf16* __restrict__ dst,
                                               const float (&acc)[D / 2], float mul,
                                               size_t row) {
  const int lane = threadIdx.x % 32;
  const size_t r = row + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(dst + r * D + col) =
        __floats2bfloat162_rn(acc[4 * i] * mul, acc[4 * i + 1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * D + col) =
        __floats2bfloat162_rn(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
  }
}

}  // namespace wg

// K1-dq, bf16: block (b0 / 128, b*h) owns query rows [b0, b0 + 128).  The
// producer loads the block's q and dout once and streams k and v tiles; a
// consumer warpgroup forms s = q.k^T and dp = dout.v^T for its 64 rows by
// wgmma from shared memory, p and ds in registers, and dq += ds.k with ds
// as the register A operand; dq stays in registers for the whole walk.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
local_attention_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const float* __restrict__ lse, const float* __restrict__ dd,
                                bf16* __restrict__ dq, int seq, int wsz, float scale) {
  using namespace wg;
  using S = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int b0 = blockIdx.x * ROWS;
  const int row0 = blockIdx.y * seq;
  const int first = dq_first(b0, wsz);
  const int tiles = dq_tiles(b0, wsz);
  const int group = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_barriers(full, empty, resident);

  if (group == 2) {  // the producer: one thread issues every copy
    if (tid == 0) {
      mbar_expect_tx(resident, 4 * S::TILE);
      for (int g = 0; g < 2; ++g) {
        unsigned char* res = smem + S::RES + g * 2 * S::TILE;
        load_tile<D>(res, &q_map, resident, row0 + b0 + TROWS * g);
        load_tile<D>(res + S::TILE, &do_map, resident, row0 + b0 + TROWS * g);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait_or_trap(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + S::RING + s * S::STAGE;
        mbar_expect_tx(&full[s], S::STAGE);
        load_tile<D>(buf, &k_map, &full[s], row0 + first + TROWS * it);
        load_tile<D>(buf + S::TILE, &v_map, &full[s], row0 + first + TROWS * it);
      }
    }
    return;
  }

  const int r0 = b0 + TROWS * group;
  const int lane = tid % 32;
  const int lr = 16 * (tid / 32) + lane / 4;  // this thread's rows: lr, lr + 8
  const size_t at = static_cast<size_t>(row0) + r0 + lr;
  const float lse2[2] = {lse[at] * LOG2E, lse[at + 8] * LOG2E};
  const float dd_r[2] = {dd[at], dd[at + 8]};
  const float scale2 = scale * LOG2E;  // p = 2^(s scale log2 e - lse log2 e)
  unsigned char* qs = smem + S::RES + group * 2 * S::TILE;
  const unsigned char* dos = qs + S::TILE;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  mbar_wait_or_trap(resident, 0);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % STAGES, t0 = first + TROWS * it;
    const int kind = dq_kind(r0, t0);
    mbar_wait_or_trap(&full[s], (it / STAGES) & 1);
    const unsigned char* ks = smem + S::RING + s * S::STAGE;
    if (kind != SKIPPED) {
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
      wgmma_fence();
      scores<D>(sc, qs, ks);
      scores<D>(dp, dos, ks + S::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      fence_operands(dp);
      // fragment element 4 i + 2 h + x: row lr + 8 h, key column
      // 8 i + 2 (lane % 4) + x; on the diagonal tile key c sees row r only
      // if c <= r (p = 0 is what the -1e10 fill gives)
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 4 * i + 2 * h + x;
            const int r = lr + 8 * h, c = 8 * i + 2 * (lane % 4) + x;
            ds[x] = 0.0f;
            if (kind == FULL || c <= r) {
              const float p = exp2f(fmaf(sc[e], scale2, -lse2[h]));
              ds[x] = p * (dp[e] - dd_r[h]);
            }
          }
          a_slot(a, i, h) = pack_bf16(ds[0], ds[1]);
        }
      }
      wgmma_fence();
      accumulate<D>(acc, a, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
    }
    if (tid == 0) mbar_arrive(&empty[s]);  // a skipping warpgroup arrives too
  }
  store_tile<D>(dq, acc, scale, static_cast<size_t>(row0) + r0, qs, 1 + group);
}

// K1-dkv, bf16: block (b0 / 128, b*h) owns key rows [b0, b0 + 128) and
// computes their dk and dv in two passes over the query tiles that see them
// (dk and dv together would need 128 accumulator registers beside a tile's
// s^T and dp^T).  The producer loads the block's k and v once and streams
// the q and dout tiles, with their 64 lse and D values, twice.  A consumer
// warpgroup first forms s^T = k.q^T for its 64 keys and p^T in registers,
// and dv += p^T.dout with p^T as the register A operand; it writes dv, then
// forms s^T and dp^T = v.dout^T, ds^T in registers, and dk += ds^T.q.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
local_attention_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap do_map,
                                 const float* __restrict__ lse, const float* __restrict__ dd,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int seq,
                                 int wsz, float scale) {
  using namespace wg;
  using S = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int b0 = blockIdx.x * ROWS;
  const int row0 = blockIdx.y * seq;
  const int tiles = dkv_tiles(b0, wsz, seq);
  const int group = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_barriers(full, empty, resident);

  if (group == 2) {
    if (tid == 0) {
      mbar_expect_tx(resident, 4 * S::TILE);
      for (int g = 0; g < 2; ++g) {
        unsigned char* res = smem + S::RES + g * 2 * S::TILE;
        load_tile<D>(res, &k_map, resident, row0 + b0 + TROWS * g);
        load_tile<D>(res + S::TILE, &v_map, resident, row0 + b0 + TROWS * g);
      }
      for (int j = 0; j < 2 * tiles; ++j) {  // both passes' tiles, in order
        const int s = j % STAGES, row = row0 + b0 + TROWS * (j % tiles);
        mbar_wait_or_trap(&empty[s], ((j / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + S::RING + s * S::STAGE;
        float* rowv = reinterpret_cast<float*>(smem + S::ROWVALS + s * ROWV);
        mbar_expect_tx(&full[s], S::STAGE + ROWV);
        load_tile<D>(buf, &q_map, &full[s], row);
        load_tile<D>(buf + S::TILE, &do_map, &full[s], row);
        bulk_load(rowv, lse + row, TROWS * 4, &full[s]);
        bulk_load(rowv + TROWS, dd + row, TROWS * 4, &full[s]);
      }
    }
    return;
  }

  const int r0 = b0 + TROWS * group;
  const int lane = tid % 32;
  const int lr = 16 * (tid / 32) + lane / 4;  // this thread's key rows: lr, lr + 8
  const float scale2 = scale * LOG2E;
  unsigned char* ks = smem + S::RES + group * 2 * S::TILE;
  const unsigned char* vs = ks + S::TILE;
  const size_t row = static_cast<size_t>(row0) + r0;
  mbar_wait_or_trap(resident, 0);

  // fragment element 4 i + 2 h + x: key row lr + 8 h, query column
  // c = 8 i + 2 (lane % 4) + x; on the diagonal tile query c sees key r
  // only if c >= r
  {  // pass 1: dv
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % STAGES;
      const int kind = dkv_kind(r0, b0 + TROWS * it);
      mbar_wait_or_trap(&full[s], (it / STAGES) & 1);
      const unsigned char* qs = smem + S::RING + s * S::STAGE;
      const float* rowv = reinterpret_cast<const float*>(smem + S::ROWVALS + s * ROWV);
      if (kind != SKIPPED) {
        float st[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = 0.0f;
        wgmma_fence();
        scores<D>(st, ks, qs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(st);
        uint32_t pa[4][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * i + 2 * (lane % 4);
          const float2 l = *reinterpret_cast<const float2*>(rowv + c);
          const float lse2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              p[x] = 0.0f;
              if (kind == FULL || c + x >= lr + 8 * h) {
                p[x] = exp2f(fmaf(st[4 * i + 2 * h + x], scale2, -lse2[x]));
              }
            }
            a_slot(pa, i, h) = pack_bf16(p[0], p[1]);
          }
        }
        wgmma_fence();
        accumulate<D>(acc, pa, qs + S::TILE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
      }
      if (tid == 0) mbar_arrive(&empty[s]);  // a skipping warpgroup arrives too
    }
    store_fragment<D>(dv, acc, 1.0f, row);
  }
  {  // pass 2: dk
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    for (int it = 0; it < tiles; ++it) {
      const int j = tiles + it, s = j % STAGES;
      const int kind = dkv_kind(r0, b0 + TROWS * it);
      mbar_wait_or_trap(&full[s], (j / STAGES) & 1);
      const unsigned char* qs = smem + S::RING + s * S::STAGE;
      const float* rowv = reinterpret_cast<const float*>(smem + S::ROWVALS + s * ROWV);
      if (kind != SKIPPED) {
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;
        wgmma_fence();
        scores<D>(st, ks, qs);
        scores<D>(dpt, vs, qs + S::TILE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(st);
        fence_operands(dpt);
        uint32_t da[4][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * i + 2 * (lane % 4);
          const float2 l = *reinterpret_cast<const float2*>(rowv + c);
          const float2 d = *reinterpret_cast<const float2*>(rowv + TROWS + c);
          const float lse2[2] = {l.x * LOG2E, l.y * LOG2E}, dd_c[2] = {d.x, d.y};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float ds[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int e = 4 * i + 2 * h + x;
              ds[x] = 0.0f;
              if (kind == FULL || c + x >= lr + 8 * h) {
                const float p = exp2f(fmaf(st[e], scale2, -lse2[x]));
                ds[x] = p * (dpt[e] - dd_c[x]);
              }
            }
            a_slot(da, i, h) = pack_bf16(ds[0], ds[1]);
          }
        }
        wgmma_fence();
        accumulate<D>(acc, da, qs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
      }
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    store_tile<D>(dk, acc, scale, row, ks, 1 + group);
  }
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

bool maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
          const void* dout, int bh, int seq, int d) {
  using progen::attention::wgmma::tile_map;
  const long long rows = static_cast<long long>(bh) * seq;
  return tile_map(&m[0], q, rows, d) && tile_map(&m[1], k, rows, d) &&
         tile_map(&m[2], v, rows, d) && tile_map(&m[3], dout, rows, d);
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dd, void* dq, int bh, int seq,
                            int wsz, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!maps(m, q, k, v, dout, bh, seq, D)) return cudaErrorInvalidValue;
  constexpr size_t bytes = wg::Layout<D>::SMEM;
  auto kernel = local_attention_dq_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(seq / wg::ROWS, bh), wg::THREADS, bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dq), seq, wsz, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dd, void* dk, void* dv, int bh,
                             int seq, int wsz, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!maps(m, q, k, v, dout, bh, seq, D)) return cudaErrorInvalidValue;
  constexpr size_t bytes = wg::Layout<D>::SMEM;
  auto kernel = local_attention_dkv_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(seq / wg::ROWS, bh), wg::THREADS, bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq,
      wsz, scale);
  return cudaGetLastError();
}

// The wgmma route takes bf16, dim_head 64 or 128 and windows that are
// multiples of 128 (cuda_attention.bwd_route decides before the launch).
bool bad_wgmma_shape(int bh, int seq, int dim_head, int wsz, int dtype) {
  return bad_shape(bh, seq, wsz) || dtype != 1 || wsz % wg::ROWS != 0 ||
         (dim_head != 64 && dim_head != 128) ||
         static_cast<long long>(bh) * seq > 0x7FFFFFFF;
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

// The wgmma route of K1-dq: bfloat16 only (dtype 1), dim_head 64 or 128,
// wsz a multiple of 128, every pointer 16-byte aligned; arguments as for
// local_attention_bwd_dq.  Returns the CUDA error code of the launch.
extern "C" int local_attention_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* dd, void* dq, int bh, int seq,
                                            int dim_head, int wsz, float scale, int dtype,
                                            void* stream) {
  if (bad_wgmma_shape(bh, seq, dim_head, wsz, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dim_head == 64
      ? launch_dq_wgmma<64>(q, k, v, dout, lse, dd, dq, bh, seq, wsz, scale, s)
      : launch_dq_wgmma<128>(q, k, v, dout, lse, dd, dq, bh, seq, wsz, scale, s);
  return static_cast<int>(err);
}

// The wgmma route of K1-dkv, as above.
extern "C" int local_attention_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* dd, void* dk, void* dv, int bh,
                                             int seq, int dim_head, int wsz, float scale,
                                             int dtype, void* stream) {
  if (bad_wgmma_shape(bh, seq, dim_head, wsz, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dim_head == 64
      ? launch_dkv_wgmma<64>(q, k, v, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s)
      : launch_dkv_wgmma<128>(q, k, v, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s);
  return static_cast<int>(err);
}
