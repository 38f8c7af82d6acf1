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
// With a halo (k_halo, v_halo: (B*H, wsz, D), the left neighbour's last
// window under context parallelism, pallas_local_attention_ext's first
// window of k_ext/v_ext) window 0's previous window is the halo: K1-dq reads
// it as it reads any key window, and K1-dkv runs wsz / 128 (wgmma) or
// ceil(wsz / 64) (wmma) more blocks per sequence, for the halo's keys, whose
// users are the queries of window 0 (all of them, no mask); they write
// dk_halo and dv_halo (B*H, wsz, D), which the caller sends back to the
// neighbour.  A null halo takes the same instructions as before it existed.
//
// What bounds them on this card: at ProGen-small (B = 8, H = 8, L = 1024,
// D = 128, wsz = 256) each reads q, k, v, dout (and writes one or two
// gradients) once, 84.4 and 101.2 MB in bf16, for 16.1 and 21.5 GFLOP of
// visible-key work: ~190-210 flops per byte, under the H100's ~295
// flops/byte ridge, so the bound is the bytes, if not by much.  The 64-row
// tiles execute ~10% more (the diagonal tiles' masked half).
//
// Three routes, chosen before the launch by cuda_attention.dq_route and
// dkv_route from the dtype, dim_head and window alone, each under its own
// extern "C" names:
//
// "wgmma" (local_attention_bwd_{dq,dkv}_wgmma): bf16, dim_head 64 or 128,
// windows that are multiples of 128 (every shipped config but `default`;
// dim_head 32, `default`, has kernels of its own, below).
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
// K1-dkv in bf16 at dim_head 32 (ProGen-default under `train
// --mixed_precision`) has a kernel of its own on the same route, reached
// through local_attention_bwd_dkv_wgmma.  It replaced the "wmma" kernel there
// (0.0998 ms at B 4 and 0.3642 at B 32 on an H100, 1.85x and 1.30x one
// scaled_dot_product_attention backward of dq, dk and dv together).  What
// bounds it: 1.61 GFLOP at B 4 (0.0016 ms at the bf16 peak) over 4.8 MB,
// and one ex2 a visible pair (0.0015 ms at B 4 on the SFUs).  At dim_head
// 32 dk and dv take 32 registers a thread beside 64 for a tile's s^T and
// dp^T, so one pass fits (the dim_head-128 design makes two, one ex2 a pair
// each): a block is one consumer warpgroup of 64 keys and one producer
// warp (attention_wgmma.cuh, d32), 44 KB of shared memory, launched longest
// walk first (d32::dkv_block_row: the f32 route's 64-key blocks, the
// halo's last); k and v arrive once, and the 64-query tiles of q and dout
// with their lse and D values through a 4-stage ring of 64-byte-swizzled
// TMA boxes.  Per tile s^T = k.q^T and dp^T = v.dout^T by wgmma m64n64k16
// from shared memory, p^T and ds^T in registers, then dv += p^T.dout and
// dk += ds^T.q by wgmma m64n32k16 with p^T and ds^T as bf16 register A
// operands and dout and q N-major; dk is scaled once.  A block's first tile
// is its diagonal one (masked in registers); every output element is
// written by one thread, once.
//
// K1-dq in bf16 at dim_head 32 has one too, reached through
// local_attention_bwd_dq_wgmma: K1-fwd's dim_head-32 kernel turned into dq,
// with no online softmax since the lse is known.  It replaced the "wmma"
// kernel there (0.0780 ms at B 4 and 0.3059 at B 32 on an H100, 1.43x and
// 1.09x one scaled_dot_product_attention backward of dq, dk and dv
// together).  What bounds it: 1.21 GFLOP at B 4 (0.0012 ms at the bf16
// peak) over 4.0 MB, and one ex2 a visible pair (0.0015 ms at B 4 on the
// SFUs).  A block is one consumer warpgroup of 64 query rows and one
// producer warp, 42 KB of shared memory, launched in K1-fwd's
// longest-walk-first order (d32::fwd_block_row); q and dout arrive once,
// each row's lse and D are read once into registers, and the 64-key k and v
// tiles stream through a 4-stage ring of 64-byte-swizzled TMA boxes.  Per
// tile s = q.k^T and dp = dout.v^T by wgmma m64n64k16 from shared memory,
// p and ds in registers, then dq += ds.k by wgmma m64n32k16 with ds as the
// bf16 register A operand and k N-major.  Only the last tile of a walk is
// the diagonal one (masked in registers); dq is scaled once and every
// element written by one thread, once.
//
// "tf32x3" (local_attention_bwd_{dq,dkv}_tf32x3): f32 with dim_head 64 or
// 128 and windows that are multiples of 128 (the "wgmma" route's shapes;
// f32 is the default of both training CLIs).  They replaced the "wmma"
// kernels' f32 FMA loops (K1-dkv 2.56 ms and K1-dq 2.36 ms at B 8 with a
// halo; together 3.3x one scaled_dot_product_attention backward).  What
// bounds them: 25.8 and 19.4 GFLOP at B 8 with the halo, each product
// f32-accurate as three TF32 products (attention_tf32x3.cuh), so at least
// 3 x FLOPs / 495 TFLOP/s = 0.156 and 0.117 ms, over ~235 and ~185 MB
// (0.070 and 0.055 ms): the operations.
//
// K1-dkv: a block of eight warps owns
// 128 keys of one window (or of the halo), k and v resident in shared
// memory; the 32-query tiles of q and dout, with their lse and D, stream
// through a two-stage cp.async ring into padded f32 rows.  Each warp owns
// 16 keys: s^T = k.q^T and dp^T = v.dout^T by mma.sync m16n8k8 TF32, each
// operand split into hi + lo in registers as its fragment is loaded; p^T
// and ds^T on the f32 fragments; dv += p^T.dout and dk += ds^T.q with p^T
// and ds^T split in registers and dout and q read N-major.  One pass: dk
// and dv (2 x D / 2 registers a thread at D = 128) stay in registers beside
// a tile's s^T and dp^T (32), since a 32-query tile keeps those small.  A
// warp skips what its keys do not see; every output element is written by
// one thread, once: the same bits every run.
//
// K1-dkv at dim_head 32 (ProGen-default, the training CLI's default run)
// has a kernel of its own on the same route.  It replaced the "wmma"
// kernel's FMA loops there (0.417 ms at B 4 on an H100, 1.37x one f32
// scaled_dot_product_attention backward of dq, dk and dv together).  What
// bounds it: 1.612 GFLOP at B 4, 3 x FLOPs / 495 TFLOP/s = 0.0098 ms, over
// 9.5 MB: the operations; at B 4 (192 blocks) the longest block's walk
// bounds the launch, a key block of window 0 streaming 32 query tiles.  A
// block is four warps of 64 keys (two resident an SM, 37 KB), launched
// longest walk first (d32::dkv_block_row: every window but the last by
// place, then the last; the halo's blocks after); each warp splits its
// 16 x 32 k and v fragments into hi and lo once and holds them (64
// registers) beside dk and dv (32) for the whole walk, so only the
// streamed q and dout are split per tile.  193 registers, no spills.
//
// K1-dq at dim_head 32 has one too: K1-fwd's dim_head-32 kernel turned
// into dq.  It replaced the "wmma" kernel's FMA loops there (0.2275 ms at B
// 4 and 0.9714 at B 32 on an H100).  What bounds it: 1.21 GFLOP at B 4,
// 3 x FLOPs / 495 TFLOP/s = 0.0073 ms, over 8 MB: the operations.  A block
// is four warps of 64 query rows (37 KB), launched in K1-fwd's
// longest-walk-first order; the k and v tiles of 32 keys stream through the
// two-stage cp.async ring; each warp splits its 16 x 32 q and dout
// fragments into hi and lo once and holds them (64 registers) beside dq
// (16) for the whole walk, so only the streamed k and v are split per
// tile.  Three blocks an SM (168 registers, 8 B of spills) ran 1-5% and
// 5-7% faster at B 4 and B 32 on an H100 than two with 64-key tiles (253
// registers, the first design; kernels.ablate local_attention_bwd_dq_d32).
//
// K1-dq: K1-dkv turned round.  A block of eight warps owns 128 query rows
// of one window, in K1-fwd's longest-walk-first order (block_row), q and
// dout resident in shared memory (rows of D + 4 words: 135 KB at D = 128);
// the 32-key tiles of k and v stream through the two-stage cp.async ring
// (67.6 KB), from the previous window's first key (the halo's, at
// t0 < 0, when one is given; none for window 0 without one, whose phantom
// keys add nothing to dq) to the block's last row.  Each warp owns 16
// rows, whose lse and D it reads once: per tile s = q.k^T and dp =
// dout.v^T (16 x 32) in registers, p = exp(s scale - lse) and ds = p (dp -
// D) there, then dq += ds.k with ds as split A fragments and k read
// N-major, as K1-fwd's p.v.  dq (16 x D) stays in registers for the whole
// walk and is scaled and written once.  A warp skips the tiles whose keys
// all come after its rows; the diagonal tile is masked in registers.  No
// atomics: the same bits every run.
//
// "wmma" (local_attention_bwd_{dq,dkv}): windows that are not a multiple of
// 128, and what a caller forces onto it.  One block of 4 warps owns 64 rows,
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

#include "attention_tf32x3.cuh"
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
                          const T* __restrict__ v, const T* __restrict__ k_halo,
                          const T* __restrict__ v_halo, const T* __restrict__ dout,
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
  const size_t hbase = static_cast<size_t>(blockIdx.y) * wsz * D;
  const T* kh = k_halo != nullptr ? k_halo + hbase : nullptr;
  const T* vh = v_halo != nullptr ? v_halo + hbase : nullptr;

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
    load_rows<T, D, L::BN>(ks, k + base, kt - wsz, seq, kh, wsz);
    load_rows<T, D, L::BN>(vs, v + base, kt - wsz, seq, vh, wsz);
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
                           const T* __restrict__ v, const T* __restrict__ k_halo,
                           const T* __restrict__ v_halo, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dd,
                           T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dk_halo,
                           T* __restrict__ dv_halo, int seq, int wsz, float scale) {
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
  // blocks past the sequence's own own the halo's keys, rows [-wsz, 0)
  const int own_blocks = (seq + BM - 1) / BM;
  const bool hb = static_cast<int>(blockIdx.x) >= own_blocks;
  const int k0 = hb ? (static_cast<int>(blockIdx.x) - own_blocks) * BM - wsz
                    : static_cast<int>(blockIdx.x) * BM;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seq;
  const size_t base = row0 * D;
  const size_t hbase = static_cast<size_t>(blockIdx.y) * wsz * D;

  if (hb) {
    load_rows<T, D, BM>(ks, k_halo + hbase, k0 + wsz, wsz);
    load_rows<T, D, BM>(vs, v_halo + hbase, k0 + wsz, wsz);
  } else {
    load_rows<T, D, BM>(ks, k + base, k0, seq);
    load_rows<T, D, BM>(vs, v + base, k0, seq);
  }
  for (int idx = threadIdx.x; idx < BM * L::LDO; idx += THREADS) {
    dks[idx] = 0.0f;
    dvs[idx] = 0.0f;
  }

  // this lane's key row j: its users are the queries i >= j of its own
  // window (causal) and every query of the next window; a halo key's are
  // the queries of window 0
  const int r = warp * 16 + (lane >> 1);
  const int h = lane & 1;
  const int j = k0 + r;
  const bool live = hb ? j < 0 : j < seq;
  const int i_end_j = hb ? wsz : (j / wsz + 2) * wsz;

  const int i_end = hb ? wsz : min(((min(k0 + BM, seq) - 1) / wsz + 2) * wsz, seq);
  for (int it = hb ? 0 : k0; it < i_end; it += L::BN) {
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
  if (hb) {
    store_rows<T, D>(dk_halo + hbase, dks, k0 + wsz, wsz, scale, warp);
    store_rows<T, D>(dv_halo + hbase, dvs, k0 + wsz, wsz, 1.0f, warp);
  } else {
    store_rows<T, D>(dk + base, dks, k0, seq, scale, warp);
    store_rows<T, D>(dv + base, dvs, k0, seq, 1.0f, warp);
  }
}

// -- K1-dkv in f32 on the tensor cores: 3xTF32 (the "tf32x3" route) ----------

namespace t3 = progen::attention::tf32x3;

// Shared memory: the block's 128 key rows of k and of v, then the ring's
// stages of a 32-query q tile, its dout tile and its 32 lse and D values;
// every row D + 4 words.
template <int D>
struct Dkv3Layout {
  static constexpr int LD = D + 4;
  static constexpr size_t K = 0;
  static constexpr size_t V = K + sizeof(float) * t3::ROWS * LD;
  static constexpr size_t RING = V + sizeof(float) * t3::ROWS * LD;
  static constexpr size_t STAGE = sizeof(float) * (2 * t3::QUERIES * LD + 2 * t3::QUERIES);
  static constexpr size_t SMEM = RING + t3::STAGES * STAGE;
};

// K1-dkv, f32: block (x, b*h) owns key rows [b0, b0 + 128) (b0 = 128 x) and
// streams the 32-query tiles of their users, from b0 to the end of the next
// window; with a halo, the blocks past the sequence's own own the halo's
// keys (b0 < 0) and stream the queries of window 0, every pair visible.
// Each warp owns 16 keys and, per tile, forms s^T = k.q^T and dp^T =
// v.dout^T (16 x 32) in registers, p^T = exp(s^T scale - lse) and ds^T =
// p^T (dp^T - D) there, then dv += p^T.dout and dk += ds^T.q with p^T and
// ds^T as split A fragments; dk and dv (16 x D each) stay in registers for
// the whole walk, every product 3xTF32.  A warp skips the tiles its keys
// have no user in; the diagonal tile is masked in registers.
template <int D>
__global__ void __launch_bounds__(t3::THREADS, 1)
local_attention_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ k_halo,
                                  const float* __restrict__ v_halo,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ dd,
                                  float* __restrict__ dk, float* __restrict__ dv,
                                  float* __restrict__ dk_halo, float* __restrict__ dv_halo,
                                  int seq, int wsz, float scale) {
  using S = Dkv3Layout<D>;
  constexpr int LD = S::LD;
  constexpr int QT = t3::QUERIES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + S::K);
  float* vs = reinterpret_cast<float*>(smem + S::V);

  const int own_blocks = seq / t3::ROWS;
  const bool hb = static_cast<int>(blockIdx.x) >= own_blocks;
  const int b0 = hb ? (static_cast<int>(blockIdx.x) - own_blocks) * t3::ROWS - wsz
                    : static_cast<int>(blockIdx.x) * t3::ROWS;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seq;
  // the first row of this block's keys in k (or in the halo)
  const size_t krow = hb ? static_cast<size_t>(blockIdx.y) * wsz + wsz + b0 : row0 + b0;
  const int i_first = hb ? 0 : b0;
  const int i_end = hb ? wsz : min((b0 / wsz + 2) * wsz, seq);
  const int tiles = (i_end - i_first) / QT;

  auto stage = [&](int it) {
    return reinterpret_cast<float*>(smem + S::RING + (it % t3::STAGES) * S::STAGE);
  };
  auto load = [&](int it) {  // q, dout, lse and D of query tile it
    const size_t at = row0 + i_first + QT * it;
    float* qs = stage(it);
    t3::copy_rows<D, QT>(qs, q + at * D);
    t3::copy_rows<D, QT>(qs + QT * LD, dout + at * D);
    float* rowv = qs + 2 * QT * LD;
    if (threadIdx.x < QT / 2) {  // 2 x 32 values, 16 bytes a thread
      const int w = threadIdx.x / (QT / 4), c = (threadIdx.x % (QT / 4)) * 4;
      progen::hopper::cp_async_16(rowv + w * QT + c, (w == 0 ? lse : dd) + at + c);
    }
  };
  const float* ksrc = hb ? k_halo : k;
  const float* vsrc = hb ? v_halo : v;
  t3::copy_rows<D, t3::ROWS>(ks, ksrc + krow * D);
  t3::copy_rows<D, t3::ROWS>(vs, vsrc + krow * D);
  load(0);
  progen::hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = b0 + 16 * warp;           // this warp's keys; the thread's: r0 + g (+ 8)
  const float scale2 = scale * t3::LOG2E;  // p = 2^(s scale log2 e - lse log2 e)
  const float* kw = ks + 16 * warp * LD;
  const float* vw = vs + 16 * warp * LD;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;
  }

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load(it + 1);
    progen::hopper::cp_async_commit();  // an empty group at the end keeps the count
    progen::hopper::cp_async_wait<1>();  // tile it (and k, v) have landed
    __syncthreads();
    const int i0 = i_first + QT * it;
    // a warp skips a tile whose queries all come before its keys; the
    // diagonal tile is computed whole and masked
    if (hb || i0 + QT - 1 >= r0) {
      const float* qs = stage(it);
      const float* dos = qs + QT * LD;
      const float* rowv = qs + 2 * QT * LD;
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
      }
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {  // s^T = k.q^T
        t3::FragA a;
        t3::FragB b[4];
        t3::load_a(a, kw + 8 * kk, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) t3::load_b_rows(b[j], qs + 8 * j * LD + 8 * kk, LD);
        t3::mma3<4>(st, a, b);
      }
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {  // dp^T = v.dout^T
        t3::FragA a;
        t3::FragB b[4];
        t3::load_a(a, vw + 8 * kk, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) t3::load_b_rows(b[j], dos + 8 * j * LD + 8 * kk, LD);
        t3::mma3<4>(dpt, a, b);
      }
      // element (j, 2 h + x): key r0 + g + 8 h, query c = 8 j + 2 t + x of
      // the tile, a user if it is at or after the key (own window; every
      // query of the next window and of window 0 for a halo key is)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int c = 8 * j + 2 * t + x;
          const float lse2 = rowv[c] * t3::LOG2E, dd_c = rowv[QT + c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + x;
            const bool user = hb || i0 + c >= r0 + g + 8 * h;
            const float p = user ? exp2f(fmaf(st[j][e], scale2, -lse2)) : 0.0f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dd_c);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t3::FragA pa, da;
        t3::a_from_c(pa, st[j]);
        t3::a_from_c(da, dpt[j]);
#pragma unroll
        for (int n0 = 0; n0 < D / 8; n0 += 8) {
          t3::FragB b[8];
#pragma unroll
          for (int n = 0; n < 8; ++n) t3::load_b_cols(b[n], dos + 8 * j * LD + 8 * (n0 + n), LD);
          t3::mma3<8>(acc_v + n0, pa, b);  // dv += p^T.dout
#pragma unroll
          for (int n = 0; n < 8; ++n) t3::load_b_cols(b[n], qs + 8 * j * LD + 8 * (n0 + n), LD);
          t3::mma3<8>(acc_k + n0, da, b);  // dk += ds^T.q
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* dk_out = (hb ? dk_halo : dk) + krow * D;
  float* dv_out = (hb ? dv_halo : dv) + krow * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = static_cast<size_t>(16 * warp + g + 8 * h) * D + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(dk_out + at) =
          make_float2(acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv_out + at) = make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_tf32x3(const void* q, const void* k, const void* v, const void* k_halo,
                              const void* v_halo, const void* dout, const void* lse,
                              const void* dd, void* dk, void* dv, void* dk_halo,
                              void* dv_halo, int bh, int seq, int wsz, float scale,
                              cudaStream_t stream) {
  constexpr size_t bytes = Dkv3Layout<D>::SMEM;
  auto kernel = local_attention_dkv_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (seq + (k_halo != nullptr ? wsz : 0)) / t3::ROWS;
  kernel<<<dim3(blocks, bh), t3::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(k_halo), static_cast<const float*>(v_halo),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dk_halo), static_cast<float*>(dv_halo), seq, wsz, scale);
  return cudaGetLastError();
}

// -- K1-dkv in f32 at dim_head 32: 3xTF32, k's and v's split held -----------

namespace d32 = progen::attention::tf32x3::d32;

// Shared memory: the block's 64 key rows of k and of v (read once, into the
// held split), then the ring's stages of a 32-query q tile, its dout tile
// and its 32 lse and D values; every row 36 words: 37,376 bytes.
struct Dkv3D32Layout {
  static constexpr size_t K = 0;
  static constexpr size_t V = K + sizeof(float) * d32::ROWS * d32::LD;
  static constexpr size_t RING = V + sizeof(float) * d32::ROWS * d32::LD;
  static constexpr size_t STAGE =
      sizeof(float) * (2 * d32::QUERIES * d32::LD + 2 * d32::QUERIES);
  static constexpr size_t SMEM = RING + t3::STAGES * STAGE;
};

// K1-dkv, f32, dim_head 32: block blk owns key rows [b0, b0 + 64)
// (d32::dkv_block_row of rank blk / bh, longest walk first) of sequence
// blk % bh and streams the 32-query tiles of their users, from b0 to the
// end of the next window; with a halo, the ranks past the sequence's own
// own the halo's keys (b0 < 0) and stream window 0's queries, every pair
// visible.  Each warp owns 16 keys: their k and v fragments are split into
// hi and lo once, after k and v land, and held in registers (64) for the
// whole walk; per tile only the streamed q and dout are split as their
// fragments load.  s^T = k.q^T and dp^T = v.dout^T (16 x 32), p^T and ds^T
// there, dv += p^T.dout and dk += ds^T.q (16 x 32 each, in registers for
// the whole walk), every product 3xTF32.  A warp skips the tiles its keys
// have no user in; the diagonal tiles are masked in registers.
__global__ void __launch_bounds__(d32::THREADS, 2)
local_attention_dkv_d32_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ k_halo,
                                      const float* __restrict__ v_halo,
                                      const float* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ dd, float* __restrict__ dk,
                                      float* __restrict__ dv, float* __restrict__ dk_halo,
                                      float* __restrict__ dv_halo, int bh, int seq, int wsz,
                                      float scale) {
  using S = Dkv3D32Layout;
  constexpr int D = d32::D, LD = d32::LD, QT = d32::QUERIES, THREADS = d32::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + S::K);
  float* vs = reinterpret_cast<float*>(smem + S::V);

  const int b0 = d32::dkv_block_row(blockIdx.x / bh, seq, wsz);
  const int sq = blockIdx.x % bh;
  const bool hb = b0 < 0;
  const size_t row0 = static_cast<size_t>(sq) * seq;
  // the first row of this block's keys in k (or in the halo)
  const size_t krow = hb ? static_cast<size_t>(sq) * wsz + wsz + b0 : row0 + b0;
  const int i_first = hb ? 0 : b0;
  const int i_end = hb ? wsz : min((b0 / wsz + 2) * wsz, seq);
  const int tiles = (i_end - i_first) / QT;

  auto stage = [&](int it) {
    return reinterpret_cast<float*>(smem + S::RING + (it % t3::STAGES) * S::STAGE);
  };
  auto load = [&](int it) {  // q, dout, lse and D of query tile it
    const size_t at = row0 + i_first + QT * it;
    float* qs = stage(it);
    progen::tf32x3::copy_rows<D, QT, THREADS>(qs, q + at * D);
    progen::tf32x3::copy_rows<D, QT, THREADS>(qs + QT * LD, dout + at * D);
    float* rowv = qs + 2 * QT * LD;
    if (threadIdx.x < QT / 2) {  // 2 x 32 values, 16 bytes a thread
      const int w = threadIdx.x / (QT / 4), c = (threadIdx.x % (QT / 4)) * 4;
      progen::hopper::cp_async_16(rowv + w * QT + c, (w == 0 ? lse : dd) + at + c);
    }
  };
  progen::tf32x3::copy_rows<D, d32::ROWS, THREADS>(ks, (hb ? k_halo : k) + krow * D);
  progen::tf32x3::copy_rows<D, d32::ROWS, THREADS>(vs, (hb ? v_halo : v) + krow * D);
  progen::hopper::cp_async_commit();
  load(0);
  progen::hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = b0 + 16 * warp;           // this warp's keys; the thread's: r0 + g (+ 8)
  const float scale2 = scale * t3::LOG2E;  // p = 2^(s scale log2 e - lse log2 e)
  progen::hopper::cp_async_wait<1>();  // k and v have landed (tile 0 may be in flight)
  __syncthreads();
  t3::FragA ka[D / 8], va[D / 8];  // the held split
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    t3::load_a(ka[kk], ks + 16 * warp * LD + 8 * kk, LD);
    t3::load_a(va[kk], vs + 16 * warp * LD + 8 * kk, LD);
  }
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;
  }

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load(it + 1);
    progen::hopper::cp_async_commit();  // an empty group at the end keeps the count
    progen::hopper::cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const int i0 = i_first + QT * it;
    // a warp skips a tile whose queries all come before its keys; the
    // diagonal tiles are computed whole and masked
    if (hb || i0 + QT - 1 >= r0) {
      const float* qs = stage(it);
      const float* dos = qs + QT * LD;
      const float* rowv = qs + 2 * QT * LD;
      float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {  // s^T = k.q^T
        t3::FragB b[QT / 8];
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) t3::load_b_rows(b[j], qs + 8 * j * LD + 8 * kk, LD);
        t3::mma3<QT / 8>(st, ka[kk], b);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {  // dp^T = v.dout^T
        t3::FragB b[QT / 8];
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) t3::load_b_rows(b[j], dos + 8 * j * LD + 8 * kk, LD);
        t3::mma3<QT / 8>(dpt, va[kk], b);
      }
      // element (j, 2 h + x): key r0 + g + 8 h, query c = 8 j + 2 t + x of
      // the tile, a user if it is at or after the key (own window; every
      // query of the next window and of window 0 for a halo key is)
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int c = 8 * j + 2 * t + x;
          const float lse2 = rowv[c] * t3::LOG2E, dd_c = rowv[QT + c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + x;
            const bool user = hb || i0 + c >= r0 + g + 8 * h;
            const float p = user ? exp2f(fmaf(st[j][e], scale2, -lse2)) : 0.0f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dd_c);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        t3::FragA pa, da;
        t3::a_from_c(pa, st[j]);
        t3::a_from_c(da, dpt[j]);
        t3::FragB b[D / 8];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) t3::load_b_cols(b[n], dos + 8 * j * LD + 8 * n, LD);
        t3::mma3<D / 8>(acc_v, pa, b);  // dv += p^T.dout
#pragma unroll
        for (int n = 0; n < D / 8; ++n) t3::load_b_cols(b[n], qs + 8 * j * LD + 8 * n, LD);
        t3::mma3<D / 8>(acc_k, da, b);  // dk += ds^T.q
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* dk_out = (hb ? dk_halo : dk) + krow * D;
  float* dv_out = (hb ? dv_halo : dv) + krow * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = static_cast<size_t>(16 * warp + g + 8 * h) * D + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(dk_out + at) =
          make_float2(acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv_out + at) = make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

cudaError_t launch_dkv_tf32x3_d32(const void* q, const void* k, const void* v,
                                  const void* k_halo, const void* v_halo, const void* dout,
                                  const void* lse, const void* dd, void* dk, void* dv,
                                  void* dk_halo, void* dv_halo, int bh, int seq, int wsz,
                                  float scale, cudaStream_t stream) {
  constexpr size_t bytes = Dkv3D32Layout::SMEM;
  auto kernel = local_attention_dkv_d32_tf32x3_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (seq + (k_halo != nullptr ? wsz : 0)) / d32::ROWS;
  kernel<<<blocks * bh, d32::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(k_halo), static_cast<const float*>(v_halo),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dk_halo), static_cast<float*>(dv_halo), bh, seq, wsz, scale);
  return cudaGetLastError();
}

// -- K1-dq in f32 at dim_head 32: 3xTF32, q's and dout's split held --------

constexpr int DQ32_KEYS = 32;        // keys of a streamed tile
constexpr int DQ32_F32_BLOCKS = 3;   // blocks an SM the registers are capped for

// Shared memory: the block's 64 query rows of q and of dout (read once, into
// the held split), then the ring's stages of a k tile and its v tile; every
// row 36 words: 36,864 bytes.
struct Dq3D32Layout {
  static constexpr size_t Q = 0;
  static constexpr size_t DOUT = Q + sizeof(float) * d32::ROWS * d32::LD;
  static constexpr size_t RING = DOUT + sizeof(float) * d32::ROWS * d32::LD;
  static constexpr size_t STAGE = sizeof(float) * 2 * DQ32_KEYS * d32::LD;
  static constexpr size_t SMEM = RING + t3::STAGES * STAGE;
};

// K1-dq, f32, dim_head 32: block blk owns query rows [b0, b0 + 64) of row
// block blk / bh (d32::fwd_block_row, K1-fwd's longest-walk-first order) of
// sequence blk % bh and walks the key tiles from the previous window's
// first (the halo's, at t0 < 0, when one is given; window 0 without one
// from key 0) to b0 + 63.  Each warp owns 16 rows, whose lse and D it reads
// once: their q and dout fragments are split into hi and lo once, after q
// and dout land, and held in registers (64) for the whole walk; per tile
// only the streamed k and v are split as their fragments load.  s = q.k^T
// and dp = dout.v^T (16 x DQ32_KEYS), p = 2^(s scale log2 e - lse log2 e)
// and ds = p (dp - D) there, dq += ds.k with ds as split A fragments and k
// read N-major (16 x 32, in registers for the whole walk), every product
// 3xTF32.  A warp skips the tiles whose keys all come after its rows; the
// tiles that reach past its first row are masked in registers.
__global__ void __launch_bounds__(d32::THREADS, DQ32_F32_BLOCKS)
local_attention_dq_d32_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ k_halo,
                                     const float* __restrict__ v_halo,
                                     const float* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ dd, float* __restrict__ dq,
                                     int bh, int seq, int wsz, float scale) {
  using S = Dq3D32Layout;
  constexpr int D = d32::D, LD = d32::LD, KT = DQ32_KEYS, THREADS = d32::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::Q);
  float* dos = reinterpret_cast<float*>(smem + S::DOUT);

  const int b0 = d32::fwd_block_row(blockIdx.x / bh, seq, wsz);
  const int sq = blockIdx.x % bh;
  const size_t row0 = static_cast<size_t>(sq) * seq;
  const bool halo = k_halo != nullptr;
  const float* kh = halo ? k_halo + static_cast<size_t>(sq) * wsz * D : nullptr;
  const float* vh = halo ? v_halo + static_cast<size_t>(sq) * wsz * D : nullptr;
  const int first = wgmma::dq_first(b0, wsz, halo);
  const int tiles = (b0 + d32::ROWS - first) / KT;

  auto stage = [&](int it) {
    return reinterpret_cast<float*>(smem + S::RING + (it % t3::STAGES) * S::STAGE);
  };
  auto load = [&](int it) {  // tile it into its stage (window 0's previous: the halo)
    const int t0 = first + KT * it;
    float* ks = stage(it);
    const float* ksrc = t0 < 0 ? kh + static_cast<size_t>(wsz + t0) * D : k + (row0 + t0) * D;
    const float* vsrc = t0 < 0 ? vh + static_cast<size_t>(wsz + t0) * D : v + (row0 + t0) * D;
    progen::tf32x3::copy_rows<D, KT, THREADS>(ks, ksrc);
    progen::tf32x3::copy_rows<D, KT, THREADS>(ks + KT * LD, vsrc);
  };
  progen::tf32x3::copy_rows<D, d32::ROWS, THREADS>(qs, q + (row0 + b0) * D);
  progen::tf32x3::copy_rows<D, d32::ROWS, THREADS>(dos, dout + (row0 + b0) * D);
  progen::hopper::cp_async_commit();
  load(0);
  progen::hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = b0 + 16 * warp;  // this warp's rows; the thread's: r0 + g (+ 8)
  const size_t at = row0 + r0 + g;
  const float lse2[2] = {lse[at] * t3::LOG2E, lse[at + 8] * t3::LOG2E};
  const float dd_r[2] = {dd[at], dd[at + 8]};
  const float scale2 = scale * t3::LOG2E;  // p = 2^(s scale log2 e - lse log2 e)
  progen::hopper::cp_async_wait<1>();  // q and dout have landed (tile 0 may be in flight)
  __syncthreads();
  t3::FragA qa[D / 8], da[D / 8];  // the held split
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    t3::load_a(qa[kk], qs + 16 * warp * LD + 8 * kk, LD);
    t3::load_a(da[kk], dos + 16 * warp * LD + 8 * kk, LD);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load(it + 1);
    progen::hopper::cp_async_commit();  // an empty group at the end keeps the count
    progen::hopper::cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const int t0 = first + KT * it;
    if (t0 <= r0 + 15) {  // some key of the tile is at or before some row of the warp
      const bool diagonal = t0 + KT - 1 > r0;  // ... and some key after some row
      const float* ks = stage(it);
      const float* vs = ks + KT * LD;
      float sc[KT / 8][4], dp[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {  // s = q.k^T
        t3::FragB b[KT / 8];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) t3::load_b_rows(b[j], ks + 8 * j * LD + 8 * kk, LD);
        t3::mma3<KT / 8>(sc, qa[kk], b);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {  // dp = dout.v^T
        t3::FragB b[KT / 8];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) t3::load_b_rows(b[j], vs + 8 * j * LD + 8 * kk, LD);
        t3::mma3<KT / 8>(dp, da[kk], b);
      }
      // element (j, 2 h + x): row r0 + g + 8 h, key t0 + 8 j + 2 t + x of
      // the tile, seen if the key is at or before the row
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * h + x;
            const bool seen = !diagonal || t0 + 8 * j + 2 * t + x <= r0 + g + 8 * h;
            const float p = seen ? exp2f(fmaf(sc[j][e], scale2, -lse2[h])) : 0.0f;
            dp[j][e] = p * (dp[j][e] - dd_r[h]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {  // dq += ds.k
        t3::FragA dsa;
        t3::a_from_c(dsa, dp[j]);
        t3::FragB b[D / 8];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) t3::load_b_cols(b[n], ks + 8 * j * LD + 8 * n, LD);
        t3::mma3<D / 8>(acc, dsa, b);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(dq + (at + 8 * h) * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

cudaError_t launch_dq_tf32x3_d32(const void* q, const void* k, const void* v,
                                 const void* k_halo, const void* v_halo, const void* dout,
                                 const void* lse, const void* dd, void* dq, int bh, int seq,
                                 int wsz, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Dq3D32Layout::SMEM;
  auto kernel = local_attention_dq_d32_tf32x3_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(seq / d32::ROWS) * bh, d32::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(k_halo), static_cast<const float*>(v_halo),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<float*>(dq), bh, seq, wsz, scale);
  return cudaGetLastError();
}

// -- K1-dq in f32 on the tensor cores: 3xTF32 (the "tf32x3" route) -----------

// Shared memory: the block's 128 query rows of q and of dout, then the
// ring's stages of a 32-key k tile and its v tile; every row D + 4 words.
template <int D>
struct Dq3Layout {
  static constexpr int LD = D + 4;
  static constexpr size_t Q = 0;
  static constexpr size_t DOUT = Q + sizeof(float) * t3::ROWS * LD;
  static constexpr size_t RING = DOUT + sizeof(float) * t3::ROWS * LD;
  static constexpr size_t STAGE = sizeof(float) * 2 * t3::DQ_KEYS * LD;
  static constexpr size_t SMEM = RING + t3::STAGES * STAGE;
};

// K1-dq, f32: block blk owns query rows [b0, b0 + 128) of row block
// blk / bh (block_row, longest walk first) of sequence blk % bh and walks
// the 32-key tiles from dq_first (the halo's first, at t0 < 0, when one is
// given) to b0 + 128, as cuda_attention.k1_bwd_tiles(side="dq", tile=32)
// lists them.  Each warp owns 16 rows: per tile s = q.k^T and dp =
// dout.v^T (16 x 32) in registers, p and ds there, and dq += ds.k (16 x D,
// f32 in registers for the whole walk), every product 3xTF32.
template <int D>
__global__ void __launch_bounds__(t3::THREADS, 1)
local_attention_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ k_halo,
                                 const float* __restrict__ v_halo,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ dd,
                                 float* __restrict__ dq, int bh, int seq, int wsz,
                                 float scale) {
  namespace awg = progen::attention::wgmma;
  using S = Dq3Layout<D>;
  constexpr int LD = S::LD;
  constexpr int KT = t3::DQ_KEYS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::Q);
  float* dos = reinterpret_cast<float*>(smem + S::DOUT);

  const int b0 = awg::block_row(blockIdx.x / bh, seq, wsz);
  const int sq = blockIdx.x % bh;
  const size_t row0 = static_cast<size_t>(sq) * seq;
  const bool halo = k_halo != nullptr;
  const float* kh = halo ? k_halo + static_cast<size_t>(sq) * wsz * D : nullptr;
  const float* vh = halo ? v_halo + static_cast<size_t>(sq) * wsz * D : nullptr;
  const int first = awg::dq_first(b0, wsz, halo);
  const int tiles = (b0 + t3::ROWS - first) / KT;

  auto stage = [&](int it) {
    return reinterpret_cast<float*>(smem + S::RING + (it % t3::STAGES) * S::STAGE);
  };
  auto load = [&](int it) {  // tile it into its stage (window 0's previous: the halo)
    const int t0 = first + KT * it;
    float* ks = stage(it);
    const float* ksrc = t0 < 0 ? kh + static_cast<size_t>(wsz + t0) * D : k + (row0 + t0) * D;
    const float* vsrc = t0 < 0 ? vh + static_cast<size_t>(wsz + t0) * D : v + (row0 + t0) * D;
    t3::copy_rows<D, KT>(ks, ksrc);
    t3::copy_rows<D, KT>(ks + KT * LD, vsrc);
  };
  t3::copy_rows<D, t3::ROWS>(qs, q + (row0 + b0) * D);
  t3::copy_rows<D, t3::ROWS>(dos, dout + (row0 + b0) * D);
  load(0);
  progen::hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = b0 + 16 * warp;  // this warp's rows; the thread's: r0 + g (+ 8)
  const size_t at = row0 + r0 + g;
  const float lse2[2] = {lse[at] * t3::LOG2E, lse[at + 8] * t3::LOG2E};
  const float dd_r[2] = {dd[at], dd[at + 8]};
  const float scale2 = scale * t3::LOG2E;  // p = 2^(s scale log2 e - lse log2 e)
  const float* qw = qs + 16 * warp * LD;
  const float* dow = dos + 16 * warp * LD;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load(it + 1);
    progen::hopper::cp_async_commit();  // an empty group at the end keeps the count
    progen::hopper::cp_async_wait<1>();  // tile it (and q, dout) have landed
    __syncthreads();
    const int t0 = first + KT * it;
    // a warp skips a tile whose keys all come after its rows; the diagonal
    // tile is computed whole and masked
    if (t0 <= r0 + 15) {
      const float* ks = stage(it);
      const float* vs = ks + KT * LD;
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {  // s = q.k^T
        t3::FragA a;
        t3::FragB b[4];
        t3::load_a(a, qw + 8 * kk, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) t3::load_b_rows(b[j], ks + 8 * j * LD + 8 * kk, LD);
        t3::mma3<4>(sc, a, b);
      }
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {  // dp = dout.v^T
        t3::FragA a;
        t3::FragB b[4];
        t3::load_a(a, dow + 8 * kk, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) t3::load_b_rows(b[j], vs + 8 * j * LD + 8 * kk, LD);
        t3::mma3<4>(dp, a, b);
      }
      // element (j, 2 h + x): row r0 + g + 8 h, key t0 + 8 j + 2 t + x of
      // the tile, seen if the key is at or before the row
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * h + x;
            const bool seen = t0 + 8 * j + 2 * t + x <= r0 + g + 8 * h;
            const float p = seen ? exp2f(fmaf(sc[j][e], scale2, -lse2[h])) : 0.0f;
            dp[j][e] = p * (dp[j][e] - dd_r[h]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t3::FragA da;
        t3::a_from_c(da, dp[j]);
#pragma unroll
        for (int n0 = 0; n0 < D / 8; n0 += 4) {
          t3::FragB b[4];
#pragma unroll
          for (int n = 0; n < 4; ++n) t3::load_b_cols(b[n], ks + 8 * j * LD + 8 * (n0 + n), LD);
          t3::mma3<4>(acc + n0, da, b);  // dq += ds.k
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(dq + (at + 8 * h) * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch_dq_tf32x3(const void* q, const void* k, const void* v, const void* k_halo,
                             const void* v_halo, const void* dout, const void* lse,
                             const void* dd, void* dq, int bh, int seq, int wsz, float scale,
                             cudaStream_t stream) {
  constexpr size_t bytes = Dq3Layout<D>::SMEM;
  auto kernel = local_attention_dq_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(seq / t3::ROWS) * bh, t3::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(k_halo), static_cast<const float*>(v_halo),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<float*>(dq), bh, seq, wsz, scale);
  return cudaGetLastError();
}

// -- K1-dkv in bf16 at dim_head 32: 64-byte-swizzled TMA into wgmma ---------

namespace w32 = progen::attention::wgmma::d32;

constexpr int W32_STAGES = 4;  // the ring's depth

// Shared memory: the block's 64-row k and v tiles, then the ring's stages of
// a q and a dout tile (one 64-byte-swizzled box each), then each stage's 64
// lse and 64 D values, then the barriers: 44,104 bytes with the alignment
// slack.
struct Dkv32Layout {
  static constexpr int RES = 0;
  static constexpr int RING = RES + 2 * w32::TILE;
  static constexpr int STAGE = 2 * w32::TILE;
  static constexpr int ROWV = 2 * w32::ROWS * 4;
  static constexpr int ROWVALS = RING + W32_STAGES * STAGE;
  static constexpr int BARS = ROWVALS + W32_STAGES * ROWV;
  static constexpr size_t SMEM = 1024 + BARS + (2 * W32_STAGES + 1) * sizeof(uint64_t);
};

// K1-dkv, bf16, dim_head 32: block blk owns key rows [b0, b0 + 64)
// (d32::dkv_block_row of rank blk / bh, longest walk first; the halo's
// blocks, b0 < 0, last) of sequence blk % bh, and computes their dk and dv in
// one pass over the 64-query tiles of their users, from b0 to the end of
// the next window (a halo block: window 0's queries, every pair visible).
// The producer warp's first thread loads k and v once and streams the q and
// dout tiles with their 64 lse and D values; per tile the consumer
// warpgroup forms s^T = k.q^T and dp^T = v.dout^T by wgmma from shared
// memory, p^T = 2^(s^T scale log2 e - lse log2 e) and ds^T = p^T (dp^T - D)
// in registers, and dv += p^T.dout and dk += ds^T.q with p^T and ds^T as
// bf16 register A operands (the casts the TPU kernel makes); dk and dv stay
// in registers and dk is scaled once.  The first tile of a block of real
// keys is its diagonal tile, masked in registers.
__global__ void __launch_bounds__(w32::THREADS, 3)
local_attention_dkv_d32_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     const __grid_constant__ CUtensorMap do_map,
                                     const __grid_constant__ CUtensorMap kh_map,
                                     const __grid_constant__ CUtensorMap vh_map,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ dd, bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, bf16* __restrict__ dk_halo,
                                     bf16* __restrict__ dv_halo, int bh, int seq, int wsz,
                                     float scale) {
  using S = Dkv32Layout;
  constexpr int STAGES = W32_STAGES, TILE = w32::TILE, ROWS = w32::ROWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int b0 = d32::dkv_block_row(blockIdx.x / bh, seq, wsz);
  const bool hb = b0 < 0;
  const int row0 = (blockIdx.x % bh) * seq;
  const int krow = hb ? (blockIdx.x % bh) * wsz + wsz + b0 : row0 + b0;  // k's (or the halo's)
  const int i_first = hb ? 0 : b0;
  const int i_end = hb ? wsz : min((b0 / wsz + 2) * wsz, seq);
  const int tiles = (i_end - i_first) / ROWS;
  w32::init_barriers(full, empty, resident, STAGES);

  if (threadIdx.x >= w32::CONSUMERS) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == w32::CONSUMERS) {
      mbar_expect_tx(resident, 2 * TILE);
      tma_load_2d(smem + S::RES, hb ? &kh_map : &k_map, resident, 0, krow);
      tma_load_2d(smem + S::RES + TILE, hb ? &vh_map : &v_map, resident, 0, krow);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % STAGES, row = row0 + i_first + ROWS * it;
        mbar_wait_or_trap(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + S::RING + s * S::STAGE;
        float* rowv = reinterpret_cast<float*>(smem + S::ROWVALS + s * S::ROWV);
        mbar_expect_tx(&full[s], S::STAGE + S::ROWV);
        tma_load_2d(buf, &q_map, &full[s], 0, row);
        tma_load_2d(buf + TILE, &do_map, &full[s], 0, row);
        bulk_load(rowv, lse + row, ROWS * 4, &full[s]);
        bulk_load(rowv + ROWS, dd + row, ROWS * 4, &full[s]);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32;
  const int lr = 16 * (tid / 32) + lane / 4;  // this thread's key rows: lr, lr + 8
  const float scale2 = scale * wgmma::LOG2E;
  const unsigned char* ks = smem + S::RES;
  const unsigned char* vs = ks + TILE;
  float acc_k[w32::D / 2], acc_v[w32::D / 2];
#pragma unroll
  for (int i = 0; i < w32::D / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
  mbar_wait_or_trap(resident, 0);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % STAGES;
    const bool diagonal = !hb && it == 0;  // queries i0 + c see key b0 + r only if c >= r
    mbar_wait_or_trap(&full[s], (it / STAGES) & 1);
    const unsigned char* qs = smem + S::RING + s * S::STAGE;
    const unsigned char* dos = qs + TILE;
    const float* rowv = reinterpret_cast<const float*>(smem + S::ROWVALS + s * S::ROWV);
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;
    wgmma_fence();
    w32::scores(st, ks, qs);
    w32::scores(dpt, vs, dos);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);
    // fragment element 4 i + 2 h + x: key row lr + 8 h, query column
    // c = 8 i + 2 (lane % 4) + x of the tile
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      const float2 l = *reinterpret_cast<const float2*>(rowv + c);
      const float2 d = *reinterpret_cast<const float2*>(rowv + ROWS + c);
      const float lse2[2] = {l.x * wgmma::LOG2E, l.y * wgmma::LOG2E}, dd_c[2] = {d.x, d.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2], ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 4 * i + 2 * h + x;
          p[x] = ds[x] = 0.0f;
          if (!diagonal || c + x >= lr + 8 * h) {
            p[x] = exp2f(fmaf(st[e], scale2, -lse2[x]));
            ds[x] = p[x] * (dpt[e] - dd_c[x]);
          }
        }
        wgmma::a_slot(pa, i, h) = pack_bf16(p[0], p[1]);
        wgmma::a_slot(da, i, h) = pack_bf16(ds[0], ds[1]);
      }
    }
    wgmma_fence();
    w32::accumulate(acc_v, pa, dos);
    w32::accumulate(acc_k, da, qs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_v);
    fence_operands(acc_k);
    if (tid == 0) mbar_arrive(&empty[s]);
  }

  const float by_scale[2] = {scale, scale}, by_one[2] = {1.0f, 1.0f};
  w32::store_rows((hb ? dk_halo : dk) + static_cast<size_t>(krow) * w32::D, acc_k, by_scale);
  w32::store_rows((hb ? dv_halo : dv) + static_cast<size_t>(krow) * w32::D, acc_v, by_one);
}

// -- K1-dq in bf16 at dim_head 32: 64-byte-swizzled TMA into wgmma ----------

constexpr int DQ32_STAGES = 4;  // the ring's depth
constexpr int DQ32_BLOCKS = 3;  // blocks an SM the registers are capped for

// Shared memory: the block's 64-row q and dout tiles, then the ring's stages
// of a k and a v tile (one 64-byte-swizzled box each), then the barriers:
// 42,056 bytes with the alignment slack.
struct Dq32Layout {
  static constexpr int RES = 0;
  static constexpr int RING = RES + 2 * w32::TILE;
  static constexpr int STAGE = 2 * w32::TILE;
  static constexpr int BARS = RING + DQ32_STAGES * STAGE;
  static constexpr size_t SMEM = 1024 + BARS + (2 * DQ32_STAGES + 1) * sizeof(uint64_t);
};

// K1-dq, bf16, dim_head 32: block blk owns query rows [b0, b0 + 64) of row
// block blk / bh (d32::fwd_block_row, K1-fwd's longest-walk-first order) of
// sequence blk % bh.  The producer warp's first thread loads q and dout once
// and streams the 64-key k and v tiles from the previous window's first (the
// halo's maps at t0 < 0 when `halo` is set; window 0 without one from key
// 0) to b0, the last one the diagonal tile; the consumer warpgroup reads its
// rows' lse and D once, forms s = q.k^T and dp = dout.v^T by wgmma from
// shared memory, p = 2^(s scale log2 e - lse log2 e) and ds = p (dp - D) in
// registers, and dq += ds.k with ds as the bf16 register A operand (the cast
// the TPU kernel makes) and k N-major; dq stays in registers and is scaled
// once.
__global__ void __launch_bounds__(w32::THREADS, DQ32_BLOCKS)
local_attention_dq_d32_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                    const __grid_constant__ CUtensorMap k_map,
                                    const __grid_constant__ CUtensorMap v_map,
                                    const __grid_constant__ CUtensorMap do_map,
                                    const __grid_constant__ CUtensorMap kh_map,
                                    const __grid_constant__ CUtensorMap vh_map,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ dd, bf16* __restrict__ dq,
                                    int bh, int seq, int wsz, float scale, int halo) {
  using S = Dq32Layout;
  constexpr int STAGES = DQ32_STAGES, TILE = w32::TILE, ROWS = w32::ROWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int b0 = d32::fwd_block_row(blockIdx.x / bh, seq, wsz);
  const int row0 = (blockIdx.x % bh) * seq;
  const int hrow0 = (blockIdx.x % bh) * wsz;  // this sequence's halo rows
  const int first = wgmma::dq_first(b0, wsz, halo);
  const int tiles = (b0 + ROWS - first) / ROWS;
  w32::init_barriers(full, empty, resident, STAGES);

  if (threadIdx.x >= w32::CONSUMERS) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == w32::CONSUMERS) {
      mbar_expect_tx(resident, 2 * TILE);
      tma_load_2d(smem + S::RES, &q_map, resident, 0, row0 + b0);
      tma_load_2d(smem + S::RES + TILE, &do_map, resident, 0, row0 + b0);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % STAGES, t0 = first + ROWS * it;
        mbar_wait_or_trap(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + S::RING + s * S::STAGE;
        mbar_expect_tx(&full[s], S::STAGE);
        const bool from_halo = t0 < 0;  // window 0's previous window: the halo
        const int row = from_halo ? hrow0 + wsz + t0 : row0 + t0;
        tma_load_2d(buf, from_halo ? &kh_map : &k_map, &full[s], 0, row);
        tma_load_2d(buf + TILE, from_halo ? &vh_map : &v_map, &full[s], 0, row);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32;
  const int lr = 16 * (tid / 32) + lane / 4;  // this thread's rows: lr, lr + 8
  const size_t at = static_cast<size_t>(row0) + b0 + lr;
  const float lse2[2] = {lse[at] * wgmma::LOG2E, lse[at + 8] * wgmma::LOG2E};
  const float dd_r[2] = {dd[at], dd[at + 8]};
  const float scale2 = scale * wgmma::LOG2E;  // p = 2^(s scale log2 e - lse log2 e)
  const unsigned char* qs = smem + S::RES;
  const unsigned char* dos = qs + TILE;
  float acc[w32::D / 2];
#pragma unroll
  for (int i = 0; i < w32::D / 2; ++i) acc[i] = 0.0f;
  mbar_wait_or_trap(resident, 0);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % STAGES;
    const bool diagonal = it == tiles - 1;  // every earlier tile's keys precede every row
    mbar_wait_or_trap(&full[s], (it / STAGES) & 1);
    const unsigned char* ks = smem + S::RING + s * S::STAGE;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    wgmma_fence();
    w32::scores(sc, qs, ks);
    w32::scores(dp, dos, ks + TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);
    // fragment element 4 i + 2 h + x: row lr + 8 h, key column
    // 8 i + 2 (lane % 4) + x; on the diagonal tile key c sees row r only if
    // c <= r (p = 0 is what the -1e10 fill gives)
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 4 * i + 2 * h + x;
          ds[x] = 0.0f;
          if (!diagonal || 8 * i + 2 * (lane % 4) + x <= lr + 8 * h) {
            const float p = exp2f(fmaf(sc[e], scale2, -lse2[h]));
            ds[x] = p * (dp[e] - dd_r[h]);
          }
        }
        wgmma::a_slot(a, i, h) = pack_bf16(ds[0], ds[1]);
      }
    }
    wgmma_fence();
    w32::accumulate(acc, a, ks);  // dq += ds.k
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (tid == 0) mbar_arrive(&empty[s]);
  }

  const float by_scale[2] = {scale, scale};
  w32::store_rows(dq + (static_cast<size_t>(row0) + b0) * w32::D, acc, by_scale);
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
// producer loads the block's q and dout once and streams k and v tiles
// (window 0's previous-window tiles from the halo's maps when `halo` is set); a
// consumer warpgroup forms s = q.k^T and dp = dout.v^T for its 64 rows by
// wgmma from shared memory, p and ds in registers, and dq += ds.k with ds
// as the register A operand; dq stays in registers for the whole walk.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
local_attention_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const __grid_constant__ CUtensorMap kh_map,
                                const __grid_constant__ CUtensorMap vh_map,
                                const float* __restrict__ lse, const float* __restrict__ dd,
                                bf16* __restrict__ dq, int seq, int wsz, float scale,
                                int halo) {
  using namespace wg;
  using S = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int b0 = blockIdx.x * ROWS;
  const int row0 = blockIdx.y * seq;
  const int hrow0 = blockIdx.y * wsz;  // this sequence's halo rows
  const int first = dq_first(b0, wsz, halo);
  const int tiles = dq_tiles(b0, wsz, halo);
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
        const int s = it % STAGES, t0 = first + TROWS * it;
        mbar_wait_or_trap(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + S::RING + s * S::STAGE;
        mbar_expect_tx(&full[s], S::STAGE);
        if (t0 < 0) {  // window 0's previous window: the halo
          load_tile<D>(buf, &kh_map, &full[s], hrow0 + wsz + t0);
          load_tile<D>(buf + S::TILE, &vh_map, &full[s], hrow0 + wsz + t0);
        } else {
          load_tile<D>(buf, &k_map, &full[s], row0 + t0);
          load_tile<D>(buf + S::TILE, &v_map, &full[s], row0 + t0);
        }
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
// With `halo` set, the blocks past the sequence's own (b0 < 0) own the
// halo's key rows, loaded from its maps, stream the queries of window 0
// (every pair visible) and write dk_halo and dv_halo.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
local_attention_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap do_map,
                                 const __grid_constant__ CUtensorMap kh_map,
                                 const __grid_constant__ CUtensorMap vh_map,
                                 const float* __restrict__ lse, const float* __restrict__ dd,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                 bf16* __restrict__ dk_halo, bf16* __restrict__ dv_halo,
                                 int seq, int wsz, float scale) {
  using namespace wg;
  using S = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  // blocks past the sequence's own own the halo's keys, rows [-wsz, 0)
  const int own_blocks = seq / ROWS;
  const bool hb = static_cast<int>(blockIdx.x) >= own_blocks;
  const int b0 = hb ? (static_cast<int>(blockIdx.x) - own_blocks) * ROWS - wsz
                    : static_cast<int>(blockIdx.x) * ROWS;
  const int row0 = blockIdx.y * seq;
  const int hrow0 = blockIdx.y * wsz;
  const int q_first = hb ? 0 : b0;  // the first query tile of the walk
  const int tiles = hb ? wsz / TROWS : dkv_tiles(b0, wsz, seq);
  const int group = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_barriers(full, empty, resident);

  if (group == 2) {
    if (tid == 0) {
      mbar_expect_tx(resident, 4 * S::TILE);
      for (int g = 0; g < 2; ++g) {
        unsigned char* res = smem + S::RES + g * 2 * S::TILE;
        const CUtensorMap* km = hb ? &kh_map : &k_map;
        const CUtensorMap* vm = hb ? &vh_map : &v_map;
        const int at = (hb ? hrow0 + wsz : row0) + b0 + TROWS * g;
        load_tile<D>(res, km, resident, at);
        load_tile<D>(res + S::TILE, vm, resident, at);
      }
      for (int j = 0; j < 2 * tiles; ++j) {  // both passes' tiles, in order
        const int s = j % STAGES, row = row0 + q_first + TROWS * (j % tiles);
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
  const size_t row = static_cast<size_t>(hb ? hrow0 + wsz : row0) + r0;
  bf16* dk_out = hb ? dk_halo : dk;
  bf16* dv_out = hb ? dv_halo : dv;
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
      const int kind = dkv_kind(r0, q_first + TROWS * it);
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
    store_fragment<D>(dv_out, acc, 1.0f, row);
  }
  {  // pass 2: dk
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    for (int it = 0; it < tiles; ++it) {
      const int j = tiles + it, s = j % STAGES;
      const int kind = dkv_kind(r0, q_first + TROWS * it);
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
    store_tile<D>(dk_out, acc, scale, row, ks, 1 + group);
  }
}

// -- launch -------------------------------------------------------------------

// The halo of one launch: k and v (bh, wsz, D) in, dk and dv (K1-dkv) out;
// all null for the phantom window.
struct Halo {
  const void* k;
  const void* v;
  void* dk;
  void* dv;
  bool on() const { return k != nullptr; }
};

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, Halo halo,
                      const void* dout, const void* lse, const void* dd, void* dq, int bh,
                      int seq, int wsz, float scale, cudaStream_t stream) {
  constexpr size_t bytes = DqLayout<T, D>::bytes;
  auto kernel = local_attention_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BM - 1) / BM, bh);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(halo.k), static_cast<const T*>(halo.v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dq), seq, wsz, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, Halo halo,
                       const void* dout, const void* lse, const void* dd, void* dk, void* dv,
                       int bh, int seq, int wsz, float scale, cudaStream_t stream) {
  constexpr size_t bytes = DkvLayout<T, D>::bytes;
  auto kernel = local_attention_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BM - 1) / BM + (halo.on() ? (wsz + BM - 1) / BM : 0), bh);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(halo.k), static_cast<const T*>(halo.v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(halo.dk), static_cast<T*>(halo.dv), seq, wsz, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, Halo halo,
                        const void* dout, const void* lse, const void* dd, void* dq, int bh,
                        int seq, int dim_head, int wsz, float scale, cudaStream_t s) {
  switch (dim_head) {
    case 32: return launch_dq<T, 32>(q, k, v, halo, dout, lse, dd, dq, bh, seq, wsz, scale, s);
    case 64: return launch_dq<T, 64>(q, k, v, halo, dout, lse, dd, dq, bh, seq, wsz, scale, s);
    case 128:
      return launch_dq<T, 128>(q, k, v, halo, dout, lse, dd, dq, bh, seq, wsz, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, Halo halo,
                         const void* dout, const void* lse, const void* dd, void* dk,
                         void* dv, int bh, int seq, int dim_head, int wsz, float scale,
                         cudaStream_t s) {
  switch (dim_head) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, halo, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s);
    case 64:
      return launch_dkv<T, 64>(q, k, v, halo, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, halo, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int seq, int wsz) {
  return bh <= 0 || bh > 65535 || seq <= 0 || wsz <= 0 || seq % wsz != 0;
}

// k and v of a halo come together; K1-dkv's halo also needs dk and dv.
bool bad_halo(Halo halo, bool dkv) {
  if ((halo.k == nullptr) != (halo.v == nullptr)) return true;
  return dkv && halo.on() && (halo.dk == nullptr || halo.dv == nullptr);
}

// The maps of q, k, v and dout (bh * seq rows), then of the halo's k and v
// (bh * wsz rows; k's and v's own when there is no halo, never read).
bool maps(CUtensorMap (&m)[6], const void* q, const void* k, const void* v, Halo halo,
          const void* dout, int bh, int seq, int wsz, int d) {
  using progen::attention::wgmma::tile_map;
  const long long rows = static_cast<long long>(bh) * seq;
  if (!(tile_map(&m[0], q, rows, d) && tile_map(&m[1], k, rows, d) &&
        tile_map(&m[2], v, rows, d) && tile_map(&m[3], dout, rows, d))) {
    return false;
  }
  m[4] = m[1];
  m[5] = m[2];
  const long long halo_rows = static_cast<long long>(bh) * wsz;
  return !halo.on() ||
         (tile_map(&m[4], halo.k, halo_rows, d) && tile_map(&m[5], halo.v, halo_rows, d));
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, Halo halo,
                            const void* dout, const void* lse, const void* dd, void* dq,
                            int bh, int seq, int wsz, float scale, cudaStream_t stream) {
  CUtensorMap m[6];
  if (!maps(m, q, k, v, halo, dout, bh, seq, wsz, D)) return cudaErrorInvalidValue;
  constexpr size_t bytes = wg::Layout<D>::SMEM;
  auto kernel = local_attention_dq_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(seq / wg::ROWS, bh), wg::THREADS, bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dq), seq, wsz, scale,
      halo.on() ? 1 : 0);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, Halo halo,
                             const void* dout, const void* lse, const void* dd, void* dk,
                             void* dv, int bh, int seq, int wsz, float scale,
                             cudaStream_t stream) {
  CUtensorMap m[6];
  if (!maps(m, q, k, v, halo, dout, bh, seq, wsz, D)) return cudaErrorInvalidValue;
  constexpr size_t bytes = wg::Layout<D>::SMEM;
  auto kernel = local_attention_dkv_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (seq + (halo.on() ? wsz : 0)) / wg::ROWS;
  kernel<<<dim3(blocks, bh), wg::THREADS, bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<bf16*>(halo.dk), static_cast<bf16*>(halo.dv), seq, wsz, scale);
  return cudaGetLastError();
}

// maps() at dim_head 32: (32 columns, 64 rows) boxes, 64-byte swizzled.
bool maps_d32(CUtensorMap (&m)[6], const void* q, const void* k, const void* v, Halo halo,
              const void* dout, int bh, int seq, int wsz) {
  const long long rows = static_cast<long long>(bh) * seq;
  if (!(w32::tile_map(&m[0], q, rows) && w32::tile_map(&m[1], k, rows) &&
        w32::tile_map(&m[2], v, rows) && w32::tile_map(&m[3], dout, rows))) {
    return false;
  }
  m[4] = m[1];  // k's and v's own when there is no halo, never read
  m[5] = m[2];
  const long long halo_rows = static_cast<long long>(bh) * wsz;
  return !halo.on() ||
         (w32::tile_map(&m[4], halo.k, halo_rows) && w32::tile_map(&m[5], halo.v, halo_rows));
}

cudaError_t launch_dq_wgmma_d32(const void* q, const void* k, const void* v, Halo halo,
                                const void* dout, const void* lse, const void* dd, void* dq,
                                int bh, int seq, int wsz, float scale, cudaStream_t stream) {
  CUtensorMap m[6];
  if (!maps_d32(m, q, k, v, halo, dout, bh, seq, wsz)) return cudaErrorInvalidValue;
  constexpr size_t bytes = Dq32Layout::SMEM;
  auto kernel = local_attention_dq_d32_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(seq / w32::ROWS) * bh, w32::THREADS, bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dq), bh, seq, wsz, scale,
      halo.on() ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wgmma_d32(const void* q, const void* k, const void* v, Halo halo,
                                 const void* dout, const void* lse, const void* dd, void* dk,
                                 void* dv, int bh, int seq, int wsz, float scale,
                                 cudaStream_t stream) {
  CUtensorMap m[6];
  if (!maps_d32(m, q, k, v, halo, dout, bh, seq, wsz)) return cudaErrorInvalidValue;
  constexpr size_t bytes = Dkv32Layout::SMEM;
  auto kernel = local_attention_dkv_d32_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (seq + (halo.on() ? wsz : 0)) / w32::ROWS;
  kernel<<<blocks * bh, w32::THREADS, bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<bf16*>(halo.dk), static_cast<bf16*>(halo.dv), bh, seq, wsz, scale);
  return cudaGetLastError();
}

// The Hopper routes take dim_head 32, 64 or 128 and windows that are
// multiples of 128 (cuda_attention.dq_route and dkv_route decide before the
// launch), bf16 on "wgmma" (dtype 1) and f32 on "tf32x3" (dtype 0).
bool bad_hopper_shape(int bh, int seq, int dim_head, int wsz, int dtype, int want_dtype) {
  return bad_shape(bh, seq, wsz) || dtype != want_dtype || wsz % wg::ROWS != 0 ||
         (dim_head != 32 && dim_head != 64 && dim_head != 128) ||
         static_cast<long long>(bh) * seq > 0x7FFFFFFF;
}

}  // namespace

// q, k, v, dout, dq: (bh, seq, dim_head) contiguous, dtype 0 = float32,
// 1 = bfloat16; k_halo, v_halo: (bh, wsz, dim_head), both null (the phantom
// window) or neither; lse (the forward's) and dd = rowsum(dout * out):
// (bh, seq) float32.  Returns the CUDA error code of the launch (0 = ok).
extern "C" int local_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* k_halo, const void* v_halo,
                                      const void* dout, const void* lse, const void* dd,
                                      void* dq, int bh, int seq, int dim_head, int wsz,
                                      float scale, int dtype, void* stream) {
  const Halo halo{k_halo, v_halo, nullptr, nullptr};
  if (bad_shape(bh, seq, wsz) || bad_halo(halo, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dq<float>(q, k, v, halo, dout, lse, dd, dq, bh, seq, dim_head, wsz,
                             scale, s);
  } else if (dtype == 1) {
    err = dispatch_dq<bf16>(q, k, v, halo, dout, lse, dd, dq, bh, seq, dim_head, wsz,
                            scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As above, writing dk and dv, (bh, seq, dim_head) each, of the real keys,
// and with a halo dk_halo and dv_halo, (bh, wsz, dim_head) each, of its keys.
extern "C" int local_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* k_halo, const void* v_halo,
                                       const void* dout, const void* lse, const void* dd,
                                       void* dk, void* dv, void* dk_halo, void* dv_halo,
                                       int bh, int seq, int dim_head, int wsz, float scale,
                                       int dtype, void* stream) {
  const Halo halo{k_halo, v_halo, dk_halo, dv_halo};
  if (bad_shape(bh, seq, wsz) || bad_halo(halo, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dkv<float>(q, k, v, halo, dout, lse, dd, dk, dv, bh, seq, dim_head, wsz,
                              scale, s);
  } else if (dtype == 1) {
    err = dispatch_dkv<bf16>(q, k, v, halo, dout, lse, dd, dk, dv, bh, seq, dim_head, wsz,
                             scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The wgmma route of K1-dq: bfloat16 only (dtype 1), dim_head 32, 64 or
// 128 (32 its own kernel, 64-row blocks of one warpgroup), wsz a multiple
// of 128, every pointer 16-byte aligned; arguments as for
// local_attention_bwd_dq.  Returns the CUDA error code of the launch.
extern "C" int local_attention_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                            const void* k_halo, const void* v_halo,
                                            const void* dout, const void* lse,
                                            const void* dd, void* dq, int bh, int seq,
                                            int dim_head, int wsz, float scale, int dtype,
                                            void* stream) {
  const Halo halo{k_halo, v_halo, nullptr, nullptr};
  if (bad_hopper_shape(bh, seq, dim_head, wsz, dtype, 1) || bad_halo(halo, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dim_head == 32
          ? launch_dq_wgmma_d32(q, k, v, halo, dout, lse, dd, dq, bh, seq, wsz, scale, s)
      : dim_head == 64
          ? launch_dq_wgmma<64>(q, k, v, halo, dout, lse, dd, dq, bh, seq, wsz, scale, s)
          : launch_dq_wgmma<128>(q, k, v, halo, dout, lse, dd, dq, bh, seq, wsz, scale, s);
  return static_cast<int>(err);
}

// The wgmma route of K1-dkv, as above (dim_head 32 its own kernel, 64-key
// blocks in one pass).
extern "C" int local_attention_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                             const void* k_halo, const void* v_halo,
                                             const void* dout, const void* lse,
                                             const void* dd, void* dk, void* dv,
                                             void* dk_halo, void* dv_halo, int bh, int seq,
                                             int dim_head, int wsz, float scale, int dtype,
                                             void* stream) {
  const Halo halo{k_halo, v_halo, dk_halo, dv_halo};
  if (bad_hopper_shape(bh, seq, dim_head, wsz, dtype, 1) || bad_halo(halo, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dim_head == 32
          ? launch_dkv_wgmma_d32(q, k, v, halo, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s)
      : dim_head == 64
          ? launch_dkv_wgmma<64>(q, k, v, halo, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s)
          : launch_dkv_wgmma<128>(q, k, v, halo, dout, lse, dd, dk, dv, bh, seq, wsz, scale, s);
  return static_cast<int>(err);
}

// The tf32x3 route of K1-dq: float32 only (dtype 0), dim_head 32, 64 or
// 128 (32 its own kernel, 64-row blocks of four warps), wsz a multiple of
// 128, every pointer 16-byte aligned; arguments as for
// local_attention_bwd_dq.  Returns the CUDA error code of the launch.
extern "C" int local_attention_bwd_dq_tf32x3(const void* q, const void* k, const void* v,
                                             const void* k_halo, const void* v_halo,
                                             const void* dout, const void* lse,
                                             const void* dd, void* dq, int bh, int seq,
                                             int dim_head, int wsz, float scale, int dtype,
                                             void* stream) {
  const Halo halo{k_halo, v_halo, nullptr, nullptr};
  if (bad_hopper_shape(bh, seq, dim_head, wsz, dtype, 0) || bad_halo(halo, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim_head == 32) {
    return static_cast<int>(launch_dq_tf32x3_d32(q, k, v, k_halo, v_halo, dout, lse, dd, dq,
                                                 bh, seq, wsz, scale, s));
  }
  cudaError_t err = dim_head == 64
      ? launch_dq_tf32x3<64>(q, k, v, k_halo, v_halo, dout, lse, dd, dq, bh, seq, wsz, scale, s)
      : launch_dq_tf32x3<128>(q, k, v, k_halo, v_halo, dout, lse, dd, dq, bh, seq, wsz, scale,
                              s);
  return static_cast<int>(err);
}

// The tf32x3 route of K1-dkv: float32 only (dtype 0), dim_head 32, 64 or
// 128, wsz a multiple of 128, every pointer 16-byte aligned; arguments as
// for local_attention_bwd_dkv.  Returns the CUDA error code of the launch.
extern "C" int local_attention_bwd_dkv_tf32x3(const void* q, const void* k, const void* v,
                                              const void* k_halo, const void* v_halo,
                                              const void* dout, const void* lse,
                                              const void* dd, void* dk, void* dv,
                                              void* dk_halo, void* dv_halo, int bh, int seq,
                                              int dim_head, int wsz, float scale, int dtype,
                                              void* stream) {
  const Halo halo{k_halo, v_halo, dk_halo, dv_halo};
  if (bad_hopper_shape(bh, seq, dim_head, wsz, dtype, 0) || bad_halo(halo, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim_head == 32) {
    return static_cast<int>(launch_dkv_tf32x3_d32(q, k, v, k_halo, v_halo, dout, lse, dd, dk,
                                                  dv, dk_halo, dv_halo, bh, seq, wsz, scale,
                                                  s));
  }
  cudaError_t err = dim_head == 64
      ? launch_dkv_tf32x3<64>(q, k, v, k_halo, v_halo, dout, lse, dd, dk, dv, dk_halo,
                              dv_halo, bh, seq, wsz, scale, s)
      : launch_dkv_tf32x3<128>(q, k, v, k_halo, v_halo, dout, lse, dd, dk, dv, dk_halo,
                               dv_halo, bh, seq, wsz, scale, s);
  return static_cast<int>(err);
}
