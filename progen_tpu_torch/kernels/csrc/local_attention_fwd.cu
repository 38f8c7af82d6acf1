// Windowed causal local attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel progen_tpu/ops/pallas_attention.py:_fwd_kernel
// (launched by _forward_ext).  Query row i of window w = i / wsz attends the
// keys of window w-1 (all of them) and of its own window up to i, scaled by
// `scale`, with an f32 softmax; window 0's previous window is the phantom
// zero window, whose wsz zero logits count in the softmax denominator and
// whose zero values add nothing.  p is cast to the input dtype before p.v,
// which accumulates in f32.  Writes out (B*H, L, D) in the input dtype and
// the per-row logsumexp lse (B*H, L) in f32, which the backward reads.
//
// With a halo (k_halo, v_halo: (B*H, wsz, D), the left neighbour's last
// window under context parallelism; pallas_local_attention_ext's k_ext/v_ext
// first window) window 0's previous window is the halo instead of the
// phantom: its wsz logits are real.  A null halo is the phantom, and takes
// the same instructions as before the halo existed.
//
// What bounds it on this card: at ProGen-small (D = 128, wsz = 256) a row
// does 4*D*(wsz + i%wsz + 1) flops, ~196k on average, over 4*D*2 bytes of
// q/k/v/out in bf16: ~190 flops per byte, under the H100's ~295 flops/byte
// ridge, so the bound is the bytes (33.6 MB, 0.0101 ms at B = 4), if not by
// much (6.45 GFLOP, 0.0065 ms at the bf16 peak).
//
// Three routes, chosen before the launch by cuda_attention.fwd_route from
// the dtype, dim_head and window alone, each under its own extern "C" name:
//
// "wgmma" (local_attention_fwd_wgmma): bf16, dim_head 64 or 128, windows
// that are multiples of 128 (every shipped config but `default`; dim_head
// 32 has a kernel of its own, below).  It walks
// exactly what K1-dq walks (attention_wgmma.cuh): a block of three
// warpgroups owns 128 query rows of one window, q resident in shared memory
// by TMA; the producer's one thread streams the 64-key k and v tiles the
// block sees through a 4-stage ring of 128-byte-swizzled TMA copies.  Each
// consumer warpgroup owns 64 rows and, per tile, runs s = q.k^T as wgmma
// m64n64k16 from shared memory into registers, an online softmax in
// registers (a row's 16 values a thread, the row max across the quad of
// threads that shares the row by shuffle, exp2 with the scale folded in),
// packs p to bf16 as the register A operand and runs o += p.v as wgmma
// m64n{128,64}k16 with v N-major; the f32 o (D / 2 registers a thread)
// stays in registers for the whole walk.  Only the diagonal tile is masked
// (in registers; a masked logit is -inf, which the TPU's -1e10 fill equals
// after exp); tiles no row of a warpgroup sees are skipped, and tiles no
// row of the block sees are never loaded.  The phantom window is an exact
// term: rows of window 0 start the running max at 0 and add wsz * exp(-m)
// to the denominator at the end, so lse = m + log(denominator) is the
// TPU's.  Blocks run longest walk first (k1_fwd_block).  Every output
// element is written by one block, once: no atomics, the same bits every
// run; every mbarrier wait traps rather than hangs.
//
// At dim_head 32 (ProGen-default: the sample CLI, which computes in bf16,
// and `train --mixed_precision`; H 3, L 1024, window 512) the same route
// has a kernel of its own, reached through the same extern "C" name.  It
// replaced the "wmma" kernel there (0.0788 ms at B 4 and 0.2707 at B 32 on
// an H100, 2.56x and 2.22x one bf16 scaled_dot_product_attention call).
// What bounds it: not the bytes (3.2 MB at B 4, 0.00095 ms) nor the products
// (0.81 GFLOP, 0.0008 ms at the bf16 peak) but the exponentials: one ex2 a
// visible pair, 6,297,600 pairs at B 4 and 50.4 M at B 32, at 16 a clock
// on each of 132 SMs at 1.98 GHz are 0.0015 and 0.0121 ms; a 64 x 64 tile
// costs 4,096 ex2 (256 clocks of one SM's SFUs) against 0.5 MFLOP of
// products (~128 clocks of wgmma).  So the design keeps the SFUs fed: a
// block is one consumer warpgroup of 64 query rows and one producer warp
// (attention_wgmma.cuh, d32), 37 KB of shared memory, four resident on an
// SM (192 blocks at B 4 where 128-row blocks would leave 96 for 132 SMs),
// launched longest walk first (d32::fwd_block_row, the f32 route's 64-row
// walk); q arrives once and the 64-key k and v tiles through a 4-stage
// ring, each a (32, 64) TMA box with 64-byte swizzle (a bf16 row of
// dim_head 32 is 64 bytes: the 128-byte maps need 64 columns).  Per tile
// s = q.k^T is two wgmma m64n64k16 from shared memory (64-byte-swizzle
// descriptors), the online softmax runs on the f32 fragment in registers
// (exp2 with the scale folded in), and o += p.v is four wgmma m64n32k16
// with p as the bf16 register A operand and v N-major.  Only the last tile
// of a walk is the diagonal one, masked in registers; the phantom window is
// the exact term above, and with a halo window 0 streams the halo's tiles
// first.  Every output element is written by one thread, once.
//
// "tf32x3" (local_attention_fwd_tf32x3): f32 with dim_head 64 or 128 and
// windows that are multiples of 128, the shapes of the "wgmma" route (f32
// is the default of both training CLIs; f32 prefill workers).  It replaced
// the "wmma" kernel's f32 FMA loops (one shared-memory load an FMA, no
// tensor core: 2.16 ms at B 8, 4.6x one scaled_dot_product_attention call).
// What bounds it: the bf16 route's work, 12.9 GFLOP at B 8 with the halo, each
// product f32-accurate as three TF32 products (attention_tf32x3.cuh): the
// least time is 3 x FLOPs / 495 TFLOP/s, 0.078 ms, over ~151 MB (0.045 ms),
// so the operations.  A block of eight warps owns 128 query rows of one
// window (the bf16 route's blocks, walks and longest-first order), q
// resident in shared memory; the k and v tiles of 64 keys stream through a
// two-stage cp.async ring (one tile in use, the next in flight) into padded
// f32 rows.  Each warp owns 16 rows: s = q.k^T by mma.sync m16n8k8 TF32,
// each operand split into hi + lo in registers as its fragment is loaded;
// the online softmax on the f32 fragment (a row's values across a quad of
// threads, exp2 with the scale folded in); o += p.v with p's fragment split
// in registers and v read N-major, the f32 o in registers for the whole
// walk.  The phantom window is the bf16 route's exact term.  Every output
// element is written by one thread, once: the same bits every run.
//
// At dim_head 32 (ProGen-default, the training CLI's default run: B 4, H 3,
// L 1024, window 512) the same route has a kernel of its own.  It replaced
// the "wmma" kernel's FMA loops there (0.2165 ms at B 4 on an H100, 1.31x
// one f32 scaled_dot_product_attention call).  What bounds it: 0.806 GFLOP at B 4
// (6,297,600 visible pairs), 3 x FLOPs / 495 TFLOP/s = 0.0049 ms, over
// 6.3 MB (0.0019 ms): the operations; but at B 4 the whole grid is 192
// blocks, so what it takes is the longest block's walk (16 tiles), and the
// D = 128 design would leave it worse off: 128-row blocks of eight warps
// at one an SM give 96 blocks for 132 SMs, and its p.v loop takes eight
// column fragments at a time (D / 8 = 4 here).  So a block is four warps
// of 64 query rows (46 KB of shared memory: q and a two-stage ring of
// 64-key k and v tiles), three resident an SM (159 registers, no spills;
// two, at 172, ran 6% slower at B 32 on an H100), longest walk first
// (d32::fwd_block_row); each warp splits its 16 x 32 q fragments into hi
// and lo once and holds them (32 registers) for the whole walk, so only
// the streamed k and v are split per tile; p.v runs four column fragments
// at a time.
//
// "wmma" (local_attention_fwd): windows that are not a multiple of 128,
// and what a caller forces onto it.  Flash-style, one block of 4 warps per (b*h, 64 query
// rows); each warp owns 16 rows.  The block walks 64-key tiles over the
// extended key range [window start of its first row - wsz, its last row];
// a key tile row before position 0 is loaded as zeros (the phantom
// window) or from the halo.  Keys above a row's diagonal are skipped rather than filled
// with -1e10; the two are exact equals, since every row keeps at least wsz
// visible logits and exp(-1e10 - max) is 0 in f32.  Scores go to shared
// memory, the online softmax runs per row in f32 (two lanes per row), and
// the f32 output accumulator stays in shared memory.  bf16 runs QK^T and
// PV through WMMA (16x16x16, f32 accumulate); f32 runs FMA loops.
// Nothing is pipelined.

#include <cuda.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>

#include <cstdint>

#include "attention_tf32x3.cuh"
#include "attention_tile.cuh"
#include "attention_wgmma.cuh"
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
                           const T* __restrict__ v, const T* __restrict__ k_halo,
                           const T* __restrict__ v_halo, T* __restrict__ out,
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
  const size_t hbase = static_cast<size_t>(blockIdx.y) * wsz * D;
  const T* kh = k_halo != nullptr ? k_halo + hbase : nullptr;
  const T* vh = v_halo != nullptr ? v_halo + hbase : nullptr;

  load_rows<T, D, BM>(qs, q + base, q0, seq);
  for (int idx = threadIdx.x; idx < BM * L::LDO; idx += THREADS) os[idx] = 0.0f;

  // this lane's query row and its visible keys, in extended coordinates
  // (extended key e is sequence position e - wsz; e < wsz is the phantom,
  // or the halo)
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
    load_rows<T, D, BN>(ks, k + base, kt - wsz, seq, kh, wsz);
    load_rows<T, D, BN>(vs, v + base, kt - wsz, seq, vh, wsz);
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
cudaError_t launch(const void* q, const void* k, const void* v, const void* k_halo,
                   const void* v_halo, void* out, void* lse, int bh, int seq, int wsz,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::bytes;
  auto kernel = local_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BM - 1) / BM, bh);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(k_halo), static_cast<const T*>(v_halo), static_cast<T*>(out),
      static_cast<float*>(lse), seq, wsz, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* kh,
                     const void* vh, void* out, void* lse, int bh, int seq, int dim_head,
                     int wsz, float scale, cudaStream_t stream) {
  switch (dim_head) {
    case 32: return launch<T, 32>(q, k, v, kh, vh, out, lse, bh, seq, wsz, scale, stream);
    case 64: return launch<T, 64>(q, k, v, kh, vh, out, lse, bh, seq, wsz, scale, stream);
    case 128: return launch<T, 128>(q, k, v, kh, vh, out, lse, bh, seq, wsz, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// -- f32 on the tensor cores: 3xTF32 from a cp.async ring (the "tf32x3" route)

namespace t3 = progen::attention::tf32x3;
namespace wg = progen::attention::wgmma;

// Shared memory: the block's 128 query rows, then the ring's stages of a
// 64-key k tile and its v tile, every row D + 4 words.
template <int D>
struct F3Layout {
  static constexpr int LD = D + 4;
  static constexpr size_t Q = 0;
  static constexpr size_t RING = Q + sizeof(float) * t3::ROWS * LD;
  static constexpr size_t STAGE = sizeof(float) * 2 * t3::KEYS * LD;
  static constexpr size_t SMEM = RING + t3::STAGES * STAGE;
};

// K1-fwd, f32: block blk owns query rows [b0, b0 + 128) of row block
// blk / bh (wg::block_row, longest walk first) of sequence blk % bh, and
// walks what the bf16 route walks (wg::dq_first, wg::dq_tiles): the 64-key
// tiles from the previous window's first (the halo's, at t0 < 0, when one
// is given) to b0 + 64.  Each warp owns 16 rows: per tile s = q.k^T (16 x 64)
// in registers, the online softmax there, and o += p.v (16 x D, f32 in
// registers for the whole walk), every product 3xTF32.  A warp skips the
// tiles its rows do not see; the diagonal tile is masked in registers.  The phantom window is the bf16 route's exact term.
template <int D>
__global__ void __launch_bounds__(t3::THREADS, 1)
local_attention_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ k_halo,
                                  const float* __restrict__ v_halo, float* __restrict__ out,
                                  float* __restrict__ lse, int bh, int seq, int wsz,
                                  float scale) {
  using S = F3Layout<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::Q);

  const int b0 = wg::block_row(blockIdx.x / bh, seq, wsz);
  const int sq = blockIdx.x % bh;
  const size_t row0 = static_cast<size_t>(sq) * seq;
  const bool halo = k_halo != nullptr;
  const float* kh = halo ? k_halo + static_cast<size_t>(sq) * wsz * D : nullptr;
  const float* vh = halo ? v_halo + static_cast<size_t>(sq) * wsz * D : nullptr;
  const int first = wg::dq_first(b0, wsz, halo);
  const int tiles = wg::dq_tiles(b0, wsz, halo);

  auto stage = [&](int it) {
    return reinterpret_cast<float*>(smem + S::RING + (it % t3::STAGES) * S::STAGE);
  };
  auto load = [&](int it) {  // tile it into its stage (window 0's previous: the halo)
    const int t0 = first + t3::KEYS * it;
    float* ks = stage(it);
    const float* ksrc = t0 < 0 ? kh + static_cast<size_t>(wsz + t0) * D : k + (row0 + t0) * D;
    const float* vsrc = t0 < 0 ? vh + static_cast<size_t>(wsz + t0) * D : v + (row0 + t0) * D;
    t3::copy_rows<D, t3::KEYS>(ks, ksrc);
    t3::copy_rows<D, t3::KEYS>(ks + t3::KEYS * LD, vsrc);
  };
  t3::copy_rows<D, t3::ROWS>(qs, q + (row0 + b0) * D);
  load(0);
  progen::hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = b0 + 16 * warp;              // this warp's rows; the thread's: r0 + g (+ 8)
  const float scale2 = scale * t3::LOG2E;     // logits in log2 units
  const bool phantom = b0 < wsz && !halo;     // window 0: wsz zero logits too
  const float* qw = qs + 16 * warp * LD;
  float mx[2], den[2] = {0.0f, 0.0f};
  mx[0] = mx[1] = phantom ? 0.0f : -1e30f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load(it + 1);
    progen::hopper::cp_async_commit();  // an empty group at the end keeps the count
    progen::hopper::cp_async_wait<1>();  // tile it (and q) have landed
    __syncthreads();
    const int t0 = first + t3::KEYS * it;
    // a warp skips a tile whose keys all come after its rows; the diagonal
    // tile is computed whole and masked
    if (t0 <= r0 + 15) {
      const float* ks = stage(it);
      const float* vs = ks + t3::KEYS * LD;
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        t3::FragA a;
        t3::FragB b[8];
        t3::load_a(a, qw + 8 * kk, LD);
#pragma unroll
        for (int j = 0; j < 8; ++j) t3::load_b_rows(b[j], ks + 8 * j * LD + 8 * kk, LD);
        t3::mma3<8>(sc, a, b);
      }
      // element (j, 2 h + x): row r0 + g + 8 h, key t0 + 8 j + 2 t + x,
      // seen if the key is at or before the row
      float top[2] = {mx[0], mx[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const bool seen = t0 + 8 * j + 2 * t + x <= r0 + g + 8 * h;
            const float s = seen ? sc[j][2 * h + x] * scale2 : -INFINITY;
            sc[j][2 * h + x] = s;
            top[h] = fmaxf(top[h], s);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 1));
        top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 2));
        alpha[h] = exp2f(mx[h] - top[h]);
        mx[h] = top[h];
        den[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2f(sc[j][e] - mx[e / 2]);
          den[e / 2] += sc[j][e];
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        t3::FragA p;
        t3::a_from_c(p, sc[j]);
#pragma unroll
        for (int n0 = 0; n0 < D / 8; n0 += 8) {
          t3::FragB b[8];
#pragma unroll
          for (int n = 0; n < 8; ++n) t3::load_b_cols(b[n], vs + 8 * j * LD + 8 * (n0 + n), LD);
          t3::mma3<8>(acc + n0, p, b);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // the quad's shares of each denominator, the phantom's wsz zero logits
  // (2^(0 - max) each), then out = o / denominator and lse = max + log
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
    if (phantom) den[h] += static_cast<float>(wsz) * exp2f(-mx[h]);
    inv[h] = 1.0f / den[h];
    if (t == 0) lse[row0 + r0 + g + 8 * h] = mx[h] * t3::LN2 + logf(den[h]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(out + (row0 + r0 + g + 8 * h) * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
    }
  }
}

template <int D>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, const void* k_halo,
                          const void* v_halo, void* out, void* lse, int bh, int seq, int wsz,
                          float scale, cudaStream_t stream) {
  constexpr size_t bytes = F3Layout<D>::SMEM;
  auto kernel = local_attention_fwd_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(seq / t3::ROWS) * bh, t3::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(k_halo), static_cast<const float*>(v_halo),
      static_cast<float*>(out), static_cast<float*>(lse), bh, seq, wsz, scale);
  return cudaGetLastError();
}

// -- f32 at dim_head 32: 3xTF32, q's split held (the "tf32x3" route) ---------

namespace d32 = progen::attention::tf32x3::d32;

// Shared memory: the block's 64 query rows, then the ring's stages of a
// 64-key k tile and its v tile, every row 36 words: 46,080 bytes.
struct F3D32Layout {
  static constexpr size_t Q = 0;
  static constexpr size_t RING = Q + sizeof(float) * d32::ROWS * d32::LD;
  static constexpr size_t STAGE = sizeof(float) * 2 * d32::KEYS * d32::LD;
  static constexpr size_t SMEM = RING + t3::STAGES * STAGE;
};

// K1-fwd, f32, dim_head 32: block blk owns query rows [b0, b0 + 64) of row
// block blk / bh (d32::fwd_block_row, longest walk first) of sequence
// blk % bh and walks the 64-key tiles from the previous window's first
// (the halo's, at t0 < 0, when one is given) to b0 + 63, the last one the
// diagonal tile, which every warp meets.  Each warp owns 16 rows: their q
// fragments are split into hi and lo once, after q lands, and held in
// registers (32) for the whole walk; per tile only the streamed k and v are
// split as their fragments load.  s = q.k^T (16 x 64), the online softmax,
// o += p.v (16 x 32, four column fragments), all in registers, every
// product 3xTF32; the phantom window is the exact term of the other routes.
__global__ void __launch_bounds__(d32::THREADS, 3)
local_attention_fwd_d32_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ k_halo,
                                      const float* __restrict__ v_halo,
                                      float* __restrict__ out, float* __restrict__ lse, int bh,
                                      int seq, int wsz, float scale) {
  using S = F3D32Layout;
  constexpr int D = d32::D, LD = d32::LD, KT = d32::KEYS, THREADS = d32::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::Q);

  const int b0 = d32::fwd_block_row(blockIdx.x / bh, seq, wsz);
  const int sq = blockIdx.x % bh;
  const size_t row0 = static_cast<size_t>(sq) * seq;
  const bool halo = k_halo != nullptr;
  const float* kh = halo ? k_halo + static_cast<size_t>(sq) * wsz * D : nullptr;
  const float* vh = halo ? v_halo + static_cast<size_t>(sq) * wsz * D : nullptr;
  const int first = wg::dq_first(b0, wsz, halo);
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
  progen::hopper::cp_async_commit();
  load(0);
  progen::hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = b0 + 16 * warp;              // this warp's rows; the thread's: r0 + g (+ 8)
  const float scale2 = scale * t3::LOG2E;     // logits in log2 units
  const bool phantom = b0 < wsz && !halo;     // window 0: wsz zero logits too
  const float* qw = qs + 16 * warp * LD;
  progen::hopper::cp_async_wait<1>();  // q has landed (tile 0 may be in flight)
  __syncthreads();
  t3::FragA qa[D / 8];  // the held split
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) t3::load_a(qa[kk], qw + 8 * kk, LD);
  float mx[2], den[2] = {0.0f, 0.0f};
  mx[0] = mx[1] = phantom ? 0.0f : -1e30f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load(it + 1);
    progen::hopper::cp_async_commit();  // an empty group at the end keeps the count
    progen::hopper::cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const int t0 = first + KT * it;
    const bool diagonal = t0 == b0;  // every earlier tile's keys precede every row
    const float* ks = stage(it);
    const float* vs = ks + KT * LD;
    float sc[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      t3::FragB b[KT / 8];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) t3::load_b_rows(b[j], ks + 8 * j * LD + 8 * kk, LD);
      t3::mma3<KT / 8>(sc, qa[kk], b);
    }
    // element (j, 2 h + x): row r0 + g + 8 h, key t0 + 8 j + 2 t + x, seen
    // unless the tile is the diagonal one and the key comes after the row
    float top[2] = {mx[0], mx[1]};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const bool seen = !diagonal || 8 * j + 2 * t + x <= 16 * warp + g + 8 * h;
          const float s = seen ? sc[j][2 * h + x] * scale2 : -INFINITY;
          sc[j][2 * h + x] = s;
          top[h] = fmaxf(top[h], s);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 1));
      top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 2));
      alpha[h] = exp2f(mx[h] - top[h]);
      mx[h] = top[h];
      den[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - mx[e / 2]);
        den[e / 2] += sc[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      t3::FragA p;
      t3::a_from_c(p, sc[j]);
      t3::FragB b[D / 8];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) t3::load_b_cols(b[n], vs + 8 * j * LD + 8 * n, LD);
      t3::mma3<D / 8>(acc, p, b);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // the quad's shares of each denominator, the phantom's wsz zero logits
  // (2^(0 - max) each), then out = o / denominator and lse = max + log
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
    if (phantom) den[h] += static_cast<float>(wsz) * exp2f(-mx[h]);
    inv[h] = 1.0f / den[h];
    if (t == 0) lse[row0 + r0 + g + 8 * h] = mx[h] * t3::LN2 + logf(den[h]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(out + (row0 + r0 + g + 8 * h) * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
    }
  }
}

cudaError_t launch_tf32x3_d32(const void* q, const void* k, const void* v, const void* k_halo,
                              const void* v_halo, void* out, void* lse, int bh, int seq,
                              int wsz, float scale, cudaStream_t stream) {
  constexpr size_t bytes = F3D32Layout::SMEM;
  auto kernel = local_attention_fwd_d32_tf32x3_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(seq / d32::ROWS) * bh, d32::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(k_halo), static_cast<const float*>(v_halo),
      static_cast<float*>(out), static_cast<float*>(lse), bh, seq, wsz, scale);
  return cudaGetLastError();
}

// -- bf16 at dim_head 32: 64-byte-swizzled TMA into wgmma (the "wgmma" route)

namespace w32 = progen::attention::wgmma::d32;

constexpr int W32_STAGES = 4;  // the ring's depth

// Shared memory: the block's 64-row q tile, then the ring's stages of a k
// and a v tile (one 64-byte-swizzled box each), then the barriers: 37,960
// bytes with the alignment slack.
struct W32Layout {
  static constexpr int RES = 0;
  static constexpr int RING = RES + w32::TILE;
  static constexpr int STAGE = 2 * w32::TILE;
  static constexpr int BARS = RING + W32_STAGES * STAGE;
  static constexpr size_t SMEM = 1024 + BARS + (2 * W32_STAGES + 1) * sizeof(uint64_t);
};

// K1-fwd, bf16, dim_head 32: block blk owns query rows [b0, b0 + 64) of row
// block blk / bh (d32::fwd_block_row, longest walk first) of sequence
// blk % bh.  The producer warp's first thread loads q once and streams the
// 64-key k and v tiles from the previous window's first (the halo's maps at
// t0 < 0 when `halo` is set) to b0, the last one the diagonal tile; the
// consumer warpgroup forms s = q.k^T by wgmma from shared memory, p in
// registers by an online softmax (exp2 with the scale folded in), and
// o += p.v with p as the register A operand; o stays in registers.
__global__ void __launch_bounds__(w32::THREADS, 4)
local_attention_fwd_d32_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     const __grid_constant__ CUtensorMap kh_map,
                                     const __grid_constant__ CUtensorMap vh_map,
                                     bf16* __restrict__ out, float* __restrict__ lse, int bh,
                                     int seq, int wsz, float scale, int halo) {
  using namespace progen::hopper;
  using S = W32Layout;
  constexpr int STAGES = W32_STAGES, TILE = w32::TILE, ROWS = w32::ROWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int b0 = d32::fwd_block_row(blockIdx.x / bh, seq, wsz);
  const int row0 = (blockIdx.x % bh) * seq;
  const int hrow0 = (blockIdx.x % bh) * wsz;  // this sequence's halo rows
  const int first = wg::dq_first(b0, wsz, halo);
  const int tiles = (b0 + ROWS - first) / ROWS;
  w32::init_barriers(full, empty, resident, STAGES);

  if (threadIdx.x >= w32::CONSUMERS) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == w32::CONSUMERS) {
      mbar_expect_tx(resident, TILE);
      tma_load_2d(smem + S::RES, &q_map, resident, 0, row0 + b0);
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
  const float scale2 = scale * wg::LOG2E;     // logits in log2 units
  const bool phantom = b0 < wsz && !halo;     // window 0: wsz zero logits too
  const unsigned char* qs = smem + S::RES;
  // the running max of each row (log2 units), and this thread's share of
  // each row's denominator at that max
  float mx[2], den[2] = {0.0f, 0.0f};
  mx[0] = mx[1] = phantom ? 0.0f : -1e30f;
  float acc[w32::D / 2];
#pragma unroll
  for (int i = 0; i < w32::D / 2; ++i) acc[i] = 0.0f;
  mbar_wait_or_trap(resident, 0);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % STAGES;
    const bool diagonal = it == tiles - 1;  // every earlier tile's keys precede every row
    mbar_wait_or_trap(&full[s], (it / STAGES) & 1);
    const unsigned char* ks = smem + S::RING + s * S::STAGE;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    wgmma_fence();
    w32::scores(sc, qs, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    // fragment element 4 i + 2 h + x: row lr + 8 h, key column
    // 8 i + 2 (lane % 4) + x; on the diagonal tile key c sees row r only if
    // c <= r
    float top[2] = {mx[0], mx[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 4 * i + 2 * h + x;
          const bool seen = !diagonal || 8 * i + 2 * (lane % 4) + x <= lr + 8 * h;
          const float v = seen ? sc[e] * scale2 : -INFINITY;
          sc[e] = v;
          top[h] = fmaxf(top[h], v);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 1));
      top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 2));
      alpha[h] = exp2f(mx[h] - top[h]);
      mx[h] = top[h];
      den[h] *= alpha[h];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(sc[4 * i + 2 * h] - mx[h]);
        const float p1 = exp2f(sc[4 * i + 2 * h + 1] - mx[h]);
        den[h] += p0 + p1;
        wg::a_slot(pa, i, h) = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int i = 0; i < w32::D / 8; ++i) {
      acc[4 * i] *= alpha[0];
      acc[4 * i + 1] *= alpha[0];
      acc[4 * i + 2] *= alpha[1];
      acc[4 * i + 3] *= alpha[1];
    }
    wgmma_fence();
    w32::accumulate(acc, pa, ks + TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (tid == 0) mbar_arrive(&empty[s]);
  }

  // the quad's shares of each denominator, the phantom's wsz zero logits
  // (2^(0 - max) each), then out = o / denominator and lse = max + log
  float inv[2];
  const size_t at = static_cast<size_t>(row0) + b0 + lr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
    if (phantom) den[h] += static_cast<float>(wsz) * exp2f(-mx[h]);
    inv[h] = 1.0f / den[h];
    if (lane % 4 == 0) lse[at + 8 * h] = mx[h] * w32::LN2 + logf(den[h]);
  }
  w32::store_rows(out + (static_cast<size_t>(row0) + b0) * w32::D, acc, inv);
}

cudaError_t launch_wgmma_d32(const void* q, const void* k, const void* v, const void* k_halo,
                             const void* v_halo, void* out, void* lse, int bh, int seq,
                             int wsz, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(bh) * seq;
  const long long halo_rows = static_cast<long long>(bh) * wsz;
  const int halo = k_halo != nullptr;
  CUtensorMap q_map, k_map, v_map, kh_map, vh_map;
  if (!w32::tile_map(&q_map, q, rows) || !w32::tile_map(&k_map, k, rows) ||
      !w32::tile_map(&v_map, v, rows)) {
    return cudaErrorInvalidValue;
  }
  kh_map = k_map;  // never read without a halo
  vh_map = v_map;
  if (halo && (!w32::tile_map(&kh_map, k_halo, halo_rows) ||
               !w32::tile_map(&vh_map, v_halo, halo_rows))) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t bytes = W32Layout::SMEM;
  auto kernel = local_attention_fwd_d32_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(seq / w32::ROWS) * bh, w32::THREADS, bytes, stream>>>(
      q_map, k_map, v_map, kh_map, vh_map, static_cast<bf16*>(out), static_cast<float*>(lse),
      bh, seq, wsz, scale, halo);
  return cudaGetLastError();
}

// -- bf16 on Hopper: a TMA ring into wgmma (the "wgmma" route) ----------------

namespace fwg {

using namespace progen::attention::wgmma;

constexpr float LN2 = 0.6931471805599453f;

// Shared memory: each consumer warpgroup's resident 64-row q tile, then the
// ring's stages of a k and a v tile, then the barriers.  A 64-row tile is
// D / 64 boxes of 64 columns, each 128-byte swizzled.
template <int D>
struct Layout {
  static constexpr int TILE = (D / 64) * BOX;
  static constexpr int RES = 0;
  static constexpr int RING = RES + 2 * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr size_t SMEM = 1024 + BARS + (2 * STAGES + 1) * sizeof(uint64_t);
};

// Byte offset of element (row r, column c) of a 64-row tile of D columns in
// the 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8)).
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c / 64) * BOX + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

}  // namespace fwg

// K1-fwd, bf16: block blk owns query rows [b0, b0 + 128) of row block
// blk / bh (block_row) of sequence blk % bh.  The producer loads the
// block's q once and streams the k and v tiles of the walk (window 0's
// previous-window tiles from the halo's maps when `halo` is set); a consumer
// warpgroup forms s = q.k^T for its 64 rows by wgmma from shared memory, p
// in registers by an online softmax, and o += p.v with p as the register A
// operand; o stays in registers for the whole walk.
template <int D>
__global__ void __launch_bounds__(fwg::THREADS, 1)
local_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap kh_map,
                                 const __grid_constant__ CUtensorMap vh_map,
                                 bf16* __restrict__ out, float* __restrict__ lse, int bh,
                                 int seq, int wsz, float scale, int halo) {
  using namespace fwg;
  using S = fwg::Layout<D>;  // the wmma route's Layout is another
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int b0 = block_row(blockIdx.x / bh, seq, wsz);
  const int row0 = (blockIdx.x % bh) * seq;
  const int hrow0 = (blockIdx.x % bh) * wsz;  // this sequence's halo rows
  const int first = dq_first(b0, wsz, halo);
  const int tiles = dq_tiles(b0, wsz, halo);
  const int group = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_barriers(full, empty, resident);

  if (group == 2) {  // the producer: one thread issues every copy
    if (tid == 0) {
      mbar_expect_tx(resident, 2 * S::TILE);
      for (int g = 0; g < 2; ++g) {
        load_tile<D>(smem + S::RES + g * S::TILE, &q_map, resident, row0 + b0 + TROWS * g);
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
  const float scale2 = scale * LOG2E;         // logits in log2 units
  const bool phantom = b0 < wsz && !halo;     // window 0: wsz zero logits too
  unsigned char* qs = smem + S::RES + group * S::TILE;
  // the running max of each row (log2 units), and this thread's share of
  // each row's denominator at that max
  float mx[2], den[2] = {0.0f, 0.0f};
  mx[0] = mx[1] = phantom ? 0.0f : -1e30f;
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
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      wgmma_fence();
      scores<D>(sc, qs, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      // fragment element 4 i + 2 h + x: row lr + 8 h, key column
      // 8 i + 2 (lane % 4) + x; on the diagonal tile key c sees row r only
      // if c <= r
      float top[2] = {mx[0], mx[1]};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 4 * i + 2 * h + x;
            const int r = lr + 8 * h, c = 8 * i + 2 * (lane % 4) + x;
            const float v = (kind == FULL || c <= r) ? sc[e] * scale2 : -INFINITY;
            sc[e] = v;
            top[h] = fmaxf(top[h], v);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 1));
        top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 2));
        alpha[h] = exp2f(mx[h] - top[h]);
        mx[h] = top[h];
        den[h] *= alpha[h];
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = exp2f(sc[4 * i + 2 * h] - mx[h]);
          const float p1 = exp2f(sc[4 * i + 2 * h + 1] - mx[h]);
          den[h] += p0 + p1;
          a_slot(pa, i, h) = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
      wgmma_fence();
      accumulate<D>(acc, pa, ks + S::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
    }
    if (tid == 0) mbar_arrive(&empty[s]);  // a skipping warpgroup arrives too
  }

  // the quad's shares of each denominator, the phantom's wsz zero logits
  // (exp(0 - max) each), then out = o / denominator and lse = max + log
  float inv[2];
  const size_t at = static_cast<size_t>(row0) + r0 + lr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
    if (phantom) den[h] += static_cast<float>(wsz) * exp2f(-mx[h]);
    inv[h] = 1.0f / den[h];
    if (lane % 4 == 0) lse[at + 8 * h] = mx[h] * LN2 + logf(den[h]);
  }
  // stage the bf16 rows in the warpgroup's own q tile (free now), in its
  // swizzle, then write them with 16-byte stores
  named_sync(1 + group, 128);  // every warp of the warpgroup is done with q
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<__nv_bfloat162*>(qs + swizzled(lr + 8 * h, col)) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] * inv[h], acc[4 * i + 2 * h + 1] * inv[h]);
    }
  }
  named_sync(1 + group, 128);
  bf16* dst = out + (static_cast<size_t>(row0) + r0) * D;
  for (int v = tid; v < TROWS * (D / 8); v += 128) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * D + c) =
        *reinterpret_cast<const uint4*>(qs + swizzled(r, c));
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* k_halo,
                         const void* v_halo, void* out, void* lse, int bh, int seq, int wsz,
                         float scale, cudaStream_t stream) {
  using progen::attention::wgmma::tile_map;
  const long long rows = static_cast<long long>(bh) * seq;
  const long long halo_rows = static_cast<long long>(bh) * wsz;
  const int halo = k_halo != nullptr;
  CUtensorMap q_map, k_map, v_map, kh_map, vh_map;
  if (!tile_map(&q_map, q, rows, D) || !tile_map(&k_map, k, rows, D) ||
      !tile_map(&v_map, v, rows, D)) {
    return cudaErrorInvalidValue;
  }
  kh_map = k_map;  // never read without a halo
  vh_map = v_map;
  if (halo && (!tile_map(&kh_map, k_halo, halo_rows, D) ||
               !tile_map(&vh_map, v_halo, halo_rows, D))) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t bytes = fwg::Layout<D>::SMEM;
  auto kernel = local_attention_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(seq / fwg::ROWS) * bh, fwg::THREADS, bytes, stream>>>(
      q_map, k_map, v_map, kh_map, vh_map, static_cast<bf16*>(out), static_cast<float*>(lse),
      bh, seq, wsz, scale, halo);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (bh, seq, dim_head) contiguous, dtype 0 = float32, 1 = bfloat16;
// k_halo, v_halo: (bh, wsz, dim_head), both null (the phantom window) or
// neither; lse: (bh, seq) float32.  Returns the CUDA error code of the
// launch (0 = ok).
extern "C" int local_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* k_halo, const void* v_halo, void* out,
                                   void* lse, int bh, int seq, int dim_head, int wsz,
                                   float scale, int dtype, void* stream) {
  if (bh <= 0 || seq <= 0 || wsz <= 0 || seq % wsz != 0 ||
      (k_halo == nullptr) != (v_halo == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, k_halo, v_halo, out, lse, bh, seq, dim_head, wsz, scale, s);
  } else if (dtype == 1) {
    err = dispatch<bf16>(q, k, v, k_halo, v_halo, out, lse, bh, seq, dim_head, wsz, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The wgmma route of K1-fwd: bfloat16 only (dtype 1), dim_head 32, 64 or
// 128 (32: its own kernel, 64-row blocks), wsz a multiple of 128, every
// pointer 16-byte aligned; arguments as for local_attention_fwd.  Returns
// the CUDA error code of the launch (0 = ok).
extern "C" int local_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* k_halo, const void* v_halo, void* out,
                                         void* lse, int bh, int seq, int dim_head, int wsz,
                                         float scale, int dtype, void* stream) {
  if (bh <= 0 || seq <= 0 || wsz <= 0 || seq % wsz != 0 || dtype != 1 ||
      (k_halo == nullptr) != (v_halo == nullptr) || wsz % fwg::ROWS != 0 ||
      (dim_head != 32 && dim_head != 64 && dim_head != 128) ||
      static_cast<long long>(bh) * seq > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dim_head == 32 ? launch_wgmma_d32(q, k, v, k_halo, v_halo, out, lse, bh, seq, wsz, scale, s)
      : dim_head == 64
          ? launch_wgmma<64>(q, k, v, k_halo, v_halo, out, lse, bh, seq, wsz, scale, s)
          : launch_wgmma<128>(q, k, v, k_halo, v_halo, out, lse, bh, seq, wsz, scale, s);
  return static_cast<int>(err);
}

// The tf32x3 route of K1-fwd: float32 only (dtype 0), dim_head 32, 64 or
// 128, wsz a multiple of 128, every pointer 16-byte aligned; arguments as
// for local_attention_fwd.  Returns the CUDA error code of the launch (0 = ok).
extern "C" int local_attention_fwd_tf32x3(const void* q, const void* k, const void* v,
                                          const void* k_halo, const void* v_halo, void* out,
                                          void* lse, int bh, int seq, int dim_head, int wsz,
                                          float scale, int dtype, void* stream) {
  if (bh <= 0 || seq <= 0 || wsz <= 0 || seq % wsz != 0 || dtype != 0 ||
      (k_halo == nullptr) != (v_halo == nullptr) || wsz % t3::ROWS != 0 ||
      (dim_head != 32 && dim_head != 64 && dim_head != 128) ||
      static_cast<long long>(bh) * seq > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dim_head == 32 ? launch_tf32x3_d32(q, k, v, k_halo, v_halo, out, lse, bh, seq, wsz, scale, s)
      : dim_head == 64
          ? launch_tf32x3<64>(q, k, v, k_halo, v_halo, out, lse, bh, seq, wsz, scale, s)
          : launch_tf32x3<128>(q, k, v, k_halo, v_halo, out, lse, bh, seq, wsz, scale, s);
  return static_cast<int>(err);
}
