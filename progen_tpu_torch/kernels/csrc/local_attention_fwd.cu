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
// What bounds it on this card: at ProGen-small (D = 128, wsz = 256) a row
// does 4*D*(wsz + i%wsz + 1) flops, ~196k on average, over 4*D*2 bytes of
// q/k/v/out in bf16: ~190 flops per byte, under the H100's ~295 flops/byte
// ridge, so the bound is the bytes (33.6 MB, 0.0101 ms at B = 4), if not by
// much (6.45 GFLOP, 0.0065 ms at the bf16 peak).
//
// Two routes, chosen before the launch by cuda_attention.fwd_route from the
// dtype, dim_head and window alone, each under its own extern "C" name:
//
// "wgmma" (local_attention_fwd_wgmma): bf16, dim_head 64 or 128, windows
// that are multiples of 128 (every shipped config but `default`).  It walks
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
// "wmma" (local_attention_fwd): f32 (the comparison path), dim_head 32 and
// the other windows.  Flash-style, one block of 4 warps per (b*h, 64 query
// rows); each warp owns 16 rows.  The block walks 64-key tiles over the
// extended key range [window start of its first row - wsz, its last row];
// a key tile row before position 0 is loaded as zeros (the phantom
// window).  Keys above a row's diagonal are skipped rather than filled
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

// The first row of the block of rank `rank` in the longest-first order
// (mirrored by cuda_attention.k1_fwd_tiles).  A row block at place p of
// window w >= 1 walks wsz / 64 + 2 p + 2 key tiles, one of window 0 only
// 2 p + 2 (no previous window): so first the blocks of windows 1.. by place,
// the last place first, then window 0's, the last place first.
__device__ __forceinline__ int block_row(int rank, int seq, int wsz) {
  const int wins = seq / wsz, places = wsz / ROWS;
  const int later = (wins - 1) * places;  // blocks outside window 0
  if (rank < later) {
    return (wins - 1 - rank % (wins - 1)) * wsz + (places - 1 - rank / (wins - 1)) * ROWS;
  }
  return (places - 1 - (rank - later)) * ROWS;
}

// Byte offset of element (row r, column c) of a 64-row tile of D columns in
// the 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8)).
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c / 64) * BOX + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

}  // namespace fwg

// K1-fwd, bf16: block blk owns query rows [b0, b0 + 128) of row block
// blk / bh (fwg::block_row) of sequence blk % bh.  The producer loads the
// block's q once and streams the k and v tiles of the walk; a consumer
// warpgroup forms s = q.k^T for its 64 rows by wgmma from shared memory, p
// in registers by an online softmax, and o += p.v with p as the register A
// operand; o stays in registers for the whole walk.
template <int D>
__global__ void __launch_bounds__(fwg::THREADS, 1)
local_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 bf16* __restrict__ out, float* __restrict__ lse, int bh,
                                 int seq, int wsz, float scale) {
  using namespace fwg;
  using S = fwg::Layout<D>;  // the wmma route's Layout is another
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int b0 = block_row(blockIdx.x / bh, seq, wsz);
  const int row0 = (blockIdx.x % bh) * seq;
  const int first = dq_first(b0, wsz);
  const int tiles = dq_tiles(b0, wsz);
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
  const float scale2 = scale * LOG2E;         // logits in log2 units
  const bool phantom = b0 < wsz;              // window 0: wsz zero logits too
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
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                         int bh, int seq, int wsz, float scale, cudaStream_t stream) {
  using progen::attention::wgmma::tile_map;
  const long long rows = static_cast<long long>(bh) * seq;
  CUtensorMap q_map, k_map, v_map;
  if (!tile_map(&q_map, q, rows, D) || !tile_map(&k_map, k, rows, D) ||
      !tile_map(&v_map, v, rows, D)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t bytes = fwg::Layout<D>::SMEM;
  auto kernel = local_attention_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(seq / fwg::ROWS) * bh, fwg::THREADS, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), static_cast<float*>(lse), bh, seq, wsz,
      scale);
  return cudaGetLastError();
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

// The wgmma route of K1-fwd: bfloat16 only (dtype 1), dim_head 64 or 128,
// wsz a multiple of 128, every pointer 16-byte aligned; arguments as for
// local_attention_fwd.  Returns the CUDA error code of the launch (0 = ok).
extern "C" int local_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                         void* out, void* lse, int bh, int seq,
                                         int dim_head, int wsz, float scale, int dtype,
                                         void* stream) {
  if (bh <= 0 || seq <= 0 || wsz <= 0 || seq % wsz != 0 || dtype != 1 ||
      wsz % fwg::ROWS != 0 || (dim_head != 64 && dim_head != 128) ||
      static_cast<long long>(bh) * seq > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dim_head == 64
      ? launch_wgmma<64>(q, k, v, out, lse, bh, seq, wsz, scale, s)
      : launch_wgmma<128>(q, k, v, out, lse, bh, seq, wsz, scale, s);
  return static_cast<int>(err);
}
