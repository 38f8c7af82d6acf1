// The windowed-attention kernels' Hopper machinery, shared by K1-fwd
// (local_attention_fwd.cu) and K1-dq / K1-dkv (local_attention_bwd.cu) on
// their "wgmma" route: a block of three warpgroups owns 128 rows of one
// window, two consumer warpgroups of 64 rows and a producer whose one
// thread streams 64-row tiles of the other side through a ring of
// 128-byte-swizzled TMA stages; the tile walk; the products (s = A.B^T
// from shared memory, acc += P.B with P as the register A operand).  At
// dim_head 32 (`d32`: K1-fwd and K1-dkv) a bf16 row is 64 bytes, so the
// tiles are 64-byte swizzled and a block is one consumer warpgroup.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace progen {
namespace attention {
namespace wgmma {

using namespace progen::hopper;

constexpr int ROWS = 128;            // rows a block owns: two consumer warpgroups
constexpr int TROWS = 64;            // rows of a warpgroup, and of a streamed tile
constexpr int BOX = 64 * 64 * 2;     // one (64 rows, 64 columns) bf16 TMA box, 8 KB
constexpr int STAGES = 4;
constexpr int THREADS = 384;         // warpgroups 0-1 consume, 2 produces
constexpr float LOG2E = 1.4426950408889634f;

// The tile walk, shared with cuda_attention.k1_bwd_tiles and k1_fwd_tiles
// (which the CPU tests hold against the visibility mask).  A block owns
// rows [b0, b0 + 128) of one window (wsz % 128 == 0) and streams 64-row
// tiles t0 of the other side: K1-fwd and K1-dq stream the keys from the
// previous window's first (none for window 0: the phantom's keys are
// zeros; with a halo, window 0's previous window is the halo, rows
// t0 in [-wsz, 0)) to b0 + 64; K1-dkv streams the queries from b0 to the
// end of the next window (once for each of its two passes), and a block of
// halo keys (b0 < 0) the queries of window 0.  A warpgroup's rows
// r0 = b0 + 64 g meet a tile as full, diagonal (the causal mask, applied in
// registers) or skipped (no visible pair).
enum Kind { FULL = 0, DIAGONAL = 1, SKIPPED = 2 };

__device__ __forceinline__ int dq_first(int b0, int wsz, bool halo = false) {
  return halo ? (b0 / wsz - 1) * wsz : max(0, (b0 / wsz - 1) * wsz);
}
__device__ __forceinline__ int dq_tiles(int b0, int wsz, bool halo = false) {
  return (b0 + TROWS - dq_first(b0, wsz, halo)) / TROWS + 1;
}
__device__ __forceinline__ int dq_kind(int r0, int t0) {
  return t0 < r0 ? FULL : (t0 == r0 ? DIAGONAL : SKIPPED);
}
__device__ __forceinline__ int dkv_tiles(int b0, int wsz, int seq) {
  return (min((b0 / wsz + 2) * wsz, seq) - b0) / TROWS;
}
__device__ __forceinline__ int dkv_kind(int r0, int t0) {
  return t0 > r0 ? FULL : (t0 == r0 ? DIAGONAL : SKIPPED);
}

// K1-fwd's blocks (both Hopper routes, 128 rows each): the first row of the
// block of rank `rank` in the longest-first order (mirrored by
// cuda_attention.k1_fwd_tiles).  A row block at place p of window w >= 1
// walks wsz / 64 + 2 p + 2 key tiles, one of window 0 only 2 p + 2 (no
// previous window): so first the blocks of windows 1.. by place, the last
// place first, then window 0's, the last place first.
__device__ __forceinline__ int block_row(int rank, int seq, int wsz) {
  const int wins = seq / wsz, places = wsz / ROWS;
  const int later = (wins - 1) * places;  // blocks outside window 0
  if (rank < later) {
    return (wins - 1 - rank % (wins - 1)) * wsz + (places - 1 - rank / (wins - 1)) * ROWS;
  }
  return (places - 1 - (rank - later)) * ROWS;
}

// Each stage's `full` barrier takes the producer's one arrival (and the
// bytes of its copies), its `empty` barrier one arrival per consumer
// warpgroup, which a warpgroup that skips the tile makes too; `resident`
// takes the block's own tiles.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* resident) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// One 64-row tile (rows `row`.. of the (B*H*L, D) matrix) by D / 64 copies.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a) tma_load_2d(dst + a * BOX, map, bar, 64 * a, row);
}

// s[64 x 64] = A_rows . B_rows^T over D: both 64-row tiles K-major (D
// contiguous); step kk reads columns 16 kk.. of box kk / 4.
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_m64n64k16<0, 0>(s, sw128_desc(a + off, 16, 1024), sw128_desc(b + off, 16, 1024), 1);
  }
}

// acc[64 x D] += P[64 x 64] . B_tile[64 x D]: P from registers (four 16-wide
// slices), the tile an N-major operand whose 64-column boxes lie BOX apart.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&p)[4][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs<1>(acc, p[k], sw128_desc(b + 2048 * k, BOX, 1024), 1);
    } else {
      wgmma_m64n64k16_rs<1>(acc, p[k], sw128_desc(b + 2048 * k, BOX, 1024), 1);
    }
  }
}

// Where an m64n64 f32 fragment's elements 4 i + 2 h and 4 i + 2 h + 1 (row
// lr + 8 h, columns 8 i + 2 (lane % 4) and the next) go in the bf16 A
// operand of its four 16-wide slices: a[i / 2][2 (i % 2) + h] (hopper.cuh).
// Packing each pair as it is formed lets its f32 registers go at once.
__device__ __forceinline__ uint32_t& a_slot(uint32_t (&a)[4][4], int i, int h) {
  return a[i / 2][2 * (i % 2) + h];
}

// (rows, D) bf16 as a tensor map of (64 columns, 64 rows) boxes.
inline bool tile_map(CUtensorMap* map, const void* base, long long rows, int d) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {64, 64};
  return bf16_tensor_map(map, base, 2, dims, strides, box);
}

// dim_head 32 (ProGen-default), K1-fwd and K1-dkv in bf16: a bf16 row is
// 64 bytes, so a tile is one (32 columns, 64 rows) box, 4 KB, with 64-byte
// swizzle (the 128-byte maps above need 64 columns); a block is one
// consumer warpgroup of 64 rows and one producer warp, several resident on
// an SM, and its blocks run in the f32 route's longest-walk-first order
// (attention_tf32x3.cuh, d32::fwd_block_row and d32::dkv_block_row: the
// same 64-row blocks).
namespace d32 {

constexpr int D = 32;
constexpr int ROWS = 64;              // rows a block owns, and of a streamed tile
constexpr int TILE = ROWS * D * 2;    // one 64-row bf16 tile, 4 KB
constexpr int CONSUMERS = 128;        // threads 0-127 consume, 128-159 produce
constexpr int THREADS = CONSUMERS + 32;
constexpr int SWIZZLE = 512;          // bytes of a 64-byte-swizzle atom (8 rows)
constexpr float LN2 = 0.6931471805599453f;

// Each of the ring's `stages` `full` barriers takes the producer's one
// arrival (and the bytes of its copies), each `empty` barrier the consumer
// warpgroup's one; `resident` takes the block's own tiles.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* resident, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// s[64 x 64] = A_rows . B_rows^T over D = 32: both tiles K-major, two
// k-steps of 16 columns (32 bytes) inside each 64-byte row.
__device__ __forceinline__ void scores(float (&s)[32], const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_m64n64k16<0, 0>(s, sw64_desc(a + 32 * kk, 16, SWIZZLE),
                          sw64_desc(b + 32 * kk, 16, SWIZZLE), 1);
  }
}

// acc[64 x 32] += P[64 x 64] . B_tile[64 x 32]: P from registers (four
// 16-wide slices), the tile an N-major operand one swizzle atom wide, its
// 16-row slice k at 1024 k bytes.
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&p)[4][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wgmma_m64n32k16_rs<1>(acc, p[k], sw64_desc(b + 16 * D * 2 * k, TILE, SWIZZLE), 1);
  }
}

// A warpgroup's 64 x 32 f32 fragment (rows lr and lr + 8, columns
// 8 i + 2 (lane % 4) and the next) times mul[h] for row lr + 8 h, cast once
// and written to the 64 rows at `dst` (32 bf16 each).
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[D / 2], const float (&mul)[2]) {
  const int lane = threadIdx.x % 32;
  const int lr = 16 * ((threadIdx.x % CONSUMERS) / 32) + lane / 4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (lr + 8 * h) * D + 8 * i + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] * mul[h], acc[4 * i + 2 * h + 1] * mul[h]);
    }
  }
}

// (rows, 32) bf16 as a tensor map of (32 columns, 64 rows) boxes, 64-byte
// swizzled.
inline bool tile_map(CUtensorMap* map, const void* base, long long rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {D, ROWS};
  return bf16_tensor_map(map, base, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace d32

}  // namespace wgmma
}  // namespace attention
}  // namespace progen
