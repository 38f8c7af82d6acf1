// The windowed-attention kernels' f32 machinery on the tensor cores, shared
// by K1-fwd (local_attention_fwd.cu), K1-dq and K1-dkv
// (local_attention_bwd.cu) on their "tf32x3" route: the 3xTF32 split, mma.sync and the fragment loaders
// of tf32x3.cuh (its note says how a product is formed and read), with the
// attention kernels' tiling (at dim_head 32, `d32`: blocks of four warps).
//
// K1's products and their operands: s = q.k^T, dp = dout.v^T and their
// transposes read both operands K-major (load_a, load_b_rows); p.v, ds.k,
// p^T.dout and ds^T.q take their A operand from a first product's C
// fragment (a_from_c) and B N-major with k permuted to match
// (load_b_cols).  Rows are D + 4 words apart.  (wgmma .tf32 wants both
// operands K-major, which p.v, ds.k, p^T.dout and ds^T.q are not:
// transposed copies, and a split held in shared memory, would double a
// tile's bytes.)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace progen {
namespace attention {
namespace tf32x3 {

// FragA, FragB, split, mma3, load_a, a_from_c, load_b_rows, load_b_cols
using namespace progen::tf32x3;

constexpr int ROWS = 128;     // rows a block owns: eight warps of 16
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KEYS = 64;      // K1-fwd: keys of a streamed tile
constexpr int DQ_KEYS = 32;   // K1-dq: keys of a streamed tile
constexpr int QUERIES = 32;   // K1-dkv: queries of a streamed tile
constexpr int STAGES = 2;     // the ring: one tile in use, the next in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Rows [0, N) of a (rows, D) f32 matrix from `src` into shared memory rows
// of D + 4 words, by the block's threads (the caller commits the group).
template <int D, int N>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src) {
  progen::tf32x3::copy_rows<D, N, THREADS>(dst, src);
}

// dim_head 32 (ProGen-default), K1-fwd and K1-dkv: a quarter of D = 128's
// tiles, so smaller blocks of four warps, several resident on an SM, each
// warp holding its own operand's split in registers for the whole walk.
namespace d32 {

constexpr int D = 32;
constexpr int LD = D + 4;     // shared-memory rows, words: 4 (mod 32)
constexpr int ROWS = 64;      // rows a block owns: four warps of 16
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KEYS = 64;      // K1-fwd: keys of a streamed tile
constexpr int QUERIES = 32;   // K1-dkv: queries of a streamed tile

// K1-fwd's query blocks, longest walk first (mirrored by
// cuda_attention.k1_fwd_tiles(..., block=64)): a block at place p of
// window w >= 1 walks wsz / 64 + p + 1 key tiles, one of window 0 only
// p + 1 (no previous window), so first the blocks of windows 1.. by place,
// the last place first, then window 0's, the last place first.
__device__ __forceinline__ int fwd_block_row(int rank, int seq, int wsz) {
  const int wins = seq / wsz, places = wsz / ROWS;
  const int later = (wins - 1) * places;  // blocks outside window 0
  if (rank < later) {
    return (wins - 1 - rank % (wins - 1)) * wsz + (places - 1 - rank / (wins - 1)) * ROWS;
  }
  return (places - 1 - (rank - later)) * ROWS;
}

// K1-dkv's key blocks, longest walk first (mirrored by
// cuda_attention.k1_dkv_blocks): a block at place p of window w streams
// the queries from its first key to the end of window w + 1, 2 wsz - 64 p
// of them, or wsz - 64 p in the last window; so first the blocks of every
// window but the last by place, the first place first, then the last
// window's.  Ranks past the sequence's blocks own the halo's keys
// (b0 < 0), which stream window 0's wsz queries.
__device__ __forceinline__ int dkv_block_row(int rank, int seq, int wsz) {
  const int wins = seq / wsz, places = wsz / ROWS, own = seq / ROWS;
  const int early = (wins - 1) * places;  // blocks outside the last window
  if (rank >= own) return (rank - own) * ROWS - wsz;
  if (rank < early) return (rank % (wins - 1)) * wsz + (rank / (wins - 1)) * ROWS;
  return (wins - 1) * wsz + (rank - early) * ROWS;
}

}  // namespace d32

}  // namespace tf32x3
}  // namespace attention
}  // namespace progen
