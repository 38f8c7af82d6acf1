// The windowed-attention kernels' f32 machinery on the tensor cores, shared
// by K1-fwd (local_attention_fwd.cu), K1-dq and K1-dkv
// (local_attention_bwd.cu) on their "tf32x3" route: the 3xTF32 split, mma.sync and the fragment loaders
// of tf32x3.cuh (its note says how a product is formed and read), with the
// attention kernels' tiling.
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

}  // namespace tf32x3
}  // namespace attention
}  // namespace progen
