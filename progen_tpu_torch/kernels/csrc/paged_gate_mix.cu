// Ragged paged gate mix for Hopper (sm_90a): the decode step's spatial-gate
// contraction over gate rows that live in a global page pool.
//
// Replaces the TPU kernels progen_tpu/ops/pallas_paged_attention.py:
// _mix_kernel (launched by _pallas_mix) and _mix_kernel_q8 (launched by
// _pallas_mix_q8).  For batch row b at position pos_b:
//
//   out[b] = sum_{i <= pos_b} W[pos_b, i] * pool[table[b, i / ps], i % ps]
//            + bias[pos_b]
//
// with W (n, n), bias (n, 1) f32, pool (num_pages, ps, d), table (B, ppr)
// int32, pos (B,) int32, out (B, d) f32.  The q8 entry points take W as int8
// with one f32 scale per weight ROW and/or the pool as int8 with one f32
// scale per pool ROW; both are widened to f32 and scaled before the product,
// as the TPU kernel does, so nothing 8-bit passes through device memory at a
// higher precision.  The full-precision entry points are their own
// instantiations and never multiply by a scale.
//
// Rules both routes keep: rows past pos_b are never read (the walk stops
// there), so a stale row in a reused page, or garbage in the write-sink
// page, cannot reach the sum; W is never read at a column >= n, even when
// ppr * ps > n; a table entry outside the pool is skipped; the bias is added
// in f32 at the end; no float goes through an atomic, so a rerun gives the
// same bits.
//
// What bounds it on this card: the bytes.  At ProGen-small with 8 rows at
// ragged positions it reads 3672 pool rows of 4 KB (bf16) for one FMA per
// pool element: 15.1 MB for 0.015 GFLOP, 0.0045 ms at 3.35 TB/s.
//
// Two routes, chosen by the wrapper before the launch
// (ops/cuda_paged_gate_mix.py:route):
//
// "bulk" (paged_gate_mix_bulk, paged_gate_mix_q8_bulk), every pool whose
// row is a multiple of 16 bytes.  The grid is (split, slab, batch row),
// sized from the shapes alone, never from pos, so a captured graph replays
// with new positions.  Split s takes rows [r s, r s + r) of the walk (r =
// 32; 16 for an int8 pool, whose row is one slab), slab l bytes [2048 l,
// 2048 l + 2048) of each pool row (1024 bf16 channels, 512 f32 or 2048
// int8), and the splits form thread-block clusters of 8.  A cluster whose
// first row lies past pos_b exits at once; in a live cluster a split past
// pos_b copies nothing and only joins the cluster's barriers.  At the
// smoke's positions 236 blocks sum (bf16; 232 for int8), each reading at
// most 64 KB, three blocks an SM: the long rows no longer keep a few
// blocks busy while the rest of the card idles.
//
// In a block one producer warp feeds a ring of 4 stages of 8 row slabs (16
// KB) by cp.async.bulk, one copy a row, completing on the stage's mbarrier:
// lane j + 1 reads row j's table entry, skips a page outside the pool,
// starts the copy, and puts the row's weight W[pos_b, i] (times
// w_scale[pos_b]) and, for an int8 pool, the row's scale into the stage's
// header; lane 0 announces the stage's bytes.  The lanes load the table
// entries and weights of the first ring before the barriers are set up,
// and a whole split is in flight at once.  Two groups of 128 consumer
// threads take the even and the odd rows of each stage; a thread owns 16
// bytes of the slab (8 bf16, 16 int8 or 4 f32 channels), read as one
// 16-byte shared-memory load, widened exactly (int8 without the conversion
// unit), scaled, and summed in f32 FMAs.  The groups add in shared memory
// (group 0 + group 1), which leaves the split's f32 sums of its slab there.
//
// The sum across blocks: block r of a cluster sums the r-th eighth of the
// slab over the cluster's live splits, in split order, reading their
// shared memory (distributed shared memory).  One live cluster writes out
// = sum + bias at once.  Otherwise each cluster writes its sums to a
// workspace (B, clusters, d) and draws a ticket (an int atomic add with
// acquire and release, per (b, slab, rank)); the block that draws the last
// one sums the clusters in order, adds the bias, writes out and sets the
// ticket back to 0 for the next launch or graph replay.  Floats never meet
// an atomic: the bits are the same on every run.
//
// What holds it back (kernels.ablate at the smoke's shape, warm L2, on an
// H100): the launch of the grid alone is a fifth of the time, the copies
// and the fixed latencies of a block (table, copy, barriers) most of the
// rest; the products hide under the copies; the cluster's sum and the
// ticket take about a sixth each.
//
// "simt" (paged_gate_mix, paged_gate_mix_q8), the first kernel, for the
// rest (a row that is no multiple of 16 bytes, such as 72 int8 channels):
// one block per (batch row, 128-channel tile) walks the row's pos_b + 1
// pool rows, each of 16 warps every 16th row, a lane 4 channels; the
// warps' sums meet in shared memory and the bias is added in the epilogue.
//
// Measured times: PERF.md, section 6.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using progen::bf16;

// -- the "simt" route: the first kernel ---------------------------------------

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 4;            // channels per lane
constexpr int TILE = 32 * VEC;    // channels per block

__device__ __forceinline__ float weight_f(float x) { return x; }
__device__ __forceinline__ float weight_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void load4(const float* p, float (&x)[VEC]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&x)[VEC]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[VEC]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = static_cast<float>(v.x); x[1] = static_cast<float>(v.y);
  x[2] = static_cast<float>(v.z); x[3] = static_cast<float>(v.w);
}

template <typename WT, typename PT, bool SCALED>
__global__ void __launch_bounds__(THREADS)
paged_gate_mix_kernel(const WT* __restrict__ w, const float* __restrict__ bias,
                      const PT* __restrict__ pool, const int* __restrict__ table,
                      const int* __restrict__ pos, const float* __restrict__ w_scale,
                      const float* __restrict__ pool_scale, float* __restrict__ out,
                      int n, int d, int ps, int ppr, int num_pages) {
  __shared__ float part[WARPS][TILE];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * TILE + lane * VEC;
  const int p = pos[b];
  const int row = min(max(p, 0), n - 1);           // weight row and bias entry
  const int last = min(min(p, n - 1), ppr * ps - 1);  // pool rows 0..last count
  const int* trow = table + static_cast<size_t>(b) * ppr;
  const WT* wrow = w + static_cast<size_t>(row) * n;
  float ws = 1.0f;
  if (SCALED && w_scale != nullptr) ws = w_scale[row];

  float acc[VEC] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c < d) {
#pragma unroll 4
    for (int i = warp; i <= last; i += WARPS) {
      const int page = trow[i / ps];
      if (static_cast<unsigned>(page) >= static_cast<unsigned>(num_pages)) continue;
      const size_t r = static_cast<size_t>(page) * ps + (i % ps);
      float wv = weight_f(wrow[i]);
      if (SCALED) wv *= ws;
      float x[VEC];
      load4(pool + r * d + c, x);
      if (SCALED && pool_scale != nullptr) {
        const float s = pool_scale[r];
#pragma unroll
        for (int k = 0; k < VEC; ++k) x[k] *= s;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wv, x[k], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) part[warp][lane * VEC + k] = acc[k];
  __syncthreads();

  const int col = blockIdx.x * TILE + threadIdx.x;
  if (threadIdx.x < TILE && col < d) {
    float sum = 0.0f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) sum += part[wi][threadIdx.x];
    out[static_cast<size_t>(b) * d + col] = sum + bias[row];
  }
}

template <typename WT, typename PT, bool SCALED>
cudaError_t launch(const void* w, const void* bias, const void* pool, const void* table,
                   const void* pos, const void* w_scale, const void* pool_scale, void* out,
                   int batch, int n, int d, int ps, int ppr, int num_pages,
                   cudaStream_t stream) {
  dim3 grid((d + TILE - 1) / TILE, batch);
  paged_gate_mix_kernel<WT, PT, SCALED><<<grid, THREADS, 0, stream>>>(
      static_cast<const WT*>(w), static_cast<const float*>(bias),
      static_cast<const PT*>(pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<const float*>(w_scale),
      static_cast<const float*>(pool_scale), static_cast<float*>(out), n, d, ps, ppr,
      num_pages);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int d, int ps, int ppr, int num_pages) {
  return batch <= 0 || batch > 65535 || n <= 0 || d <= 0 || d % VEC != 0 || ps <= 0 ||
         ppr <= 0 || num_pages <= 0;
}


// -- the "bulk" route ------------------------------------------------------------

namespace bk {

namespace cg = cooperative_groups;
using namespace progen::hopper;

constexpr int SLAB_BYTES = 2048;          // bytes of each pool row a block owns
constexpr int STAGE_ROWS = 8;             // row slabs a ring stage holds
constexpr int STAGES = 4;                 // ring stages (4 x 16 KB)
constexpr int SPLIT_ROWS = 32;            // rows of the walk a block takes
constexpr int SPLIT_ROWS_8 = 16;          // ... of an int8 pool (one slab a row)
constexpr int CLUSTER = 8;                // splits whose blocks form a cluster
constexpr int GROUPS = 2;                 // consumer row groups
constexpr int LANES = SLAB_BYTES / 16;    // threads of a group, 16 bytes each
constexpr int CONSUMERS = GROUPS * LANES;
constexpr int THREADS = 32 + CONSUMERS;   // the producer warp first
constexpr int MAX_CH = 16;                // channels a thread owns (int8)
// float4 units of a slab's f32 sums that one consumer thread takes in the
// cluster's and the last block's sums (a slab has at most 512 units)
constexpr int UNITS = (SLAB_BYTES / 4 / CLUSTER + CONSUMERS - 1) / CONSUMERS;
static_assert(STAGE_ROWS < 32 && STAGE_ROWS % GROUPS == 0 && SPLIT_ROWS % STAGE_ROWS == 0 &&
                  SPLIT_ROWS_8 % STAGE_ROWS == 0,
              "a stage's rows are producer lanes 1.., split evenly over the groups");

// Rows a split takes: an int8 row is one slab, a bf16 row two, so an int8
// pool's splits are half as long and the grid as wide.
template <typename PT>
__host__ __device__ constexpr int split_rows() {
  return sizeof(PT) == 1 ? SPLIT_ROWS_8 : SPLIT_ROWS;
}

// atomicAdd with acquire and release at the GPU's scope: the block's stores
// before it (ordered by a barrier) are seen by whoever draws a later
// ticket, and that block's loads after it see every earlier drawer's.
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// A stage's header, written by the producer lanes before they arrive on the
// stage's barrier: each row's weight (w_scale applied), each row's pool
// scale, and which rows were copied.
struct Head {
  float w[STAGE_ROWS];
  float scale[STAGE_ROWS];
  uint32_t mask;
  uint32_t pad[3];
};

// Shared memory: the ring, whose first bytes, once every stage is consumed,
// hold the other groups' sums (RED) and then the block's f32 sums of its
// slab (SUMS), which the cluster's blocks read; the stages' headers; the
// barriers; the ticket drawn.
constexpr size_t RING = static_cast<size_t>(STAGES) * STAGE_ROWS * SLAB_BYTES;
constexpr size_t RED = 0;
constexpr size_t SUMS = RED + static_cast<size_t>(GROUPS - 1) * MAX_CH * LANES * sizeof(float);
constexpr size_t HEADS = RING;
constexpr size_t BARS = HEADS + STAGES * sizeof(Head);
constexpr size_t FLAG = BARS + 2 * STAGES * sizeof(uint64_t);
constexpr size_t SMEM = FLAG + 16;
static_assert(SUMS + SLAB_BYTES * sizeof(float) <= RING, "the sums fit in the ring");

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
// Four int8 of a 32-bit word widened exactly to f32 on the integer and FMA
// pipes, not the conversion unit (a sixteenth of their rate): byte b ^ 0x80
// as the low mantissa bits of 2^23 is the float 2^23 + 128 + b, and one
// subtraction leaves b.
__device__ __forceinline__ void widen4(uint32_t word, float* x) {
  const uint32_t u = word ^ 0x80808080u;
  x[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  x[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  x[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  x[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
}
__device__ __forceinline__ void load16(const int8_t* p, float (&x)[16]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) widen4(u[k], x + 4 * k);
}

// x[q..q+3] + add as one 16-byte store (q a constant once the loops unroll)
template <int N>
__device__ __forceinline__ void store4(float* p, const float (&x)[N], int q, float add) {
  *reinterpret_cast<float4*>(p) =
      make_float4(x[q] + add, x[q + 1] + add, x[q + 2] + add, x[q + 3] + add);
}

template <typename WT, typename PT, bool SCALED>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
paged_gate_mix_bulk_kernel(const WT* __restrict__ w, const float* __restrict__ bias,
                           const PT* __restrict__ pool, const int* __restrict__ table,
                           const int* __restrict__ pos, const float* __restrict__ w_scale,
                           const float* __restrict__ pool_scale, float* __restrict__ out,
                           float* __restrict__ partials, int* __restrict__ tickets, int n,
                           int d, int ps, int ppr, int num_pages) {
  constexpr int CH = 16 / static_cast<int>(sizeof(PT));
  constexpr int SPLIT = split_rows<PT>();
  const int split = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int cl = split / CLUSTER, rank = split % CLUSTER;
  const int p = pos[b];
  const int row = min(max(p, 0), n - 1);              // weight row and bias entry
  const int last = min(min(p, n - 1), ppr * ps - 1);  // pool rows 0..last count
  const int live = last < 0 ? 1 : last / SPLIT + 1;  // splits that sum
  const int live_clusters = (live + CLUSTER - 1) / CLUSTER;
  if (cl >= live_clusters) return;  // every row of this cluster lies past pos_b
  const int r0 = split * SPLIT;
  const int rows = split < live ? max(0, min(last + 1 - r0, SPLIT)) : 0;
  const int stages = (rows + STAGE_ROWS - 1) / STAGE_ROWS;
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(PT);
  const int slab0 = slab * SLAB_BYTES;
  const int width = min(SLAB_BYTES, static_cast<int>(row_bytes) - slab0);

  extern __shared__ __align__(128) unsigned char smem[];
  Head* head = reinterpret_cast<Head*>(smem + HEADS);
  float* red = reinterpret_cast<float*>(smem + RED);
  float* sums = reinterpret_cast<float*>(smem + SUMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS);
  uint64_t* empty = full + STAGES;
  int* flag = reinterpret_cast<int*>(smem + FLAG);
  const int lane = threadIdx.x & 31;
  // the producer lane j + 1 brings row j of each stage; its table entries
  // and weights of the first ring are loaded before the barriers are set up
  const int j = lane - 1;
  const int* trow = table + static_cast<size_t>(b) * ppr;
  const WT* wrow = w + static_cast<size_t>(row) * n;
  int first_page[STAGES];
  float first_w[STAGES];
#pragma unroll
  for (int k = 0; k < STAGES; ++k) {
    const int i = k * STAGE_ROWS + j;  // the row's place in the split
    first_page[k] = -1;
    first_w[k] = 0.0f;
    if (threadIdx.x < 32 && j >= 0 && j < STAGE_ROWS && i < rows) {
      first_page[k] = trow[(r0 + i) / ps];
      first_w[k] = weight_f(wrow[r0 + i]);
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int c = threadIdx.x - 32;  // consumer index
  const int g = c / LANES, t = c % LANES;
  const bool owner = c >= 0 && g == 0 && t * 16 < width;
  float acc[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) acc[k] = 0.0f;
  if (threadIdx.x < 32) {
    // the producer warp
    float ws = 1.0f;
    if (SCALED && w_scale != nullptr) ws = w_scale[row];
    auto fetch = [&](int k, int page, float wv) {
      const int s = k % STAGES;
      if (k >= STAGES) mbar_wait_or_trap(&empty[s], ((k / STAGES) - 1) & 1);
      const int i = k * STAGE_ROWS + j;
      const bool ok = j >= 0 && j < STAGE_ROWS && i < rows &&
                      static_cast<unsigned>(page) < static_cast<unsigned>(num_pages);
      const uint32_t mask = __ballot_sync(0xffffffffu, ok) >> 1;
      Head& h = head[s];
      if (lane == 0) {
        h.mask = mask;
        mbar_expect_tx(&full[s], __popc(mask) * width);
      }
      __syncwarp();
      if (ok) {
        const size_t pr = static_cast<size_t>(page) * ps + (r0 + i) % ps;
        bulk_load(smem + static_cast<size_t>(s * STAGE_ROWS + j) * SLAB_BYTES,
                  reinterpret_cast<const unsigned char*>(pool) + pr * row_bytes + slab0,
                  width, &full[s]);
        if (SCALED) wv *= ws;
        h.w[j] = wv;
        if (SCALED && pool_scale != nullptr) h.scale[j] = pool_scale[pr];
      }
      if (lane != 0) mbar_arrive(&full[s]);
    };
#pragma unroll
    for (int k = 0; k < STAGES; ++k) {
      if (k < stages) fetch(k, first_page[k], first_w[k]);
    }
    for (int k = STAGES; k < stages; ++k) {  // a split longer than the ring
      const int i = k * STAGE_ROWS + j;
      const bool mine = j >= 0 && j < STAGE_ROWS && i < rows;
      fetch(k, mine ? trow[(r0 + i) / ps] : -1, mine ? weight_f(wrow[r0 + i]) : 0.0f);
    }
  } else {
    // the consumers: group g takes rows j = g, g + GROUPS, ... of each stage
    const bool active = t * 16 < width;
    for (int k = 0; k < stages; ++k) {
      const int s = k % STAGES;
      mbar_wait_or_trap(&full[s], (k / STAGES) & 1);
      const Head& h = head[s];
      const uint32_t mask = h.mask;
      if (active) {
#pragma unroll
        for (int j = g; j < STAGE_ROWS; j += GROUPS) {
          if ((mask >> j) & 1u) {
            float x[CH];
            load16(reinterpret_cast<const PT*>(
                       smem + static_cast<size_t>(s * STAGE_ROWS + j) * SLAB_BYTES + t * 16),
                   x);
            if (SCALED && pool_scale != nullptr) {
              const float sc = h.scale[j];
#pragma unroll
              for (int q = 0; q < CH; ++q) x[q] *= sc;
            }
            const float wv = h.w[j];
#pragma unroll
            for (int q = 0; q < CH; ++q) acc[q] = fmaf(wv, x[q], acc[q]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the groups' sums meet in group 0, in group order, over the spent ring
    named_sync(1, CONSUMERS);
    if (g > 0 && active) {
#pragma unroll
      for (int q = 0; q < CH; ++q) red[((g - 1) * MAX_CH + q) * LANES + t] = acc[q];
    }
    named_sync(1, CONSUMERS);
    if (owner) {
      for (int gg = 1; gg < GROUPS; ++gg) {
#pragma unroll
        for (int q = 0; q < CH; ++q) acc[q] += red[((gg - 1) * MAX_CH + q) * LANES + t];
      }
#pragma unroll
      for (int q = 0; q < CH; q += 4) store4(sums + t * CH + q, acc, q, 0.0f);
    }
  }
  // The cluster's splits meet: block `rank` sums its share of the slab's
  // float4 units over the cluster's live splits, in split order, from their
  // shared memory.  Every thread of every block of the cluster takes part
  // in both cluster barriers; the second keeps each block's sums alive
  // until the others have read them.
  cg::cluster_group cluster = cg::this_cluster();
  const int units = width / static_cast<int>(sizeof(PT)) / 4;
  const int per = (units + CLUSTER - 1) / CLUSTER;
  const int u0 = rank * per, u1 = min(units, u0 + per);
  const int ranks = min(CLUSTER, live - cl * CLUSTER);
  float4 mine[UNITS];
  cluster.sync();
  if (c >= 0) {
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = u0 + c + k * CONSUMERS;
      if (u >= u1) continue;
      float4 v = reinterpret_cast<const float4*>(cluster.map_shared_rank(sums, 0))[u];
      for (int q = 1; q < ranks; ++q) {
        const float4 x = reinterpret_cast<const float4*>(cluster.map_shared_rank(sums, q))[u];
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
      mine[k] = v;
    }
  }
  cluster.sync();
  if (c < 0) return;  // the producer warp is done

  // One live cluster: out = its sum + bias.  Otherwise each cluster's share
  // goes to the workspace (B, clusters, d), and the block that draws the
  // last ticket of its (b, slab, rank) sums the clusters in order.
  const size_t cb = static_cast<size_t>(slab0) / sizeof(PT);
  const float bv = bias[row];
  float* dst = out + static_cast<size_t>(b) * d + cb;
  float* part = partials + static_cast<size_t>(b) * (gridDim.x / CLUSTER) * d + cb;
  float* put = live_clusters == 1 ? dst : part + static_cast<size_t>(cl) * d;
  const float add = live_clusters == 1 ? bv : 0.0f;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = u0 + c + k * CONSUMERS;
    if (u >= u1) continue;
    const float x[4] = {mine[k].x, mine[k].y, mine[k].z, mine[k].w};
    store4(put + 4 * u, x, 0, add);
  }
  if (live_clusters == 1) return;
  named_sync(1, CONSUMERS);  // the block's stores, then one thread's ticket
  int* ticket = tickets + (static_cast<size_t>(b) * gridDim.y + slab) * CLUSTER + rank;
  if (c == 0) *flag = ticket_add(ticket);
  named_sync(1, CONSUMERS);
  if (*flag != live_clusters - 1) return;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = u0 + c + k * CONSUMERS;
    if (u >= u1) continue;
    float4 v = __ldcg(reinterpret_cast<const float4*>(part + 4 * u));
    for (int cc = 1; cc < live_clusters; ++cc) {
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(part + static_cast<size_t>(cc) * d + 4 * u));
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    const float x[4] = {v.x, v.y, v.z, v.w};
    store4(dst + 4 * u, x, 0, bv);
  }
  if (c == 0) *ticket = 0;  // ready for the next launch or graph replay
}

template <typename WT, typename PT, bool SCALED>
cudaError_t launch(const void* w, const void* bias, const void* pool, const void* table,
                   const void* pos, const void* w_scale, const void* pool_scale, void* out,
                   void* partials, void* tickets, int batch, int n, int d, int ps, int ppr,
                   int num_pages, int splits, cudaStream_t stream) {
  const int row_bytes = d * static_cast<int>(sizeof(PT));
  constexpr int rows = split_rows<PT>() * CLUSTER;
  const int clusters = (std::min(n, ppr * ps) + rows - 1) / rows;
  if (row_bytes % 16 != 0 || splits != clusters * CLUSTER) return cudaErrorInvalidValue;
  auto kernel = paged_gate_mix_bulk_kernel<WT, PT, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid(splits, (row_bytes + SLAB_BYTES - 1) / SLAB_BYTES, batch);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const WT*>(w), static_cast<const float*>(bias),
      static_cast<const PT*>(pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<const float*>(w_scale),
      static_cast<const float*>(pool_scale), static_cast<float*>(out),
      static_cast<float*>(partials), static_cast<int*>(tickets), n, d, ps, ppr, num_pages);
  return cudaGetLastError();
}

}  // namespace bk

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16, 2 = int8.  All tensors contiguous;
// d must be a multiple of 4.  Each returns the CUDA error code of the launch
// (0 = ok).  The first two are the "simt" route.

// K3: w (n, n) f32, bias (n, 1) f32, pool (num_pages, ps, d) f32 or bf16,
// table (batch, ppr) int32, pos (batch,) int32, out (batch, d) f32.
extern "C" int paged_gate_mix(const void* w, const void* bias, const void* pool,
                              const void* table, const void* pos, void* out, int batch,
                              int n, int d, int ps, int ppr, int num_pages,
                              int pool_dtype, void* stream) {
  if (bad_shape(batch, n, d, ps, ppr, num_pages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (pool_dtype == 0) {
    err = launch<float, float, false>(w, bias, pool, table, pos, nullptr, nullptr, out,
                                      batch, n, d, ps, ppr, num_pages, s);
  } else if (pool_dtype == 1) {
    err = launch<float, bf16, false>(w, bias, pool, table, pos, nullptr, nullptr, out,
                                     batch, n, d, ps, ppr, num_pages, s);
  }
  return static_cast<int>(err);
}

// K3-q8: as K3, with w f32 or int8 (then w_scale (n,) f32, else null) and the
// pool f32, bf16 or int8 (then pool_scale (num_pages, ps) f32, else null); at
// least one side is int8.
extern "C" int paged_gate_mix_q8(const void* w, const void* bias, const void* pool,
                                 const void* table, const void* pos, const void* w_scale,
                                 const void* pool_scale, void* out, int batch, int n, int d,
                                 int ps, int ppr, int num_pages, int w_dtype,
                                 int pool_dtype, void* stream) {
  if (bad_shape(batch, n, d, ps, ppr, num_pages) ||
      (w_dtype == 2) != (w_scale != nullptr) ||
      (pool_dtype == 2) != (pool_scale != nullptr) ||
      (w_dtype != 2 && pool_dtype != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define PROGEN_Q8_CASE(WD, PD, WT, PT)                                                   \
  if (w_dtype == WD && pool_dtype == PD) {                                               \
    err = launch<WT, PT, true>(w, bias, pool, table, pos, w_scale, pool_scale, out,      \
                               batch, n, d, ps, ppr, num_pages, s);                      \
  }
  PROGEN_Q8_CASE(2, 2, int8_t, int8_t)
  PROGEN_Q8_CASE(2, 1, int8_t, bf16)
  PROGEN_Q8_CASE(2, 0, int8_t, float)
  PROGEN_Q8_CASE(0, 2, float, int8_t)
#undef PROGEN_Q8_CASE
  return static_cast<int>(err);
}

// The "bulk" route's plan, for the wrapper to hold its mirror against:
// rows a split takes (f32 and bf16 pools, int8 pools), bytes of a slab, rows
// of a stage, consumer groups, splits a cluster.
extern "C" void paged_gate_mix_bulk_plan(int* plan) {
  plan[0] = bk::SPLIT_ROWS;
  plan[1] = bk::SPLIT_ROWS_8;
  plan[2] = bk::SLAB_BYTES;
  plan[3] = bk::STAGE_ROWS;
  plan[4] = bk::GROUPS;
  plan[5] = bk::CLUSTER;
}

// K3 on the "bulk" route: arguments as paged_gate_mix's, plus partials
// (batch, splits / 8, d) f32 and tickets (at least batch * slabs * 8 int32,
// zero before the first launch; each launch leaves them zero), with splits
// = 8 ceil(min(n, ppr * ps) / (8 r)) (whole clusters of 8 splits of r = 32
// rows, 16 for an int8 pool) and slabs = ceil(d * element size / 2048);
// d * element size must be a multiple of 16.
extern "C" int paged_gate_mix_bulk(const void* w, const void* bias, const void* pool,
                                   const void* table, const void* pos, void* out,
                                   void* partials, void* tickets, int batch, int n, int d,
                                   int ps, int ppr, int num_pages, int splits,
                                   int pool_dtype, void* stream) {
  if (bad_shape(batch, n, d, ps, ppr, num_pages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (pool_dtype == 0) {
    err = bk::launch<float, float, false>(w, bias, pool, table, pos, nullptr, nullptr, out,
                                          partials, tickets, batch, n, d, ps, ppr,
                                          num_pages, splits, s);
  } else if (pool_dtype == 1) {
    err = bk::launch<float, bf16, false>(w, bias, pool, table, pos, nullptr, nullptr, out,
                                         partials, tickets, batch, n, d, ps, ppr,
                                         num_pages, splits, s);
  }
  return static_cast<int>(err);
}

// K3-q8 on the "bulk" route: arguments as paged_gate_mix_q8's, plus
// partials, tickets and splits as paged_gate_mix_bulk's.
extern "C" int paged_gate_mix_q8_bulk(const void* w, const void* bias, const void* pool,
                                      const void* table, const void* pos,
                                      const void* w_scale, const void* pool_scale,
                                      void* out, void* partials, void* tickets, int batch,
                                      int n, int d, int ps, int ppr, int num_pages,
                                      int splits, int w_dtype, int pool_dtype,
                                      void* stream) {
  if (bad_shape(batch, n, d, ps, ppr, num_pages) ||
      (w_dtype == 2) != (w_scale != nullptr) ||
      (pool_dtype == 2) != (pool_scale != nullptr) ||
      (w_dtype != 2 && pool_dtype != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define PROGEN_Q8_BULK_CASE(WD, PD, WT, PT)                                             \
  if (w_dtype == WD && pool_dtype == PD) {                                              \
    err = bk::launch<WT, PT, true>(w, bias, pool, table, pos, w_scale, pool_scale, out, \
                                   partials, tickets, batch, n, d, ps, ppr, num_pages,  \
                                   splits, s);                                          \
  }
  PROGEN_Q8_BULK_CASE(2, 2, int8_t, int8_t)
  PROGEN_Q8_BULK_CASE(2, 1, int8_t, bf16)
  PROGEN_Q8_BULK_CASE(2, 0, int8_t, float)
  PROGEN_Q8_BULK_CASE(0, 2, float, int8_t)
#undef PROGEN_Q8_BULK_CASE
  return static_cast<int>(err);
}
