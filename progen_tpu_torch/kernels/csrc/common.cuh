// Helpers shared by the port's kernels: the element types they take and the
// conversions to and from the f32 they compute in.
#pragma once

#include <cuda_bf16.h>

namespace progen {

using bf16 = __nv_bfloat16;

// Shared-memory row padding, in elements: 16 bytes, so that rows stay
// 16-byte aligned for vector copies and WMMA strides stay legal while
// neighbouring rows fall in other banks.
template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace progen
