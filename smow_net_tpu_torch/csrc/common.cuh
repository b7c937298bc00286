// Small helpers shared by the kernels in this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace smow {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Load N contiguous elements (N * sizeof(T) a multiple of 16 bytes, 16-byte
// aligned) as 16-byte vectors and widen them to fp32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&v)[N]) {
  constexpr int kPerVec = 16 / sizeof(T);
  static_assert(N % kPerVec == 0, "row must be a whole number of 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N / kPerVec; ++i) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPerVec; ++j) v[i * kPerVec + j] = to_float(e[j]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace smow
