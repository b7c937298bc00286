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

// Store N fp32 values as N contiguous elements of T with 16-byte vectors
// (same size and alignment rules as load_f32).
template <typename T, int N>
__device__ __forceinline__ void store_from_f32(T* __restrict__ p, const float (&v)[N]) {
  constexpr int kPerVec = 16 / sizeof(T);
  static_assert(N % kPerVec == 0, "row must be a whole number of 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N / kPerVec; ++i) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPerVec; ++j) e[j] = from_float<T>(v[i * kPerVec + j]);
    reinterpret_cast<uint4*>(p)[i] = raw;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bilinear corners of one grid point (x, y in [-1, 1]) in an H x W image,
// border padding, align_corners=True, exactly as the JAX package's
// `_corner_indices_weights`: the coordinate is clamped before the floor
// (a NaN clamps to 0), x1 = min(x0 + 1, W - 1). idx[k * 2 + j] is the flat
// index of corner (y_k, x_j); wy[k], wx[j] are the separable lerp weights.
struct Corners {
  int idx[4];
  float wy[2], wx[2];
};

__device__ __forceinline__ Corners bilinear_corners(float2 g, int H, int W) {
  float ix = (g.x + 1.f) * 0.5f * (float)(W - 1);
  float iy = (g.y + 1.f) * 0.5f * (float)(H - 1);
  ix = fminf(fmaxf(ix, 0.f), (float)(W - 1));
  iy = fminf(fmaxf(iy, 0.f), (float)(H - 1));
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  const float tx = ix - fx0, ty = iy - fy0;
  const int x0 = (int)fx0, y0 = (int)fy0;
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  Corners c;
  c.idx[0] = y0 * W + x0;
  c.idx[1] = y0 * W + x1;
  c.idx[2] = y1 * W + x0;
  c.idx[3] = y1 * W + x1;
  c.wy[0] = 1.f - ty;
  c.wy[1] = ty;
  c.wx[0] = 1.f - tx;
  c.wx[1] = tx;
  return c;
}

}  // namespace smow
