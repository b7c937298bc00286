// Small helpers shared by the kernels in this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bilinear corners of one grid point (x, y in [-1, 1]) in an H x W image,
// exactly as the JAX package's `_corner_indices_weights`. The coordinate is
// unnormalised as (g + 1) (size - 1) / 2 with kAlign (align_corners=True)
// and as ((g + 1) size - 1) / 2 without (each step rounded on its own, as
// the plain version rounds it: no contraction into an FMA). Border padding
// (kZeros false) clamps it to [0, size - 1] before the floor and takes x1 =
// min(x0 + 1, W - 1); zeros padding multiplies each per-axis weight by its
// corner's validity and clamps the indices into the image. A NaN coordinate
// keeps NaN lerp weights in both modes (fmaxf and fminf would drop it, so
// the clamps see only a number) and floors to index 0, as XLA's float -> int
// conversion and the plain version's nan_to_num give it: corners (0, 0),
// (0, 1), (1, 0) and (1, 1). idx[k * 2 + j] is the flat index of corner
// (y_k, x_j); wy[k], wx[j] are the separable lerp weights.
struct Corners {
  int idx[4];
  float wy[2], wx[2];
};

template <bool kAlign>
__device__ __forceinline__ float unnormalize(float g, int size) {
  if (kAlign) return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f), (float)(size - 1));
  return __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(g, 1.f), (float)size), -1.f), 0.5f);
}

template <bool kZeros = false, bool kAlign = true>
__device__ __forceinline__ Corners bilinear_corners(float2 g, int H, int W) {
  float ix = unnormalize<kAlign>(g.x, W);
  float iy = unnormalize<kAlign>(g.y, H);
  if (!kZeros) {
    ix = isnan(ix) ? ix : fminf(fmaxf(ix, 0.f), (float)(W - 1));
    iy = isnan(iy) ? iy : fminf(fmaxf(iy, 0.f), (float)(H - 1));
  }
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  const float tx = ix - fx0, ty = iy - fy0;
  Corners c;
  c.wy[0] = 1.f - ty;
  c.wy[1] = ty;
  c.wx[0] = 1.f - tx;
  c.wx[1] = tx;
  int x0, y0, x1, y1;
  if (kZeros) {
    c.wx[0] *= (float)(fx0 >= 0.f && fx0 < (float)W);
    c.wx[1] *= (float)(fx0 + 1.f >= 0.f && fx0 + 1.f < (float)W);
    c.wy[0] *= (float)(fy0 >= 0.f && fy0 < (float)H);
    c.wy[1] *= (float)(fy0 + 1.f >= 0.f && fy0 + 1.f < (float)H);
    // -1 .. size before the clamp, so a far coordinate stays in range
    const int xl = isnan(fx0) ? 0 : (int)fminf(fmaxf(fx0, -1.f), (float)W);
    const int yl = isnan(fy0) ? 0 : (int)fminf(fmaxf(fy0, -1.f), (float)H);
    x0 = min(max(xl, 0), W - 1);
    y0 = min(max(yl, 0), H - 1);
    x1 = min(max(xl + 1, 0), W - 1);
    y1 = min(max(yl + 1, 0), H - 1);
  } else {
    x0 = isnan(fx0) ? 0 : (int)fx0;
    y0 = isnan(fy0) ? 0 : (int)fy0;
    x1 = min(x0 + 1, W - 1);
    y1 = min(y0 + 1, H - 1);
  }
  c.idx[0] = y0 * W + x0;
  c.idx[1] = y0 * W + x1;
  c.idx[2] = y1 * W + x0;
  c.idx[3] = y1 * W + x1;
  return c;
}

// The warp kernels' instantiations: f(TypeTag<T>, IntTag<C>, BoolTag<zeros>,
// BoolTag<align>) for the element type (fp32 or bf16), C in {8, 16, 32} and
// the four (padding, align_corners) pairs; any other C is refused.
template <typename T> struct TypeTag { using type = T; };
template <int V> using IntTag = std::integral_constant<int, V>;
template <bool V> using BoolTag = std::integral_constant<bool, V>;

template <typename F>
cudaError_t dispatch_warp(int C, int is_bf16, int zeros, int align, F&& f) {
  auto modes = [&](auto t, auto c) -> cudaError_t {
    if (zeros) return align ? f(t, c, BoolTag<true>{}, BoolTag<true>{})
                            : f(t, c, BoolTag<true>{}, BoolTag<false>{});
    return align ? f(t, c, BoolTag<false>{}, BoolTag<true>{})
                 : f(t, c, BoolTag<false>{}, BoolTag<false>{});
  };
  auto widths = [&](auto t) -> cudaError_t {
    if (C == 8) return modes(t, IntTag<8>{});
    if (C == 16) return modes(t, IntTag<16>{});
    if (C == 32) return modes(t, IntTag<32>{});
    return cudaErrorInvalidValue;
  };
  return is_bf16 ? widths(TypeTag<__nv_bfloat16>{}) : widths(TypeTag<float>{});
}

// The bilinear sample of the C-channel image `img` at the corners `cr`:
// out[c] = sum_k w_k img[idx_k, c] in fp32, corners in the order of `idx`.
template <typename T, int C>
__device__ __forceinline__ void gather_lerp(const T* __restrict__ img, const Corners& cr,
                                            float (&out)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v[C];
    load_f32<T, C>(img + (size_t)cr.idx[k] * C, v);
    const float w = cr.wy[k / 2] * cr.wx[k % 2];
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] += w * v[c];
  }
}

}  // namespace smow
