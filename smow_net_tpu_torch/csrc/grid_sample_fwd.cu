// Kernel A-fwd: bilinear sampling (the warp op), forward.
//
// Replaces `grid_sample_pallas` / `_kernel` in smow_net_tpu/ops/pallas/warp.py,
// which SMOW_Net_LW's train-time token chain runs first (`flow_warp` of the
// attention logits). For every grid pixel p with corners (y_k, x_j) and
// separable weights (wy_k, wx_j) (border or zeros padding, either
// align_corners, as common.cuh `bilinear_corners` computes them):
//   out[p, c] = sum_{k,j} wy_k wx_j x[y_k, x_j, c]
// in fp32, rounded once to x's dtype. C is 8, 16 or 32 (OFW's features),
// or 64 (PA-Former's PriorInterpreter: zeros padding, align_corners=False).
//
// What bounds it on the card: memory. Per pixel it reads the grid point and
// four C-channel image rows (gathers that mostly hit L2: neighbouring pixels
// share corners) and writes one row; the arithmetic is 4C FMAs per pixel.
//
// Design: the TPU kernel folded the vertical lerp into a one-hot MXU matmul
// and the horizontal one into a masked lane reduction, because the TPU has
// no fast gather. Here one thread owns one grid pixel: it computes its
// corners exactly as the other warp kernels do (common.cuh), gathers the
// four corner rows with 16-byte loads, lerps in fp32 and stores its row. No
// atomics, so the result is the same on every run. At C = 64 a pixel's row
// is split over four threads of 16 channels each (kChunk), which keeps a
// thread's registers at the C = 16 kernel's and makes a pixel's four
// threads read its corner rows as 64 contiguous bytes (fp32) each.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;   // channels a thread takes at C > 32

// Threads per grid pixel: one up to C = 32, C / kChunk above.
template <int C> constexpr int threads_per_pixel() { return C > 32 ? C / kChunk : 1; }

template <typename T, int C, bool kZeros, bool kAlign>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const T* __restrict__ x, const float* __restrict__ grid,
                       T* __restrict__ out, int H, int W, int P) {
  const int b = blockIdx.y;
  if constexpr (C > 32) {
    constexpr int kSplit = C / kChunk;
    const int t = blockIdx.x * kThreads + threadIdx.x;
    const int p = t / kSplit, c0 = t % kSplit * kChunk;
    if (p >= P) return;
    const float2 gp = __ldg(reinterpret_cast<const float2*>(grid) + (size_t)b * P + p);
    const smow::Corners cr = smow::bilinear_corners<kZeros, kAlign>(gp, H, W);
    const T* xb = x + (size_t)b * H * W * C + c0;
    float v[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) v[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float r[kChunk];
      smow::load_f32<T, kChunk>(xb + (size_t)cr.idx[k] * C, r);
      const float w = cr.wy[k / 2] * cr.wx[k % 2];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) v[c] += w * r[c];
    }
    smow::store_from_f32<T, kChunk>(out + ((size_t)b * P + p) * C + c0, v);
  } else {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= P) return;
    const float2 gp = __ldg(reinterpret_cast<const float2*>(grid) + (size_t)b * P + p);
    const smow::Corners cr = smow::bilinear_corners<kZeros, kAlign>(gp, H, W);
    float v[C];
    smow::gather_lerp<T, C>(x + (size_t)b * H * W * C, cr, v);
    smow::store_from_f32<T, C>(out + ((size_t)b * P + p) * C, v);
  }
}

}  // namespace

// x: (B, H, W, C) fp32 or bf16 image; grid: (B, Hg, Wg, 2) fp32. Writes
// out: (B, Hg, Wg, C) in x's dtype. C is 8, 16, 32 or 64; zeros: zeros
// padding (else border); align: align_corners.
extern "C" int grid_sample_fwd(const void* x, const void* grid, void* out, int B, int H, int W,
                               int Hg, int Wg, int C, int is_bf16, int zeros, int align,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hg <= 0 || Wg <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = Hg * Wg;
  return static_cast<int>(smow::dispatch_warp<true>(C, is_bf16, zeros, align,
                                                    [&](auto t, auto c, auto z, auto al) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    const long long threads = (long long)P * threads_per_pixel<kC>();
    const dim3 blocks((unsigned)((threads + kThreads - 1) / kThreads), B);
    grid_sample_fwd_kernel<T, kC, decltype(z)::value, decltype(al)::value>
        <<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const float*>(grid),
                                     static_cast<T*>(out), H, W, P);
    return cudaGetLastError();
  }));
}
