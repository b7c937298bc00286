// Kernel B: the adjoint of bilinear sampling as a primal op (the transpose
// warp), forward.
//
// Replaces `grid_sample_transpose_pallas` / `_t_kernel` in
// smow_net_tpu/ops/pallas/warp.py, which SMOW_Net_LW's train-time token
// chain runs last (`flow_warp_transpose` of the exponentiated logits). It
// scatters a pixel tensor g through the bilinear weights of a grid into an
// (H, W) image: for every grid pixel p with corners (y_k, x_j) and separable
// weights (wy_k, wx_j) (border or zeros padding, either align_corners)
//   out[y_k, x_j, c] += wy_k wx_j g[p, c]
// accumulated in fp32; the wrapper casts the sum once to g's dtype. C is 8,
// 16 or 32.
//
// What bounds it on the card: atomics and memory. Per pixel it reads the
// grid point and one g row and issues 4C fp32 atomic adds into the
// accumulator (8 MB at SMOW_Net_LW's shape, resident in the 50 MB L2).
//
// Design: the TPU kernel formed (lerp-weighted g) @ (vertical one-hot)^T on
// the MXU and carried the image across its sequential grid in VMEM. Blocks
// on the card run in no order, so one thread owns one grid pixel and adds
// its four weighted rows with atomicAdd into an fp32 image, the scatter half
// of kernel D (common.cuh `scatter_lerp`). The atomics' order, hence the
// last bits of the sum, varies from run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int C, bool kZeros, bool kAlign>
__global__ void __launch_bounds__(kThreads)
grid_sample_transpose_kernel(const T* __restrict__ g, const float* __restrict__ grid,
                             float* __restrict__ out, int H, int W, int P) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const float2 gp = __ldg(reinterpret_cast<const float2*>(grid) + (size_t)b * P + p);
  const smow::Corners cr = smow::bilinear_corners<kZeros, kAlign>(gp, H, W);
  float v[C];
  smow::load_f32<T, C>(g + ((size_t)b * P + p) * C, v);
  smow::scatter_lerp<C>(out + (size_t)b * H * W * C, cr, v);
}

}  // namespace

// g: (B, Hg, Wg, C) fp32 or bf16; grid: (B, Hg, Wg, 2) fp32. Accumulates
// into out: (B, H, W, C) fp32, zeroed. C is 8, 16 or 32; zeros: zeros
// padding (else border); align: align_corners.
extern "C" int grid_sample_transpose(const void* g, const void* grid, void* out, int B, int H,
                                     int W, int Hg, int Wg, int C, int is_bf16, int zeros,
                                     int align, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hg <= 0 || Wg <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = Hg * Wg;
  const dim3 blocks((P + kThreads - 1) / kThreads, B);
  return static_cast<int>(smow::dispatch_warp(C, is_bf16, zeros, align,
                                              [&](auto t, auto c, auto z, auto al) {
    using T = typename decltype(t)::type;
    grid_sample_transpose_kernel<T, decltype(c)::value, decltype(z)::value, decltype(al)::value>
        <<<blocks, kThreads, 0, s>>>(static_cast<const T*>(g), static_cast<const float*>(grid),
                                     static_cast<float*>(out), H, W, P);
    return cudaGetLastError();
  }));
}
