// Kernel A-bwd: the VJP of bilinear sampling (the warp op).
//
// Replaces the backward of `grid_sample_pallas`, `_bwd_kernel` in
// smow_net_tpu/ops/pallas/warp.py, which the token chain's split backward
// (`_tok_hyb_bwd`) runs second. The primal op samples an image x at a grid;
// given x and the pixel cotangent gy, for every grid pixel p with corners
// (y_k, x_j) and separable weights (wy_k, wx_j) (border or zeros padding,
// either align_corners; under zeros padding the weights carry the corners'
// validity):
//   dx[y_k, x_j, c] += wy_k wx_j gy[p, c]                     (a scatter)
//   s_kj     = sum_c x[y_k, x_j, c] gy[p, c]
//   dwy_k[p] = sum_j wx_j s_kj,   dwx_j[p] = sum_k wy_k s_kj
// The wrapper carries (dwy0, dwy1, dwx0, dwx1) to dgrid in plain torch.
//
// What bounds it on the card: memory and atomics. Per pixel it reads one gy
// row, four C-channel image rows (L2 hits, mostly) and the grid point,
// writes four fp32 weight gradients and issues 4C fp32 atomic adds into the
// dx accumulator (16 MB at the SMOW_Net shape, resident in L2).
//
// Design: the TPU kernel ran three one-hot MXU matmuls per pixel tile
// around one expanded operand. Here one thread owns one grid pixel, as in
// kernel D: it gathers the four corner rows with 16-byte loads, forms the
// dot products, writes its weight gradients and scatters w * gy into an
// fp32 accumulator with atomicAdd (the wrapper casts it once). A
// border-clamped flow sends many pixels to one corner, so those atomics
// contend, and their order, hence the last bits of dx, varies by run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int C, bool kZeros, bool kAlign>
__global__ void __launch_bounds__(kThreads)
grid_sample_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                       const float* __restrict__ grid, float* __restrict__ dx,
                       float* __restrict__ dw, int H, int W, int P) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const float2 gp = __ldg(reinterpret_cast<const float2*>(grid) + (size_t)b * P + p);
  const smow::Corners cr = smow::bilinear_corners<kZeros, kAlign>(gp, H, W);
  float gv[C];
  smow::load_f32<T, C>(gy + ((size_t)b * P + p) * C, gv);
  const T* xb = x + (size_t)b * H * W * C;
  float* dxb = dx + (size_t)b * H * W * C;
  float s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v[C];
    smow::load_f32<T, C>(xb + (size_t)cr.idx[k] * C, v);
    const float w = cr.wy[k / 2] * cr.wx[k % 2];
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dot += v[c] * gv[c];
      atomicAdd(dxb + (size_t)cr.idx[k] * C + c, w * gv[c]);
    }
    s[k] = dot;
  }
  float* dwb = dw + (size_t)b * 4 * P + p;
  dwb[0] = cr.wx[0] * s[0] + cr.wx[1] * s[1];   // dwy0
  dwb[P] = cr.wx[0] * s[2] + cr.wx[1] * s[3];   // dwy1
  dwb[2 * P] = cr.wy[0] * s[0] + cr.wy[1] * s[2];  // dwx0
  dwb[3 * P] = cr.wy[0] * s[1] + cr.wy[1] * s[3];  // dwx1
}

}  // namespace

// x: (B, H, W, C) primal image; gy: (B, Hg, Wg, C) pixel cotangent, the
// same dtype (fp32 or bf16); grid: (B, Hg, Wg, 2) fp32. Accumulates into
// dx: (B, H, W, C) fp32, zeroed, and writes dw: (B, 4, Hg, Wg) fp32 rows
// (dwy0, dwy1, dwx0, dwx1). C is 8, 16 or 32; zeros: zeros padding (else
// border); align: align_corners.
extern "C" int grid_sample_bwd(const void* x, const void* gy, const void* grid, void* dx,
                               void* dw, int B, int H, int W, int Hg, int Wg, int C,
                               int is_bf16, int zeros, int align, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hg <= 0 || Wg <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = Hg * Wg;
  const dim3 blocks((P + kThreads - 1) / kThreads, B);
  return static_cast<int>(smow::dispatch_warp(C, is_bf16, zeros, align,
                                              [&](auto t, auto c, auto z, auto al) {
    using T = typename decltype(t)::type;
    grid_sample_bwd_kernel<T, decltype(c)::value, decltype(z)::value, decltype(al)::value>
        <<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(gy),
                                     static_cast<const float*>(grid), static_cast<float*>(dx),
                                     static_cast<float*>(dw), H, W, P);
    return cudaGetLastError();
  }));
}
