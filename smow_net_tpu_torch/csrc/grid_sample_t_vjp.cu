// Kernel C: the VJP of the bilinear scatter (transpose warp) op.
//
// Replaces `grid_sample_transpose_vjp_pallas` / `_t_vjp_kernel` in
// smow_net_tpu/ops/pallas/warp.py, which the token chain's split backward
// (`_tok_hyb_bwd`) runs first. The primal op scatters a pixel tensor g
// through the bilinear weights of a grid into an image; given the image-side
// cotangent xbar and the primal g, for every grid pixel p with corners
// (y_k, x_j) and separable weights (wy_k, wx_j) (border or zeros padding,
// either align_corners; under zeros padding the weights carry the corners'
// validity, so the rows are the gradients of the masked weights):
//   dg[p, c] = sum_{k,j} wy_k wx_j xbar[y_k, x_j, c]          (a gather)
//   s_kj     = sum_c xbar[y_k, x_j, c] g[p, c]
//   dwy_k[p] = sum_j wx_j s_kj,   dwx_j[p] = sum_k wy_k s_kj
// The wrapper carries (dwy0, dwy1, dwx0, dwx1) to dgrid in plain torch, as
// the JAX package leaves `jax.vjp(_corner_indices_weights)` to XLA.
//
// What bounds it on the card: memory. Per pixel it reads four C-channel
// cotangent rows (gathers that mostly hit L2: neighbouring pixels share
// corners), one g row and the grid point, and writes one dg row and four
// fp32 weight gradients; the arithmetic is ~6C FMAs per pixel.
//
// Design: the TPU kernel built one-hot matrices and ran two MXU matmuls
// because the TPU has no fast gather. Here one thread owns one grid pixel,
// computes its corners exactly as kernel D does (common.cuh), gathers the
// four corner rows with 16-byte loads, and writes dg and its four weight
// gradients; no atomics, so the result is the same on every run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int C, bool kZeros, bool kAlign>
__global__ void __launch_bounds__(kThreads)
grid_sample_t_vjp_kernel(const T* __restrict__ xbar, const T* __restrict__ g,
                         const float* __restrict__ grid, T* __restrict__ dg,
                         float* __restrict__ dw, int H, int W, int P) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const float2 gp = __ldg(reinterpret_cast<const float2*>(grid) + (size_t)b * P + p);
  const smow::Corners cr = smow::bilinear_corners<kZeros, kAlign>(gp, H, W);
  float gv[C];
  smow::load_f32<T, C>(g + ((size_t)b * P + p) * C, gv);
  const T* xb = xbar + (size_t)b * H * W * C;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v[C];
    smow::load_f32<T, C>(xb + (size_t)cr.idx[k] * C, v);
    const float w = cr.wy[k / 2] * cr.wx[k % 2];
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] += w * v[c];
      dot += v[c] * gv[c];
    }
    s[k] = dot;
  }
  smow::store_from_f32<T, C>(dg + ((size_t)b * P + p) * C, acc);
  float* dwb = dw + (size_t)b * 4 * P + p;
  dwb[0] = cr.wx[0] * s[0] + cr.wx[1] * s[1];   // dwy0
  dwb[P] = cr.wx[0] * s[2] + cr.wx[1] * s[3];   // dwy1
  dwb[2 * P] = cr.wy[0] * s[0] + cr.wy[1] * s[2];  // dwx0
  dwb[3 * P] = cr.wy[0] * s[1] + cr.wy[1] * s[3];  // dwx1
}

}  // namespace

// xbar: (B, H, W, C) image-side cotangent; g: (B, Hg, Wg, C) primal pixel
// tensor, the same dtype (fp32 or bf16); grid: (B, Hg, Wg, 2) fp32.
// Writes dg: (B, Hg, Wg, C) in g's dtype and dw: (B, 4, Hg, Wg) fp32 rows
// (dwy0, dwy1, dwx0, dwx1). C is 8, 16 or 32; zeros: zeros padding (else
// border); align: align_corners.
extern "C" int grid_sample_t_vjp(const void* xbar, const void* g, const void* grid, void* dg,
                                 void* dw, int B, int H, int W, int Hg, int Wg, int C,
                                 int is_bf16, int zeros, int align, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hg <= 0 || Wg <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = Hg * Wg;
  const dim3 blocks((P + kThreads - 1) / kThreads, B);
  return static_cast<int>(smow::dispatch_warp(C, is_bf16, zeros, align,
                                              [&](auto t, auto c, auto z, auto al) {
    using T = typename decltype(t)::type;
    grid_sample_t_vjp_kernel<T, decltype(c)::value, decltype(z)::value, decltype(al)::value>
        <<<blocks, kThreads, 0, s>>>(static_cast<const T*>(xbar), static_cast<const T*>(g),
                                     static_cast<const float*>(grid), static_cast<T*>(dg),
                                     static_cast<float*>(dw), H, W, P);
    return cudaGetLastError();
  }));
}
