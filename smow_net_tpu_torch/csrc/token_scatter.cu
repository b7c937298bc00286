// Kernels D and E: the OFW token chain's warped-softmax scatter, forward.
//
// D replaces `token_scatter_pallas` / `_tok_kernel` and E replaces
// `token_scatter_hybrid_pallas` / `_tok_kernel_hyb` in
// smow_net_tpu/ops/pallas/warp.py. For each frame f and token channel l:
//   aw  = S a          bilinear sample of the logits at the flow grid
//                      (border padding, align_corners=True)
//   eaw = exp(aw - m)  m[f, l] = max over pixels of a (computed by the caller)
//   ew  = S^T eaw      scatter back through the same bilinear weights
//   zaw = sum_n eaw
// (ew, zaw) share the per-(frame, l) scale exp(max aw - m): the caller
// divides ew by max(zaw, tiny) (smow_net_tpu/ops/warp.py:217-257 contract).
// E is D that also writes eaw in the input dtype, the residual the split
// backward (kernels C and A-bwd) reads; D is the inference entry.
//
// What bounds it on the card: memory traffic and atomics, not arithmetic.
// At the SMOW_Net shape (32 frames, 128x128, 8 channels) each pixel reads
// four 8-channel logit rows (16 B each in bf16) and issues 32 fp32 atomic
// adds into the 16 MB ew accumulator, which stays resident in the 50 MB L2.
// E adds one 16-byte store per pixel in bf16.
//
// Design: the TPU kernel expressed the gather and the scatter as one-hot
// matmuls because the TPU has no fast gather. Here one thread owns one
// output pixel: it computes its four corners and weights exactly as
// `_corner_indices_weights` does (common.cuh `bilinear_corners`), gathers
// each corner's channel row with 16-byte loads, lerps and exponentiates in
// fp32, and scatters w_k * eaw with atomicAdd into an fp32 accumulator (the
// wrapper casts to the input dtype). zaw is reduced per block with warp
// shuffles and added with one atomicAdd per block and channel. Atomics make
// the summation order, and so the last bits of ew and zaw, vary from run to
// run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int C, bool kResidual>
__global__ void __launch_bounds__(kThreads)
token_scatter_fwd_kernel(const T* __restrict__ a, const float* __restrict__ grid,
                         const float* __restrict__ m, float* __restrict__ ew,
                         float* __restrict__ zaw, T* __restrict__ eaw, int H, int W) {
  const int f = blockIdx.y;
  const int P = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float e[C];
#pragma unroll
  for (int c = 0; c < C; ++c) e[c] = 0.f;

  if (p < P) {
    const float2 g = __ldg(reinterpret_cast<const float2*>(grid) + (size_t)f * P + p);
    const smow::Corners cr = smow::bilinear_corners(g, H, W);
    const T* af = a + (size_t)f * P * C;
    float aw[C];
#pragma unroll
    for (int c = 0; c < C; ++c) aw[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[C];
      smow::load_f32<T, C>(af + (size_t)cr.idx[k] * C, v);
      const float w = cr.wy[k / 2] * cr.wx[k % 2];
#pragma unroll
      for (int c = 0; c < C; ++c) aw[c] += w * v[c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = expf(aw[c] - __ldg(m + f * C + c));
    if (kResidual) smow::store_from_f32<T, C>(eaw + ((size_t)f * P + p) * C, e);

    float* ef = ew + (size_t)f * P * C;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = cr.wy[k / 2] * cr.wx[k % 2];
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(ef + (size_t)cr.idx[k] * C + c, w * e[c]);
    }
  }

  __shared__ float part[kThreads / 32][C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float s = smow::warp_sum(e[c]);
    if (lane == 0) part[warp][c] = s;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += part[i][threadIdx.x];
    atomicAdd(zaw + f * C + threadIdx.x, s);
  }
}

template <typename T, int C, bool kResidual>
cudaError_t launch(const void* a, const void* grid, const void* m, void* ew, void* zaw,
                   void* eaw, int frames, int H, int W, cudaStream_t stream) {
  const dim3 blocks((H * W + kThreads - 1) / kThreads, frames);
  token_scatter_fwd_kernel<T, C, kResidual><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const float*>(grid),
      static_cast<const float*>(m), static_cast<float*>(ew), static_cast<float*>(zaw),
      static_cast<T*>(eaw), H, W);
  return cudaGetLastError();
}

template <bool kResidual>
cudaError_t dispatch(const void* a, const void* grid, const void* m, void* ew, void* zaw,
                     void* eaw, int frames, int H, int W, int C, int is_bf16,
                     cudaStream_t s) {
  if (frames <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  if (C == 8)
    return is_bf16 ? launch<__nv_bfloat16, 8, kResidual>(a, grid, m, ew, zaw, eaw, frames, H, W, s)
                   : launch<float, 8, kResidual>(a, grid, m, ew, zaw, eaw, frames, H, W, s);
  if (C == 16)
    return is_bf16 ? launch<__nv_bfloat16, 16, kResidual>(a, grid, m, ew, zaw, eaw, frames, H, W, s)
                   : launch<float, 16, kResidual>(a, grid, m, ew, zaw, eaw, frames, H, W, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// a: (frames, H, W, C) fp32 or bf16 logits; grid: (frames, H, W, 2) fp32;
// m: (frames, C) fp32 shift; ew: (frames, H, W, C) fp32, zeroed;
// zaw: (frames, C) fp32, zeroed. C is 8 or 16.
extern "C" int token_scatter_fwd(const void* a, const void* grid, const void* m, void* ew,
                                 void* zaw, int frames, int H, int W, int C, int is_bf16,
                                 void* stream) {
  return static_cast<int>(dispatch<false>(a, grid, m, ew, zaw, nullptr, frames, H, W, C,
                                          is_bf16, static_cast<cudaStream_t>(stream)));
}

// Kernel E: as token_scatter_fwd, and eaw: (frames, H, W, C) in a's dtype
// receives exp(S a - m).
extern "C" int token_scatter_fwd_eaw(const void* a, const void* grid, const void* m,
                                     void* ew, void* zaw, void* eaw, int frames, int H,
                                     int W, int C, int is_bf16, void* stream) {
  return static_cast<int>(dispatch<true>(a, grid, m, ew, zaw, eaw, frames, H, W, C, is_bf16,
                                         static_cast<cudaStream_t>(stream)));
}

extern "C" const char* smow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
