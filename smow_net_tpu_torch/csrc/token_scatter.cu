// Kernel D: the OFW token chain's warped-softmax scatter, forward.
//
// Replaces `token_scatter_pallas` / `_tok_kernel` in
// smow_net_tpu/ops/pallas/warp.py. For each frame f and token channel l:
//   aw  = S a          bilinear sample of the logits at the flow grid
//                      (border padding, align_corners=True)
//   eaw = exp(aw - m)  m[f, l] = max over pixels of a (computed by the caller)
//   ew  = S^T eaw      scatter back through the same bilinear weights
//   zaw = sum_n eaw
// (ew, zaw) share the per-(frame, l) scale exp(max aw - m): the caller
// divides ew by max(zaw, tiny) (smow_net_tpu/ops/warp.py:217-257 contract).
//
// What bounds it on the card: memory traffic and atomics, not arithmetic.
// At the SMOW_Net shape (32 frames, 128x128, 8 channels) each pixel reads
// four 8-channel logit rows (16 B each in bf16) and issues 32 fp32 atomic
// adds into the 16 MB ew accumulator, which stays resident in the 50 MB L2.
//
// Design: the TPU kernel expressed the gather and the scatter as one-hot
// matmuls because the TPU has no fast gather. Here one thread owns one
// output pixel: it computes its four corners and weights exactly as
// `_corner_indices_weights` does (clamp before floor, x1 = min(x0+1, W-1)),
// gathers each corner's channel row with 16-byte loads, lerps and
// exponentiates in fp32, and scatters w_k * eaw with atomicAdd into an fp32
// accumulator (the wrapper casts to the input dtype). zaw is reduced per
// block with warp shuffles and added with one atomicAdd per block and
// channel. Atomics make the summation order, and so the last bits of ew and
// zaw, vary from run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
token_scatter_fwd_kernel(const T* __restrict__ a, const float* __restrict__ grid,
                         const float* __restrict__ m, float* __restrict__ ew,
                         float* __restrict__ zaw, int H, int W) {
  const int f = blockIdx.y;
  const int P = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float e[C];
#pragma unroll
  for (int c = 0; c < C; ++c) e[c] = 0.f;

  if (p < P) {
    const float2 g = __ldg(reinterpret_cast<const float2*>(grid) + (size_t)f * P + p);
    float ix = (g.x + 1.f) * 0.5f * (float)(W - 1);
    float iy = (g.y + 1.f) * 0.5f * (float)(H - 1);
    ix = fminf(fmaxf(ix, 0.f), (float)(W - 1));
    iy = fminf(fmaxf(iy, 0.f), (float)(H - 1));
    const float fx0 = floorf(ix), fy0 = floorf(iy);
    const float tx = ix - fx0, ty = iy - fy0;
    const int x0 = (int)fx0, y0 = (int)fy0;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const int idx[4] = {y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1};
    const float w[4] = {(1.f - tx) * (1.f - ty), tx * (1.f - ty), (1.f - tx) * ty, tx * ty};

    const T* af = a + (size_t)f * P * C;
    float aw[C];
#pragma unroll
    for (int c = 0; c < C; ++c) aw[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[C];
      smow::load_f32<T, C>(af + (size_t)idx[k] * C, v);
#pragma unroll
      for (int c = 0; c < C; ++c) aw[c] += w[k] * v[c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = expf(aw[c] - __ldg(m + f * C + c));

    float* ef = ew + (size_t)f * P * C;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(ef + (size_t)idx[k] * C + c, w[k] * e[c]);
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

template <typename T, int C>
cudaError_t launch(const void* a, const void* grid, const void* m, void* ew, void* zaw,
                   int frames, int H, int W, cudaStream_t stream) {
  const dim3 blocks((H * W + kThreads - 1) / kThreads, frames);
  token_scatter_fwd_kernel<T, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const float*>(grid),
      static_cast<const float*>(m), static_cast<float*>(ew), static_cast<float*>(zaw), H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_channels(const void* a, const void* grid, const void* m, void* ew,
                              void* zaw, int frames, int H, int W, int C,
                              cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(a, grid, m, ew, zaw, frames, H, W, stream);
    case 16: return launch<T, 16>(a, grid, m, ew, zaw, frames, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// a: (frames, H, W, C) fp32 or bf16 logits; grid: (frames, H, W, 2) fp32;
// m: (frames, C) fp32 shift; ew: (frames, H, W, C) fp32, zeroed;
// zaw: (frames, C) fp32, zeroed. C is 8 or 16.
extern "C" int token_scatter_fwd(const void* a, const void* grid, const void* m, void* ew,
                                 void* zaw, int frames, int H, int W, int C, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_channels<__nv_bfloat16>(a, grid, m, ew, zaw, frames, H, W, C, s)
              : dispatch_channels<float>(a, grid, m, ew, zaw, frames, H, W, C, s);
  return static_cast<int>(err);
}

extern "C" const char* smow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
