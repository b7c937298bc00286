// Kernels D, E and D-bwd: the OFW token chain's warped-softmax scatter,
// forward and its whole VJP.
//
// D replaces `token_scatter_pallas` / `_tok_kernel`, E replaces
// `token_scatter_hybrid_pallas` / `_tok_kernel_hyb` and D-bwd replaces
// `_tok_bwd` / `_tok_bwd_kernel` (the fused lowering's backward) in
// smow_net_tpu/ops/pallas/warp.py. For each frame f and token channel l:
//   aw  = S a          bilinear sample of the logits at the flow grid
//                      (border padding, align_corners=True)
//   eaw = exp(aw - m)  m[f, l] = max over pixels of a (computed by the caller)
//   ew  = S^T eaw      scatter back through the same bilinear weights
//   zaw = sum_n eaw
// (ew, zaw) share the per-(frame, l) scale exp(max aw - m): the caller
// divides ew by max(zaw, tiny) (smow_net_tpu/ops/warp.py:217-257 contract).
// E is D that also writes eaw in the input dtype, the residual the split
// backward (kernels C and A-bwd) reads; D is the inference entry and the
// fused chain's forward.
//
// D-bwd takes the cotangents (ew_bar, dzaw) and saves nothing from the
// forward but (a, grid, m): per grid pixel it recomputes aw and eaw, and
//   dg  = S ew_bar,  daw = (dg + dzaw) eaw,  da = S^T daw   (a scatter)
//   s_kj = sum_c daw_c a[y_k, x_j, c] + sum_c eaw_c ew_bar[y_k, x_j, c]
//   dwy_k = sum_j wx_j s_kj,  dwx_j = sum_k wy_k s_kj
// the weight-gradient rows of both gathers summed (they share the grid);
// the wrapper carries them to dgrid.
//
// What bounds it on the card: bytes, once the atomics are few. At the
// SMOW_Net shape (32 frames, 128x128, 8 channels) each pixel reads four
// 8-channel logit rows (16 B each in bf16, mostly from L1 and L2: a flow
// of a few pixels reuses its neighbours' rows) and adds four weighted rows
// into the 16 MB fp32 ew accumulator; E adds one 16-byte store per pixel in
// bf16. D-bwd reads eight corner rows (four of a, four of ew_bar), scatters
// into da and writes four fp32 weight gradients.
//
// Design: the TPU kernel expressed the gather and the scatter as one-hot
// matmuls because the TPU has no fast gather. All three kernels are kernel
// A-fwd's gather followed by kernel B's scatter (tile_scatter.cuh): a block
// of kScatterThreads takes a ScatterTile<C> tile of grid pixels; for each of
// its slots a thread computes the four corners and weights exactly as
// `_corner_indices_weights` does (common.cuh `bilinear_corners`), gathers
// each corner's channel row with 16-byte loads, lerps and exponentiates in
// fp32, in E stores eaw with 16-byte vectors, and stages the row to scatter
// (D, E: eaw; D-bwd: daw) and notes the corners in shared memory.
// `scatter_tile` then sorts the tile's corners by the cells of its bounding
// box, sums each cell's weighted rows in registers and adds each sum to the
// accumulator (ew, da) with one 16-byte vector reduction per four channels,
// or, where the box is too wide (a far-scattered or NaN grid), adds the
// corner rows straight to it as vector reductions. With one thread per
// pixel issuing 4C scalar fp32 atomics (the design this one replaced) the
// L2's atomic unit was the limit: 0.24 ms at (32, 128, 128, 8), 3-5% of the
// byte bound (PERF.md). zaw is summed over a thread's slots, then over the
// block with warp shuffles, and added with one atomicAdd per block and
// channel; an empty slot adds nothing. D-bwd gathers the a and ew_bar rows
// twice: once for aw and dg, and again, from L1, for the weight-gradient
// dots once daw is known (keeping the eight rows would take 8C registers);
// consecutive slots are consecutive pixels of a tile row, so its four dw
// rows are stored coalesced. Atomics make the summation order, and so the
// last bits of ew, zaw and da, vary from run to run.

#include "tile_scatter.cuh"

namespace {

// D and E: one ScatterTile<C> tile of frame blockIdx.y's grid pixels a block.
template <typename T, int C, bool kResidual>
__global__ void __launch_bounds__(smow::kScatterThreads)
token_scatter_fwd_kernel(const T* __restrict__ a, const float* __restrict__ grid,
                         const float* __restrict__ m, float* __restrict__ ew,
                         float* __restrict__ zaw, T* __restrict__ eaw, int H, int W) {
  constexpr int kWarps = smow::kScatterThreads / 32;
  __shared__ smow::ScatterSmem<C> sm;
  __shared__ float part[kWarps][C];
  const int f = blockIdx.y;
  const int P = H * W;
  const smow::TileGeom<C> tg(blockIdx.x, H, W);
  const float2* gridf = reinterpret_cast<const float2*>(grid) + (size_t)f * P;
  const T* af = a + (size_t)f * P * C;
  float z[C];                   // the thread's share of zaw
#pragma unroll
  for (int c = 0; c < C; ++c) z[c] = 0.f;
  smow::Box box;
#pragma unroll
  for (int i = 0; i < smow::ScatterSmem<C>::kSlots; ++i) {
    const int slot = i * smow::kScatterThreads + threadIdx.x;
    const int p = tg.pixel(slot, W);
    if (p < 0) {
      smow::note_empty(sm, slot);
      continue;
    }
    const smow::Corners cr = smow::bilinear_corners(__ldg(gridf + p), H, W);
    float e[C];
    smow::gather_lerp<T, C>(af, cr, e);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      e[c] = expf(e[c] - __ldg(m + f * C + c));
      z[c] += e[c];
    }
    if (kResidual) smow::store_from_f32<T, C>(eaw + ((size_t)f * P + p) * C, e);
    smow::stage_row(sm, slot, e);
    smow::note_corners(sm, slot, cr, W, box);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float s = smow::warp_sum(z[c]);
    if (lane == 0) part[warp][c] = s;
  }
  // its first barrier also publishes the warps' parts of zaw
  smow::scatter_tile(sm, box, ew + (size_t)f * P * C, W);
  if (threadIdx.x < C) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += part[k][threadIdx.x];
    atomicAdd(zaw + f * C + threadIdx.x, s);
  }
}

// D-bwd: one ScatterTile<C> tile of frame blockIdx.y's grid pixels a block.
template <typename T, int C>
__global__ void __launch_bounds__(smow::kScatterThreads)
token_scatter_bwd_kernel(const T* __restrict__ a, const float* __restrict__ grid,
                         const float* __restrict__ m, const float* __restrict__ dz,
                         const T* __restrict__ ew_bar, float* __restrict__ da,
                         float* __restrict__ dw, int H, int W) {
  __shared__ smow::ScatterSmem<C> sm;
  const int f = blockIdx.y;
  const int P = H * W;
  const smow::TileGeom<C> tg(blockIdx.x, H, W);
  const float2* gridf = reinterpret_cast<const float2*>(grid) + (size_t)f * P;
  const T* af = a + (size_t)f * P * C;
  const T* ef = ew_bar + (size_t)f * P * C;
  float* dwf = dw + (size_t)f * 4 * P;
  smow::Box box;
#pragma unroll 1
  for (int i = 0; i < smow::ScatterSmem<C>::kSlots; ++i) {
    const int slot = i * smow::kScatterThreads + threadIdx.x;
    const int p = tg.pixel(slot, W);
    if (p < 0) {
      smow::note_empty(sm, slot);
      continue;
    }
    const smow::Corners cr = smow::bilinear_corners(__ldg(gridf + p), H, W);
    float eaw[C], daw[C];
    smow::gather_lerp<T, C>(af, cr, eaw);   // aw
    smow::gather_lerp<T, C>(ef, cr, daw);   // dg
#pragma unroll
    for (int c = 0; c < C; ++c) {
      eaw[c] = expf(eaw[c] - __ldg(m + f * C + c));
      daw[c] = (daw[c] + __ldg(dz + f * C + c)) * eaw[c];
    }
    float s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float va[C], ve[C];
      smow::load_f32<T, C>(af + (size_t)cr.idx[k] * C, va);
      smow::load_f32<T, C>(ef + (size_t)cr.idx[k] * C, ve);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) dot += daw[c] * va[c] + eaw[c] * ve[c];
      s[k] = dot;
    }
    dwf[p] = cr.wx[0] * s[0] + cr.wx[1] * s[1];           // dwy0
    dwf[P + p] = cr.wx[0] * s[2] + cr.wx[1] * s[3];       // dwy1
    dwf[2 * P + p] = cr.wy[0] * s[0] + cr.wy[1] * s[2];   // dwx0
    dwf[3 * P + p] = cr.wy[0] * s[1] + cr.wy[1] * s[3];   // dwx1
    smow::stage_row(sm, slot, daw);
    smow::note_corners(sm, slot, cr, W, box);
  }
  smow::scatter_tile(sm, box, da + (size_t)f * P * C, W);
}

// f(TypeTag<T>, IntTag<C>) for fp32 or bf16 logits and C in {8, 16}, on
// a (frames, H, W) grid the tile scatter's noted corners can index
template <typename F>
cudaError_t dispatch(int frames, int H, int W, int C, int is_bf16, F&& f) {
  if (frames <= 0 || H <= 0 || W <= 0 || H > smow::kCoordBits || W > smow::kCoordBits)
    return cudaErrorInvalidValue;
  auto widths = [&](auto t) -> cudaError_t {
    if (C == 8) return f(t, smow::IntTag<8>{});
    if (C == 16) return f(t, smow::IntTag<16>{});
    return cudaErrorInvalidValue;
  };
  return is_bf16 ? widths(smow::TypeTag<__nv_bfloat16>{}) : widths(smow::TypeTag<float>{});
}

// D (kResidual false) and E: one ScatterTile<C> tile of grid pixels a block
template <bool kResidual>
cudaError_t launch_fwd(const void* a, const void* grid, const void* m, void* ew, void* zaw,
                       void* eaw, int frames, int H, int W, int C, int is_bf16,
                       cudaStream_t stream) {
  return dispatch(frames, H, W, C, is_bf16, [&](auto t, auto c) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    const dim3 blocks(smow::TileGeom<kC>::count(H, W), frames);
    token_scatter_fwd_kernel<T, kC, kResidual><<<blocks, smow::kScatterThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const float*>(grid),
        static_cast<const float*>(m), static_cast<float*>(ew), static_cast<float*>(zaw),
        static_cast<T*>(eaw), H, W);
    return cudaGetLastError();
  });
}

}  // namespace

// a: (frames, H, W, C) fp32 or bf16 logits; grid: (frames, H, W, 2) fp32;
// m: (frames, C) fp32 shift; ew: (frames, H, W, C) fp32, zeroed;
// zaw: (frames, C) fp32, zeroed. C is 8 or 16.
extern "C" int token_scatter_fwd(const void* a, const void* grid, const void* m, void* ew,
                                 void* zaw, int frames, int H, int W, int C, int is_bf16,
                                 void* stream) {
  return static_cast<int>(launch_fwd<false>(a, grid, m, ew, zaw, nullptr, frames, H, W, C,
                                            is_bf16, static_cast<cudaStream_t>(stream)));
}

// Kernel E: as token_scatter_fwd, and eaw: (frames, H, W, C) in a's dtype
// receives exp(S a - m).
extern "C" int token_scatter_fwd_eaw(const void* a, const void* grid, const void* m,
                                     void* ew, void* zaw, void* eaw, int frames, int H,
                                     int W, int C, int is_bf16, void* stream) {
  return static_cast<int>(launch_fwd<true>(a, grid, m, ew, zaw, eaw, frames, H, W, C, is_bf16,
                                           static_cast<cudaStream_t>(stream)));
}

// Kernel D-bwd: a (frames, H, W, C) fp32 or bf16 logits, grid, m as above;
// dz: (frames, C) fp32, the cotangent of zaw; ew_bar: (frames, H, W, C) in
// a's dtype, the cotangent of ew. Accumulates into da: (frames, H, W, C)
// fp32, zeroed, and writes dw: (frames, 4, H, W) fp32 rows (dwy0, dwy1,
// dwx0, dwx1). C is 8 or 16.
extern "C" int token_scatter_bwd(const void* a, const void* grid, const void* m,
                                 const void* dz, const void* ew_bar, void* da, void* dw,
                                 int frames, int H, int W, int C, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(frames, H, W, C, is_bf16, [&](auto t, auto c) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    const dim3 blocks(smow::TileGeom<kC>::count(H, W), frames);
    token_scatter_bwd_kernel<T, kC><<<blocks, smow::kScatterThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const float*>(grid), static_cast<const float*>(m),
        static_cast<const float*>(dz), static_cast<const T*>(ew_bar), static_cast<float*>(da),
        static_cast<float*>(dw), H, W);
    return cudaGetLastError();
  }));
}

extern "C" const char* smow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
