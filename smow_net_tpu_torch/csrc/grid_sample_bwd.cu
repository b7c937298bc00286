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
// What bounds it on the card: bytes, once the atomics are few. One thread
// per grid pixel issuing 4C scalar fp32 atomics into the dx accumulator,
// each warp instruction spread over 32 rows of 32 bytes with 4 useful bytes
// in each, made the L2's atomic unit the limit (0.22 ms at (32, 128, 128,
// 8), 5% of the byte bound). The bytes are x, gy and the grid read once, dx's
// fp32 sum and the four fp32 weight-gradient rows.
//
// Design: the TPU kernel ran three one-hot MXU matmuls per pixel tile
// around one expanded operand. Here a block takes a tile of grid pixels.
// One thread per pixel gathers the four corner rows of x with 16-byte loads,
// forms the dot products with gy and writes the four weight gradients
// coalesced by pixel, as kernel D does; it notes the pixel's corners and
// stages its gy row in shared memory. The block then sorts the corners by
// the cells of the tile's bounding box, sums each cell's w * gy rows in
// registers and adds each sum to dx with 16-byte vector reductions, or,
// when the box is too large, adds the corner rows straight to dx as vector
// reductions (tile_scatter.cuh, shared with kernel B). A border-clamped
// flow sends many pixels to one cell, whose thread then sums them all; the
// sums' order, hence the last bits of dx, varies by run.

#include "tile_scatter.cuh"

namespace {

template <typename T, int C, bool kZeros, bool kAlign>
__global__ void __launch_bounds__(smow::kScatterThreads)
grid_sample_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                       const float* __restrict__ grid, float* __restrict__ dx,
                       float* __restrict__ dw, int H, int W, int Hg, int Wg) {
  __shared__ smow::ScatterSmem<C> sm;
  const int b = blockIdx.y;
  const int P = Hg * Wg;
  const smow::TileGeom<C> tg(blockIdx.x, Hg, Wg);
  const float2* gridb = reinterpret_cast<const float2*>(grid) + (size_t)b * P;
  const T* xb = x + (size_t)b * H * W * C;
  const T* gyb = gy + (size_t)b * P * C;
  smow::Box box;
#pragma unroll
  for (int i = 0; i < smow::ScatterSmem<C>::kSlots; ++i) {
    const int slot = i * smow::kScatterThreads + threadIdx.x;
    const int p = tg.pixel(slot, Wg);
    if (p < 0) {
      smow::note_empty(sm, slot);
      continue;
    }
    const smow::Corners cr = smow::bilinear_corners<kZeros, kAlign>(__ldg(gridb + p), H, W);
    float s[4];
    if constexpr (C > 32) {
      // 16 channels at a time: gy's chunk is staged, each corner's chunk
      // dotted with it; the sums run over c in order, as below
      constexpr int kChunk = 16;
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] = 0.f;
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += kChunk) {
        float gv[kChunk];
        smow::load_f32<T, kChunk>(gyb + (size_t)p * C + c0, gv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v[kChunk];
          smow::load_f32<T, kChunk>(xb + (size_t)cr.idx[k] * C + c0, v);
#pragma unroll
          for (int c = 0; c < kChunk; ++c) s[k] += v[c] * gv[c];
        }
#pragma unroll
        for (int i = 0; i < kChunk / 4; ++i)
          sm.vals[slot * (C / 4) + c0 / 4 + i] =
              make_float4(gv[4 * i], gv[4 * i + 1], gv[4 * i + 2], gv[4 * i + 3]);
      }
    } else {
      float gv[C];
      smow::load_f32<T, C>(gyb + (size_t)p * C, gv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[C];
        smow::load_f32<T, C>(xb + (size_t)cr.idx[k] * C, v);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) dot += v[c] * gv[c];
        s[k] = dot;
      }
      smow::stage_row(sm, slot, gv);
    }
    float* dwb = dw + (size_t)b * 4 * P + p;
    dwb[0] = cr.wx[0] * s[0] + cr.wx[1] * s[1];   // dwy0
    dwb[P] = cr.wx[0] * s[2] + cr.wx[1] * s[3];   // dwy1
    dwb[2 * P] = cr.wy[0] * s[0] + cr.wy[1] * s[2];  // dwx0
    dwb[3 * P] = cr.wy[0] * s[1] + cr.wy[1] * s[3];  // dwx1
    smow::note_corners(sm, slot, cr, W, box);
  }
  smow::scatter_tile(sm, box, dx + (size_t)b * H * W * C, W);
}

}  // namespace

// x: (B, H, W, C) primal image; gy: (B, Hg, Wg, C) pixel cotangent, the
// same dtype (fp32 or bf16); grid: (B, Hg, Wg, 2) fp32. Accumulates into
// dx: (B, H, W, C) fp32, zeroed, and writes dw: (B, 4, Hg, Wg) fp32 rows
// (dwy0, dwy1, dwx0, dwx1). C is 8, 16, 32 or 64; zeros: zeros padding
// (else border); align: align_corners.
extern "C" int grid_sample_bwd(const void* x, const void* gy, const void* grid, void* dx,
                               void* dw, int B, int H, int W, int Hg, int Wg, int C,
                               int is_bf16, int zeros, int align, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hg <= 0 || Wg <= 0 || H > smow::kCoordBits ||
      W > smow::kCoordBits)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(smow::dispatch_warp<true>(C, is_bf16, zeros, align,
                                                    [&](auto t, auto c, auto z, auto al) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    auto kernel = grid_sample_bwd_kernel<T, kC, decltype(z)::value, decltype(al)::value>;
    const dim3 blocks(smow::TileGeom<kC>::count(Hg, Wg), B);
    kernel<<<blocks, smow::kScatterThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(gy), static_cast<const float*>(grid),
        static_cast<float*>(dx), static_cast<float*>(dw), H, W, Hg, Wg);
    return cudaGetLastError();
  }));
}
