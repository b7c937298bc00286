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
// What bounds it on the card: bytes, once the atomics are few. One thread
// per grid pixel issuing 4C scalar fp32 atomics into the accumulator, each
// warp instruction spread over 32 rows of 32 bytes with 4 useful bytes in
// each, made the L2's atomic unit the limit (0.21 ms at (32, 128, 128, 8),
// 3% of the byte bound). The bytes are g and the grid read once and the
// image's fp32 sum.
//
// Design: the TPU kernel formed (lerp-weighted g) @ (vertical one-hot)^T on
// the MXU and carried the image across its sequential grid in VMEM. Here a
// block takes a tile of grid pixels, notes their corners, stages their g
// rows in shared memory, sorts the corners by the cells of the tile's
// bounding box and sums each cell's weighted rows in registers, then adds
// each cell's sum to the fp32 image with one 16-byte vector reduction per
// four channels (tile_scatter.cuh): under a flow of a few pixels about C/4
// reductions per pixel in place of 4C atomics. A tile whose box is too
// large adds its corner rows straight to the image as vector reductions.
// The sums' order, hence the last bits of the image, varies from run to run.

#include "tile_scatter.cuh"

namespace {

template <typename T, int C, bool kZeros, bool kAlign>
__global__ void __launch_bounds__(smow::kScatterThreads)
grid_sample_transpose_kernel(const T* __restrict__ g, const float* __restrict__ grid,
                             float* __restrict__ out, int H, int W, int Hg, int Wg) {
  __shared__ smow::ScatterSmem<C> sm;
  const int b = blockIdx.y;
  const smow::TileGeom<C> tg(blockIdx.x, Hg, Wg);
  const float2* gridb = reinterpret_cast<const float2*>(grid) + (size_t)b * Hg * Wg;
  const T* gb = g + (size_t)b * Hg * Wg * C;
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
    float v[C];
    smow::load_f32<T, C>(gb + (size_t)p * C, v);
    smow::stage_row(sm, slot, v);
    smow::note_corners(sm, slot, cr, W, box);
  }
  smow::scatter_tile(sm, box, out + (size_t)b * H * W * C, W);
}

}  // namespace

// g: (B, Hg, Wg, C) fp32 or bf16; grid: (B, Hg, Wg, 2) fp32. Accumulates
// into out: (B, H, W, C) fp32, zeroed. C is 8, 16 or 32; zeros: zeros
// padding (else border); align: align_corners.
extern "C" int grid_sample_transpose(const void* g, const void* grid, void* out, int B, int H,
                                     int W, int Hg, int Wg, int C, int is_bf16, int zeros,
                                     int align, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hg <= 0 || Wg <= 0 || H > smow::kCoordBits ||
      W > smow::kCoordBits)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(smow::dispatch_warp(C, is_bf16, zeros, align,
                                              [&](auto t, auto c, auto z, auto al) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    auto kernel = grid_sample_transpose_kernel<T, kC, decltype(z)::value, decltype(al)::value>;
    const dim3 blocks(smow::TileGeom<kC>::count(Hg, Wg), B);
    kernel<<<blocks, smow::kScatterThreads, 0, s>>>(
        static_cast<const T*>(g), static_cast<const float*>(grid), static_cast<float*>(out), H,
        W, Hg, Wg);
    return cudaGetLastError();
  }));
}
