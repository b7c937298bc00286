// What the selective scan's sweeps share (selective_scan.cu: I-fwd, I-ckpt,
// the carry and the adjoint carry; selective_scan_bwd.cu: I-bwd): the
// state and chunk sizes, where a row lies in the two layouts, the softplus,
// the shape check and the launch over slices of rows. In an anonymous
// namespace, as each file's kernels are: every file that includes it keeps
// its own copy, and its kernels' names and code stay what they were when
// these lived in selective_scan.cu.
#pragma once

#include "common.cuh"

namespace {

constexpr int kN = 16;        // d_state
constexpr int kChunk = 16;    // steps per chunk: the checkpoint interval
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Where row r' = row0 + blockIdx.y of a launch lies in its tensors (see
// selective_scan.cu's header); the layout is a template parameter, so the
// grouped layout's strides are the compile-time widths. Grid y stops at
// 65535, so a call of more rows is launched in slices of rows, each from
// its row0.
template <bool kFlat>
struct Rows {
  int L;      // steps each row walks
  int S;      // segments per sequence
  int G;      // groups
  int row0;   // the launch's first row
  int rows;   // the call's rows (all launches)

  __device__ __forceinline__ int group(int rs) const { return (rs / S) % G; }
  // distance between consecutive steps in a tensor of width W
  __device__ __forceinline__ int step(int W) const { return kFlat ? G * W : W; }
  // offset of row rs's first step in a tensor of width W
  __device__ __forceinline__ size_t base(int rs, int W) const {
    if (!kFlat) return (size_t)rs * L * W;    // rows of S * L steps: r * S * L + s * L = rs * L
    const int r = rs / S, s = rs % S;
    return ((size_t)(r / G) * S * L * G + (r % G)) * W + (size_t)s * L * G * W;
  }
};

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

bool bad_shape(int rows, int L, int Dk, int G, int S, int flat) {
  return rows <= 0 || L <= 0 || Dk <= 0 || G <= 0 || S <= 0 || rows % ((long long)G * S) != 0 ||
         (flat != 0 && flat != 1);
}

constexpr int kMaxGridY = 65535;

// Call `launch(grid, rw)` over the call's rows in slices of at most kMaxGridY,
// each on grid (blocks of kBlockChannels channels, slice rows) with its Rows;
// the first error stops it.
template <int kBlockChannels, bool kFlat, typename F>
cudaError_t launch_rows(int rows, int L, int Dk, int G, int S, F&& launch) {
  for (int row0 = 0; row0 < rows; row0 += kMaxGridY) {
    const int slice = rows - row0 < kMaxGridY ? rows - row0 : kMaxGridY;
    const dim3 grid((Dk + kBlockChannels - 1) / kBlockChannels, slice);
    launch(grid, Rows<kFlat>{L, S, G, row0, rows});
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
