// What the selective scan's sweeps share (selective_scan.cu: I-fwd, I-ckpt,
// the carry and the adjoint carry; selective_scan_bwd.cu: I-bwd): the
// state and chunk sizes, where a row lies in the two layouts, the softplus,
// the shape check, the launch over slices of rows, and the block shape and
// staging helpers of the two 4-warp sweeps (scan_fwd_kernel and
// scan_bwd_kernel). In an anonymous namespace, as each file's kernels are:
// every file that includes it keeps its own copy, and its kernels' names
// and code stay what they were when these lived in the .cu files.
#pragma once

#include <cstdint>

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

// The 4-warp sweeps' block: 32 channels of one row, 4 lanes a channel, 4 of
// its 16 states a lane.
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerChannel = 4;
constexpr int kStates = kN / kLanesPerChannel;               // per lane
constexpr int kWarpChannels = 32 / kLanesPerChannel;         // 8
constexpr int kBlockChannels = kWarps * kWarpChannels;       // 32

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group of copies (the newest) is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until no copy of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Copy n_t steps of a (kChunk x W) tile, row t at src + t * stride, into
// dst: 16-byte cp.async copies where `vec` and the vector lies within the
// n_w valid columns, element loads elsewhere; zeros past n_t and n_w. The
// block's threads share the tile's 16-byte vectors.
template <typename T, int W>
__device__ __forceinline__ void stage_tile(T (*dst)[W], const T* __restrict__ src, int stride,
                                           int n_t, int n_w, bool vec) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kRowVecs = W / kV;
  for (int i = threadIdx.x; i < kChunk * kRowVecs; i += kThreads) {
    const int t = i / kRowVecs, w = i % kRowVecs * kV;
    const T* s = src + (size_t)t * stride + w;
    if (vec && t < n_t && w + kV <= n_w) {
      cp_async16(&dst[t][w], s);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e)
        dst[t][w + e] = t < n_t && w + e < n_w ? s[e] : smow::from_float<T>(0.f);
    }
  }
}

// Four consecutive values of a shared-memory row as fp32 (16-byte aligned
// in fp32, 8-byte in bf16).
__device__ __forceinline__ void load4(const float* p, float (&v)[kStates]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[kStates]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// 2^x on the multi-function unit, subnormal results flushed to zero (the
// decays exp(dt A) <= 1 lose nothing that the sums keep).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
