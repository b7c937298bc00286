// The scatter half of kernels B, A-bwd, D, E and D-bwd: a tile of grid
// pixels adds its channel rows, weighted by their bilinear corners' lerp
// weights, into an fp32 (H, W, C) image accumulator, cell by cell in shared
// memory, and sends each cell's sum to device memory as 16-byte vector
// reductions.
//
// One block of kScatterThreads threads owns a TH x TW tile of grid pixels of
// one batch entry (ScatterTile<C>). Each thread first takes its pixels
// (slots tid, tid + kScatterThreads, ...): it notes their corners
// (`note_corners`: the corner cells and w_k = wy[k / 2] wx[k % 2], the
// products the plain scatter forms) and stages their rows in fp32
// (`stage_row`).
// Then `scatter_tile`:
//   1. reduces the corners' rows and columns over the block to a bounding
//      box in the image;
//   2. if the box has fewer than kWindowCells cells, sorts the tile's 4 x
//      TH x TW corners by box cell (a counting sort: one shared-memory
//      integer atomicAdd per corner for its rank in its cell, a block scan
//      of the counts, the corners listed by cell), then gives each thread
//      (cell, four channels) pairs, neighbouring threads on neighbouring
//      vectors of a box row: it sums w_k v over the cell's corners in
//      registers and adds the sum to the accumulator with one 16-byte vector
//      reduction (float4 atomicAdd, red.global.add.v4.f32 on compute
//      capability 9.x). Hopper has no fp32 add in shared memory (atomicAdd
//      there compiles to a compare-and-swap loop, and 4C of them per pixel
//      made that loop the kernels' limit); the sort takes four native
//      integer adds per pixel;
//   3. else (a far-scattered or NaN grid, a spread across the tile wider
//      than the box allows) adds each corner row straight to the
//      accumulator as C/4 vector reductions.
// Every corner is added in both branches, zero-weight ones included, so NaN
// and Inf in the values propagate as in the plain scatter. The products
// w_k v are rounded before they are summed, as in the plain version. A
// cell's corners are summed in the order of their ranks, which the integer
// atomics hand out in no fixed order, and blocks reduce into device memory
// in no fixed order: the last bits of the sum vary from run to run.
#pragma once

#include <climits>

#include "common.cuh"

namespace smow {

constexpr int kScatterThreads = 256;
constexpr int kWindowCells = 2048;   // box cells a block sorts its corners into

// Grid pixels per block, TH x TW: fewer at wider C, so that a tile's rows
// take 16 KB in fp32 at every C (at C = 64, A-bwd's only, a quarter of the
// block's threads hold a pixel while the corners are noted).
template <int C> struct ScatterTile;
template <> struct ScatterTile<8> { static constexpr int kTH = 16, kTW = 32; };
template <> struct ScatterTile<16> { static constexpr int kTH = 16, kTW = 16; };
template <> struct ScatterTile<32> { static constexpr int kTH = 8, kTW = 16; };
template <> struct ScatterTile<64> { static constexpr int kTH = 8, kTW = 8; };

// Rows and columns below 2^30: bit 30 of a noted corner carries dy or dx.
constexpr int kCoordBits = (1 << 30) - 1;

template <int C>
struct ScatterSmem {
  static constexpr int kTW = ScatterTile<C>::kTW;
  static constexpr int kPix = ScatterTile<C>::kTH * kTW;
  static constexpr int kVecs = C / 4;
  // a thread's pixels: slots s * kScatterThreads + tid, s < kSlots
  static constexpr int kSlots = (kPix + kScatterThreads - 1) / kScatterThreads;
  float4 vals[kPix * kVecs];      // each tile pixel's row in fp32
  float4 w[kPix];                 // w_k = wy[k / 2] wx[k % 2] of each tile pixel
  int2 yx[kPix];                  // (y0 | (y1 - y0) << 30, x0 | (x1 - x0) << 30); x < 0: no pixel
  int cell[kWindowCells];         // per box cell: its corners' count, then its first list entry
  unsigned short list[kPix * 4];  // the corners, slot * 4 + k, grouped by box cell
  int box[kScatterThreads / 32][4];   // per warp: min y0, max y1, min x0, max x1
  int warp_sum[kScatterThreads / 32];
};

// The block's tile: blockIdx.x counts tiles row-major over the (Hg, Wg) grid.
template <int C>
struct TileGeom {
  static constexpr int kTH = ScatterTile<C>::kTH, kTW = ScatterTile<C>::kTW;
  int ty0, tx0, rows, cols;

  static int count(int Hg, int Wg) {
    return ((Hg + kTH - 1) / kTH) * ((Wg + kTW - 1) / kTW);
  }

  __device__ TileGeom(int tile, int Hg, int Wg) {
    const int tiles_x = (Wg + kTW - 1) / kTW;
    ty0 = tile / tiles_x * kTH;
    tx0 = tile % tiles_x * kTW;
    rows = min(kTH, Hg - ty0);
    cols = min(kTW, Wg - tx0);
  }

  // The grid pixel of tile slot `slot`, or -1 past the tile or the grid.
  __device__ __forceinline__ int pixel(int slot, int Wg) const {
    const int ty = slot / kTW, tx = slot % kTW;
    return slot < kTH * kTW && ty < rows && tx < cols ? (ty0 + ty) * Wg + tx0 + tx : -1;
  }
};

// One thread's running bounds of the corners it noted.
struct Box {
  int y0 = INT_MAX, y1 = INT_MIN, x0 = INT_MAX, x1 = INT_MIN;
};

template <int C>
__device__ __forceinline__ void note_corners(ScatterSmem<C>& sm, int slot, const Corners& cr,
                                             int W, Box& box) {
  const int y0 = cr.idx[0] / W;
  const int x0 = cr.idx[0] - y0 * W;
  const int dx = cr.idx[1] - cr.idx[0];
  const int dy = cr.idx[2] != cr.idx[0];
  sm.yx[slot] = make_int2(y0 | dy << 30, x0 | dx << 30);
  sm.w[slot] = make_float4(cr.wy[0] * cr.wx[0], cr.wy[0] * cr.wx[1], cr.wy[1] * cr.wx[0],
                           cr.wy[1] * cr.wx[1]);
  box.y0 = min(box.y0, y0);
  box.y1 = max(box.y1, y0 + dy);
  box.x0 = min(box.x0, x0);
  box.x1 = max(box.x1, x0 + dx);
}

template <int C>
__device__ __forceinline__ void note_empty(ScatterSmem<C>& sm, int slot) {
  if (slot < ScatterSmem<C>::kPix) sm.yx[slot] = make_int2(-1, -1);
}

template <int C>
__device__ __forceinline__ void stage_row(ScatterSmem<C>& sm, int slot, const float (&v)[C]) {
#pragma unroll
  for (int i = 0; i < C / 4; ++i)
    sm.vals[slot * (C / 4) + i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ float4 scale4(float w, float4 v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z), __fmul_rn(w, v.w));
}

// cell[0 .. n] -> exclusive prefix sums (cell[n], zero on entry, ends as the
// total). n < kWindowCells.
template <int C>
__device__ __forceinline__ void scan_cells(ScatterSmem<C>& sm, int n) {
  constexpr int kPer = kWindowCells / kScatterThreads;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int base = threadIdx.x * kPer;
  int v[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = base + j <= n ? sm.cell[base + j] : 0;
    sum += v[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) sm.warp_sum[warp] = incl;
  __syncthreads();
  int prefix = incl - sum;
  for (int k = 0; k < warp; ++k) prefix += sm.warp_sum[k];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (base + j <= n) sm.cell[base + j] = prefix;
    prefix += v[j];
  }
  __syncthreads();
}

// acc[corner k of pixel p] += w_k row[p] for every pixel of the tile whose
// corners and row the block noted and staged; `box` is this thread's bounds
// of them; acc: (H, W, C) fp32 of this batch entry. Called by every thread
// of the block after its notes (it synchronises the block).
template <int C>
__device__ __forceinline__ void scatter_tile(ScatterSmem<C>& sm, Box box, float* __restrict__ acc,
                                             int W) {
  using S = ScatterSmem<C>;
  constexpr int kVecs = S::kVecs;
  const int warp = threadIdx.x / 32;
  box.y0 = __reduce_min_sync(~0u, box.y0);
  box.y1 = __reduce_max_sync(~0u, box.y1);
  box.x0 = __reduce_min_sync(~0u, box.x0);
  box.x1 = __reduce_max_sync(~0u, box.x1);
  if (threadIdx.x % 32 == 0) {
    sm.box[warp][0] = box.y0;
    sm.box[warp][1] = box.y1;
    sm.box[warp][2] = box.x0;
    sm.box[warp][3] = box.x1;
  }
  __syncthreads();   // the box, every noted corner and staged row
  int ymin = sm.box[0][0], ymax = sm.box[0][1], xmin = sm.box[0][2], xmax = sm.box[0][3];
#pragma unroll
  for (int k = 1; k < kScatterThreads / 32; ++k) {
    ymin = min(ymin, sm.box[k][0]);
    ymax = max(ymax, sm.box[k][1]);
    xmin = min(xmin, sm.box[k][2]);
    xmax = max(xmax, sm.box[k][3]);
  }
  const int R = ymax - ymin + 1, Q = xmax - xmin + 1;

  if (R * Q < kWindowCells) {
    const int n = R * Q;
    for (int i = threadIdx.x; i <= n; i += kScatterThreads) sm.cell[i] = 0;
    __syncthreads();
    // each corner's box cell and its rank among the cell's corners
    int at[S::kSlots][4], rank[S::kSlots][4];
#pragma unroll
    for (int s = 0; s < S::kSlots; ++s) {
      const int slot = s * kScatterThreads + threadIdx.x;
      const int2 yx = slot < S::kPix ? sm.yx[slot] : make_int2(-1, -1);
      if (yx.x < 0) continue;
      const int l00 = ((yx.x & kCoordBits) - ymin) * Q + (yx.y & kCoordBits) - xmin;
      const int dx = yx.y >> 30, dy = (yx.x >> 30) * Q;
      at[s][0] = l00;
      at[s][1] = l00 + dx;
      at[s][2] = l00 + dy;
      at[s][3] = l00 + dy + dx;
#pragma unroll
      for (int k = 0; k < 4; ++k) rank[s][k] = atomicAdd(&sm.cell[at[s][k]], 1);
    }
    __syncthreads();
    scan_cells(sm, n);
#pragma unroll
    for (int s = 0; s < S::kSlots; ++s) {
      const int slot = s * kScatterThreads + threadIdx.x;
      if (slot >= S::kPix || sm.yx[slot].x < 0) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sm.list[sm.cell[at[s][k]] + rank[s][k]] = static_cast<unsigned short>(slot * 4 + k);
    }
    __syncthreads();
    const float* wk = reinterpret_cast<const float*>(sm.w);
    float4* acc4 = reinterpret_cast<float4*>(acc) + ((size_t)ymin * W + xmin) * kVecs;
    for (int item = threadIdx.x; item < n * kVecs; item += kScatterThreads) {
      const int l = item / kVecs, vec = item % kVecs;
      const int beg = sm.cell[l], end = sm.cell[l + 1];
      if (beg == end) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int e = beg; e < end; ++e) {
        const int id = sm.list[e];
        const float4 p = scale4(wk[id], sm.vals[(id >> 2) * kVecs + vec]);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      const int r = l / Q;
      atomicAdd(acc4 + ((size_t)r * W + (l - r * Q)) * kVecs + vec, sum);
    }
  } else {
    for (int item = threadIdx.x; item < S::kPix * kVecs; item += kScatterThreads) {
      const int slot = item / kVecs, vec = item % kVecs;
      const int2 yx = sm.yx[slot];
      if (yx.x < 0) continue;
      const float4 w = sm.w[slot], v = sm.vals[item];
      const size_t g00 = (size_t)(yx.x & kCoordBits) * W + (yx.y & kCoordBits);
      const size_t dx = yx.y >> 30, dy = (size_t)(yx.x >> 30) * W;
      float4* a = reinterpret_cast<float4*>(acc) + vec;
      atomicAdd(a + g00 * kVecs, scale4(w.x, v));
      atomicAdd(a + (g00 + dx) * kVecs, scale4(w.y, v));
      atomicAdd(a + (g00 + dy) * kVecs, scale4(w.z, v));
      atomicAdd(a + (g00 + dy + dx) * kVecs, scale4(w.w, v));
    }
  }
}

}  // namespace smow
