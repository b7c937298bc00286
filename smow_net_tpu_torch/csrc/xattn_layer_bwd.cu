// Kernel F-bwd: the backward of the whole dim_head=1 pixel-decoder layer.
//
// Replaces `_layer_bwd_kernel` (via `_layer_vjp_bwd`) in
// smow_net_tpu/ops/pallas/xattn.py. Given the layer's inputs and the output
// cotangent g, per row of x (B, N, D) it recomputes the forward of kernel F
// and runs
//   MLP:       dhg = g w2^T, dh = dhg (cdf(h) + h pdf(h)), dyn = dh w1^T,
//              LN2 backward + g  -> dy1
//   attention: do = dy1 wo^T, dnum = do / den, dden = -do o / den,
//              dd_m = e_m (dnum v_m + dden), dq = sum_m dd_m kexp_m,
//              dxn = dq wq^T, LN1 backward + dy1 -> dxc, dx[perm[d]] = dxc[d]
// and accumulates every reduction over rows in the kernel: dw1 = yn^T dh,
// db1, dw2 = hg^T g, db2, dwo = o^T dy1, dbo, dwq = xn^T dq, the LayerNorm
// scales and biases (sum dyn yhat, sum dyn; sum dxn xhat, sum dxn), and per
// batch dkexp = sum q dd, dvexp = sum e dnum. Only the layer's inputs are
// saved for the backward, never its (B, N, hidden) activations.
//
// What bounds it on the card: five products of D x hidden per row (h, dhg,
// dyn, dw1, dw2), 86 GFLOP at the SMOW_Net shape (16 x 16384 rows, D = 128;
// a quarter of that at SMOW_Net_LW's D = 64): 0.087 ms on bf16 tensor
// cores, against 0.060 ms for the 201 MB of x, g and dx in bf16.
//
// bf16 design (`layer_bwd_tc`). The TPU kernel runs the five products on
// the MXU and keeps dw1 and dw2 in VMEM across its sequential grid. Here the
// products run on the tensor cores (`mma.sync.m16n8k16` with `ldmatrix`,
// xattn_layer_tc.cuh; the A and B operands of every product, both
// orientations, from one padded shared-memory copy of each matrix), and
// dw1 and dw2 stay in registers for the whole call, written once per block
// at the end. fp32 dw1 + dw2 are 4 D^2 floats (256 KB at D = 128), more than
// a block's registers or shared memory, so a thread-block cluster of C = 2D
// / 64 blocks (4 at D = 128, 2 at D = 64) splits the hidden dimension: block
// c of a cluster holds w1[:, 64c:64c+64] and w2[64c:64c+64, :] in bf16 (16
// KB each at D = 128) and the matching 64 columns of dw1 and 64 rows of dw2
// in its 8 warps' accumulators (D/2 floats a thread). The clusters are
// persistent (as many as fit at once, cudaOccupancyMaxActiveClusters) and
// walk 64-row tiles; per tile:
//   1. prefix, split by rows: block c recomputes LN1, q, the softmax, y1 and
//      LN2 for its 64/C rows (one warp per row, fp32 on the CUDA cores, one
//      shift per (pixel, head)), and writes LN2(y1), as bf16 hi + lo, into
//      every block of the cluster through distributed shared memory;
//      cluster barrier;
//   2. h = yn w1_c and dhg = g w2_c^T on 64 x 64 per block; the exact GELU and
//      its derivative give hg and dh (hi + lo, shared memory); then dyn_c =
//      dh w1_c^T (64 x D, this block's part of the sum over hidden), dw1_c +=
//      yn^T dh and dw2_c += hg^T g into the accumulators, db1 from dh;
//      cluster barrier;
//   3. the rest, split by rows: block c sums the C parts of dyn for its rows
//      out of the cluster's shared memory, in rank order, and runs LN2's
//      backward, the attention backward, LN1's backward and dx for them on
//      the CUDA cores in fp32, with the small reductions (dwq, dwo, the
//      LayerNorms', db2, dbo) in shared memory owned one element a thread.
// The next tile's g (all rows) and x (this block's rows) stream in through
// `cp.async` while the current one runs. Each fp32 activation operand of a
// product is split into bf16 hi + lo (yn, hg, dh; both sides of dw1 = yn^T
// dh); g and the weights are bf16 already: 10 MMAs per row-column-depth
// unit where single rounding takes 5. Every reduction over
// rows is summed in a fixed order (no float atomics) except dkexp and
// dvexp, 64 values per batch, added per tile with atomicAdd. A block writes
// its record (its dw1 columns, dw2 rows, db1 part, and the small sums of its
// rows) once, at the end; the wrapper sums the records over clusters. Rows
// past N load as zeros, which makes every contribution they add exactly
// zero, and are not stored. On the H100 the steps on the CUDA cores (steps 1
// and 3, the GELU) and the two cluster barriers a tile, not the products,
// set its time (PERF.md §6).
//
// fp32 (`xattn_layer_bwd_kernel`, the port's first design, kept for the fp32
// checks and fp32 models): a persistent grid, one block of 256 threads per
// SM, each walking a strided set of 64-row tiles and adding its partial sums
// into its row of a device-memory slab per tile; the hidden dimension
// streams through shared memory 64 units at a time, every product in fp32
// FMA on the CUDA cores.

#include <cooperative_groups.h>

#include "xattn_layer_tc.cuh"

namespace {


using namespace smow::xlayer;
using smow::from_float;
using smow::to_float;
using smow::warp_sum;

constexpr int kW1Row = kChunk + 1;   // w1 chunk (kD, kChunk), odd stride
constexpr int kHRow = kChunk + 1;    // GELU(h) and dh chunks (kTile, kChunk)

// one block's partial sums, in floats (the wrapper reads the same layout)
template <int kD>
struct Slab {
  static constexpr int kW2Row = kD + 1;                    // w2 chunk (kChunk, kD), odd stride
  static constexpr int kOffW1 = 0;                         // (kD, kHidden)
  static constexpr int kOffW2 = kOffW1 + kD * kHidden<kD>;  // (kHidden, kD)
  static constexpr int kOffWq = kOffW2 + kHidden<kD> * kD;  // (kD, kHeads)
  static constexpr int kOffWo = kOffWq + kD * kHeads;      // (kHeads, kD)
  static constexpr int kOffLn1g = kOffWo + kHeads * kD;
  static constexpr int kOffLn1b = kOffLn1g + kD;
  static constexpr int kOffLn2g = kOffLn1b + kD;
  static constexpr int kOffLn2b = kOffLn2g + kD;
  static constexpr int kOffBo = kOffLn2b + kD;
  static constexpr int kOffB2 = kOffBo + kD;
  static constexpr int kOffB1 = kOffB2 + kD;               // (kHidden,)
  static constexpr int kSize = kOffB1 + kHidden<kD>;
  static constexpr int kSmemFloats = 3 * kTile * kRow<kD> + kD * kW1Row + kChunk * kW2Row +
                                     2 * kTile * kHRow + 3 * kTile * kHeads + 4 * kTile +
                                     2 * kHeads * kM;
  static constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
  static_assert(kSmemBytes <= 232448, "over a block's shared memory");
  static_assert(kTile * kRow<kD> <= kD * kW1Row + kChunk * kW2Row,
                "dyn reuses the weight chunks");
};
static_assert(kThreads == 256 && kTile == 64 && kChunk == 64 && kHeads == 8 && kM == 8,
              "the thread layouts below assume these sizes");

constexpr float kInvSqrt2Pi = 0.3989422804014327f;

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
xattn_layer_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ dx,
                       float* __restrict__ slab, float* __restrict__ dkexp,
                       float* __restrict__ dvexp, Params p, int B) {
  static_assert(kD == 64 || kD == 128, "the thread layouts assume D = 64 or 128");
  using S = Slab<kD>;
  constexpr int kR = kRow<kD>;
  constexpr int kW2Row = S::kW2Row;
  constexpr int kCols = kD / 16;             // dyn / dw2 columns per thread
  constexpr int kW1Rows = kD / 16;           // dw1 rows per thread
  constexpr int kHeadsPer = kHeads * kD / kThreads;   // dwo heads per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ys = smem;                        // x tile, then y1
  float* ns = ys + kTile * kR;             // LN1's statistics, then LN2(y1), then the x tile again
  float* gs = ns + kTile * kR;             // output cotangent g, then dy1
  float* w1s = gs + kTile * kR;            // (kD, kW1Row) w1 chunk
  float* w2s = w1s + kD * kW1Row;          // (kChunk, kW2Row) w2 chunk
  float* dyn = w1s;                        // after the chunks: (kTile, kR) d LN2(y1)
  float* hgs = w2s + kChunk * kW2Row;      // (kTile, kHRow) GELU(h) chunk
  float* dhs = hgs + kTile * kHRow;        // (kTile, kHRow) dh chunk
  float* qs = dhs + kTile * kHRow;         // (kTile, kHeads)
  float* os = qs + kTile * kHeads;         // (kTile, kHeads)
  float* dqs = os + kTile * kHeads;        // (kTile, kHeads)
  float* mu1 = dqs + kTile * kHeads;
  float* rs1 = mu1 + kTile;
  float* mu2 = rs1 + kTile;
  float* rs2 = mu2 + kTile;
  float* dkv = rs2 + kTile;                // (2, kHeads, kM): dkexp, dvexp of the tile

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int N = p.N;
  const int tiles_per_b = (N + kTile - 1) / kTile;
  const int n_tiles = B * tiles_per_b;
  float* part = slab + (size_t)blockIdx.x * S::kSize;
  for (int i = t; i < 2 * kHeads * kM; i += kThreads) dkv[i] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_b;
    const int n0 = (tile % tiles_per_b) * kTile;
    const T* xb = x + (size_t)b * N * kD;
    const T* gb = gy + (size_t)b * N * kD;
    __syncthreads();   // the previous tile's reads are done

    // 1. the x tile (permuted) and the cotangent tile
    load_tile<kD>(xb, p.perm, n0, N, ys);
    load_tile<kD>(gb, static_cast<const int*>(nullptr), n0, N, gs);
    __syncthreads();

    // 2. forward recompute up to LN2(y1), as kernel F
    ln_stats_rows<kD>(ys, p.eps, reinterpret_cast<double*>(ns), mu1, rs1);
    __syncthreads();
    attention_rows<kD>(ys, reinterpret_cast<const double*>(ns), p, b, os, qs);
    __syncthreads();
    attention_out_rows<kD>(ys, os, p);
    __syncthreads();
    layer_norm_rows<kD>(ys, ns, p.ln2_g, p.ln2_b, p.eps, mu2, rs2);

    // 3. the MLP, hidden streamed in chunks. Thread (ty, tx) owns rows
    //    ty*4..+3 and chunk columns tx + 16j for h and dhg, and columns
    //    tx + 16j of D for dyn.
    const int ty = t / 16, tx = t % 16;
    float acc[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < kHidden<kD>; c0 += kChunk) {
      __syncthreads();   // LN2 written / the previous chunk's reads done
      for (int i = t; i < kD * kChunk; i += kThreads) {
        const int k = i / kChunk, j = i % kChunk;
        w1s[k * kW1Row + j] = __ldg(p.w1 + (size_t)k * kHidden<kD> + c0 + j);
      }
      for (int i = t; i < kChunk * kD; i += kThreads) {
        const int j = i / kD, d = i % kD;
        w2s[j * kW2Row + d] = __ldg(p.w2 + (size_t)(c0 + j) * kD + d);
      }
      __syncthreads();

      // h = LN2(y1) w1 and dhg = g w2^T for this chunk's columns
      float hp[4][4], dg[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hp[i][j] = dg[i][j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < kD; ++k) {
        float a[4], g[4], bw[4], cw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ns[(ty * 4 + i) * kR + k];
          g[i] = gs[(ty * 4 + i) * kR + k];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bw[j] = w1s[k * kW1Row + tx + 16 * j];
          cw[j] = w2s[(tx + 16 * j) * kW2Row + k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hp[i][j] += a[i] * bw[j];
            dg[i][j] += g[i] * cw[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const float h = hp[i][j] + __ldg(p.b1 + c0 + col);
          const float cdf = gelu_cdf(h);
          const float pdf = expf(-0.5f * h * h) * kInvSqrt2Pi;
          hgs[(ty * 4 + i) * kHRow + col] = h * cdf;
          dhs[(ty * 4 + i) * kHRow + col] = dg[i][j] * (cdf + h * pdf);
        }
      __syncthreads();

      // dyn += dh w1_chunk^T
#pragma unroll 2
      for (int k = 0; k < kChunk; ++k) {
        float a[4], bw[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = dhs[(ty * 4 + i) * kHRow + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) bw[j] = w1s[(tx + 16 * j) * kW1Row + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] += a[i] * bw[j];
      }

      // the chunk's dw1 block (kD x kChunk) += LN2(y1)^T dh: thread owns
      // rows (t/16)*kW1Rows..+kW1Rows-1 and columns t%16 + 16j
      {
        const int a8 = t / 16, bc = t % 16;
        float o[kW1Rows][4];
#pragma unroll
        for (int i = 0; i < kW1Rows; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
        for (int r = 0; r < kTile; ++r) {
          float yv[kW1Rows];
#pragma unroll
          for (int v = 0; v < kW1Rows / 4; ++v) {
            const float4 y4 =
                reinterpret_cast<const float4*>(ns + r * kR + a8 * kW1Rows)[v];
            yv[4 * v] = y4.x;
            yv[4 * v + 1] = y4.y;
            yv[4 * v + 2] = y4.z;
            yv[4 * v + 3] = y4.w;
          }
          float hv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) hv[j] = dhs[r * kHRow + bc + 16 * j];
#pragma unroll
          for (int i = 0; i < kW1Rows; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) o[i][j] += yv[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < kW1Rows; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[S::kOffW1 + (a8 * kW1Rows + i) * kHidden<kD> + c0 + bc + 16 * j] += o[i][j];
      }
      // the chunk's dw2 block (kChunk x kD) += GELU(h)^T g: thread owns rows
      // (t/16)*4..+3 and columns t%16 + 16j
      {
        const int a4 = t / 16, bc = t % 16;
        float o[4][kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) o[i][j] = 0.f;
        for (int r = 0; r < kTile; ++r) {
          float hv[4], gv[kCols];
#pragma unroll
          for (int i = 0; i < 4; ++i) hv[i] = hgs[r * kHRow + a4 * 4 + i];
#pragma unroll
          for (int j = 0; j < kCols; ++j) gv[j] = gs[r * kR + bc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) o[i][j] += hv[i] * gv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            part[S::kOffW2 + (c0 + a4 * 4 + i) * kD + bc + 16 * j] += o[i][j];
      }
      if (t < kChunk) {
        float s = 0.f;
        for (int r = 0; r < kTile; ++r) s += dhs[r * kHRow + t];
        part[S::kOffB1 + c0 + t] += s;
      }
    }
    __syncthreads();   // the last chunk's reads of w1s / w2s are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) dyn[(ty * 4 + i) * kR + tx + 16 * j] = acc[i][j];
    __syncthreads();

    // 4. column sums of this tile: db2 (g), and LN2's scale and bias
    if (t < kD) {
      float sg = 0.f, sdg = 0.f, sdb = 0.f;
      for (int r = 0; r < kTile; ++r) {
        const float yh = (ys[r * kR + t] - mu2[r]) * rs2[r];
        const float dv = dyn[r * kR + t];
        sg += gs[r * kR + t];
        sdg += dv * yh;
        sdb += dv;
      }
      part[S::kOffB2 + t] += sg;
      part[S::kOffLn2g + t] += sdg;
      part[S::kOffLn2b + t] += sdb;
    }
    __syncthreads();

    // 5. LN2 backward, one warp per row: gs <- dy1 = LN2'(dyn) + g
    for (int r = warp; r < kTile; r += kThreads / 32) {
      float yh[kD / 32], dyh[kD / 32];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        const int d = lane + 32 * j;
        yh[j] = (ys[r * kR + d] - mu2[r]) * rs2[r];
        dyh[j] = dyn[r * kR + d] * __ldg(p.ln2_g + d);
        s1 += dyh[j];
        s2 += dyh[j] * yh[j];
      }
      const float m1 = warp_sum(s1) * (1.f / kD), m2 = warp_sum(s2) * (1.f / kD);
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        const int d = lane + 32 * j;
        gs[r * kR + d] += rs2[r] * (dyh[j] - m1 - yh[j] * m2);
      }
    }
    __syncthreads();

    // 6a. attention backward, one thread per (row, head); the per-batch sums
    //     over rows reduce across the warp's four rows, then in smem
    for (int i = t; i < kTile * kHeads; i += kThreads) {
      const int r = i / kHeads, hh = i % kHeads;
      float dov = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) dov += gs[r * kR + d] * __ldg(p.wo + hh * kD + d);
      const float q = qs[r * kHeads + hh];
      const float* kr = p.kexp + ((size_t)b * kHeads + hh) * kM;
      const float* vr = p.vexp + ((size_t)b * kHeads + hh) * kM;
      float e[kM];
      const float den = softmax_tokens(q, kr, e);
      const float dnum = dov / den;
      const float dden = -dov * os[r * kHeads + hh] / den;
      float dq = 0.f, gk[kM], gv[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float dd = e[m] * (dnum * __ldg(vr + m) + dden);
        dq += dd * __ldg(kr + m);
        gk[m] = q * dd;
        gv[m] = e[m] * dnum;
      }
      dqs[r * kHeads + hh] = dq;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        gk[m] += __shfl_xor_sync(0xffffffffu, gk[m], 8);
        gk[m] += __shfl_xor_sync(0xffffffffu, gk[m], 16);
        gv[m] += __shfl_xor_sync(0xffffffffu, gv[m], 8);
        gv[m] += __shfl_xor_sync(0xffffffffu, gv[m], 16);
      }
      if (lane < kHeads) {
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          atomicAdd(dkv + hh * kM + m, gk[m]);
          atomicAdd(dkv + kHeads * kM + hh * kM + m, gv[m]);
        }
      }
    }
    // 6b. column sums: dwo = o^T dy1 (thread: column t % kD, heads
    //     (t / kD)*kHeadsPer..+kHeadsPer-1) and dbo
    {
      const int d = t % kD, h0 = (t / kD) * kHeadsPer;
      float oh[kHeadsPer], sb = 0.f;
#pragma unroll
      for (int j = 0; j < kHeadsPer; ++j) oh[j] = 0.f;
      for (int r = 0; r < kTile; ++r) {
        const float dy = gs[r * kR + d];
#pragma unroll
        for (int j = 0; j < kHeadsPer; ++j) oh[j] += os[r * kHeads + h0 + j] * dy;
        sb += dy;
      }
#pragma unroll
      for (int j = 0; j < kHeadsPer; ++j) part[S::kOffWo + (h0 + j) * kD + d] += oh[j];
      if (h0 == 0) part[S::kOffBo + d] += sb;
    }
    // 7. the x tile again, for LN1's backward (ns is free now)
    load_tile<kD>(xb, p.perm, n0, N, ns);
    __syncthreads();
    if (t < 2 * kHeads * kM) {
      const float v = dkv[t];
      dkv[t] = 0.f;
      float* dst = (t < kHeads * kM) ? dkexp : dvexp;
      atomicAdd(dst + (size_t)b * kHeads * kM + t % (kHeads * kM), v);
    }

    // 8a. LN1 backward, one warp per row: dxn = dq wq^T, dx = LN1'(dxn) + dy1
    T* dxb = dx + (size_t)b * N * kD;
    for (int r = warp; r < kTile; r += kThreads / 32) {
      float xh[kD / 32], dxh[kD / 32];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        const int d = lane + 32 * j;
        float dxn = 0.f;
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh)
          dxn += dqs[r * kHeads + hh] * __ldg(p.wq + d * kHeads + hh);
        xh[j] = (ns[r * kR + d] - mu1[r]) * rs1[r];
        dxh[j] = dxn * __ldg(p.ln1_g + d);
        s1 += dxh[j];
        s2 += dxh[j] * xh[j];
      }
      const float m1 = warp_sum(s1) * (1.f / kD), m2 = warp_sum(s2) * (1.f / kD);
      const int n = n0 + r;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        const int d = lane + 32 * j;
        const float v = rs1[r] * (dxh[j] - m1 - xh[j] * m2) + gs[r * kR + d];
        dxb[(size_t)n * kD + (p.perm ? __ldg(p.perm + d) : d)] = from_float<T>(v);
      }
    }
    // 8b. column sums: dwq = LN1(x)^T dq, LN1's scale and bias
    if (t < kD) {
      const float g1 = __ldg(p.ln1_g + t), b1 = __ldg(p.ln1_b + t);
      float wq[kHeads], sw[kHeads];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        wq[hh] = __ldg(p.wq + t * kHeads + hh);
        sw[hh] = 0.f;
      }
      float sdg = 0.f, sdb = 0.f;
      for (int r = 0; r < kTile; ++r) {
        const float xh = (ns[r * kR + t] - mu1[r]) * rs1[r];
        const float xn = xh * g1 + b1;
        float dxn = 0.f;
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const float dq = dqs[r * kHeads + hh];
          dxn += dq * wq[hh];
          sw[hh] += xn * dq;
        }
        sdg += dxn * xh;
        sdb += dxn;
      }
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) part[S::kOffWq + t * kHeads + hh] += sw[hh];
      part[S::kOffLn1g + t] += sdg;
      part[S::kOffLn1b + t] += sdb;
    }
  }
}


// ---- bf16: tensor cores, thread-block clusters over the hidden dimension --

namespace tcb {

using namespace smow::xlayer::tc;
namespace cg = cooperative_groups;

constexpr int kRows = 64;   // rows of a tile
constexpr int kHS = 64;     // hidden units per block of a cluster
constexpr int kWarps = kThreads / 32;

template <int kD>
struct Layout {
  static constexpr int kHid = 2 * kD;
  static constexpr int kC = kHid / kHS;        // blocks per cluster
  static constexpr int kOwn = kRows / kC;      // a block's rows of each tile (prefix and rest)
  static constexpr int kAS = kD + kPad;        // bf16 rows of D: g, yn hi/lo, the w2 slice
  static constexpr int kHSS = kHS + kPad;      // bf16 rows of 64: the w1 slice, hg and dh hi/lo
  static constexpr int kFS = kD + 8;           // fp32 rows of this block's dyn part
  static constexpr size_t kBf = sizeof(__nv_bfloat16);
  static constexpr size_t kOffW1 = 0;                                     // (kD, kHSS)
  static constexpr size_t kOffW2 = kOffW1 + kBf * kD * kHSS;              // (kHS, kAS)
  static constexpr size_t kOffG = kOffW2 + kBf * kHS * kAS;               // 2 x (kRows, kAS)
  static constexpr size_t kOffX = kOffG + kBf * 2 * kRows * kAS;          // 2 x (kOwn, kD)
  static constexpr size_t kOffYn = kOffX + kBf * 2 * kOwn * kD;           // hi, lo (kRows, kAS)
  // hg hi/lo, dh hi/lo (kRows, kHSS)
  static constexpr size_t kOffHg = kOffYn + kBf * 2 * kRows * kAS;
  // this block's part of dyn (kRows, kFS) fp32 takes the place of hg and dh
  // once the products have read them
  static constexpr size_t kOffDyn = kOffHg;
  static_assert(sizeof(float) * kRows * kFS <= kBf * 4 * kRows * kHSS, "dyn part over hg, dh");
  static constexpr size_t kOffY1 = kOffHg + kBf * 4 * kRows * kHSS;       // (kOwn, kD): y1
  static constexpr size_t kOffDy = kOffY1 + sizeof(float) * kOwn * kD;    // (kOwn, kD): summed dyn
  static constexpr size_t kOffDy1 = kOffDy + sizeof(float) * kOwn * kD;   // (kOwn, kD): dy1
  // per own row: mu1, rs1, mu2, rs2, then q, o, dq (kOwn, 8)
  static constexpr size_t kOffRow = kOffDy1 + sizeof(float) * kOwn * kD;
  static constexpr size_t kOffPrm = kOffRow + sizeof(float) * (4 + 3 * kHeads) * kOwn;
  // ln1_g, ln1_b, ln2_g, ln2_b, bo (kD each), wq^T (8, kD), wo (8, kD), b1 slice (kHS)
  static constexpr int kPrmFloats = 5 * kD + 2 * kHeads * kD + kHS;
  static constexpr size_t kOffPart = kOffPrm + sizeof(float) * kPrmFloats;
  // the small sums, in the record's order: db1 slice (kHS), dwq (kD, 8),
  // dwo (8, kD), dln1_g, dln1_b, dln2_g, dln2_b, dbo, db2 (kD each)
  static constexpr int kPartFloats = kHS + 2 * kHeads * kD + 6 * kD;
  // dkexp, dvexp of a tile's rows: one (2, 8, 8) partial per warp
  static constexpr size_t kOffDkv = kOffPart + sizeof(float) * kPartFloats;
  static constexpr size_t kOffDb1 = kOffDkv + sizeof(float) * kWarps * 2 * kHeads * kM;
  static constexpr size_t kOffPerm = kOffDb1 + sizeof(float) * 4 * kHS;   // db1: (4, kHS)
  static constexpr size_t kBytes = kOffPerm + sizeof(int) * kD;
  static_assert(kBytes <= 232448, "over a block's shared memory");
  // a block's record in the slab: dw1[:, slice] (kD, kHS), dw2[slice, :]
  // (kHS, kD), then the small sums as above
  static constexpr int kRec = 2 * kD * kHS + kPartFloats;
};

// v[i] = its sum over the warp, for kN values side by side
template <int kN>
__device__ __forceinline__ void warp_sums(float (&v)[kN]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

// The one-warp-per-row steps give lane l the column pairs 2l + 64 jj, jj <
// kV / 2: value j of a lane is column col(lane, j). Neighbouring lanes read
// neighbouring 8-byte pairs, so per-column parameters and row tiles load
// without bank conflicts.
__device__ __forceinline__ int col(int lane, int j) { return 2 * lane + 64 * (j >> 1) + (j & 1); }

template <int kV>
__device__ __forceinline__ void load_pairs(float (&v)[kV], const float* row, int lane) {
#pragma unroll
  for (int jj = 0; jj < kV / 2; ++jj) {
    const float2 a = *reinterpret_cast<const float2*>(row + 2 * lane + 64 * jj);
    v[2 * jj] = a.x, v[2 * jj + 1] = a.y;
  }
}
template <int kV>
__device__ __forceinline__ void load_pairs(float (&v)[kV], const __nv_bfloat16* row, int lane) {
#pragma unroll
  for (int jj = 0; jj < kV / 2; ++jj) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 2 * lane + 64 * jj));
    v[2 * jj] = a.x, v[2 * jj + 1] = a.y;
  }
}
template <int kV>
__device__ __forceinline__ void store_pairs(float* row, const float (&v)[kV], int lane) {
#pragma unroll
  for (int jj = 0; jj < kV / 2; ++jj)
    *reinterpret_cast<float2*>(row + 2 * lane + 64 * jj) = make_float2(v[2 * jj], v[2 * jj + 1]);
}

// the value of lane `lane` of v (kHeads values held alike by every lane)
__device__ __forceinline__ float pick(const float* v, int lane) {
  float r = v[0];
#pragma unroll
  for (int h = 1; h < kHeads; ++h)
    if (lane == h) r = v[h];
  return r;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
layer_bwd_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gy,
             __nv_bfloat16* __restrict__ dx, const __nv_bfloat16* __restrict__ w1,
             const __nv_bfloat16* __restrict__ w2, float* __restrict__ slab,
             float* __restrict__ dkexp, float* __restrict__ dvexp, Params p, int B) {
  static_assert(kD == 64 || kD == 128, "built for D = 64 and 128");
  using L = Layout<kD>;
  constexpr int kHid = L::kHid, kC = L::kC, kOwn = L::kOwn;
  constexpr int kAS = L::kAS, kHSS = L::kHSS, kFS = L::kFS;
  constexpr int kV = kD / 32;       // columns per lane in the one-warp-per-row steps
  constexpr int kRW = kOwn / kWarps;  // rows per warp in those steps
  constexpr int kKS = kD / 16;      // k-steps over D
  constexpr int kNW = kD / 16;      // n-tiles per warp: dyn, dw1 and dw2 alike
  extern __shared__ __align__(16) unsigned char smem[];
  auto* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffW1);
  auto* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffW2);
  auto* gall = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffG);
  auto* xall = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffX);
  auto* ynh = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffYn);
  __nv_bfloat16* ynl = ynh + kRows * kAS;
  auto* hgh = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffHg);
  __nv_bfloat16 *hgl = hgh + kRows * kHSS, *dhh = hgl + kRows * kHSS, *dhl = dhh + kRows * kHSS;
  float* dynp = reinterpret_cast<float*>(smem + L::kOffDyn);
  float* y1s = reinterpret_cast<float*>(smem + L::kOffY1);
  float* dys = reinterpret_cast<float*>(smem + L::kOffDy);
  float* dy1s = reinterpret_cast<float*>(smem + L::kOffDy1);
  float* mu1 = reinterpret_cast<float*>(smem + L::kOffRow);
  float *rs1 = mu1 + kOwn, *mu2 = rs1 + kOwn, *rs2 = mu2 + kOwn;
  float *qs = rs2 + kOwn, *os = qs + kOwn * kHeads, *dqs = os + kOwn * kHeads;
  float* g1 = reinterpret_cast<float*>(smem + L::kOffPrm);
  float *be1 = g1 + kD, *g2 = be1 + kD, *be2 = g2 + kD, *bo = be2 + kD;
  float *wq = bo + kD, *wo = wq + kHeads * kD, *b1s = wo + kHeads * kD;   // wq as (8, kD)
  float* part = reinterpret_cast<float*>(smem + L::kOffPart);
  float *pb1 = part, *pwq = pb1 + kHS, *pwo = pwq + kHeads * kD, *pln1g = pwo + kHeads * kD;
  float *pln1b = pln1g + kD, *pln2g = pln1b + kD, *pln2b = pln2g + kD, *pbo = pln2b + kD;
  float* pb2 = pbo + kD;
  float* dkv = reinterpret_cast<float*>(smem + L::kOffDkv);   // (kWarps, 2, 8, 8)
  float* db1w = reinterpret_cast<float*>(smem + L::kOffDb1);  // (4 row groups, kHS)
  int* perm = reinterpret_cast<int*>(smem + L::kOffPerm);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int j0 = rank * kHS;     // this block's hidden units
  const int r0 = rank * kOwn;    // this block's rows of each tile
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int N = p.N;
  const int tiles_per_b = (N + kRows - 1) / kRows, n_tiles = B * tiles_per_b;
  const int cid = blockIdx.x / kC, n_clusters = gridDim.x / kC;

  // this block's weight slices, once
  stage_bf16(w1s, kHSS, w1 + j0, kHid, kD, kHS, t, kThreads);
  stage_bf16(w2s, kAS, w2 + (size_t)j0 * kD, kD, kHS, kD, t, kThreads);
  for (int i = t; i < kD; i += kThreads) {
    g1[i] = p.ln1_g[i];
    be1[i] = p.ln1_b[i];
    g2[i] = p.ln2_g[i];
    be2[i] = p.ln2_b[i];
    bo[i] = p.bo[i];
    perm[i] = p.perm ? p.perm[i] : i;
  }
  for (int i = t; i < kHeads * kD; i += kThreads) {
    wq[(i % kHeads) * kD + i / kHeads] = p.wq[i];
    wo[i] = p.wo[i];
  }
  for (int i = t; i < kHS; i += kThreads) b1s[i] = p.b1[j0 + i];
  for (int i = t; i < L::kPartFloats; i += kThreads) part[i] = 0.f;

  // a tile's g (all rows) and x (this block's rows), zeros past N
  auto load = [&](int tile, int buf) {
    const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * kRows;
    constexpr int kChunks = kD / 8;
    __nv_bfloat16* gd = gall + buf * kRows * kAS;
    for (int i = t; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = n0 + r < N;
      cp_async16(gd + r * kAS + c, ok ? gy + ((size_t)b * N + n0 + r) * kD + c : gy, ok);
    }
    __nv_bfloat16* xd = xall + buf * kOwn * kD;
    for (int i = t; i < kOwn * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = n0 + r0 + r < N;
      cp_async16(xd + r * kD + c, ok ? x + ((size_t)b * N + n0 + r0 + r) * kD + c : x, ok);
    }
  };
  if (cid < n_tiles) load(cid, 0);
  cp_async_commit();
  cluster.sync();   // every block of the cluster runs before one writes to another

  float dw1[kNW][4], dw2[kNW][4];
#pragma unroll
  for (int j = 0; j < kNW; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dw1[j][c] = dw2[j][c] = 0.f;
  // dw1 (kD, kHS): warp's m-tile and first n-tile; dw2 (kHS, kD) likewise
  const int m1 = warp % (kD / 16), nb1 = (warp / (kD / 16)) * kNW;
  const int m2 = warp & 3, nb2 = (warp >> 2) * kNW;
  static_assert(kD / 16 * (kHS / 8) == kWarps * kNW && kHS / 16 * (kD / 8) == kWarps * kNW,
                "the warps cover dw1 and dw2");

  for (int tile = cid, it = 0; tile < n_tiles; tile += n_clusters, ++it) {
    const int buf = it & 1;
    const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * kRows;
    const __nv_bfloat16* gs = gall + buf * kRows * kAS;
    const __nv_bfloat16* xs = xall + buf * kOwn * kD;
    cp_async_wait<0>();
    __syncthreads();

    // 1. the prefix of this block's rows: one warp per row, a warp's kRW rows
    //    side by side; LN2(y1) hi/lo to every block of the cluster
    {
      float xv[kRW][kV], st[2 * kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarps * i;
        st[2 * i] = st[2 * i + 1] = 0.f;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          xv[i][j] = __bfloat162float(xs[r * kD + perm[col(lane, j)]]);
          st[2 * i] += xv[i][j];
          st[2 * i + 1] += xv[i][j] * xv[i][j];
        }
      }
      warp_sums(st);
      float m1[kRW], q1[kRW], qp[kRW * kHeads];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        m1[i] = st[2 * i] * (1.f / kD);
        q1[i] = rsqrtf(st[2 * i + 1] * (1.f / kD) - m1[i] * m1[i] + p.eps);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) qp[i * kHeads + h] = 0.f;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const int d = col(lane, j);
          const float xn = (xv[i][j] - m1[i]) * q1[i] * g1[d] + be1[d];
#pragma unroll
          for (int h = 0; h < kHeads; ++h) qp[i * kHeads + h] += xn * wq[h * kD + d];
        }
      }
      warp_sums(qp);
      float oh[kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) oh[i] = 0.f;
      if (lane < kHeads) {   // lane h: head h's softmax over the M tokens
        const float* kr = p.kexp + ((size_t)b * kHeads + lane) * kM;
        const float* vr = p.vexp + ((size_t)b * kHeads + lane) * kM;
#pragma unroll
        for (int i = 0; i < kRW; ++i) {
          const int r = warp + kWarps * i;
          const float qh = pick(qp + i * kHeads, lane);
          float e[kM];
          const float den = softmax_tokens(qh, kr, e);
          float num = 0.f;
#pragma unroll
          for (int m = 0; m < kM; ++m) num += e[m] * __ldg(vr + m);
          oh[i] = num / den;
          qs[r * kHeads + lane] = qh;
          os[r * kHeads + lane] = oh[i];
        }
      }
      float y[kRW][kV];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarps * i;
        float o[kHeads];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) o[h] = __shfl_sync(0xffffffffu, oh[i], h);
        st[2 * i] = st[2 * i + 1] = 0.f;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const int d = col(lane, j);
          float acc = bo[d] + xv[i][j];
#pragma unroll
          for (int h = 0; h < kHeads; ++h) acc += o[h] * wo[h * kD + d];
          y[i][j] = acc;
          st[2 * i] += acc;
          st[2 * i + 1] += acc * acc;
        }
        store_pairs(y1s + r * kD, y[i], lane);
      }
      warp_sums(st);
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarps * i;
        const float m2 = st[2 * i] * (1.f / kD);
        const float q2 = rsqrtf(st[2 * i + 1] * (1.f / kD) - m2 * m2 + p.eps);
        if (lane == 0) {
          mu1[r] = m1[i];
          rs1[r] = q1[i];
          mu2[r] = m2;
          rs2[r] = q2;
        }
        uint32_t hi[kV / 2], lo[kV / 2];
#pragma unroll
        for (int j = 0; j < kV / 2; ++j) {
          const int d = col(lane, 2 * j);
          split2((y[i][2 * j] - m2) * q2 * g2[d] + be2[d],
                 (y[i][2 * j + 1] - m2) * q2 * g2[d + 1] + be2[d + 1], hi[j], lo[j]);
        }
        const int at = (r0 + r) * kAS + 2 * lane;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          __nv_bfloat16* rh = cluster.map_shared_rank(ynh, c);
          __nv_bfloat16* rl = cluster.map_shared_rank(ynl, c);
#pragma unroll
          for (int j = 0; j < kV / 2; ++j) {
            *reinterpret_cast<uint32_t*>(rh + at + 64 * j) = hi[j];
            *reinterpret_cast<uint32_t*>(rl + at + 64 * j) = lo[j];
          }
        }
      }
    }
    cluster.sync();   // every row's LN2(y1) is in every block

    if (tile + n_clusters < n_tiles) load(tile + n_clusters, buf ^ 1);
    cp_async_commit();

    // 2a. h = yn w1_c and dhg = g w2_c^T: warp (rg, ch) owns rows 16 rg.. and
    //     hidden columns 32 ch.. of the block's 64
    {
      const int rg = warp & 3, ch = warp >> 2;
      float hacc[4][4] = {}, gacc[4][4] = {};
#pragma unroll 4
      for (int s = 0; s < kKS; ++s) {
        const int ao = (16 * rg + a_row(lane)) * kAS + 16 * s + a_col(lane);
        uint32_t ahi[4], alo[4], ag[4];
        ldsm(ahi, ynh + ao);
        ldsm(alo, ynl + ao);
        ldsm(ag, gs + ao);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t rb[4];
          ldsm_t(rb, w1s + (16 * s + bt_row(lane)) * kHSS + 32 * ch + 16 * pp + bt_col(lane));
          mma(hacc[2 * pp], ahi, rb[0], rb[1]);
          mma(hacc[2 * pp + 1], ahi, rb[2], rb[3]);
          mma(hacc[2 * pp], alo, rb[0], rb[1]);
          mma(hacc[2 * pp + 1], alo, rb[2], rb[3]);
          ldsm(rb, w2s + (32 * ch + 16 * pp + b_row(lane)) * kAS + 16 * s + b_col(lane));
          mma(gacc[2 * pp], ag, rb[0], rb[1]);
          mma(gacc[2 * pp + 1], ag, rb[2], rb[3]);
        }
      }
      // hg = GELU(h), dh = dhg GELU'(h), hi and lo into shared memory; the
      // warp's column sums of dh (db1) to db1w[rg]
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = 32 * ch + 8 * nt + 2 * q;
        float cs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at = (16 * rg + g + 8 * i) * kHSS + col;
          float hg[2], dh[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float h = hacc[nt][2 * i + e] + b1s[col + e];
            const float cdf = gelu_cdf(h);
            const float pdf = expf(-0.5f * h * h) * kInvSqrt2Pi;
            hg[e] = h * cdf;
            dh[e] = gacc[nt][2 * i + e] * (cdf + h * pdf);
          }
          uint32_t hi, lo;
          split2(hg[0], hg[1], hi, lo);
          *reinterpret_cast<uint32_t*>(hgh + at) = hi;
          *reinterpret_cast<uint32_t*>(hgl + at) = lo;
          split2(dh[0], dh[1], hi, lo);
          *reinterpret_cast<uint32_t*>(dhh + at) = hi;
          *reinterpret_cast<uint32_t*>(dhl + at) = lo;
          cs[0] += dh[0];
          cs[1] += dh[1];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
        }
        if (g == 0) *reinterpret_cast<float2*>(db1w + rg * kHS + col) = make_float2(cs[0], cs[1]);
      }
    }
    __syncthreads();

    // 2b. dyn_c = dh w1_c^T: warp (rg, half) owns rows 16 rg.., columns
    //     (kD / 2) half..
    float dacc[kNW][4];
#pragma unroll
    for (int j = 0; j < kNW; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dacc[j][c] = 0.f;
    {
      const int rg = warp & 3, half = warp >> 2;
#pragma unroll
      for (int s = 0; s < kHS / 16; ++s) {
        const int ao = (16 * rg + a_row(lane)) * kHSS + 16 * s + a_col(lane);
        uint32_t ahi[4], alo[4];
        ldsm(ahi, dhh + ao);
        ldsm(alo, dhl + ao);
#pragma unroll
        for (int pp = 0; pp < kNW / 2; ++pp) {
          uint32_t rb[4];
          ldsm(rb, w1s + ((kD / 2) * half + 16 * pp + b_row(lane)) * kHSS + 16 * s + b_col(lane));
          mma(dacc[2 * pp], ahi, rb[0], rb[1]);
          mma(dacc[2 * pp + 1], ahi, rb[2], rb[3]);
          mma(dacc[2 * pp], alo, rb[0], rb[1]);
          mma(dacc[2 * pp + 1], alo, rb[2], rb[3]);
        }
      }
    }
    // 2c. dw1_c += yn^T dh (k = the tile's rows)
#pragma unroll
    for (int s = 0; s < kRows / 16; ++s) {
      const int ao = (16 * s + b_row(lane)) * kAS + 16 * m1 + b_col(lane);
      uint32_t ahi[4], alo[4];
      ldsm_t(ahi, ynh + ao);
      ldsm_t(alo, ynl + ao);
#pragma unroll
      for (int pp = 0; pp < kNW / 2; ++pp) {
        const int bo_ = (16 * s + bt_row(lane)) * kHSS + 8 * nb1 + 16 * pp + bt_col(lane);
        uint32_t bh[4], bl[4];
        ldsm_t(bh, dhh + bo_);
        mma(dw1[2 * pp], ahi, bh[0], bh[1]);
        mma(dw1[2 * pp + 1], ahi, bh[2], bh[3]);
        ldsm_t(bl, dhl + bo_);
        mma(dw1[2 * pp], ahi, bl[0], bl[1]);
        mma(dw1[2 * pp + 1], ahi, bl[2], bl[3]);
        mma(dw1[2 * pp], alo, bh[0], bh[1]);
        mma(dw1[2 * pp + 1], alo, bh[2], bh[3]);
      }
    }
    // 2d. dw2_c += hg^T g
#pragma unroll
    for (int s = 0; s < kRows / 16; ++s) {
      const int ao = (16 * s + b_row(lane)) * kHSS + 16 * m2 + b_col(lane);
      uint32_t ahi[4], alo[4];
      ldsm_t(ahi, hgh + ao);
      ldsm_t(alo, hgl + ao);
#pragma unroll
      for (int pp = 0; pp < kNW / 2; ++pp) {
        uint32_t bg[4];
        ldsm_t(bg, gs + (16 * s + bt_row(lane)) * kAS + 8 * nb2 + 16 * pp + bt_col(lane));
        mma(dw2[2 * pp], ahi, bg[0], bg[1]);
        mma(dw2[2 * pp + 1], ahi, bg[2], bg[3]);
        mma(dw2[2 * pp], alo, bg[0], bg[1]);
        mma(dw2[2 * pp + 1], alo, bg[2], bg[3]);
      }
    }
    // 2e. db1_c: the four row groups' column sums of dh, in order
    if (t < kHS) pb1[t] += ((db1w[t] + db1w[kHS + t]) + db1w[2 * kHS + t]) + db1w[3 * kHS + t];
    __syncthreads();   // hg and dh are read: the dyn part takes their place
    // 2f. this block's part of dyn for the cluster
    {
      const int rg = warp & 3, half = warp >> 2;
#pragma unroll
      for (int nt = 0; nt < kNW; ++nt) {
        const int col = (kD / 2) * half + 8 * nt + 2 * q;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(dynp + (16 * rg + g + 8 * i) * kFS + col) =
              make_float2(dacc[nt][2 * i], dacc[nt][2 * i + 1]);
      }
    }
    cluster.sync();   // every block's part of dyn is written

    // 3. the rest, for this block's rows: one warp per row, a warp's kRW rows
    //    side by side: dyn summed over the cluster in rank order, LN2's
    //    backward (dy1 = LN2'(dyn) + g), the attention backward (lane h:
    //    head h), LN1's backward and dx
    {
      float dy[kRW][kV], yh[kRW][kV], gv_[kRW][kV], st[2 * kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarps * i;
        float dn[kV], part_[kV], yv[kV];
        load_pairs(dn, cluster.map_shared_rank(dynp, 0) + (r0 + r) * kFS, lane);
#pragma unroll
        for (int c = 1; c < kC; ++c) {
          load_pairs(part_, cluster.map_shared_rank(dynp, c) + (r0 + r) * kFS, lane);
#pragma unroll
          for (int j = 0; j < kV; ++j) dn[j] += part_[j];
        }
        store_pairs(dys + r * kD, dn, lane);
        load_pairs(yv, y1s + r * kD, lane);
        load_pairs(gv_[i], gs + (r0 + r) * kAS, lane);
        st[2 * i] = st[2 * i + 1] = 0.f;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          yh[i][j] = (yv[j] - mu2[r]) * rs2[r];
          dy[i][j] = dn[j] * g2[col(lane, j)];
          st[2 * i] += dy[i][j];
          st[2 * i + 1] += dy[i][j] * yh[i][j];
        }
      }
      warp_sums(st);
      float dov[kRW * kHeads];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarps * i;
        const float a1 = st[2 * i] * (1.f / kD), a2 = st[2 * i + 1] * (1.f / kD);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) dov[i * kHeads + h] = 0.f;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          dy[i][j] = rs2[r] * (dy[i][j] - a1 - yh[i][j] * a2) + gv_[i][j];
#pragma unroll
          for (int h = 0; h < kHeads; ++h)
            dov[i * kHeads + h] += dy[i][j] * wo[h * kD + col(lane, j)];
        }
        store_pairs(dy1s + r * kD, dy[i], lane);
      }
      warp_sums(dov);
      float dqh[kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) dqh[i] = 0.f;
      if (lane < kHeads) {
        const float* kr = p.kexp + ((size_t)b * kHeads + lane) * kM;
        const float* vr = p.vexp + ((size_t)b * kHeads + lane) * kM;
        float gk[kM], gv[kM];
#pragma unroll
        for (int m = 0; m < kM; ++m) gk[m] = gv[m] = 0.f;
#pragma unroll
        for (int i = 0; i < kRW; ++i) {
          const int r = warp + kWarps * i;
          const float dv = pick(dov + i * kHeads, lane), qv = qs[r * kHeads + lane];
          float e[kM];
          const float den = softmax_tokens(qv, kr, e);
          const float dnum = dv / den;
          const float dden = -dv * os[r * kHeads + lane] / den;
          float dq = 0.f;
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            const float dd = e[m] * (dnum * __ldg(vr + m) + dden);
            dq += dd * __ldg(kr + m);
            gk[m] += qv * dd;
            gv[m] += e[m] * dnum;
          }
          dqh[i] = dq;
          dqs[r * kHeads + lane] = dq;
        }
        float* dst = dkv + warp * 2 * kHeads * kM + lane * kM;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          dst[m] = gk[m];
          dst[kHeads * kM + m] = gv[m];
        }
      }
      float dxh[kRW][kV];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarps * i;
        float dq[kHeads];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) dq[h] = __shfl_sync(0xffffffffu, dqh[i], h);
        st[2 * i] = st[2 * i + 1] = 0.f;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const int d = col(lane, j);
          float dxn = 0.f;
#pragma unroll
          for (int h = 0; h < kHeads; ++h) dxn += dq[h] * wq[h * kD + d];
          yh[i][j] = (__bfloat162float(xs[r * kD + perm[d]]) - mu1[r]) * rs1[r];   // x hat
          dxh[i][j] = dxn * g1[d];
          st[2 * i] += dxh[i][j];
          st[2 * i + 1] += dxh[i][j] * yh[i][j];
        }
      }
      warp_sums(st);
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + kWarps * i, n = n0 + r0 + r;
        if (n >= N) continue;
        const float a1 = st[2 * i] * (1.f / kD), a2 = st[2 * i + 1] * (1.f / kD);
        __nv_bfloat16* dxr = dx + ((size_t)b * N + n) * kD;
#pragma unroll
        for (int j = 0; j < kV; ++j)
          dxr[perm[col(lane, j)]] =
              __float2bfloat16(rs1[r] * (dxh[i][j] - a1 - yh[i][j] * a2) + dy[i][j]);
      }
    }
    __syncthreads();

    // column sums over this block's rows: db2, LN2's scale and bias, dbo, dwo
    // (threads 0 .. kD - 1), dwq and LN1's scale and bias (kD .. 2 kD - 1)
    if (t < kD) {
      float sg = 0.f, sdg = 0.f, sdb = 0.f, sbo = 0.f, swo[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) swo[h] = 0.f;
#pragma unroll 8
      for (int r = 0; r < kOwn; ++r) {
        const float dn = dys[r * kD + t], dyv = dy1s[r * kD + t];
        sg += __bfloat162float(gs[(r0 + r) * kAS + t]);
        sdg += dn * (y1s[r * kD + t] - mu2[r]) * rs2[r];
        sdb += dn;
        sbo += dyv;
        const float4 oa = *reinterpret_cast<const float4*>(os + r * kHeads);
        const float4 ob = *reinterpret_cast<const float4*>(os + r * kHeads + 4);
        const float o[kHeads] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
#pragma unroll
        for (int h = 0; h < kHeads; ++h) swo[h] += o[h] * dyv;
      }
      pb2[t] += sg;
      pln2g[t] += sdg;
      pln2b[t] += sdb;
      pbo[t] += sbo;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) pwo[h * kD + t] += swo[h];
    } else if (t < 2 * kD) {
      const int d = t - kD;
      float w[kHeads], sw[kHeads], sdg = 0.f, sdb = 0.f;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        w[h] = wq[h * kD + d];
        sw[h] = 0.f;
      }
      const float gd = g1[d], bd = be1[d];
      const int src = perm[d];
#pragma unroll 8
      for (int r = 0; r < kOwn; ++r) {
        const float xh = (__bfloat162float(xs[r * kD + src]) - mu1[r]) * rs1[r];
        const float xn = xh * gd + bd;
        const float4 qa = *reinterpret_cast<const float4*>(dqs + r * kHeads);
        const float4 qb = *reinterpret_cast<const float4*>(dqs + r * kHeads + 4);
        const float dq[kHeads] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        float dxn = 0.f;
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          dxn += dq[h] * w[h];
          sw[h] += xn * dq[h];
        }
        sdg += dxn * xh;
        sdb += dxn;
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h) pwq[d * kHeads + h] += sw[h];
      pln1g[d] += sdg;
      pln1b[d] += sdb;
    }
    if (t < 2 * kHeads * kM) {   // dkexp, dvexp: the warps' partials in order
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += dkv[w * 2 * kHeads * kM + t];
      float* dst = (t < kHeads * kM) ? dkexp : dvexp;
      atomicAdd(dst + (size_t)b * kHeads * kM + t % (kHeads * kM), v);
    }
  }
  cluster.sync();   // no block leaves while another still reads its dyn part

  // the block's record: dw1 columns, dw2 rows, then the small sums
  float* rec = slab + (size_t)blockIdx.x * L::kRec;
#pragma unroll
  for (int j = 0; j < kNW; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c1 = 8 * (nb1 + j) + 2 * q, row1 = 16 * m1 + g + 8 * i;
      *reinterpret_cast<float2*>(rec + row1 * kHS + c1) =
          make_float2(dw1[j][2 * i], dw1[j][2 * i + 1]);
      const int c2 = 8 * (nb2 + j) + 2 * q, row2 = 16 * m2 + g + 8 * i;
      *reinterpret_cast<float2*>(rec + kD * kHS + row2 * kD + c2) =
          make_float2(dw2[j][2 * i], dw2[j][2 * i + 1]);
    }
  for (int i = t; i < L::kPartFloats; i += kThreads) rec[2 * kD * kHS + i] = part[i];
}

template <int kD>
cudaLaunchConfig_t config(int ctas, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<kD>::kBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = Layout<kD>::kC;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// blocks of layer_bwd_tc<kD> in one full wave: clusters that fit at once x C
template <int kD>
cudaError_t wave_ctas(int* ctas) {
  static int cached = 0;
  if (cached == 0) {
    cudaError_t err = cudaFuncSetAttribute(layer_bwd_tc<kD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Layout<kD>::kBytes);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config<kD>(sms / Layout<kD>::kC * Layout<kD>::kC, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, layer_bwd_tc<kD>, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    cached = clusters * Layout<kD>::kC;
  }
  *ctas = cached;
  return cudaSuccess;
}

template <int kD>
cudaError_t launch(const void* x, const void* gy, void* dx, const void* w1, const void* w2,
                   void* slab, void* dkexp, void* dvexp, const Params& p, int B, int ctas,
                   int slab_floats, cudaStream_t stream) {
  using L = Layout<kD>;
  int wave = 0;
  cudaError_t err = wave_ctas<kD>(&wave);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((p.N + kRows - 1) / kRows);
  if (slab_floats != L::kRec || ctas % L::kC != 0 || ctas > wave || ctas / L::kC > tiles)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config<kD>(ctas, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, layer_bwd_tc<kD>, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(gy),
                           static_cast<__nv_bfloat16*>(dx),
                           static_cast<const __nv_bfloat16*>(w1),
                           static_cast<const __nv_bfloat16*>(w2), static_cast<float*>(slab),
                           static_cast<float*>(dkexp), static_cast<float*>(dvexp), p, B);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tcb

// ---- fp32 ------------------------------------------------------------------

template <int kD>
cudaError_t launch_fp32(const void* x, const void* gy, void* dx, void* slab, void* dkexp,
                        void* dvexp, const Params& p, int B, int blocks, int slab_floats,
                        cudaStream_t stream) {
  if (slab_floats != Slab<kD>::kSize) return cudaErrorInvalidValue;
  constexpr size_t kSmemBytes = Slab<kD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(xattn_layer_bwd_kernel<float, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  xattn_layer_bwd_kernel<float, kD><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gy), static_cast<float*>(dx),
      static_cast<float*>(slab), static_cast<float*>(dkexp), static_cast<float*>(dvexp), p, B);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_dtype(const void* x, const void* gy, void* dx, const void* w1,
                         const void* w2, void* slab, void* dkexp, void* dvexp, const Params& p,
                         int B, int blocks, int slab_floats, int is_bf16, cudaStream_t s) {
  return is_bf16 ? tcb::launch<kD>(x, gy, dx, w1, w2, slab, dkexp, dvexp, p, B, blocks,
                                   slab_floats, s)
                 : launch_fp32<kD>(x, gy, dx, slab, dkexp, dvexp, p, B, blocks, slab_floats, s);
}

}  // namespace

// x, gy, dx: (B, N, D) fp32 or bf16, contiguous; perm: (D,) int32 source lane
// per output lane, or null; weights as for xattn_layer_fwd (w1 and w2 bf16
// when x is). dkexp, dvexp: (B, h, M) fp32, zeroed. slab: (blocks,
// slab_floats) fp32. fp32: zeroed, one block's partial sums per row in the
// layout of Slab<D> above (slab_floats its kSize), blocks at most one per
// tile. bf16: written whole, one record per block in the layout of
// tcb::Layout<D>::kRec (slab_floats its size), blocks a multiple of the
// cluster size 2D / 64, at most one wave (xattn_layer_grid) and one cluster
// per 64-row tile. Built for h = 8, M = 8 and (D, hidden) = (128, 256) or
// (64, 128); other sizes return cudaErrorInvalidValue.
extern "C" int xattn_layer_bwd(const void* x, const void* gy, const void* perm,
                               const void* ln1_g, const void* ln1_b, const void* wq,
                               const void* kexp, const void* vexp, const void* wo,
                               const void* bo, const void* ln2_g, const void* ln2_b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* dx, void* slab, void* dkexp, void* dvexp, int B, int N,
                               int D, int heads, int M, int hidden, int blocks,
                               int slab_floats, int is_bf16, float eps, void* stream) {
  if (heads != kHeads || M != kM || hidden != 2 * D || N <= 0 || B <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.perm = static_cast<const int*>(perm);
  p.ln1_g = static_cast<const float*>(ln1_g);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.wq = static_cast<const float*>(wq);
  p.kexp = static_cast<const float*>(kexp);
  p.vexp = static_cast<const float*>(vexp);
  p.wo = static_cast<const float*>(wo);
  p.bo = static_cast<const float*>(bo);
  p.ln2_g = static_cast<const float*>(ln2_g);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.N = N;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 128)
    err = launch_dtype<128>(x, gy, dx, w1, w2, slab, dkexp, dvexp, p, B, blocks, slab_floats,
                            is_bf16, s);
  else if (D == 64)
    err = launch_dtype<64>(x, gy, dx, w1, w2, slab, dkexp, dvexp, p, B, blocks, slab_floats,
                           is_bf16, s);
  return static_cast<int>(err);
}

// F-bwd's part of xattn_layer_grid (xattn_layer.cu)
extern "C" int xattn_layer_bwd_grid(int D, int is_bf16, int* ctas, int* smem_bytes) {
  cudaError_t err = cudaSuccess;
  if (is_bf16) {
    err = D == 128 ? tcb::wave_ctas<128>(ctas) : tcb::wave_ctas<64>(ctas);
    *smem_bytes = (int)(D == 128 ? tcb::Layout<128>::kBytes : tcb::Layout<64>::kBytes);
  } else {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) == cudaSuccess)
      err = cudaDeviceGetAttribute(ctas, cudaDevAttrMultiProcessorCount, dev);
    *smem_bytes = (int)(D == 128 ? Slab<128>::kSmemBytes : Slab<64>::kSmemBytes);
  }
  return static_cast<int>(err);
}
