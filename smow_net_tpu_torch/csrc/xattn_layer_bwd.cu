// Kernel F-bwd: the backward of the whole dim_head=1 pixel-decoder layer.
//
// Replaces `_layer_bwd_kernel` (via `_layer_vjp_bwd`) in
// smow_net_tpu/ops/pallas/xattn.py. Given the layer's inputs and the output
// cotangent g, per row of x (B, N, D) it recomputes the forward of kernel F
// (xattn_layer.cuh, same arithmetic) and runs
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
// What bounds it on the card: arithmetic. Per row it does five products of
// D x hidden (the MLP forward's first half, dhg, dyn, dw1, dw2), 164k FMAs,
// 86 GFLOP at the SMOW_Net shape (16 x 16384 rows, D = 128; a quarter of
// that at SMOW_Net_LW's D = 64), in fp32 on the CUDA cores (no tensor cores
// yet), against 201 MB of x, g and dx in bf16 (101 MB at D = 64).
//
// Design: the width D is a template argument (64 or 128, hidden = 2D).
// Blocks cannot carry sums across the grid, and fp32 dw1 + dw2 (256 KB at
// D = 128) do not fit a block's 227 KB of shared memory. So the grid is
// persistent, one block of 256 threads per SM, each walking a strided set
// of 64-row tiles and keeping its own fp32 partial sums in a slab of device
// memory (read, added to, written back per tile; the slabs together, 36 MB
// on 132 SMs at D = 128, stay in L2); the wrapper sums the slabs over blocks, a tiny
// torch reduction. dkexp and dvexp (64 values per batch) take fp32
// atomicAdd per tile. The hidden dimension streams in chunks of 64: each
// chunk stages its w1 columns and w2 rows in shared memory (rows padded to
// an odd stride so both orientations read without bank conflicts), forms h
// and dhg together, then adds dh w1^T into 4 x D/16 registers per thread and
// the chunk's dw1 and dw2 blocks into the slab. Rows past N load as zeros,
// which makes every contribution they add exactly zero, and are not stored.
// Weights arrive as fp32; only x, g and dx take the activation dtype.

#include "xattn_layer.cuh"

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
  float* ns = ys + kTile * kR;             // LN1(x), then LN2(y1), then the x tile again
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
    layer_norm_rows<kD>(ys, ns, p.ln1_g, p.ln1_b, p.eps, mu1, rs1);
    __syncthreads();
    attention_rows<kD>(ns, p, b, os, qs);
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

template <typename T, int kD>
cudaError_t launch(const void* x, const void* gy, void* dx, void* slab, void* dkexp,
                   void* dvexp, const Params& p, int B, int blocks, cudaStream_t stream) {
  constexpr size_t kSmemBytes = Slab<kD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(xattn_layer_bwd_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  xattn_layer_bwd_kernel<T, kD><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), static_cast<T*>(dx),
      static_cast<float*>(slab), static_cast<float*>(dkexp), static_cast<float*>(dvexp), p, B);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_dtype(const void* x, const void* gy, void* dx, void* slab, void* dkexp,
                         void* dvexp, const Params& p, int B, int blocks, int slab_floats,
                         int is_bf16, cudaStream_t s) {
  if (slab_floats != Slab<kD>::kSize) return cudaErrorInvalidValue;
  return is_bf16 ? launch<__nv_bfloat16, kD>(x, gy, dx, slab, dkexp, dvexp, p, B, blocks, s)
                 : launch<float, kD>(x, gy, dx, slab, dkexp, dvexp, p, B, blocks, s);
}

}  // namespace

// x, gy, dx: (B, N, D) fp32 or bf16, contiguous; perm: (D,) int32 source lane
// per output lane, or null; weights fp32 as for xattn_layer_fwd. slab:
// (blocks, slab_floats) fp32, zeroed, one block's partial sums each in the
// layout of Slab<D> above (slab_floats must equal its kSize); dkexp, dvexp:
// (B, h, M) fp32, zeroed. Built for h = 8, M = 8 and (D, hidden) = (128,
// 256) or (64, 128); other sizes return cudaErrorInvalidValue.
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
    err = launch_dtype<128>(x, gy, dx, slab, dkexp, dvexp, p, B, blocks, slab_floats, is_bf16, s);
  else if (D == 64)
    err = launch_dtype<64>(x, gy, dx, slab, dkexp, dvexp, p, B, blocks, slab_floats, is_bf16, s);
  return static_cast<int>(err);
}
