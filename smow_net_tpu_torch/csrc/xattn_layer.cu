// Kernel F: the whole dim_head=1 pixel-decoder layer, forward.
//
// Replaces `cross_layer_head1_pallas` / `_layer_fwd_kernel` (via
// `_layer_core`) in smow_net_tpu/ops/pallas/xattn.py: the reference
// TransformerDecoder layer (models/SMOW_Net.py:285-303) over x (B, N, D)
// pixel queries against M memory tokens, per row
//   xc   = x[perm]                 optional lane permutation (index gather)
//   q    = LN1(xc) wq              D -> h heads of width 1
//   o_h  = softmax_m(q_h k[h, m] scale) . v[h, :]      per (pixel, head)
//   y1   = o wo + bo + xc
//   out  = GELU(LN2(y1) w1 + b1) w2 + b2 + y1           exact erf GELU
// with one read of x and one write of out.
//
// What bounds it on the card: the MLP (D -> 2D -> D), about 98% of the
// FLOPs: 2 * 2 * D * hidden = 131k FLOP per pixel, 34 GFLOP at the SMOW_Net
// shape (16 x 16384 pixels, D = 128, hidden = 256; a quarter of that at
// SMOW_Net_LW's D = 64). On bf16 tensor cores that is 0.035 ms, under the
// 0.040 ms that 128 MB of x in and out take at 3.35 TB/s: the bytes bound
// the call, if the products run on tensor cores and the rest keeps up.
//
// bf16 design (`layer_fwd_tc`): the TPU kernel runs both products on the MXU;
// here they run on the tensor cores through `mma.sync.m16n8k16` with
// `ldmatrix` (xattn_layer_tc.cuh). Not `wgmma`: a warpgroup product wants
// its A operand from shared memory or from one warpgroup's registers, 64
// rows deep, and a 16-row tile per warp lets every warp run its rows alone,
// from registers, with no barrier between warps after the weights are
// staged. Each persistent block (one per SM: 215 KB of shared memory at D =
// 128, and over 128 registers a thread at both widths) stages w1 and w2 in
// bf16 once, rows padded by 16 bytes so
// `ldmatrix.trans` reads them without bank conflicts, and its 8 warps each
// walk their own 16-row tiles, the next tile's rows streaming in through
// `cp.async` into the warp's second buffer while the current one computes.
// A warp holds its 16 rows in the accumulator layout of the products: LN1,
// q = LN1(xc) wq (D x 8), the 8 x 8 softmax, y1 = o wo + bo + xc and LN2 run
// on the CUDA cores in fp32 on those registers (one shift per (pixel,
// head), `softmax_tokens`); LN2(y1), split into bf16 hi + lo, is the A
// operand of h = LN2(y1) w1 without a trip through shared memory, and y1 +
// b2 is the initial value of the output accumulators. The hidden dimension
// goes 16 units at a time: h's accumulators take b1 and the exact GELU,
// are split again into hi + lo and are the A operand of out += GELU(h) w2.
// The hi/lo split holds an fp32 operand to about 2^-17 of the
// product, so the result is the fp32 layer's rounded once to bf16, as the
// bound on it (2^-8 of the largest element) asks; 4 MMAs per 16 x 16 x 16
// step pair instead of 2. The wrapper hands w1 and w2 as bf16 and the other
// weights at their bf16 values, as the plain version rounds them. Rows past N
// load as zeros (the `cp.async` zero fill) and are not stored; the output
// goes back through the tile's buffer as 16-byte rows.
//
// fp32 (`xattn_layer_fwd_kernel`, the port's first design, kept for the
// fp32 checks and fp32 models): one block of 256 threads owns a tile of 64
// rows in fp32 shared memory; LN statistics one warp per row, the 8 x 8
// attention one thread per (row, head); fp32 w1 and w2 (256 KB at D = 128)
// stream through shared memory 64 hidden units at a time, the MLP in fp32
// FMA on the CUDA cores (4 x 4 outputs per thread), all arithmetic fp32.

#include <algorithm>

#include "xattn_layer_tc.cuh"

namespace {


using namespace smow::xlayer;
using smow::from_float;

constexpr int kHRow = kChunk + 4;
template <int kD>
constexpr int kSmemFloats =
    2 * kTile * kRow<kD> + kD * kChunk + kChunk * kD + kTile * kHRow + kTile * kHeads;
static_assert(kThreads == 256 && kTile == 64 && kChunk == 64,
              "the register tiling below assumes these sizes");

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
xattn_layer_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, Params p) {
  static_assert(kD == 64 || kD == 128, "the register tiling assumes D = 64 or 128");
  constexpr int kR = kRow<kD>;
  constexpr int kCols = kD / 16;           // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                        // x tile, later y1
  float* ns = xs + kTile * kR;             // LN1(x), later LN2(y1)
  float* w1s = ns + kTile * kR;            // (kD, kChunk)
  float* w2s = w1s + kD * kChunk;          // (kChunk, kD)
  float* hs = w2s + kChunk * kD;           // (kTile, kHRow) GELU(h) chunk
  float* os = hs + kTile * kHRow;          // (kTile, kHeads) attention output

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  const int N = p.N;
  const T* xb = x + (size_t)b * N * kD;

  // 1. load the tile, applying the permutation as an index gather
  load_tile<kD>(xb, p.perm, n0, N, xs);
  __syncthreads();

  // 2. LN1
  layer_norm_rows<kD>(xs, ns, p.ln1_g, p.ln1_b, p.eps);
  __syncthreads();

  // 3. q and the per-(row, head) softmax over the M memory tokens
  attention_rows<kD>(ns, p, b, os);
  __syncthreads();

  // 4. y1 = o wo + bo + xc, in place of the tile
  attention_out_rows<kD>(xs, os, p);
  __syncthreads();

  // 5. LN2
  layer_norm_rows<kD>(xs, ns, p.ln2_g, p.ln2_b, p.eps);

  // 6. MLP, hidden streamed in chunks: thread (ty, tx) owns rows ty*4..+3,
  //    GELU columns tx*4..+3 of a chunk, and output columns q*64 + tx*4..+3
  //    for q < kD/64 (acc[i][q*4 + j])
  const int ty = t / 16, tx = t % 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < kHidden<kD>; c0 += kChunk) {
    __syncthreads();   // LN2 written / previous chunk's smem reads done
    for (int i = t; i < kD * kChunk / 4; i += kThreads) {
      const int k = i / (kChunk / 4), j4 = i % (kChunk / 4);
      reinterpret_cast<float4*>(w1s)[i] =
          __ldg(reinterpret_cast<const float4*>(p.w1 + (size_t)k * kHidden<kD> + c0) + j4);
    }
    for (int i = t; i < kChunk * kD / 4; i += kThreads)
      reinterpret_cast<float4*>(w2s)[i] =
          __ldg(reinterpret_cast<const float4*>(p.w2 + (size_t)c0 * kD) + i);
    __syncthreads();

    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kD; ++k) {
      const float4 bv = reinterpret_cast<const float4*>(w1s + k * kChunk)[tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = ns[(ty * 4 + i) * kR + k];
        h[i][0] += av * bv.x;
        h[i][1] += av * bv.y;
        h[i][2] += av * bv.z;
        h[i][3] += av * bv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float hp = h[i][j] + __ldg(p.b1 + c0 + tx * 4 + j);
        hs[(ty * 4 + i) * kHRow + tx * 4 + j] = hp * gelu_cdf(hp);
      }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float4 bq[kD / 64];
#pragma unroll
      for (int q = 0; q < kD / 64; ++q)
        bq[q] = reinterpret_cast<const float4*>(w2s + k * kD + q * 64)[tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = hs[(ty * 4 + i) * kHRow + k];
#pragma unroll
        for (int q = 0; q < kD / 64; ++q) {
          acc[i][q * 4 + 0] += av * bq[q].x;
          acc[i][q * 4 + 1] += av * bq[q].y;
          acc[i][q * 4 + 2] += av * bq[q].z;
          acc[i][q * 4 + 3] += av * bq[q].w;
        }
      }
    }
  }

  // 7. out = h w2 + b2 + y1 (rows past N are not stored)
  T* ob = out + (size_t)b * N * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, n = n0 + r;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = (j / 4) * 64 + tx * 4 + j % 4;
      ob[(size_t)n * kD + d] = from_float<T>(acc[i][j] + __ldg(p.b2 + d) + xs[r * kR + d]);
    }
  }
}


// ---- bf16: tensor cores ----------------------------------------------------

namespace tcf {

using namespace smow::xlayer::tc;

constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 16;   // rows of a warp's tile

template <int kD>
struct Layout {
  static constexpr int kHid = 2 * kD;
  static constexpr int kW1S = kHid + kPad;   // w1 (kD, kHid), row stride
  static constexpr int kW2S = kD + kPad;     // w2 (kHid, kD)
  static constexpr int kXS = kD + kPad;      // a warp's x / out tile (16, kD), two per warp
  static constexpr size_t kOffW1 = 0;
  static constexpr size_t kOffW2 = kOffW1 + sizeof(__nv_bfloat16) * kD * kW1S;
  static constexpr size_t kOffX = kOffW2 + sizeof(__nv_bfloat16) * kHid * kW2S;
  static constexpr size_t kOffP = kOffX + sizeof(__nv_bfloat16) * kWarps * 2 * kWarpRows * kXS;
  // fp32: ln1_g, ln1_b, ln2_g, ln2_b, bo, b2 (kD each), b1 (kHid), wq (kD, 8), wo (8, kD)
  static constexpr int kPFloats = 6 * kD + kHid + 2 * kHeads * kD;
  static constexpr size_t kOffPerm = kOffP + sizeof(float) * kPFloats;
  static constexpr size_t kBytes = kOffPerm + sizeof(int) * kD;
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
layer_fwd_tc(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
             const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
             Params p, int B) {
  static_assert(kD == 64 || kD == 128, "built for D = 64 and 128");
  using L = Layout<kD>;
  constexpr int kHid = L::kHid, kXS = L::kXS;
  constexpr int kNT = kD / 8;     // 8-wide n-tiles of a row
  constexpr int kKS = kD / 16;    // 16-deep k-steps over D
  constexpr int kChunks = kD / 8; // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem[];
  auto* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffW1);
  auto* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffW2);
  float* g1 = reinterpret_cast<float*>(smem + L::kOffP);
  float *be1 = g1 + kD, *g2 = be1 + kD, *be2 = g2 + kD, *bo = be2 + kD, *b2 = bo + kD;
  float *b1 = b2 + kD, *wq = b1 + kHid, *wo = wq + kHeads * kD;
  int* perm = reinterpret_cast<int*>(smem + L::kOffPerm);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int N = p.N;
  const int tiles_per_b = (N + kWarpRows - 1) / kWarpRows, n_tiles = B * tiles_per_b;
  const int stride = gridDim.x * kWarps;
  __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffX) +
                      warp * 2 * kWarpRows * kXS;

  // the weights, once per block
  stage_bf16(w1s, L::kW1S, w1, kHid, kD, kHid, t, kThreads);
  stage_bf16(w2s, L::kW2S, w2, kD, kHid, kD, t, kThreads);
  for (int i = t; i < kD; i += kThreads) {
    g1[i] = p.ln1_g[i];
    be1[i] = p.ln1_b[i];
    g2[i] = p.ln2_g[i];
    be2[i] = p.ln2_b[i];
    bo[i] = p.bo[i];
    b2[i] = p.b2[i];
    perm[i] = p.perm ? p.perm[i] : i;
  }
  for (int i = t; i < kHid; i += kThreads) b1[i] = p.b1[i];
  for (int i = t; i < kHeads * kD; i += kThreads) {
    wq[i] = p.wq[i];
    wo[i] = p.wo[i];
  }

  // a tile's 16 rows into one of the warp's two buffers (zeros past N)
  auto load = [&](int tile, int buf) {
    const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * kWarpRows;
    const __nv_bfloat16* src = x + ((size_t)b * N + n0) * kD;
    __nv_bfloat16* dst = xw + buf * kWarpRows * kXS;
    for (int i = lane; i < kWarpRows * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = n0 + r < N;
      cp_async16(dst + r * kXS + c, ok ? src + (size_t)r * kD + c : x, ok);
    }
  };

  int tile = blockIdx.x * kWarps + warp;
  if (tile < n_tiles) load(tile, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int it = 0; tile < n_tiles; tile += stride, ++it) {
    const int buf = it & 1;
    if (tile + stride < n_tiles) load(tile + stride, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * kWarpRows;
    __nv_bfloat16* xt = xw + buf * kWarpRows * kXS;

    // xc in the accumulator layout: v[nt] holds (g, c), (g, c + 1), (g + 8,
    // c), (g + 8, c + 1) for c = 8 nt + 2q
    float v[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int2 src = *reinterpret_cast<const int2*>(perm + nt * 8 + 2 * q);
      v[nt][0] = __bfloat162float(xt[g * kXS + src.x]);
      v[nt][1] = __bfloat162float(xt[g * kXS + src.y]);
      v[nt][2] = __bfloat162float(xt[(g + 8) * kXS + src.x]);
      v[nt][3] = __bfloat162float(xt[(g + 8) * kXS + src.y]);
    }
    // statistics of rows g (i = 0) and g + 8 (i = 1): a quad holds a row
    auto row_stats = [&](float (&mu)[2], float (&rs)[2]) {
      float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[c >> 1] += v[nt][c];
          ss[c >> 1] += v[nt][c] * v[nt][c];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
          ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], o);
        }
        mu[i] = s[i] * (1.f / kD);
        rs[i] = rsqrtf(ss[i] * (1.f / kD) - mu[i] * mu[i] + p.eps);
      }
    };
    float mu[2], rs[2];
    row_stats(mu, rs);

    // q = LN1(xc) wq: this lane's columns, then the quad's sum
    float qv[2][kHeads];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < kHeads; ++h) qv[i][h] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * q + e;
        const float4 wa = *reinterpret_cast<const float4*>(wq + col * kHeads);
        const float4 wb = *reinterpret_cast<const float4*>(wq + col * kHeads + 4);
        const float w[kHeads] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float xn = (v[nt][2 * i + e] - mu[i]) * rs[i] * g1[col] + be1[col];
#pragma unroll
          for (int h = 0; h < kHeads; ++h) qv[i][h] += xn * w[h];
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        qv[i][h] += __shfl_xor_sync(0xffffffffu, qv[i][h], 1);
        qv[i][h] += __shfl_xor_sync(0xffffffffu, qv[i][h], 2);
      }

    // softmax over the M tokens: lane q takes heads 2q, 2q + 1 of both rows,
    // then the quad shares the 8 heads' outputs
    float om[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float qh = qv[i][e];
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (q == k) qh = qv[i][2 * k + e];
        const int hh = 2 * q + e;
        const float* vr = p.vexp + ((size_t)b * kHeads + hh) * kM;
        float ev[kM];
        const float den = softmax_tokens(qh, p.kexp + ((size_t)b * kHeads + hh) * kM, ev);
        float num = 0.f;
#pragma unroll
        for (int m = 0; m < kM; ++m) num += ev[m] * __ldg(vr + m);
        om[i][e] = num / den;
      }
    float o[2][kHeads];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
        o[i][h] = __shfl_sync(0xffffffffu, om[i][h & 1], (lane & ~3) | (h >> 1));

    // y1 = o wo + bo + xc, in place
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * q + e;
        float w[kHeads];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) w[h] = wo[h * kD + col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float acc = bo[col] + v[nt][2 * i + e];
#pragma unroll
          for (int h = 0; h < kHeads; ++h) acc += o[i][h] * w[h];
          v[nt][2 * i + e] = acc;
        }
      }

    // LN2(y1) as the A operand (hi, lo) of the first product; y1 + b2 as the
    // output accumulators
    row_stats(mu, rs);
    uint32_t ah[kKS][4], al[kKS][4];
#pragma unroll
    for (int s = 0; s < kKS; ++s)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * s + u, col = nt * 8 + 2 * q;
        float yn[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          yn[c] = (v[nt][c] - mu[c >> 1]) * rs[c >> 1] * g2[col + (c & 1)] + be2[col + (c & 1)];
        split2(yn[0], yn[1], ah[s][2 * u], al[s][2 * u]);
        split2(yn[2], yn[3], ah[s][2 * u + 1], al[s][2 * u + 1]);
      }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[nt][c] += b2[nt * 8 + 2 * q + (c & 1)];

    // the MLP, 16 hidden units at a time
#pragma unroll 1
    for (int hc = 0; hc < kHid / 16; ++hc) {
      float hacc[2][4] = {};
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        uint32_t r[4];
        ldsm_t(r, w1s + (16 * s + bt_row(lane)) * L::kW1S + 16 * hc + bt_col(lane));
        mma(hacc[0], ah[s], r[0], r[1]);
        mma(hacc[1], ah[s], r[2], r[3]);
        mma(hacc[0], al[s], r[0], r[1]);
        mma(hacc[1], al[s], r[2], r[3]);
      }
      uint32_t hh[4], hl[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 16 * hc + 8 * u + 2 * q;
        float hg[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float hp = hacc[u][c] + b1[col + (c & 1)];
          hg[c] = hp * gelu_cdf(hp);
        }
        split2(hg[0], hg[1], hh[2 * u], hl[2 * u]);
        split2(hg[2], hg[3], hh[2 * u + 1], hl[2 * u + 1]);
      }
#pragma unroll
      for (int pu = 0; pu < kD / 16; ++pu) {
        uint32_t r[4];
        ldsm_t(r, w2s + (16 * hc + bt_row(lane)) * L::kW2S + 16 * pu + bt_col(lane));
        mma(v[2 * pu], hh, r[0], r[1]);
        mma(v[2 * pu + 1], hh, r[2], r[3]);
        mma(v[2 * pu], hl, r[0], r[1]);
        mma(v[2 * pu + 1], hl, r[2], r[3]);
      }
    }

    // out: through the tile's buffer (every lane's reads of it are done) as
    // 16-byte rows; rows past N are not stored
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = nt * 8 + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(xt + g * kXS + col) =
          __floats2bfloat162_rn(v[nt][0], v[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(xt + (g + 8) * kXS + col) =
          __floats2bfloat162_rn(v[nt][2], v[nt][3]);
    }
    __syncwarp();
    __nv_bfloat16* dst = out + ((size_t)b * N + n0) * kD;
    for (int i = lane; i < kWarpRows * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (n0 + r < N)
        *reinterpret_cast<uint4*>(dst + (size_t)r * kD + c) =
            *reinterpret_cast<const uint4*>(xt + r * kXS + c);
    }
    __syncwarp();
  }
}

// resident blocks of layer_fwd_tc<kD> on the current device, all SMs
template <int kD>
cudaError_t resident_blocks(int* blocks) {
  static int cached = 0;
  cudaError_t err = tc::resident_blocks(layer_fwd_tc<kD>, Layout<kD>::kBytes, &cached);
  *blocks = cached;
  return err;
}

template <int kD>
cudaError_t launch(const void* x, void* out, const void* w1, const void* w2, const Params& p,
                   int B, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = resident_blocks<kD>(&resident);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((p.N + kWarpRows - 1) / kWarpRows);
  const int blocks = (int)std::min<long long>(resident, (tiles + kWarps - 1) / kWarps);
  layer_fwd_tc<kD><<<blocks, kThreads, Layout<kD>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), p, B);
  return cudaGetLastError();
}

}  // namespace tcf

// ---- fp32 ------------------------------------------------------------------

template <int kD>
cudaError_t launch_fp32(const void* x, void* out, const Params& p, int B, cudaStream_t stream) {
  constexpr size_t kSmemBytes = kSmemFloats<kD> * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(xattn_layer_fwd_kernel<float, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 blocks((p.N + kTile - 1) / kTile, B);
  xattn_layer_fwd_kernel<float, kD><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), p);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_dtype(const void* x, void* out, const void* w1, const void* w2,
                         const Params& p, int B, int is_bf16, cudaStream_t s) {
  return is_bf16 ? tcf::launch<kD>(x, out, w1, w2, p, B, s) : launch_fp32<kD>(x, out, p, B, s);
}

}  // namespace

// x, out: (B, N, D) fp32 or bf16, contiguous. perm: (D,) int32 source lane
// per output lane, or null. Weights contiguous, in (in, out) layout: wq (D,
// h), wo (h, D), w1 (D, hidden), w2 (hidden, D); kexp/vexp (B, h, M) with
// the softmax scale folded into kexp; all fp32, except w1 and w2 in bf16
// when x is bf16. Built for h = 8, M = 8 and (D, hidden) = (128, 256)
// (SMOW_Net's decoder) or (64, 128) (SMOW_Net_LW's); other sizes return
// cudaErrorInvalidValue.
extern "C" int xattn_layer_fwd(const void* x, const void* perm, const void* ln1_g,
                               const void* ln1_b, const void* wq, const void* kexp,
                               const void* vexp, const void* wo, const void* bo,
                               const void* ln2_g, const void* ln2_b, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* out,
                               int B, int N, int D, int heads, int M, int hidden, int is_bf16,
                               float eps, void* stream) {
  if (heads != kHeads || M != kM || hidden != 2 * D || N <= 0 || B <= 0)
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
    err = launch_dtype<128>(x, out, w1, w2, p, B, is_bf16, s);
  else if (D == 64)
    err = launch_dtype<64>(x, out, w1, w2, p, B, is_bf16, s);
  return static_cast<int>(err);
}

// Kernel F's (bwd = 0) or F-bwd's (bwd = 1) residency for the width and
// dtype: *ctas, the blocks of one full wave on the current device (F-bwd's
// bf16 kernel: its thread-block clusters that fit at once, times the cluster
// size; its fp32 kernel: one block per SM), *smem_bytes, a block's shared
// memory.
extern "C" int xattn_layer_bwd_grid(int D, int is_bf16, int* ctas, int* smem_bytes);

extern "C" int xattn_layer_grid(int D, int is_bf16, int bwd, int* ctas, int* smem_bytes) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (bwd) return xattn_layer_bwd_grid(D, is_bf16, ctas, smem_bytes);
  cudaError_t err = cudaSuccess;
  if (is_bf16) {
    err = D == 128 ? tcf::resident_blocks<128>(ctas) : tcf::resident_blocks<64>(ctas);
    *smem_bytes = (int)(D == 128 ? tcf::Layout<128>::kBytes : tcf::Layout<64>::kBytes);
  } else {
    // one block per 64-row tile, not persistent: report one wave of them
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *ctas = sms;
    *smem_bytes = (int)((D == 128 ? kSmemFloats<128> : kSmemFloats<64>) * sizeof(float));
  }
  return static_cast<int>(err);
}
