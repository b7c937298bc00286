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
// What bounds it on the card: arithmetic. The MLP (D -> 2D -> D) is about
// 98% of the FLOPs: 2 * 2 * D * hidden = 131k FLOP per pixel, 34 GFLOP at
// the SMOW_Net shape (16 x 16384 pixels, D = 128, hidden = 256; a quarter
// of that at SMOW_Net_LW's D = 64, hidden = 128), against 128 MB of x in
// and out in bf16 (64 MB at D = 64). This first version runs it in fp32 FMA
// on the CUDA cores (no tensor cores), so it is bound by FMA issue and
// shared-memory bandwidth; wgmma is later work.
//
// Design: one block of 256 threads owns a tile of 64 pixel rows; the width
// D is a template argument (64 or 128, hidden = 2D). The tile (after the
// index permutation) and its normalized copy live in shared memory as fp32;
// LN statistics are one warp per row, the 8 x 8 attention is one thread per
// (row, head). fp32 w1 and w2 (256 KB together at D = 128) exceed the 227
// KB a block may use, so the hidden dimension streams in chunks of 64: each
// chunk stages its w1 columns and w2 rows in shared memory, forms GELU(h)
// for the tile (4 x 4 outputs per thread) and accumulates h w2 into
// 4 x D/16 fp32 registers per thread. Rows past N (the ragged tail) are
// loaded as zeros and never stored. Weights arrive as fp32; only x and out take
// the activation dtype (fp32 or bf16), and all arithmetic is fp32.

#include "xattn_layer.cuh"

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

template <typename T, int kD>
cudaError_t launch(const void* x, void* out, const Params& p, int B, cudaStream_t stream) {
  constexpr size_t kSmemBytes = kSmemFloats<kD> * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(xattn_layer_fwd_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 blocks((p.N + kTile - 1) / kTile, B);
  xattn_layer_fwd_kernel<T, kD><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_dtype(const void* x, void* out, const Params& p, int B, int is_bf16,
                         cudaStream_t s) {
  return is_bf16 ? launch<__nv_bfloat16, kD>(x, out, p, B, s) : launch<float, kD>(x, out, p, B, s);
}

}  // namespace

// x, out: (B, N, D) fp32 or bf16, contiguous. perm: (D,) int32 source lane
// per output lane, or null. Weights fp32, contiguous, in (in, out) layout:
// wq (D, h), wo (h, D), w1 (D, hidden), w2 (hidden, D); kexp/vexp (B, h, M)
// with the softmax scale folded into kexp. Built for h = 8, M = 8 and
// (D, hidden) = (128, 256) (SMOW_Net's decoder) or (64, 128)
// (SMOW_Net_LW's); other sizes return cudaErrorInvalidValue.
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
    err = launch_dtype<128>(x, out, p, B, is_bf16, s);
  else if (D == 64)
    err = launch_dtype<64>(x, out, p, B, is_bf16, s);
  return static_cast<int>(err);
}
