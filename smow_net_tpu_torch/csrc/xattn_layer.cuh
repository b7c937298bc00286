// Shared pieces of kernel F (xattn_layer.cu) and its backward
// (xattn_layer_bwd.cu), and of kernel G (cross_attn.cu, the layer's attention
// sublayer alone) and its backward (cross_attn_bwd.cu): the sizes built into
// them, their parameters, and the forward steps the backward kernels
// recompute per row tile, so all four run the same arithmetic in the same
// order. The row-tile steps take the tile's row count kRows as a template
// argument (F's 64, kTile, by default; G's wider rows need fewer to fit a
// block's shared memory).
#pragma once

#include "common.cuh"

namespace smow {
namespace xlayer {

// Widths built into F and F-bwd: kD in {64, 128} (SMOW_Net_LW's and
// SMOW_Net's decoders), hidden = 2 kD; G and G-bwd take kD in {64, 128, 256,
// 384, 512}. Every function below takes kD as a template argument.
constexpr int kHeads = 8;
constexpr int kM = 8;         // memory tokens
constexpr int kTile = 64;     // pixel rows per block (F, F-bwd)
constexpr int kChunk = 64;    // hidden units staged per step
constexpr int kThreads = 256;
template <int kD> constexpr int kHidden = 2 * kD;
template <int kD> constexpr int kRow = kD + 4;  // padded smem row stride (bank spread)
// The first design's rows per tile in G and G-bwd: G-bwd's two (kRows, kRow)
// fp32 tiles take 67 KB at kD = 128 with 64 rows, and 132 KB at kD = 512
// with 32
template <int kD> constexpr int kAttnRows = kD >= 256 ? 32 : 64;

struct Params {
  const int* perm;
  const float *ln1_g, *ln1_b, *wq, *kexp, *vexp, *wo, *bo;
  const float *ln2_g, *ln2_b, *w1, *b1, *w2, *b2;
  int N;
  float eps;
};

// Rows n0 .. n0 + kRows of one batch's (N, kD) matrix into smem (stride
// kRow<kD>) as fp32, with the lane permutation as an index gather (dst[d] =
// src[perm[d]]); rows past N are zeros.
template <int kD, int kRows = kTile, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, const int* __restrict__ perm,
                                          int n0, int N, float* dst) {
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD, n = n0 + r;
    float v = 0.f;
    if (n < N) v = to_float(src[(size_t)n * kD + (perm ? __ldg(perm + d) : d)]);
    dst[r * kRow<kD> + d] = v;
  }
}

// LayerNorm of kRows rows of `src` into `dst` (both smem, stride kRow<kD>), one
// warp per row, statistics E[x^2] - mu^2 as in the JAX package (F's LN2).
// Each row's mean and 1/sqrt(var + eps) go to mu[r], rs[r] when those are
// given.
template <int kD, int kRows = kTile>
__device__ __forceinline__ void layer_norm_rows(const float* src, float* dst,
                                                const float* __restrict__ g,
                                                const float* __restrict__ b, float eps,
                                                float* mu_out = nullptr,
                                                float* rs_out = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float v[kD / 32];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      v[j] = src[r * kRow<kD> + lane + 32 * j];
      s += v[j];
      ss += v[j] * v[j];
    }
    const float mu = warp_sum(s) * (1.f / kD);
    const float rs = rsqrtf(warp_sum(ss) * (1.f / kD) - mu * mu + eps);
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      const int d = lane + 32 * j;
      dst[r * kRow<kD> + d] = (v[j] - mu) * rs * __ldg(g + d) + __ldg(b + d);
    }
    if (mu_out != nullptr && lane == 0) {
      mu_out[r] = mu;
      rs_out[r] = rs;
    }
  }
}

// Softmax over the M memory tokens of (row, head) with logits q * kexp[m]:
// the exps e[m] and their sum, floored at 1e-30. The shift is the max over
// this head's M logits, as the reference's softmax takes it (not the Pallas
// kernels' one max per row over all heads, under which a head whose logits lie
// far below another's underflows to o = 0); the sum is then >= 1.
__device__ __forceinline__ float softmax_tokens(float q, const float* __restrict__ kr,
                                                float (&e)[kM]) {
  float mx = q * __ldg(kr);
#pragma unroll
  for (int m = 1; m < kM; ++m) mx = fmaxf(mx, q * __ldg(kr + m));
  float den = 0.f;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    e[m] = expf(q * __ldg(kr + m) - mx);
    den += e[m];
  }
  return fmaxf(den, 1e-30f);
}

// LN1's statistics of kRows rows of `src` (smem, stride kRow<kD>), one warp
// per row, in float64 from the fp32 tile: st[2 r] = mu, st[2 r + 1] =
// 1/sqrt(E[x^2] - mu^2 + eps), the JAX package's statistics; each also to
// mu_out[r], rs_out[r] in fp32 when those are given (the backward's xhat).
template <int kD, int kRows = kTile>
__device__ __forceinline__ void ln_stats_rows(const float* src, float eps, double* st,
                                              float* mu_out = nullptr, float* rs_out = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    double s = 0.0, ss = 0.0;
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      const double v = src[r * kRow<kD> + lane + 32 * j];
      s += v;
      ss += v * v;
    }
    const double mu = warp_sum(s) * (1.0 / kD);
    const double rs = 1.0 / sqrt(warp_sum(ss) * (1.0 / kD) - mu * mu + eps);
    if (lane == 0) {
      st[2 * r] = mu;
      st[2 * r + 1] = rs;
      if (mu_out != nullptr) {
        mu_out[r] = (float)mu;
        rs_out[r] = (float)rs;
      }
    }
  }
}

// q = LN1(xc) wq for each (row, head) of the tile (xs: the xc tile; st: its
// statistics from ln_stats_rows), then the attention output o = softmax . v
// into os (kRows, kHeads), q into qs when given. LN1 and q run in float64 from
// the fp32 tile and weights and round once to fp32: where a head's keys are
// large, q kexp reaches ~1e3 and the gradient near a tie between two tokens
// moves with q's absolute error, which an fp32 LayerNorm and one serial fp32
// sum over D each put near or past 1e-4 of a leaf's largest element.
template <int kD, int kRows = kTile>
__device__ __forceinline__ void attention_rows(const float* xs, const double* st, const Params& p,
                                               int b, float* os, float* qs = nullptr) {
  for (int i = threadIdx.x; i < kRows * kHeads; i += kThreads) {
    const int r = i / kHeads, hh = i % kHeads;
    const double mu = st[2 * r], rs = st[2 * r + 1];
    double qd = 0.0;
#pragma unroll 8
    for (int d = 0; d < kD; ++d)
      qd += ((xs[r * kRow<kD> + d] - mu) * rs * __ldg(p.ln1_g + d) + __ldg(p.ln1_b + d)) *
            __ldg(p.wq + d * kHeads + hh);
    const float q = (float)qd;
    const float* vr = p.vexp + ((size_t)b * kHeads + hh) * kM;
    float e[kM];
    const float den = softmax_tokens(q, p.kexp + ((size_t)b * kHeads + hh) * kM, e);
    float num = 0.f;
#pragma unroll
    for (int m = 0; m < kM; ++m) num += e[m] * __ldg(vr + m);
    os[r * kHeads + hh] = num / den;
    if (qs != nullptr) qs[r * kHeads + hh] = q;
  }
}

// y1 = o wo + bo + xc, in place of the tile xs.
template <int kD, int kRows = kTile>
__device__ __forceinline__ void attention_out_rows(float* xs, const float* os, const Params& p) {
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    float acc = __ldg(p.bo + d) + xs[r * kRow<kD> + d];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) acc += os[r * kHeads + hh] * __ldg(p.wo + hh * kD + d);
    xs[r * kRow<kD> + d] = acc;
  }
}

__device__ __forceinline__ float gelu_cdf(float h) {
  return 0.5f * (1.f + erff(h * 0.70710678118654752f));
}

// Kernels G's and G-bwd's instantiations: f(TypeTag<T>, IntTag<kD>) for fp32
// or bf16 and kD in {64, 128, 256, 384, 512}; any other width is refused.
template <typename F>
cudaError_t dispatch_attn(int D, int is_bf16, F&& f) {
  auto widths = [&](auto t) -> cudaError_t {
    switch (D) {
      case 64: return f(t, IntTag<64>{});
      case 128: return f(t, IntTag<128>{});
      case 256: return f(t, IntTag<256>{});
      case 384: return f(t, IntTag<384>{});
      case 512: return f(t, IntTag<512>{});
      default: return cudaErrorInvalidValue;
    }
  };
  return is_bf16 ? widths(TypeTag<__nv_bfloat16>{}) : widths(TypeTag<float>{});
}

}  // namespace xlayer
}  // namespace smow
