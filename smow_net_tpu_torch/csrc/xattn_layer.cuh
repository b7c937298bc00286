// Shared pieces of kernel F (xattn_layer.cu) and its backward
// (xattn_layer_bwd.cu): the sizes built into both, their parameters, and the
// forward steps the backward recomputes per row tile, so both run the same
// arithmetic in the same order.
#pragma once

#include "common.cuh"

namespace smow {
namespace xlayer {

// Widths built into both kernels: kD in {64, 128} (SMOW_Net_LW's and
// SMOW_Net's decoders), hidden = 2 kD; every function below takes kD as a
// template argument.
constexpr int kHeads = 8;
constexpr int kM = 8;         // memory tokens
constexpr int kTile = 64;     // pixel rows per block
constexpr int kChunk = 64;    // hidden units staged per step
constexpr int kThreads = 256;
template <int kD> constexpr int kHidden = 2 * kD;
template <int kD> constexpr int kRow = kD + 4;  // padded smem row stride (bank spread)

struct Params {
  const int* perm;
  const float *ln1_g, *ln1_b, *wq, *kexp, *vexp, *wo, *bo;
  const float *ln2_g, *ln2_b, *w1, *b1, *w2, *b2;
  int N;
  float eps;
};

// Rows n0 .. n0 + kTile of one batch's (N, kD) matrix into smem (stride
// kRow<kD>) as fp32, with the lane permutation as an index gather (dst[d] =
// src[perm[d]]); rows past N are zeros.
template <int kD, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, const int* __restrict__ perm,
                                          int n0, int N, float* dst) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, d = i % kD, n = n0 + r;
    float v = 0.f;
    if (n < N) v = to_float(src[(size_t)n * kD + (perm ? __ldg(perm + d) : d)]);
    dst[r * kRow<kD> + d] = v;
  }
}

// LayerNorm of kTile rows of `src` into `dst` (both smem, stride kRow<kD>), one
// warp per row, statistics E[x^2] - mu^2 as in the JAX package. Each row's
// mean and 1/sqrt(var + eps) go to mu[r], rs[r] when those are given.
template <int kD>
__device__ __forceinline__ void layer_norm_rows(const float* src, float* dst,
                                                const float* __restrict__ g,
                                                const float* __restrict__ b, float eps,
                                                float* mu_out = nullptr,
                                                float* rs_out = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTile; r += kThreads / 32) {
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
// the exps e[m] (shifted by the row max) and their sum, floored at 1e-30.
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

// q = LN1(x) wq for each (row, head) of the tile (ns: LN1 output), the
// attention output o = softmax . v into os (kTile, kHeads), q into qs when
// given.
template <int kD>
__device__ __forceinline__ void attention_rows(const float* ns, const Params& p, int b,
                                               float* os, float* qs = nullptr) {
  for (int i = threadIdx.x; i < kTile * kHeads; i += kThreads) {
    const int r = i / kHeads, hh = i % kHeads;
    float q = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) q += ns[r * kRow<kD> + d] * __ldg(p.wq + d * kHeads + hh);
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
template <int kD>
__device__ __forceinline__ void attention_out_rows(float* xs, const float* os, const Params& p) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
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

}  // namespace xlayer
}  // namespace smow
