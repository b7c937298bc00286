// The forward prefix that kernel G's bf16 body (cross_attn.cu
// `cross_attn_fwd_tc`) computes and kernel G-bwd's bf16 body
// (cross_attn_bwd.cu `cross_attn_bwd_tc`) recomputes, at D = 64 and 128, on
// a warp's 16-row tile in the accumulator layout of `mma.sync` (lane (g, q):
// rows g and g + 8, columns 8 nt + 2q and 8 nt + 2q + 1 of each 8-wide n-tile
// nt, heads 2q and 2q + 1): LN1's statistics, q = LN1(xc) wq and the per-head
// softmax over the M tokens. Both kernels call these functions, so G's q and
// o are the bits G-bwd's recompute forms. Each takes the tile's xc values
// through an accessor, xc(nt) -> a float4 of rows g (x, y) and g + 8 (z, w)
// at columns 8 nt + 2q, 8 nt + 2q + 1 (G holds them in registers, G-bwd
// reads its shared tile).
#pragma once

#include "xattn_layer_tc.cuh"

namespace smow {
namespace xlayer {
namespace tca {

using namespace smow::xlayer::tc;

constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 16;   // rows of a warp's tile
// floats a row of the staged wq: the 8 heads and 4 of padding, so that the
// four columns a quad's lanes read at once fall on four different groups of
// banks (at a stride of 8 floats lanes q and q + 2 met on the same banks:
// G and G-bwd each ran ~12% longer, NVIDIA H100 80GB HBM3 at 700 W)
constexpr int kWqS = kHeads + 4;

__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  return as_u32(__floats2bfloat162_rn(a, b));
}

// The block's copy of what the prefix reads: wq (kD, 8) in fp32 at its bf16
// values (rows kWqS floats apart), LN1's scale and bias, the permutation's
// source lanes (identity without one). By all kThreads threads; the caller
// syncs.
template <int kD>
__device__ __forceinline__ void stage_prefix(const Params& p, float* wq32, float* g1, float* be1,
                                             int* perm) {
  for (int i = threadIdx.x; i < kD * kHeads; i += kThreads)
    wq32[(i / kHeads) * kWqS + i % kHeads] = bf16_value(p.wq[i]);
  for (int i = threadIdx.x; i < kD; i += kThreads) {
    g1[i] = p.ln1_g[i];
    be1[i] = p.ln1_b[i];
    perm[i] = p.perm ? p.perm[i] : i;
  }
}

// LN1's statistics of rows g (i = 0) and g + 8 (i = 1): a quad holds a row
template <int kD, typename XC>
__device__ __forceinline__ void row_stats(XC&& xc, float eps, float (&mu)[2], float (&rs)[2]) {
  float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const float4 v = xc(nt);
    s[0] += v.x + v.y;
    ss[0] += v.x * v.x + v.y * v.y;
    s[1] += v.z + v.w;
    ss[1] += v.z * v.z + v.w * v.w;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], o);
    }
    mu[i] = s[i] * (1.f / kD);
    rs[i] = rsqrtf(ss[i] * (1.f / kD) - mu[i] * mu[i] + eps);
  }
}

// q = LN1(xc) wq in fp32 on the CUDA cores: this lane's columns, then the
// quad's sum (where a head's keys are large, q kexp reaches ~1e3, and a
// hi/lo split's 2^-17 of q would move that head's softmax past the bound).
// on_xhat(i, col, h0, h1) sees each pair of xhat values on the way. Element
// c of qa: row g + 8 (c >> 1), head 2q + (c & 1).
template <int kD, typename XC, typename XH>
__device__ __forceinline__ void head_queries(XC&& xc, XH&& on_xhat, const float (&mu)[2],
                                             const float (&rs)[2], const float* wq32,
                                             const float* g1, const float* be1, int q,
                                             float (&qa)[4]) {
  float qp[2][kHeads];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < kHeads; ++h) qp[i][h] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int col = 8 * nt + 2 * q;
    const float4 v = xc(nt);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float h0 = ((i ? v.z : v.x) - mu[i]) * rs[i];
      const float h1 = ((i ? v.w : v.y) - mu[i]) * rs[i];
      on_xhat(i, col, h0, h1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xn = (e ? h1 : h0) * g1[col + e] + be1[col + e];
        const float4 wa = *reinterpret_cast<const float4*>(wq32 + (col + e) * kWqS);
        const float4 wb = *reinterpret_cast<const float4*>(wq32 + (col + e) * kWqS + 4);
        const float w[kHeads] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int h = 0; h < kHeads; ++h) qp[i][h] += xn * w[h];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      qp[i][h] += __shfl_xor_sync(0xffffffffu, qp[i][h], 1);
      qp[i][h] += __shfl_xor_sync(0xffffffffu, qp[i][h], 2);
    }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = c >> 1, e = c & 1;
    float v = qp[i][e];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (q == k) v = qp[i][2 * k + e];
    qa[c] = v;
  }
}

// head hh's folded keys kexp and values of batch b
__device__ __forceinline__ void head_tokens(const Params& p, int b, int hh, float (&kr)[kM],
                                            float (&vr)[kM]) {
  const size_t at = ((size_t)b * kHeads + hh) * kM;
  const float4* kp = reinterpret_cast<const float4*>(p.kexp + at);
  const float4* vp = reinterpret_cast<const float4*>(p.vexp + at);
  const float4 k0 = __ldg(kp), k1 = __ldg(kp + 1), v0 = __ldg(vp), v1 = __ldg(vp + 1);
  kr[0] = k0.x; kr[1] = k0.y; kr[2] = k0.z; kr[3] = k0.w;
  kr[4] = k1.x; kr[5] = k1.y; kr[6] = k1.z; kr[7] = k1.w;
  vr[0] = v0.x; vr[1] = v0.y; vr[2] = v0.z; vr[3] = v0.w;
  vr[4] = v1.x; vr[5] = v1.y; vr[6] = v1.z; vr[7] = v1.w;
}

// the softmax of logits qv * kr over the M tokens with this head's own shift
// (`softmax_tokens`' contract): the exps ev, their sum den (floored at
// 1e-30), and the output o = sum ev vr / den
__device__ __forceinline__ float softmax_o(float qv, const float (&kr)[kM], const float (&vr)[kM],
                                           float (&ev)[kM], float& den) {
  float mx = qv * kr[0];
#pragma unroll
  for (int m = 1; m < kM; ++m) mx = fmaxf(mx, qv * kr[m]);
  float sum = 0.f, num = 0.f;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    ev[m] = expf(qv * kr[m] - mx);
    sum += ev[m];
  }
  den = fmaxf(sum, 1e-30f);
#pragma unroll
  for (int m = 0; m < kM; ++m) num += ev[m] * vr[m];
  return num / den;
}

}  // namespace tca
}  // namespace xlayer
}  // namespace smow
