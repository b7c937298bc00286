// Kernel G-bwd: the backward of the dim_head=1 pixel cross-attention
// sublayer (kernel G, cross_attn.cu).
//
// Replaces `_vjp_bwd` / `_bwd_kernel` (over `_attn_core`) in
// smow_net_tpu/ops/pallas/xattn.py. Given the sublayer's inputs and the
// output cotangent g, per row of x (B, N, D) it recomputes G's forward up to
// the attention output (xattn_layer.cuh, the same arithmetic) and runs the
// attention half of kernel F-bwd with dy1 = g:
//   do = g wo^T, dnum = do / den, dden = -do o / den,
//   dd_m = e_m (dnum v_m + dden), dq = sum_m dd_m kexp_m,
//   dxn = dq wq^T, LN backward (biased variance) + g -> dxc,
//   dx[perm[d]] = dxc[d]
// and the reductions over rows: dwq = xn^T dq, the LayerNorm scale and bias
// (sum dxn xhat, sum dxn), dwo = o^T g, dbo = sum g, and per batch
// dkexp = sum q dd, dvexp = sum e dnum. Only the inputs are saved for it.
//
// What bounds it on the card: bytes. Per row it reads x and g and writes dx
// (6 D bytes in bf16) and does ~10 D h FLOP: at SMOW_Net's decoder shape (16
// x 16384 pixels, D = 128) 201 MB, 0.060 ms at 3.35 TB/s.
//
// Design: the width D is a template argument (64 to 512), the tile
// kAttnRows<D> rows (64, or 32 at D >= 256). Unlike F-bwd's, the sums over
// rows are small, 19 D floats (39 KB at D = 512), so they stay in registers:
// the grid is persistent (two blocks of 256 threads per SM, each walking a
// strided set of tiles), thread t owns columns t % S + S j (S = min(D, 256))
// and, where D < 256, every (256 / D)-th row of a tile, and adds each tile's
// rows into its registers. At the end the block reduces its threads' sums in
// shared memory and writes ONE partial row; the wrapper sums the rows over
// blocks, a tiny torch reduction. dkexp and dvexp (64 values per batch) are
// summed per tile in shared memory and added with fp32 atomicAdd. The LN
// output's buffer takes the cotangent tile once the attention has read it,
// so two fp32 tiles fit up to D = 512. Rows past N load as zeros, which
// makes every contribution they add exactly zero, and are not stored.
// Weights arrive as fp32; only x, g and dx take the activation dtype.

#include "xattn_layer.cuh"

namespace {

using namespace smow::xlayer;
using smow::from_float;
using smow::warp_sum;

// one block's partial sums, in floats (the wrapper reads the same layout)
template <int kD>
struct Part {
  static constexpr int kOffWq = 0;                      // (kD, kHeads)
  static constexpr int kOffWo = kOffWq + kD * kHeads;   // (kHeads, kD)
  static constexpr int kOffLng = kOffWo + kHeads * kD;  // (kD,)
  static constexpr int kOffLnb = kOffLng + kD;
  static constexpr int kOffBo = kOffLnb + kD;
  static constexpr int kSize = kOffBo + kD;             // 19 kD
};

template <int kD>
constexpr size_t kSmemBytes = (2 * kAttnRows<kD> * kRow<kD> + 3 * kAttnRows<kD> * kHeads +
                               2 * kAttnRows<kD> + 2 * kHeads * kM) * sizeof(float);

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 2)
cross_attn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ dx,
                      float* __restrict__ part, float* __restrict__ dkexp,
                      float* __restrict__ dvexp, Params p, int B) {
  using P = Part<kD>;
  constexpr int kRows = kAttnRows<kD>;
  constexpr int kR = kRow<kD>;
  constexpr int kSpan = kD < kThreads ? kD : kThreads;   // threads per row of columns
  constexpr int kGroups = kThreads / kSpan;              // row groups of a tile
  constexpr int kCols = (kD + kSpan - 1) / kSpan;        // columns per thread
  static_assert(kThreads % kSpan == 0 && kRows % kGroups == 0, "column-sum layout");
  static_assert(kRows * kHeads % kThreads == 0, "the attention backward runs whole warps");
  static_assert(kHeads == 8 && kM == 8, "the warp reductions assume 8 heads of 8 tokens");
  static_assert(kRows * kR >= P::kSize, "the block's sums reuse the x tile");
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // x tile (permuted); at the end the sums
  float* gs = xs + kRows * kR;                   // LN(x), then the cotangent tile g
  float* qs = gs + kRows * kR;                   // (kRows, kHeads)
  float* os = qs + kRows * kHeads;               // (kRows, kHeads)
  float* dqs = os + kRows * kHeads;              // (kRows, kHeads)
  float* mu = dqs + kRows * kHeads;
  float* rs = mu + kRows;
  float* dkv = rs + kRows;                       // (2, kHeads, kM): dkexp, dvexp of the tile

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int col0 = t % kSpan, grp = t / kSpan;
  const int N = p.N;
  const int tiles_per_b = (N + kRows - 1) / kRows;
  const int n_tiles = B * tiles_per_b;

  float s_wq[kCols][kHeads], s_wo[kCols][kHeads], s_lg[kCols], s_lb[kCols], s_bo[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    s_lg[j] = s_lb[j] = s_bo[j] = 0.f;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) s_wq[j][hh] = s_wo[j][hh] = 0.f;
  }
  for (int i = t; i < 2 * kHeads * kM; i += kThreads) dkv[i] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_b;
    const int n0 = (tile % tiles_per_b) * kRows;
    __syncthreads();   // the previous tile's reads are done

    // 1. forward recompute: the x tile (permuted), LN, q and o
    load_tile<kD, kRows>(x + (size_t)b * N * kD, p.perm, n0, N, xs);
    __syncthreads();
    layer_norm_rows<kD, kRows>(xs, gs, p.ln1_g, p.ln1_b, p.eps, mu, rs);
    __syncthreads();
    attention_rows<kD, kRows>(gs, p, b, os, qs);
    __syncthreads();
    load_tile<kD, kRows>(gy + (size_t)b * N * kD, static_cast<const int*>(nullptr), n0, N, gs);
    __syncthreads();

    // 2. attention backward, one thread per (row, head); the per-batch sums
    //    over rows reduce across the warp's four rows, then in smem
    for (int i = t; i < kRows * kHeads; i += kThreads) {
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
    __syncthreads();
    if (t < 2 * kHeads * kM) {
      const float v = dkv[t];
      dkv[t] = 0.f;
      float* dst = (t < kHeads * kM) ? dkexp : dvexp;
      atomicAdd(dst + (size_t)b * kHeads * kM + t % (kHeads * kM), v);
    }

    // 3. the tile's column sums into this thread's registers: dbo, dwo, dwq,
    //    LN's scale and bias
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = col0 + kSpan * j;
      if (d >= kD) continue;
      float w[kHeads];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) w[hh] = __ldg(p.wq + d * kHeads + hh);
      const float lg = __ldg(p.ln1_g + d), lb = __ldg(p.ln1_b + d);
      for (int r = grp; r < kRows; r += kGroups) {
        const float g = gs[r * kR + d];
        const float xh = (xs[r * kR + d] - mu[r]) * rs[r];
        const float xn = xh * lg + lb;
        float dxn = 0.f;
        s_bo[j] += g;
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const float dq = dqs[r * kHeads + hh];
          s_wo[j][hh] += os[r * kHeads + hh] * g;
          s_wq[j][hh] += xn * dq;
          dxn += dq * w[hh];
        }
        s_lg[j] += dxn * xh;
        s_lb[j] += dxn;
      }
    }

    // 4. LN backward, one warp per row: dxn = dq wq^T, dxc = LN'(dxn) + g,
    //    scattered through the permutation
    T* dxb = dx + (size_t)b * N * kD;
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float xh[kD / 32], dxh[kD / 32];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        const int d = lane + 32 * j;
        float dxn = 0.f;
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh)
          dxn += dqs[r * kHeads + hh] * __ldg(p.wq + d * kHeads + hh);
        xh[j] = (xs[r * kR + d] - mu[r]) * rs[r];
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
        const float v = rs[r] * (dxh[j] - m1 - xh[j] * m2) + gs[r * kR + d];
        dxb[(size_t)n * kD + (p.perm ? __ldg(p.perm + d) : d)] = from_float<T>(v);
      }
    }
  }

  // 5. the block's sums: the threads' registers added in smem (over the x
  //    tile), then written as the block's row of `part`
  __syncthreads();
  for (int i = t; i < P::kSize; i += kThreads) xs[i] = 0.f;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int d = col0 + kSpan * j;
    if (d >= kD) continue;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      atomicAdd(xs + P::kOffWq + d * kHeads + hh, s_wq[j][hh]);
      atomicAdd(xs + P::kOffWo + hh * kD + d, s_wo[j][hh]);
    }
    atomicAdd(xs + P::kOffLng + d, s_lg[j]);
    atomicAdd(xs + P::kOffLnb + d, s_lb[j]);
    atomicAdd(xs + P::kOffBo + d, s_bo[j]);
  }
  __syncthreads();
  float* pb = part + (size_t)blockIdx.x * P::kSize;
  for (int i = t; i < P::kSize; i += kThreads) pb[i] = xs[i];
}

template <typename T, int kD>
cudaError_t launch(const void* x, const void* gy, void* dx, void* part, void* dkexp,
                   void* dvexp, const Params& p, int B, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(cross_attn_bwd_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes<kD>);
  if (err != cudaSuccess) return err;
  cross_attn_bwd_kernel<T, kD><<<blocks, kThreads, kSmemBytes<kD>, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), static_cast<T*>(dx),
      static_cast<float*>(part), static_cast<float*>(dkexp), static_cast<float*>(dvexp), p, B);
  return cudaGetLastError();
}

}  // namespace

// x, gy, dx: (B, N, D) fp32 or bf16, contiguous; perm: (D,) int32 source lane
// per output lane, or null; weights fp32 as for cross_attn_fwd (bo is not
// read). part: (blocks, part_floats) fp32, one block's sums each in the
// layout of Part<D> above (part_floats must equal its kSize, 19 D), every row
// written by the kernel; dkexp, dvexp: (B, h, M) fp32, zeroed. Built for h =
// 8, M = 8 and D in {64, 128, 256, 384, 512}; other sizes return
// cudaErrorInvalidValue.
extern "C" int cross_attn_bwd(const void* x, const void* gy, const void* perm, const void* ln_g,
                              const void* ln_b, const void* wq, const void* kexp,
                              const void* vexp, const void* wo, const void* bo, void* dx,
                              void* part, void* dkexp, void* dvexp, int B, int N, int D,
                              int heads, int M, int blocks, int part_floats, int is_bf16,
                              float eps, void* stream) {
  (void)bo;
  if (heads != kHeads || M != kM || N <= 0 || B <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.perm = static_cast<const int*>(perm);
  p.ln1_g = static_cast<const float*>(ln_g);
  p.ln1_b = static_cast<const float*>(ln_b);
  p.wq = static_cast<const float*>(wq);
  p.kexp = static_cast<const float*>(kexp);
  p.vexp = static_cast<const float*>(vexp);
  p.wo = static_cast<const float*>(wo);
  p.N = N;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(smow::xlayer::dispatch_attn(D, is_bf16, [&](auto t, auto d) {
    constexpr int kD = decltype(d)::value;
    if (part_floats != Part<kD>::kSize) return cudaErrorInvalidValue;
    return launch<typename decltype(t)::type, kD>(x, gy, dx, part, dkexp, dvexp, p, B, blocks, s);
  }));
}
