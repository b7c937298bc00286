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
// x 16384 pixels, D = 128) 201 MB, 0.060 ms at 3.35 TB/s. The FLOP take as
// long on the CUDA cores' fp32 FMA, so the products go to the tensor cores.
//
// bf16 design at D = 64 and 128 (`cross_attn_bwd_tc`, on kernel F's frame,
// xattn_layer.cu `layer_fwd_tc`). About 8 D h of the FLOP per row are thin
// products with h = 8 columns, exactly the n of `mma.sync.m16n8k16`
// (xattn_layer_tc.cuh): do = g wo^T per row, dxn = dq wq^T (m16n8k8: k =
// the 8 heads), and the sums over rows xhat^T dq and g^T o. Persistent
// blocks of 8 warps (one per SM: 224 KB of shared memory at D = 128) stage
// wq and wo once at their bf16 values, wq in fp32 and both as B fragments
// laid out per lane, and each warp walks its own contiguous range of 16-row
// tiles, the next tile's x and g rows streaming in through `cp.async` into
// the warp's second buffers; no block barrier runs inside the tile loop.
// Per tile, in fp32 in the accumulator layout (lane (g, q): rows g and g +
// 8, heads 2q and 2q + 1): LN1's statistics and xhat through the
// permutation, xhat's hi + lo to the warp's shared copy; q = LN1(xc) wq in
// fp32 on the CUDA cores (where a head's keys are large, q kexp reaches
// ~1e3, and the 2^-17 of a hi/lo product moves that head's softmax past the
// bound: phase 4d's spread case), these steps and the softmax being G's own
// (cross_attn_tc.cuh), so the recompute has G's bits; do from the bf16 g tile
// through `ldmatrix` (exact); the 8 x 8 softmax and its backward on the
// CUDA cores, one per (row, head) of the lane, with `softmax_tokens`'
// per-head shift; dq split into hi + lo is the A operand of dxn from
// registers; o's and dq's hi + lo pass through 1 KB of the warp's shared
// memory to become B operands (`ldmatrix.trans`) of g^T o and xhat^T dq,
// whose A operands are the g tile and xhat's copy read by `ldmatrix.trans`.
// The LN backward runs twice over dxn (its row sums, then dxc; the second
// pass recomputes the 2 D / 8 MMAs rather than hold dxn), adds g, and
// stores dx as 16-byte rows through the tile's x buffer, written at the
// permuted lanes. The sums over rows stay in the warp's registers across
// its tiles: xhat^T dq and dwo^T (D x 8 each, 4 D / 32 floats a lane), sum
// dq (8), dbo (8 columns a lane), and dkexp, dvexp of the lane's heads,
// added to device memory with atomicAdd when the warp's batch changes. The
// LayerNorm's and wq's sums follow from xhat^T dq and sum dq, since xn =
// xhat gamma + beta and dxn = dq wq^T:
//   dwq = gamma (xhat^T dq) + beta (sum dq),
//   dgamma_d = sum_h wq[d, h] (xhat^T dq)[d, h],  dbeta = wq (sum dq).
// At the end the block adds its warps' sums in shared memory in warp order,
// forms these three and writes one record (Part<D>, the layout of the
// wide design's); the wrapper sums the records. Every fp32 operand of a
// product is split into bf16 hi + lo (xhat, dq, o); wq and wo are taken at
// their bf16 values, as the plain version's bf16 forward rounds them. dx
// and the records hold no float atomics: two runs give them bitwise equal.
//
// fp32, and bf16 at D = 256, 384 and 512 (`cross_attn_bwd_kernel`, the
// port's first design; the tensor-core body's per-warp sums, 8 D floats a
// warp, do not fit a lane's registers there): the width D is a template
// argument, the tile kAttnRows<D> rows (64, or 32 at D >= 256). The sums
// over rows, 19 D floats (39 KB at D = 512), stay in registers: the grid is
// persistent (two blocks of 256 threads per SM, each walking a strided set
// of tiles), thread t owns columns t % S + S j (S = min(D, 256)) and, where
// D < 256, every (256 / D)-th row of a tile, and adds each tile's rows into
// its registers. At the end the block reduces its threads' sums in shared
// memory and writes ONE partial row; the wrapper sums the rows over
// blocks, a tiny torch reduction. dkexp and dvexp (64 values per batch) are
// summed per tile in shared memory and added with fp32 atomicAdd. The
// forward recompute is G's first design's (LN1 and q in float64,
// xattn_layer.cuh); the buffer of LN1's statistics takes the cotangent tile
// once the attention has read them, so two fp32 tiles fit up to D = 512.
// Rows past N load as zeros, which
// makes every contribution they add exactly zero, and are not stored.
// Weights arrive as fp32; only x, g and dx take the activation dtype.

#include <type_traits>

#include "cross_attn_tc.cuh"

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
  float* gs = xs + kRows * kR;                   // LN1's statistics, then the cotangent tile g
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

    // 1. forward recompute: the x tile (permuted), LN1's statistics, q and o
    load_tile<kD, kRows>(x + (size_t)b * N * kD, p.perm, n0, N, xs);
    __syncthreads();
    ln_stats_rows<kD, kRows>(xs, p.eps, reinterpret_cast<double*>(gs), mu, rs);
    __syncthreads();
    attention_rows<kD, kRows>(xs, reinterpret_cast<const double*>(gs), p, b, os, qs);
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


// ---- bf16 at D = 64 and 128: tensor cores, warp-owned 16-row tiles ---------

namespace tcg {

using namespace smow::xlayer::tca;

template <int kD>
struct Layout {
  static constexpr int kXS = kD + kPad;   // bf16 row stride of a warp's tiles
  static constexpr int kKS = kD / 16;     // 16-deep k-steps over D
  static constexpr int kNT = kD / 8;      // 8-wide n-tiles of D
  static constexpr size_t kTile = sizeof(__nv_bfloat16) * kWarpRows * kXS;
  // a warp's: x and g, two buffers each, xhat hi and lo (16, kXS); o hi, o
  // lo, dq hi, dq lo (16, 8) each
  static constexpr size_t kOffX = 0;
  static constexpr size_t kOffG = 2 * kTile;
  static constexpr size_t kOffXh = 4 * kTile;
  static constexpr size_t kOffOq = 6 * kTile;
  static constexpr size_t kWarpBytes = kOffOq + sizeof(__nv_bfloat16) * 4 * kWarpRows * kHeads;
  // the block's: wq (kD, kWqS) fp32; B fragments per lane of do = g wo^T
  // (uint2 [kKS][32]) and of dxn = dq wq^T (uint32 [kNT][32]); ln_g, ln_b
  // (kD floats each); perm (kD ints)
  static constexpr size_t kOffWq = kWarps * kWarpBytes;
  static constexpr size_t kOffWo = kOffWq + sizeof(float) * kD * kWqS;
  static constexpr size_t kOffWqT = kOffWo + sizeof(uint2) * kKS * 32;
  static constexpr size_t kOffLn = kOffWqT + sizeof(uint32_t) * kNT * 32;
  static constexpr size_t kOffPerm = kOffLn + sizeof(float) * 2 * kD;
  static constexpr size_t kBytes = kOffPerm + sizeof(int) * kD;
  static_assert(kBytes <= 232448, "over a block's shared memory");
  static_assert(kTile % 16 == 0 && kWarpBytes % 16 == 0, "16-byte aligned tiles");
  // a warp's sums at the end, over its tiles' space: xhat^T dq (kD, 8), dwo
  // (8, kD), sum dq (8), dbo (kD)
  static constexpr int kSums = 2 * kD * kHeads + kHeads + kD;
  static_assert(sizeof(float) * kSums <= kWarpBytes, "a warp's sums over its tiles");
};

__device__ __forceinline__ __nv_bfloat162 bf2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}

// v, over the 8 lanes of each q (lanes q, q + 4, ..., q + 28)
__device__ __forceinline__ float sum_over_g(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
cross_attn_bwd_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gy,
                  __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
                  float* __restrict__ dkexp, float* __restrict__ dvexp, Params p, int B) {
  static_assert(kD == 64 || kD == 128, "built for D = 64 and 128");
  using L = Layout<kD>;
  using P = Part<kD>;
  constexpr int kXS = L::kXS, kKS = L::kKS, kNT = L::kNT;
  constexpr int kMT = kD / 16;          // 16-row m-tiles of the (kD, 8) sums
  constexpr int kChunks = kD / 8;       // 16-byte pieces of a row
  constexpr int kRowGroups = 32 / kChunks;   // dbo: lanes per chunk of 8 columns
  extern __shared__ __align__(16) unsigned char smem[];
  float* wq32 = reinterpret_cast<float*>(smem + L::kOffWq);
  const uint2* wob = reinterpret_cast<const uint2*>(smem + L::kOffWo);
  const uint32_t* wqt = reinterpret_cast<const uint32_t*>(smem + L::kOffWqT);
  float* g1 = reinterpret_cast<float*>(smem + L::kOffLn);
  float* be1 = g1 + kD;
  int* perm = reinterpret_cast<int*>(smem + L::kOffPerm);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int N = p.N;
  const int tiles_per_b = (N + kWarpRows - 1) / kWarpRows;
  const long long n_tiles = (long long)B * tiles_per_b;
  unsigned char* ws = smem + warp * L::kWarpBytes;
  auto* xbuf = reinterpret_cast<__nv_bfloat16*>(ws + L::kOffX);
  auto* gbuf = reinterpret_cast<__nv_bfloat16*>(ws + L::kOffG);
  auto* xhh = reinterpret_cast<__nv_bfloat16*>(ws + L::kOffXh);
  __nv_bfloat16* xhl = xhh + kWarpRows * kXS;
  auto* oq = reinterpret_cast<__nv_bfloat16*>(ws + L::kOffOq);   // (4, 16, 8)

  // the weights at their bf16 values, once per block: G's prefix copy (wq in
  // fp32 for q), the B fragments of do = g wo^T and of dxn = dq wq^T
  stage_prefix<kD>(p, wq32, g1, be1, perm);
  for (int i = t; i < kKS * 32; i += kThreads) {
    const int s = i >> 5, l = i & 31, lg = l >> 2, lq = l & 3;
    const int k0 = 16 * s + 2 * lq, k1 = k0 + 8;
    reinterpret_cast<uint2*>(smem + L::kOffWo)[i] =
        make_uint2(pack(p.wo[lg * kD + k0], p.wo[lg * kD + k0 + 1]),
                   pack(p.wo[lg * kD + k1], p.wo[lg * kD + k1 + 1]));
  }
  for (int i = t; i < kNT * 32; i += kThreads) {
    const int nt = i >> 5, l = i & 31, d = 8 * nt + (l >> 2), h = 2 * (l & 3);
    reinterpret_cast<uint32_t*>(smem + L::kOffWqT)[i] =
        pack(p.wq[d * kHeads + h], p.wq[d * kHeads + h + 1]);
  }

  // this warp's tiles: a contiguous range, so that its batch seldom changes
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  const int first = (int)(w * n_tiles / n_warps), last = (int)((w + 1) * n_tiles / n_warps);

  // a tile's 16 rows of x and of g into the warp's buffers `buf` (zeros past N)
  auto load = [&](int tile, int buf) {
    const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * kWarpRows;
    const size_t at = ((size_t)b * N + n0) * kD;
    __nv_bfloat16* xd = xbuf + buf * kWarpRows * kXS;
    __nv_bfloat16* gd = gbuf + buf * kWarpRows * kXS;
    for (int i = lane; i < kWarpRows * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = n0 + r < N;
      cp_async16(xd + r * kXS + c, ok ? x + at + (size_t)r * kD + c : x, ok);
      cp_async16(gd + r * kXS + c, ok ? gy + at + (size_t)r * kD + c : gy, ok);
    }
  };
  if (first < last) load(first, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the sums over this warp's rows
  float sxq[kMT][4], swo[kMT][4], sdq[2], sbo[8], gk[2][kM], gv[2][kM];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) sxq[mt][c] = swo[mt][c] = 0.f;
  sdq[0] = sdq[1] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sbo[j] = 0.f;
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int m = 0; m < kM; ++m) gk[e][m] = gv[e][m] = 0.f;

  // dkexp, dvexp of batch b: the lanes' sums over g, added by lanes 0..3
  auto flush = [&](int b) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float k = sum_over_g(gk[e][m]), v = sum_over_g(gv[e][m]);
        gk[e][m] = gv[e][m] = 0.f;
        if (g == 0) {
          const size_t at = ((size_t)b * kHeads + 2 * q + e) * kM + m;
          atomicAdd(dkexp + at, k);
          atomicAdd(dvexp + at, v);
        }
      }
  };

  int cur_b = -1;
  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int buf = it & 1;
    if (tile + 1 < last) load(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * kWarpRows;
    if (b != cur_b) {
      if (cur_b >= 0) flush(cur_b);
      cur_b = b;
    }
    __nv_bfloat16* xt = xbuf + buf * kWarpRows * kXS;
    const __nv_bfloat16* gt = gbuf + buf * kWarpRows * kXS;

    // LN1's statistics and q = LN1(xc) wq, as G computes them, from the
    // tile; xhat (hi, lo) into the warp's copy on the way
    auto xc = [&](int nt) {
      const int2 src = *reinterpret_cast<const int2*>(perm + nt * 8 + 2 * q);
      return make_float4(__bfloat162float(xt[g * kXS + src.x]),
                         __bfloat162float(xt[g * kXS + src.y]),
                         __bfloat162float(xt[(g + 8) * kXS + src.x]),
                         __bfloat162float(xt[(g + 8) * kXS + src.y]));
    };
    auto keep_xhat = [&](int i, int col, float h0, float h1) {
      const int r = g + 8 * i;
      uint32_t hh, hl;
      split2(h0, h1, hh, hl);
      *reinterpret_cast<uint32_t*>(xhh + r * kXS + col) = hh;
      *reinterpret_cast<uint32_t*>(xhl + r * kXS + col) = hl;
    };
    float mu[2], rs[2], qa[4];
    row_stats<kD>(xc, p.eps, mu, rs);
    head_queries<kD>(xc, keep_xhat, mu, rs, wq32, g1, be1, q, qa);

    // do = g wo^T (the bf16 g tile is exact)
    float dov[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
      uint32_t a[4];
      ldsm(a, gt + a_row(lane) * kXS + 16 * s + a_col(lane));
      const uint2 wb = wob[s * 32 + lane];
      mma(dov, a, wb.x, wb.y);
    }

    // dbo: lane l sums 8 columns of every kRowGroups-th row
    {
      const int c8 = (lane % kChunks) * 8;
#pragma unroll
      for (int r = lane / kChunks; r < kWarpRows; r += kRowGroups) {
        const uint4 raw = *reinterpret_cast<const uint4*>(gt + r * kXS + c8);
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(v[j]);
          sbo[2 * j] += f.x;
          sbo[2 * j + 1] += f.y;
        }
      }
    }

    // the softmax and its backward, per (row, head) of this lane: element c
    // of the accumulators is row g + 8 (c >> 1), head 2q + (c & 1)
    float o[4], dq[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float kr[kM], vr[kM];
      head_tokens(p, b, 2 * q + e, kr, vr);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = 2 * i + e;
        const float qv = qa[c];
        float ev[kM], den;
        o[c] = softmax_o(qv, kr, vr, ev, den);
        const float dnum = dov[c] / den;
        const float dden = -dov[c] * o[c] / den;
        float d = 0.f;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float dd = ev[m] * (dnum * vr[m] + dden);
          d += dd * kr[m];
          gk[e][m] += qv * dd;
          gv[e][m] += ev[m] * dnum;
        }
        dq[c] = d;
      }
      sdq[e] += dq[e] + dq[2 + e];
    }

    // o and dq (hi, lo) to the warp's (16, 8) scratch for their transposed
    // loads; dq's halves are also the A operand of dxn = dq wq^T
    uint32_t dqh[2], dql[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = (g + 8 * i) * kHeads + 2 * q;
      uint32_t hi, lo;
      split2(o[2 * i], o[2 * i + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(oq + at) = hi;
      *reinterpret_cast<uint32_t*>(oq + kWarpRows * kHeads + at) = lo;
      split2(dq[2 * i], dq[2 * i + 1], dqh[i], dql[i]);
      *reinterpret_cast<uint32_t*>(oq + 2 * kWarpRows * kHeads + at) = dqh[i];
      *reinterpret_cast<uint32_t*>(oq + 3 * kWarpRows * kHeads + at) = dql[i];
    }
    __syncwarp();
    // B fragments (k = the tile's rows, n = heads): o hi, o lo; dq hi, dq lo
    uint32_t ob[4], qb[4];
    ldsm_t(ob, oq + (lane >> 4) * kWarpRows * kHeads + (lane & 15) * kHeads);
    ldsm_t(qb, oq + (2 + (lane >> 4)) * kWarpRows * kHeads + (lane & 15) * kHeads);

    // dwo^T += g^T o and xhat^T dq, k = the tile's rows
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int ao = b_row(lane) * kXS + 16 * mt + b_col(lane);
      uint32_t a[4], xh[4], xl[4];
      ldsm_t(a, gt + ao);
      mma(swo[mt], a, ob[0], ob[1]);
      mma(swo[mt], a, ob[2], ob[3]);
      ldsm_t(xh, xhh + ao);
      ldsm_t(xl, xhl + ao);
      mma(sxq[mt], xh, qb[0], qb[1]);
      mma(sxq[mt], xh, qb[2], qb[3]);
      mma(sxq[mt], xl, qb[0], qb[1]);
    }

    // the LN backward: dxhat = (dq wq^T) gamma, its row means against 1 and
    // xhat, then dxc = rs (dxhat - m1 - xhat m2) + g, twice over the n-tiles
    // of dxn (the second pass recomputes them)
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = 8 * nt + 2 * q;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t wb = wqt[nt * 32 + lane];
        mma_k8(acc, dqh, wb);
        mma_k8(acc, dql, wb);
        const int2 dst = *reinterpret_cast<const int2*>(perm + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = g + 8 * i;
          const float2 hi = __bfloat1622float2(bf2(xhh + r * kXS + col));
          const float2 lo = __bfloat1622float2(bf2(xhl + r * kXS + col));
          const float xa = hi.x + lo.x, xb = hi.y + lo.y;
          const float da = acc[2 * i] * g1[col], db = acc[2 * i + 1] * g1[col + 1];
          if (pass == 0) {
            m1[i] += da + db;
            m2[i] += da * xa + db * xb;
          } else {
            const float2 gv2 = __bfloat1622float2(bf2(gt + r * kXS + col));
            xt[r * kXS + dst.x] = __float2bfloat16(rs[i] * (da - m1[i] - xa * m2[i]) + gv2.x);
            xt[r * kXS + dst.y] = __float2bfloat16(rs[i] * (db - m1[i] - xb * m2[i]) + gv2.y);
          }
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int o2 = 1; o2 <= 2; o2 <<= 1) {
            m1[i] += __shfl_xor_sync(0xffffffffu, m1[i], o2);
            m2[i] += __shfl_xor_sync(0xffffffffu, m2[i], o2);
          }
          m1[i] *= 1.f / kD;
          m2[i] *= 1.f / kD;
        }
      }
    }

    // dx: the tile's x buffer, now dxc at the permuted lanes, as 16-byte rows
    __syncwarp();
    __nv_bfloat16* out = dx + ((size_t)b * N + n0) * kD;
    for (int i = lane; i < kWarpRows * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (n0 + r < N)
        *reinterpret_cast<uint4*>(out + (size_t)r * kD + c) =
            *reinterpret_cast<const uint4*>(xt + r * kXS + c);
    }
    __syncwarp();
  }
  if (cur_b >= 0) flush(cur_b);

  // the warps' sums into their tiles' space, then added in warp order
#pragma unroll
  for (int e = 0; e < 2; ++e) sdq[e] = sum_over_g(sdq[e]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int o2 = kChunks; o2 < 32; o2 <<= 1) sbo[j] += __shfl_xor_sync(0xffffffffu, sbo[j], o2);
  __syncthreads();   // every warp is done with its tiles
  float* mine = reinterpret_cast<float*>(ws);
  float *mxq = mine, *mwo = mxq + kD * kHeads, *msq = mwo + kD * kHeads, *mbo = msq + kHeads;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 16 * mt + g + 8 * (c >> 1), h = 2 * q + (c & 1);
      mxq[d * kHeads + h] = sxq[mt][c];
      mwo[h * kD + d] = swo[mt][c];
    }
  if (g == 0) {
    msq[2 * q] = sdq[0];
    msq[2 * q + 1] = sdq[1];
  }
  if (lane < kChunks) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mbo[lane * 8 + j] = sbo[j];
  }
  __syncthreads();
  // warp 0's sums become the block's
  for (int i = t; i < L::kSums; i += kThreads) {
    float v = reinterpret_cast<const float*>(smem)[i];
#pragma unroll
    for (int k = 1; k < kWarps; ++k)
      v += reinterpret_cast<const float*>(smem + k * L::kWarpBytes)[i];
    reinterpret_cast<float*>(smem)[i] = v;
  }
  __syncthreads();
  const float* txq = reinterpret_cast<const float*>(smem);
  const float *two = txq + kD * kHeads, *tsq = two + kD * kHeads, *tbo = tsq + kHeads;
  float* rec = part + (size_t)blockIdx.x * P::kSize;
  for (int i = t; i < kD * kHeads; i += kThreads) {
    const int d = i / kHeads, h = i % kHeads;
    rec[P::kOffWq + i] = g1[d] * txq[i] + be1[d] * tsq[h];
    rec[P::kOffWo + i] = two[i];
  }
  for (int d = t; d < kD; d += kThreads) {
    float lg = 0.f, lb = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      lg += wq32[d * kWqS + h] * txq[d * kHeads + h];
      lb += wq32[d * kWqS + h] * tsq[h];
    }
    rec[P::kOffLng + d] = lg;
    rec[P::kOffLnb + d] = lb;
    rec[P::kOffBo + d] = tbo[d];
  }
}

// resident blocks of cross_attn_bwd_tc<kD> in one wave on the current device
template <int kD>
cudaError_t resident_blocks(int* blocks) {
  static int cached = 0;
  cudaError_t err = tc::resident_blocks(cross_attn_bwd_tc<kD>, Layout<kD>::kBytes, &cached);
  *blocks = cached;
  return err;
}

template <int kD>
cudaError_t launch(const void* x, const void* gy, void* dx, void* part, void* dkexp,
                   void* dvexp, const Params& p, int B, int blocks, cudaStream_t stream) {
  int resident = 0;   // and the kernel's shared-memory size set, once
  cudaError_t err = resident_blocks<kD>(&resident);
  if (err != cudaSuccess) return err;
  cross_attn_bwd_tc<kD><<<blocks, kThreads, Layout<kD>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gy),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part), static_cast<float*>(dkexp),
      static_cast<float*>(dvexp), p, B);
  return cudaGetLastError();
}

}  // namespace tcg

}  // namespace

// x, gy, dx: (B, N, D) fp32 or bf16, contiguous; perm: (D,) int32 source lane
// per output lane, or null; weights fp32 as for cross_attn_fwd (bo is not
// read; the bf16 kernel at D <= 128 takes wq and wo at their bf16 values).
// part: (blocks, part_floats) fp32, one block's sums each in the layout of
// Part<D> above (part_floats must equal its kSize, 19 D), every row written
// by the kernel; blocks from cross_attn_bwd_grid; dkexp, dvexp: (B, h, M)
// fp32, zeroed. Built for h = 8, M = 8 and D in {64, 128, 256, 384, 512};
// other sizes return cudaErrorInvalidValue.
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
    using T = typename decltype(t)::type;
    if (part_floats != Part<kD>::kSize) return cudaErrorInvalidValue;
    if constexpr (std::is_same<T, __nv_bfloat16>::value && kD <= 128)
      return tcg::launch<kD>(x, gy, dx, part, dkexp, dvexp, p, B, blocks, s);
    else
      return launch<T, kD>(x, gy, dx, part, dkexp, dvexp, p, B, blocks, s);
  }));
}

// G-bwd's grid for the width and dtype on the current device: *ctas, the
// blocks of one full wave; *tile_rows, the rows of a tile; *tiles_per_block,
// the tiles a block takes at once (the bf16 kernel at D <= 128: one per
// warp). A call launches min(ctas, ceil(tiles / tiles_per_block)) blocks.
extern "C" int cross_attn_bwd_grid(int D, int is_bf16, int* ctas, int* tile_rows,
                                   int* tiles_per_block) {
  return static_cast<int>(smow::xlayer::dispatch_attn(D, is_bf16, [&](auto t, auto d) {
    constexpr int kD = decltype(d)::value;
    using T = typename decltype(t)::type;
    if constexpr (std::is_same<T, __nv_bfloat16>::value && kD <= 128) {
      *tile_rows = tcg::kWarpRows;
      *tiles_per_block = tcg::kWarps;
      return tcg::resident_blocks<kD>(ctas);
    } else {
      int dev = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      *ctas = 2 * sms;
      *tile_rows = kAttnRows<kD>;
      *tiles_per_block = 1;
      return err;
    }
  }));
}
