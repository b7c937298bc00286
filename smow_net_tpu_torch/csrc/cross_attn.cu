// Kernel G: the dim_head=1 pixel cross-attention sublayer, forward.
//
// Replaces `cross_attn_head1_pallas` / `_run_fwd` / `_fwd_kernel` (over
// `_attn_core`) in smow_net_tpu/ops/pallas/xattn.py: the first half of the
// reference TransformerDecoder layer (models/SMOW_Net.py:270-283, 337-381)
// over x (B, N, D) pixel queries against M memory tokens, per row
//   xc   = x[perm]                 optional lane permutation (index gather)
//   q    = LN(xc) wq               D -> h heads of width 1
//   o_h  = softmax_m(q_h k[h, m] scale) . v[h, :]      per (pixel, head)
//   y    = o wo + bo + xc
// with one read of x and one write of y. It is kernel F (xattn_layer.cu)
// without the MLP.
//
// What bounds it on the card: bytes. Per row it does 2 * 2 * D * h FLOP for
// the two projections and ~40 for the 8 x 8 softmax, against 4 D bytes of x
// and y in bf16: 8 FLOP per byte, far under the card's ~295. At SMOW_Net's
// decoder shape (16 x 16384 pixels, D = 128) that is 134 MB, 0.040 ms at
// 3.35 TB/s.
//
// bf16 design at D = 64 and 128 (`cross_attn_fwd_tc`, on G-bwd's frame,
// cross_attn_bwd.cu `cross_attn_bwd_tc`): persistent blocks of 8 warps, two
// a SM (no more than 128 registers a thread; 114,688 bytes of shared memory
// at D = 128), stage wq at its bf16 values in fp32, LN1's scale and bias, bo
// and the B fragments of wo once; each warp walks its own contiguous range
// of 16-row tiles, the next tile's x rows streaming in through `cp.async`
// into the warp's second buffer; no block barrier runs inside the tile
// loop. Per tile the lane gathers its xc values (rows g and g + 8, through
// the permutation) into the warp's xc tile, whose elements it alone then
// reads and overwrites with y (held in registers instead, they took the
// D = 128 body past 128 registers), and G-bwd's prefix
// (cross_attn_tc.cuh) forms LN1's statistics per quad, q = LN1(xc) wq in
// fp32 on the CUDA cores and the per-head softmax, in the accumulator
// layout: G's q and o are the bits G-bwd's recompute forms. The
// out-projection y = o wo runs on `mma_k8` (m16n8k8, k = the 8 heads), o
// split into bf16 hi + lo as the A operand from registers, wo at its bf16
// value; the accumulators start at xc + bo (bo at its bf16 value), in fp32.
// y is rounded once to bf16 and leaves as 16-byte rows through the xc tile.
// No atomics: two runs give bitwise equal outputs.
//
// fp32 at every width, and bf16 at D = 256, 384 and 512
// (`cross_attn_fwd_kernel`, the port's first design): one block of 256
// threads owns a tile of kAttnRows<D> pixel rows (64 at D <= 128, 32 at D >=
// 256); the width D is a template argument. The tile (after the index
// permutation) lives in shared memory as fp32 and runs F's steps
// (xattn_layer.cuh) in F's order: LN1's statistics one warp per row, LN1, q
// (both in float64, rounded once) and the 8 x 8 attention one thread per
// (row, head), the out-projection one thread per element, written in place
// of the tile and stored with coalesced rows. The weights (2 x 8 x D floats) are
// read through the read-only cache. Rows past N (the ragged tail) are loaded
// as zeros and never stored. Weights arrive as fp32; only x and y take the
// activation dtype, and all other arithmetic is fp32.

#include <algorithm>

#include "cross_attn_tc.cuh"

namespace {

using namespace smow::xlayer;
using smow::from_float;

template <int kD>
constexpr size_t kSmemBytes =
    (kAttnRows<kD> * kRow<kD> + kAttnRows<kD> * kHeads) * sizeof(float) +
    2 * kAttnRows<kD> * sizeof(double);

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
cross_attn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, Params p) {
  constexpr int kRows = kAttnRows<kD>;
  constexpr int kR = kRow<kD>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // x tile, then y
  float* os = xs + kRows * kR;                   // (kRows, kHeads) attention output
  double* st = reinterpret_cast<double*>(os + kRows * kHeads);   // LN1's statistics

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int N = p.N;

  load_tile<kD, kRows>(x + (size_t)b * N * kD, p.perm, n0, N, xs);
  __syncthreads();
  ln_stats_rows<kD, kRows>(xs, p.eps, st);
  __syncthreads();
  attention_rows<kD, kRows>(xs, st, p, b, os);
  __syncthreads();
  attention_out_rows<kD, kRows>(xs, os, p);
  __syncthreads();

  T* ob = out + (size_t)b * N * kD;
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD, n = n0 + r;
    if (n < N) ob[(size_t)n * kD + d] = from_float<T>(xs[r * kR + d]);
  }
}

template <typename T, int kD>
cudaError_t launch(const void* x, void* out, const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(cross_attn_fwd_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes<kD>);
  if (err != cudaSuccess) return err;
  const dim3 blocks((p.N + kAttnRows<kD> - 1) / kAttnRows<kD>, B);
  cross_attn_fwd_kernel<T, kD><<<blocks, kThreads, kSmemBytes<kD>, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return cudaGetLastError();
}


// ---- bf16 at D = 64 and 128: tensor cores, warp-owned 16-row tiles ---------

namespace tcg {

using namespace smow::xlayer::tca;

template <int kD>
struct Layout {
  static constexpr int kXS = kD + kPad;   // bf16 row stride of a warp's tiles
  static constexpr int kNT = kD / 8;      // 8-wide n-tiles of D
  // a warp's: two x buffers and the xc tile (16, kXS) each
  static constexpr size_t kTile = sizeof(__nv_bfloat16) * kWarpRows * kXS;
  static constexpr size_t kWarpBytes = 3 * kTile;
  // the block's: wq (kD, kWqS) fp32; the B fragments per lane of y = o wo
  // (uint32 [kNT][32]); ln_g, ln_b, bo (kD floats each); perm (kD ints)
  static constexpr size_t kOffWq = kWarps * kWarpBytes;
  static constexpr size_t kOffWo = kOffWq + sizeof(float) * kD * kWqS;
  static constexpr size_t kOffLn = kOffWo + sizeof(uint32_t) * kNT * 32;
  static constexpr size_t kOffPerm = kOffLn + sizeof(float) * 3 * kD;
  static constexpr size_t kBytes = kOffPerm + sizeof(int) * kD;
  // two blocks an SM, each with its 1 KB of reserved shared memory
  static_assert(2 * (kBytes + 1024) <= 233472, "over half an SM's shared memory");
  static_assert(kWarpBytes % 16 == 0, "16-byte aligned tiles");
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
cross_attn_fwd_tc(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                  Params p, int B) {
  static_assert(kD == 64 || kD == 128, "built for D = 64 and 128");
  using L = Layout<kD>;
  constexpr int kXS = L::kXS, kNT = L::kNT;
  constexpr int kChunks = kD / 8;   // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* wq32 = reinterpret_cast<float*>(smem + L::kOffWq);
  const uint32_t* wob = reinterpret_cast<const uint32_t*>(smem + L::kOffWo);
  float* g1 = reinterpret_cast<float*>(smem + L::kOffLn);
  float *be1 = g1 + kD, *bo = be1 + kD;
  int* perm = reinterpret_cast<int*>(smem + L::kOffPerm);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int N = p.N;
  const int tiles_per_b = (N + kWarpRows - 1) / kWarpRows;
  const long long n_tiles = (long long)B * tiles_per_b;
  auto* xbuf = reinterpret_cast<__nv_bfloat16*>(smem + warp * L::kWarpBytes);
  auto* xcb = xbuf + 2 * kWarpRows * kXS;   // xc = x[perm], then y

  // the weights, once per block: G-bwd's prefix copy, bo at its bf16 value,
  // and the B fragments (k = heads 2q, 2q + 1; n = column 8 nt + g) of wo at
  // its bf16 values
  stage_prefix<kD>(p, wq32, g1, be1, perm);
  for (int i = t; i < kD; i += kThreads) bo[i] = bf16_value(p.bo[i]);
  for (int i = t; i < kNT * 32; i += kThreads) {
    const int nt = i >> 5, l = i & 31, d = 8 * nt + (l >> 2), h = 2 * (l & 3);
    reinterpret_cast<uint32_t*>(smem + L::kOffWo)[i] =
        pack(p.wo[h * kD + d], p.wo[(h + 1) * kD + d]);
  }

  // this warp's tiles: a contiguous range
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  const int first = (int)(w * n_tiles / n_warps), last = (int)((w + 1) * n_tiles / n_warps);

  // a tile's 16 rows of x into the warp's buffer `buf` (zeros past N)
  auto load = [&](int tile, int buf) {
    const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * kWarpRows;
    const __nv_bfloat16* src = x + ((size_t)b * N + n0) * kD;
    __nv_bfloat16* dst = xbuf + buf * kWarpRows * kXS;
    for (int i = lane; i < kWarpRows * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = n0 + r < N;
      cp_async16(dst + r * kXS + c, ok ? src + (size_t)r * kD + c : x, ok);
    }
  };
  if (first < last) load(first, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int buf = it & 1;
    if (tile + 1 < last) load(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * kWarpRows;
    __nv_bfloat16* xt = xbuf + buf * kWarpRows * kXS;

    // xc = x[perm] at this lane's elements (rows g, g + 8; columns 8 nt +
    // 2q, + 1) into the warp's xc tile: from here on each lane reads and
    // writes only its own elements of it
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = nt * 8 + 2 * q;
      const int2 src = *reinterpret_cast<const int2*>(perm + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = g + 8 * i;
        *reinterpret_cast<__nv_bfloat162*>(xcb + r * kXS + col) =
            __halves2bfloat162(xt[r * kXS + src.x], xt[r * kXS + src.y]);
      }
    }
    auto xc = [&](int nt) {
      const auto* at = reinterpret_cast<const __nv_bfloat162*>(xcb + g * kXS) + 4 * nt + q;
      const float2 a = __bfloat1622float2(at[0]), c = __bfloat1622float2(at[4 * kXS]);
      return make_float4(a.x, a.y, c.x, c.y);
    };

    // LN1, q and the softmax, as G-bwd recomputes them; element c of o is
    // row g + 8 (c >> 1), head 2q + (c & 1)
    float mu[2], rs[2], qa[4], o[4];
    row_stats<kD>(xc, p.eps, mu, rs);
    head_queries<kD>(xc, [](int, int, float, float) {}, mu, rs, wq32, g1, be1, q, qa);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float kr[kM], vr[kM];
      head_tokens(p, b, 2 * q + e, kr, vr);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ev[kM], den;
        o[2 * i + e] = softmax_o(qa[2 * i + e], kr, vr, ev, den);
      }
    }

    // y = o wo + (xc + bo): o (hi, lo) is the A operand (k = the heads), its
    // rows g and g + 8 exactly this lane's accumulator elements
    uint32_t oh[2], ol[2];
    split2(o[0], o[1], oh[0], ol[0]);
    split2(o[2], o[3], oh[1], ol[1]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = 8 * nt + 2 * q;
      const float2 bb = *reinterpret_cast<const float2*>(bo + col);
      const float4 v = xc(nt);
      float acc[4] = {v.x + bb.x, v.y + bb.y, v.z + bb.x, v.w + bb.y};
      const uint32_t wb = wob[nt * 32 + lane];
      mma_k8(acc, oh, wb);
      mma_k8(acc, ol, wb);
      *reinterpret_cast<__nv_bfloat162*>(xcb + g * kXS + col) =
          __floats2bfloat162_rn(acc[0], acc[1]);
      *reinterpret_cast<__nv_bfloat162*>(xcb + (g + 8) * kXS + col) =
          __floats2bfloat162_rn(acc[2], acc[3]);
    }

    // y: the xc tile as 16-byte rows; rows past N are not stored
    __syncwarp();
    __nv_bfloat16* dst = out + ((size_t)b * N + n0) * kD;
    for (int i = lane; i < kWarpRows * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (n0 + r < N)
        *reinterpret_cast<uint4*>(dst + (size_t)r * kD + c) =
            *reinterpret_cast<const uint4*>(xcb + r * kXS + c);
    }
    __syncwarp();
  }
}

// resident blocks of cross_attn_fwd_tc<kD> in one wave on the current device
template <int kD>
cudaError_t resident_blocks(int* blocks) {
  static int cached = 0;
  cudaError_t err = tc::resident_blocks(cross_attn_fwd_tc<kD>, Layout<kD>::kBytes, &cached);
  *blocks = cached;
  return err;
}

template <int kD>
cudaError_t launch(const void* x, void* out, const Params& p, int B, cudaStream_t stream) {
  int resident = 0;   // and the kernel's shared-memory size set, once
  cudaError_t err = resident_blocks<kD>(&resident);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((p.N + kWarpRows - 1) / kWarpRows);
  const int blocks = (int)std::min<long long>(resident, (tiles + kWarps - 1) / kWarps);
  cross_attn_fwd_tc<kD><<<blocks, kThreads, Layout<kD>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), p, B);
  return cudaGetLastError();
}

}  // namespace tcg

}  // namespace

// x, out: (B, N, D) fp32 or bf16, contiguous. perm: (D,) int32 source lane
// per output lane, or null. Weights fp32, contiguous, in (in, out) layout:
// ln_g, ln_b, bo (D,), wq (D, h), wo (h, D); kexp/vexp (B, h, M) with the
// softmax scale folded into kexp. Built for h = 8, M = 8 and D in {64, 128,
// 256, 384, 512}; other sizes return cudaErrorInvalidValue.
extern "C" int cross_attn_fwd(const void* x, const void* perm, const void* ln_g,
                              const void* ln_b, const void* wq, const void* kexp,
                              const void* vexp, const void* wo, const void* bo, void* out,
                              int B, int N, int D, int heads, int M, int is_bf16, float eps,
                              void* stream) {
  if (heads != kHeads || M != kM || N <= 0 || B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.perm = static_cast<const int*>(perm);
  p.ln1_g = static_cast<const float*>(ln_g);
  p.ln1_b = static_cast<const float*>(ln_b);
  p.wq = static_cast<const float*>(wq);
  p.kexp = static_cast<const float*>(kexp);
  p.vexp = static_cast<const float*>(vexp);
  p.wo = static_cast<const float*>(wo);
  p.bo = static_cast<const float*>(bo);
  p.N = N;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(smow::xlayer::dispatch_attn(D, is_bf16, [&](auto t, auto d) {
    constexpr int kD = decltype(d)::value;
    using T = typename decltype(t)::type;
    if constexpr (std::is_same<T, __nv_bfloat16>::value && kD <= 128)
      return tcg::launch<kD>(x, out, p, B, s);
    else
      return launch<T, kD>(x, out, p, B, s);
  }));
}

// G's grid for the width and dtype on the current device: *ctas, the blocks
// resident in one wave; *tile_rows, the rows of a tile; *tiles_per_block,
// the tiles a block takes at once (the bf16 kernel at D <= 128: one per
// warp, persistent; the first design launches one block per tile).
extern "C" int cross_attn_fwd_grid(int D, int is_bf16, int* ctas, int* tile_rows,
                                   int* tiles_per_block) {
  return static_cast<int>(smow::xlayer::dispatch_attn(D, is_bf16, [&](auto t, auto d) {
    constexpr int kD = decltype(d)::value;
    using T = typename decltype(t)::type;
    if constexpr (std::is_same<T, __nv_bfloat16>::value && kD <= 128) {
      *tile_rows = tcg::kWarpRows;
      *tiles_per_block = tcg::kWarps;
      return tcg::resident_blocks<kD>(ctas);
    } else {
      static int cached = 0;
      *tile_rows = kAttnRows<kD>;
      *tiles_per_block = 1;
      cudaError_t err = tc::resident_blocks(cross_attn_fwd_kernel<T, kD>, kSmemBytes<kD>, &cached);
      *ctas = cached;
      return err;
    }
  }));
}
