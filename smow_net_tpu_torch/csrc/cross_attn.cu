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
// without the MLP, and runs F's steps (xattn_layer.cuh) in F's order.
//
// What bounds it on the card: bytes. Per row it does 2 * 2 * D * h FLOP for
// the two projections and ~40 for the 8 x 8 softmax, against 4 D bytes of x
// and y in bf16: 8 FLOP per byte, far under the card's ~295. At SMOW_Net's
// decoder shape (16 x 16384 pixels, D = 128) that is 134 MB, 0.040 ms at
// 3.35 TB/s.
//
// Design: one block of 256 threads owns a tile of kAttnRows<D> pixel rows (64
// at D <= 128, 32 at D >= 256, so two fp32 tiles fit in shared memory up to
// D = 512); the width D is a template argument. The tile (after the index
// permutation) and its normalized copy live in shared memory as fp32; LN
// statistics are one warp per row, the 8 x 8 attention is one thread per
// (row, head), the out-projection one thread per element, written in place
// of the tile and stored with coalesced rows. The weights (2 x 8 x D floats)
// are read through the read-only cache. Rows past N (the ragged tail) are
// loaded as zeros and never stored. Weights arrive as fp32; only x and y take
// the activation dtype (fp32 or bf16), and all arithmetic is fp32.

#include "xattn_layer.cuh"

namespace {

using namespace smow::xlayer;
using smow::from_float;

template <int kD>
constexpr size_t kSmemBytes =
    (2 * kAttnRows<kD> * kRow<kD> + kAttnRows<kD> * kHeads) * sizeof(float);

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
cross_attn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, Params p) {
  constexpr int kRows = kAttnRows<kD>;
  constexpr int kR = kRow<kD>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // x tile, then y
  float* ns = xs + kRows * kR;                   // LN(x)
  float* os = ns + kRows * kR;                   // (kRows, kHeads) attention output

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int N = p.N;

  load_tile<kD, kRows>(x + (size_t)b * N * kD, p.perm, n0, N, xs);
  __syncthreads();
  layer_norm_rows<kD, kRows>(xs, ns, p.ln1_g, p.ln1_b, p.eps);
  __syncthreads();
  attention_rows<kD, kRows>(ns, p, b, os);
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
    return launch<typename decltype(t)::type, decltype(d)::value>(x, out, p, B, s);
  }));
}
