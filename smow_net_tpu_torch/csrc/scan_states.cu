// Kernel J: the state recurrence of the general selective scan.
//
// Replaces `_scan_states` / `_scan_kernel` (pallas_call :82) in
// smow_net_tpu/ops/pallas/scan.py, which `selective_scan_pallas` (:122) runs
// once forward and twice backward (`_bwd` :133: the states again, and the
// reverse adjoint). Over precomputed fp32 operands dA = exp(dt A) and
// dBu = dt u B, (B, L, K) with K = D * N lanes (any N; the softplus of dt,
// if any, was taken by the caller), it computes from h = 0
//   h_t = dA_t h_{t-1} + dBu_t          forward, t = 0 .. L - 1
//   h_t = dA_t h_{t+1} + dBu_t          reverse, t = L - 1 .. 0
// in fp32, one rounding per step as the Pallas kernel takes it.
//
// What bounds it on the card: memory. Each element is read twice (dA, dBu)
// and written once, 12 bytes, and takes one FMA: 12 B per element over
// 3.35 TB/s. The general route materialises these (B, L, D, N) operands in
// device memory as the JAX package does; the fused kernels H and I, which
// never do, stay the fast route for the shapes they take (N = 16, softplus).
//
// Design: the TPU kernel walked L in VMEM chunks with (D_blk * N) on the
// lanes and carried the state across its sequential grid. Here one thread
// owns one (batch row, lane) and walks L with its state in a register;
// consecutive threads own consecutive lanes, so a warp's loads coalesce into
// 128-byte rows. The walk is serial, so a thread issues the loads of
// kSteps steps together before it uses the first (one load per step waits
// a memory latency each, as kernel H's first build showed), and blocks are
// small so that B * K / kThreads blocks spread over the SMs.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kSteps = 16;    // steps whose loads are in flight together

template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
scan_states_kernel(const float* __restrict__ dA, const float* __restrict__ dBu,
                   float* __restrict__ h, int L, int K, int lane_blocks) {
  const int b = blockIdx.x / lane_blocks;
  const int lane = (blockIdx.x % lane_blocks) * kThreads + threadIdx.x;
  if (lane >= K) return;
  const size_t row = (size_t)b * L * K + lane;
  // step i of the walk is time t = i (forward) or L - 1 - i (reverse)
  auto at = [&](int i) { return row + (size_t)(kReverse ? L - 1 - i : i) * K; };
  float state = 0.f;
  int i = 0;
  for (; i + kSteps <= L; i += kSteps) {
    float va[kSteps], vb[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      va[j] = __ldg(dA + at(i + j));
      vb[j] = __ldg(dBu + at(i + j));
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      state = va[j] * state + vb[j];
      h[at(i + j)] = state;
    }
  }
  for (; i < L; ++i) {
    state = __ldg(dA + at(i)) * state + __ldg(dBu + at(i));
    h[at(i)] = state;
  }
}

}  // namespace

// dA, dBu: (B, L, K) fp32; writes h: (B, L, K) fp32, walked from the end
// when reverse is 1.
extern "C" int scan_states(const void* dA, const void* dBu, void* h, int B, int L, int K,
                           int reverse, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || (reverse != 0 && reverse != 1)) return cudaErrorInvalidValue;
  const int lane_blocks = (K + kThreads - 1) / kThreads;
  if ((long long)B * lane_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blocks(B * lane_blocks);
  const float* a = static_cast<const float*>(dA);
  const float* u = static_cast<const float*>(dBu);
  float* out = static_cast<float*>(h);
  if (reverse)
    scan_states_kernel<true><<<blocks, kThreads, 0, s>>>(a, u, out, L, K, lane_blocks);
  else
    scan_states_kernel<false><<<blocks, kThreads, 0, s>>>(a, u, out, L, K, lane_blocks);
  return static_cast<int>(cudaGetLastError());
}
