// Kernel I: the fused selective scan (Mamba S6) of the VMamba models' SS2D,
// as three sweeps: I-fwd (the output y), I-ckpt (the hidden state at the
// start of every chunk of kChunk steps) and I-bwd (h recomputed inside each
// chunk from its checkpoint, then the reverse adjoint sweep).
//
// Replaces, in smow_net_tpu/ops/pallas/scan_fused.py, `_fwd_kernel` (:147,
// reached by `_fwd_core`'s pallas_call :413), `_ckpt_kernel` (:261, the first
// pallas_call of `_bwd_core`, :517) and `_bwd_kernel` (:291, its second,
// :541): the kernels `selective_scan_fused_grouped` (:841) runs for every
// SS2D call of ChangeMamba.
//
// Layouts (the direction-major grouped ones; row r = b * K + k):
//   u, dts, y, dy   (rows, L, Dk)               fp32 or bf16 (one dtype)
//   Bm, Cm          (rows, L, 16)               the same dtype
//   A               (K, 16, Dk)                 fp32, already -exp(A_log)
//   Dv, bias        (K * Dk)                    fp32
//   hck             (rows, ceil(L / 16), 16, Dk) fp32
//   dus, ddt        (rows, L, Dk)               fp32
//   dBp, dCp        (ceil(Dk / 16), rows, L, 16) fp32: one partial sum per
//                                               16-channel block, summed by
//                                               the caller
//   dA              (rows, 16, Dk)              fp32, summed over L
// Per (row, channel, state n), in fp32:
//   dt_l = softplus(dts_l + bias)   (jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0))
//   h_l  = exp(dt_l A_n) h_{l-1} + B_l[n] (dt_l u_l)
//   y_l  = sum_n C_l[n] h_l[n] + D u_l
// and the adjoint g_l = C_l dy_l + exp(dt_{l+1} A) g_{l+1}, walked backwards.
//
// What bounds it on the card: the exponentials. Every (row, step, channel,
// state) takes one exp on the multi-function unit (16 per clock per SM); the
// bytes are about 8 per (row, step, channel). The backward takes three exps
// per state-step (checkpoint sweep, recompute, reverse sweep).
//
// Design: the TPU kernels tiled (bt rows, chunk, Cg lanes) for VMEM and the
// 128 lanes. Here two lanes own one (row, channel), eight of its 16 states
// each in registers, and walk L; a block is one warp of 16 channels, small
// so that several blocks share an SM and one block's loads overlap another's
// arithmetic (the walk is serial, so warps in flight, not bytes, set the
// pace). y and the per-channel sums take one shuffle between the two lanes.
// The B and C rows of a chunk of 16 steps (shared by every channel of the
// row) are staged in shared memory; a full chunk's 16 steps run without a
// branch, the softplus of all 16 taken up front, so one step's exps overlap
// the last one's sums. I-bwd keeps the chunk's states per lane in shared
// memory (16 KB a block), sums dB and dC over the warp's 16 channels at
// every step with a butterfly of shuffles that leaves each lane group one
// state's sum (no atomics, so the result is the same on every run), and
// sums dA over L in registers.

#include "common.cuh"

namespace {

constexpr int kN = 16;        // d_state
constexpr int kHalf = 8;      // states per lane: two lanes per channel
constexpr int kChunk = 16;    // steps per chunk: the checkpoint interval
constexpr int kLanes = 32;    // threads per block: one warp
constexpr int kChannels = kLanes / 2;   // channels per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

// The chunk's n_t rows of 16 values starting at `src` (contiguous) into
// dst[t][n] as fp32; rows past n_t are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, float (*dst)[kN], int n_t) {
  for (int i = threadIdx.x; i < kChunk * kN; i += kLanes)
    dst[i / kN][i % kN] = (i / kN < n_t) ? smow::to_float(src[i]) : 0.f;
}

// One step of the butterfly: keep half of the 2W values, send the other half
// to the lane kDist away, add what it sends.
template <int W, int kDist>
__device__ __forceinline__ void fold(float (&v)[kHalf], bool hi) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = hi ? v[i] : v[i + W];
    const float keep = hi ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kDist);
  }
}

// Sum each lane's 8 values over the warp's 16 channels (lane bits 1-4; bit
// 0 picks the half of the states): on return, v[0] of lane l holds the sum
// for state (l & 1) * 8 + ((l >> 2) & 7) (lanes l and l ^ 2 hold the same).
__device__ __forceinline__ void channel_sum8(float (&v)[kHalf], int lane) {
  fold<4, 16>(v, lane & 16);
  fold<2, 8>(v, lane & 8);
  fold<1, 4>(v, lane & 4);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
}

// One thread's column of a chunk: u, dt = softplus(dts + bias) and, for
// I-bwd, dy, for the chunk's n_t steps (zeros past them). All loads and
// softpluses are independent, so they issue together.
template <typename T, bool kFull>
__device__ __forceinline__ void load_chunk(const T* __restrict__ u, const T* __restrict__ dts,
                                           const T* __restrict__ dy, size_t at, int Dk, int n_t,
                                           float bias_c, bool active,
                                           float (&uu)[kChunk], float (&dd)[kChunk],
                                           float (&gy)[kChunk]) {
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    uu[t] = 0.f;
    dd[t] = 0.f;
    gy[t] = 0.f;
    if (kFull || t < n_t) {
      const size_t i = at + (size_t)t * Dk;
      uu[t] = smow::to_float(u[i]);
      dd[t] = softplus(smow::to_float(dts[i]) + bias_c);
      if (dy != nullptr && active) gy[t] = smow::to_float(dy[i]);
    }
  }
}

// I-fwd's (or I-ckpt's) steps of one chunk over this lane's 8 states (n0..);
// the lane with n0 = 0 stores y. kFull: all kChunk steps, with no per-step
// branch, so the compiler can overlap one step's exps with the last one's
// sums.
template <typename T, bool kCkpt, bool kFull>
__device__ __forceinline__ void fwd_steps(const float (&uu)[kChunk], const float (&dd)[kChunk],
                                          const float (*sB)[kN], const float (*sC)[kN],
                                          const float (&a2)[kHalf], float (&h)[kHalf], int n0,
                                          float d_c, T* __restrict__ y, size_t at, int Dk,
                                          int n_t, bool store) {
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    if (kFull || t < n_t) {
      const float dt = dd[t], dtu = dt * uu[t];
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        h[i] = exp2f(dt * a2[i]) * h[i] + sB[t][n0 + i] * dtu;
        if (!kCkpt) acc[i % 2] += sC[t][n0 + i] * h[i];
      }
      if (!kCkpt) {
        float sum = acc[0] + acc[1];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        if (store) y[at + (size_t)t * Dk] = smow::from_float<T>(sum + d_c * uu[t]);
      }
    }
  }
}

// I-fwd (kCkpt = false): y. I-ckpt (kCkpt = true): the state before every
// chunk into hck, no y (Cm, Dv and y are not read).
template <typename T, bool kCkpt>
__global__ void __launch_bounds__(kLanes)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dts, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ A,
                const float* __restrict__ Dv, const float* __restrict__ bias,
                T* __restrict__ y, float* __restrict__ hck, int L, int Dk, int K) {
  __shared__ float sB[kChunk][kN];
  __shared__ float sC[kChunk][kN];
  const int lane = threadIdx.x;
  const int r = blockIdx.y;
  const int c = blockIdx.x * kChannels + (lane >> 1);
  const int n0 = (lane & 1) * kHalf;
  const bool active = c < Dk;
  const int cc = active ? c : Dk - 1;     // idle lanes read a valid channel, store nothing
  const int k = r % K;
  float a2[kHalf], h[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    a2[i] = A[((size_t)k * kN + n0 + i) * Dk + cc] * kLog2e;   // exp(dt A) = exp2(dt a2)
    h[i] = 0.f;
  }
  const float bias_c = bias[(size_t)k * Dk + cc];
  const float d_c = kCkpt ? 0.f : Dv[(size_t)k * Dk + cc];
  const bool store = active && n0 == 0;
  const size_t row = (size_t)r * L;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  for (int j = 0; j < n_chunks; ++j) {
    const int l0 = j * kChunk;
    const int n_t = min(kChunk, L - l0);
    const bool full = n_t == kChunk;
    const size_t at = (row + l0) * Dk + cc;
    if (kCkpt && active) {
      float* dst = hck + (((size_t)r * n_chunks + j) * kN + n0) * Dk + c;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) dst[(size_t)i * Dk] = h[i];
    }
    float uu[kChunk], dd[kChunk], unused[kChunk];
    if (full)
      load_chunk<T, true>(u, dts, nullptr, at, Dk, n_t, bias_c, active, uu, dd, unused);
    else
      load_chunk<T, false>(u, dts, nullptr, at, Dk, n_t, bias_c, active, uu, dd, unused);
    __syncthreads();    // the previous chunk's rows are read
    stage_rows<T>(Bm + (row + l0) * kN, sB, n_t);
    if (!kCkpt) stage_rows<T>(Cm + (row + l0) * kN, sC, n_t);
    __syncthreads();
    if (full)
      fwd_steps<T, kCkpt, true>(uu, dd, sB, sC, a2, h, n0, d_c, y, at, Dk, n_t, store);
    else
      fwd_steps<T, kCkpt, false>(uu, dd, sB, sC, a2, h, n0, d_c, y, at, Dk, n_t, store);
  }
}

// I-bwd's work on one chunk over this lane's 8 states (n0..): h from the
// chunk's checkpoint forward through it (the state before every step kept in
// sH), then the reverse sweep.
template <bool kFull>
__device__ __forceinline__ void bwd_steps(const float (&uu)[kChunk], const float (&dd)[kChunk],
                                          const float (&gy)[kChunk], const float (*sB)[kN],
                                          const float (*sC)[kN], float (*sH)[kHalf][kLanes],
                                          const float (&a2)[kHalf], float (&h)[kHalf],
                                          float (&g)[kHalf], float (&a_next)[kHalf],
                                          float (&dA_acc)[kHalf], int n0,
                                          float* __restrict__ dus, float* __restrict__ ddt,
                                          float* __restrict__ dB_blk, float* __restrict__ dC_blk,
                                          size_t at, int l0, int Dk, int n_t, bool store,
                                          int lane) {
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    if (kFull || t < n_t) {
      const float dtu = dd[t] * uu[t];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        sH[t][i][lane] = h[i];
        h[i] = exp2f(dd[t] * a2[i]) * h[i] + sB[t][n0 + i] * dtu;
      }
    }
  }
  // h is the state after the chunk's last step; each reverse step turns it
  // into the state before that step
#pragma unroll
  for (int t = kChunk - 1; t >= 0; --t) {
    if (kFull || t < n_t) {
      const float dt = dd[t], dyv = gy[t], dtu = dt * uu[t];
      float s = 0.f, s_a = 0.f, vB[kHalf], vC[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float hp = sH[t][i][lane];
        const float a = exp2f(dt * a2[i]);
        g[i] = sC[t][n0 + i] * dyv + a_next[i] * g[i];
        a_next[i] = a;
        const float gha = g[i] * hp * a;
        s += g[i] * sB[t][n0 + i];
        s_a += gha * a2[i];
        dA_acc[i] += gha * dt;
        vB[i] = g[i] * dtu;
        vC[i] = h[i] * dyv;
        h[i] = hp;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s_a += __shfl_xor_sync(0xffffffffu, s_a, 1);
      if (store) {
        dus[at + (size_t)t * Dk] = dt * s;
        ddt[at + (size_t)t * Dk] = uu[t] * s + s_a * kLn2;     // sum_n gha A_n
      }
      channel_sum8(vB, lane);
      channel_sum8(vC, lane);
      if ((lane & 2) == 0) {
        const int n = n0 + ((lane >> 2) & 7);
        dB_blk[(size_t)(l0 + t) * kN + n] = vB[0];
        dC_blk[(size_t)(l0 + t) * kN + n] = vC[0];
      }
    }
  }
}

// I-bwd: chunks last to first. ddt is the gradient with respect to dt after
// the softplus (the caller applies its derivative, as the JAX package's
// epilogue does).
template <typename T>
__global__ void __launch_bounds__(kLanes)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dts, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dy,
                const float* __restrict__ A, const float* __restrict__ bias,
                const float* __restrict__ hck, float* __restrict__ dus, float* __restrict__ ddt,
                float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ dA, int L,
                int Dk, int K) {
  __shared__ float sH[kChunk][kHalf][kLanes];
  __shared__ float sB[kChunk][kN];
  __shared__ float sC[kChunk][kN];
  const int lane = threadIdx.x;
  const int r = blockIdx.y;
  const int c = blockIdx.x * kChannels + (lane >> 1);
  const int n0 = (lane & 1) * kHalf;
  const bool active = c < Dk;
  const int cc = active ? c : Dk - 1;     // idle lanes see dy = 0: g, dB, dC stay 0
  const int k = r % K;
  float a2[kHalf], g[kHalf], a_next[kHalf], dA_acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    a2[i] = A[((size_t)k * kN + n0 + i) * Dk + cc] * kLog2e;
    g[i] = 0.f;
    a_next[i] = 0.f;
    dA_acc[i] = 0.f;
  }
  const float bias_c = bias[(size_t)k * Dk + cc];
  const bool store = active && n0 == 0;
  const size_t row = (size_t)r * L;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  float* dB_blk = dBp + ((size_t)blockIdx.x * gridDim.y + r) * L * kN;
  float* dC_blk = dCp + ((size_t)blockIdx.x * gridDim.y + r) * L * kN;
  for (int j = n_chunks - 1; j >= 0; --j) {
    const int l0 = j * kChunk;
    const int n_t = min(kChunk, L - l0);
    const bool full = n_t == kChunk;
    const size_t at = (row + l0) * Dk + cc;
    float uu[kChunk], dd[kChunk], gy[kChunk], h[kHalf];
    if (full)
      load_chunk<T, true>(u, dts, dy, at, Dk, n_t, bias_c, active, uu, dd, gy);
    else
      load_chunk<T, false>(u, dts, dy, at, Dk, n_t, bias_c, active, uu, dd, gy);
    const float* ck = hck + (((size_t)r * n_chunks + j) * kN + n0) * Dk + cc;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) h[i] = ck[(size_t)i * Dk];
    __syncthreads();    // the previous chunk's rows are read
    stage_rows<T>(Bm + (row + l0) * kN, sB, n_t);
    stage_rows<T>(Cm + (row + l0) * kN, sC, n_t);
    __syncthreads();
    if (full)
      bwd_steps<true>(uu, dd, gy, sB, sC, sH, a2, h, g, a_next, dA_acc, n0, dus, ddt, dB_blk,
                      dC_blk, at, l0, Dk, n_t, store, lane);
    else
      bwd_steps<false>(uu, dd, gy, sB, sC, sH, a2, h, g, a_next, dA_acc, n0, dus, ddt, dB_blk,
                       dC_blk, at, l0, Dk, n_t, store, lane);
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) dA[((size_t)r * kN + n0 + i) * Dk + c] = dA_acc[i];
  }
}

bool bad_shape(int rows, int L, int Dk, int K) {
  return rows <= 0 || L <= 0 || Dk <= 0 || K <= 0 || rows % K != 0 || rows > 65535;
}

template <typename T, bool kCkpt>
cudaError_t launch_fwd(const void* u, const void* dts, const void* Bm, const void* Cm,
                       const void* A, const void* Dv, const void* bias, void* y, void* hck,
                       int rows, int L, int Dk, int K, cudaStream_t s) {
  const dim3 grid((Dk + kChannels - 1) / kChannels, rows);
  scan_fwd_kernel<T, kCkpt><<<grid, kLanes, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dts), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const float*>(Dv),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<float*>(hck), L, Dk, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* u, const void* dts, const void* Bm, const void* Cm,
                       const void* dy, const void* A, const void* bias, const void* hck,
                       void* dus, void* ddt, void* dBp, void* dCp, void* dA, int rows, int L,
                       int Dk, int K, cudaStream_t s) {
  const dim3 grid((Dk + kChannels - 1) / kChannels, rows);
  scan_bwd_kernel<T><<<grid, kLanes, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dts), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(dy), static_cast<const float*>(A),
      static_cast<const float*>(bias), static_cast<const float*>(hck), static_cast<float*>(dus),
      static_cast<float*>(ddt), static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dA), L, Dk, K);
  return cudaGetLastError();
}

}  // namespace

// I-fwd: y (rows, L, Dk) in u's dtype.
extern "C" int selective_scan_fwd(const void* u, const void* dts, const void* Bm, const void* Cm,
                                  const void* A, const void* Dv, const void* bias, void* y,
                                  int rows, int L, int Dk, int K, int is_bf16, void* stream) {
  if (bad_shape(rows, L, Dk, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16, false>(u, dts, Bm, Cm, A, Dv, bias, y, nullptr, rows,
                                                 L, Dk, K, s)
              : launch_fwd<float, false>(u, dts, Bm, Cm, A, Dv, bias, y, nullptr, rows, L, Dk,
                                         K, s);
  return static_cast<int>(err);
}

// I-ckpt: hck (rows, ceil(L / 16), 16, Dk) fp32, the state before each chunk.
extern "C" int selective_scan_ckpt(const void* u, const void* dts, const void* Bm, const void* A,
                                   const void* bias, void* hck, int rows, int L, int Dk, int K,
                                   int is_bf16, void* stream) {
  if (bad_shape(rows, L, Dk, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16, true>(u, dts, Bm, nullptr, A, nullptr, bias, nullptr,
                                                hck, rows, L, Dk, K, s)
              : launch_fwd<float, true>(u, dts, Bm, nullptr, A, nullptr, bias, nullptr, hck,
                                        rows, L, Dk, K, s);
  return static_cast<int>(err);
}

// I-bwd: dus, ddt (rows, L, Dk), the per-block partials dBp, dCp
// (ceil(Dk / 16), rows, L, 16) and dA (rows, 16, Dk), all fp32.
extern "C" int selective_scan_bwd(const void* u, const void* dts, const void* Bm, const void* Cm,
                                  const void* dy, const void* A, const void* bias,
                                  const void* hck, void* dus, void* ddt, void* dBp, void* dCp,
                                  void* dA, int rows, int L, int Dk, int K, int is_bf16,
                                  void* stream) {
  if (bad_shape(rows, L, Dk, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(u, dts, Bm, Cm, dy, A, bias, hck, dus, ddt, dBp, dCp,
                                          dA, rows, L, Dk, K, s)
              : launch_bwd<float>(u, dts, Bm, Cm, dy, A, bias, hck, dus, ddt, dBp, dCp, dA,
                                  rows, L, Dk, K, s);
  return static_cast<int>(err);
}
