// Kernel I: the fused selective scan (Mamba S6), as three sweeps: I-fwd (the
// output y), I-ckpt (the hidden state at the start of every chunk of kChunk
// steps) and I-bwd (h recomputed inside each chunk from its checkpoint, then
// the reverse adjoint sweep). Kernel H is the same three sweeps over the flat
// (B, L, G * Cg) layout, read in place. Kernel H-seg, the segmented long-L
// scan, adds two sweeps: the carry (I-fwd's sweep that writes only each
// segment's final state and its dt sum) and the adjoint carry (the reverse
// recurrence of the adjoint alone); I-fwd, I-ckpt and I-bwd then run seeded
// with each segment's incoming state and adjoint.
//
// Replaces, in smow_net_tpu/ops/pallas/scan_fused.py, `_fwd_kernel` (:147,
// reached by `_fwd_core`'s pallas_call :413), `_ckpt_kernel` (:261, the first
// pallas_call of `_bwd_core`, :517) and `_bwd_kernel` (:291, its second,
// :541): the kernels `selective_scan_fused_grouped` (:841) runs for every
// SS2D call of ChangeMamba and `selective_scan_fused` (:754) for every scan
// of CD-Mamba; and `_carry_kernel` (:188, `_carry_core`'s pallas_call :445)
// and `_adjcarry_kernel` (:223, `_adjcarry_core`'s pallas_call :473), which
// `_fwd_segmented` (:630) and `_bwd_segmented` (:657) run.
//
// Rows. A row r = b * G + g (group g takes A, D and the bias of group g) of a
// sequence of S * L steps is cut into S segments of L steps; the kernels walk
// row r' = r * S + s, from step s * L. Two layouts (W: the channels Dk, or
// 16 for B and C):
//   grouped (flat = 0)  (B * G, S * L, W)       ChangeMamba's direction-major
//   flat    (flat = 1)  (B, S * L, G, W)        the (B, L, G * Cg) contract
// u, dts, y, dy, dus and ddt have width Dk; Bm, Cm, dBp and dCp width 16.
//   u, dts, y, dy   fp32 or bf16 (one dtype)
//   A               (G, 16, Dk)                 fp32, already -exp(A_log)
//   Dv, bias        (G * Dk)                    fp32
//   h0, g0, a0, hend, gend (rows', 16, Dk)      fp32 (rows' = B * G * S)
//   csum            (rows', Dk)                 fp32: the segment's dt sum
//   hck             (rows', ceil(L / 16), 16, Dk) fp32
//   dus, ddt        u's layout                  fp32
//   dBp, dCp        ceil(Dk / 16) x Bm's layout fp32: one partial sum per
//                                               16-channel block, summed by
//                                               the caller
//   dA              (rows', 16, Dk)             fp32, summed over the segment
// Per (row, channel, state n), in fp32:
//   dt_l = softplus(dts_l + bias)   (jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0))
//   h_l  = exp(dt_l A_n) h_{l-1} + B_l[n] (dt_l u_l),  h_{-1} = h0 (0 when null)
//   y_l  = sum_n C_l[n] h_l[n] + D u_l
// and the adjoint g_l = C_l dy_l + exp(dt_{l+1} A) g_{l+1}, walked backwards
// from g_L = g0 with exp(dt_L A) = a0 (both 0 when null).
//
// What bounds it on the card: the exponentials. Every (row, step, channel,
// state) takes one exp on the multi-function unit (16 per clock per SM); the
// bytes are about 8 per (row, step, channel). The backward takes three exps
// per state-step (checkpoint sweep, recompute, reverse sweep). At CD-Mamba's
// long sequences (L = 65536, 32-64 rows of 32 channels) the rows give one
// warp per SM or less, and a serial walk with nothing to hide its latency is
// far from that bound: segmenting L multiplies the rows by S at the cost of
// the carry sweeps (ops/scan.py `seg_count` decides).
//
// Design: the TPU kernels tiled (bt rows, chunk, Cg lanes) for VMEM and the
// 128 lanes. Here two lanes own one (row, channel), eight of its 16 states
// each in registers, and walk L; a block is one warp of 16 channels, small
// so that several blocks share an SM and one block's loads overlap another's
// arithmetic (the walk is serial, so warps in flight, not bytes, set the
// pace). y and the per-channel sums take one shuffle between the two lanes.
// The B and C rows of a chunk of 16 steps (shared by every channel of the
// row) are staged in shared memory, every load of a chunk issued before the
// first is waited on; a full chunk's 16 steps run without a branch, the
// softplus of all 16 taken up front, so one step's exps overlap the last
// one's sums. I-bwd keeps the chunk's states per lane in shared
// memory (16 KB a block), sums dB and dC over the warp's 16 channels at
// every step with a butterfly of shuffles that leaves each lane group one
// state's sum (no atomics, so the result is the same on every run), and
// sums dA over L in registers. Each kernel computes its rows' offsets from
// the layout, so the flat layout needs no transposed copy on either side.

#include "common.cuh"

namespace {

constexpr int kN = 16;        // d_state
constexpr int kHalf = 8;      // states per lane: two lanes per channel
constexpr int kChunk = 16;    // steps per chunk: the checkpoint interval
constexpr int kLanes = 32;    // threads per block: one warp
constexpr int kChannels = kLanes / 2;   // channels per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// I-fwd's sweep writes y, I-ckpt's the chunk-start states, the carry's the
// final state and the dt sum
enum { kModeFwd = 0, kModeCkpt = 1, kModeCarry = 2 };

// Where row r' = row0 + blockIdx.y of a launch lies in its tensors (see the
// header); the layout is a template parameter, so the grouped layout's
// strides are the compile-time widths. Grid y stops at 65535, so a call of
// more rows is launched in slices of rows, each from its row0.
template <bool kFlat>
struct Rows {
  int L;      // steps each row walks
  int S;      // segments per sequence
  int G;      // groups
  int row0;   // the launch's first row
  int rows;   // the call's rows (all launches)

  __device__ __forceinline__ int group(int rs) const { return (rs / S) % G; }
  // distance between consecutive steps in a tensor of width W
  __device__ __forceinline__ int step(int W) const { return kFlat ? G * W : W; }
  // offset of row rs's first step in a tensor of width W
  __device__ __forceinline__ size_t base(int rs, int W) const {
    if (!kFlat) return (size_t)rs * L * W;    // rows of S * L steps: r * S * L + s * L = rs * L
    const int r = rs / S, s = rs % S;
    return ((size_t)(r / G) * S * L * G + (r % G)) * W + (size_t)s * L * G * W;
  }
};

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

// A chunk's rows of B or C (16 values a step) pass through registers on the
// way to shared memory: each lane loads its kRowVals of the chunk's 16 x 16
// values, all loads issued together (with one warp per SM, as at CD-Mamba's
// long sequences, loads issued one after another cost a memory latency
// each), then stores them once the previous chunk's rows are read.
constexpr int kRowVals = kChunk * kN / kLanes;

// The chunk's n_t rows, row t at src + t * sn, as fp32 (zero past n_t).
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int sn, int n_t,
                                          float (&v)[kRowVals]) {
#pragma unroll
  for (int k = 0; k < kRowVals; ++k) {
    const int i = threadIdx.x + k * kLanes, t = i / kN, n = i % kN;
    v[k] = (t < n_t) ? smow::to_float(src[t * sn + n]) : 0.f;
  }
}

__device__ __forceinline__ void store_rows(const float (&v)[kRowVals], float (*dst)[kN]) {
#pragma unroll
  for (int k = 0; k < kRowVals; ++k) {
    const int i = threadIdx.x + k * kLanes;
    dst[i / kN][i % kN] = v[k];
  }
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

// One thread's column of a chunk: u (kU), dt = softplus(dts + bias) and dy
// (kDy), for the chunk's n_t steps (zeros past them; dy zero on idle lanes).
// All loads and softpluses are independent, so they issue together.
template <typename T, bool kFull, bool kU, bool kDy>
__device__ __forceinline__ void load_chunk(const T* __restrict__ u, const T* __restrict__ dts,
                                           const T* __restrict__ dy, size_t at, int su,
                                           int n_t, float bias_c, bool active,
                                           float (&uu)[kChunk], float (&dd)[kChunk],
                                           float (&gy)[kChunk]) {
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    uu[t] = 0.f;
    dd[t] = 0.f;
    gy[t] = 0.f;
    if (kFull || t < n_t) {
      const size_t i = at + t * su;
      if (kU) uu[t] = smow::to_float(u[i]);
      dd[t] = softplus(smow::to_float(dts[i]) + bias_c);
      if (kDy && active) gy[t] = smow::to_float(dy[i]);
    }
  }
}

// The forward sweep's steps of one chunk over this lane's 8 states (n0..);
// in kModeFwd the lane with n0 = 0 stores y. kFull: all kChunk steps, with
// no per-step branch, so the compiler can overlap one step's exps with the
// last one's sums.
template <typename T, int kMode, bool kFull>
__device__ __forceinline__ void fwd_steps(const float (&uu)[kChunk], const float (&dd)[kChunk],
                                          const float (*sB)[kN], const float (*sC)[kN],
                                          const float (&a2)[kHalf], float (&h)[kHalf], int n0,
                                          float d_c, T* __restrict__ y, size_t at, int su,
                                          int n_t, bool store) {
  constexpr bool kY = kMode == kModeFwd;
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    if (kFull || t < n_t) {
      const float dt = dd[t], dtu = dt * uu[t];
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        h[i] = exp2f(dt * a2[i]) * h[i] + sB[t][n0 + i] * dtu;
        if (kY) acc[i % 2] += sC[t][n0 + i] * h[i];
      }
      if (kY) {
        float sum = acc[0] + acc[1];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        if (store) y[at + t * su] = smow::from_float<T>(sum + d_c * uu[t]);
      }
    }
  }
}

// I-fwd (kModeFwd): y. I-ckpt (kModeCkpt): the state before every chunk into
// hout (rows', chunks, 16, Dk). The carry (kModeCarry): the state after the
// last step into hout (rows', 16, Dk) and the sum of dt into csum. Cm, Dv
// and y are read or written in kModeFwd only; h0 may be null.
template <typename T, int kMode, bool kFlat>
__global__ void __launch_bounds__(kLanes)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dts, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ A,
                const float* __restrict__ Dv, const float* __restrict__ bias,
                const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hout,
                float* __restrict__ csum, Rows<kFlat> rw, int Dk) {
  constexpr bool kY = kMode == kModeFwd;
  __shared__ float sB[kChunk][kN];
  __shared__ float sC[kChunk][kN];
  const int lane = threadIdx.x;
  const int r = rw.row0 + blockIdx.y;
  const int c = blockIdx.x * kChannels + (lane >> 1);
  const int n0 = (lane & 1) * kHalf;
  const bool active = c < Dk;
  const int cc = active ? c : Dk - 1;     // idle lanes read a valid channel, store nothing
  const int k = rw.group(r);
  float a2[kHalf], h[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    a2[i] = A[((size_t)k * kN + n0 + i) * Dk + cc] * kLog2e;   // exp(dt A) = exp2(dt a2)
    h[i] = (h0 != nullptr && active) ? h0[((size_t)r * kN + n0 + i) * Dk + c] : 0.f;
  }
  const float bias_c = bias[(size_t)k * Dk + cc];
  const float d_c = kY ? Dv[(size_t)k * Dk + cc] : 0.f;
  const bool store = active && n0 == 0;
  const int L = rw.L;
  const int su = rw.step(Dk), sn = rw.step(kN);
  const size_t row_u = rw.base(r, Dk) + cc, row_n = rw.base(r, kN);
  const int n_chunks = (L + kChunk - 1) / kChunk;
  float dsum = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    const int l0 = j * kChunk;
    const int n_t = min(kChunk, L - l0);
    const bool full = n_t == kChunk;
    const size_t at = row_u + (size_t)l0 * su;
    if (kMode == kModeCkpt && active) {
      float* dst = hout + (((size_t)r * n_chunks + j) * kN + n0) * Dk + c;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) dst[(size_t)i * Dk] = h[i];
    }
    float uu[kChunk], dd[kChunk], unused[kChunk], vB[kRowVals], vC[kRowVals];
    load_rows<T>(Bm + row_n + (size_t)l0 * sn, sn, n_t, vB);
    if (kY) load_rows<T>(Cm + row_n + (size_t)l0 * sn, sn, n_t, vC);
    if (full)
      load_chunk<T, true, true, false>(u, dts, nullptr, at, su, n_t, bias_c, active, uu, dd,
                                       unused);
    else
      load_chunk<T, false, true, false>(u, dts, nullptr, at, su, n_t, bias_c, active, uu, dd,
                                        unused);
    if (kMode == kModeCarry) {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) dsum += dd[t];    // zero past n_t
    }
    __syncthreads();    // the previous chunk's rows are read
    store_rows(vB, sB);
    if (kY) store_rows(vC, sC);
    __syncthreads();
    if (full)
      fwd_steps<T, kMode, true>(uu, dd, sB, sC, a2, h, n0, d_c, y, at, su, n_t, store);
    else
      fwd_steps<T, kMode, false>(uu, dd, sB, sC, a2, h, n0, d_c, y, at, su, n_t, store);
  }
  if (kMode == kModeCarry && active) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) hout[((size_t)r * kN + n0 + i) * Dk + c] = h[i];
    if (n0 == 0) csum[(size_t)r * Dk + c] = dsum;
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
                                          size_t at, int su, int l0, int sn, int n_t,
                                          bool store, int lane) {
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
        dus[at + t * su] = dt * s;
        ddt[at + t * su] = uu[t] * s + s_a * kLn2;     // sum_n gha A_n
      }
      channel_sum8(vB, lane);
      channel_sum8(vC, lane);
      if ((lane & 2) == 0) {
        const int n = n0 + ((lane >> 2) & 7);
        dB_blk[(size_t)(l0 + t) * sn + n] = vB[0];
        dC_blk[(size_t)(l0 + t) * sn + n] = vC[0];
      }
    }
  }
}

// I-bwd: chunks last to first, from the adjoint g0 and the decay a0 of the
// step after the row (null: 0). ddt is the gradient with respect to dt
// after the softplus (the caller applies its derivative, as the JAX
// package's epilogue does).
template <typename T, bool kFlat>
__global__ void __launch_bounds__(kLanes)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dts, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dy,
                const float* __restrict__ A, const float* __restrict__ bias,
                const float* __restrict__ hck, const float* __restrict__ g0,
                const float* __restrict__ a0, float* __restrict__ dus, float* __restrict__ ddt,
                float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ dA,
                Rows<kFlat> rw, int Dk) {
  __shared__ float sH[kChunk][kHalf][kLanes];
  __shared__ float sB[kChunk][kN];
  __shared__ float sC[kChunk][kN];
  const int lane = threadIdx.x;
  const int r = rw.row0 + blockIdx.y;
  const int c = blockIdx.x * kChannels + (lane >> 1);
  const int n0 = (lane & 1) * kHalf;
  const bool active = c < Dk;
  const int cc = active ? c : Dk - 1;     // idle lanes see dy = 0 and g = 0: dB, dC stay 0
  const int k = rw.group(r);
  float a2[kHalf], g[kHalf], a_next[kHalf], dA_acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const size_t at = ((size_t)r * kN + n0 + i) * Dk + c;
    a2[i] = A[((size_t)k * kN + n0 + i) * Dk + cc] * kLog2e;
    g[i] = (g0 != nullptr && active) ? g0[at] : 0.f;
    a_next[i] = (a0 != nullptr && active) ? a0[at] : 0.f;
    dA_acc[i] = 0.f;
  }
  const float bias_c = bias[(size_t)k * Dk + cc];
  const bool store = active && n0 == 0;
  const int L = rw.L;
  const int su = rw.step(Dk), sn = rw.step(kN);
  const size_t row_u = rw.base(r, Dk) + cc, row_n = rw.base(r, kN);
  const int n_chunks = (L + kChunk - 1) / kChunk;
  // this block's partial: block x of ceil(Dk / 16), each as large as Bm
  const size_t part = (size_t)blockIdx.x * rw.rows * L * kN;
  float* dB_blk = dBp + part + row_n;
  float* dC_blk = dCp + part + row_n;
  for (int j = n_chunks - 1; j >= 0; --j) {
    const int l0 = j * kChunk;
    const int n_t = min(kChunk, L - l0);
    const bool full = n_t == kChunk;
    const size_t at = row_u + (size_t)l0 * su;
    float uu[kChunk], dd[kChunk], gy[kChunk], h[kHalf], vB[kRowVals], vC[kRowVals];
    load_rows<T>(Bm + row_n + (size_t)l0 * sn, sn, n_t, vB);
    load_rows<T>(Cm + row_n + (size_t)l0 * sn, sn, n_t, vC);
    if (full)
      load_chunk<T, true, true, true>(u, dts, dy, at, su, n_t, bias_c, active, uu, dd, gy);
    else
      load_chunk<T, false, true, true>(u, dts, dy, at, su, n_t, bias_c, active, uu, dd, gy);
    const float* ck = hck + (((size_t)r * n_chunks + j) * kN + n0) * Dk + cc;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) h[i] = ck[(size_t)i * Dk];
    __syncthreads();    // the previous chunk's rows are read
    store_rows(vB, sB);
    store_rows(vC, sC);
    __syncthreads();
    if (full)
      bwd_steps<true>(uu, dd, gy, sB, sC, sH, a2, h, g, a_next, dA_acc, n0, dus, ddt, dB_blk,
                      dC_blk, at, su, l0, sn, n_t, store, lane);
    else
      bwd_steps<false>(uu, dd, gy, sB, sC, sH, a2, h, g, a_next, dA_acc, n0, dus, ddt, dB_blk,
                       dC_blk, at, su, l0, sn, n_t, store, lane);
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) dA[((size_t)r * kN + n0 + i) * Dk + c] = dA_acc[i];
  }
}

// The adjoint carry's steps of one chunk, last to first, over this lane's 8
// states: g_l = C_l dy_l + a_{l+1} g_{l+1}, then a_l = exp(dt_l A).
template <bool kFull>
__device__ __forceinline__ void adj_steps(const float (&dd)[kChunk], const float (&gy)[kChunk],
                                          const float (*sC)[kN], const float (&a2)[kHalf],
                                          float (&g)[kHalf], float (&a_next)[kHalf], int n0,
                                          int n_t) {
#pragma unroll
  for (int t = kChunk - 1; t >= 0; --t) {
    if (kFull || t < n_t) {
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        g[i] = sC[t][n0 + i] * gy[t] + a_next[i] * g[i];
        a_next[i] = exp2f(dd[t] * a2[i]);
      }
    }
  }
}

// The adjoint carry: the reverse sweep from zero incoming adjoint, reading
// dts, Cm and dy only; writes g at the row's first step into gout (rows',
// 16, Dk).
template <typename T, bool kFlat>
__global__ void __launch_bounds__(kLanes)
scan_adjcarry_kernel(const T* __restrict__ dts, const T* __restrict__ Cm,
                     const T* __restrict__ dy, const float* __restrict__ A,
                     const float* __restrict__ bias, float* __restrict__ gout, Rows<kFlat> rw,
                     int Dk) {
  __shared__ float sC[kChunk][kN];
  const int lane = threadIdx.x;
  const int r = rw.row0 + blockIdx.y;
  const int c = blockIdx.x * kChannels + (lane >> 1);
  const int n0 = (lane & 1) * kHalf;
  const bool active = c < Dk;
  const int cc = active ? c : Dk - 1;     // idle lanes see dy = 0: g stays 0
  const int k = rw.group(r);
  float a2[kHalf], g[kHalf], a_next[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    a2[i] = A[((size_t)k * kN + n0 + i) * Dk + cc] * kLog2e;
    g[i] = 0.f;
    a_next[i] = 0.f;
  }
  const float bias_c = bias[(size_t)k * Dk + cc];
  const int L = rw.L;
  const int su = rw.step(Dk), sn = rw.step(kN);
  const size_t row_u = rw.base(r, Dk) + cc, row_n = rw.base(r, kN);
  const int n_chunks = (L + kChunk - 1) / kChunk;
  for (int j = n_chunks - 1; j >= 0; --j) {
    const int l0 = j * kChunk;
    const int n_t = min(kChunk, L - l0);
    const bool full = n_t == kChunk;
    const size_t at = row_u + (size_t)l0 * su;
    float unused[kChunk], dd[kChunk], gy[kChunk], vC[kRowVals];
    load_rows<T>(Cm + row_n + (size_t)l0 * sn, sn, n_t, vC);
    if (full)
      load_chunk<T, true, false, true>(nullptr, dts, dy, at, su, n_t, bias_c, active, unused, dd,
                                       gy);
    else
      load_chunk<T, false, false, true>(nullptr, dts, dy, at, su, n_t, bias_c, active, unused,
                                        dd, gy);
    __syncthreads();    // the previous chunk's rows are read
    store_rows(vC, sC);
    __syncthreads();
    if (full)
      adj_steps<true>(dd, gy, sC, a2, g, a_next, n0, n_t);
    else
      adj_steps<false>(dd, gy, sC, a2, g, a_next, n0, n_t);
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) gout[((size_t)r * kN + n0 + i) * Dk + c] = g[i];
  }
}

bool bad_shape(int rows, int L, int Dk, int G, int S, int flat) {
  return rows <= 0 || L <= 0 || Dk <= 0 || G <= 0 || S <= 0 || rows % ((long long)G * S) != 0 ||
         (flat != 0 && flat != 1);
}

constexpr int kMaxGridY = 65535;

// Call `launch(grid, rw)` over the call's rows in slices of at most kMaxGridY,
// each on grid (channel blocks, slice rows) with its Rows; the first error
// stops it.
template <bool kFlat, typename F>
cudaError_t launch_rows(int rows, int L, int Dk, int G, int S, F&& launch) {
  for (int row0 = 0; row0 < rows; row0 += kMaxGridY) {
    const int slice = rows - row0 < kMaxGridY ? rows - row0 : kMaxGridY;
    const dim3 grid((Dk + kChannels - 1) / kChannels, slice);
    launch(grid, Rows<kFlat>{L, S, G, row0, rows});
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int kMode, bool kFlat>
cudaError_t launch_fwd_as(const void* u, const void* dts, const void* Bm, const void* Cm,
                          const void* A, const void* Dv, const void* bias, const void* h0,
                          void* y, void* hout, void* csum, int rows, int L, int Dk, int G, int S,
                          cudaStream_t s) {
  return launch_rows<kFlat>(rows, L, Dk, G, S, [&](dim3 grid, Rows<kFlat> rw) {
    scan_fwd_kernel<T, kMode, kFlat><<<grid, kLanes, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(dts), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const float*>(Dv),
        static_cast<const float*>(bias), static_cast<const float*>(h0), static_cast<T*>(y),
        static_cast<float*>(hout), static_cast<float*>(csum), rw, Dk);
  });
}

template <typename T, int kMode>
cudaError_t launch_fwd(const void* u, const void* dts, const void* Bm, const void* Cm,
                       const void* A, const void* Dv, const void* bias, const void* h0, void* y,
                       void* hout, void* csum, int rows, int L, int Dk, int G, int S, int flat,
                       cudaStream_t s) {
  if (flat)
    return launch_fwd_as<T, kMode, true>(u, dts, Bm, Cm, A, Dv, bias, h0, y, hout, csum, rows,
                                         L, Dk, G, S, s);
  return launch_fwd_as<T, kMode, false>(u, dts, Bm, Cm, A, Dv, bias, h0, y, hout, csum, rows, L,
                                        Dk, G, S, s);
}

template <typename T, bool kFlat>
cudaError_t launch_bwd_as(const void* u, const void* dts, const void* Bm, const void* Cm,
                          const void* dy, const void* A, const void* bias, const void* hck,
                          const void* g0, const void* a0, void* dus, void* ddt, void* dBp,
                          void* dCp, void* dA, int rows, int L, int Dk, int G, int S,
                          cudaStream_t s) {
  return launch_rows<kFlat>(rows, L, Dk, G, S, [&](dim3 grid, Rows<kFlat> rw) {
    scan_bwd_kernel<T, kFlat><<<grid, kLanes, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(dts), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const T*>(dy), static_cast<const float*>(A),
        static_cast<const float*>(bias), static_cast<const float*>(hck),
        static_cast<const float*>(g0), static_cast<const float*>(a0), static_cast<float*>(dus),
        static_cast<float*>(ddt), static_cast<float*>(dBp), static_cast<float*>(dCp),
        static_cast<float*>(dA), rw, Dk);
  });
}

template <typename T>
cudaError_t launch_bwd(const void* u, const void* dts, const void* Bm, const void* Cm,
                       const void* dy, const void* A, const void* bias, const void* hck,
                       const void* g0, const void* a0, void* dus, void* ddt, void* dBp,
                       void* dCp, void* dA, int rows, int L, int Dk, int G, int S, int flat,
                       cudaStream_t s) {
  if (flat)
    return launch_bwd_as<T, true>(u, dts, Bm, Cm, dy, A, bias, hck, g0, a0, dus, ddt, dBp, dCp,
                                  dA, rows, L, Dk, G, S, s);
  return launch_bwd_as<T, false>(u, dts, Bm, Cm, dy, A, bias, hck, g0, a0, dus, ddt, dBp, dCp,
                                 dA, rows, L, Dk, G, S, s);
}

template <typename T, bool kFlat>
cudaError_t launch_adjcarry_as(const void* dts, const void* Cm, const void* dy, const void* A,
                               const void* bias, void* gout, int rows, int L, int Dk, int G,
                               int S, cudaStream_t s) {
  return launch_rows<kFlat>(rows, L, Dk, G, S, [&](dim3 grid, Rows<kFlat> rw) {
    scan_adjcarry_kernel<T, kFlat><<<grid, kLanes, 0, s>>>(
        static_cast<const T*>(dts), static_cast<const T*>(Cm), static_cast<const T*>(dy),
        static_cast<const float*>(A), static_cast<const float*>(bias), static_cast<float*>(gout),
        rw, Dk);
  });
}

template <typename T>
cudaError_t launch_adjcarry(const void* dts, const void* Cm, const void* dy, const void* A,
                            const void* bias, void* gout, int rows, int L, int Dk, int G, int S,
                            int flat, cudaStream_t s) {
  if (flat) return launch_adjcarry_as<T, true>(dts, Cm, dy, A, bias, gout, rows, L, Dk, G, S, s);
  return launch_adjcarry_as<T, false>(dts, Cm, dy, A, bias, gout, rows, L, Dk, G, S, s);
}

}  // namespace

// Every entry: rows = B * G * S rows of L steps each, Dk channels, G groups,
// S segments per sequence, the layout (flat), the dtype of the T tensors.

// I-fwd: y in u's layout and dtype, from h0 (null: 0).
extern "C" int selective_scan_fwd(const void* u, const void* dts, const void* Bm, const void* Cm,
                                  const void* A, const void* Dv, const void* bias,
                                  const void* h0, void* y, int rows, int L, int Dk, int G, int S,
                                  int flat, int is_bf16, void* stream) {
  if (bad_shape(rows, L, Dk, G, S, flat)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16, kModeFwd>(u, dts, Bm, Cm, A, Dv, bias, h0, y, nullptr,
                                                    nullptr, rows, L, Dk, G, S, flat, s)
              : launch_fwd<float, kModeFwd>(u, dts, Bm, Cm, A, Dv, bias, h0, y, nullptr,
                                            nullptr, rows, L, Dk, G, S, flat, s);
  return static_cast<int>(err);
}

// I-ckpt: hck (rows, ceil(L / 16), 16, Dk) fp32, the state before each chunk,
// from h0 (null: 0).
extern "C" int selective_scan_ckpt(const void* u, const void* dts, const void* Bm, const void* A,
                                   const void* bias, const void* h0, void* hck, int rows, int L,
                                   int Dk, int G, int S, int flat, int is_bf16, void* stream) {
  if (bad_shape(rows, L, Dk, G, S, flat)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16, kModeCkpt>(u, dts, Bm, nullptr, A, nullptr, bias, h0,
                                                     nullptr, hck, nullptr, rows, L, Dk, G, S,
                                                     flat, s)
              : launch_fwd<float, kModeCkpt>(u, dts, Bm, nullptr, A, nullptr, bias, h0, nullptr,
                                             hck, nullptr, rows, L, Dk, G, S, flat, s);
  return static_cast<int>(err);
}

// H-seg carry: hend (rows, 16, Dk), the state after each row's last step from
// h0 (null: 0), and csum (rows, Dk), its sum of dt; fp32, no y.
extern "C" int selective_scan_carry(const void* u, const void* dts, const void* Bm, const void* A,
                                    const void* bias, const void* h0, void* hend, void* csum,
                                    int rows, int L, int Dk, int G, int S, int flat, int is_bf16,
                                    void* stream) {
  if (bad_shape(rows, L, Dk, G, S, flat)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16, kModeCarry>(u, dts, Bm, nullptr, A, nullptr, bias, h0,
                                                      nullptr, hend, csum, rows, L, Dk, G, S,
                                                      flat, s)
              : launch_fwd<float, kModeCarry>(u, dts, Bm, nullptr, A, nullptr, bias, h0,
                                              nullptr, hend, csum, rows, L, Dk, G, S, flat, s);
  return static_cast<int>(err);
}

// I-bwd: dus, ddt (u's layout), the per-block partials dBp, dCp (ceil(Dk /
// 16) x Bm's layout) and dA (rows, 16, Dk), all fp32; g0 and a0 (rows, 16,
// Dk) seed the adjoint from the right (null: 0).
extern "C" int selective_scan_bwd(const void* u, const void* dts, const void* Bm, const void* Cm,
                                  const void* dy, const void* A, const void* bias,
                                  const void* hck, const void* g0, const void* a0, void* dus,
                                  void* ddt, void* dBp, void* dCp, void* dA, int rows, int L,
                                  int Dk, int G, int S, int flat, int is_bf16, void* stream) {
  if (bad_shape(rows, L, Dk, G, S, flat)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(u, dts, Bm, Cm, dy, A, bias, hck, g0, a0, dus, ddt,
                                          dBp, dCp, dA, rows, L, Dk, G, S, flat, s)
              : launch_bwd<float>(u, dts, Bm, Cm, dy, A, bias, hck, g0, a0, dus, ddt, dBp, dCp,
                                  dA, rows, L, Dk, G, S, flat, s);
  return static_cast<int>(err);
}

// H-seg adjoint carry: gout (rows, 16, Dk) fp32, the adjoint at each row's
// first step from zero incoming.
extern "C" int selective_scan_adjcarry(const void* dts, const void* Cm, const void* dy,
                                       const void* A, const void* bias, void* gout, int rows,
                                       int L, int Dk, int G, int S, int flat, int is_bf16,
                                       void* stream) {
  if (bad_shape(rows, L, Dk, G, S, flat)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_adjcarry<__nv_bfloat16>(dts, Cm, dy, A, bias, gout, rows, L, Dk, G, S,
                                               flat, s)
              : launch_adjcarry<float>(dts, Cm, dy, A, bias, gout, rows, L, Dk, G, S, flat, s);
  return static_cast<int>(err);
}
