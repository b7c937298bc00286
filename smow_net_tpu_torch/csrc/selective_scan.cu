// Kernel I: the fused selective scan (Mamba S6), as three sweeps: I-fwd (the
// output y), I-ckpt (the hidden state at the start of every chunk of kChunk
// steps) and I-bwd (h recomputed inside each chunk from its checkpoint, then
// the reverse adjoint sweep; in selective_scan_bwd.cu). Kernel H is the same
// three sweeps over the flat (B, L, G * Cg) layout, read in place. Kernel
// H-seg, the segmented long-L scan, adds two sweeps: the carry (I-fwd's
// sweep that writes only each segment's final state and its dt sum) and the
// adjoint carry (the reverse recurrence of the adjoint alone); I-fwd, I-ckpt
// and I-bwd then run seeded with each segment's incoming state and adjoint.
// I-fwd, I-ckpt, the carry and the adjoint carry are one kernel,
// scan_fwd_kernel, in four modes (the store differs; the adjoint carry walks
// the same sweep backwards).
//
// Replaces, in smow_net_tpu/ops/pallas/scan_fused.py, `_fwd_kernel` (:147,
// reached by `_fwd_core`'s pallas_call :413) and `_ckpt_kernel` (:261, the
// first pallas_call of `_bwd_core`, :517): the kernels
// `selective_scan_fused_grouped` (:841) runs for every SS2D call of
// ChangeMamba and `selective_scan_fused` (:754) for every scan of CD-Mamba;
// and `_carry_kernel` (:188, `_carry_core`'s pallas_call :445) and
// `_adjcarry_kernel` (:223, `_adjcarry_core`'s pallas_call :473), which
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
//   dBp, dCp        ceil(Dk / 32) x Bm's layout fp32: one partial sum per
//                                               32-channel block of I-bwd,
//                                               summed by the caller
//   dA              (rows', 16, Dk)             fp32, summed over the segment
// Per (row, channel, state n), in fp32:
//   dt_l = softplus(dts_l + bias)   (jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0))
//   h_l  = exp(dt_l A_n) h_{l-1} + B_l[n] (dt_l u_l),  h_{-1} = h0 (0 when null)
//   y_l  = sum_n C_l[n] h_l[n] + D u_l
// and the adjoint g_l = C_l dy_l + exp(dt_{l+1} A) g_{l+1}, walked backwards
// from g_L = g0 with exp(dt_L A) = a0 (both 0 when null).
//
// What bounds the forward sweep on the card: the exponentials. Every (row,
// step, channel, state) takes one exp(dt A) on the multi-function unit (16
// per clock per SM), and every (row, step, channel) the softplus's exp and
// log: 18 per element, against about 8 bytes moved. A row's walk is serial,
// so the card reaches that bound only with enough warps in flight to hide
// each step's latencies (the MUFU's, shared memory's, a chunk's loads) and
// with few instructions besides the exps. The kernel this one replaced (one
// warp a block over 16 channels, 2 lanes a channel, 8 states a lane, the
// softplus taken by both lanes, chunk j + 1's loads issued after chunk j's
// steps) took 159-166 registers and ran at 3.0x its bound (PERF.md).
//
// Design: a block is 4 warps over 32 channels of one row (scan_common.cuh's
// block shape); lane l of warp w owns channel l and states 4 w..4 w + 3,
// in registers, so the B and C values a step reads are the same for the
// whole warp (one broadcast load each) and a warp's checkpoint stores
// cover 32 consecutive channels of one state (128 bytes). The chunk's u
// and dts tiles (16 steps x 32 channels) and B and C rows (16 x 16) are
// copied into shared memory with 16-byte cp.async copies into a ring of
// two stages, chunk j + 1's issued before chunk j's steps; in bf16 each
// thread's share of a full chunk's copies is planned once (element loads
// where a row is ragged, misaligned or has idle channels). One thread per
// (step, channel) takes the softplus and dt u once into shared memory, and in
// bf16 the B and C rows are widened to fp32 there once, so a lane's step
// is two loads of dt and dt u, one 16-byte load of B (and of C), and per
// state one FMUL and one MUFU.EX2 (ex2.approx.ftz: a decay below 2^-126
// flushes to 0, which moves h by less than 2^-126 |h|) and two FMAs. In
// I-fwd each warp writes its 4 states' part of C h (warp 0 adds D u) to a
// 16 x 32 tile of its own; the next chunk's first pass sums the 4 tiles in
// a fixed order and stores y with 16-byte vectors. No shuffle, no atomic:
// every run gives the same bits. I-ckpt stores the states before each
// chunk, the carry the last state and the dt sum once; no y work is done
// in those modes. Each kernel computes its rows' offsets from the layout,
// so the flat layout needs no transposed copy on either side.
//
// The adjoint carry (kModeAdj) is the same sweep with the chunks and the
// steps of a chunk walked last to first: the "u" tile holds dy and the "B"
// rows hold C, the softplus pass stores dy in place of dt u, and the step
// is g = exp2(dt' a2) g + C[t] dy[t], where dt' is the dt of the step
// after (kept in a register from step to step and across the chunk
// boundary; g starts at 0, so the first step's dt' only has to be finite).
// A step costs what the forward step costs, and rounds as the one-warp
// kernel this mode replaced did (e g rounded, then C dy added in an FMA;
// the forward sweep's FMA takes e h instead), so the adjoint carry's
// outputs keep that kernel's bits: in the forward's order, one leaf of
// CD-Mamba's fp32 gradient (an encoder layer's skip_scale) moved by 1.25e-3
// of its largest element against the plain backward, over chip_smoke.py
// phase 22's bound of 1e-3 (PERF.md). The chunk walked first is the row's
// ragged last one, staged by stage_tile; chunk j - 1's copies are in
// flight while chunk j's steps run. A fourth mode takes fewer lines than a
// sibling kernel on the same helpers, and runs at the carry's rate (the
// one-warp kernel it replaced, without prefetch, took 1.5x as long;
// PERF.md).
//
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8): at most 64 registers a
// thread (the launch bounds) and 0 spill bytes in all sixteen
// instantiations (4 modes x 2 dtypes x 2 layouts); 26,624 bytes of static
// shared memory a block in fp32, 20,480 in bf16; 8 blocks, 32 warps per SM
// on an H100 (`selective_scan_fwd_occupancy`, the CUDA occupancy
// calculator). chip_smoke.py's phases 13, 19 and 20 log both.

#include <cstddef>

#include "scan_common.cuh"

namespace {

// I-fwd's sweep writes y, I-ckpt's the chunk-start states, the carry's the
// final state and the dt sum, the adjoint carry's (walked backwards) the
// adjoint at the first step
enum { kModeFwd = 0, kModeCkpt = 1, kModeCarry = 2, kModeAdj = 3 };

constexpr int kFwdMinBlocks = 8;        // 64 registers a thread at most: 32 warps an SM

// One stage of the forward sweep's ring: a chunk's tiles in the inputs'
// dtype (Cm in kModeFwd only).
template <typename T>
struct FwdStage {
  T u[kChunk][kBlockChannels];
  T dts[kChunk][kBlockChannels];
  T Bm[kChunk][kN];
  T Cm[kChunk][kN];
};

template <typename T>
struct FwdSmem {
  FwdStage<T> ring[2];
  float dt[kChunk][kBlockChannels];            // softplus(dts + bias)
  float dtu[kChunk][kBlockChannels];           // dt u
  float Bm[kChunk][kN];                        // bf16: the chunk's B and C rows in fp32
  float Cm[kChunk][kN];
  // kModeFwd: warp w's part of y (its 4 states' C h; warp 0's with D u)
  // at step t, channel c
  float yp[kWarps][kChunk][kBlockChannels];
};

// Where chunk 0's vector v of a tile of width W (row t at base + t *
// stride) lies.
template <typename T, int W>
__device__ __forceinline__ const T* tile_vector(const T* base, int stride, int v) {
  constexpr int kV = 16 / sizeof(T), kRowVecs = W / kV;
  return base + (size_t)(v / kRowVecs) * stride + v % kRowVecs * kV;
}

// y of the chunk's n_t steps (the sum of the warps' parts, in the order of
// the warps) into its rows, row t at dst + t * stride, n_c valid columns:
// 16-byte vectors where `vec` and the vector lies within the n_c columns,
// element stores elsewhere.
template <typename T>
__device__ __forceinline__ void store_y(T* __restrict__ dst, const FwdSmem<T>& sm,
                                        size_t stride, int n_t, int n_c, bool vec) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kRowVecs = kBlockChannels / kV;
  for (int i = threadIdx.x; i < kChunk * kRowVecs; i += kThreads) {
    const int t = i / kRowVecs, w = i % kRowVecs * kV;
    if (t >= n_t) continue;
    float v[kV];
#pragma unroll
    for (int e = 0; e < kV; e += 4) {
      float4 y = *reinterpret_cast<const float4*>(&sm.yp[0][t][w + e]);
#pragma unroll
      for (int k = 1; k < kWarps; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(&sm.yp[k][t][w + e]);
        y.x += p.x, y.y += p.y, y.z += p.z, y.w += p.w;
      }
      v[e] = y.x, v[e + 1] = y.y, v[e + 2] = y.z, v[e + 3] = y.w;
    }
    T* d = dst + t * stride + w;
    if (vec && w + kV <= n_c) {
      smow::store_from_f32<T, kV>(d, v);
    } else {
      for (int e = 0; e < kV && w + e < n_c; ++e) d[e] = smow::from_float<T>(v[e]);
    }
  }
}

// The forward sweep's steps of one chunk for this lane (channel cl of the
// block, the warp's states n0..n0 + 3), B and C rows in fp32 at Bf and Cf;
// in kModeFwd the lane's part of y goes into the warp's tile (warp 0 adds
// D u), in kModeCarry the lane sums dt into dacc; kModeAdj walks the steps
// last to first, B and dt u standing for C and dy, with the decay of the
// step after, whose dt dacc carries. kFull: all kChunk steps, with no
// per-step branch.
template <typename T, int kMode, bool kFull>
__device__ __forceinline__ void fwd_steps(FwdSmem<T>& sm, const FwdStage<T>& st,
                                          const float (*Bf)[kN], const float (*Cf)[kN], int cl,
                                          int n0, const float (&a2)[kStates],
                                          float (&h)[kStates], float d_c, float& dacc, int n_t) {
  constexpr bool kY = kMode == kModeFwd;
  constexpr bool kAdj = kMode == kModeAdj;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const int t = kAdj ? kChunk - 1 - q : q;
    if (kFull || t < n_t) {
      const float dt = sm.dt[t][cl], dtu = sm.dtu[t][cl];
      const float dd = kAdj ? dacc : dt;     // the adjoint decays by the step after's dt
      float b[kStates];
      load4(&Bf[t][n0], b);                  // the same address across the warp
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        const float e = exp2_ftz(dd * a2[i]);
        // the adjoint rounds e g, then adds C dy in the FMA (see the header)
        h[i] = kAdj ? fmaf(b[i], dtu, e * h[i]) : e * h[i] + b[i] * dtu;
      }
      if (kMode == kModeCarry) dacc += dt;
      if (kAdj) dacc = dt;
      if (kY) {
        float cm[kStates];
        load4(&Cf[t][n0], cm);
        float s = cm[0] * h[0];
#pragma unroll
        for (int i = 1; i < kStates; ++i) s += cm[i] * h[i];
        if (warp == 0) s += d_c * smow::to_float(st.u[t][cl]);
        sm.yp[warp][t][cl] = s;
      }
    }
  }
}

// I-fwd (kModeFwd): y. I-ckpt (kModeCkpt): the state before every chunk into
// hout (rows', chunks, 16, Dk). The carry (kModeCarry): the state after the
// last step into hout (rows', 16, Dk) and the sum of dt into csum. The
// adjoint carry (kModeAdj, u = dy, Bm = C, h0 null): the adjoint at the
// first step from zero after the last into hout (rows', 16, Dk). Cm, Dv
// and y are read or written in kModeFwd only; h0 may be null. One row r =
// row0 + blockIdx.y and the 32 channels of block x: lane l of warp w owns
// channel l and states 4 w..4 w + 3.
template <typename T, int kMode, bool kFlat>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dts, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ A,
                const float* __restrict__ Dv, const float* __restrict__ bias,
                const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hout,
                float* __restrict__ csum, Rows<kFlat> rw, int Dk) {
  constexpr bool kY = kMode == kModeFwd;
  constexpr bool kAdj = kMode == kModeAdj;
  constexpr bool kF32 = std::is_same<T, float>::value;
  __shared__ __align__(16) FwdSmem<T> sm;
  const int cl = threadIdx.x % 32;                    // the lane's channel
  const int n0 = threadIdx.x / 32 * kStates;          // and the warp's first state
  const int c0 = blockIdx.x * kBlockChannels, c = c0 + cl;
  const int n_c = min(kBlockChannels, Dk - c0);
  const int r = rw.row0 + blockIdx.y;
  const bool active = c < Dk;
  const int cc = active ? c : Dk - 1;     // idle lanes read a valid channel, store nothing
  const int k = rw.group(r);
  float a2[kStates], h[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    a2[i] = A[((size_t)k * kN + n0 + i) * Dk + cc] * kLog2e;   // exp(dt A) = exp2(dt a2)
    h[i] = (h0 != nullptr && active) ? h0[((size_t)r * kN + n0 + i) * Dk + c] : 0.f;
  }
  // the softplus pass: thread i takes channel i % 32 (the lane's) of the tile
  const float d_c = kY ? Dv[(size_t)k * Dk + cc] : 0.f;
  const float bias_c = bias[(size_t)k * Dk + cc];
  const int L = rw.L;
  const int su = rw.step(Dk), sn = rw.step(kN);
  const int n_chunks = (L + kChunk - 1) / kChunk;
  // the row's first step at the block's first channel in u, dts and y
  const size_t ub = rw.base(r, Dk) + c0;
  constexpr int kV = 16 / sizeof(T);
  const bool vec_u = Dk % kV == 0 && aligned16(u) && aligned16(dts);
  const bool vec_n = aligned16(Bm) && (!kY || aligned16(Cm));
  const bool vec_y = kY && Dk % kV == 0 && aligned16(y);
  // In bf16, a full chunk's copies with whole 16-byte vectors over all 32
  // channels: the stage [u | dts | B | C] is one list of 16-byte vectors,
  // thread i copies vectors i + 128 q (in slot q, whose source is planned
  // once; slot 0 holds a u or a dts vector, slot 1 a B or a C vector).
  // Else (fp32, whose three slots would cost the registers of 8 blocks an
  // SM; the last chunk of a ragged row; idle channels; misaligned rows)
  // stage_tile's copies and element loads.
  const bool fast = !kF32 && vec_u && vec_n && n_c == kBlockChannels;
  constexpr int kVu = kChunk * kBlockChannels / kV, kVn = kChunk * kN / kV;
  constexpr int kCopies = 2 * kVu + (kY ? 2 : 1) * kVn;
  constexpr int kSlots = (kCopies + kThreads - 1) / kThreads;
  static_assert(kF32 || (kSlots == 2 && 2 * kVu == kThreads), "slot 0: u, dts; slot 1: B, C");
  static_assert(offsetof(FwdStage<T>, Cm) == (2 * kVu + kVn) * 16, "the stage is one list");
  const T* cp[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int v = threadIdx.x + q * kThreads;
    if (v < kVu)
      cp[q] = tile_vector<T, kBlockChannels>(u + ub, su, v);
    else if (v < 2 * kVu)
      cp[q] = tile_vector<T, kBlockChannels>(dts + ub, su, v - kVu);
    else if (v < 2 * kVu + kVn)
      cp[q] = tile_vector<T, kN>(Bm + rw.base(r, kN), sn, v - 2 * kVu);
    else if (v < kCopies)
      cp[q] = tile_vector<T, kN>(Cm + rw.base(r, kN), sn, v - 2 * kVu - kVn);
    else
      cp[q] = nullptr;
  }

  auto stage = [&](int j, FwdStage<T>& st) {
    const int n_t = min(kChunk, L - j * kChunk);
    const size_t at = (size_t)j * kChunk * su, an = (size_t)j * kChunk * sn;
    if (fast && n_t == kChunk) {
      char* base = reinterpret_cast<char*>(&st);
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int v = threadIdx.x + q * kThreads;
        if (v < kCopies) cp_async16(base + v * 16, cp[q] + (q == 0 ? at : an));
      }
    } else {
      const size_t nb = rw.base(r, kN) + an;
      stage_tile<T, kBlockChannels>(st.u, u + ub + at, su, n_t, n_c, vec_u);
      stage_tile<T, kBlockChannels>(st.dts, dts + ub + at, su, n_t, n_c, vec_u);
      stage_tile<T, kN>(st.Bm, Bm + nb, sn, n_t, kN, vec_n);
      if (kY) stage_tile<T, kN>(st.Cm, Cm + nb, sn, n_t, kN, vec_n);
    }
    cp_async_commit();
  };

  float dacc = 0.f;           // the carry's dt sum; the adjoint carry's dt of the step after
  // the adjoint carry walks the chunks last to first
  const int j0 = kAdj ? n_chunks - 1 : 0, j_end = kAdj ? -1 : n_chunks, dj = kAdj ? -1 : 1;
  stage(j0, sm.ring[0]);
  for (int j = j0, s = 0; j != j_end; j += dj, s ^= 1) {
    const int n_t = min(kChunk, L - j * kChunk);
    cp_async_wait_all();
    __syncthreads();          // chunk j's tiles are in place; the previous chunk's steps are done
    if (j + dj != j_end) stage(j + dj, sm.ring[s ^ 1]);    // in flight while chunk j runs
    const FwdStage<T>& st = sm.ring[s];
    if (kY && j > 0)          // chunk j - 1's y, which its steps left in the warps' tiles
      store_y<T>(y + ub + (size_t)(j - 1) * kChunk * su, sm, su, kChunk, n_c, vec_y);
    for (int t = threadIdx.x / kBlockChannels; t < kChunk; t += kThreads / kBlockChannels) {
      const float dt = softplus(smow::to_float(st.dts[t][cl]) + bias_c);
      sm.dt[t][cl] = dt;
      sm.dtu[t][cl] = kAdj ? smow::to_float(st.u[t][cl]) : dt * smow::to_float(st.u[t][cl]);
    }
    if (!kF32) {              // the B (and C) rows in fp32: 4 values a thread
      const int t = threadIdx.x % (kChunk * kN / 4) / 4, n = threadIdx.x % 4 * 4;
      if (threadIdx.x < kChunk * kN / 4 || kY) {
        const bool is_b = threadIdx.x < kChunk * kN / 4;
        float v[4];
        load4(is_b ? &st.Bm[t][n] : &st.Cm[t][n], v);
        *reinterpret_cast<float4*>(is_b ? &sm.Bm[t][n] : &sm.Cm[t][n]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (kMode == kModeCkpt && active) {     // a warp's store: 32 channels of one state
      float* dst = hout + (((size_t)r * n_chunks + j) * kN + n0) * Dk + c;
#pragma unroll
      for (int i = 0; i < kStates; ++i) dst[(size_t)i * Dk] = h[i];
    }
    __syncthreads();          // the chunk's dt, dt u, B and C
    const float (*Bf)[kN] = kF32 ? reinterpret_cast<const float (*)[kN]>(st.Bm) : sm.Bm;
    const float (*Cf)[kN] = kF32 ? reinterpret_cast<const float (*)[kN]>(st.Cm) : sm.Cm;
    if (n_t == kChunk)
      fwd_steps<T, kMode, true>(sm, st, Bf, Cf, cl, n0, a2, h, d_c, dacc, n_t);
    else
      fwd_steps<T, kMode, false>(sm, st, Bf, Cf, cl, n0, a2, h, d_c, dacc, n_t);
  }
  if (kY) {
    __syncthreads();          // the last chunk's y
    const int j = n_chunks - 1;
    store_y<T>(y + ub + (size_t)j * kChunk * su, sm, su, L - j * kChunk, n_c, vec_y);
  }
  if ((kMode == kModeCarry || kAdj) && active) {
#pragma unroll
    for (int i = 0; i < kStates; ++i) hout[((size_t)r * kN + n0 + i) * Dk + c] = h[i];
    if (kMode == kModeCarry && n0 == 0) csum[(size_t)r * Dk + c] = dacc;
  }
}

// The kernel's shared memory is static (below 48 KB): ask for the largest
// shared-memory carveout, so that kFwdMinBlocks blocks fit an SM, once per
// instantiation.
template <typename T, int kMode, bool kFlat>
cudaError_t configure_fwd() {
  static const cudaError_t err = cudaFuncSetAttribute(
      scan_fwd_kernel<T, kMode, kFlat>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, int kMode, bool kFlat>
cudaError_t launch_fwd_as(const void* u, const void* dts, const void* Bm, const void* Cm,
                          const void* A, const void* Dv, const void* bias, const void* h0,
                          void* y, void* hout, void* csum, int rows, int L, int Dk, int G, int S,
                          cudaStream_t s) {
  const cudaError_t err = configure_fwd<T, kMode, kFlat>();
  if (err != cudaSuccess) return err;
  return launch_rows<kBlockChannels, kFlat>(rows, L, Dk, G, S, [&](dim3 grid, Rows<kFlat> rw) {
    scan_fwd_kernel<T, kMode, kFlat><<<grid, kThreads, 0, s>>>(
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

template <typename T, int kMode, bool kFlat>
cudaError_t occupancy_as(int* warps) {
  const cudaError_t err = configure_fwd<T, kMode, kFlat>();
  if (err != cudaSuccess) return err;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, scan_fwd_kernel<T, kMode, kFlat>, kThreads, 0);
  *warps = blocks * kWarps;
  return e;
}

template <typename T>
cudaError_t occupancy_of(int mode, int flat, int* warps) {
  switch (mode * 2 + flat) {
    case kModeFwd * 2: return occupancy_as<T, kModeFwd, false>(warps);
    case kModeFwd * 2 + 1: return occupancy_as<T, kModeFwd, true>(warps);
    case kModeCkpt * 2: return occupancy_as<T, kModeCkpt, false>(warps);
    case kModeCkpt * 2 + 1: return occupancy_as<T, kModeCkpt, true>(warps);
    case kModeCarry * 2: return occupancy_as<T, kModeCarry, false>(warps);
    case kModeCarry * 2 + 1: return occupancy_as<T, kModeCarry, true>(warps);
    case kModeAdj * 2: return occupancy_as<T, kModeAdj, false>(warps);
    default: return occupancy_as<T, kModeAdj, true>(warps);
  }
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

// H-seg adjoint carry: gout (rows, 16, Dk) fp32, the adjoint at each row's
// first step from zero incoming; dy in dts's layout and dtype.
extern "C" int selective_scan_adjcarry(const void* dts, const void* Cm, const void* dy,
                                       const void* A, const void* bias, void* gout, int rows,
                                       int L, int Dk, int G, int S, int flat, int is_bf16,
                                       void* stream) {
  if (bad_shape(rows, L, Dk, G, S, flat)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16, kModeAdj>(dy, dts, Cm, nullptr, A, nullptr, bias,
                                                    nullptr, nullptr, gout, nullptr, rows, L, Dk,
                                                    G, S, flat, s)
              : launch_fwd<float, kModeAdj>(dy, dts, Cm, nullptr, A, nullptr, bias, nullptr,
                                            nullptr, gout, nullptr, rows, L, Dk, G, S, flat, s);
  return static_cast<int>(err);
}

// The forward sweep's resident warps per SM on this card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x 4 warps a block) in mode
// 0 (I-fwd), 1 (I-ckpt), 2 (the carry) or 3 (the adjoint carry), for the
// layout and dtype, into *warps; and its shared memory per block, into
// *smem_bytes.
extern "C" int selective_scan_fwd_occupancy(int mode, int flat, int is_bf16, int* warps,
                                            int* smem_bytes) {
  if (mode < kModeFwd || mode > kModeAdj || (flat != 0 && flat != 1))
    return cudaErrorInvalidValue;
  *smem_bytes = is_bf16 ? (int)sizeof(FwdSmem<__nv_bfloat16>) : (int)sizeof(FwdSmem<float>);
  const cudaError_t err = is_bf16 ? occupancy_of<__nv_bfloat16>(mode, flat, warps)
                                  : occupancy_of<float>(mode, flat, warps);
  return static_cast<int>(err);
}
