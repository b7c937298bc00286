// Kernel I-bwd (over the flat layout: H-bwd): the selective scan's reverse
// sweep. Per row and 16-step chunk, last chunk first, it recomputes the
// states h inside the chunk from I-ckpt's checkpoint, then walks the chunk
// backwards with the adjoint g_l = C_l dy_l + exp(dt_{l+1} A) g_{l+1} and
// writes dus, ddt (with respect to dt after the softplus), one partial of
// dB and dC per block of 32 channels, and dA summed over the row. Seeded
// rows start from the adjoint g0 and the next step's decay a0 (both 0 when
// null). The layouts, shapes and the recurrence are selective_scan.cu's.
//
// Replaces `_bwd_kernel` (smow_net_tpu/ops/pallas/scan_fused.py:291, the
// second pallas_call of `_bwd_core`, :541), which `selective_scan_fused`
// (CD-Mamba) and `selective_scan_fused_grouped` (ChangeMamba's SS2D) run.
//
// What bounds it on the card: the exponentials, on the multi-function unit
// at 16 per clock per SM (16 exp(dt A) per (row, step, channel) and the
// softplus's exp and log), and the bytes (u, dts, dy, B, C and the
// checkpoints in, dus, ddt and the dB, dC partials out). A row's walk is
// serial, so what sets the pace is how many warps an SM holds to hide each
// step's latency, and how many instructions a step issues. The kernel this
// one replaced (two lanes per channel, each lane's copy of the chunk's
// operands in registers, a warp a block, dB and dC summed over its 16
// channels by a butterfly of shuffles at every step) took 255 registers and
// held 8 warps per SM.
//
// Design: a block is 4 warps over 32 channels of one row; 4 lanes own a
// channel, 4 of its 16 states each. The chunk's u, dts and dy tiles (16
// steps x 32 channels) and B and C rows are copied into shared memory with
// 16-byte cp.async copies into a ring of two stages, chunk j - 1's while
// chunk j computes (element loads where a row is ragged or misaligned). One
// thread per (step, channel) takes the softplus (and dt u) once into shared
// memory. The recompute keeps the state before each step in a slot of
// shared memory (8 KB a warp); then one pass of the block sums dC over its
// 32 channels from those slots; the reverse sweep reads each step's slot
// back and writes the step's adjoint g in its place, and a second pass sums
// dB from them. So a step of the sweep issues no shuffle but the two that
// sum du and ddt over a channel's 4 lanes, and the passes add their 32
// channels in a fixed order, one partial per 32 channels: no float atomics,
// every run gives the same bits. The sweep takes exp(dt A) again rather
// than read the recompute's: keeping each step's decay costs 16 KB more a
// block, half the blocks an SM, and ran 38-46% slower on an H100
// (PERF.md).
//
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 128 registers and 0 spill
// bytes in all four instantiations (fp32 and bf16, grouped and flat); 56,384
// bytes of shared memory a block in fp32, 48,192 in bf16. Occupancy on an
// H100 (`selective_scan_bwd_occupancy`, the CUDA occupancy calculator): 4
// blocks, 16 warps per SM, in all four. chip_smoke.py's phase 14 logs both.

#include "scan_common.cuh"

namespace {

// a block (scan_common.cuh's 4 warps over kBlockChannels = 32 channels)
// writes one dB/dC partial
constexpr int kMinBlocks = 4;                                // 128 registers a thread at most

// One stage of the ring: a chunk's tiles in the inputs' dtype.
template <typename T>
struct Stage {
  T u[kChunk][kBlockChannels];
  T dts[kChunk][kBlockChannels];
  T dy[kChunk][kBlockChannels];
  T Bm[kChunk][kN];
  T Cm[kChunk][kN];
};

// A slot of the chunk's states: 32 channels x 16 states, padded by 16
// floats so that the passes' two steps per warp fall in other banks.
constexpr int kSlot = kBlockChannels * kN + 16;

template <typename T>
struct BwdSmem {
  Stage<T> ring[2];
  float dt[kChunk][kBlockChannels];            // softplus(dts + bias)
  float dtu[kChunk][kBlockChannels];           // dt u
  // slot t: the state before step t (slot n_t: after the last step); the
  // sweep overwrites slot t with the adjoint g of step t once it has read it
  float h[(kChunk + 1) * kSlot];

  __device__ __forceinline__ float* slot(int t, int c) { return h + t * kSlot + c * kN; }
};

__device__ __forceinline__ void store4(float* p, const float (&v)[kStates]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Sum over a channel's 4 lanes.
__device__ __forceinline__ float lane_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The recompute of one chunk for this lane (channel cl of the block, states
// n0..) from the checkpoint h: the state before each step into its slot,
// the state after the last into slot n_t; h ends as that state.
template <typename T, bool kFull>
__device__ __forceinline__ void recompute(BwdSmem<T>& sm, const Stage<T>& st, int cl, int n0,
                                          const float (&a2)[kStates], float (&h)[kStates],
                                          int n_t) {
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    if (kFull || t < n_t) {
      const float dt = sm.dt[t][cl], dtu = sm.dtu[t][cl];
      float b[kStates];
      load4(&st.Bm[t][n0], b);
      store4(sm.slot(t, cl) + n0, h);
#pragma unroll
      for (int i = 0; i < kStates; ++i) h[i] = exp2_ftz(dt * a2[i]) * h[i] + b[i] * dtu;
    }
  }
  store4(sm.slot(n_t, cl) + n0, h);
}

// The reverse sweep of one chunk for this lane: the adjoint g, dA, and dus
// and ddt at dus_c / ddt_c + t * su (their sums over the channel's 4 lanes
// take two shuffles each); g of step t goes into slot t, in place of the
// state the step has just read. kFull: all kChunk steps, with no per-step
// branch.
template <typename T, bool kFull>
__device__ __forceinline__ void sweep(BwdSmem<T>& sm, const Stage<T>& st, int cl, int n0,
                                      const float (&a2)[kStates], float (&g)[kStates],
                                      float (&a_next)[kStates], float (&dA_acc)[kStates],
                                      float* __restrict__ dus_c, float* __restrict__ ddt_c,
                                      int su, int n_t, bool active) {
  const int q = threadIdx.x % kLanesPerChannel;
#pragma unroll
  for (int t = kChunk - 1; t >= 0; --t) {
    if (kFull || t < n_t) {
      const float dt = sm.dt[t][cl], dyv = smow::to_float(st.dy[t][cl]);
      float hp[kStates], b[kStates], cm[kStates];
      load4(sm.slot(t, cl) + n0, hp);
      load4(&st.Bm[t][n0], b);
      load4(&st.Cm[t][n0], cm);
      float s = 0.f, s_a = 0.f;
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        const float a = exp2_ftz(dt * a2[i]);
        g[i] = cm[i] * dyv + a_next[i] * g[i];
        a_next[i] = a;
        const float gha = g[i] * hp[i] * a;
        s += g[i] * b[i];
        s_a += gha * a2[i];
        dA_acc[i] += gha * dt;
      }
      store4(sm.slot(t, cl) + n0, g);
      s = lane_sum(s);
      s_a = lane_sum(s_a);
      if (active && q == 0) dus_c[t * su] = dt * s;
      if (active && q == 1)                                   // sum_n gha A_n
        ddt_c[t * su] = smow::to_float(st.u[t][cl]) * s + s_a * kLn2;
    }
  }
}

// One pass over the block: for each of the chunk's n_t steps and 16
// states, out[(l0 + t) * sn + n] = sum over the block's 32 channels c of
// slot(t + dslot, c)[n] w[t][c], in the order of c (so every run gives the
// same bits). Thread i takes state i % 16 at steps i / 16 and i / 16 + 8.
template <typename T, typename W>
__device__ __forceinline__ void channel_pass(BwdSmem<T>& sm, int dslot,
                                             const W (*w)[kBlockChannels], float* __restrict__ out,
                                             int l0, int sn, int n_t) {
  const int n = threadIdx.x % kN;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int t = threadIdx.x / kN + k * (kThreads / kN);
    if (t < n_t) {
      const float* col = sm.slot(t + dslot, 0) + n;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kBlockChannels; c += kStates) {
        float v[kStates];
        load4(&w[t][c], v);
#pragma unroll
        for (int i = 0; i < kStates; ++i) sum += col[(c + i) * kN] * v[i];
      }
      out[(size_t)(l0 + t) * sn + n] = sum;
    }
  }
}

// I-bwd over one row r = row0 + blockIdx.y and the 32 channels of block x.
template <typename T, bool kFlat>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dts, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dy,
                const float* __restrict__ A, const float* __restrict__ bias,
                const float* __restrict__ hck, const float* __restrict__ g0,
                const float* __restrict__ a0, float* __restrict__ dus, float* __restrict__ ddt,
                float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ dA,
                Rows<kFlat> rw, int Dk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<T>& sm = *reinterpret_cast<BwdSmem<T>*>(smem_raw);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cl = warp * kWarpChannels + lane / kLanesPerChannel;   // the lane's channel
  const int n0 = lane % kLanesPerChannel * kStates;                // and its first state
  const int c0 = blockIdx.x * kBlockChannels, c = c0 + cl;
  const int n_c = min(kBlockChannels, Dk - c0);
  const int r = rw.row0 + blockIdx.y;
  const bool active = c < Dk;
  const int cc = active ? c : Dk - 1;     // idle lanes see dy = 0 and g = 0: dB, dC stay 0
  const int k = rw.group(r);
  float a2[kStates], g[kStates], a_next[kStates], dA_acc[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    const size_t at = ((size_t)r * kN + n0 + i) * Dk + c;
    a2[i] = A[((size_t)k * kN + n0 + i) * Dk + cc] * kLog2e;   // exp(dt A) = exp2(dt a2)
    g[i] = (g0 != nullptr && active) ? g0[at] : 0.f;
    a_next[i] = (a0 != nullptr && active) ? a0[at] : 0.f;
    dA_acc[i] = 0.f;
  }
  // the softplus pass: thread i takes channel i % 32 of the tile
  const int sc = threadIdx.x % kBlockChannels;
  const int L = rw.L;
  const int su = rw.step(Dk), sn = rw.step(kN);
  const size_t row_u = rw.base(r, Dk), row_n = rw.base(r, kN);
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const bool vec_u = Dk % (16 / sizeof(T)) == 0 && aligned16(u) && aligned16(dts) &&
                     aligned16(dy);
  const bool vec_n = aligned16(Bm) && aligned16(Cm);
  // this block's partial: block x of ceil(Dk / 32), each as large as Bm
  const size_t part = (size_t)blockIdx.x * rw.rows * L * kN;
  float* dB_blk = dBp + part + row_n;
  float* dC_blk = dCp + part + row_n;

  auto stage = [&](int j, Stage<T>& st) {
    const int l0 = j * kChunk, n_t = min(kChunk, L - l0);
    const size_t at = row_u + (size_t)l0 * su + c0;
    stage_tile<T, kBlockChannels>(st.u, u + at, su, n_t, n_c, vec_u);
    stage_tile<T, kBlockChannels>(st.dts, dts + at, su, n_t, n_c, vec_u);
    stage_tile<T, kBlockChannels>(st.dy, dy + at, su, n_t, n_c, vec_u);
    stage_tile<T, kN>(st.Bm, Bm + row_n + (size_t)l0 * sn, sn, n_t, kN, vec_n);
    stage_tile<T, kN>(st.Cm, Cm + row_n + (size_t)l0 * sn, sn, n_t, kN, vec_n);
    cp_async_commit();
  };
  // the checkpoint of chunk j: the state before its first step
  auto checkpoint = [&](int j, float (&h)[kStates]) {
    const float* ck = hck + (((size_t)r * n_chunks + j) * kN + n0) * Dk + cc;
#pragma unroll
    for (int i = 0; i < kStates; ++i) h[i] = active ? ck[(size_t)i * Dk] : 0.f;
  };

  stage(n_chunks - 1, sm.ring[0]);
  for (int j = n_chunks - 1, s = 0; j >= 0; --j, s ^= 1) {
    const int l0 = j * kChunk, n_t = min(kChunk, L - l0);
    float h[kStates];
    checkpoint(j, h);
    if (j > 0) {
      stage(j - 1, sm.ring[s ^ 1]);
    } else {
      cp_async_commit();      // an empty group: the wait below stays the same
    }
    cp_async_wait_all_but_newest();
    __syncthreads();          // chunk j's tiles, copied and loaded, are in place
    const Stage<T>& st = sm.ring[s];
    const float bias_s = bias[(size_t)k * Dk + min(c0 + sc, Dk - 1)];
    for (int t = threadIdx.x / kBlockChannels; t < kChunk; t += kThreads / kBlockChannels) {
      const float dt = softplus(smow::to_float(st.dts[t][sc]) + bias_s);
      sm.dt[t][sc] = dt;
      sm.dtu[t][sc] = dt * smow::to_float(st.u[t][sc]);
    }
    __syncthreads();
    if (n_t == kChunk)
      recompute<T, true>(sm, st, cl, n0, a2, h, n_t);
    else
      recompute<T, false>(sm, st, cl, n0, a2, h, n_t);
    __syncthreads();          // every channel's states of the chunk
    // dC_t[n] = sum_c h_t[c][n] dy_t[c], h_t the state after step t (slot t + 1)
    channel_pass(sm, 1, st.dy, dC_blk, l0, sn, n_t);
    __syncthreads();          // the states are read: the sweep may overwrite them
    const size_t at = row_u + (size_t)l0 * su + cc;
    if (n_t == kChunk)
      sweep<T, true>(sm, st, cl, n0, a2, g, a_next, dA_acc, dus + at, ddt + at, su, n_t, active);
    else
      sweep<T, false>(sm, st, cl, n0, a2, g, a_next, dA_acc, dus + at, ddt + at, su, n_t,
                      active);
    __syncthreads();          // every channel's adjoints of the chunk
    // dB_t[n] = sum_c g_t[c][n] dt_t[c] u_t[c] (slot t)
    channel_pass(sm, 0, sm.dtu, dB_blk, l0, sn, n_t);
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kStates; ++i) dA[((size_t)r * kN + n0 + i) * Dk + c] = dA_acc[i];
  }
}

// The kernel's shared memory is dynamic (above the 48 KB of a static
// array): allow it, and ask for the largest shared-memory carveout, once
// per instantiation.
template <typename T, bool kFlat>
cudaError_t configure() {
  static const cudaError_t err = [] {
    const cudaError_t e = cudaFuncSetAttribute(scan_bwd_kernel<T, kFlat>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)sizeof(BwdSmem<T>));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(scan_bwd_kernel<T, kFlat>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  return err;
}

template <typename T, bool kFlat>
cudaError_t launch_bwd_as(const void* u, const void* dts, const void* Bm, const void* Cm,
                          const void* dy, const void* A, const void* bias, const void* hck,
                          const void* g0, const void* a0, void* dus, void* ddt, void* dBp,
                          void* dCp, void* dA, int rows, int L, int Dk, int G, int S,
                          cudaStream_t s) {
  const cudaError_t err = configure<T, kFlat>();
  if (err != cudaSuccess) return err;
  return launch_rows<kBlockChannels, kFlat>(rows, L, Dk, G, S, [&](dim3 grid, Rows<kFlat> rw) {
    scan_bwd_kernel<T, kFlat><<<grid, kThreads, sizeof(BwdSmem<T>), s>>>(
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
cudaError_t occupancy_as(int* warps) {
  const cudaError_t err = configure<T, kFlat>();
  if (err != cudaSuccess) return err;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, scan_bwd_kernel<T, kFlat>, kThreads, sizeof(BwdSmem<T>));
  *warps = blocks * kWarps;
  return e;
}

}  // namespace

// I-bwd: dus, ddt (u's layout), the per-block partials dBp, dCp (ceil(Dk /
// 32) x Bm's layout) and dA (rows, 16, Dk), all fp32; g0 and a0 (rows, 16,
// Dk) seed the adjoint from the right (null: 0). Shapes as selective_scan.cu's
// entries.
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

// I-bwd's resident warps per SM on this card (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x 4 warps a block) for the layout and dtype, into *warps; and its shared
// memory per block, into *smem_bytes.
extern "C" int selective_scan_bwd_occupancy(int flat, int is_bf16, int* warps, int* smem_bytes) {
  *smem_bytes = is_bf16 ? (int)sizeof(BwdSmem<__nv_bfloat16>) : (int)sizeof(BwdSmem<float>);
  cudaError_t err;
  if (is_bf16)
    err = flat ? occupancy_as<__nv_bfloat16, true>(warps) : occupancy_as<__nv_bfloat16, false>(warps);
  else
    err = flat ? occupancy_as<float, true>(warps) : occupancy_as<float, false>(warps);
  return static_cast<int>(err);
}
