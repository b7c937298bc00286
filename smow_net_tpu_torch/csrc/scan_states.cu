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
// in fp32, one rounding per step (an FMA) as the Pallas kernel takes it.
//
// What bounds it on the card: memory. Each element is read twice (dA, dBu)
// and written once, 12 bytes, and takes one FMA: 12 B per element over
// 3.35 TB/s. The general route materialises these (B, L, D, N) operands in
// device memory as the JAX package does; the fused kernels H and I, which
// never do, stay the fast route for the shapes they take (N = 16, softplus).
//
// Design. The TPU kernel walked L in VMEM chunks with (D_blk * N) on the
// lanes and carried the state across its sequential grid. Here one warp
// walks one strip, a batch row's 32 consecutive lanes, with each lane's
// state in a register: every step reads one 128-byte row of dA and of dBu.
// The walk is serial and its loads are not, so the operands stream through
// a ring of kChunks chunks (kSteps steps x 32 lanes of both operands) in
// the warp's shared memory, kChunks - 1 chunks ahead of the walk, by
// `cp.async`: 16 bytes a lane and copy where the rows are 16-byte aligned
// (K % 4 == 0), 4 bytes otherwise (K = 33, say). Each lane's copies arrive
// on the slot's mbarrier (`cp.async.mbarrier.arrive.noinc`), which the
// warp waits on before it walks the chunk. The walk writes each state over
// its dBu in the slot, and the warp stores the chunk's rows of h with
// 16-byte stores (4-byte ones on unaligned rows). A block's kWarps warps
// walk adjacent strips, chunk by chunk in step: their 128-byte rows are
// read and written side by side, which took (13, 62500, 1024) from 3.87-4.03
// to 3.48-3.54 ms on the H100 (1 warp a block against 2; 4 gave 3.59-3.66).
// TMA was slower here: one 128-byte `cp.async.bulk` a row cost the warp
// ~2.5 us of issue a 32-step chunk (4.97 ms), and a (32 lanes x 32 steps)
// tensor-map box a chunk 4.29-4.31 ms against `cp.async`'s 4.01-4.03 in
// the same geometry; its reads stayed near 11 GB/s an SM whether one warp
// or four shared the SM (by estimate the TMA unit's rate for 128-byte rows).
//
// Few strips cannot keep enough bytes in flight (2 x 256 lanes: 16 strips
// on 132 SMs), so the caller may cut L into S segments of a multiple of
// kSteps steps, at most kSegSteps (ops/scan.py `states_seg_count`), one
// chained pass:
// - blocks take (segment, strip) tickets, kWarps adjacent ones at a time,
//   from an atomic counter, segment major, so a warp only ever waits on a
//   segment whose warp is running;
// - segment 0 walks from h = 0, writes h and publishes its end state as its
//   inclusive state I_0;
// - segment s > 0 loads its whole tile into the ring and walks it from
//   zero, taking E_s (the end state) and P_s (the product of its dA, one
//   rounding a step); it publishes (P_s, E_s), then finds its seed
//   I_{s-1}: it reads back 32 predecessors' flags at a time to the newest
//   one with I published and applies the (P, E) after it in segment order,
//   x = P_j x + E_j, one FMA each. That is the chain's own arithmetic,
//   I_j = P_j I_{j-1} + E_j, so the seed's bits do not depend on where the
//   look-back stopped: no aggregates are combined with each other, and h
//   is bitwise the same in every run. It publishes I_s = P_s I_{s-1} + E_s,
//   then walks its tile again from shared memory from the seed, writing h.
// Each element is read from device memory once; the records (P, E, I of
// 32 lanes, and a flag) add 388 bytes a segment.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 2;                      // warps a block, on adjacent strips
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 64;                     // steps a chunk
constexpr int kChunks = 3;                     // chunks in a warp's ring
constexpr int kSegSteps = kSteps * kChunks;    // the longest segment a warp holds whole
constexpr int kChunkFloats = kSteps * 32;      // one operand's chunk
constexpr int kWarpFloats = kChunks * 2 * kChunkFloats;
constexpr size_t kSmem = kWarps * (kWarpFloats * sizeof(float) + kChunks * sizeof(uint64_t));
constexpr int kRecord = 3 * 32;                // a segment's P, E and I, 32 lanes each

struct Shape {
  int L, K;
  int lane_strips;   // strips a batch row: ceil(K / 32)
  int strips;        // B * lane_strips
  int S;             // segments a strip
  int seg;           // steps a segment (L when S == 1), a multiple of kSteps when S > 1
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void async_copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void async_copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// one arrival on `bar` once this lane's earlier cp.async copies have landed
__device__ __forceinline__ void async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Each lane's `v` into its slot of `dst`, then the segment's flag to
// `state` (1: P and E, 2: I) once every lane's store is visible.
__device__ __forceinline__ void publish(float* dst, float v, unsigned* flag, unsigned state,
                                        int lane) {
  dst[lane] = v;
  __threadfence();
  __syncwarp();
  if (lane == 0) st_release(flag, state);
}

// The seed of ticket t's segment, I_{s-1} of its strip: back from segment
// s - 1 to the newest one with I published (all between with P and E), 32
// flags a read; then the chain from there in segment order. Segment 0
// publishes only I, so the look-back ends there at the latest.
__device__ float look_back(const float* rec, const unsigned* flags, long long t, int strips,
                           int lane) {
  long long base = t - strips, found;
  while (true) {
    const long long j = base - (long long)lane * strips;
    const unsigned f = j >= 0 ? ld_acquire(flags + j) : 2u;
    const unsigned none = __ballot_sync(~0u, f == 0), whole = __ballot_sync(~0u, f == 2);
    if (whole && (!none || __ffs(whole) < __ffs(none))) {
      found = base - (long long)(__ffs(whole) - 1) * strips;
      break;
    }
    if (none)
      __nanosleep(32);          // a segment in the window has published nothing yet
    else
      base -= 32LL * strips;    // 32 with P and E only: further back
  }
  __syncwarp();
  float x = __ldcg(rec + (size_t)found * kRecord + 64 + lane);
#pragma unroll 4
  for (long long j = found + strips; j < t; j += strips)
    x = __fmaf_rn(__ldcg(rec + (size_t)j * kRecord + lane), x,
                  __ldcg(rec + (size_t)j * kRecord + 32 + lane));
  return x;
}

// `rows` steps of the chunk (a_s, b_s), row j the walk's step j, from state
// x: x = a x + b rounded once a step. kOut: each state goes over its b (the
// aligned path stores the rows of h from there) or straight to h at
// `hrow(j)` (the unaligned path, lanes that hold a column); otherwise p
// takes the product of the a's.
template <bool kOut, bool kVec, typename HRow>
__device__ __forceinline__ void walk(const float* a_s, float* b_s, int rows, int lane,
                                     bool column, HRow hrow, float& x, float& p) {
  auto step = [&](int j) {
    const float a = a_s[j * 32 + lane];
    x = __fmaf_rn(a, x, b_s[j * 32 + lane]);
    if (!kOut)
      p = __fmul_rn(p, a);
    else if (kVec)
      b_s[j * 32 + lane] = x;
    else if (column)
      *hrow(j) = x;
  };
  if (rows == kSteps) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) step(j);
  } else {
    for (int j = 0; j < rows; ++j) step(j);
  }
}

template <bool kVec, bool kReverse>
__global__ void __launch_bounds__(kThreads)
scan_states_kernel(const float* __restrict__ dA, const float* __restrict__ dBu,
                   float* __restrict__ h, float* __restrict__ rec, unsigned* __restrict__ flags,
                   Shape sh) {
  extern __shared__ __align__(128) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ring = smem + warp * kWarpFloats;          // [kChunks][dA, dBu][kSteps][32]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kWarps * kWarpFloats) + warp * kChunks;
  if (lane < kChunks) mbar_init(bars + lane, 32);     // one arrival a lane
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();

  // A block's warps take kWarps consecutive tickets together: adjacent
  // strips of one segment, whose rows they read side by side. Without
  // segments they also walk chunk by chunk in step (the rows of a block's
  // strips then stay together in device memory's pages).
  const long long tickets = (long long)sh.strips * sh.S;
  __shared__ long long group_shared;
  auto take_group = [&]() -> long long {
    __syncthreads();              // every warp has read the last group
    if (threadIdx.x == 0) group_shared = atomicAdd(flags + tickets, (unsigned)kWarps);
    __syncthreads();
    return group_shared;
  };
  unsigned issued = 0, used = 0;    // this warp's chunks put into and taken from its ring
  for (long long group = flags ? take_group() : (long long)blockIdx.x * kWarps;
       group < tickets; group = take_group()) {
    const long long t = group + warp;
    const int in_step = 32 * (int)min((long long)kWarps, tickets - group);
    if (t >= tickets) {           // a spare warp of the last group
      if (!flags) break;
      continue;
    }
    const int s = (int)(t / sh.strips), q = (int)(t % sh.strips);
    const int b = q / sh.lane_strips, col0 = (q % sh.lane_strips) * 32;
    const int cols = min(32, sh.K - col0);
    const int i0 = s * sh.seg, n = min(sh.seg, sh.L - i0);
    const int chunks = (n + kSteps - 1) / kSteps;
    const size_t row0 = (size_t)b * sh.L * sh.K + col0;
    // the time of walk step i (i forward, L - 1 - i reverse), a time's row
    auto at = [&](int i) { return kReverse ? sh.L - 1 - i : i; };
    auto offset = [&](int tm) { return row0 + (size_t)tm * sh.K; };

    auto issue = [&](int c) {     // chunk c of the segment into the ring's next slot
      const int slot = issued++ % kChunks;
      float* a_s = ring + slot * 2 * kChunkFloats;
      float* b_s = a_s + kChunkFloats;
      const int first = i0 + c * kSteps, rows = min(kSteps, n - c * kSteps);
      __syncwarp();               // every lane is done with the slot's last chunk
      if (kVec) {                 // 16 bytes a copy: 8 copies a row and operand
        for (int e = lane; e < rows * 8; e += 32) {
          const int r = e / 8, c4 = (e % 8) * 4;
          if (c4 < cols) {
            const size_t g = offset(at(first + r)) + c4;
            async_copy16(a_s + r * 32 + c4, dA + g);
            async_copy16(b_s + r * 32 + c4, dBu + g);
          }
        }
      } else if (lane < cols) {
        for (int j = 0; j < rows; ++j) {
          const size_t g = offset(at(first + j)) + lane;
          async_copy4(a_s + j * 32 + lane, dA + g);
          async_copy4(b_s + j * 32 + lane, dBu + g);
        }
      }
      async_arrive(bars + slot);
    };
    auto take = [&]() {           // the oldest chunk issued, once it has landed
      const int slot = used % kChunks;
      mbar_wait(bars + slot, (used / kChunks) & 1u);
      ++used;
      return slot;
    };
    // walk chunk c in `slot` from x; kOut: write its states to h
    auto walk_chunk = [&](auto out, int slot, int c, float& x, float& p) {
      constexpr bool kOut = decltype(out)::value;
      float* a_s = ring + slot * 2 * kChunkFloats;
      float* b_s = a_s + kChunkFloats;
      const int first = i0 + c * kSteps, rows = min(kSteps, n - c * kSteps);
      walk<kOut, kVec>(a_s, b_s, rows, lane, lane < cols,
                       [&](int j) { return h + offset(at(first + j)) + lane; }, x, p);
      if (kOut && kVec) {         // the chunk's rows of h, 16 bytes a lane
        __syncwarp();
        const int c4 = (lane % 8) * 4;
        for (int r = lane / 8; r < rows; r += 4)
          if (c4 < cols)
            *reinterpret_cast<float4*>(h + offset(at(first + r)) + c4) =
                *reinterpret_cast<const float4*>(b_s + r * 32 + c4);
      }
    };
    using Out = std::true_type;
    using Zero = std::false_type;

    float x = 0.f, p = 1.f;
    if (s == 0) {                 // from h = 0, final: stream the segment through the ring
      for (int c = 0; c < min(chunks, kChunks); ++c) issue(c);
      for (int c = 0; c < chunks; ++c) {
        walk_chunk(Out{}, take(), c, x, p);
        if (!flags) asm volatile("bar.sync 1, %0;\n" ::"r"(in_step) : "memory");
        if (c + kChunks < chunks) issue(c + kChunks);
      }
      if (sh.S > 1) publish(rec + (size_t)t * kRecord + 64, x, flags + t, 2u, lane);
    } else {                      // chunks <= kChunks: the tile stays whole in the ring
      const unsigned first_slot = issued;
      for (int c = 0; c < chunks; ++c) issue(c);
      for (int c = 0; c < chunks; ++c) walk_chunk(Zero{}, take(), c, x, p);
      float* r = rec + (size_t)t * kRecord;
      const bool last = s == sh.S - 1;          // no successor reads its record
      if (!last) {
        r[lane] = p;
        publish(r + 32, x, flags + t, 1u, lane);
      }
      const float seed = look_back(rec, flags, t, sh.strips, lane);
      if (!last) publish(r + 64, __fmaf_rn(p, seed, x), flags + t, 2u, lane);
      x = seed;
      for (int c = 0; c < chunks; ++c) walk_chunk(Out{}, (first_slot + c) % kChunks, c, x, p);
    }
    if (!flags) break;            // one strip a warp without segments
  }
}

// Sets the kernel's shared-memory limit and counts the blocks resident at
// once over all SMs, once per instantiation.
template <bool kVec, bool kReverse>
cudaError_t configure(int* resident) {
  static int cached = 0;
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(scan_states_kernel<kVec, kReverse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(scan_states_kernel<kVec, kReverse>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scan_states_kernel<kVec, kReverse>, kThreads, kSmem);
    if (e == cudaSuccess && per_sm == 0) e = cudaErrorInvalidConfiguration;
    cached = per_sm * sms;
    return e;
  }();
  *resident = cached;
  return err;
}

template <bool kVec, bool kReverse>
cudaError_t launch_as(const void* dA, const void* dBu, void* h, void* rec, void* flags,
                      const Shape& sh, cudaStream_t s) {
  int resident = 0;
  const cudaError_t err = configure<kVec, kReverse>(&resident);
  if (err != cudaSuccess) return err;
  long long blocks = ((long long)sh.strips * sh.S + kWarps - 1) / kWarps;
  if (flags != nullptr && blocks > resident) blocks = resident;   // persistent: tickets
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  scan_states_kernel<kVec, kReverse><<<(unsigned)blocks, kThreads, kSmem, s>>>(
      static_cast<const float*>(dA), static_cast<const float*>(dBu), static_cast<float*>(h),
      static_cast<float*>(rec), static_cast<unsigned*>(flags), sh);
  return cudaGetLastError();
}

int launch(const void* dA, const void* dBu, void* h, void* rec, void* flags, int B, int L, int K,
           int S, int reverse, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || S <= 0 || (reverse != 0 && reverse != 1))
    return cudaErrorInvalidValue;
  // segments of ceil(L / S) steps rounded up to whole chunks; S must be
  // the count they make, each at most kSegSteps (held whole in the ring)
  const long long per = ((long long)L + S - 1) / S;
  const int seg = S > 1 ? (int)((per + kSteps - 1) / kSteps * kSteps) : L;
  if (S > 1 && (seg > kSegSteps || ((long long)L + seg - 1) / seg != S || !rec || !flags))
    return cudaErrorInvalidValue;
  const int lane_strips = (K + 31) / 32;
  const long long strips = (long long)B * lane_strips;
  if (strips * S >= INT_MAX) return cudaErrorInvalidValue;   // tickets: a 32-bit counter
  const Shape sh{L, K, lane_strips, (int)strips, S, seg};
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = K % 4 == 0 && aligned(dA) && aligned(dBu) && aligned(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return reverse ? launch_as<true, true>(dA, dBu, h, rec, flags, sh, s)
                   : launch_as<true, false>(dA, dBu, h, rec, flags, sh, s);
  return reverse ? launch_as<false, true>(dA, dBu, h, rec, flags, sh, s)
                 : launch_as<false, false>(dA, dBu, h, rec, flags, sh, s);
}

}  // namespace

// dA, dBu: (B, L, K) fp32; writes h: (B, L, K) fp32, walked from the end
// when reverse is 1. One segment: each warp streams its strip.
extern "C" int scan_states(const void* dA, const void* dBu, void* h, int B, int L, int K,
                           int reverse, void* stream) {
  return launch(dA, dBu, h, nullptr, nullptr, B, L, K, 1, reverse, stream);
}

// The same in S segments of ceil(L / S) steps rounded up to whole chunks
// of kSteps (64), at most kSegSteps (192) (the last may be shorter; S must
// be the count they make), one chained pass. rec: B * ceil(K / 32) * S
// records of 96 fp32 (unset); flags: B * ceil(K / 32) * S + 1 int32,
// zeroed (the last is the ticket counter).
extern "C" int scan_states_seg(const void* dA, const void* dBu, void* h, void* rec, void* flags,
                               int B, int L, int K, int S, int reverse, void* stream) {
  return launch(dA, dBu, h, rec, flags, B, L, K, S, reverse, stream);
}
