// Tensor-core pieces of the bf16 kernels F (xattn_layer.cu), F-bwd
// (xattn_layer_bwd.cu) and G-bwd (cross_attn_bwd.cu): `mma.sync.m16n8k16`
// and `m16n8k8` (bf16 operands, fp32 accumulation) fed by `ldmatrix`,
// `cp.async` tile loads, and the hi/lo split that keeps an fp32 operand's
// product at the precision of the fp32 plain version.
//
// Fragments (PTX ISA, m16n8k16 .bf16; g = lane / 4, q = lane % 4): A (16 x 16,
// row) is four .b32 registers, (row g, cols 2q..2q+1), (g + 8, 2q..), (g,
// 2q + 8..), (g + 8, 2q + 8..); B (16 x 8, col) is two, (k 2q..2q+1, n g) and
// (k 2q + 8.., n g); the fp32 accumulator C (16 x 8) is four floats, (g, 2q),
// (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1). m16n8k8 takes the first two
// A registers and the first B register of that layout. The accumulators of two
// neighbouring n-tiles, rounded to bf16 pairs, are exactly the A fragment of
// one 16-deep k-step, so a product's output feeds the next product from
// registers.
//
// `ldmatrix` (x4) loads four 8 x 8 b16 matrices, lane i giving the address of
// row i % 8 of matrix i / 8; with `.trans` each is transposed on the way. So
// one shared-memory copy of a matrix serves both orientations: stored
// [m][k] (k contiguous) it is an A operand as is and, transposed, the B
// operand of a product with it on the other side. Rows are padded by 16
// bytes (8 bf16), which puts the 8 rows of one 8 x 8 load on 8 different
// 4-bank groups: conflict-free.
#pragma once

#include <cstdint>

#include "xattn_layer.cuh"

namespace smow {
namespace xlayer {
namespace tc {

constexpr int kPad = 8;   // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Lane offsets (row, col) into a stored matrix for one x4 load covering 16 x
// 16 elements at its origin:
//   a_:  A stored [m][k], no transpose: row lane % 16, col 8 (lane / 16);
//   b_:  B stored [n][k] (2 n-tiles), no transpose, and A^T stored [k][m]
//        with .trans: row lane % 8 + 8 (lane / 16), col 8 (lane / 8 % 2);
//   bt_: B stored [k][n] (2 n-tiles), .trans: row lane % 8 + 8 (lane / 8 %
//        2), col 8 (lane / 16).
// For B, registers 0-1 are the first n-tile's (b0, b1), 2-3 the second's.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) << 3; }

// c += a b (16 x 8 x 16, bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b (16 x 8 x 8): a is (row g, cols 2q..2q+1), (g + 8, 2q..); b is
// (k 2q..2q+1, n g)
__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> bf16 pair hi = rn(a, b) and the pair lo = rn((a, b) - hi): hi + lo
// holds 16 significant bits, so a product through both halves is off the
// fp32 product by about 2^-17 of it. One bf16 rounding (hi alone) misses the
// bf16 kernels' bound: dw1 came to 1.12x it at (16, 16384, 128).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = as_u32(h);
  const float2 hf = __bfloat1622float2(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// rows x cols bf16 (cols a multiple of 8) from global (row stride `src_ld`
// elements) into shared (row stride `dst_ld`), by `threads` threads starting
// at `t`, asynchronously
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int dst_ld,
                                           const __nv_bfloat16* src, int src_ld, int rows,
                                           int cols, int t, int threads) {
  const int chunks = cols / 8;
  for (int i = t; i < rows * chunks; i += threads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    cp_async16(dst + r * dst_ld + c, src + (size_t)r * src_ld + c, true);
  }
}

// Blocks of `kernel` (kThreads threads and `smem` bytes of dynamic shared
// memory, which this sets as its maximum) resident in one wave over all SMs
// of the current device, once per kernel: *cached holds the count.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* cached) {
  if (*cached == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    *cached = per_sm * sms;
  }
  return cudaSuccess;
}

}  // namespace tc
}  // namespace xlayer
}  // namespace smow
