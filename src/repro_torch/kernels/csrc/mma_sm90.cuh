// PTX wrappers shared by the port's tensor-core kernels (sm_90a): 16- and
// 4-byte cp.async into shared memory, ldmatrix, and mma.sync m16n8k16 with
// bf16 operands and fp32 accumulators.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, 4 registers of bf16 pairs): a0 (g, 2t..2t+1),
//     a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
//   B (16 x 8, 2 registers): b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g);
//   C (16 x 8 fp32): c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..).
// The lower half of a register holds the lower column (k) index.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; 16 zero bytes when !live (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
// 4 bytes global -> shared (through L1); 4 zero bytes when !live
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i ((g, 2t..2t+1) per lane)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// the same, transposed: register i receives (2t..2t+1, g) of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values as PARTS bf16 pairs whose sum is the pair: each part
// is the rounding of what the earlier parts left (exact in fp32), so
// every part adds about 8 bits of the significand.
template <int PARTS>
__device__ __forceinline__ void split_bf16(float lo, float hi,
                                           uint32_t (&out)[PARTS]) {
#pragma unroll
  for (int i = 0; i < PARTS; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    out[i] = *reinterpret_cast<const uint32_t*>(&v);
    lo -= __low2float(v);
    hi -= __high2float(v);
  }
}

// the bf16 pair (low, high) of a register as floats
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  return __bfloat1622float2(v);
}

}  // namespace mma_sm90
