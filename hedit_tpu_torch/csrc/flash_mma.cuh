// Tensor-core building blocks shared by the bf16 kernels
// (flash_attention_tc.cu, flash_attention_bwd_tc.cu, flash_probes_tc.cu, flash_variants.cu,
// mm_probe_tc.cu):
// cp.async copies into shared memory, ldmatrix fragment loads and the
// mma.sync m16n8k16 product (bf16 operands, float32 accumulators).
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16 (row):  a[0] row g, cols 2t, 2t+1;  a[1] row g+8, the same cols;
//                     a[2] row g, cols 2t+8, 2t+9; a[3] row g+8, those cols;
//   B 16 x 8 (col):   b0 rows 2t, 2t+1 of col g;  b1 rows 2t+8, 2t+9;
//   C 16 x 8 (float): c[0], c[1] row g, cols 2t, 2t+1; c[2], c[3] row g+8.
// So the C tiles of two neighbouring n-tiles, rounded to bf16 pairs, are the
// A fragment of a product that contracts over their 16 columns:
// a[2 * hh + r] = (c_hh[2r], c_hh[2r + 1]) for n-tile hh and row half r.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; !valid zero-fills them (src-size 0)
__device__ __forceinline__ void cp_async_16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes (one float) global -> shared; !valid zero-fills them
__device__ __forceinline__ void cp_async_4(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned addr, unsigned (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// two floats rounded to a bf16 pair: one register of an A fragment
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: a 16 x 8 bf16 (row), b 8 x 8 bf16 (col), c 16 x 8 float32; the
// fragments are the first halves of m16n8k16's: a[0] row g, cols 2t, 2t+1,
// a[1] row g+8; b0 rows 2t, 2t+1 of col g
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], unsigned a0, unsigned a1,
                                            unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

}  // namespace
