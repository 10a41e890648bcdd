// Device helpers shared by the tensor-core kernels of flash_attention.cu and
// cross_entropy.cu (sm_90a): asynchronous global -> shared copies
// (cp.async, with zero-fill), ldmatrix fragment loads and the bf16
// mma.sync m16n8k16 product with float32 sums.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t
// (g = lane / 4, t = lane % 4) holds
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//                           a[2] = (g, 2t + 8..),  a[3] = (g + 8, 2t + 8..);
//   B (16 x 8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t + 8.., n g);
//   C (16 x 8, float32):    c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..).
// ldsm4 with lane l pointing at row (l % 16), column 8 (l / 16) of a
// row-major 16 x 16 tile returns its A fragment; pointing at row
// 8 (l / 16) + l % 8, column 8 ((l / 8) % 2) of a [n][k] tile, it returns
// the B fragments of two 8-column tiles ({r[0], r[1]}, {r[2], r[3]});
// ldsm4_t with lane l pointing at row 8 ((l / 8) % 2) + l % 8, column
// 8 (l / 16) of a row-major [k][n] tile returns the same two B fragments;
// ldsm2_t reads the addresses of lanes 0-15 only and returns the first.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte (or 4-byte) asynchronous copy global -> shared; zero-fills the
// destination when ``ok`` is false (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory (one row address per lane)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// two 8x8 bf16 matrices, transposed (the addresses of lanes 0-15)
__device__ __forceinline__ void ldsm2_t(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
