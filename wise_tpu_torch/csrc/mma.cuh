#pragma once

// Warp-level tensor-core fragments (mma.sync, ldmatrix) shared by the
// attention kernels: attention.cuh (the CLIP and XLM-R towers' attention)
// and swin_kernels.cu (HTSAT's window attention). Internal linkage, as
// common.cuh: each translation unit holds its own copy.
//
// Fragment layout of mma.sync m16n8k16 / m16n8k8 with bf16 operands, lane
// l = 4 g + t: A (16 x k, row-major) rows g and g + 8, columns 2t, 2t + 1
// (and 2t + 8, 2t + 9 for k = 16); B (k x 8) columns (keys) g, rows 2t, 2t + 1
// (and 2t + 8, 2t + 9); C (16 x 8, f32) c[0..1] row g, c[2..3] row g + 8,
// columns 2t, 2t + 1.

#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two 8x8 bf16 matrices; lanes 0-15 give the addresses (row l % 8 of
// matrix l / 8), the other lanes' are not read
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8 f32) += a (16x8 bf16, row) b (8x8 bf16, col)
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4],
                                            const unsigned (&a)[2],
                                            unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// two floats as bf16x2, lo in the low half (the lower column of a fragment)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
