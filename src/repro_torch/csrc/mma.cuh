// Tensor-core building blocks shared by the flash-attention kernels:
// ldmatrix loads from shared memory, the bf16 mma.sync m16n8k16 product
// with fp32 accumulation, and a 16-byte tile copy into padded shared rows.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): with g = lane / 4 and
// t = lane % 4, an A fragment (16 x 16, row) holds rows g and g + 8 at
// columns 2t, 2t + 1 (regs 0, 1) and 2t + 8, 2t + 9 (regs 2, 3); a C
// fragment (16 x 8 fp32) holds rows g (c0, c1) and g + 8 (c2, c3) at
// columns 2t, 2t + 1.  So the C fragments of two neighbouring n-tiles,
// rounded to bf16 and packed in pairs, are the A fragment of the next
// product over those 16 columns (pack_bf16 below).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float* c, const unsigned* a,
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The A fragment over 16 columns 16 kk .. 16 kk + 15 of a row block whose
// values sit in C fragments c[n-tile][4] (rounded to bf16).
__device__ __forceinline__ void c_to_a(unsigned* a, const float (*c)[4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Copies rows [row0, row0 + ROWS) of one head (row stride `stride`
// elements) into a (ROWS, HD + 8) shared tile with 16-byte loads, by
// NTHREADS threads; rows at or past `rows` are zero.  The padding keeps
// ldmatrix free of bank conflicts.
template <int HD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int row0,
                                               int rows) {
  constexpr int VEC = HD / 8;
  for (int i = threadIdx.x; i < ROWS * VEC; i += NTHREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}
