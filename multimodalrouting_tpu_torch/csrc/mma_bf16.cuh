// Warp-level bf16 tensor-core helpers shared by the packed attention kernels
// (K1 forward, K2 backward): mma.sync m16n8k16 with fp32 accumulators.
//
// Fragment layout of m16n8k16 (g = lane / 4, c2 = 2 * (lane % 4)):
//   A 16x16 row-major: a0 = A[g][c2..c2+1], a1 = A[g+8][c2..], a2 = A[g][c2+8..],
//                      a3 = A[g+8][c2+8..]
//   B 16x8 (k x n):    b0 = B[c2..c2+1][g], b1 = B[c2+8..c2+9][g]
//   C 16x8:            c0, c1 = C[g][c2], C[g][c2+1]; c2, c3 = C[g+8][c2], C[g+8][c2+1]
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values `stride` elements apart, packed as one 32-bit operand: a
// B fragment read down a column of a row-major shared tile.
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int stride) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two accumulator n-tiles (16 rows x 16 columns, fp32) re-packed in registers
// as the bf16 A operand of the next product's k-step.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}
