// bf16 tensor-core helpers (sm_80 and later) for the bf16 variants of
// csrc/stem_conv.cu and csrc/gather_gemm.cuh: ldmatrix loads of 8x8 bf16
// tiles from shared memory and the warp-wide mma.sync m16n8k16 with bf16
// inputs and float32 accumulation.
//
// Fragment layout of mma.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8):  b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (16 x 8):  c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1];
// the lower half of a 32-bit register holds the lower column (A) or row
// (B) index.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mgar {

// Four 8x8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i (16-byte aligned), r[i] receives it in A-fragment order.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed: from a row-major (k, n) tile in shared
// memory it gives B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two transposed 8x8 matrices (lanes 0 .. 15 give the row addresses).
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// d += A (16 x 16 bf16) * B (16 x 8 bf16), float32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values in one register, `lo` in the lower half.
__device__ __forceinline__ unsigned pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// A float32 value rounded to bf16 (to nearest, ties to even) and widened
// back: exact in float32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two float32 values rounded to bf16 (to nearest, ties to even), `lo` in
// the lower half.
__device__ __forceinline__ unsigned round_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace mgar
