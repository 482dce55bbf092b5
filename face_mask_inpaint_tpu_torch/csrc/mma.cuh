// Warp-level tensor-core idioms shared by K4b's and K5's bf16 kernels: cp.async
// copies into shared memory, ldmatrix fragment loads and mma.sync m16n8k16
// (bf16 operands, f32 accumulation). sm_80 instructions, run on sm_90a.
//
// Fragment layout of mma.m16n8k16.row.col (lane = 4 g + t):
//   A (16 x 16): a0 = (row g, k 2t..2t+1), a1 = (row g + 8, same k),
//                a2 = (row g, k 8 + 2t..), a3 = (row g + 8, k 8 + 2t..)
//   B (16 x 8):  b0 = (k 2t..2t+1, col g), b1 = (k 8 + 2t.., col g)
//   C (16 x 8):  c0, c1 = (row g, cols 2t, 2t + 1), c2, c3 = (row g + 8, same cols)
// ldmatrix_x4 loads four 8 x 8 matrices; lane l gives the address of row
// (l & 7) of matrix (l >> 3). With lm = l >> 3 and lr = l & 7:
//   A from [M][K] (K contiguous):  row m0 + (lm & 1) * 8 + lr, col k0 + (lm >> 1) * 8
//   A from [K][M] (.trans):        row k0 + (lm >> 1) * 8 + lr, col m0 + (lm & 1) * 8
//   B pair from [N][K]:            row n0 + (lm >> 1) * 8 + lr, col k0 + (lm & 1) * 8
//   B pair from [K][N] (.trans):   row k0 + (lm & 1) * 8 + lr, col n0 + (lm >> 1) * 8
// where a B pair gives b0, b1 of the n-tile n0 and b2, b3 of n0 + 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fmi_mma {

// 16 bytes global -> shared; src_bytes 0 writes zeros (the source address
// must still be valid)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
// 4 bytes global -> shared, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// two matrices: lanes 0-15 give the addresses (the others are ignored)
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned r[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// c += a b
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

}  // namespace fmi_mma
