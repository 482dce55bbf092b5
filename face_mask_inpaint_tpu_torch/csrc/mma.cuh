// Warp-level tensor-core idioms shared by K4a's, K4b's and K5's bf16 kernels
// and K1's and K5's f32 kernels: cp.async copies into shared memory, ldmatrix
// fragment loads, mma.sync m16n8k16 (bf16 operands, f32 accumulation) and
// mma.sync m16n8k8 on TF32 operands in split precision (3xTF32, below).
// sm_80 instructions, run on sm_90a.
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
//
// mma.m16n8k8.row.col on tf32 (one 32-bit element a register):
//   A (16 x 8):  a0 = (row g, k t), a1 = (row g + 8, k t), a2 = (row g, k t + 4),
//                a3 = (row g + 8, k t + 4)
//   B (8 x 8):   b0 = (k t, col g), b1 = (k t + 4, col g)
//   C:           as above
// An 8 x 8 b16 matrix of ldmatrix is an 8 x 4 f32 one (lane 4 g + t gets row
// g, element t), so the addresses above serve f32 [M][K] and [N][K] tiles
// with 4 f32 where they say 8 bf16. There is no transposed ldmatrix for
// 32-bit elements: a B operand stored [K][N] (k rows, n contiguous) is read
// with scalar loads. The f32 kernels take their k order within each group
// of 8 as 0, 2, 4, 6, 1, 3, 5, 7 (logical k t is physical 2t, k t + 4 is
// 2t + 1) wherever a product's operand is read that way, so that
//   - the C fragment of one product is the A fragment of the next without
//     an exchange (c0, c1 of row g are its physical k 2t, 2t + 1), and
//   - b0, b1 of a [K][N] operand are rows 2t and 2t + 1, which fall in
//     distinct banks when the row stride is 4 mod 16 words (every f32 tile
//     here has rows of a multiple of 32 words plus 4: ldmatrix needs the
//     same stride to read 8 rows without conflict).
//
// Split precision (3xTF32, what CUTLASS calls OpMultiplyAddFastF32): an f32
// x is hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), each
// 11 significant bits, together about 21 of f32's 24; a b = al bh + ah bl +
// ah bh (the small terms first), with f32 accumulation, drops only al bl,
// about 2^-22 |a||b|. One TF32 product (torch's allow_tf32) keeps about 11
// bits; this keeps the f32 gates. The split runs on the ALUs, at each
// fragment load (no lo copies are stored). The tensor cores' f32
// accumulate does not round to nearest: on the H100 an accumulator that
// takes thousands of products drifts, in one direction (with dv added in
// place, K5 used 1.3 of its f32 gate at config 5,
// tools/tensor_core_variants.py). A long sum therefore takes a tile's
// products in a zeroed fragment and adds that to its f32 total with a
// rounded FADD.

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

// rows [row0, row0 + rows) of an [L][width] f32 matrix into shared rows of
// `stride` floats, channels padded to wpad (a multiple of 4), by `threads`
// threads; rows past L and channels past width are zero-filled from a valid
// address
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int row0, int rows,
                                              int L, int width, int wpad, int stride, int tid,
                                              int threads) {
  const int per_row = wpad / 4;
  for (int i = tid; i < rows * per_row; i += threads) {
    const int r = i / per_row, c = (i % per_row) * 4, row = row0 + r;
    const bool ok = row < L && c < width;
    cp_async16(&dst[r * stride + c], ok ? src + (size_t)row * width + c : src, ok ? 16 : 0);
  }
}

// c += a b on tf32 operands (f32 bit patterns with the low 13 bits zero)
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32 of a finite x: the magnitude's bits rounded half up at
// bit 13 (to nearest, ties away from zero), the low 13 cleared: an integer
// add and a mask. The PTX cvt compiles on sm_90a to those plus a compare and
// a select that pass inf and NaN through, which no operand here holds.
__device__ __forceinline__ unsigned rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, each rounded to tf32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}
// the four f32 of an A fragment, split
__device__ __forceinline__ void split_a(const float a[4], unsigned hi[4], unsigned lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
}
__device__ __forceinline__ void split_a(const unsigned a[4], unsigned hi[4], unsigned lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), hi[i], lo[i]);
}

// c += a b in split precision: three tf32 products, the small ones first
__device__ __forceinline__ void mma_tf32x3(float c[4], const unsigned ah[4], const unsigned al[4],
                                           unsigned bh0, unsigned bh1, unsigned bl0,
                                           unsigned bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}
// the same with an f32 B pair split here
__device__ __forceinline__ void mma_tf32x3(float c[4], const unsigned ah[4], const unsigned al[4],
                                           float b0, float b1) {
  unsigned bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32x3(c, ah, al, bh0, bh1, bl0, bl1);
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

}  // namespace fmi_mma
