// Flash-attention backward for the PICNet self-similarity maps (kernel K5).
//
// Replaces: face_mask_inpaint_tpu/ops/pallas/flash_attention.py, the three
// backward kernels of K1's custom_vjp: `_backward_sym` (`_sym_bwd_kernel`),
// `_backward_fused` (`_fused_bwd_kernel`) and `_backward` (`_dq_kernel`,
// `_dkv_kernel`), which compute one function.
//
// For q [N, L, d] (query == key, no scale), values v [N, L, C] (several
// value tensors concatenated on channels), the output gradient dO [N, L, C],
// K1's base-2 row lse [N, L] and D = rowsum(dO * O) [N, L] (f32):
//     P[r, c]  = exp2(log2(e) * q_r . q_c - lse_r)       (= softmax row r)
//     dS[r, c] = P[r, c] * (dO_r . v_c - D_r)
//     dq_r     = sum_c (dS[r, c] + dS[c, r]) q_c         (query and key role)
//     dv_r     = sum_c P[c, r] dO_c
// S is symmetric (q == k), so P[c, r] = exp2(log2(e) * S[r, c] - lse_c)
// comes from the same scores.
//
// What bounds it on an H100: at config 5 (N = 16, L = 16384, d = 64,
// C = 256, bf16) the function needs 2 N L^2 (1.5 d + 2 C) ~ 5.2 TFLOP (one
// score tile per unordered pair) against ~0.65 GB of inputs and outputs, so
// it is compute-bound: the products must run on the tensor cores and the
// [L, L] maps must stay on chip (5.3 ms at the dense bf16 peak; 31.6 ms in
// f32 as three TF32 products at the dense TF32 peak).
//
// Three routes, chosen by type, shape and alignment only
// (fmi_flash_attention_bwd_route): bf16 and f32 at d in {32, 64} and C <=
// 256 (C % 8 == 0, 16-byte aligned) take the tensor cores, bf16 directly
// and f32 in split precision (3xTF32, see its section below and
// csrc/mma.cuh), both column-owned; everything else the CUDA cores.
//
// Tensor-core route (bf16, d in {32, 64}, C <= 256 with C % 8 == 0, 16-byte
// aligned tensors; mma.sync m16n8k16, bf16 in, f32 accumulate), column-owned
// as FlashAttention-2's backward: one block of 8 warps per (64-key tile c,
// sample) holds q_c and v_c (their A fragments in registers) and sweeps the
// 64-row tiles r through a 3-stage cp.async ring. Per tile pair:
//     S^T = q_c q_r^T, P^T = exp2(S2 - lse_r), dv_c += P^T dO_r,
//     dP^T = v_c dO_r^T, dS^T = P^T (dP^T - D_r),
//     key role dq_c += dS^T q_r, query role dq_r += dS q_c,
// 704 multiply-adds per ordered pair (the previous design, a row-owned dq
// kernel reading both dP tiles plus a dv kernel, did 1,024). P^T and dS^T
// pass through shared memory (double-buffered) between the warps that make
// them (16 keys x 32 rows each) and those that use them (dv: 32 keys x 64
// channels; the two dq roles: 16 x d/2 each), with one barrier per tile
// pair. The query role of a row gathers over all key tiles, so it is added
// to an f32 [N, L, d] scratch with atomics, as is the key role at the end;
// a last pass rounds the scratch to dq once. Atomics make dq's f32 sums
// land in a run-dependent order: the result is not bit-deterministic (dv
// is). P and each dS[r, c] are rounded to bf16 before their products, dS
// for either role on its own, as the TPU's `_backward` (K5c) rounds them;
// `_backward_sym` and the plain version round the summed dS[r, c] +
// dS[c, r] once instead (within the tolerance the checks hold it to).
//
// CUDA-core route (other d or C; d = 48 in the repo's paths): two kernels,
// each a variant of K1's loop. dq: one block per (64-row tile, sample) sweeps the
// column tiles computing S, both dP tiles (dO_r v_c^T and v_r dO_c^T over
// all C), the summed dS (rounded once to the input type) and dq += dS q_c,
// both roles in registers, deterministic. dv: one block per (64-row tile,
// 128-channel chunk, sample) computes P[c, r] per column tile and
// dv += P^T dO_c.
//
// Ragged L is masked on every route: keys or rows past L have P = 0, and
// rows past L are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "mma.cuh"

namespace {

constexpr int kBR = 64;            // rows per block
constexpr int kBC = 64;            // columns per tile
constexpr int kCC = 128;           // dv channels per block
constexpr int kCK = 32;            // dP channels per chunk (CUDA-core dq)
constexpr int kPStride = kBC + 4;  // padded rows of the P / dS tile
constexpr int kThreads = 256;
constexpr int kDMax = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: where the TPU kernel casts P and dS to the input
// type before a product
template <typename T>
__device__ __forceinline__ float round_t(float x) { return to_f(from_f<T>(x)); }

// ---------------------------------------------------------------------------
// CUDA-core path (f32 arithmetic; T = float or bf16). 256 threads; thread
// (ty, tx) owns rows ty*4..+3 and columns tx*4..+3 of each 64 x 64 tile.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int L, int d, int C) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                  // [d][kBR]  q_r transposed, times log2(e)
  float* kt = qt + d * kBR;          // [d][kBC]  q_c transposed
  float* qc = kt + d * kBC;          // [kBC][d]  q_c
  float* a1 = qc + kBC * d;          // [kCK][kBR] dO_r chunk, transposed
  float* b1 = a1 + kCK * kBR;        // [kCK][kBC] v_c chunk, transposed
  float* a2 = b1 + kCK * kBC;        // [kCK][kBR] v_r chunk, transposed
  float* b2 = a2 + kCK * kBR;        // [kCK][kBC] dO_c chunk, transposed
  float* ms = b2 + kCK * kBC;        // [kBR][kPStride] summed dS
  float* lsec = ms + kBR * kPStride; // [kBC]
  float* dcol = lsec + kBC;          // [kBC]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kBR, n = blockIdx.y;
  const T* qn = q + (size_t)n * L * d;
  const T* vn = v + (size_t)n * L * C;
  const T* don = dout + (size_t)n * L * C;
  const float* lsen = lse + (size_t)n * L;
  const float* dn = dsum + (size_t)n * L;

  for (int idx = tid; idx < kBR * d; idx += kThreads) {
    const int r = idx % kBR, k = idx / kBR, row = r0 + r;
    qt[k * kBR + r] = row < L ? to_f(qn[(size_t)row * d + k]) * kLog2e : 0.f;
  }
  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    lse_r[i] = row < L ? lsen[row] : 0.f;
    d_r[i] = row < L ? dn[row] : 0.f;
  }
  const int nd = (d + 15) / 16;  // dq columns per thread: tx + 16 m
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[i][m] = 0.f;

  const int n_tiles = (L + kBC - 1) / kBC;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * kBC;
    for (int idx = tid; idx < kBC * d; idx += kThreads) {
      const int col = idx / d, k = idx % d, key = c0 + col;
      const float x = key < L ? to_f(qn[(size_t)key * d + k]) : 0.f;
      qc[col * d + k] = x;
      kt[k * kBC + col] = x;
    }
    if (tid < kBC) {
      const int key = c0 + tid;
      lsec[tid] = key < L ? lsen[key] : 0.f;
      dcol[tid] = key < L ? dn[key] : 0.f;
    }
    __syncthreads();

    float s[4][4], p1[4][4], p2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = p1[i][j] = p2[i][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[k * kBR + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kt[k * kBC + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
    for (int ch0 = 0; ch0 < C; ch0 += kCK) {
      for (int idx = tid; idx < kCK * kBR; idx += kThreads) {
        const int ch = idx % kCK, r = idx / kCK, c = ch0 + ch;
        const int row = r0 + r, key = c0 + r;
        const bool rok = row < L && c < C, kok = key < L && c < C;
        a1[ch * kBR + r] = rok ? to_f(don[(size_t)row * C + c]) : 0.f;
        a2[ch * kBR + r] = rok ? to_f(vn[(size_t)row * C + c]) : 0.f;
        b1[ch * kBC + r] = kok ? to_f(vn[(size_t)key * C + c]) : 0.f;
        b2[ch * kBC + r] = kok ? to_f(don[(size_t)key * C + c]) : 0.f;
      }
      __syncthreads();
      for (int ch = 0; ch < kCK; ++ch) {
        const float4 x1 = *reinterpret_cast<const float4*>(&a1[ch * kBR + ty * 4]);
        const float4 y1 = *reinterpret_cast<const float4*>(&b1[ch * kBC + tx * 4]);
        const float4 x2 = *reinterpret_cast<const float4*>(&a2[ch * kBR + ty * 4]);
        const float4 y2 = *reinterpret_cast<const float4*>(&b2[ch * kBC + tx * 4]);
        const float xv1[4] = {x1.x, x1.y, x1.z, x1.w}, yv1[4] = {y1.x, y1.y, y1.z, y1.w};
        const float xv2[4] = {x2.x, x2.y, x2.z, x2.w}, yv2[4] = {y2.x, y2.y, y2.z, y2.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p1[i][j] = fmaf(xv1[i], yv1[j], p1[i][j]);
            p2[i][j] = fmaf(xv2[i], yv2[j], p2[i][j]);
          }
      }
      __syncthreads();  // the next chunk overwrites a1..b2
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j;
        float m = 0.f;
        if (c0 + col < L) {
          const float prc = exp2f(s[i][j] - lse_r[i]);
          const float pcr = exp2f(s[i][j] - lsec[col]);
          m = prc * (p1[i][j] - d_r[i]) + pcr * (p2[i][j] - dcol[col]);
        }
        ms[(ty * 4 + i) * kPStride + col] = round_t<T>(m);
      }
    __syncthreads();

    for (int c = 0; c < kBC; ++c) {
      float mv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mv[i] = ms[(ty * 4 + i) * kPStride + c];
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        const int k = tx + 16 * mm;
        if (mm < nd && k < d) {
          const float b = qc[c * d + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][mm] = fmaf(mv[i], b, acc[i][mm]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites kt, qc, ms, lsec, dcol
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= L) continue;
#pragma unroll
    for (int mm = 0; mm < 8; ++mm) {
      const int k = tx + 16 * mm;
      if (mm < nd && k < d) dq[((size_t)n * L + row) * d + k] = from_f<T>(acc[i][mm]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dv_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dv,
                    int L, int d, int C) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                  // [d][kBR]  q_r transposed, times log2(e)
  float* kt = qt + d * kBR;          // [d][kBC]  q_c transposed
  float* ds = kt + d * kBC;          // [kBC][kCC] dO_c chunk
  float* ps = ds + kBC * kCC;        // [kBR][kPStride] P[c, r] as [r][c]
  float* lsec = ps + kBR * kPStride; // [kBC]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kBR, ch0 = blockIdx.y * kCC;
  const int cw = min(kCC, C - ch0);
  const int n = blockIdx.z;
  const T* qn = q + (size_t)n * L * d;
  const T* don = dout + (size_t)n * L * C;
  const float* lsen = lse + (size_t)n * L;

  for (int idx = tid; idx < kBR * d; idx += kThreads) {
    const int r = idx % kBR, k = idx / kBR, row = r0 + r;
    qt[k * kBR + r] = row < L ? to_f(qn[(size_t)row * d + k]) * kLog2e : 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_tiles = (L + kBC - 1) / kBC;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * kBC;
    for (int idx = tid; idx < kBC * d; idx += kThreads) {
      const int col = idx % kBC, k = idx / kBC, key = c0 + col;
      kt[k * kBC + col] = key < L ? to_f(qn[(size_t)key * d + k]) : 0.f;
    }
    for (int idx = tid; idx < kBC * kCC; idx += kThreads) {
      const int key = c0 + idx / kCC, ch = idx % kCC;
      ds[idx] = (key < L && ch < cw) ? to_f(don[(size_t)key * C + ch0 + ch]) : 0.f;
    }
    if (tid < kBC) lsec[tid] = c0 + tid < L ? lsen[c0 + tid] : 0.f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[k * kBR + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kt[k * kBC + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j;
        p[j] = c0 + col < L ? round_t<T>(exp2f(s[i][j] - lsec[col])) : 0.f;
      }
      *reinterpret_cast<float4*>(&ps[(ty * 4 + i) * kPStride + tx * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    for (int k = 0; k < kBC; ++k) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPStride + k];
      const float4 v0 = *reinterpret_cast<const float4*>(&ds[k * kCC + tx * 4]);
      const float4 v1 = *reinterpret_cast<const float4*>(&ds[k * kCC + 64 + tx * 4]);
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites kt, ds, ps and lsec
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= L) continue;
    T* orow = dv + ((size_t)n * L + row) * C + ch0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c0 = tx * 4 + j, c1 = 64 + tx * 4 + j;
      if (c0 < cw) orow[c0] = from_f<T>(acc[i][j]);
      if (c1 < cw) orow[c1] = from_f<T>(acc[i][4 + j]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* v, const void* dout, const void* lse,
           const void* dsum, void* dq, void* dv, int N, int L, int d, int C,
           cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * (size_t)(2 * d * kBR + kBC * d + 4 * kCK * kBR +
                                                  kBR * kPStride + 2 * kBC);
  const size_t smem_dv =
      sizeof(float) * (size_t)(2 * d * kBR + kBC * kCC + kBR * kPStride + kBC);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L + kBR - 1) / kBR;
  flash_bwd_dq_kernel<T><<<dim3(tiles, N), kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<T*>(dq),
      L, d, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dv_kernel<T><<<dim3(tiles, (C + kCC - 1) / kCC, N), kThreads, smem_dv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dv), L, d, C);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core path for bf16 (d in {32, 64}, C <= 256 with C % 8 == 0, 16-byte
// aligned rows): column-owned, see the header. 256 threads, one block per
// (64-key tile, sample); fragments as csrc/mma.cuh lays them out.
// ---------------------------------------------------------------------------

constexpr int kColThreads = 256;
constexpr int kColCMax = 256;

// rows [row0, row0 + 64) of a [L, width] bf16 matrix into smem rows of
// `stride` elements, channels padded to `wpad` (a multiple of 8); rows past L
// and channels past `width` are zero-filled from a valid address
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int L, int width, int wpad, int stride,
                                          int tid) {
  const int per_row = wpad / 8;
  for (int i = tid; i < kBR * per_row; i += kColThreads) {
    const int r = i / per_row, c = (i % per_row) * 8, row = row0 + r;
    const bool ok = row < L && c < width;
    fmi_mma::cp_async16(&dst[r * stride + c], ok ? src + (size_t)row * width + c : src,
                        ok ? 16 : 0);
  }
}

template <int D, int NCW>
struct ColPlan {
  static constexpr int kStages = 3;       // ring of swept row tiles
  static constexpr int kCpad = 64 * NCW;  // value channels, padded
  static constexpr int kQS = D + 8;       // row stride of the q tiles (bf16)
  static constexpr int kCS = kCpad + 8;   // row stride of the v and dO tiles
  static constexpr int kPS = kBR + 8;     // row stride of P^T and dS^T
  // q_c, v_c, q_r[3], dO_r[3], P^T[2], dS^T[2] in bf16; lse_r[3], D_r[3] in f32
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * ((size_t)kBC * kQS + kBC * kCS + kStages * kBR * (kQS + kCS) +
                               4 * kBC * kPS) +
      sizeof(float) * 2 * kStages * kBR;
};

template <int D, int NCW>
__global__ void __launch_bounds__(kColThreads, 1)
flash_bwd_col_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dq_acc,
                     __nv_bfloat16* __restrict__ dv, int L, int C) {
  using namespace fmi_mma;
  using P = ColPlan<D, NCW>;
  constexpr int QS = P::kQS, CS = P::kCS, PS = P::kPS, CP = P::kCpad, NS = P::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qc = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBC][QS] the block's keys
  __nv_bfloat16* vc = qc + kBC * QS;                                // [kBC][CS]
  __nv_bfloat16* qr = vc + kBC * CS;                                // [NS][kBR][QS] swept rows
  __nv_bfloat16* dor = qr + NS * kBR * QS;                          // [NS][kBR][CS]
  __nv_bfloat16* pts = dor + NS * kBR * CS;                         // [2][kBC][PS] P^T
  __nv_bfloat16* dsts = pts + 2 * kBC * PS;                         // [2][kBC][PS] dS^T
  float* lr = reinterpret_cast<float*>(dsts + 2 * kBC * PS);        // [NS][kBR] lse of the rows
  float* dr = lr + NS * kBR;                                        // [NS][kBR] D of the rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lm = lane >> 3, li = lane & 7;
  const int c0 = blockIdx.x * kBC, n = blockIdx.y;
  // warp roles: S^T, dP^T and dS^T on keys kw*16.. x rows rh*32..; dv on
  // keys dk*32.. x channels dc*16*NCW..; the query role on rows qm*16.. and
  // the key role on keys qm*16.., each x head columns qh*D/2..
  const int kw = warp & 3, rh = warp >> 2;
  const int dk = warp & 1, dc = warp >> 1;
  const int qm = warp & 3, qh = warp >> 2;
  const __nv_bfloat16* qn = q + (size_t)n * L * D;
  const __nv_bfloat16* vn = v + (size_t)n * L * C;
  const __nv_bfloat16* don = dout + (size_t)n * L * C;
  const float* lsen = lse + (size_t)n * L;
  const float* dn = dsum + (size_t)n * L;

  load_rows(qc, qn, c0, L, D, D, QS, tid);
  load_rows(vc, vn, c0, L, C, CP, CS, tid);
  auto load_tile = [&](int it, int buf) {
    const int r0 = it * kBR;
    load_rows(qr + buf * kBR * QS, qn, r0, L, D, D, QS, tid);
    load_rows(dor + buf * kBR * CS, don, r0, L, C, CP, CS, tid);
    if (tid < 2 * kBR) {
      const int i = tid % kBR, row = r0 + i;
      const bool ok = row < L;
      cp_async4((tid < kBR ? lr : dr) + buf * kBR + i, (tid < kBR ? lsen : dn) + (ok ? row : 0),
                ok ? 4 : 0);
    }
  };
  const int n_tiles = (L + kBR - 1) / kBR;
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // the block's keys never change: their A fragments stay in registers
  unsigned qf[D / 16][4];        // q_c, rows kw*16..
  unsigned vf[CP / 16][4];       // v_c, rows kw*16..
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], &qc[(kw * 16 + (lm & 1) * 8 + li) * QS + kk * 16 + (lm >> 1) * 8]);
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk)
    ldmatrix_x4(vf[kk], &vc[(kw * 16 + (lm & 1) * 8 + li) * CS + kk * 16 + (lm >> 1) * 8]);
  float dva[2][2 * NCW][4];      // dv of keys dk*32.. x channels dc*16*NCW..
  float dqc[D / 16][4];          // key role of keys qm*16.. x head columns qh*D/2..
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * NCW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[mt][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) dqc[j][0] = dqc[j][1] = dqc[j][2] = dqc[j][3] = 0.f;

  // One barrier an iteration: phase A (S, P, dP, dS) reads row tile it and
  // writes P^T and dS^T buffer it & 1; the barrier publishes them and row
  // tile it + 1; phase B (dv, both roles of dq) reads them while row tile
  // it + 2 streams into the ring slot row tile it - 1 left.
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % NS, r0 = it * kBR;
    __nv_bfloat16* pt = pts + (it & 1) * kBC * PS;
    __nv_bfloat16* dst = dsts + (it & 1) * kBC * PS;
    const __nv_bfloat16* qb = qr + buf * kBR * QS;
    const __nv_bfloat16* ob = dor + buf * kBR * CS;
    const float* lb = lr + buf * kBR;
    const float* db = dr + buf * kBR;

    // S^T = q_c q_r^T (16 keys x 32 rows), then P^T[c, r] = exp2(S2 - lse_r)
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, &qb[(rh * 32 + jp * 16 + (lm >> 1) * 8 + li) * QS + kk * 16 + (lm & 1) * 8]);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    // dP^T = v_c dO_r^T over all channels (placed before the exp2 below,
    // which waits on the S products)
    float dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, &ob[(rh * 32 + jp * 16 + (lm >> 1) * 8 + li) * CS + kk * 16 + (lm & 1) * 8]);
        mma_bf16(dp[2 * jp], vf[kk], b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], vf[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + kw * 16 + g + 8 * (e >> 1);
        const int col = rh * 32 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < L && r0 + col < L ? exp2f(fmaf(s[j][e], kLog2e, -lb[col])) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(&pt[(kw * 16 + g + 8 * h) * PS + rh * 32 + j * 8 + 2 * t]) =
            pack_bf16(s[j][2 * h], s[j][2 * h + 1]);
    // dS^T = P^T (dP^T - D_r) in f32, then rounded to bf16 for both roles
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - db[rh * 32 + j * 8 + 2 * t + (e & 1)];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(&dst[(kw * 16 + g + 8 * h) * PS + rh * 32 + j * 8 + 2 * t]) =
            pack_bf16(s[j][2 * h], s[j][2 * h + 1]);
    cp_async_wait<0>();  // row tile it + 1, the only copies in flight
    __syncthreads();
    if (it + 2 < n_tiles) load_tile(it + 2, (it + 2) % NS);
    cp_async_commit();

    // dv_c += P^T dO_r
#pragma unroll
    for (int kk = 0; kk < kBR / 16; ++kk) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], &pt[(dk * 32 + mt * 16 + (lm & 1) * 8 + li) * PS + kk * 16 +
                               (lm >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < NCW; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, &ob[(kk * 16 + (lm & 1) * 8 + li) * CS + dc * 16 * NCW + np * 16 +
                                 (lm >> 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(dva[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(dva[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    // key role: dq_c += dS^T q_r
#pragma unroll
    for (int kk = 0; kk < kBR / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, &dst[(qm * 16 + (lm & 1) * 8 + li) * PS + kk * 16 + (lm >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < D / 32; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, &qb[(kk * 16 + (lm & 1) * 8 + li) * QS + qh * (D / 2) + np * 16 +
                                 (lm >> 1) * 8]);
        mma_bf16(dqc[2 * np], a, b[0], b[1]);
        mma_bf16(dqc[2 * np + 1], a, b[2], b[3]);
      }
    }
    // query role: dq_r += dS q_c, added to the f32 accumulator
    float dqr[D / 16][4];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dqr[j][0] = dqr[j][1] = dqr[j][2] = dqr[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4_trans(a, &dst[(kk * 16 + (lm >> 1) * 8 + li) * PS + qm * 16 + (lm & 1) * 8]);
#pragma unroll
      for (int np = 0; np < D / 32; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, &qc[(kk * 16 + (lm & 1) * 8 + li) * QS + qh * (D / 2) + np * 16 +
                                 (lm >> 1) * 8]);
        mma_bf16(dqr[2 * np], a, b[0], b[1]);
        mma_bf16(dqr[2 * np + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + qm * 16 + g + 8 * h;
      if (row >= L) continue;
      float* dst_row = dq_acc + ((size_t)n * L + row) * D + qh * (D / 2);
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        atomicAdd(reinterpret_cast<float2*>(dst_row + j * 8 + 2 * t),
                  make_float2(dqr[j][2 * h], dqr[j][2 * h + 1]));
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = c0 + dk * 32 + mt * 16 + g + 8 * h;
      if (key >= L) continue;
      __nv_bfloat16* orow = dv + ((size_t)n * L + key) * C;
#pragma unroll
      for (int j = 0; j < 2 * NCW; ++j) {
        const int ch = dc * 16 * NCW + j * 8 + 2 * t;
        if (ch < C)
          *reinterpret_cast<__nv_bfloat162*>(&orow[ch]) =
              __floats2bfloat162_rn(dva[mt][j][2 * h], dva[mt][j][2 * h + 1]);
      }
    }
  // the key role goes to the accumulator as well
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = c0 + qm * 16 + g + 8 * h;
    if (key >= L) continue;
    float* dst_row = dq_acc + ((size_t)n * L + key) * D + qh * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      atomicAdd(reinterpret_cast<float2*>(dst_row + j * 8 + 2 * t),
                make_float2(dqc[j][2 * h], dqc[j][2 * h + 1]));
  }
}

// dq = the f32 accumulator rounded once to bf16 (pairs; the count is even)
__global__ void dq_round_kernel(const float2* __restrict__ acc, __nv_bfloat162* __restrict__ dq,
                                size_t pairs) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = __floats2bfloat162_rn(acc[i].x, acc[i].y);
}

template <int D, int NCW>
int launch_col(const void* q, const void* v, const void* dout, const void* lse,
               const void* dsum, void* dq, void* dv, void* work, int N, int L, int C,
               cudaStream_t stream) {
  using B = __nv_bfloat16;
  const size_t count = (size_t)N * L * D;
  cudaError_t err = cudaMemsetAsync(work, 0, count * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = ColPlan<D, NCW>::kSmem;
  err = cudaFuncSetAttribute(flash_bwd_col_kernel<D, NCW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_col_kernel<D, NCW><<<dim3((L + kBC - 1) / kBC, N), kColThreads, smem, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(v), static_cast<const B*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<float*>(work), static_cast<B*>(dv), L, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t pairs = count / 2;
  const int blocks = static_cast<int>(std::min<size_t>((pairs + 255) / 256, 4096));
  dq_round_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float2*>(work),
                                              static_cast<__nv_bfloat162*>(dq), pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_col_d(const void* q, const void* v, const void* dout, const void* lse,
                 const void* dsum, void* dq, void* dv, void* work, int N, int L, int C,
                 cudaStream_t s) {
  switch ((C + 63) / 64) {
    case 1: return launch_col<D, 1>(q, v, dout, lse, dsum, dq, dv, work, N, L, C, s);
    case 2: return launch_col<D, 2>(q, v, dout, lse, dsum, dq, dv, work, N, L, C, s);
    case 3: return launch_col<D, 3>(q, v, dout, lse, dsum, dq, dv, work, N, L, C, s);
    default: return launch_col<D, 4>(q, v, dout, lse, dsum, dq, dv, work, N, L, C, s);
  }
}

// ---------------------------------------------------------------------------
// Split-precision path for f32 (d in {32, 64}, C <= 256 with C % 8 == 0,
// 16-byte aligned tensors): the bf16 route's column-owned schedule, 704
// multiply-adds an ordered pair, with every product on the tensor cores as
// three TF32 products (mma.sync m16n8k8, csrc/mma.cuh): S^T, dP^T, dv, and
// both roles of dq. P and dS stay f32 and are split as the other operands
// are; no operand is rounded to a narrower type.
//
// Design: one block of 8 warps per (64-key tile c, sample) holds q_c and v_c
// in shared memory and sweeps 32-row tiles r (q_r, dO_r and their lse and D)
// through a 3-stage cp.async ring. In f32 the bf16 plan (64-row tiles, v_c's
// fragments in registers, double-buffered P^T and dS^T) needs about 420 KB
// of shared memory and 128 more registers a thread; here v_c's fragments
// are read from shared memory at each use, the row tiles are half as tall
// and P^T and dS^T are single-buffered, which costs a second barrier a tile
// pair (229 KB at d = 64, C = 256). Per tile pair:
//   phase A, warp (16 keys, 16 rows): S^T = q_c q_r^T, dP^T = v_c dO_r^T,
//     P^T = exp2(S2 - lse_r), dS^T = P^T (dP^T - D_r), into shared memory;
//   phase B: dv_c += P^T dO_r (warp: 32 keys x C/4 channels), the key role
//     dq_c += dS^T q_r (16 keys x d/2), the query role dq_r += dS q_c (16
//     rows x d/4), added to dq with f32 atomics. dv and the key role sum
//     L rows: a tile's products go to zeroed fragments (dv's in two halves
//     of its channels) that one rounded add each takes into the sum, since
//     the tensor cores' accumulate drifts over long sums (csrc/mma.cuh;
//     with dv added in place, K5 used 1.3 of its gate at config 5 on an
//     H100, 0.07 this way: tools/tensor_core_variants.py).
// Operands stored K-contiguous take their fragments by ldmatrix; those
// stored [K][N] (dO_r for dv, q_r for the key role, q_c for the query role)
// by scalar loads of the k pair (2t, 2t + 1), and P^T and dS^T are stored
// with the rows of each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 so
// that ldmatrix gives A fragments in that k order too (csrc/mma.cuh). All
// row strides are 4 mod 32 words: ldmatrix, the k pairs and the transposed
// reads of dS^T are free of bank conflicts.
// What holds it back: phase A's warp tiles are 16 x 16, so each of its
// fragments is split for two products; dP^T (36% of the work) spends about
// four splits a three-product step on the ALUs.
// dq: the f32 output itself is the accumulator (zeroed first): the query
// role of a row gathers over all key tiles and meets the key role there
// through atomics, so f32 dq is not bit-deterministic, as the bf16 route's
// is not; the CUDA-core route and the JAX kernels are. dv is. Error: the
// split keeps about 21 bits of each operand (csrc/mma.cuh), against the
// gate's 1e-4 of the largest plain entry.
// ---------------------------------------------------------------------------

constexpr int kTfBR = 32;       // rows a swept tile
constexpr int kTfStages = 3;

template <int D, int NCW>
struct TfPlan {
  static constexpr int kCpad = 64 * NCW;  // value channels, padded
  static constexpr int kQS = D + 4;       // row strides in f32, 4 mod 32
  static constexpr int kCS = kCpad + 4;
  static constexpr int kPS = kTfBR + 4;
  // q_c, v_c, q_r[3], dO_r[3], P^T, dS^T, lse_r[3], D_r[3]
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBC * (kQS + kCS) + (size_t)kTfStages * kTfBR * (kQS + kCS) +
                       2 * kBC * kPS + 2 * kTfStages * kTfBR);
};

// the shared column of logical row r (within the tile) of P^T and dS^T
__device__ __forceinline__ int perm8(int r) { return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2); }

template <int D, int NCW>
__global__ void __launch_bounds__(kColThreads, 1)
flash_bwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ v,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dsum, float* __restrict__ dq,
                        float* __restrict__ dv, int L, int C) {
  using namespace fmi_mma;
  using P = TfPlan<D, NCW>;
  constexpr int QS = P::kQS, CS = P::kCS, PS = P::kPS, CP = P::kCpad, NS = kTfStages;
  extern __shared__ __align__(16) float smem[];
  float* qc = smem;                   // [kBC][QS] the block's keys
  float* vc = qc + kBC * QS;          // [kBC][CS]
  float* qr = vc + kBC * CS;          // [NS][kTfBR][QS] swept rows
  float* dor = qr + NS * kTfBR * QS;  // [NS][kTfBR][CS]
  float* pt = dor + NS * kTfBR * CS;  // [kBC][PS] P^T, rows permuted within 8
  float* dst = pt + kBC * PS;         // [kBC][PS] dS^T, the same
  float* lr = dst + kBC * PS;         // [NS][kTfBR] lse of the rows
  float* dr = lr + NS * kTfBR;        // [NS][kTfBR] D of the rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lm = lane >> 3, li = lane & 7;
  const int c0 = blockIdx.x * kBC, n = blockIdx.y;
  // warp roles: phase A on keys kw*16.. x rows rh*16..; dv on keys dk*32.. x
  // channels dc*CP/4..; the key role on keys qm*16.. x head columns
  // qh*D/2..; the query role on rows rm*16.. x head columns rq*D/4..
  const int kw = warp & 3, rh = warp >> 2;
  const int dk = warp & 1, dc = warp >> 1;
  const int qm = warp & 3, qh = warp >> 2;
  const int rm = warp & 1, rq = warp >> 1;
  const float* qn = q + (size_t)n * L * D;
  const float* vn = v + (size_t)n * L * C;
  const float* don = dout + (size_t)n * L * C;
  const float* lsen = lse + (size_t)n * L;
  const float* dn = dsum + (size_t)n * L;

  load_rows_f32(qc, qn, c0, kBC, L, D, D, QS, tid, kColThreads);
  load_rows_f32(vc, vn, c0, kBC, L, C, CP, CS, tid, kColThreads);
  auto load_tile = [&](int it, int slot) {
    const int r0 = it * kTfBR;
    load_rows_f32(qr + slot * kTfBR * QS, qn, r0, kTfBR, L, D, D, QS, tid, kColThreads);
    load_rows_f32(dor + slot * kTfBR * CS, don, r0, kTfBR, L, C, CP, CS, tid,
                  kColThreads);
    if (tid < 2 * kTfBR) {
      const int i = tid % kTfBR, row = r0 + i;
      const bool ok = row < L;
      cp_async4((tid < kTfBR ? lr : dr) + slot * kTfBR + i,
                (tid < kTfBR ? lsen : dn) + (ok ? row : 0), ok ? 4 : 0);
    }
  };
  const int n_tiles = (L + kTfBR - 1) / kTfBR;
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  float dva[2][CP / 32][4];  // dv of keys dk*32.. x channels dc*CP/4..
  float dqc[D / 16][4];      // key role of keys qm*16.. x head columns qh*D/2..
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < CP / 32; ++j)
      dva[mt][j][0] = dva[mt][j][1] = dva[mt][j][2] = dva[mt][j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) dqc[j][0] = dqc[j][1] = dqc[j][2] = dqc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it % NS, r0 = it * kTfBR;
    cp_async_wait<1>();  // everything but the newest tile has landed
    __syncthreads();     // ... for every thread; phase B of it - 1 is done everywhere
    if (it + 2 < n_tiles) load_tile(it + 2, (it + 2) % NS);
    cp_async_commit();
    const float* qb = qr + slot * kTfBR * QS;
    const float* ob = dor + slot * kTfBR * CS;
    const float* lb = lr + slot * kTfBR;
    const float* db = dr + slot * kTfBR;

    // phase A: S^T = q_c q_r^T and dP^T = v_c dO_r^T (16 keys x 16 rows)
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      unsigned a[4], ah[4], al[4], b[4];
      ldmatrix_x4(a, &qc[(kw * 16 + (lm & 1) * 8 + li) * QS + kk * 8 + (lm >> 1) * 4]);
      split_a(a, ah, al);
      ldmatrix_x4(b, &qb[(rh * 16 + (lm >> 1) * 8 + li) * QS + kk * 8 + (lm & 1) * 4]);
      mma_tf32x3(s[0], ah, al, __uint_as_float(b[0]), __uint_as_float(b[1]));
      mma_tf32x3(s[1], ah, al, __uint_as_float(b[2]), __uint_as_float(b[3]));
    }
#pragma unroll 4
    for (int kk = 0; kk < CP / 8; ++kk) {
      unsigned a[4], ah[4], al[4], b[4];
      ldmatrix_x4(a, &vc[(kw * 16 + (lm & 1) * 8 + li) * CS + kk * 8 + (lm >> 1) * 4]);
      split_a(a, ah, al);
      ldmatrix_x4(b, &ob[(rh * 16 + (lm >> 1) * 8 + li) * CS + kk * 8 + (lm & 1) * 4]);
      mma_tf32x3(dp[0], ah, al, __uint_as_float(b[0]), __uint_as_float(b[1]));
      mma_tf32x3(dp[1], ah, al, __uint_as_float(b[2]), __uint_as_float(b[3]));
    }
    // P^T[c, r] = exp2(S2 - lse_r), dS^T = P^T (dP^T - D_r), stored with the
    // rows of each 8 permuted (perm8)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key_i = kw * 16 + g + 8 * (e >> 1);
        const int col = rh * 16 + j * 8 + 2 * t + (e & 1);
        const float p = c0 + key_i < L && r0 + col < L ? exp2f(fmaf(s[j][e], kLog2e, -lb[col]))
                                                       : 0.f;
        const int at = key_i * PS + rh * 16 + j * 8 + t + 4 * (e & 1);  // perm8(col)
        pt[at] = p;
        dst[at] = p * (dp[j][e] - db[col]);
      }
    __syncthreads();  // P^T and dS^T are complete

    // dv_c += P^T dO_r, 8 rows a step in the order of perm8; half the
    // n-tiles at a time, the tile's 32 rows in zeroed fragments, then one
    // rounded add each: dv sums L rows (csrc/mma.cuh on the tensor cores'
    // accumulate)
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      float part[2][CP / 64][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jj = 0; jj < CP / 64; ++jj)
          part[mt][jj][0] = part[mt][jj][1] = part[mt][jj][2] = part[mt][jj][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTfBR / 8; ++kk) {
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          unsigned a[4];
          ldmatrix_x4(a, &pt[(dk * 32 + mt * 16 + (lm & 1) * 8 + li) * PS + kk * 8 +
                             (lm >> 1) * 4]);
          split_a(a, ah[mt], al[mt]);
        }
        // rows 2t, 2t + 1
        const float* orow = ob + (kk * 8 + 2 * t) * CS + dc * (CP / 4) + jh * (CP / 8) + g;
#pragma unroll
        for (int jj = 0; jj < CP / 64; ++jj) {
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(orow[jj * 8], bh0, bl0);
          split_tf32(orow[CS + jj * 8], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_tf32x3(part[mt][jj], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jj = 0; jj < CP / 64; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) dva[mt][jh * (CP / 64) + jj][e] += part[mt][jj][e];
    }
    // key role: dq_c += dS^T q_r, the tile's 32 rows summed apart first
    float dqt[D / 16][4];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dqt[j][0] = dqt[j][1] = dqt[j][2] = dqt[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTfBR / 8; ++kk) {
      unsigned a[4], ah[4], al[4];
      ldmatrix_x4(a, &dst[(qm * 16 + (lm & 1) * 8 + li) * PS + kk * 8 + (lm >> 1) * 4]);
      split_a(a, ah, al);
      const float* qrow = qb + (kk * 8 + 2 * t) * QS + qh * (D / 2) + g;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) mma_tf32x3(dqt[j], ah, al, qrow[j * 8], qrow[QS + j * 8]);
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqc[j][e] += dqt[j][e];
    // query role: dq_r += dS q_c over the block's 64 keys, k pairs (2t, 2t + 1);
    // dS[r, c] is dS^T[c][perm8(r)]
    float dqr[D / 32][4];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) dqr[j][0] = dqr[j][1] = dqr[j][2] = dqr[j][3] = 0.f;
    const int pr = perm8(rm * 16 + g);
#pragma unroll
    for (int kk = 0; kk < kBC / 8; ++kk) {
      const float* d0 = dst + (kk * 8 + 2 * t) * PS + pr;  // keys 2t, 2t + 1
      const float a[4] = {d0[0], d0[8], d0[PS], d0[PS + 8]};
      unsigned ah[4], al[4];
      split_a(a, ah, al);
      const float* crow = qc + (kk * 8 + 2 * t) * QS + rq * (D / 4) + g;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) mma_tf32x3(dqr[j], ah, al, crow[j * 8], crow[QS + j * 8]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + rm * 16 + g + 8 * h;
      if (row >= L) continue;
      float* drow = dq + ((size_t)n * L + row) * D + rq * (D / 4);
#pragma unroll
      for (int j = 0; j < D / 32; ++j)
        atomicAdd(reinterpret_cast<float2*>(drow + j * 8 + 2 * t),
                  make_float2(dqr[j][2 * h], dqr[j][2 * h + 1]));
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = c0 + dk * 32 + mt * 16 + g + 8 * h;
      if (key >= L) continue;
      float* orow = dv + ((size_t)n * L + key) * C;
#pragma unroll
      for (int j = 0; j < CP / 32; ++j) {
        const int ch = dc * (CP / 4) + j * 8 + 2 * t;
        if (ch < C)
          *reinterpret_cast<float2*>(&orow[ch]) =
              make_float2(dva[mt][j][2 * h], dva[mt][j][2 * h + 1]);
      }
    }
  // the key role goes to dq as well
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = c0 + qm * 16 + g + 8 * h;
    if (key >= L) continue;
    float* drow = dq + ((size_t)n * L + key) * D + qh * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      atomicAdd(reinterpret_cast<float2*>(drow + j * 8 + 2 * t),
                make_float2(dqc[j][2 * h], dqc[j][2 * h + 1]));
  }
}

template <int D, int NCW>
int launch_tf32x3(const void* q, const void* v, const void* dout, const void* lse,
                  const void* dsum, void* dq, void* dv, int N, int L, int C,
                  cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(dq, 0, (size_t)N * L * D * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = TfPlan<D, NCW>::kSmem;
  err = cudaFuncSetAttribute(flash_bwd_tf32x3_kernel<D, NCW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_tf32x3_kernel<D, NCW><<<dim3((L + kBC - 1) / kBC, N), kColThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<float*>(dq), static_cast<float*>(dv), L, C);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32x3_d(const void* q, const void* v, const void* dout, const void* lse,
                    const void* dsum, void* dq, void* dv, int N, int L, int C, cudaStream_t s) {
  switch ((C + 63) / 64) {
    case 1: return launch_tf32x3<D, 1>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
    case 2: return launch_tf32x3<D, 2>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
    case 3: return launch_tf32x3<D, 3>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
    default: return launch_tf32x3<D, 4>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

bool shape_ok(int N, int L, int d, int C) {
  return N >= 1 && N <= 65535 && L >= 1 && d >= 1 && d <= kDMax && C >= 1;
}

}  // namespace

// Which K5 kernels take a call: for bf16, 1 the tensor-core kernel; for
// f32, 2 the split-precision (3xTF32) kernel; 0 the CUDA-core kernels. Both
// tensor-core routes take d in {32, 64}, C <= 256 with C % 8 == 0 and
// 16-byte aligned tensors. By type, shape and alignment only.
extern "C" int fmi_flash_attention_bwd_route(int bf16, const void* q, const void* v,
                                             const void* dout, const void* dq, const void* dv,
                                             int d, int C) {
  const bool ok = (d == 32 || d == 64) && C % 8 == 0 && C <= kColCMax && aligned16(q) &&
                  aligned16(v) && aligned16(dout) && aligned16(dq) && aligned16(dv);
  return !ok ? 0 : bf16 ? 1 : 2;
}

// q [N, L, d], v and dout [N, L, C], lse and dsum [N, L] f32, dq [N, L, d]
// and dv [N, L, C] outputs (contiguous; q, v, dout, dq, dv of one type).
// Returns a cudaError_t code; 0 means the kernels launched. f32 takes the
// route above: the split-precision kernel or the CUDA-core kernels.
extern "C" int fmi_flash_attention_bwd_f32(const void* q, const void* v, const void* dout,
                                           const void* lse, const void* dsum, void* dq,
                                           void* dv, int N, int L, int d, int C,
                                           void* stream) {
  if (!shape_ok(N, L, d, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fmi_flash_attention_bwd_route(0, q, v, dout, dq, dv, d, C))
    return launch<float>(q, v, dout, lse, dsum, dq, dv, N, L, d, C, s);
  if (d == 64) return launch_tf32x3_d<64>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
  return launch_tf32x3_d<32>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
}

// bf16: the route above decides. The tensor-core route needs `work`, an f32
// [N, L, d] scratch for dq (zeroed here); the CUDA-core route ignores it.
extern "C" int fmi_flash_attention_bwd_bf16(const void* q, const void* v, const void* dout,
                                            const void* lse, const void* dsum, void* dq,
                                            void* dv, void* work, int N, int L, int d, int C,
                                            void* stream) {
  if (!shape_ok(N, L, d, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fmi_flash_attention_bwd_route(1, q, v, dout, dq, dv, d, C))
    return launch<__nv_bfloat16>(q, v, dout, lse, dsum, dq, dv, N, L, d, C, s);
  if (work == nullptr || !aligned16(work)) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64) return launch_col_d<64>(q, v, dout, lse, dsum, dq, dv, work, N, L, C, s);
  return launch_col_d<32>(q, v, dout, lse, dsum, dq, dv, work, N, L, C, s);
}
