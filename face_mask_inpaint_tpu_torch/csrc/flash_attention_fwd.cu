// Flash-attention forward for the PICNet self-similarity maps (kernel K1).
//
// Replaces: face_mask_inpaint_tpu/ops/pallas/flash_attention.py, `_forward`
// (`_fwd_kernel`) and its triangular-schedule twin `_sym_forward`, which
// compute the same function.
//
// Computes, for q [N, L, d] and v [N, L, C] (several value tensors
// concatenated on channels, all sharing one map):
//     out[n, i, :] = sum_j softmax_j(q_i . q_j) v[n, j, :]
// query == key, no 1/sqrt(d) scale. The softmax runs in base 2 with log2(e)
// folded in, in f32, with an online max and sum; P is rounded to bf16 before
// P V on the bf16 tensor-core path, as the TPU kernel rounds it to the value
// type (in f32, P stays f32). Optionally writes the per-row
// lse = m + log2(l) (base 2) for a later backward.
//
// What bounds it on an H100: at the flagship (L = 16384, d = 64, C = 256) the
// forward is 2 L^2 (d + C) ~ 172 GFLOP per sample against 2 L (d + C) values
// read, so it is compute-bound (2.78 ms at the dense bf16 peak for the
// batch of 16, 16.7 ms for three TF32 products at the dense TF32 peak): the
// products have to run on the tensor cores, and the [L, L] map must never
// reach device memory. Ragged L is masked: padded keys score -inf, padded
// query rows are neither stored nor given an lse.
//
// Three kernels; fmi_flash_attention_fwd_route picks one by type, shape and
// alignment only. Two routes take d = 64 (bf16) or d in {32, 64} (f32) with
// C <= 256, C % 8 == 0 and 16-byte aligned tensors (the flagship, config 5,
// Stack A's two values of 200 + 56 channels):
// - bf16: the warp-specialised kernel on the warpgroup tensor cores (wgmma,
//   TMA; see its section). One block takes 128 query rows and all channels,
//   so no score is computed twice. At the flagship it ran at 545 TFLOP/s
//   (5.04 ms on an H100 SXM at 700 W, where scaled_dot_product_attention
//   took 5.85 ms). What holds it back is the softmax between its two
//   products: the products wait for it, and without the P V products the
//   kernel still took 3.3-3.6 ms (tools/tensor_core_variants.py).
// - f32: the split-precision kernel (3xTF32 on mma.sync m16n8k8, see its
//   section and csrc/mma.cuh), held to the same f32 gate as the CUDA-core
//   kernel. torch.backends.cuda.matmul.allow_tf32 does not govern it: that
//   flag means one TF32 product, about 11 bits, which this route is not.
// - everything else (other d or C, misaligned tensors): the CUDA cores in
//   f32, 256 threads, one block per (64-row query tile, 128-channel chunk,
//   sample); each chunk recomputes its scores. Each thread owns a 4x4 score
//   tile and a 4x8 accumulator tile; the rows of both coincide, so the
//   online rescale needs no exchange beyond 16-lane shuffles for the row
//   max and row sum. This path sits far below the tensor-core rate; no path
//   of the repo runs it but d = 48.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kCC = 128;       // value channels per block
constexpr int kPStride = kBK + 4;  // padded P rows: two rows read together
                                   // land in different banks
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 int L, int d, int C) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [d][kBQ]  q tile, transposed, times log2(e)
  float* kt = qt + d * kBQ;      // [d][kBK]  key tile, transposed
  float* vs = kt + d * kBK;      // [kBK][kCC]
  float* ps = vs + kBK * kCC;    // [kBQ][kPStride] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // owns score columns / channels tx*4 .. tx*4+3
  const int ty = tid >> 4;   // owns rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int c0 = blockIdx.y * kCC;
  const int cw = min(kCC, C - c0);
  const int n = blockIdx.z;
  const T* qn = q + (size_t)n * L * d;
  const T* vn = v + (size_t)n * L * C;

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int r = idx % kBQ, k = idx / kBQ;
    const int row = q0 + r;
    qt[k * kBQ + r] = row < L ? to_f(qn[(size_t)row * d + k]) * kLog2e : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (L + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      const int col = idx % kBK, k = idx / kBK;
      const int key = k0 + col;
      kt[k * kBK + col] = key < L ? to_f(qn[(size_t)key * d + k]) : 0.f;
    }
    for (int idx = tid; idx < kBK * kCC; idx += kThreads) {
      const int key = k0 + idx / kCC, ch = idx % kCC;
      vs[idx] = (key < L && ch < cw) ? to_f(vn[(size_t)key * C + c0 + ch]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[k * kBQ + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kt[k * kBK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx * 4 + j >= L) s[i][j] = -INFINITY;
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(&ps[(ty * 4 + i) * kPStride + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    for (int k = 0; k < kBK; ++k) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPStride + k];
      const float4 v0 = *reinterpret_cast<const float4*>(&vs[k * kCC + tx * 4]);
      const float4 v1 = *reinterpret_cast<const float4*>(&vs[k * kCC + 64 + tx * 4]);
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites kt, vs and ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
    const float inv = 1.f / l[i];
    T* orow = o + ((size_t)n * L + row) * C + c0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch0 = tx * 4 + j, ch1 = 64 + tx * 4 + j;
      if (ch0 < cw) orow[ch0] = from_f<T>(acc[i][j] * inv);
      if (ch1 < cw) orow[ch1] = from_f<T>(acc[i][4 + j] * inv);
    }
    if (lse != nullptr && blockIdx.y == 0 && tx == 0)
      lse[(size_t)n * L + row] = m[i] + log2f(l[i]);
  }
}

template <typename T>
int launch(const void* q, const void* v, void* o, void* lse, int N, int L,
           int d, int C, void* stream) {
  if (N < 1 || L < 1 || d < 1 || d > kDMax || C < 1 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (size_t)(2 * d * kBQ + kBK * kCC + kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kBQ - 1) / kBQ, (C + kCC - 1) / kCC, N);
  flash_fwd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), L, d, C);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Split-precision path for f32 (d in {32, 64}, C <= 256 with C % 8 == 0,
// 16-byte aligned tensors): every product on the tensor cores as three TF32
// products (csrc/mma.cuh: hi = rna(x), lo = rna(x - hi), a b = al bh + ah bl
// + ah bh), S = Q K^T and O += P V alike, P kept in f32 and split as the
// other operands are.
//
// Design: mma.sync m16n8k8 .tf32, one block of 8 warps per (128 query rows,
// sample) with all C channels, so no score is computed twice; each warp owns
// 16 rows and their O (C/8 x 4 f32 a thread, 128 at C = 256). Key tiles of
// 32 keys (K [32][d] and V [32][C] in f32) stream through a 3-stage
// cp.async ring, with one barrier a tile; Q stays in shared memory. Why not
// wgmma, as the bf16 route: wgmma takes tf32 operands only K-major, so V
// would have to reach shared memory transposed, and both hi and lo of every
// B tile too (64 KB a 32-key V tile at C = 256, twice that for a ring), next
// to the raw tiles the loads land in; mma.sync splits in registers at each
// fragment load and keeps one f32 copy. The cost of that choice is the
// split on the ALUs: every warp splits the whole V tile (two roundings and
// a subtract an element), about two splits a three-product step, which
// compete with the tensor cores for the warp schedulers' cycles.
// - Q and K are K-major: ldmatrix (non-transposed) serves their fragments.
// - P never leaves registers: the C fragment of S, physical keys 2t and 2t +
//   1 of each 8, is the A fragment of P V in the k order 0, 2, 4, 6, 1, 3,
//   5, 7; V ([keys][channels], MN-major for this product) is read with
//   scalar loads of rows 2t and 2t + 1, conflict-free at the row stride C +
//   4.
// Error: the split keeps about 21 bits of each operand, so a product is off
// by about 2^-21 of |a||b| where one TF32 product is off by 2^-11. An error
// e in log2(e) S moves P by the relative factor 2^e; with |q|^2 ~ 4 as at
// the flagship the scores' error is ~1e-6, far below the gate's 1e-4
// relative. O sums L keys: a tile's products go to zeroed fragments (64
// channels at a time, eight independent chains) that one rounded add each
// takes into O, since the tensor cores' accumulate drifts over long sums
// (csrc/mma.cuh; added in place, O used 0.40 of its gate at the flagship on
// an H100, 0.02 this way: tools/tensor_core_variants.py). The gate of the f32
// route (|kernel - plain| <= 1e-4 + 1e-4 |plain|, lse within 1e-3) is the
// CUDA-core kernel's, unchanged.
// ---------------------------------------------------------------------------

constexpr int kTfBQ = 128;    // query rows a block, 16 a warp
constexpr int kTfBK = 32;     // keys a tile
constexpr int kTfStages = 3;
constexpr int kTfThreads = 256;

template <int D, int NCW>
struct TfPlan {
  static constexpr int kCpad = 64 * NCW;  // value channels, padded
  static constexpr int kQS = D + 4;       // row strides in f32, 4 mod 32
  static constexpr int kVS = kCpad + 4;
  static constexpr int kStage = kTfBK * (kQS + kVS);  // a K and a V tile, in f32
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kTfBQ * kQS + (size_t)kTfStages * kStage);
};

template <int D, int NCW>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ v,
                        float* __restrict__ o, float* __restrict__ lse, int L, int C) {
  using namespace fmi_mma;
  using P = TfPlan<D, NCW>;
  constexpr int QS = P::kQS, VS = P::kVS, CP = P::kCpad, NS = kTfStages;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kTfBQ][QS]
  float* ring = qs + kTfBQ * QS;     // [NS][K tile [kTfBK][QS], V tile [kTfBK][VS]]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lm = lane >> 3, li = lane & 7;
  const int q0 = blockIdx.x * kTfBQ, n = blockIdx.y;
  const float* qn = q + (size_t)n * L * D;
  const float* vn = v + (size_t)n * L * C;

  auto load_tile = [&](int tile, int slot) {
    float* st = ring + slot * P::kStage;
    load_rows_f32(st, qn, tile * kTfBK, kTfBK, L, D, D, QS, tid, kTfThreads);
    load_rows_f32(st + kTfBK * QS, vn, tile * kTfBK, kTfBK, L, C, CP, VS, tid, kTfThreads);
  };
  const int n_tiles = (L + kTfBK - 1) / kTfBK;
  load_rows_f32(qs, qn, q0, kTfBQ, L, D, D, QS, tid, kTfThreads);
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  float acc[CP / 8][4];  // O of rows g, g + 8 of the warp's 16
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();  // everything but the newest tile has landed
    __syncthreads();     // ... for every thread; the slot of tile it - 1 is free
    if (it + 2 < n_tiles) load_tile(it + 2, (it + 2) % NS);
    cp_async_commit();
    const float* kb = ring + (it % NS) * P::kStage;
    const float* vb = kb + kTfBK * QS;

    // S = Q K^T: the warp's 16 rows x 32 keys
    float s[kTfBK / 8][4];
#pragma unroll
    for (int j = 0; j < kTfBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      unsigned a[4], ah[4], al[4];
      ldmatrix_x4(a, &qs[(warp * 16 + (lm & 1) * 8 + li) * QS + kk * 8 + (lm >> 1) * 4]);
      split_a(a, ah, al);
#pragma unroll
      for (int jp = 0; jp < kTfBK / 16; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, &kb[(jp * 16 + (lm >> 1) * 8 + li) * QS + kk * 8 + (lm & 1) * 4]);
        mma_tf32x3(s[2 * jp], ah, al, __uint_as_float(b[0]), __uint_as_float(b[1]));
        mma_tf32x3(s[2 * jp + 1], ah, al, __uint_as_float(b[2]), __uint_as_float(b[3]));
      }
    }

    const int k0 = it * kTfBK;
    if (k0 + kTfBK > L) {
#pragma unroll
      for (int j = 0; j < kTfBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= L) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTfBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m_r[h], mx * kLog2e);  // running max, base-2 scale
      const float alpha = exp2f(m_r[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kTfBK / 8; ++j) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -m_new));
          rs += s[j][e];
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_r[h] = l_r[h] * alpha + rs;
      m_r[h] = m_new;
#pragma unroll
      for (int j = 0; j < CP / 8; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
    }

    // O += P V, 8 keys a step in the k order 0, 2, 4, 6, 1, 3, 5, 7: P's C
    // fragment of keys 8 kk.. is its A fragment
    unsigned ph[kTfBK / 8][4], pl[kTfBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kTfBK / 8; ++kk) {
      const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      split_a(pa, ph[kk], pl[kk]);
    }
    const float* vrow = vb + 2 * t * VS + g;  // keys 2t and 2t + 1 of each 8
#pragma unroll
    for (int jg = 0; jg < CP / 64; ++jg) {
      // 64 channels at a time: the tile's 32 keys in zeroed fragments, then
      // one rounded add each: O sums L keys (csrc/mma.cuh on the tensor
      // cores' accumulate)
      float part[8][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) part[jj][0] = part[jj][1] = part[jj][2] = part[jj][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTfBK / 8; ++kk)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* v0 = vrow + kk * 8 * VS + (jg * 8 + jj) * 8;
          mma_tf32x3(part[jj], ph[kk], pl[kk], v0[0], v0[VS]);
        }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jg * 8 + jj][e] += part[jj][e];
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= L) continue;
    const float inv = 1.f / l_r[h];
    float* orow = o + ((size_t)n * L + row) * C;
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      const int ch = j * 8 + 2 * t;
      if (ch < C)
        *reinterpret_cast<float2*>(&orow[ch]) =
            make_float2(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
    if (lse != nullptr && t == 0) lse[(size_t)n * L + row] = m_r[h] + log2f(l_r[h]);
  }
}

template <int D, int NCW>
int launch_tf32x3(const void* q, const void* v, void* o, void* lse, int N, int L, int C,
                  void* stream) {
  constexpr size_t smem = TfPlan<D, NCW>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D, NCW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTfBQ - 1) / kTfBQ, N);
  flash_fwd_tf32x3_kernel<D, NCW><<<grid, kTfThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), L, C);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32x3_d(const void* q, const void* v, void* o, void* lse, int N, int L, int C,
                    void* stream) {
  switch ((C + 63) / 64) {
    case 1: return launch_tf32x3<D, 1>(q, v, o, lse, N, L, C, stream);
    case 2: return launch_tf32x3<D, 2>(q, v, o, lse, N, L, C, stream);
    case 3: return launch_tf32x3<D, 3>(q, v, o, lse, N, L, C, stream);
    default: return launch_tf32x3<D, 4>(q, v, o, lse, N, L, C, stream);
  }
}

// ---------------------------------------------------------------------------
// Warp-specialised path on Hopper's warpgroup tensor cores, for bf16 with
// d = 64 and C <= 256 (C % 8 == 0, 16-byte aligned rows): the flagship's and
// config 5's configuration. One block of three warpgroups takes 128 query
// rows x all C channels x one sample:
//   - warpgroup 2 (producer) gives up registers and one thread keeps TMA
//     loads in flight: Q once (two 64-row boxes), then per 64-key tile the
//     K box [64 keys][64] and four V boxes [64 keys][64 channels], into a
//     ring of kWgStages stages, each with a full and an empty mbarrier.
//     Boxes past L or C arrive as zeros.
//   - warpgroups 0 and 1 (consumers) take 64 query rows each and raise their
//     registers: S = Q K^T is wgmma m64n64k16 (both K-major), the online
//     softmax runs on its f32 fragment in registers, P is rounded to bf16 in
//     registers and is the A operand of O += P V, wgmma m64n256k16 with V
//     MN-major (the transpose bit). O stays in 128 f32 registers a thread.
// No score is computed twice: the executed work is the function's.
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;        // query rows a block (64 per consumer warpgroup)
constexpr int kWgBK = 64;         // keys a tile
constexpr int kWgD = 64;          // head dim of this path
constexpr int kWgCMax = 256;      // value channels: four 64-channel boxes
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;
constexpr int kWgTileBytes = kWgBK * kWgD * 2;            // one 64 x 64 bf16 box: 8 KB
constexpr int kWgStageBytes = kWgTileBytes * (1 + kWgCMax / 64);  // K + 4 V boxes
constexpr size_t kWgSmem = 1024 /* alignment slack */ + 2 * kWgTileBytes /* Q */ +
                           static_cast<size_t>(kWgStages) * kWgStageBytes +
                           sizeof(uint64_t) * (1 + 2 * kWgStages);

__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int L, int C) {
  using namespace fmi_wgmma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(sm);            // [128][64]
  unsigned char* ring = sm + 2 * kWgTileBytes;                          // [stage][K, V0..V3]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kWgStages * kWgStageBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kWgStages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kWgBQ, n = blockIdx.y;
  const int n_tiles = (L + kWgBK - 1) / kWgBK;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: the paths of the two roles never meet again
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_expect_tx(q_full, 2 * kWgTileBytes);
      tma_load_3d(qs, &qmap, q_full, 0, q0, n);
      tma_load_3d(qs + kWgBK * kWgD, &qmap, q_full, 0, q0 + kWgBK, n);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kWgStages;
        mbar_wait(&empty[s], ((t / kWgStages) & 1) ^ 1);
        unsigned char* st = ring + s * kWgStageBytes;
        mbar_expect_tx(&full[s], kWgStageBytes);
        tma_load_3d(st, &qmap, &full[s], 0, t * kWgBK, n);
#pragma unroll
        for (int cb = 0; cb < kWgCMax / 64; ++cb)
          tma_load_3d(st + (1 + cb) * kWgTileBytes, &vmap, &full[s], cb * 64, t * kWgBK, n);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint64_t qdesc = desc_sw128(qs + wg * kWgBK * kWgD, 16, 1024);

    float oacc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) oacc[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // rows g, g + 8

    float sacc[32], alpha[2];
    unsigned pa[4][4];

    // S = Q K^T of tile t into sacc: one committed group, in flight on return
    auto issue_qk = [&](int t) {
      const int s = t % kWgStages;
      mbar_wait(&full[s], (t / kWgStages) & 1);
      const uint64_t kdesc = desc_sw128(ring + s * kWgStageBytes, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < kWgD / 16; ++kk)  // 16 columns = 32 bytes a step
        wgmma_m64n64k16_ss(sacc, qdesc + 2 * kk, kdesc + 2 * kk, kk);
      wgmma_commit();
    };
    // the online softmax of tile t's scores, in place: sacc becomes P (f32),
    // m and l move on, alpha[h] is the factor that O's row h still owes
    auto softmax = [&](int t) {
      const int k0 = t * kWgBK;
      if (k0 + kWgBK > L) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + 2 * t4 + (e & 1) >= L) sacc[4 * j + e] = -INFINITY;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * h], sacc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // every tile holds at least one real key, so m_new is finite
        const float m_new = fmaxf(m_r[h], mx * kLog2e);  // running max, base-2 scale
        alpha[h] = exp2f(m_r[h] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            sacc[4 * j + e] = exp2f(fmaf(sacc[4 * j + e], kLog2e, -m_new));
            rs += sacc[4 * j + e];
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_r[h] = l_r[h] * alpha[h] + rs;
        m_r[h] = m_new;
      }
    };
    // P in bf16 as the A fragments of four k16 steps (keys 16 kk ..)
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = fmi_mma::pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = fmi_mma::pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = fmi_mma::pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = fmi_mma::pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          oacc[4 * j + 2 * h] *= alpha[h];
          oacc[4 * j + 2 * h + 1] *= alpha[h];
        }
    };
    auto issue_pv = [&](int t) {
      const uint64_t vdesc =
          desc_sw128(ring + (t % kWgStages) * kWgStageBytes + kWgTileBytes, kWgTileBytes, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n256k16_rs(oacc, pa[kk], vdesc + 128 * kk);
      wgmma_commit();
    };
    // Per tile: S, the softmax, then O += P V, each product waited for at
    // once. The two consumer warpgroups overlap one's softmax with the
    // other's products only as the warp schedulers interleave them:
    // schedules that issue the next tile's S ahead or take turns through
    // named barriers measured slower on the H100 (ptxas serialised their
    // wgmma, C7514 / C7520).
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      wgmma_fence();
      issue_qk(t);
      wgmma_wait<0>();
      pin(sacc);
      softmax(t);
      rescale();
      pack();
      wgmma_fence();
      issue_pv(t);
      wgmma_wait<0>();
      pin(oacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);
      mbar_arrive(&empty[t % kWgStages]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wg * 64 + warp * 16 + g + 8 * h;
      if (row >= L) continue;
      const float inv = 1.f / l_r[h];
      __nv_bfloat16* orow = o + ((size_t)n * L + row) * C;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int ch = j * 8 + 2 * t4;
        if (ch < C)
          *reinterpret_cast<__nv_bfloat162*>(&orow[ch]) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * h] * inv, oacc[4 * j + 2 * h + 1] * inv);
      }
      if (lse != nullptr && t4 == 0) lse[(size_t)n * L + row] = m_r[h] + log2f(l_r[h]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime so that the library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [N][L][width] bf16 as a 3-d map of [64 x 64] boxes with the 128-byte
// swizzle; out-of-range elements read as zeros
bool rows_map(CUtensorMap* map, const void* base, int N, int L, int width) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(width) * 2 * L};
  const cuuint32_t box[3] = {64, kWgBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* q, const void* v, void* o, void* lse, int N, int L, int C,
                 void* stream) {
  CUtensorMap qmap, vmap;
  if (!rows_map(&qmap, q, N, L, kWgD) || !rows_map(&vmap, v, N, L, C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kWgSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kWgBQ - 1) / kWgBQ, N);
  flash_fwd_wgmma_kernel<<<grid, kWgThreads, kWgSmem, static_cast<cudaStream_t>(stream)>>>(
      qmap, vmap, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), L, C);
  return static_cast<int>(cudaGetLastError());
}

// 2: the warpgroup kernel (bf16); 1: the split-precision kernel (f32); 0: the
// CUDA cores
int route(int bf16, const void* q, const void* v, const void* o, int N, int L, int d, int C) {
  const bool ok = N >= 1 && N <= 65535 && L >= 1 && C >= 8 && C % 8 == 0 && C <= kWgCMax &&
                  aligned16(q) && aligned16(v) && aligned16(o);
  if (ok && bf16 && d == kWgD) return 2;
  if (ok && !bf16 && (d == 32 || d == 64)) return 1;
  return 0;
}

}  // namespace

// q [N, L, d], v [N, L, C], o [N, L, C] (contiguous, same type), lse [N, L]
// f32 or null. Returns a cudaError_t code; 0 means launched. Each type takes
// the route fmi_flash_attention_fwd_route gives its shape and alignment.
extern "C" int fmi_flash_attention_fwd_f32(const void* q, const void* v, void* o,
                                           void* lse, int N, int L, int d, int C,
                                           void* stream) {
  if (route(0, q, v, o, N, L, d, C) != 1) return launch<float>(q, v, o, lse, N, L, d, C, stream);
  if (d == 64) return launch_tf32x3_d<64>(q, v, o, lse, N, L, C, stream);
  return launch_tf32x3_d<32>(q, v, o, lse, N, L, C, stream);
}

extern "C" int fmi_flash_attention_fwd_bf16(const void* q, const void* v, void* o,
                                            void* lse, int N, int L, int d, int C,
                                            void* stream) {
  if (route(1, q, v, o, N, L, d, C) == 2) return launch_wgmma(q, v, o, lse, N, L, C, stream);
  return launch<__nv_bfloat16>(q, v, o, lse, N, L, d, C, stream);
}

// Which K1 kernel takes a call with these pointers and shape: 2 the
// warpgroup (wgmma) kernel, 1 the split-precision (3xTF32) kernel, 0 the
// CUDA-core kernel. By type, shape and alignment only.
extern "C" int fmi_flash_attention_fwd_route(int bf16, const void* q, const void* v,
                                             const void* o, int N, int L, int d, int C) {
  return route(bf16, q, v, o, N, L, d, C);
}
