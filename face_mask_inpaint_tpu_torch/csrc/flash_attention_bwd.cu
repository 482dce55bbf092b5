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
// S is symmetric (q == k), so both roles of a pair are read from one score
// tile: P[c, r] = exp2(log2(e) * S[r, c] - lse_c). Each block owns a tile of
// rows and sweeps all column tiles; dq's two roles are summed in f32 in
// registers and rounded once, so no atomics and no second pass are needed and
// the result is deterministic. P and the summed dS are rounded to the input
// type before their products, with f32 accumulation, as the TPU kernels round
// them.
//
// What bounds it on an H100: at the flagship (N = 16, L = 16384, d = 64,
// C = 256, bf16) the function needs 2 N L^2 (1.5 d + 2 C) ~ 5.2 TFLOP against
// ~0.65 GB of inputs and outputs, so it is compute-bound: the products must
// run on the tensor cores and the [L, L] maps must stay on chip.
//
// Design (simple first; the triangular sweep, wgmma and TMA are later work):
// two kernels per call, each a variant of K1's loop.
// - dq: one block per (64-row tile, sample) holds q_r, dO_r and v_r in shared
//   memory and, per 64-column tile, computes S, both dP tiles (dO_r v_c^T and
//   v_r dO_c^T, contracted over all C), the summed dS, and dq += dS q_c.
// - dv: one block per (64-row tile, 128-channel chunk, sample) computes S and
//   P[c, r] per column tile and dv += P^T dO_c, K1's loop with a fixed lse.
// bf16 with d in {32, 64, 128} and C % 8 == 0 takes mma.sync m16n8k16
// (bf16 in, f32 accumulate) with cp.async loads; everything else (f32, other
// d or C) runs on the CUDA cores in f32. Ragged L is masked: columns past L
// have P = 0, rows past L are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBR = 64;            // rows per block
constexpr int kBC = 64;            // columns per tile
constexpr int kCC = 128;           // dv channels per block
constexpr int kCK = 32;            // dP channels per chunk (CUDA-core dq)
constexpr int kPStride = kBC + 4;  // padded rows of the P / dS tile
constexpr int kThreads = 256;
constexpr int kDMax = 128;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use
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
// Tensor-core path for bf16 (d in {32, 64, 128}, C % 8 == 0, 16-byte aligned
// rows). Four warps per block; each owns 16 of the 64 rows. Fragments follow
// K1's mma.sync m16n8k16 layout; shared-memory rows are padded by 16 bytes so
// ldmatrix reads are free of bank conflicts.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

// rows [row0, row0 + kBR) of a [L, width] bf16 matrix into smem rows of
// `stride` elements, channels padded to `wpad` (a multiple of 16); rows past L
// and channels past `width` are zero-filled from a clamped, valid address
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int L, int width, int wpad,
                                          int stride, int tid) {
  const int per_row = wpad / 8;
  for (int i = tid; i < kBR * per_row; i += kMmaThreads) {
    const int r = i / per_row, c = (i % per_row) * 8, row = row0 + r;
    const bool ok = row < L && c < width;
    cp_async16(&dst[r * stride + c], src + (size_t)min(row, L - 1) * width + (ok ? c : 0),
               ok ? 16 : 0);
  }
}

template <int D>
struct DqPlan {
  static constexpr int kQS = D + 8;  // padded row stride of q tiles, in bf16
  static size_t smem(int cs) {
    return sizeof(__nv_bfloat16) * (size_t)(2 * kBR * kQS + 4 * kBR * cs) +
           sizeof(float) * 2 * kBC;
  }
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dq, int L, int C, int cpad) {
  constexpr int QS = DqPlan<D>::kQS;
  const int cs = cpad + 8;  // padded row stride of the value tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qr = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBR][QS]
  __nv_bfloat16* qc = qr + kBR * QS;                                // [kBC][QS]
  __nv_bfloat16* dor = qc + kBC * QS;                               // [kBR][cs]
  __nv_bfloat16* vr = dor + kBR * cs;                               // [kBR][cs]
  __nv_bfloat16* vc = vr + kBR * cs;                                // [kBC][cs]
  __nv_bfloat16* doc = vc + kBC * cs;                               // [kBC][cs]
  float* lsec = reinterpret_cast<float*>(doc + kBC * cs);           // [kBC]
  float* dcol = lsec + kBC;                                         // [kBC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;    // mma fragment row group / column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const int r0 = blockIdx.x * kBR, n = blockIdx.y;
  const __nv_bfloat16* qn = q + (size_t)n * L * D;
  const __nv_bfloat16* vn = v + (size_t)n * L * C;
  const __nv_bfloat16* don = dout + (size_t)n * L * C;
  const float* lsen = lse + (size_t)n * L;
  const float* dn = dsum + (size_t)n * L;

  load_rows(qr, qn, r0, L, D, D, QS, tid);
  load_rows(dor, don, r0, L, C, cpad, cs, tid);
  load_rows(vr, vn, r0, L, C, cpad, cs, tid);
  cp_async_commit();
  float lse_r[2], d_r[2];  // rows g and g + 8 of this warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    lse_r[h] = row < L ? lsen[row] : 0.f;
    d_r[h] = row < L ? dn[row] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  unsigned qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], &qr[(warp * 16 + (lm & 1) * 8 + lr) * QS + kk * 16 + (lm >> 1) * 8]);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = (L + kBC - 1) / kBC;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * kBC;
    load_rows(qc, qn, c0, L, D, D, QS, tid);
    load_rows(vc, vn, c0, L, C, cpad, cs, tid);
    load_rows(doc, don, c0, L, C, cpad, cs, tid);
    cp_async_commit();
    if (tid < kBC) {
      lsec[tid] = c0 + tid < L ? lsen[c0 + tid] : 0.f;
      dcol[tid] = c0 + tid < L ? dn[c0 + tid] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float s[kBC / 8][4], p1[kBC / 8][4], p2[kBC / 8][4];
#pragma unroll
    for (int j = 0; j < kBC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = p1[j][e] = p2[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kBC / 16; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, &qc[(jp * 16 + (lm >> 1) * 8 + lr) * QS + kk * 16 + (lm & 1) * 8]);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }
    // dP[r, c] = dO_r . v_c and dP[c, r] = v_r . dO_c, over all channels
    for (int kk = 0; kk < cpad / 16; ++kk) {
      unsigned a[4];
      const int arow = (warp * 16 + (lm & 1) * 8 + lr) * cs + kk * 16 + (lm >> 1) * 8;
      ldmatrix_x4(a, &dor[arow]);
#pragma unroll
      for (int jp = 0; jp < kBC / 16; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, &vc[(jp * 16 + (lm >> 1) * 8 + lr) * cs + kk * 16 + (lm & 1) * 8]);
        mma_bf16(p1[2 * jp], a, b[0], b[1]);
        mma_bf16(p1[2 * jp + 1], a, b[2], b[3]);
      }
      ldmatrix_x4(a, &vr[arow]);
#pragma unroll
      for (int jp = 0; jp < kBC / 16; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, &doc[(jp * 16 + (lm >> 1) * 8 + lr) * cs + kk * 16 + (lm & 1) * 8]);
        mma_bf16(p2[2 * jp], a, b[0], b[1]);
        mma_bf16(p2[2 * jp + 1], a, b[2], b[3]);
      }
    }

    // summed dS of both roles, in f32 (held in s)
#pragma unroll
    for (int j = 0; j < kBC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1), h = e >> 1;
        float m = 0.f;
        if (c0 + col < L) {
          const float s2 = s[j][e] * kLog2e;
          m = exp2f(s2 - lse_r[h]) * (p1[j][e] - d_r[h]) +
              exp2f(s2 - lsec[col]) * (p2[j][e] - dcol[col]);
        }
        s[j][e] = m;
      }
    // dq += dS q_c, dS rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, &qc[(kk * 16 + (lm & 1) * 8 + lr) * QS + np * 16 +
                                 (lm >> 1) * 8]);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next tile overwrites qc, vc, doc, lsec and dcol
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= L) continue;
    __nv_bfloat16* orow = dq + ((size_t)n * L + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&orow[j * 8 + 2 * t]) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int D>
struct DvPlan {
  static constexpr int kQS = D + 8;
  static constexpr int kOS = kCC + 8;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (size_t)(kBR * kQS + 2 * kBC * kQS + 2 * kBC * kOS) +
      sizeof(float) * 2 * kBC;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, __nv_bfloat16* __restrict__ dv,
                        int L, int C) {
  using P = DvPlan<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBR][kQS]
  __nv_bfloat16* ks = qs + kBR * P::kQS;                           // [2][kBC][kQS]
  __nv_bfloat16* os = ks + 2 * kBC * P::kQS;                       // [2][kBC][kOS]
  float* lsec = reinterpret_cast<float*>(os + 2 * kBC * P::kOS);   // [2][kBC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int r0 = blockIdx.x * kBR;
  const int ch0 = blockIdx.y * kCC;
  const int cw = min(kCC, C - ch0);  // a multiple of 8
  const int n = blockIdx.z;
  const __nv_bfloat16* qn = q + (size_t)n * L * D;
  const __nv_bfloat16* don = dout + (size_t)n * L * C;
  const float* lsen = lse + (size_t)n * L;

  load_rows(qs, qn, r0, L, D, D, P::kQS, tid);
  auto load_tile = [&](int tile, int buf) {
    const int c0 = tile * kBC;
    load_rows(ks + buf * kBC * P::kQS, qn, c0, L, D, D, P::kQS, tid);
    __nv_bfloat16* ob = os + buf * kBC * P::kOS;
    for (int i = tid; i < kBC * kCC / 8; i += kMmaThreads) {
      const int r = i / (kCC / 8), c = (i % (kCC / 8)) * 8, key = c0 + r;
      const bool ok = key < L && c < cw;  // masked keys and channels read as 0
      cp_async16(&ob[r * P::kOS + c], don + (size_t)min(key, L - 1) * C + ch0 + (ok ? c : 0),
                 ok ? 16 : 0);
    }
    // the buffer written here was last read before the previous iteration's
    // closing barrier
    if (tid < kBC) lsec[buf * kBC + tid] = c0 + tid < L ? lsen[c0 + tid] : 0.f;
  };
  load_tile(0, 0);
  cp_async_commit();

  unsigned qf[D / 16][4];
  float acc[kCC / 8][4];
#pragma unroll
  for (int j = 0; j < kCC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = (L + kBC - 1) / kBC;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // everything but the tile just requested has landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], &qs[(warp * 16 + (lm & 1) * 8 + lr) * P::kQS + kk * 16 +
                                (lm >> 1) * 8]);
    }
    const __nv_bfloat16* kb = ks + buf * kBC * P::kQS;
    const __nv_bfloat16* ob = os + buf * kBC * P::kOS;
    const float* lb = lsec + buf * kBC;

    float s[kBC / 8][4];
#pragma unroll
    for (int j = 0; j < kBC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kBC / 16; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, &kb[(jp * 16 + (lm >> 1) * 8 + lr) * P::kQS + kk * 16 + (lm & 1) * 8]);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }
    const int c0 = tile * kBC;
#pragma unroll
    for (int j = 0; j < kBC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        s[j][e] = c0 + col < L ? exp2f(fmaf(s[j][e], kLog2e, -lb[col])) : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kCC / 16; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, &ob[(kk * 16 + (lm & 1) * 8 + lr) * P::kOS + np * 16 +
                                 (lm >> 1) * 8]);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration refills the buffer read here
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= L) continue;
    __nv_bfloat16* orow = dv + ((size_t)n * L + row) * C + ch0;
#pragma unroll
    for (int j = 0; j < kCC / 8; ++j) {
      const int ch = j * 8 + 2 * t;
      if (ch < cw)
        *reinterpret_cast<__nv_bfloat162*>(&orow[ch]) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

template <int D>
bool mma_fits(int C) {
  const int cpad = (C + 15) / 16 * 16;
  return DqPlan<D>::smem(cpad + 8) <= (size_t)kMaxSmem;
}

template <int D>
int launch_mma(const void* q, const void* v, const void* dout, const void* lse,
               const void* dsum, void* dq, void* dv, int N, int L, int C,
               cudaStream_t stream) {
  const int cpad = (C + 15) / 16 * 16;
  const size_t smem_dq = DqPlan<D>::smem(cpad + 8);
  const size_t smem_dv = DvPlan<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L + kBR - 1) / kBR;
  using B = __nv_bfloat16;
  flash_bwd_dq_mma_kernel<D><<<dim3(tiles, N), kMmaThreads, smem_dq, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(v), static_cast<const B*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<B*>(dq),
      L, C, cpad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dv_mma_kernel<D><<<dim3(tiles, (C + kCC - 1) / kCC, N), kMmaThreads, smem_dv,
                               stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(dout), static_cast<const float*>(lse),
      static_cast<B*>(dv), L, C);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

bool shape_ok(int N, int L, int d, int C) {
  return N >= 1 && N <= 65535 && L >= 1 && d >= 1 && d <= kDMax && C >= 1;
}

}  // namespace

// q [N, L, d], v and dout [N, L, C], lse and dsum [N, L] f32, dq [N, L, d]
// and dv [N, L, C] outputs (contiguous; q, v, dout, dq, dv of one type).
// Returns a cudaError_t code; 0 means both kernels launched.
extern "C" int fmi_flash_attention_bwd_f32(const void* q, const void* v, const void* dout,
                                           const void* lse, const void* dsum, void* dq,
                                           void* dv, int N, int L, int d, int C,
                                           void* stream) {
  if (!shape_ok(N, L, d, C)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(q, v, dout, lse, dsum, dq, dv, N, L, d, C,
                       static_cast<cudaStream_t>(stream));
}

// bf16 takes the tensor-core path where its shape, alignment and shared
// memory allow (the flagship always does), and the CUDA-core path otherwise.
extern "C" int fmi_flash_attention_bwd_bf16(const void* q, const void* v, const void* dout,
                                            const void* lse, const void* dsum, void* dq,
                                            void* dv, int N, int L, int d, int C,
                                            void* stream) {
  if (!shape_ok(N, L, d, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = C % 8 == 0 && aligned16(q) && aligned16(v) && aligned16(dout) &&
                   aligned16(dq) && aligned16(dv);
  if (mma && d == 64 && mma_fits<64>(C))
    return launch_mma<64>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
  if (mma && d == 32 && mma_fits<32>(C))
    return launch_mma<32>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
  if (mma && d == 128 && mma_fits<128>(C))
    return launch_mma<128>(q, v, dout, lse, dsum, dq, dv, N, L, C, s);
  return launch<__nv_bfloat16>(q, v, dout, lse, dsum, dq, dv, N, L, d, C, s);
}
