// Fused instance norm + activation (kernel K2).
//
// Replaces: face_mask_inpaint_tpu/ops/pallas/norm_act.py:135
// `instance_norm_act` -> `_forward` (`_stats_kernel`, pallas_call at :92;
// `_apply_kernel`, pallas_call at :116; and the finish between them, which
// the JAX package leaves to XLA).
//
// Computes, for x [N, C, H, W] contiguous of type T in {f32, bf16}, an
// optional affine weight, bias [C] (f32), an optional input bias ib [C]
// (f32: the bias of the conv that wrote x, which that conv leaves to this
// kernel) and act in {LeakyReLU(slope), ReLU, none}, per plane (n, c) of HW
// elements:
//     v = x + ib[c]                              in f32, as each element is
//                                                loaded (v = x without ib)
//     s1 = sum v, s2 = sum v^2                   in f32
//     mean = s1 / HW, var = max(s2 / HW - mean^2, 0), a = rsqrt(var + eps) weight
//     y = act(a (v - mean) + bias)               rounded once to T
// The variance is clamped at 0 as instance_norm_act_reference clamps it
// (norm_act.py:52; the Pallas `_forward` does not, :105-106). The affine is
// taken on x - mean rather than as a x + (bias - a mean): the same function,
// but a plane whose values all equal its mean gives act(bias) exactly, where
// a x + b would leave the rounding of a mean, up to rsqrt(eps) = 316 times
// the plane's size in ulps.
//
// What bounds it on an H100: per element it does a handful of f32
// operations and moves its bytes once each way, so bytes bound it: one read
// and one write of the map (0.891 ms for the flagship's ten decoder norms in
// bf16 at 3.35 TB/s). A kernel that reads the map twice, once for the sums
// and once to apply them, cannot go below 1.5 times that.
//
// Design, route "cluster" (every plane that a cluster of at most 8 blocks can
// hold in shared memory: all of the flagship's, config 5's and the f32
// CLI's): each plane is read once into shared memory, summed there, and
// normalised from there.
//   - A plane of up to 16 KB goes to a group of warps: a block of 8 warps
//     holds 8, 4, 2 or 1 such planes, so the 32^2 and 64^2 decoder planes do
//     not leave most of a block idle.
//   - A larger plane goes to a cluster of 1-8 blocks (launched with
//     cudaLaunchKernelEx and a cluster dimension); each block holds one
//     16-byte-aligned slice of at most 64 KB of it (128 KB for 512^2 in f32).
//   - A group loads its slice with one bulk copy (cp.async.bulk, completion
//     on an mbarrier) where the slice starts on a 16-byte boundary and is a
//     whole number of 16-byte pieces, else the aligned 16-byte pieces that
//     cover it with cp.async, keeping the slice's offset in the first piece.
//   - Each thread sums its pieces in a fixed order, the warps' sums meet by
//     shuffles and then in warp order. In a cluster, each block's two sums
//     are read by every block through distributed shared memory (mapa,
//     ld.shared::cluster) in rank order after a cluster barrier, so every
//     block finishes mean and a with the same bits; the sums are
//     deterministic. A second cluster barrier, waited on at the end, keeps
//     each block's shared memory alive until the others have read it.
//   - The activation is applied from shared memory and stored in 16-byte
//     pieces (element by element at a slice's ragged ends, or where x and y
//     do not lie alike modulo 16 bytes).
// The wrapper (kernels/norm_act.py `_plan`) chooses the group, cluster and
// slice sizes; the launcher checks them.
//
// Route "two_pass" (a plane no cluster holds, e.g. 1024^2 in bf16): one
// kernel writes f32 sums of 16K-element chunks; the second reads its plane's
// sums in chunk order, finishes mean and a itself and applies. Two launches
// and no host work between them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace fmi_mma;
using namespace fmi_wgmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 227 * 1024;  // shared memory a block may opt into
constexpr int kStatic = 1024;         // kept for the kernel's static shared memory

template <typename T>
struct Vec;  // elements of a 16-byte piece
template <>
struct Vec<float> {
  static constexpr int E = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// act: 0 LeakyReLU(slope), 1 ReLU, 2 none (kernels/norm_act.py ACTS)
template <int ACT>
__device__ __forceinline__ float activate(float v, float slope) {
  if (ACT == 0) return v >= 0.f ? v : v * slope;
  if (ACT == 1) return v >= 0.f ? v : 0.f;
  return v;
}

// The elements [first, first + len) of an array of T, as the aligned
// 16-byte pieces that cover them: piece j starts at base + 16 j, and the
// range starts `lead` elements into piece 0.
template <typename T>
struct Span {
  static constexpr int E = Vec<T>::E;
  uintptr_t base;
  int lead, len, pieces;

  __device__ __forceinline__ Span(const T* first, int n) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(first);
    base = a & ~static_cast<uintptr_t>(15);
    lead = static_cast<int>((a - base) / sizeof(T));
    len = n;
    pieces = (lead + len + E - 1) / E;
  }
  __device__ __forceinline__ bool full(int j) const {
    return j * E >= lead && j * E + E - lead <= len;
  }
  __device__ __forceinline__ bool holds(int j, int k) const {
    const int i = j * E + k - lead;
    return i >= 0 && i < len;
  }
};

// s1 += the piece's elements in the range, each plus `shift` (the input
// bias, 0 without one), s2 += their squares, in element order
template <typename T>
__device__ __forceinline__ void add_piece(const uint4& v, const Span<T>& sp, int j, float shift,
                                          float& s1, float& s2) {
  constexpr int E = Vec<T>::E;
  float f[E];
  unpack(v, f);
#pragma unroll
  for (int k = 0; k < E; ++k) f[k] += shift;
  if (sp.full(j)) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      s1 += f[k];
      s2 = fmaf(f[k], f[k], s2);
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (sp.holds(j, k)) {
        s1 += f[k];
        s2 = fmaf(f[k], f[k], s2);
      }
  }
}

// y = act(a (x + shift - mean) + beta) of the piece's elements in the range, stored
// at the same offsets from `dst` (the range's first output element) as the
// inputs lie from the range's first input; a whole piece goes out in one
// 16-byte store where x and y lie alike modulo 16 bytes (`vec`)
template <typename T, int ACT>
__device__ __forceinline__ void store_piece(const uint4& v, const Span<T>& sp, int j, T* dst,
                                            bool vec, float shift, float a, float mean,
                                            float beta, float slope) {
  constexpr int E = Vec<T>::E;
  float f[E];
  unpack(v, f);
#pragma unroll
  for (int k = 0; k < E; ++k) f[k] = activate<ACT>(fmaf(a, (f[k] + shift) - mean, beta), slope);
  if (vec && sp.full(j)) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(dst) - sp.lead * sizeof(T) + 16 * j;
    *reinterpret_cast<uint4*>(p) = pack(f);
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (sp.holds(j, k)) dst[j * E + k - sp.lead] = from_f<T>(f[k]);
  }
}

// shuffles over the warp: every lane ends with the same bits
__device__ __forceinline__ void warp_sum(float& s1, float& s2) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    s2 += __shfl_xor_sync(0xffffffffu, s2, m);
  }
}

// the sums of the gw warps of group g, added in warp order, in every thread
// of the block (red [2][kWarps] in shared memory; ends with a barrier passed)
__device__ __forceinline__ void group_sum(float& s1, float& s2, float (*red)[kWarps], int g,
                                          int gw) {
  warp_sum(s1, s2);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  s1 = 0.f;
  s2 = 0.f;
  for (int k = 0; k < gw; ++k) {
    s1 += red[0][g * gw + k];
    s2 += red[1][g * gw + k];
  }
}

// mean, a and beta of channel c from a plane's sums
__device__ __forceinline__ void finish(float s1, float s2, int hw, const float* __restrict__ w,
                                       const float* __restrict__ b, int c, float eps,
                                       float& mean, float& a, float& beta) {
  const float n = static_cast<float>(hw);
  mean = s1 / n;
  // E[x^2] - mean^2 with two roundings, as the plain version takes it
  const float var = fmaxf(__fsub_rn(s2 / n, __fmul_rn(mean, mean)), 0.f);
  const float r = rsqrtf(var + eps);
  a = w != nullptr ? r * w[c] : r;
  beta = w != nullptr ? b[c] : 0.f;
}

// Route "cluster": a block of 8 warps holds ppb planes (8 / ppb warps a
// plane), or, with ppb = 1, slice `rank` of one plane in a cluster of cs
// blocks (blockIdx.x = plane * cs + rank). Dynamic shared memory: ppb
// regions of cap bytes (kernels/norm_act.py `_plan`).
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
norm_act_cluster_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, const float* __restrict__ ib,
                        T* __restrict__ y, int planes, int C, int hw, int cs, int ppb, int slice,
                        float slope, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kWarps];
  __shared__ float red[2][kWarps];
  __shared__ float part[2];  // this block's sums, read by the cluster
  __shared__ float tot[2];
  const int tid = threadIdx.x;
  const int gw = kWarps / ppb, G = 32 * gw;
  const int g = (tid >> 5) / gw, gt = tid - g * G;
  const int rank = cs > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int plane = (blockIdx.x / cs) * ppb + g;
  const bool live = plane < planes;
  const int e0 = rank * slice;
  const int len = live ? min(hw - e0, slice) : 0;
  const size_t cap = ((static_cast<size_t>(slice) * sizeof(T) + 15) & ~static_cast<size_t>(15)) + 16;
  unsigned char* buf = smem + g * cap;
  const T* src = x + (live ? static_cast<size_t>(plane) * hw + e0 : 0);
  const Span<T> sp(src, len);
  const bool bulk = live && sp.lead == 0 && (len * sizeof(T)) % 16 == 0;
  const float shift = live && ib != nullptr ? ib[plane % C] : 0.f;

  if (tid < ppb) mbar_init(&bars[tid], 1);
  mbar_fence_init();
  __syncthreads();
  if (bulk) {
    if (gt == 0) {
      mbar_expect_tx(&bars[g], len * sizeof(T));
      bulk_load(buf, src, len * sizeof(T), &bars[g]);
    }
  } else if (live) {
    for (int j = gt; j < sp.pieces; j += G)
      cp_async16(buf + 16 * j, reinterpret_cast<const void*>(sp.base + 16 * j), 16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  if (bulk) mbar_wait(&bars[g], 0);
  __syncthreads();

  float s1 = 0.f, s2 = 0.f;
  if (live)
    for (int j = gt; j < sp.pieces; j += G)
      add_piece(*reinterpret_cast<const uint4*>(buf + 16 * j), sp, j, shift, s1, s2);
  group_sum(s1, s2, red, g, gw);
  if (cs > 1) {
    if (tid == 0) {
      part[0] = s1;
      part[1] = s2;
    }
    cluster_arrive();
    cluster_wait();  // every block's sums are written
    if (tid == 0) {
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < cs; ++r) {
        t1 += ld_cluster_f32(&part[0], r);
        t2 += ld_cluster_f32(&part[1], r);
      }
      tot[0] = t1;
      tot[1] = t2;
    }
    cluster_arrive();  // this block is done with the others' shared memory
    __syncthreads();
    s1 = tot[0];
    s2 = tot[1];
  }
  if (live) {
    float mean, a, beta;
    finish(s1, s2, hw, w, b, plane % C, eps, mean, a, beta);
    const bool vec =
        ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    T* dst = y + static_cast<size_t>(plane) * hw + e0;
    for (int j = gt; j < sp.pieces; j += G)
      store_piece<T, ACT>(*reinterpret_cast<const uint4*>(buf + 16 * j), sp, j, dst, vec, shift,
                          a, mean, beta, slope);
  }
  if (cs > 1) cluster_wait();  // no block leaves while another may read its sums
}

// Route "two_pass", first kernel: the f32 sums of chunk k of plane p to
// parts[p * chunks + k][2] (blockIdx.x = p * chunks + k)
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_act_sums_kernel(const T* __restrict__ x, const float* __restrict__ ib,
                     float* __restrict__ parts, int C, int hw, int chunks, int chunk) {
  __shared__ float red[2][kWarps];
  const int plane = blockIdx.x / chunks, k = blockIdx.x - plane * chunks;
  const int e0 = k * chunk;
  const Span<T> sp(x + static_cast<size_t>(plane) * hw + e0, min(hw - e0, chunk));
  const float shift = ib != nullptr ? ib[plane % C] : 0.f;
  float s1 = 0.f, s2 = 0.f;
  for (int j = threadIdx.x; j < sp.pieces; j += kThreads)
    add_piece(__ldg(reinterpret_cast<const uint4*>(sp.base + 16 * j)), sp, j, shift, s1, s2);
  group_sum(s1, s2, red, 0, kWarps);
  if (threadIdx.x == 0) {
    parts[2 * static_cast<size_t>(blockIdx.x)] = s1;
    parts[2 * static_cast<size_t>(blockIdx.x) + 1] = s2;
  }
}

// Route "two_pass", second kernel: the plane's sums in chunk order, the
// finish, and the activation of chunk k
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
norm_act_scale_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, const float* __restrict__ ib,
                      const float* __restrict__ parts, T* __restrict__ y, int C, int hw,
                      int chunks, int chunk, float slope, float eps) {
  __shared__ float tot[2];
  const int plane = blockIdx.x / chunks, k = blockIdx.x - plane * chunks;
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    const float* pp = parts + 2 * static_cast<size_t>(plane) * chunks;
    for (int i = 0; i < chunks; ++i) {
      t1 += pp[2 * i];
      t2 += pp[2 * i + 1];
    }
    tot[0] = t1;
    tot[1] = t2;
  }
  __syncthreads();
  float mean, a, beta;
  finish(tot[0], tot[1], hw, w, b, plane % C, eps, mean, a, beta);
  const int e0 = k * chunk;
  const size_t off = static_cast<size_t>(plane) * hw + e0;
  const Span<T> sp(x + off, min(hw - e0, chunk));
  const bool vec = ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const float shift = ib != nullptr ? ib[plane % C] : 0.f;
  for (int j = threadIdx.x; j < sp.pieces; j += kThreads)
    store_piece<T, ACT>(__ldg(reinterpret_cast<const uint4*>(sp.base + 16 * j)), sp, j, y + off,
                        vec, shift, a, mean, beta, slope);
}

// the route's shared memory a block: ppb regions of one slice each
size_t cluster_smem(int slice, int ppb, size_t es) {
  return ppb * (((static_cast<size_t>(slice) * es + 15) & ~static_cast<size_t>(15)) + 16);
}

template <typename T, int ACT>
int launch_act(const T* x, const float* w, const float* b, const float* ib, T* y, float* parts,
               int planes, int C, int hw, int route, int cs, int ppb, int slice, float slope,
               float eps, cudaStream_t stream) {
  if (route == 0) {
    const size_t smem = cluster_smem(slice, ppb, sizeof(T));
    const int blocks = (planes + ppb - 1) / ppb;
    if (static_cast<long long>(blocks) * cs > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    auto kernel = norm_act_cluster_kernel<T, ACT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks * cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(
        cudaLaunchKernelEx(&cfg, kernel, x, w, b, ib, y, planes, C, hw, cs, ppb, slice, slope,
                           eps));
  }
  const int chunks = cs, chunk = slice;
  if (static_cast<long long>(planes) * chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  norm_act_sums_kernel<T><<<planes * chunks, kThreads, 0, stream>>>(x, ib, parts, C, hw, chunks,
                                                                    chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_act_scale_kernel<T, ACT><<<planes * chunks, kThreads, 0, stream>>>(
      x, w, b, ib, parts, y, C, hw, chunks, chunk, slope, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* b, const void* ib, void* y, void* parts,
           int planes, int C, int hw, int route, int cs, int ppb, int slice, int act, float slope,
           float eps, void* stream) {
  const long long covered = static_cast<long long>(slice) * cs;
  bool ok = planes >= 1 && C >= 1 && planes % C == 0 && hw >= 1 && slice >= 1 && cs >= 1 &&
            covered >= hw && covered - slice < hw && (w == nullptr) == (b == nullptr);
  if (route == 0)
    ok = ok && (ppb == 1 || ppb == 2 || ppb == 4 || ppb == 8) && cs <= 8 &&
         (ppb == 1 || cs == 1) &&
         cluster_smem(slice, ppb, sizeof(T)) + kStatic <= static_cast<size_t>(kSmemMax);
  else
    ok = ok && route == 1 && parts != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const float* ibp = static_cast<const float*>(ib);
  T* yp = static_cast<T*>(y);
  float* pp = static_cast<float*>(parts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0:
      return launch_act<T, 0>(xp, wp, bp, ibp, yp, pp, planes, C, hw, route, cs, ppb, slice,
                              slope, eps, st);
    case 1:
      return launch_act<T, 1>(xp, wp, bp, ibp, yp, pp, planes, C, hw, route, cs, ppb, slice,
                              slope, eps, st);
    case 2:
      return launch_act<T, 2>(xp, wp, bp, ibp, yp, pp, planes, C, hw, route, cs, ppb, slice,
                              slope, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y [planes, hw] contiguous of one type (planes = N C); w, b [C] f32, or
// both null for no affine; ib [C] f32 added to x as it is loaded, or null;
// parts f32 [planes, cs, 2] scratch for route 1.
// route 0 "cluster": cs blocks a cluster, ppb planes a block, slices of
// `slice` elements; route 1 "two_pass": cs chunks of `slice` elements a
// plane. act: 0 LeakyReLU(slope), 1 ReLU, 2 none. Returns a cudaError_t
// code; 0 means launched.
extern "C" int fmi_norm_act_f32(const void* x, const void* w, const void* b, const void* ib,
                                void* y, void* parts, int planes, int C, int hw, int route,
                                int cs, int ppb, int slice, int act, float slope, float eps,
                                void* stream) {
  return launch<float>(x, w, b, ib, y, parts, planes, C, hw, route, cs, ppb, slice, act, slope,
                       eps, stream);
}

extern "C" int fmi_norm_act_bf16(const void* x, const void* w, const void* b, const void* ib,
                                 void* y, void* parts, int planes, int C, int hw, int route,
                                 int cs, int ppb, int slice, int act, float slope, float eps,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, w, b, ib, y, parts, planes, C, hw, route, cs, ppb, slice, act,
                               slope, eps, stream);
}
