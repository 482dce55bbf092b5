// The StyleGAN2 activation: bias, LeakyReLU and gain in one pass (kernel K7a).
//
// Replaces: face_mask_inpaint_tpu/ops/pallas/fused_act_pallas.py:55
// `fused_leaky_relu_pallas` (pallas_call in `_run_fwd` at :40, body
// `_fwd_kernel`).
//
// Computes, for x [P, hw] contiguous (P = N * C planes of an [N, C, ...] map;
// hw = 1 for [N, C] rows) of one dtype T in {f32, bf16}, and a bias of C
// values in its own dtype (f32 or bf16) or none:
//     v = x + bias[plane % C],   y = (v >= 0 ? v : v * slope) * scale
// in f32, rounded once to T. The add and both multiplies are rounded to
// nearest one by one (__fadd_rn, __fmul_rn: nothing contracts into a fused
// multiply-add), in the order of the plain version (kernels/fused_act.py
// `fused_leaky_relu_plain`), so both give the same values bit for bit.
// Without a bias nothing is added (-0 stays -0).
//
// What bounds it on an H100: one read and one write of each element and four
// operations, so device memory's 3.35 TB/s bounds it by far: the 17 calls of
// a config-4 forward (bf16, batch 16) move 8.410 GB, 2.510 ms.
//
// Design:
//   - 16-byte accesses: a thread moves vectors of 8 bf16 or 4 f32 values,
//     neighbouring threads neighbouring vectors, and issues its kUnroll loads
//     before its first store, so that each SM keeps tens of kilobytes of
//     loads in flight to cover the memory's latency;
//   - two routes, by the plane's size (fmi_fused_act_route; kernels/
//     fused_act.py `_plan` mirrors it):
//       "plane" (hw >= 256): a block takes a chunk of one plane. It finds
//           its plane with one division and reads the plane's bias once;
//           its elements need no division. A plane smaller than a chunk
//           gets a block of as many warps as its vectors fill
//           (fmi_fused_act_threads), so that 16^2 and 32^2 planes do not
//           leave most of a block idle;
//       "flat" (hw < 256: 4^2 and 8^2 maps, [N, C] rows): blocks take the
//           flat tensor in chunks; each vector finds the channel of its
//           first element with one division and steps through the planes
//           its elements cross;
//   - where x and y lie at one offset from a 16-byte boundary, a chunk runs
//     a head of single elements up to its first boundary, its vectors, and
//     a tail of single elements, so a plane of any size and a map at any
//     offset keep the vectors; where they do not (x a view one element off
//     its allocation), the block takes its chunk element by element,
//     neighbouring threads on neighbouring elements, in the same launch;
//   - 64-bit offsets throughout.
// What it reaches against the bound is in PERF.md (chip_smoke.py phase 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;          // threads of a block, at most
constexpr int kUnroll = 4;             // vectors a thread loads before its first store
constexpr long long kFlatBelow = 256;  // planes of fewer elements take the flat route

}  // namespace

// 0 for the plane route, 1 for the flat route, for planes of hw elements
extern "C" int fmi_fused_act_route(long long hw) { return hw < kFlatBelow ? 1 : 0; }

// The threads of a block for planes of hw elements of itemsize bytes: the
// flat route's kThreads; on the plane route the warps that the plane's
// 16-byte vectors fill, at most kThreads.
extern "C" int fmi_fused_act_threads(long long hw, int itemsize) {
  if (hw < kFlatBelow) return kThreads;
  const long long per_warp = 32LL * (16 / itemsize);
  const long long threads = (hw + per_warp - 1) / per_warp * 32;
  return threads < kThreads ? static_cast<int>(threads) : kThreads;
}

namespace {

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

template <bool HAS_BIAS>
__device__ __forceinline__ float act(float v, float b, float slope, float scale) {
  if (HAS_BIAS) v = __fadd_rn(v, b);
  return __fmul_rn(v >= 0.f ? v : __fmul_rn(v, slope), scale);
}

// the plane route's bias: one value for the whole chunk (0 and unused
// without a bias)
struct OneBias {
  float b;
  __device__ __forceinline__ float at(long long) const { return b; }
  template <int V>
  __device__ __forceinline__ void run(long long, float (&o)[V]) const {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = b;
  }
};

// the flat route's bias: element i's channel is (i / hw) % C
template <typename B>
struct FlatBias {
  const B* __restrict__ bias;
  long long hw;
  int C;
  __device__ __forceinline__ float at(long long i) const { return to_f(bias[i / hw % C]); }
  // the biases of the V elements from i: one division, then a step an element
  template <int V>
  __device__ __forceinline__ void run(long long i, float (&o)[V]) const {
    const long long q = i / hw;
    long long r = i - q * hw;
    int c = static_cast<int>(q % C);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o[j] = to_f(bias[c]);
      if (++r == hw) {
        r = 0;
        if (++c == C) c = 0;
      }
    }
  }
};

// Elements [begin, end) of x and y by one block, end - begin at most
// blockDim.x * kUnroll * V. With x and y `mis` elements past a 16-byte
// boundary (mis >= 0): single elements up to the chunk's first boundary,
// then the vectors (thread t takes vectors t, t + blockDim.x, ..., all its
// loads before its stores), then the single elements after the last whole
// vector. With mis < 0 (x and y at different offsets): single elements only.
template <typename T, bool HAS_BIAS, typename Bias>
__device__ __forceinline__ void run_chunk(const T* __restrict__ x, T* __restrict__ y,
                                          long long begin, long long end, int mis,
                                          const Bias& bias, float slope, float scale) {
  constexpr int V = 16 / sizeof(T);
  const int t = threadIdx.x;
  const long long nt = blockDim.x;
  if (mis < 0) {
#pragma unroll
    for (int s = 0; s < kUnroll * V; ++s) {
      const long long i = begin + s * nt + t;
      if (i < end) y[i] = from_f<T>(act<HAS_BIAS>(to_f(x[i]), bias.at(i), slope, scale));
    }
    return;
  }
  const long long a0 = min(end, begin + (V - (mis + begin) % V) % V);
  if (t < a0 - begin) {
    const long long i = begin + t;
    y[i] = from_f<T>(act<HAS_BIAS>(to_f(x[i]), bias.at(i), slope, scale));
  }
  const long long nv = (end - a0) / V;
  uint4 r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long k = u * nt + t;
    if (k < nv) r[u] = __ldg(reinterpret_cast<const uint4*>(x + a0 + k * V));
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long k = u * nt + t;
    if (k < nv) {
      const long long i = a0 + k * V;
      float b[V];
      bias.run(i, b);
      const T* e = reinterpret_cast<const T*>(&r[u]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < V; ++j) oe[j] = from_f<T>(act<HAS_BIAS>(to_f(e[j]), b[j], slope, scale));
      *reinterpret_cast<uint4*>(y + i) = o;
    }
  }
  const long long tail = a0 + nv * V;
  if (t < end - tail) {
    const long long i = tail + t;
    y[i] = from_f<T>(act<HAS_BIAS>(to_f(x[i]), bias.at(i), slope, scale));
  }
}

// The plane route: `parts` blocks a plane, block b taking chunk b % parts of
// plane b / parts.
template <typename T, typename B, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
fused_lrelu_plane_kernel(const T* __restrict__ x, const B* __restrict__ bias, T* __restrict__ y,
                         long long hw, int C, unsigned parts, int mis, float slope,
                         float scale) {
  constexpr int V = 16 / sizeof(T);
  const unsigned plane = blockIdx.x / parts;  // the block's one division
  const long long chunk = static_cast<long long>(blockDim.x) * kUnroll * V;
  const long long first = static_cast<long long>(blockIdx.x - plane * parts) * chunk;
  const long long base = static_cast<long long>(plane) * hw;
  const OneBias b{HAS_BIAS ? to_f(bias[plane % static_cast<unsigned>(C)]) : 0.f};
  run_chunk<T, HAS_BIAS>(x, y, base + first, base + min(hw, first + chunk), mis, b, slope,
                         scale);
}

// The flat route: block b takes elements [b * chunk, (b + 1) * chunk) of all.
template <typename T, typename B, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
fused_lrelu_flat_kernel(const T* __restrict__ x, const B* __restrict__ bias, T* __restrict__ y,
                        long long total, long long hw, int C, int mis, float slope,
                        float scale) {
  constexpr int V = 16 / sizeof(T);
  const long long chunk = static_cast<long long>(blockDim.x) * kUnroll * V;
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(total, begin + chunk);
  if (HAS_BIAS)
    run_chunk<T, true>(x, y, begin, end, mis, FlatBias<B>{bias, hw, C}, slope, scale);
  else
    run_chunk<T, false>(x, y, begin, end, mis, OneBias{0.f}, slope, scale);
}

template <typename T, typename B, bool HAS_BIAS>
int launch_route(const T* x, const B* bias, T* y, long long planes, long long hw, int C,
                 float slope, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int mx = static_cast<int>(reinterpret_cast<uintptr_t>(x) % 16 / sizeof(T));
  const int my = static_cast<int>(reinterpret_cast<uintptr_t>(y) % 16 / sizeof(T));
  const int mis = mx == my ? mx : -1;
  const int threads = fmi_fused_act_threads(hw, sizeof(T));
  const long long chunk = static_cast<long long>(threads) * kUnroll * V;
  if (fmi_fused_act_route(hw) == 0) {
    const long long parts = (hw + chunk - 1) / chunk;
    if (planes > 0x7fffffffLL / parts) return static_cast<int>(cudaErrorInvalidConfiguration);
    fused_lrelu_plane_kernel<T, B, HAS_BIAS>
        <<<static_cast<unsigned>(planes * parts), threads, 0, stream>>>(
            x, bias, y, hw, C, static_cast<unsigned>(parts), mis, slope, scale);
  } else {
    const long long total = planes * hw;
    const long long blocks = (total + chunk - 1) / chunk;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    fused_lrelu_flat_kernel<T, B, HAS_BIAS><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        x, bias, y, total, hw, C, mis, slope, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <typename T>
int launch(const void* x, const void* bias, int bias_bf16, void* y, long long planes,
           long long hw, int C, float slope, float scale, void* stream) {
  const size_t bsize = bias_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if (planes < 1 || hw < 1 || C < 1 || planes % C != 0 || planes > 0x7fffffffffffffffLL / hw ||
      !aligned(x, sizeof(T)) || !aligned(y, sizeof(T)) || (bias && !aligned(bias, bsize)))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias == nullptr)
    return launch_route<T, T, false>(xp, nullptr, yp, planes, hw, C, slope, scale, st);
  if (bias_bf16)
    return launch_route<T, __nv_bfloat16, true>(
        xp, static_cast<const __nv_bfloat16*>(bias), yp, planes, hw, C, slope, scale, st);
  return launch_route<T, float, true>(xp, static_cast<const float*>(bias), yp, planes, hw, C,
                                      slope, scale, st);
}

}  // namespace

// x and y [planes, hw] contiguous, both of one type, planes = N * C; bias:
// C values, bf16 when bias_bf16 is non-zero, else f32, or null for none.
// Returns a cudaError_t code; 0 means launched.
extern "C" int fmi_fused_leaky_relu_f32(const void* x, const void* bias, int bias_bf16, void* y,
                                        long long planes, long long hw, int C, float slope,
                                        float scale, void* stream) {
  return launch<float>(x, bias, bias_bf16, y, planes, hw, C, slope, scale, stream);
}

extern "C" int fmi_fused_leaky_relu_bf16(const void* x, const void* bias, int bias_bf16,
                                         void* y, long long planes, long long hw, int C,
                                         float slope, float scale, void* stream) {
  return launch<__nv_bfloat16>(x, bias, bias_bf16, y, planes, hw, C, slope, scale, stream);
}
