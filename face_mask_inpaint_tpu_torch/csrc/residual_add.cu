// The decoder block's residual sum with its convs' biases, in one pass.
//
// Replaces no TPU kernel: the JAX package leaves ResBlockDecoder's
// `h + bypass(x)` and its convs' bias adds to XLA, which fuses them into the
// convolutions. On the card cuDNN runs a biased convolution as the
// convolution and then a separate ATen pass that adds the bias over the NCHW
// map, a broadcast that takes the generic, unvectorised elementwise kernel;
// with conv2 and bypass each adding its own bias, the block's sum was three
// passes over maps the size of its output. Here the two convs run without
// their biases and this kernel adds their sum, and the pair, in one pass.
//
// Computes, for h, s [P, hw] contiguous (P = N * C planes of an NCHW map) of
// one dtype T in {f32, bf16} and a bias b of C f32 values (the two convs'
// biases, summed in f32 by the caller):
//     y = (h + s) + b[plane % C]
// in f32, each add rounded to nearest (__fadd_rn: nothing is reassociated),
// and rounded once to T; or the same sum with s channels-last ([N, hw, C]: a
// conv whose input was channels-last writes its output so) and h and y NCHW.
// The adds come in the order of the plain version
// (kernels/residual_add.py `residual_bias_add_plain`), so both give the same
// values bit for bit.
//
// What bounds it on an H100: two reads and one write of each element and
// three adds, so device memory's 3.35 TB/s bounds it by far: the flagship's
// four calls a forward (bf16, batch 128) move 3 x 7.78 GB, 6.97 ms.
//
// Design, the plan of K7a (csrc/fused_act.cu), with one more input:
//   - 16-byte accesses: a thread moves vectors of 8 bf16 or 4 f32 values,
//     neighbouring threads neighbouring vectors, and issues the loads of its
//     kUnroll vectors of h and of s before its first store;
//   - NCHW maps take one of two routes, by the plane's size
//     (fmi_residual_add_route; kernels/residual_add.py `_plan` mirrors it):
//       "plane" (hw >= 256): a block takes a chunk of one plane. It finds
//           its plane with one division and reads the plane's bias once;
//           a plane smaller than a chunk gets a block of as many warps as
//           its vectors fill (fmi_residual_add_threads);
//       "flat" (hw < 256): blocks take the flat tensors in chunks; each
//           vector finds the channel of its first element with one division
//           and steps through the planes its elements cross (the wrapper
//           also sends h and s that are both channels-last here, as hw = 1);
//   - route "transpose" (s channels-last, h and y NCHW): a block takes a
//     tile of 32 channels x 64 pixels of one image. It reads s's tile, each
//     pixel's 32 channels a run, in 16-byte vectors into shared memory (f32,
//     rows of 65, so that the writes there do not conflict on a bank), then
//     h's and y's rows, each channel's 64 pixels a run, in 16-byte vectors;
//     elements where vectors do not fit (C or hw no multiple of the vector,
//     a ragged tile, unaligned maps) one by one;
//   - where h, s and y lie at one offset from a 16-byte boundary, a chunk
//     runs a head of single elements up to its first boundary, its vectors,
//     and a tail of single elements; where they do not, the block takes its
//     chunk element by element, in the same launch;
//   - 64-bit offsets throughout.
// What it reaches against the bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;          // threads of a block, at most
constexpr int kUnroll = 4;             // vectors of each input a thread loads first
constexpr long long kFlatBelow = 256;  // planes of fewer elements take the flat route
constexpr int kTC = 32;                // the transpose route's tile: channels
constexpr int kTP = 64;                // and pixels

}  // namespace

// 0 for the plane route, 1 for the flat route, for planes of hw elements
extern "C" int fmi_residual_add_route(long long hw) { return hw < kFlatBelow ? 1 : 0; }

// The threads of a block for planes of hw elements of itemsize bytes: the
// flat route's kThreads; on the plane route the warps that the plane's
// 16-byte vectors fill, at most kThreads.
extern "C" int fmi_residual_add_threads(long long hw, int itemsize) {
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

__device__ __forceinline__ float sum(float h, float s, float b) {
  return __fadd_rn(__fadd_rn(h, s), b);
}

// the plane route's bias: one value for the whole chunk
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
struct FlatBias {
  const float* __restrict__ b;
  long long hw;
  int C;
  __device__ __forceinline__ float at(long long i) const {
    return b[static_cast<int>(i / hw % C)];
  }
  // the biases of the V elements from i: one division, then a step an element
  template <int V>
  __device__ __forceinline__ void run(long long i, float (&o)[V]) const {
    const long long q = i / hw;
    long long r = i - q * hw;
    int c = static_cast<int>(q % C);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o[j] = b[c];
      if (++r == hw) {
        r = 0;
        if (++c == C) c = 0;
      }
    }
  }
};

// Elements [begin, end) of h, s and y by one block, end - begin at most
// blockDim.x * kUnroll * V. With h, s and y `mis` elements past a 16-byte
// boundary (mis >= 0): single elements up to the chunk's first boundary,
// then the vectors (thread t takes vectors t, t + blockDim.x, ..., all its
// loads before its stores), then the single elements after the last whole
// vector. With mis < 0 (the three at different offsets): single elements
// only.
template <typename T, typename Bias>
__device__ __forceinline__ void run_chunk(const T* __restrict__ h, const T* __restrict__ s,
                                          T* __restrict__ y, long long begin, long long end,
                                          int mis, const Bias& bias) {
  constexpr int V = 16 / sizeof(T);
  const int t = threadIdx.x;
  const long long nt = blockDim.x;
  if (mis < 0) {
#pragma unroll
    for (int k = 0; k < kUnroll * V; ++k) {
      const long long i = begin + k * nt + t;
      if (i < end) y[i] = from_f<T>(sum(to_f(h[i]), to_f(s[i]), bias.at(i)));
    }
    return;
  }
  const long long a0 = min(end, begin + (V - (mis + begin) % V) % V);
  if (t < a0 - begin) {
    const long long i = begin + t;
    y[i] = from_f<T>(sum(to_f(h[i]), to_f(s[i]), bias.at(i)));
  }
  const long long nv = (end - a0) / V;
  uint4 rh[kUnroll], rs[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long k = u * nt + t;
    if (k < nv) {
      rh[u] = __ldg(reinterpret_cast<const uint4*>(h + a0 + k * V));
      rs[u] = __ldg(reinterpret_cast<const uint4*>(s + a0 + k * V));
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long k = u * nt + t;
    if (k < nv) {
      const long long i = a0 + k * V;
      float b[V];
      bias.run(i, b);
      const T* eh = reinterpret_cast<const T*>(&rh[u]);
      const T* es = reinterpret_cast<const T*>(&rs[u]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < V; ++j) oe[j] = from_f<T>(sum(to_f(eh[j]), to_f(es[j]), b[j]));
      *reinterpret_cast<uint4*>(y + i) = o;
    }
  }
  const long long tail = a0 + nv * V;
  if (t < end - tail) {
    const long long i = tail + t;
    y[i] = from_f<T>(sum(to_f(h[i]), to_f(s[i]), bias.at(i)));
  }
}

// The plane route: `parts` blocks a plane, block b taking chunk b % parts of
// plane b / parts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_bias_add_plane_kernel(const T* __restrict__ h, const T* __restrict__ s,
                               T* __restrict__ y, const float* __restrict__ bias, long long hw,
                               int C,
                               unsigned parts, int mis) {
  constexpr int V = 16 / sizeof(T);
  const unsigned plane = blockIdx.x / parts;  // the block's one division
  const long long chunk = static_cast<long long>(blockDim.x) * kUnroll * V;
  const long long first = static_cast<long long>(blockIdx.x - plane * parts) * chunk;
  const long long base = static_cast<long long>(plane) * hw;
  const OneBias b{bias[plane % static_cast<unsigned>(C)]};
  run_chunk<T>(h, s, y, base + first, base + min(hw, first + chunk), mis, b);
}

// The flat route: block b takes elements [b * chunk, (b + 1) * chunk) of all.
template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_bias_add_flat_kernel(const T* __restrict__ h, const T* __restrict__ s,
                              T* __restrict__ y, const float* __restrict__ bias, long long total,
                              long long hw, int C, int mis) {
  constexpr int V = 16 / sizeof(T);
  const long long chunk = static_cast<long long>(blockDim.x) * kUnroll * V;
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(total, begin + chunk);
  run_chunk<T>(h, s, y, begin, end, mis, FlatBias{bias, hw, C});
}

// The transpose route: h and y [N, C, hw], s [N, hw, C]; block (x, y, z)
// takes pixels [64 x, 64 x + 64) and channels [32 y, 32 y + 32) of image z.
// vec: C and hw are multiples of the vector and the maps 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_bias_add_transpose_kernel(const T* __restrict__ h, const T* __restrict__ s,
                                   T* __restrict__ y, const float* __restrict__ bias,
                                   long long hw, int C, int vec) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float tile[kTC][kTP + 1];
  const long long p0 = static_cast<long long>(blockIdx.x) * kTP;
  const int c0 = blockIdx.y * kTC;
  const long long n = blockIdx.z;
  const int tp = static_cast<int>(min(static_cast<long long>(kTP), hw - p0));
  const int tc = min(kTC, C - c0);
  // s's [tp pixels][tc channels] into tile[channel][pixel]
  constexpr int kPerPixel = kTC / V;  // vectors of a pixel's 32 channels
  const T* sn = s + n * hw * C;
  for (int k = threadIdx.x; k < kTP * kPerPixel; k += blockDim.x) {
    const int p = k / kPerPixel, cv = k % kPerPixel * V;
    if (p >= tp || cv >= tc) continue;
    const T* src = sn + (p0 + p) * C + c0 + cv;
    if (vec && cv + V <= tc) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(src));
      const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int j = 0; j < V; ++j) tile[cv + j][p] = to_f(e[j]);
    } else {
      for (int j = 0; j < V && cv + j < tc; ++j) tile[cv + j][p] = to_f(src[j]);
    }
  }
  __syncthreads();
  // h's and y's [tc channels][tp pixels]
  constexpr int kPerRow = kTP / V;  // vectors of a channel's 64 pixels
  for (int k = threadIdx.x; k < kTC * kPerRow; k += blockDim.x) {
    const int c = k / kPerRow, pv = k % kPerRow * V;
    if (c >= tc || pv >= tp) continue;
    const float b = bias[c0 + c];
    const long long off = (n * C + c0 + c) * hw + p0 + pv;
    if (vec && pv + V <= tp) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(h + off));
      const T* e = reinterpret_cast<const T*>(&r);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < V; ++j) oe[j] = from_f<T>(sum(to_f(e[j]), tile[c][pv + j], b));
      *reinterpret_cast<uint4*>(y + off) = o;
    } else {
      for (int j = 0; j < V && pv + j < tp; ++j)
        y[off + j] = from_f<T>(sum(to_f(h[off + j]), tile[c][pv + j], b));
    }
  }
}

template <typename T>
int launch_transpose(const T* h, const T* s, T* y, const float* bias, long long planes,
                     long long hw, int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long n = planes / C;
  const long long tiles = (hw + kTP - 1) / kTP;
  if (n > 65535 || (C + kTC - 1) / kTC > 65535 || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int vec = C % V == 0 && hw % V == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(tiles), (C + kTC - 1) / kTC, static_cast<unsigned>(n));
  residual_bias_add_transpose_kernel<T><<<grid, kThreads, 0, stream>>>(
      h, s, y, bias, hw, C, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_route(const T* h, const T* s, T* y, const float* bias, long long planes,
                 long long hw, int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int mh = static_cast<int>(reinterpret_cast<uintptr_t>(h) % 16 / sizeof(T));
  const int ms = static_cast<int>(reinterpret_cast<uintptr_t>(s) % 16 / sizeof(T));
  const int my = static_cast<int>(reinterpret_cast<uintptr_t>(y) % 16 / sizeof(T));
  const int mis = mh == my && ms == my ? my : -1;
  const int threads = fmi_residual_add_threads(hw, sizeof(T));
  const long long chunk = static_cast<long long>(threads) * kUnroll * V;
  if (fmi_residual_add_route(hw) == 0) {
    const long long parts = (hw + chunk - 1) / chunk;
    if (planes > 0x7fffffffLL / parts) return static_cast<int>(cudaErrorInvalidConfiguration);
    residual_bias_add_plane_kernel<T>
        <<<static_cast<unsigned>(planes * parts), threads, 0, stream>>>(
            h, s, y, bias, hw, C, static_cast<unsigned>(parts), mis);
  } else {
    const long long total = planes * hw;
    const long long blocks = (total + chunk - 1) / chunk;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    residual_bias_add_flat_kernel<T>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        h, s, y, bias, total, hw, C, mis);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <typename T>
int launch(const void* h, const void* s, const void* b, void* y, long long planes,
           long long hw, int C, int s_nhwc, void* stream) {
  if (planes < 1 || hw < 1 || C < 1 || planes % C != 0 || planes > 0x7fffffffffffffffLL / hw ||
      !aligned(h, sizeof(T)) || !aligned(s, sizeof(T)) || !aligned(y, sizeof(T)) ||
      b == nullptr || !aligned(b, sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* hp = static_cast<const T*>(h);
  const T* sp = static_cast<const T*>(s);
  T* yp = static_cast<T*>(y);
  const float* bp = static_cast<const float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_nhwc) return launch_transpose<T>(hp, sp, yp, bp, planes, hw, C, st);
  return launch_route<T>(hp, sp, yp, bp, planes, hw, C, st);
}

}  // namespace

// h, s and y [planes, hw] contiguous, all of one type, planes = N * C; with
// s_nhwc != 0, s is [N, hw, C] instead (route "transpose"). b: C f32 values.
// Returns a cudaError_t code; 0 means launched.
extern "C" int fmi_residual_bias_add_f32(const void* h, const void* s, const void* b, void* y,
                                         long long planes, long long hw, int C, int s_nhwc,
                                         void* stream) {
  return launch<float>(h, s, b, y, planes, hw, C, s_nhwc, stream);
}

extern "C" int fmi_residual_bias_add_bf16(const void* h, const void* s, const void* b, void* y,
                                          long long planes, long long hw, int C, int s_nhwc,
                                          void* stream) {
  return launch<__nv_bfloat16>(h, s, b, y, planes, hw, C, s_nhwc, stream);
}
