// The separable StyleGAN2 resampling upfirdn2d in one pass (kernel K6).
//
// Replaces: face_mask_inpaint_tpu/ops/pallas/upfirdn2d_pallas.py:44
// `upfirdn1d_axis` (pallas_call at :121, body `_axis_kernel_body` at :137),
// which `upfirdn2d_pallas` (:241) runs twice, along H and then along W.
//
// Computes, for x [P, H, W] contiguous (P = N * C planes of an NCHW map) of
// one dtype T in {f32, bf16}, taps k[0..K) (already flipped by the caller,
// so this correlation is the true convolution of upfirdn2d), and a mode
// (up, down) in {(1, 1), (2, 1), (1, 2)}, along each axis of length L:
//     y[o] = sum_t k[t] * xu[o * down - pad0 + t]
// where xu is x zero-upsampled by `up` (xu[j] = x[j / up] when j % up == 0,
// else 0) and zero outside [0, L * up); a negative pad0 crops. For up = 2
// the sum is polyphase: an output reads only the taps of its own parity,
// those with o * down - pad0 + t even, as the TPU kernel's two phases do.
// The H pass runs first and its result is rounded to T, as `upfirdn1d_axis`
// writes its output in x's dtype; the W pass runs on that, and its result is
// rounded to T once. Each sum is taken in f32 in tap order, a multiply and an
// add each (no fused multiply-add), which is the plain version's arithmetic
// (kernels/upfirdn2d.py), so both compute the same values.
//
// What bounds it on an H100: each output is K / up multiply-adds a pass (at
// most 4 for StyleGAN2's 4-tap blur) on values read once from device memory,
// so the bytes bound it by far: the pSp forward's 16 calls (batch 16, bf16)
// read and write 4.385 GB, 1.309 ms at 3.35 TB/s.
//
// Design: one launch a call, no intermediate in device memory. A block of
// 256 threads owns a tile of OH x OW outputs of one plane (32 x 128 for
// (1, 1), 64 x 128 for (2, 1), 16 x 64 for (1, 2): each about 35 x 131
// input values or fewer); the grid covers (column tiles, row tiles, planes),
// so that planes of a few outputs, such as the 3-channel skip upsamples',
// still spread over the card. The block
//   1. stages the input window the tile reads (the tile through the mode's
//      stride plus the taps' halo, sized from K at launch in dynamic shared
//      memory) with one 16-byte load a thread and piece, zeros outside the
//      image. Rows such as the blurs' (r + 1 wide: 2,050 bytes in bf16) start
//      off a 16-byte boundary, so the loads take the aligned 16-byte pieces
//      that cover each window row (a piece that holds one element of x lies
//      in x's pages) and keep the pieces in shared memory as they lie; each
//      row's window starts at its own offset into its first piece;
//   2. runs the H pass for the window's columns into a shared f32 tile,
//      each value rounded to T: a thread takes 8 output rows of one column
//      from one register window of the input rows they read (11 loads for 8
//      outputs of the 4-tap blur, not 32);
//   3. runs the W pass from that tile, a thread taking a run of 16 bytes of
//      outputs of one row from one register window, and stores the run as
//      one 16-byte piece: each output row is cut at its 16-byte boundaries
//      (a head before the first, stored element by element), so that rows
//      of any width and alignment, such as the backward's (r + 1)-wide f32
//      ones, leave in whole pieces. The H pass's tile is swizzled (column c
//      of a row at c + c / 32) so that these runs meet distinct banks.
// The taps arrive by value in the kernel's parameters, so each is a
// constant-bank operand; a kernel unrolled for 4 taps takes StyleGAN2's
// filters, one unrolled for 16 any other. What it reaches against the
// bound is in PERF.md (chip_smoke.py phases 8 and 9).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 16;
constexpr int kThreads = 256;

struct Taps {
  float k[kMaxTaps];
};

// the output tile of a block, per mode (tests/test_torch_kernel_schedules.py
// emulates the schedule at these tiles)
template <int UP, int DOWN>
struct Tile;
template <>
struct Tile<1, 1> {
  static constexpr int OH = 32, OW = 128;
};
template <>
struct Tile<2, 1> {
  static constexpr int OH = 64, OW = 128;
};
template <>
struct Tile<1, 2> {
  static constexpr int OH = 16, OW = 64;
};

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

__host__ __device__ __forceinline__ long long floor_div(long long a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// input positions an output tile of n samples reads along one axis, at most
__host__ __device__ __forceinline__ int span(int n, int up, int down, int ktaps) {
  return ((n - 1) * down + ktaps - 1) / up + 2;
}

// the window of input positions [i0, i0 + count) that outputs [o0, o0 + n)
// read along one axis
__device__ __forceinline__ void window(int o0, int n, int up, int down, int pad0, int ktaps,
                                       int& i0, int& count) {
  const int j0 = o0 * down - pad0;  // upsampled index of the first output's tap 0
  i0 = static_cast<int>(floor_div(j0, up));
  count = static_cast<int>(floor_div(j0 + (n - 1) * down + ktaps - 1, up)) - i0 + 1;
}

// The H pass's f32 tile keeps column c of a row at c + c / 32, so that the
// W pass's threads, each on its own run of V columns, meet distinct banks.
__host__ __device__ __forceinline__ int swz(int c) { return c + (c >> 5); }

// N outputs from a register window v: o[r] = sum_t k[t] v[(PH + r DOWN + t) / UP]
// over the taps t < ktaps of the run's phase (PH + r DOWN + t = 0 mod UP),
// in tap order, a multiply and an add each
template <int UP, int DOWN, int KMAX, int N, int PH, int NV>
__device__ __forceinline__ void fir_run(const Taps& taps, int ktaps, const float (&v)[NV],
                                        float (&o)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      const int j = PH + r * DOWN + t;
      static_assert((PH + (N - 1) * DOWN + KMAX - 1) / UP < NV, "the window holds every tap");
      if (t < ktaps && j % UP == 0) acc = __fadd_rn(acc, __fmul_rn(taps.k[t], v[j / UP]));
    }
    o[r] = acc;
  }
}

// the values a run of N outputs reads, at most
template <int UP, int DOWN, int KMAX, int N>
struct Run {
  static constexpr int NV = ((N - 1) * DOWN + KMAX - 1 + UP - 1) / UP + 1;
};

// V floats rounded to T, as one 16-byte piece
__device__ __forceinline__ uint4 pack16(const float (&o)[4]) {
  return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]), __float_as_uint(o[2]),
                    __float_as_uint(o[3]));
}
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}
__device__ __forceinline__ uint4 pack16(const float (&o)[8]) {
  return make_uint4(bf16x2(o[0], o[1]), bf16x2(o[2], o[3]), bf16x2(o[4], o[5]),
                    bf16x2(o[6], o[7]));
}

constexpr int kRun = 8;  // output rows a thread of the H pass takes from one window

// x [P, H, W] -> out [P, Ho, Wo], one OH x OW output tile of plane
// blockIdx.z (and of every gridDim.z-th plane after it); taps t < ktaps <=
// KMAX. mis: the elements between x and the 16-byte boundary before it. rs:
// a staged row's stride in T (whole 16-byte pieces); iws: the H pass tile's
// row stride in f32 (swizzled); ih: the staged rows, at most. The register
// windows read past the values their stored outputs need (those feed only
// outputs that are not stored): rowbase has a window's rows of slack that
// point at row 0, and the tile's rows a window's columns.
template <typename T, int UP, int DOWN, int KMAX>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ out, const Taps taps, int P, int H,
                 int W, int Ho, int Wo, int ktaps, int pad0, int mis, int rs, int iws, int ih) {
  constexpr int OH = Tile<UP, DOWN>::OH, OW = Tile<UP, DOWN>::OW;
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte piece
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* in = reinterpret_cast<T*>(smem_raw);                              // [ih][rs]
  float* mid = reinterpret_cast<float*>(smem_raw + ((ih * rs * sizeof(T) + 15) / 16) * 16);
  int* rowbase = reinterpret_cast<int*>(mid + OH * iws);  // where window row rr's column 0 sits
  const T* xa = x - mis;                                  // 16-byte aligned

  const int oy0 = blockIdx.y * OH, ox0 = blockIdx.x * OW;
  const int rows = min(OH, Ho - oy0), cols = min(OW, Wo - ox0);
  int iy0, nh, ix0, nw;
  window(oy0, rows, UP, DOWN, pad0, ktaps, iy0, nh);
  window(ox0, cols, UP, DOWN, pad0, ktaps, ix0, nw);
  const int slots = (nw + 2 * V - 2) / V;  // pieces that cover a window row

  for (long long p = blockIdx.z; p < P; p += gridDim.z) {
    // 1. the window, piece by piece, each piece where it lies in its row;
    //    elements outside the image (a neighbouring row's, x's margins) are 0
    const long long plane = p * H * W + mis;  // x's plane p in xa's elements
    for (int i = threadIdx.x; i < nh * slots; i += kThreads) {
      const int rr = i / slots, q = i - rr * slots;
      const int row = iy0 + rr;
      const long long row0 = plane + static_cast<long long>(row) * W;  // column 0 in xa
      const long long first = floor_div(row0 + ix0, V);                // window column 0's piece
      const int col = static_cast<int>((first + q) * V - row0);        // the piece's first column
      if (q == 0) rowbase[rr] = rr * rs + ix0 - col;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row >= 0 && row < H && col < W && col + V > 0) {
        raw = __ldg(reinterpret_cast<const uint4*>(xa + row0 + col));
        if (col < 0 || col + V > W) {
          unsigned word[4] = {raw.x, raw.y, raw.z, raw.w};
          constexpr int kPerWord = 4 / sizeof(T);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const unsigned bits = sizeof(T) == 4 ? 0xffffffffu : 0xffffu << (16 * (v % kPerWord));
            if (col + v < 0 || col + v >= W) word[v / kPerWord] &= ~bits;
          }
          raw = make_uint4(word[0], word[1], word[2], word[3]);
        }
      }
      *reinterpret_cast<uint4*>(in + rr * rs + q * V) = raw;
    }
    for (int rr = nh + threadIdx.x; rr < ih + Run<UP, DOWN, KMAX, kRun>::NV; rr += kThreads)
      rowbase[rr] = 0;
    __syncthreads();

    // 2. the H pass over the window's columns, kRun output rows a thread
    //    from one register window, each value rounded to T
    {
      using R = Run<UP, DOWN, KMAX, kRun>;
      const int groups = (rows + kRun - 1) / kRun;
      for (int i = threadIdx.x; i < groups * nw; i += kThreads) {
        const int gi = i / nw, cc = i - gi * nw;
        const int r0 = gi * kRun;
        const int jb = (oy0 + r0) * DOWN - pad0 - iy0 * UP;  // upsampled, from the window's row 0
        const int a = jb / UP;
        float v[R::NV], o[kRun];
#pragma unroll
        for (int k = 0; k < R::NV; ++k) v[k] = to_f(in[rowbase[a + k] + cc]);
        if constexpr (UP == 2) {
          if (jb & 1)
            fir_run<UP, DOWN, KMAX, kRun, 1>(taps, ktaps, v, o);
          else
            fir_run<UP, DOWN, KMAX, kRun, 0>(taps, ktaps, v, o);
        } else {
          fir_run<UP, DOWN, KMAX, kRun, 0>(taps, ktaps, v, o);
        }
#pragma unroll
        for (int r = 0; r < kRun; ++r)
          if (r0 + r < rows) mid[(r0 + r) * iws + swz(cc)] = to_f(from_f<T>(o[r]));
      }
    }
    __syncthreads();

    // 3. the W pass, a run of V outputs a thread from one register window,
    //    stored as one 16-byte piece: each output row is cut into a head up
    //    to its first 16-byte boundary (run 0, stored element by element) and
    //    runs of V that start on a boundary
    {
      using R = Run<UP, DOWN, KMAX, V>;
      constexpr int G = OW / V + 1;  // runs a row, at most
      for (int i = threadIdx.x; i < rows * G; i += kThreads) {
        const int r = i / G, g = i - r * G;
        T* d = out + (p * Ho + oy0 + r) * Wo + ox0;
        const size_t at = reinterpret_cast<size_t>(d) / sizeof(T);
        const int head = static_cast<int>((V - at) & (V - 1));  // columns before a boundary
        const int c0 = g == 0 ? 0 : head + (g - 1) * V;
        const int c1 = min(g == 0 ? head : c0 + V, cols);
        if (c0 >= c1) continue;
        const int jb = (ox0 + c0) * DOWN - pad0 - ix0 * UP;
        const int a = jb / UP;
        const float* m = mid + r * iws;
        float v[R::NV], o[V];
#pragma unroll
        for (int k = 0; k < R::NV; ++k) v[k] = m[swz(a + k)];
        if constexpr (UP == 2) {
          if (jb & 1)
            fir_run<UP, DOWN, KMAX, V, 1>(taps, ktaps, v, o);
          else
            fir_run<UP, DOWN, KMAX, V, 0>(taps, ktaps, v, o);
        } else {
          fir_run<UP, DOWN, KMAX, V, 0>(taps, ktaps, v, o);
        }
        if (c1 - c0 == V) {
          *reinterpret_cast<uint4*>(d + c0) = pack16(o);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k)
            if (c0 + k < c1) d[c0 + k] = from_f<T>(o[k]);
        }
      }
    }
    __syncthreads();  // the next plane restages the window
  }
}

template <typename T, int UP, int DOWN, int KMAX>
int launch_mode(const T* x, T* out, const Taps& taps, int P, int H, int W, int Ho, int Wo,
                int ktaps, int pad0, cudaStream_t stream) {
  constexpr int OH = Tile<UP, DOWN>::OH, OW = Tile<UP, DOWN>::OW;
  constexpr int V = 16 / sizeof(T);
  const int ih = span(OH, UP, DOWN, ktaps), iw = span(OW, UP, DOWN, ktaps);
  const int rs = (iw + 2 * V - 2) / V * V;
  const int iws = swz(iw + Run<UP, DOWN, KMAX, V>::NV) + 1;  // swizzled, with the runs' slack
  const size_t smem = (static_cast<size_t>(ih) * rs * sizeof(T) + 15) / 16 * 16 +
                      sizeof(float) * OH * iws +
                      sizeof(int) * (ih + Run<UP, DOWN, KMAX, kRun>::NV);
  const dim3 grid((Wo + OW - 1) / OW, (Ho + OH - 1) / OH, P < 65535 ? P : 65535);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        upfirdn2d_kernel<T, UP, DOWN, KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int mis = static_cast<int>((reinterpret_cast<size_t>(x) & 15) / sizeof(T));
  upfirdn2d_kernel<T, UP, DOWN, KMAX><<<grid, kThreads, smem, stream>>>(
      x, out, taps, P, H, W, Ho, Wo, ktaps, pad0, mis, rs, iws, ih);
  return static_cast<int>(cudaGetLastError());
}

// StyleGAN2's filters have 4 taps: their calls take a kernel unrolled for 4
template <typename T, int UP, int DOWN>
int launch_taps(const T* x, T* out, const Taps& taps, int P, int H, int W, int Ho, int Wo,
                int ktaps, int pad0, cudaStream_t stream) {
  if (ktaps <= 4)
    return launch_mode<T, UP, DOWN, 4>(x, out, taps, P, H, W, Ho, Wo, ktaps, pad0, stream);
  return launch_mode<T, UP, DOWN, kMaxTaps>(x, out, taps, P, H, W, Ho, Wo, ktaps, pad0, stream);
}

template <typename T>
int launch(const void* x, void* out, const float* k, int ktaps, int P, int H, int W, int up,
           int down, int pad0, int Ho, int Wo, void* stream) {
  if (ktaps < 1 || ktaps > kMaxTaps || P < 1 || H < 1 || W < 1 || Ho < 1 || Wo < 1 ||
      reinterpret_cast<size_t>(x) % sizeof(T) != 0 ||
      reinterpret_cast<size_t>(out) % sizeof(T) != 0 ||
      static_cast<long long>(H) * W > 0x7fffffff || static_cast<long long>(Ho) * Wo > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int t = 0; t < kMaxTaps; ++t) taps.k[t] = t < ktaps ? k[t] : 0.f;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (up == 1 && down == 1)
    return launch_taps<T, 1, 1>(xp, op, taps, P, H, W, Ho, Wo, ktaps, pad0, st);
  if (up == 2 && down == 1)
    return launch_taps<T, 2, 1>(xp, op, taps, P, H, W, Ho, Wo, ktaps, pad0, st);
  if (up == 1 && down == 2)
    return launch_taps<T, 1, 2>(xp, op, taps, P, H, W, Ho, Wo, ktaps, pad0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [P, H, W] and out [P, Ho, Wo] contiguous, both of one type; k: ktaps f32
// taps in host memory (copied into the launch's parameters), already
// flipped; the same mode and pad0 along both axes. Returns a cudaError_t
// code; 0 means launched.
extern "C" int fmi_upfirdn2d_f32(const void* x, void* out, const float* k, int ktaps, int P,
                                 int H, int W, int up, int down, int pad0, int Ho, int Wo,
                                 void* stream) {
  return launch<float>(x, out, k, ktaps, P, H, W, up, down, pad0, Ho, Wo, stream);
}

extern "C" int fmi_upfirdn2d_bf16(const void* x, void* out, const float* k, int ktaps, int P,
                                  int H, int W, int up, int down, int pad0, int Ho, int Wo,
                                  void* stream) {
  return launch<__nv_bfloat16>(x, out, k, ktaps, P, H, W, up, down, pad0, Ho, Wo, stream);
}
