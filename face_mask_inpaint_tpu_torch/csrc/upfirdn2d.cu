// One 1-D pass of the separable StyleGAN2 resampling upfirdn2d (kernel K6).
//
// Replaces: face_mask_inpaint_tpu/ops/pallas/upfirdn2d_pallas.py:44
// `upfirdn1d_axis` (pallas_call at :121, body `_axis_kernel_body` at :137),
// which `upfirdn2d_pallas` (:241) runs twice, along H and then along W.
//
// Computes, for x [P, H, W] contiguous (P = N * C planes of an NCHW map) of
// one dtype T in {f32, bf16}, taps k[0..K) (already flipped by the caller,
// so this correlation is the true convolution of upfirdn2d), and a mode
// (up, down) in {(1, 1), (2, 1), (1, 2)}, along one axis of length L:
//     out[o] = sum_t k[t] * xu[o * down - pad0 + t]
// where xu is x zero-upsampled by `up` (xu[j] = x[j / up] when j % up == 0,
// else 0) and zero outside [0, L * up); a negative pad0 crops. For up = 2
// the sum is polyphase: an output reads only the taps of its own parity,
// those with o * down - pad0 + t even, as the TPU kernel's two phases do.
// The sum is taken in f32 and rounded once to T. The caller (the wrapper in
// kernels/upfirdn2d.py) runs the H pass into an intermediate of type T, then
// the W pass on it, as `upfirdn1d_axis` writes its output in x's dtype.
//
// What bounds it on an H100: each output is K / up multiply-adds (at most
// 4 for StyleGAN2's 4-tap blur) on values that are read once from device
// memory, so the bytes bound it by far. At the pSp forward (batch 16, bf16)
// the 16 calls read and write 4.3 GB, 1.3 ms at 3.35 TB/s, and the two
// passes double that, since the intermediate goes through device memory.
//
// Design: each thread computes kPer = 4 outputs, so a warp has up to 16
// independent loads in flight: in the H pass four consecutive output rows of
// one column (the rows they share come from L1), in the W pass four columns
// 128 apart of one row. A block covers 128 columns (times four rows, or
// times four column groups), the grid (column blocks, row blocks, planes).
// In the H pass the threads of a warp own neighbouring columns, so each row
// they read is one coalesced load; in the W pass neighbouring threads read
// neighbouring addresses (stride down / up). The taps arrive by value in the
// kernel's parameters; the loops are unrolled, so each tap is a
// constant-bank operand. Keeping the H pass's rows in shared memory and
// running the W pass on them (no intermediate in device memory), and vector
// loads, are the next steps (a later PR).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 16;
constexpr int kThreads = 128;
constexpr int kPer = 4;  // outputs a thread

struct Taps {
  float k[kMaxTaps];
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

// AXIS 0 filters along H: x [P, H, W] -> out [P, Lout, W].
// AXIS 1 filters along W: x [P, H, W] -> out [P, H, Lout].
template <typename T, int UP, int DOWN, int AXIS>
__global__ void __launch_bounds__(kThreads)
upfirdn1d_kernel(const T* __restrict__ x, T* __restrict__ out, const Taps taps, int P,
                 int H, int W, int Lout, int ktaps, int pad0) {
  const int wout = AXIS == 0 ? W : Lout;
  const int hout = AXIS == 0 ? Lout : H;
  const int L = AXIS == 0 ? H : W;           // input length along the filtered axis
  const long long step = AXIS == 0 ? W : 1;  // elements between neighbours along it
  const long long in_plane = static_cast<long long>(H) * W;
  const long long out_plane = static_cast<long long>(hout) * wout;
  // H pass: column `col`, rows row0 .. row0 + kPer - 1;
  // W pass: row `row0`, columns col, col + kThreads, ...
  const int col = AXIS == 0 ? blockIdx.x * kThreads + threadIdx.x
                            : blockIdx.x * kThreads * kPer + threadIdx.x;
  const int row0 = AXIS == 0 ? blockIdx.y * kPer : blockIdx.y;
  for (long long p = blockIdx.z; p < P; p += gridDim.z) {
    const T* src = x + p * in_plane;
    T* dst = out + p * out_plane;
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int r = AXIS == 0 ? row0 + v : row0;
      const int c = AXIS == 0 ? col : col + v * kThreads;
      if (r >= hout || c >= wout) break;
      const int o = AXIS == 0 ? r : c;       // output position along the filtered axis
      const T* line = src + (AXIS == 0 ? static_cast<long long>(c)
                                       : static_cast<long long>(r) * W);
      const int base = o * DOWN - pad0;      // upsampled index read by tap 0
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        if (t >= ktaps) break;
        const int j = base + t;
        if (UP == 2 && (j & 1)) continue;    // the other phase's tap
        if (j < 0) continue;
        const int i = j / UP;
        if (i >= L) continue;
        acc = fmaf(taps.k[t], to_f(line[i * step]), acc);
      }
      dst[static_cast<long long>(r) * wout + c] = from_f<T>(acc);
    }
  }
}

template <typename T, int UP, int DOWN>
int launch_mode(const T* x, T* out, const Taps& taps, int P, int H, int W, int axis,
                int Lout, int ktaps, int pad0, cudaStream_t stream) {
  const int wout = axis == 0 ? W : Lout;
  const int hout = axis == 0 ? Lout : H;
  const int col_span = axis == 0 ? kThreads : kThreads * kPer;
  const int row_blocks = axis == 0 ? (hout + kPer - 1) / kPer : hout;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((wout + col_span - 1) / col_span, row_blocks, P < 65535 ? P : 65535);
  if (axis == 0)
    upfirdn1d_kernel<T, UP, DOWN, 0><<<grid, kThreads, 0, stream>>>(
        x, out, taps, P, H, W, Lout, ktaps, pad0);
  else
    upfirdn1d_kernel<T, UP, DOWN, 1><<<grid, kThreads, 0, stream>>>(
        x, out, taps, P, H, W, Lout, ktaps, pad0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, void* out, const float* k, int ktaps, int P, int H, int W,
           int axis, int up, int down, int pad0, int Lout, void* stream) {
  if (ktaps < 1 || ktaps > kMaxTaps || P < 1 || H < 1 || W < 1 || Lout < 1 ||
      (axis != 0 && axis != 1) || static_cast<long long>(H) * W > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int t = 0; t < kMaxTaps; ++t) taps.k[t] = t < ktaps ? k[t] : 0.f;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (up == 1 && down == 1)
    return launch_mode<T, 1, 1>(xp, op, taps, P, H, W, axis, Lout, ktaps, pad0, st);
  if (up == 2 && down == 1)
    return launch_mode<T, 2, 1>(xp, op, taps, P, H, W, axis, Lout, ktaps, pad0, st);
  if (up == 1 && down == 2)
    return launch_mode<T, 1, 2>(xp, op, taps, P, H, W, axis, Lout, ktaps, pad0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [P, H, W] and out ([P, Lout, W] for axis 0, [P, H, Lout] for axis 1)
// contiguous, both of one type; k: ktaps f32 taps in host memory (copied
// into the launch's parameters), already flipped. Returns a cudaError_t
// code; 0 means launched.
extern "C" int fmi_upfirdn1d_f32(const void* x, void* out, const float* k, int ktaps, int P,
                                 int H, int W, int axis, int up, int down, int pad0,
                                 int Lout, void* stream) {
  return launch<float>(x, out, k, ktaps, P, H, W, axis, up, down, pad0, Lout, stream);
}

extern "C" int fmi_upfirdn1d_bf16(const void* x, void* out, const float* k, int ktaps,
                                  int P, int H, int W, int axis, int up, int down, int pad0,
                                  int Lout, void* stream) {
  return launch<__nv_bfloat16>(x, out, k, ktaps, P, H, W, axis, up, down, pad0, Lout,
                               stream);
}
