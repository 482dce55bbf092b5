// Fused Output head of the PICNet generator (kernel K3).
//
// Replaces: face_mask_inpaint_tpu/ops/pallas/packed_convt.py:658
// `packed_output_head` (`_output_head_kernel`, pallas_call at :740) together
// with what its caller adds around it: the reflection-ring correction
// `Output._ring_correct` and the integer-factor pool
// (face_mask_inpaint_tpu/nn/blocks.py:436-445, :570-637). The TPU kernel
// works on a space-to-depth packed map with a zero-pad conv and hands back
// edge blocks for the caller to repair; this one works on the dense NCHW map
// and reflects at the border itself, so there are no edge blocks.
//
// Computes, for the last decoder block's pre-add pair h, s [N, C, H, W]
// (contiguous, one dtype T in {f32, bf16}), a weight w [co, C, 3, 3] and a
// bias b [co]:
//     a   = act(h + s)        sum and act each rounded to T, as the TPU kernel
//                             adds and activates in the stream dtype
//     y   = tanh(conv3x3(reflect_pad1(a), w) + b)   accumulated in f32
//     out = mean of y over each f x f cell -> [N, co, H/f, W/f], rounded to T
// act is LeakyReLU(0.1) or ReLU; co <= 4.
//
// What bounds it on an H100: at the flagship (N = 16, C = 32, H = W = 1024,
// co = 3, f = 4) it reads two maps once, 2.147 GB in bf16 (0.64 ms at
// 3.35 TB/s; 4.295 GB and 1.28 ms in f32), and does 29.0 GFLOP of FMA
// (0.43 ms on the CUDA cores at 67 TFLOP/s). The output is 1/16 of a map
// per channel. So it is memory-bound, and with co = 3 the tensor cores do
// not pay: this is a CUDA-core kernel whose job is to read each input byte
// once and keep act(h + s), the conv output and tanh out of device memory.
//
// Design: one block owns whole f x f cells of one image, so no sum crosses
// blocks and no atomics are needed. For f <= 32 that is a tile of up to
// 32 x 64 pixels (rows x columns) made of whole cells; for f > 32 it is one
// cell, walked in 32 x 64 sub-tiles. Per sub-tile, 256 threads:
//   - stage act(h + s) for 2 channels at a time with a one-pixel halo in
//     shared memory (f32), loads coalesced along W, reflecting at the image
//     border (row -1 reads row 1, row H reads row H-2), with the chunk's
//     3 x 3 x co weights beside it; the stage is double-buffered, so the
//     next chunk's loads are in flight while this one is computed;
//   - each thread owns 8 rows of one column and keeps their co outputs in
//     registers; a staged row is read once and feeds up to three output
//     rows, so shared-memory reads stay below the FMA count;
//   - after the last chunk: bias and tanh in registers; the f x f cells are
//     summed in a fixed order (through shared memory for f <= 32, by warp
//     shuffles and a block sum for f > 32), so the result is deterministic.
// At the flagship it runs at about a third of the bytes bound (PERF.md,
// from chip_smoke.py). Neither more blocks per SM (four rows a thread) nor
// fewer (no register cap) brings it closer (tools/output_head_variants.py),
// and overlapping the loads with the compute gained little, so instruction
// issue holds it, not memory: the act(h + s) staging costs about a third of
// the instructions. Vector loads, and fewer shared-memory reads per FMA, are
// the next steps (a later PR).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 64;                 // sub-tile width: one thread per column
constexpr int kRows = 8;                // rows per thread
constexpr int kTY = kThreads / kTW;     // thread rows
constexpr int kTH = kTY * kRows;        // sub-tile height: 32
constexpr int kCK = 2;                  // channels staged per step
constexpr int kSW = kTW + 2;            // staged width with halo
constexpr int kSH = kTH + 2;            // staged height with halo
constexpr int kPlane = kSH * kSW;
constexpr int kStageIters = (kPlane + kThreads - 1) / kThreads;
constexpr int kCoMax = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kStageFloats = 2 * kCK * kPlane;  // two buffers
static_assert(kStageFloats >= kCoMax * kTH * kTW, "the tanh tile reuses the stage");

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
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// act(h + s) with the sum and the activation each rounded to T
template <typename T>
__device__ __forceinline__ float act_sum(T hv, T sv, bool leaky) {
  const float a = round_to<T>(to_f(hv) + to_f(sv));
  return a >= 0.f ? a : (leaky ? round_to<T>(a * 0.1f) : 0.f);
}

// The staging of one sub-tile: each thread owns the same kStageIters
// positions of the haloed tile in every channel, so their reflected offsets
// (-1 where a position lies outside the tile) are computed once per
// sub-tile, and a chunk's loads all go out before the first is used.
template <typename T>
struct Stager {
  int off[kStageIters];
  T hv[kStageIters][kCK], sv[kStageIters][kCK];

  __device__ __forceinline__ Stager(int H, int W, int y0, int x0, int th, int tw) {
#pragma unroll
    for (int i = 0; i < kStageIters; ++i) {
      const int p = threadIdx.x + i * kThreads;
      const int r = p / kSW;
      const int c = p - r * kSW;
      off[i] = (p < kPlane && r <= th + 1 && c <= tw + 1)
                   ? reflect(y0 - 1 + r, H) * W + reflect(x0 - 1 + c, W)
                   : -1;
    }
  }

  // issue the loads of channels [c0, c0 + kCK) into registers
  __device__ __forceinline__ void load(const T* __restrict__ hn, const T* __restrict__ sn,
                                       size_t plane, int c0, int C) {
#pragma unroll
    for (int ch = 0; ch < kCK; ++ch) {
      const bool live = c0 + ch < C;
      const size_t base = static_cast<size_t>(c0 + ch) * plane;
#pragma unroll
      for (int i = 0; i < kStageIters; ++i) {
        const bool ok = live && off[i] >= 0;
        hv[i][ch] = ok ? hn[base + off[i]] : from_f<T>(0.f);
        sv[i][ch] = ok ? sn[base + off[i]] : from_f<T>(0.f);
      }
    }
  }

  // act(h + s) of the loaded channels into one stage buffer, and the
  // chunk's weights (ws[ch][tap][o], zero past C and co) beside it
  template <int CO>
  __device__ __forceinline__ void store(float* stage, float* ws, const float* __restrict__ w,
                                        int c0, int C, bool leaky) const {
#pragma unroll
    for (int i = 0; i < kStageIters; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < kPlane)
#pragma unroll
        for (int ch = 0; ch < kCK; ++ch)
          stage[ch * kPlane + p] = act_sum<T>(hv[i][ch], sv[i][ch], leaky);
    }
    const int tid = threadIdx.x;
    if (tid < kCK * 9 * kCoMax) {
      const int ch = tid / (9 * kCoMax);
      const int o = tid % kCoMax;
      ws[tid] = (c0 + ch < C && o < CO) ? w[static_cast<size_t>(c0) * 9 * kCoMax + tid] : 0.f;
    }
  }
};

// Conv outputs (pre-bias) of the thread's kRows pixels over all C channels,
// for the sub-tile whose top-left pixel is (y0, x0) and whose valid size is
// th x tw. The stage is double-buffered: chunk k + 1's loads are in flight
// while chunk k is computed, and one barrier a chunk orders the two. `stage`
// ends the call holding nothing the caller needs.
template <typename T, int CO>
__device__ __forceinline__ void conv_tile(const T* __restrict__ hn, const T* __restrict__ sn,
                                          const float* __restrict__ w, float* stage,
                                          float* ws, float (&acc)[kRows][CO], int C,
                                          int H, int W, int y0, int x0, int th, int tw,
                                          bool leaky) {
  const int tx = threadIdx.x % kTW;
  const int ty = threadIdx.x / kTW;
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[r][o] = 0.f;

  Stager<T> st(H, W, y0, x0, th, tw);
  st.load(hn, sn, plane, 0, C);
  st.template store<CO>(stage, ws, w, 0, C, leaky);
  __syncthreads();
  for (int c0 = 0, buf = 0; c0 < C; c0 += kCK, buf ^= 1) {
    const bool more = c0 + kCK < C;
    if (more) st.load(hn, sn, plane, c0 + kCK, C);

    const float* sb = stage + buf * kCK * kPlane;
    const float* wb = ws + buf * kCK * 9 * kCoMax;
    for (int ch = 0; ch < min(kCK, C - c0); ++ch) {
      float wr[9][kCoMax];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 q = *reinterpret_cast<const float4*>(&wb[(ch * 9 + t) * kCoMax]);
        wr[t][0] = q.x; wr[t][1] = q.y; wr[t][2] = q.z; wr[t][3] = q.w;
      }
      const float* base = sb + ch * kPlane + ty * kRows * kSW + tx;
#pragma unroll
      for (int j = 0; j < kRows + 2; ++j) {
        const float a0 = base[j * kSW];
        const float a1 = base[j * kSW + 1];
        const float a2 = base[j * kSW + 2];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = j - dy;
          if (r < 0 || r >= kRows) continue;
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            float v = acc[r][o];
            v = fmaf(wr[dy * 3 + 0][o], a0, v);
            v = fmaf(wr[dy * 3 + 1][o], a1, v);
            v = fmaf(wr[dy * 3 + 2][o], a2, v);
            acc[r][o] = v;
          }
        }
      }
    }

    // the other buffer was last read before the previous barrier
    if (more)
      st.template store<CO>(stage + (buf ^ 1) * kCK * kPlane, ws + (buf ^ 1) * kCK * 9 * kCoMax,
                            w, c0 + kCK, C, leaky);
    __syncthreads();
  }
}

// f <= 32: the block's cells fit one sub-tile of cells_y x cells_x cells.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads, 2)
output_head_tile_kernel(const T* __restrict__ h, const T* __restrict__ s,
                        const float* __restrict__ w, const float* __restrict__ bias,
                        T* __restrict__ out, int C, int H, int W, int f, int cells_x,
                        int cells_y, int leaky) {
  __shared__ __align__(16) float stage[kStageFloats];
  __shared__ __align__(16) float ws[2 * kCK * 9 * kCoMax];
  const int n = blockIdx.z;
  const int hc = H / f, wc = W / f;
  const int cx0 = blockIdx.x * cells_x, cy0 = blockIdx.y * cells_y;
  const int ncx = min(cells_x, wc - cx0), ncy = min(cells_y, hc - cy0);
  const size_t image = static_cast<size_t>(C) * H * W;
  float acc[kRows][CO];
  conv_tile<T, CO>(h + n * image, s + n * image, w, stage, ws, acc, C, H, W, cy0 * f,
                   cx0 * f, ncy * f, ncx * f, leaky != 0);

  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int o = 0; o < CO; ++o)
      stage[(o * kTH + ty * kRows + r) * kTW + tx] = tanhf(acc[r][o] + bias[o]);
  __syncthreads();

  const float inv = 1.f / static_cast<float>(f * f);
  const int cells = ncx * ncy;
  for (int task = threadIdx.x; task < cells * CO; task += kThreads) {
    const int o = task / cells;
    const int cell = task - o * cells;
    const int cy = cell / ncx, cx = cell - cy * ncx;
    const float* t = stage + (o * kTH + cy * f) * kTW + cx * f;
    float sum = 0.f;
    for (int i = 0; i < f; ++i)
      for (int j = 0; j < f; ++j) sum += t[i * kTW + j];
    out[((static_cast<size_t>(n) * CO + o) * hc + cy0 + cy) * wc + cx0 + cx] =
        from_f<T>(sum * inv);
  }
}

// f > 32: one cell per block, walked in kTH x kTW sub-tiles.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads, 2)
output_head_cell_kernel(const T* __restrict__ h, const T* __restrict__ s,
                        const float* __restrict__ w, const float* __restrict__ bias,
                        T* __restrict__ out, int C, int H, int W, int f, int leaky) {
  __shared__ __align__(16) float stage[kStageFloats];
  __shared__ __align__(16) float ws[2 * kCK * 9 * kCoMax];
  __shared__ float red[kWarps][CO];
  const int n = blockIdx.z;
  const int hc = H / f, wc = W / f;
  const size_t image = static_cast<size_t>(C) * H * W;
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float total[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) total[o] = 0.f;

  for (int sy = 0; sy < f; sy += kTH) {
    for (int sx = 0; sx < f; sx += kTW) {
      const int th = min(kTH, f - sy), tw = min(kTW, f - sx);
      float acc[kRows][CO];
      conv_tile<T, CO>(h + n * image, s + n * image, w, stage, ws, acc, C, H, W,
                       blockIdx.y * f + sy, blockIdx.x * f + sx, th, tw, leaky != 0);
      float part[CO];
#pragma unroll
      for (int o = 0; o < CO; ++o) part[o] = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (ty * kRows + r < th && tx < tw)
#pragma unroll
          for (int o = 0; o < CO; ++o) part[o] += tanhf(acc[r][o] + bias[o]);
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        float v = part[o];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
        if (lane == 0) red[warp][o] = v;
      }
      __syncthreads();
      if (threadIdx.x == 0)
        for (int k = 0; k < kWarps; ++k)
#pragma unroll
          for (int o = 0; o < CO; ++o) total[o] += red[k][o];
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    const float inv = 1.f / (static_cast<float>(f) * static_cast<float>(f));
#pragma unroll
    for (int o = 0; o < CO; ++o)
      out[((static_cast<size_t>(n) * CO + o) * hc + blockIdx.y) * wc + blockIdx.x] =
          from_f<T>(total[o] * inv);
  }
}

template <typename T, int CO>
int launch_co(const void* h, const void* s, const void* w, const void* b, void* out, int N,
              int C, int H, int W, int f, int leaky, cudaStream_t stream) {
  const int hc = H / f, wc = W / f;
  const T* hp = static_cast<const T*>(h);
  const T* sp = static_cast<const T*>(s);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  T* op = static_cast<T*>(out);
  if (f <= kTH) {
    const int cells_x = kTW / f, cells_y = kTH / f;
    const dim3 grid((wc + cells_x - 1) / cells_x, (hc + cells_y - 1) / cells_y, N);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    output_head_tile_kernel<T, CO><<<grid, kThreads, 0, stream>>>(
        hp, sp, wp, bp, op, C, H, W, f, cells_x, cells_y, leaky);
  } else {
    const dim3 grid(wc, hc, N);
    output_head_cell_kernel<T, CO><<<grid, kThreads, 0, stream>>>(
        hp, sp, wp, bp, op, C, H, W, f, leaky);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* h, const void* s, const void* w, const void* b, void* out, int N,
           int C, int H, int W, int co, int f, int leaky, void* stream) {
  if (N < 1 || N > 65535 || C < 1 || H < 2 || W < 2 || f < 1 || H % f || W % f ||
      static_cast<long long>(H) * W > 0x7fffffff)  // offsets in a plane are ints
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (co) {
    case 1: return launch_co<T, 1>(h, s, w, b, out, N, C, H, W, f, leaky, st);
    case 2: return launch_co<T, 2>(h, s, w, b, out, N, C, H, W, f, leaky, st);
    case 3: return launch_co<T, 3>(h, s, w, b, out, N, C, H, W, f, leaky, st);
    case 4: return launch_co<T, 4>(h, s, w, b, out, N, C, H, W, f, leaky, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// h, s [N, C, H, W] and out [N, co, H/f, W/f] contiguous, all of one type;
// w [C, 9, 4] f32 (tap-major, co padded to 4), b [co] f32; leaky != 0 picks
// LeakyReLU(0.1), else ReLU. Returns a cudaError_t code; 0 means launched.
extern "C" int fmi_output_head_f32(const void* h, const void* s, const void* w,
                                   const void* b, void* out, int N, int C, int H, int W,
                                   int co, int f, int leaky, void* stream) {
  return launch<float>(h, s, w, b, out, N, C, H, W, co, f, leaky, stream);
}

extern "C" int fmi_output_head_bf16(const void* h, const void* s, const void* w,
                                    const void* b, void* out, int N, int C, int H, int W,
                                    int co, int f, int leaky, void* stream) {
  return launch<__nv_bfloat16>(h, s, w, b, out, N, C, H, W, co, f, leaky, stream);
}
