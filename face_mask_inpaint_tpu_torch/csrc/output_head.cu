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
// (contiguous, one dtype T in {f32, bf16}), a weight w [co, C, 3, 3], a
// bias b [co] and an optional pair bias pb [C] (f32: the block's two
// transposed convs' biases, summed, which those convs leave to this kernel):
//     a   = act(h + s + pb)   (h + s) + pb[c] in f32, rounded once to T, and
//                             act rounded to T, as the TPU kernel adds and
//                             activates in the stream dtype; without pb the
//                             sum is h + s, the same bits as T's own add
//     y   = tanh(conv3x3(reflect_pad1(a), w) + b)   accumulated in f32
//     out = mean of y over each f x f cell -> [N, co, H/f, W/f], rounded to T
// act is LeakyReLU(0.1) or ReLU; co <= 4.
//
// What bounds it on an H100: at the flagship (N = 16, C = 32, H = W = 1024,
// co = 3, f = 4) it reads two maps once, 2.147 GB in bf16 (0.64 ms at
// 3.35 TB/s; 4.295 GB and 1.28 ms in f32), and does 29.0 GFLOP of
// multiply-adds (0.43 ms on the CUDA cores at 67 TFLOP/s; on the tensor
// cores, with co padded to 8, 77 GFLOP in 0.08 ms at 989 TFLOP/s). The
// output is 1/16 of a map per channel. So bytes bound it, once the products
// leave the CUDA cores.
//
// bf16, route "mma_sync" (W % 8 == 0, 16-byte aligned h and s, f a power of
// two up to 32; fmi_output_head_route): an implicit GEMM on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate, csrc/mma.cuh) with M = a tile
// of TH x 64 pixels (TH = 16, or 32 for f = 32, so that a tile holds whole
// cells), N = co padded to 8 and K = 9 C in chunks of 16 channels.
//   - A persistent grid, two blocks an SM (one for TH = 32), each walking
//     its tiles. The inputs arrive by TMA (a 4-d tensor map of each map,
//     csrc/wgmma.cuh) as raw units of 8 channels x (TH + 2) rows x 80
//     columns (x0 - 8 .. x0 + 71), zeros outside the image; as soon as a
//     unit has been staged its buffer is refilled with the next unit, so the
//     loads of one block run under its own and the other block's staging,
//     products and epilogue.
//   - Staging: each thread reads 8 channels of an 8-pixel run of h and of s
//     from the raw unit as 16-byte pieces, forms act(h + s) on bf16 pairs
//     with act_sum's roundings (a bf16 add rounds the exact sum once, as
//     act_sum's f32 add then rounding does; the value is exact in bf16, so
//     staging it there loses nothing), transposes the 8 x 8 block with byte
//     permutes and writes each pixel's 8 channels channel-innermost into the
//     staged tile, [TH + 2][66] pixels of 48 bytes, so that ldmatrix reads
//     8 pixels from 8 distinct bank groups. The one-pixel halo reflects at
//     the image border (row -1 reads row 1, column W reads column W - 2),
//     from rows and columns the raw unit holds.
//   - The chunk's weights, packed once per call by the wrapper as bf16
//     [9][c_pad][8], go beside the staged tile.
//   - The nine taps are nine shifted ldmatrix row addresses into the one
//     staged tile; each warp keeps 4 rows x 32 (TH = 16) or 64 (TH = 32)
//     pixels x 8 channels of f32 accumulators, and each A fragment it loads
//     feeds the three output rows that read it.
// The epilogue adds the bias and takes tanh in f32 into shared memory, then
// sums each f x f cell in a fixed order, as the CUDA-core kernel does: the
// result is deterministic. At the flagship it takes about 1.6 times its
// bytes bound; what holds it is in PERF.md (tools/output_head_variants.py).
//
// f32, ragged W, misaligned maps and f that is no power of two up to 32
// (one cell a block for f > 32) take the CUDA-core kernel, route
// "cuda_cores":
// one block owns whole f x f cells of one image, so no sum crosses
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
// In bf16 at the flagship this kernel ran at about a third of the bytes
// bound, held by instruction issue, not memory (PERF.md); in f32 it reaches
// about 70%.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

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

// The pair bias of a call without one, and of the channels past C: -0
// leaves every f32 sum as it is, -0 included. Rounding the f32 sum of two
// bf16 to bf16 gives their bf16 sum, rounded once (f32 holds more than
// twice bf16's precision), so the sum is T's own h + s.
constexpr float kNoBias = -0.f;

__device__ __forceinline__ float pair_bias(const float* __restrict__ pb, int c, int C) {
  return pb != nullptr && c < C ? __ldg(pb + c) : kNoBias;
}

// act(h + s + pb) with (h + s) + pb in f32, rounded once to T, and the
// activation rounded to T
template <typename T>
__device__ __forceinline__ float act_sum(T hv, T sv, float pb, bool leaky) {
  const float a = round_to<T>(__fadd_rn(__fadd_rn(to_f(hv), to_f(sv)), pb));
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

  // act(h + s + pb) of the loaded channels into one stage buffer, and the
  // chunk's weights (ws[ch][tap][o], zero past C and co) beside it
  template <int CO>
  __device__ __forceinline__ void store(float* stage, float* ws, const float* __restrict__ w,
                                        const float* __restrict__ pb, int c0, int C,
                                        bool leaky) const {
    float b[kCK];
#pragma unroll
    for (int ch = 0; ch < kCK; ++ch) b[ch] = pair_bias(pb, c0 + ch, C);
#pragma unroll
    for (int i = 0; i < kStageIters; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < kPlane)
#pragma unroll
        for (int ch = 0; ch < kCK; ++ch)
          stage[ch * kPlane + p] = act_sum<T>(hv[i][ch], sv[i][ch], b[ch], leaky);
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
                                          const float* __restrict__ w,
                                          const float* __restrict__ pb, float* stage,
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
  st.template store<CO>(stage, ws, w, pb, 0, C, leaky);
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
                            w, pb, c0 + kCK, C, leaky);
    __syncthreads();
  }
}

// f <= 32: the block's cells fit one sub-tile of cells_y x cells_x cells.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads, 2)
output_head_tile_kernel(const T* __restrict__ h, const T* __restrict__ s,
                        const float* __restrict__ w, const float* __restrict__ bias,
                        const float* __restrict__ pb, T* __restrict__ out, int C, int H,
                        int W, int f, int cells_x, int cells_y, int leaky) {
  __shared__ __align__(16) float stage[kStageFloats];
  __shared__ __align__(16) float ws[2 * kCK * 9 * kCoMax];
  const int n = blockIdx.z;
  const int hc = H / f, wc = W / f;
  const int cx0 = blockIdx.x * cells_x, cy0 = blockIdx.y * cells_y;
  const int ncx = min(cells_x, wc - cx0), ncy = min(cells_y, hc - cy0);
  const size_t image = static_cast<size_t>(C) * H * W;
  float acc[kRows][CO];
  conv_tile<T, CO>(h + n * image, s + n * image, w, pb, stage, ws, acc, C, H, W, cy0 * f,
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
                        const float* __restrict__ pb, T* __restrict__ out, int C, int H,
                        int W, int f, int leaky) {
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
      conv_tile<T, CO>(h + n * image, s + n * image, w, pb, stage, ws, acc, C, H, W,
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
int launch_co(const void* h, const void* s, const void* w, const void* b, const void* pb,
              void* out, int N, int C, int H, int W, int f, int leaky, cudaStream_t stream) {
  const int hc = H / f, wc = W / f;
  const T* hp = static_cast<const T*>(h);
  const T* sp = static_cast<const T*>(s);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const float* pbp = static_cast<const float*>(pb);
  T* op = static_cast<T*>(out);
  if (f <= kTH) {
    const int cells_x = kTW / f, cells_y = kTH / f;
    const dim3 grid((wc + cells_x - 1) / cells_x, (hc + cells_y - 1) / cells_y, N);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    output_head_tile_kernel<T, CO><<<grid, kThreads, 0, stream>>>(
        hp, sp, wp, bp, pbp, op, C, H, W, f, cells_x, cells_y, leaky);
  } else {
    const dim3 grid(wc, hc, N);
    output_head_cell_kernel<T, CO><<<grid, kThreads, 0, stream>>>(
        hp, sp, wp, bp, pbp, op, C, H, W, f, leaky);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* h, const void* s, const void* w, const void* b, const void* pb,
           void* out, int N, int C, int H, int W, int co, int f, int leaky, void* stream) {
  if (N < 1 || N > 65535 || C < 1 || H < 2 || W < 2 || f < 1 || H % f || W % f ||
      static_cast<long long>(H) * W > 0x7fffffff)  // offsets in a plane are ints
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (co) {
    case 1: return launch_co<T, 1>(h, s, w, b, pb, out, N, C, H, W, f, leaky, st);
    case 2: return launch_co<T, 2>(h, s, w, b, pb, out, N, C, H, W, f, leaky, st);
    case 3: return launch_co<T, 3>(h, s, w, b, pb, out, N, C, H, W, f, leaky, st);
    case 4: return launch_co<T, 4>(h, s, w, b, pb, out, N, C, H, W, f, leaky, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores (route "mma_sync", see the header): an implicit
// GEMM with M = a TH x 64 pixel tile, N = co padded to 8, K = 9 C in chunks
// of 16 channels, fed by TMA.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaCK = 16;          // channels a chunk: one k16 step a tap
constexpr int kMmaTW = 64;          // tile columns
constexpr int kUnitC = 8;           // channels a raw unit: half a chunk
constexpr int kRawW = kMmaTW + 16;  // raw row: columns x0 - 8 .. x0 + 71, 160 bytes

// A tile of TH rows (16, or 32 for f = 32) x 64 columns; a warp keeps RW = 4
// rows x CB column blocks of 16 pixels (the 8 warps as TH / 4 row groups of
// WG warps each)
template <int TH_>
struct MmaCfg {
  static constexpr int TH = TH_;
  static constexpr int TW = kMmaTW;
  static constexpr int RW = 4;
  static constexpr int WG = kWarps / (TH / RW);  // warps a row group
  static constexpr int CB = TW / 16 / WG;        // 16-pixel column blocks a warp
  static constexpr int MT = RW * CB;             // m16 tiles a warp keeps
  static_assert(WG * (TH / RW) == kWarps && CB * WG * 16 == TW, "8 warps cover the tile");
  static constexpr int SH = TH + 2, SW = TW + 2;
  static constexpr int CK = kMmaCK;
  static constexpr int SP = CK + 8;               // staged pixel stride: 48 bytes
  static constexpr int NBUF = 1;                  // raw units in flight a block
  static constexpr int kRaw = kUnitC * SH * kRawW;  // bf16 of one map's raw unit
  static constexpr int kStage = SH * SW * SP;       // bf16
  static constexpr int kW = 9 * CK * 8;             // bf16: [tap][channel][8 outputs]
  static constexpr size_t kRawBytes = sizeof(bf16) * 2 * NBUF * kRaw;
  static constexpr size_t kStageBytes = sizeof(bf16) * kStage > sizeof(float) * kCoMax * TH * TW
                                            ? sizeof(bf16) * kStage
                                            : sizeof(float) * kCoMax * TH * TW;
  static constexpr size_t kSmem =
      kRawBytes + kStageBytes + sizeof(bf16) * kW + sizeof(uint64_t) * NBUF;
  static_assert(sizeof(bf16) * kRaw % 128 == 0 && kStageBytes % 16 == 0, "TMA and 16-byte alignment");
};

// act(h + s + pb) of two bf16 pairs of one channel, with act_sum's
// roundings: (h + s) + pb in f32, rounded once to bf16; LeakyReLU is
// max(a, round(0.1 a)) with 0.1 a taken in f32, which is a for a >= 0 and
// round(0.1 a) below; ReLU is max(a, 0)
template <bool LEAKY>
__device__ __forceinline__ unsigned act_sum2(unsigned h, unsigned s, float pb) {
  const unsigned aw = fmi_mma::pack_bf16(
      __fadd_rn(__fadd_rn(__uint_as_float(h << 16), __uint_as_float(s << 16)), pb),
      __fadd_rn(__fadd_rn(__uint_as_float(h & 0xffff0000u), __uint_as_float(s & 0xffff0000u)),
                pb));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&aw);
  __nv_bfloat162 r;
  if constexpr (LEAKY) {
    const unsigned rw = fmi_mma::pack_bf16(__uint_as_float(aw << 16) * 0.1f,
                                           __uint_as_float(aw & 0xffff0000u) * 0.1f);
    r = *reinterpret_cast<const __nv_bfloat162*>(&rw);
  } else {
    r = __float2bfloat162_rn(0.f);
  }
  const __nv_bfloat162 y = __hmax2(a, r);
  return *reinterpret_cast<const unsigned*>(&y);
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Stage channels [8 half, 8 half + 8) of the chunk: act(h + s) of the raw
// unit rh, rs ([8][SH][80] bf16 each, image rows y0 - 1 .. y0 + TH and
// columns x0 - 8 .. x0 + 71 as TMA left them, zeros outside the image) into
// the staged tile [SH][SW][SP], channel-innermost, its halo reflected (row
// -1 reads row 1, row H row H - 2, column -1 column 1, column W column
// W - 2, all of which the raw unit holds); with half 0, also the chunk's
// weights into ws [9][16][8]; pb [C] f32 (or null) is added to each
// channel's sum.
template <int TH, bool LEAKY>
__device__ __forceinline__ void stage_unit(const bf16* rh, const bf16* rs, bf16* stage, bf16* ws,
                                           const bf16* __restrict__ wp,
                                           const float* __restrict__ pb, int half, int c0,
                                           int C, int c_pad, int H, int W, int y0, int x0) {
  using Cfg = MmaCfg<TH>;
  constexpr int SH = Cfg::SH, SW = Cfg::SW, SP = Cfg::SP, CK = Cfg::CK, TW = Cfg::TW;
  constexpr int kRunSlots = 32 * ((SH + 3) / 4);  // (4-row group, 8-pixel run) slots
  const int tid = threadIdx.x;
  float b[8];  // the unit's channels' pair bias
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = pair_bias(pb, c0 + 8 * half + k, C);
  // the raw row that staged row r reads
  auto raw_row = [&](int r) {
    const int y = y0 - 1 + r;
    return y < 0 ? r + 2 : (y == H ? r - 2 : r);
  };
  // The 64 columns of the tile: a thread reads 8 channels of an 8-pixel run
  // of h and of s as 16-byte pieces, forms act(h + s) on bf16 pairs and
  // transposes the 8 x 8 block with byte permutes into one 16-byte store a
  // pixel. Slot u: lanes 2k, 2k + 1 take adjacent runs, the 8 lanes of a
  // store phase take four rows, so they hit four distinct bank groups
  // (48-byte pixels) where eight runs of one row would all hit one, and
  // their reads of the raw unit (160-byte rows) hit eight.
  for (int u = tid; u < kRunSlots; u += kThreads) {
    const int j = ((u >> 3) & 3) * 2 + (u & 1), r = (u >> 5) * 4 + ((u >> 1) & 3);
    if (r >= SH) continue;
    const int rr = raw_row(r), xx = x0 + 8 * j;
    uint4 hv[8], sv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      hv[k] = *reinterpret_cast<const uint4*>(rh + (k * SH + rr) * kRawW + 8 + 8 * j);
      sv[k] = *reinterpret_cast<const uint4*>(rs + (k * SH + rr) * kRawW + 8 + 8 * j);
    }
    if (xx == W) {  // column W, the halo past the image: column W - 2
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        hv[k].x = __bfloat16_as_ushort(rh[(k * SH + rr) * kRawW + W - x0 + 6]);
        sv[k].x = __bfloat16_as_ushort(rs[(k * SH + rr) * kRawW + W - x0 + 6]);
      }
    }
    unsigned a[8][4];  // channel k, pixels 2i and 2i + 1
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[k][i] = act_sum2<LEAKY>(word(hv[k], i), word(sv[k], i), b[k]);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const unsigned sel = p & 1 ? 0x7632u : 0x5410u;  // the pixel's half of each word
      *reinterpret_cast<uint4*>(stage + (r * SW + 1 + 8 * j + p) * SP + half * 8) =
          make_uint4(__byte_perm(a[0][p / 2], a[1][p / 2], sel),
                     __byte_perm(a[2][p / 2], a[3][p / 2], sel),
                     __byte_perm(a[4][p / 2], a[5][p / 2], sel),
                     __byte_perm(a[6][p / 2], a[7][p / 2], sel));
    }
  }
  // the halo columns x0 - 1 and x0 + 64 of each staged row, on the threads
  // after the runs'
  const int e = tid - (kRunSlots < kThreads ? kRunSlots : 0);
  if (e >= 0 && e < 2 * SH) {
    const int side = e % 2, r = e / 2, rr = raw_row(r);
    const int col = side ? x0 + TW : x0 - 1;
    const int rc = (col < 0 ? 1 : (col == W ? W - 2 : col)) - (x0 - 8);
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = act_sum<bf16>(rh[(k * SH + rr) * kRawW + rc], rs[(k * SH + rr) * kRawW + rc], b[k],
                           LEAKY);
    *reinterpret_cast<uint4*>(stage + (r * SW + (side ? SW - 1 : 0)) * SP + half * 8) =
        make_uint4(fmi_mma::pack_bf16(v[0], v[1]), fmi_mma::pack_bf16(v[2], v[3]),
                   fmi_mma::pack_bf16(v[4], v[5]), fmi_mma::pack_bf16(v[6], v[7]));
  }
  if (half == 0)
    for (int i = (tid + 9 * CK) % kThreads; i < 9 * CK; i += kThreads) {  // tap * CK + channel
      const int tap = i / CK, ch = i - tap * CK;
      *reinterpret_cast<uint4*>(ws + i * 8) = __ldg(reinterpret_cast<const uint4*>(
          wp + (static_cast<size_t>(tap) * c_pad + c0 + ch) * 8));
    }
}

// h, s: 4-d tensor maps of [N, C, H, W] bf16 (W % 8 == 0) with [1][8][SH][80]
// boxes, zeros outside; wp [9][c_pad][8] bf16 (tap ky * 3 + kx, input
// channel, output channel; zero past C and co); bias [co] f32; pb [C] f32
// added to each channel's h + s, or null; out [N, co, H/f, W/f] bf16; f a power of two, f <= TH. A persistent grid: block b takes
// tiles b, b + gridDim.x, ...; each tile's channels arrive as raw units of 8,
// NBUF in flight, each refilled by TMA as soon as it has been staged, so the
// loads run under the staging, the products and the epilogue.
template <int TH_, bool LEAKY>
__global__ void __launch_bounds__(kThreads, TH_ == 16 ? 2 : 1)
output_head_mma_kernel(const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap smap, const bf16* __restrict__ wp,
                       const float* __restrict__ bias, const float* __restrict__ pb,
                       bf16* __restrict__ out, int N, int C, int c_pad, int H, int W, int co,
                       int f) {
  using namespace fmi_mma;
  using namespace fmi_wgmma;
  using Cfg = MmaCfg<TH_>;
  constexpr int MT = Cfg::MT, TH = Cfg::TH, TW = Cfg::TW, SW = Cfg::SW, SP = Cfg::SP,
                CK = Cfg::CK, CB = Cfg::CB, RW = Cfg::RW, NBUF = Cfg::NBUF, kRaw = Cfg::kRaw;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* raw = reinterpret_cast<bf16*>(smem_raw);  // [NBUF][h, s][kRaw]
  bf16* stage = raw + 2 * NBUF * kRaw;             // [SH * SW][SP]; the tanh tile at the end
  bf16* ws = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(stage) + Cfg::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + Cfg::kW);  // [NBUF]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wrow = warp / Cfg::WG * RW, wcol = warp % Cfg::WG * CB * 16;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int tiles = tiles_x * tiles_y * N, chunks = c_pad / CK;
  const int my_tiles =
      tiles > static_cast<int>(blockIdx.x) ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int units = my_tiles * chunks * 2;
  // unit i: the block's tile i / (2 chunks), channels 8 (i % (2 chunks))
  auto tile_of = [&](int i, int& n, int& y0, int& x0) {
    const int tt = blockIdx.x + i / (2 * chunks) * gridDim.x;
    x0 = tt % tiles_x * TW;
    y0 = tt / tiles_x % tiles_y * TH;
    n = tt / (tiles_x * tiles_y);
  };
  auto issue = [&](int i) {
    int n, y0, x0;
    tile_of(i, n, y0, x0);
    const int b = i % NBUF, c = i % (2 * chunks) * kUnitC;
    mbar_expect_tx(&full[b], 2 * kRaw * static_cast<unsigned>(sizeof(bf16)));
    tma_load_4d(raw + 2 * b * kRaw, &hmap, &full[b], x0 - 8, y0 - 1, c, n);
    tma_load_4d(raw + (2 * b + 1) * kRaw, &smap, &full[b], x0 - 8, y0 - 1, c, n);
  };
  if (tid == 0) {
    for (int b = 0; b < NBUF; ++b) mbar_init(&full[b], 1);
    mbar_fence_init();
    for (int i = 0; i < NBUF && i < units; ++i) issue(i);
  }
  __syncthreads();

  float acc[MT][4];  // m16 tile mt: output row wrow + mt / CB, columns wcol + (mt % CB) * 16 ..
  for (int i = 0; i < units; ++i) {
    const int rem = i % (2 * chunks), chunk = rem / 2, half = rem % 2;
    int n, y0, x0;
    tile_of(i, n, y0, x0);
    if (rem == 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    const int b = i % NBUF;
    mbar_wait(&full[b], (i / NBUF) & 1);
    stage_unit<TH, LEAKY>(raw + 2 * b * kRaw, raw + (2 * b + 1) * kRaw, stage, ws, wp, pb, half,
                          chunk * CK, C, c_pad, H, W, y0, x0);
    __syncthreads();  // the raw unit is staged: refill it
    if (tid == 0 && i + NBUF < units) {
      fence_proxy_async();
      issue(i + NBUF);
    }
    if (half == 0) continue;

    unsigned bw[9][2];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) ldmatrix_x2_trans(bw[tap], ws + (tap * CK + (lane & 15)) * 8);
    // a tap is a shift of the staged tile: a row address per lane. Each A
    // fragment (staged row R, shifted kx) feeds the three output rows R - ky
    // that read it, so a warp loads RW + 2 rows of fragments, not 3 RW.
#pragma unroll
    for (int R = 0; R < RW + 2; ++R)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          unsigned a[4];
          ldmatrix_x4(a, stage + ((wrow + R) * SW + wcol + cb * 16 + (lane & 15) + kx) * SP +
                             (lane >> 4) * 8);
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
            if (R - ky >= 0 && R - ky < RW)
              mma_bf16(acc[(R - ky) * CB + cb], a, bw[ky * 3 + kx][0], bw[ky * 3 + kx][1]);
        }
    __syncthreads();  // every warp is done with the stage and the weights
    if (chunk < chunks - 1) continue;

    // bias and tanh in f32 into a [co][TH][TW] tile over the stage, then
    // each f x f cell summed in a fixed order
    float* ot = reinterpret_cast<float*>(stage);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = 2 * t + (e & 1);
        if (ch < co) {
          const int row = wrow + mt / CB;
          const int col = wcol + (mt % CB) * 16 + g + 8 * (e >> 1);
          ot[(ch * TH + row) * TW + col] = tanhf(acc[mt][e] + bias[ch]);
        }
      }
    __syncthreads();
    const int hc = H / f, wc = W / f;
    const int cells_x = TW / f, cells_y = TH / f;
    const int cx0 = x0 / f, cy0 = y0 / f;
    const int ncx = min(cells_x, wc - cx0), ncy = min(cells_y, hc - cy0);
    const int cells = ncx * ncy;
    const float inv = 1.f / static_cast<float>(f * f);
    for (int task = tid; task < cells * co; task += kThreads) {
      const int o = task / cells;
      const int cell = task - o * cells;
      const int cy = cell / ncx, cx = cell - cy * ncx;
      const float* tp = ot + (o * TH + cy * f) * TW + cx * f;
      float sum = 0.f;
      for (int ii = 0; ii < f; ++ii)
        for (int jj = 0; jj < f; ++jj) sum += tp[ii * TW + jj];
      out[((static_cast<size_t>(n) * co + o) * hc + cy0 + cy) * wc + cx0 + cx] =
          __float2bfloat16(sum * inv);
    }
    __syncthreads();  // the next tile stages over the tanh tile
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool pow2_upto32(int f) { return f >= 1 && f <= 32 && (f & (f - 1)) == 0; }

// [N, C, H, W] bf16 as a 4-d map of [1][8][sh][80] boxes; elements outside
// the map read as zeros
bool head_map(CUtensorMap* map, const void* base, int N, int C, int H, int W, int sh) {
  const fmi_wgmma::EncodeTiled encode = fmi_wgmma::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(W) * 2,
                                 static_cast<cuuint64_t>(W) * 2 * H,
                                 static_cast<cuuint64_t>(W) * 2 * H * C};
  const cuuint32_t box[4] = {kRawW, static_cast<cuuint32_t>(sh), kUnitC, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TH, bool LEAKY>
int launch_mma(const void* h, const void* s, const void* wp, const void* b, const void* pb,
               void* out, int N, int C, int c_pad, int H, int W, int co, int f,
               cudaStream_t stream) {
  using Cfg = MmaCfg<TH>;
  CUtensorMap hmap, smap;
  if (!head_map(&hmap, h, N, C, H, W, Cfg::SH) || !head_map(&smap, s, N, C, H, W, Cfg::SH))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(output_head_mma_kernel<TH, LEAKY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Cfg::kSmem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, output_head_mma_kernel<TH, LEAKY>, kThreads, Cfg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = static_cast<long long>((W + Cfg::TW - 1) / Cfg::TW) *
                          ((H + Cfg::TH - 1) / Cfg::TH) * N;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  output_head_mma_kernel<TH, LEAKY><<<grid, kThreads, Cfg::kSmem, stream>>>(
      hmap, smap, static_cast<const bf16*>(wp), static_cast<const float*>(b),
      static_cast<const float*>(pb), static_cast<bf16*>(out), N, C, c_pad, H, W, co, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h, s [N, C, H, W] and out [N, co, H/f, W/f] contiguous, all of one type;
// w [C, 9, 4] f32 (tap-major, co padded to 4), b [co] f32; pb [C] f32 added
// to h + s, or null; leaky != 0 picks LeakyReLU(0.1), else ReLU. Returns a
// cudaError_t code; 0 means launched.
extern "C" int fmi_output_head_f32(const void* h, const void* s, const void* w,
                                   const void* b, const void* pb, void* out, int N, int C,
                                   int H, int W, int co, int f, int leaky, void* stream) {
  return launch<float>(h, s, w, b, pb, out, N, C, H, W, co, f, leaky, stream);
}

extern "C" int fmi_output_head_bf16(const void* h, const void* s, const void* w,
                                    const void* b, const void* pb, void* out, int N, int C,
                                    int H, int W, int co, int f, int leaky, void* stream) {
  return launch<__nv_bfloat16>(h, s, w, b, pb, out, N, C, H, W, co, f, leaky, stream);
}

// Which kernel takes a call: 1 the tensor-core kernel ("mma_sync": bf16,
// W % 8 == 0, 16-byte aligned h and s, f a power of two up to 32), 0 the
// CUDA-core one. kernels/output_head.py `output_head_route` says the same.
extern "C" int fmi_output_head_route(int is_bf16, const void* h, const void* s, int W, int f) {
  return is_bf16 && W % 8 == 0 && aligned16(h) && aligned16(s) && pow2_upto32(f) ? 1 : 0;
}

// The "mma_sync" route: as fmi_output_head_bf16 (pb too), but w is bf16 [9][c_pad][8]
// (tap ky * 3 + kx, input channel, output channel; zero past C and co;
// c_pad = C rounded up to 16) and 16-byte aligned.
extern "C" int fmi_output_head_bf16_mma(const void* h, const void* s, const void* w,
                                        const void* b, const void* pb, void* out, int N, int C,
                                        int c_pad, int H, int W, int co, int f, int leaky,
                                        void* stream) {
  if (N < 1 || N > 65535 || C < 1 || c_pad % kMmaCK || c_pad < C || c_pad >= C + kMmaCK ||
      H < 2 || co < 1 || co > kCoMax || H % f || W % f ||
      !fmi_output_head_route(1, h, s, W, f) || !aligned16(w) ||
      static_cast<long long>(H) * W > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f == 32)
    return leaky ? launch_mma<32, true>(h, s, w, b, pb, out, N, C, c_pad, H, W, co, f, st)
                 : launch_mma<32, false>(h, s, w, b, pb, out, N, C, c_pad, H, W, co, f, st);
  return leaky ? launch_mma<16, true>(h, s, w, b, pb, out, N, C, c_pad, H, W, co, f, st)
               : launch_mma<16, false>(h, s, w, b, pb, out, N, C, c_pad, H, W, co, f, st);
}
