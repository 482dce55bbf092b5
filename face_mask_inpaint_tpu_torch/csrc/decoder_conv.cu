// The fused decoder tail of the PICNet generator: kernels K4b and K4a.
//
// Replaces: face_mask_inpaint_tpu/ops/pallas/packed_convt.py:444
// `packed_conv3x3_stats` (`_conv3_kernel`, pallas_call at :526) and
// packed_convt.py:247 `packed_convt_pair` (`_convt_kernel`, pallas_call at
// :333). The TPU kernels work on a space-to-depth packed map, where the
// column axis folds into channels; these work on the dense NCHW map, so the
// packing and its slot-row stencils are gone and only the arithmetic stays.
//
// K4b, one decoder block's first conv:
//     h = conv3x3_s1_p1(pro(x), w) + b
// K4a, the block's upsampling pair, summed over one or two input streams:
//     y = sum_s convT_k3_s2_p1_op1(pro_s(x_s), w_s) + sum_s b_s
// with an optional prologue per stream, pro(x)[n, c] = act(x * A[n, c] +
// B[n, c]) (the previous stage's instance-norm affine, then LeakyReLU(0.1)
// or ReLU), computed in f32 and rounded to the stream type T in {f32, bf16},
// as the TPU kernels round it (packed_convt.py:121-123, :394-395). The conv's
// zero padding, and the zero of the convT's output_padding, are written
// after the prologue. Weights arrive in f32 already rounded to T; products
// accumulate in f32, the bias is added in f32, the per-(n, co) sums of y and
// y^2 are taken from that f32 value, and then the optional activation and
// one rounding to T follow (packed_convt.py:214-217, :438-441).
//
// ConvT per axis: out[o] = sum_k w[k] x[(o + 1 - k) / 2] over the k for
// which the division is exact. Even o = 2m reads k = 1 at m; odd o = 2m + 1
// reads k = 0 at m + 1 and k = 2 at m. Index m + 1 = H is the zero of
// output_padding. One input position (m, n) thus feeds its four output
// parities through the nine taps, each tap once.
//
// What bounds them on an H100 (bf16, batch 16, the flagship's decoders 3 and
// 4): per call 155 (K4b) or 232 (K4a) GFLOP against 0.40-1.88 GB of traffic,
// i.e. 120-380 FLOP a byte. On the tensor cores (989 TFLOP/s) the bound is
// 0.16-0.56 ms, set by bytes for three of the four calls; on the CUDA cores
// (67 TFLOP/s f32 FMA) no kernel can go below 2.3-3.5 ms a call.
//
// K4b in bf16 (W % 8 == 0, 16-byte aligned maps; fmi_conv3x3_route) is an
// implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate): M = a tile of TH x 64 output pixels (TH = 4 for 64 output
// channels, else 8), N = all COP output channels of the block, K = 9 C in
// chunks of 16 input channels. Per chunk:
//   - cp.async copies the chunk's raw NCHW rows y0 - 1 .. y0 + TH (16-byte
//     pieces, zeros outside the image) and its weights, packed once per call
//     by the wrapper as bf16 [9][c_pad][co_pad], into the other half of a
//     double buffer while the current chunk computes (cp.async cannot apply
//     the prologue);
//   - an in-shared-memory pass applies the prologue (specialised on its
//     activation) and writes the tile and its one-pixel halo channel-
//     innermost, [TH + 2][66][16] with 48-byte pixel rows, so that ldmatrix
//     reads 8 pixels from 8 distinct bank groups; the zero halo is written
//     after the prologue;
//   - the nine taps are nine shifted row addresses into that one staged
//     tile: ldmatrix takes a row address per lane, so im2col costs nothing.
//     8 warps each keep 32 or 64 pixels x COP channels of f32 accumulators;
//     2 blocks an SM overlap one block's staging with the other's products.
// The epilogue adds the bias, takes the per-(n, co) sums of y and y^2 from
// the f32 fragments (shuffles over the fragment rows, then the 8 warps in a
// fixed order into the [N, Co, tiles] partials: deterministic, no atomics),
// applies the activation, rounds once and stores through shared memory so
// that each channel row leaves in 16-byte pieces, 128 bytes a tile row.
//
// K4a in bf16 (W % 8 == 0, 16-byte aligned maps; fmi_convt_pair_route) is
// the same machinery as four implicit GEMMs, one per output parity, over
// one staged tile of input pixels (see its section): each of the nine taps
// is one shifted ldmatrix address into the tile and feeds one parity. A
// warp keeps all four parities of its pixels, 128 f32 accumulators a thread
// at 32 and 64 output channels, so one block of 8 warps fills an SM and the
// staging pass, the copies and the epilogue are not overlapped by a second
// block. At the flagship it took 1.7 + 1.9 ms for decoders 3 + 4 (about 130
// TFLOP/s; cuDNN's two transposed convs and their sum 4.6 + 9.5 ms, on an
// H100 SXM at 700 W): it is bound neither by bytes nor by the tensor cores
// but by that unoverlapped work (tools/tensor_core_variants.py).
//
// K4b in f32 (W % 4 == 0, 16-byte aligned maps; fmi_conv3x3_route) runs the
// same implicit GEMM on the tensor cores in split precision (3xTF32 on
// mma.sync m16n8k8, csrc/mma.cuh): 8-channel chunks (one k8 step a tap), the
// input split into tf32 hi and lo tiles once, by the staging pass that
// applies the prologue, and the weights split once a call by the wrapper and
// packed N-major, [2][9][co_pad][c_pad] (there is no transposed ldmatrix for
// 32-bit data), with 48-byte rows so that 8-row ldmatrix reads are
// conflict-free. Each chunk's products go to zeroed fragments that are then
// added to the f32 totals with one rounded add. Two f32 sets of accumulators
// (a warp keeps 32 pixels x 64 channels or 64 x 32) leave one block of 8
// warps an SM, so its staging pass is not overlapped by a second block. At
// the flagship's decoders 3 and 4 (f32, batch 16: 309 GFLOP, 928 of them
// TF32 products) the bound is 1.87 ms by the tensor cores' TF32 rate; what
// it reaches is in PERF.md (tools/tensor_core_variants.py times it without
// two of its three products and with its sums added in place).
//
// K4a in f32 (W % 4 == 0, 16-byte aligned maps; fmi_convt_pair_route) runs
// its four parity GEMMs on the tensor cores in split precision as K4b's f32
// route runs its one: 8-channel chunks, hi and lo tiles staged with the
// stream's prologue, the weights split and packed [2][9][co_pad][c_pad] a
// stream by the wrapper, each chunk's products of a parity in a zeroed
// fragment added to that parity's f32 totals with one rounded add. The
// four parities' totals fill 128 registers a thread, so a warp takes its
// parities one after another, one partial set live, and a block takes at
// most 32 output channels (see its section). At the flagship's decoders 3
// and 4 (f32, batch 16: 464 GFLOP, 1392 of them TF32 products) the bound is
// 2.81 ms by the tensor cores' TF32 rate; what it reaches, and what holds it
// back, is in PERF.md (tools/tensor_core_variants.py).
//
// K4b and K4a on maps their routes reject run on the CUDA cores:
//   - a block of 256 threads owns a tile of output pixels for up to 64
//     output channels, so each input byte is read from device memory about
//     once per 64 output channels (more than 64 split into channel blocks);
//   - the input tile and its one-pixel halo are staged in shared memory in
//     chunks of input channels, with the prologue applied while staging, and
//     the chunk's weights beside them;
//   - each thread keeps 64 f32 accumulators: 8 output channels times 8 rows
//     of one column (K4b), or times 2 input rows and 4 parities (K4a). A warp
//     spans 32 columns of one channel group, so a weight read is one
//     broadcast and input reads hit 32 banks;
//   - per-block partial sums of y and y^2 go to a [N, Co, tiles] buffer that
//     the caller sums: no atomics, so the stats are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 32;   // tile columns: one warp across them
constexpr int kCPT = 8;   // output channels a thread keeps
constexpr int kCoMax = 64;

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

// act: 0 none, 1 ReLU, 2 LeakyReLU(0.1)
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return v >= 0.f ? v : 0.f;
  if (act == 2) return v >= 0.f ? v : v * 0.1f;
  return v;
}

// One input stream: x [N, C, H, W] of type T, weights [C, 9, co_pad] f32
// (tap-major, ky * 3 + kx), and the prologue: A, B [N, C] f32 and its
// activation, or pro < 0 for none.
struct Stream {
  const void* x;
  const float* w;
  const float* A;
  const float* B;
  int C;
  int pro;
};

struct Streams {
  Stream s[2];
  int count;
};

// Stage channels [c0, c0 + ck) of one image's rows [y0, y0 + sh) and columns
// [x0, x0 + sw) into stage[ck][sh][sw] as f32, with the prologue applied and
// zeros outside the image (written after the prologue); and the chunk's
// weights for output channels [co0, co0 + COP) into ws[ck][9][COP].
template <typename T, int COP>
__device__ __forceinline__ void stage_chunk(const Stream& st, int n, int c0, int ck, int H,
                                            int W, int y0, int x0, int sh, int sw, int co0,
                                            int co_pad, float* stage, float* ws) {
  const T* xn = static_cast<const T*>(st.x) + static_cast<size_t>(n) * st.C * H * W;
  const int plane = sh * sw;
  for (int i = threadIdx.x; i < ck * plane; i += kThreads) {
    const int ch = i / plane;
    const int p = i - ch * plane;
    const int r = p / sw;
    const int y = y0 + r, x = x0 + (p - r * sw);
    const int c = c0 + ch;
    float v = 0.f;
    if (c < st.C && y >= 0 && y < H && x >= 0 && x < W) {
      v = to_f(xn[static_cast<size_t>(c) * H * W + y * W + x]);
      if (st.pro >= 0) {
        const int k = n * st.C + c;
        // two roundings, no fused multiply-add: x * A, then + B
        v = round_to<T>(apply_act(__fadd_rn(__fmul_rn(v, st.A[k]), st.B[k]), st.pro));
      }
    }
    stage[i] = v;
  }
  for (int i = threadIdx.x; i < ck * 9 * COP; i += kThreads) {
    const int ch = i / (9 * COP);
    const int rest = i - ch * 9 * COP;
    const int tap = rest / COP;
    const int c = c0 + ch;
    ws[i] = c < st.C ? st.w[(static_cast<size_t>(c) * 9 + tap) * co_pad + co0 + rest % COP]
                     : 0.f;
  }
}

// Bias, stats and the store of one thread's NP output pixels for its kCPT
// channels. vals[p][o] holds the pre-bias f32 sums; valid[p] says whether
// pixel p lies inside the output, offs[p] its offset in an output plane.
// The block's partial sums of y and y^2 per channel are written to
// psum/psq[(n * Co + co) * tiles + tile] when psum is not null.
template <typename T, int COP, int NP>
__device__ __forceinline__ void epilogue(float (&vals)[NP][kCPT], const bool (&valid)[NP],
                                         const size_t (&offs)[NP], const float* __restrict__ bias,
                                         T* __restrict__ out, float* __restrict__ psum,
                                         float* __restrict__ psq, int n, int co0, int Co,
                                         size_t out_plane, int act, float* red) {
  constexpr int G = COP / kCPT;
  constexpr int TY = kWarps / G;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = warp % G, ty = warp / G;
  float s1[kCPT], s2[kCPT];
#pragma unroll
  for (int o = 0; o < kCPT; ++o) {
    s1[o] = 0.f;
    s2[o] = 0.f;
    const int co = co0 + g * kCPT + o;
    const float b = bias[co0 + g * kCPT + o];  // bias is padded to co_pad
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float y = vals[p][o] + b;
      if (valid[p] && co < Co) {
        s1[o] += y;
        s2[o] += y * y;
        out[(static_cast<size_t>(n) * Co + co) * out_plane + offs[p]] =
            from_f<T>(apply_act(y, act));
      }
    }
  }
  if (psum == nullptr) return;
  // warp sums over the 32 columns, then the TY warps of one channel group in
  // a fixed order
  float* r1 = red;
  float* r2 = red + TY * COP;
#pragma unroll
  for (int o = 0; o < kCPT; ++o) {
    float a = s1[o], b = s2[o];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, m);
      b += __shfl_xor_sync(0xffffffffu, b, m);
    }
    if (lane == 0) {
      r1[ty * COP + g * kCPT + o] = a;
      r2[ty * COP + g * kCPT + o] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < COP) {
    const int co = co0 + threadIdx.x;
    float a = 0.f, b = 0.f;
    for (int t = 0; t < TY; ++t) {
      a += r1[t * COP + threadIdx.x];
      b += r2[t * COP + threadIdx.x];
    }
    if (co < Co) {
      const int tiles = gridDim.x * gridDim.y;
      const size_t k = (static_cast<size_t>(n) * Co + co) * tiles + blockIdx.y * gridDim.x +
                       blockIdx.x;
      psum[k] = a;
      psq[k] = b;
    }
  }
}

// ---------------------------------------------------------------------------
// K4b: 3x3 stride-1 conv, zero pad 1. Tile: TH = TY * 8 rows x 32 columns of
// output; a thread owns 8 rows of one column for 8 output channels.
// ---------------------------------------------------------------------------

template <int COP>
struct Conv3Cfg {
  static constexpr int G = COP / kCPT;
  static constexpr int TY = kWarps / G;
  static constexpr int RP = 8;
  static constexpr int TH = TY * RP;
  static constexpr int SH = TH + 2, SW = kTX + 2;
  static constexpr int CK = COP == 8 ? 4 : 8;  // keeps the stage under 48 KB
};

template <typename T, int COP>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(Stream st, const float* __restrict__ bias, T* __restrict__ out,
               float* __restrict__ psum, float* __restrict__ psq, int H, int W, int Co,
               int co_blocks, int co_pad, int act) {
  using Cfg = Conv3Cfg<COP>;
  constexpr int G = Cfg::G, RP = Cfg::RP, SH = Cfg::SH, SW = Cfg::SW, CK = Cfg::CK;
  __shared__ __align__(16) float stage[CK * SH * SW];
  __shared__ __align__(16) float ws[CK * 9 * COP];
  __shared__ float red[2 * Cfg::TY * COP];

  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * COP;
  const int y0 = blockIdx.y * Cfg::TH, x0 = blockIdx.x * kTX;
  const int tx = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = warp % G, ty = warp / G;

  float acc[RP][kCPT];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int o = 0; o < kCPT; ++o) acc[r][o] = 0.f;

  for (int c0 = 0; c0 < st.C; c0 += CK) {
    stage_chunk<T, COP>(st, n, c0, CK, H, W, y0 - 1, x0 - 1, SH, SW, co0, co_pad, stage, ws);
    __syncthreads();
    const int nch = min(CK, st.C - c0);
    for (int ch = 0; ch < nch; ++ch) {
      const float* sb = stage + ch * SH * SW + ty * RP * SW + tx;
      const float* wb = ws + ch * 9 * COP + g * kCPT;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float wr[3][kCPT];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4 a = *reinterpret_cast<const float4*>(wb + (ky * 3 + kx) * COP);
          const float4 b = *reinterpret_cast<const float4*>(wb + (ky * 3 + kx) * COP + 4);
          wr[ky][0] = a.x; wr[ky][1] = a.y; wr[ky][2] = a.z; wr[ky][3] = a.w;
          wr[ky][4] = b.x; wr[ky][5] = b.y; wr[ky][6] = b.z; wr[ky][7] = b.w;
        }
        // staged row j feeds output rows j - ky
#pragma unroll
        for (int j = 0; j < RP + 2; ++j) {
          const float v = sb[j * SW + kx];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const int r = j - ky;
            if (r < 0 || r >= RP) continue;
#pragma unroll
            for (int o = 0; o < kCPT; ++o) acc[r][o] = fmaf(wr[ky][o], v, acc[r][o]);
          }
        }
      }
    }
    __syncthreads();
  }

  bool valid[RP];
  size_t offs[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int y = y0 + ty * RP + r, x = x0 + tx;
    valid[r] = y < H && x < W;
    offs[r] = static_cast<size_t>(y) * W + x;
  }
  epilogue<T, COP, RP>(acc, valid, offs, bias, out, psum, psq, n, co0, Co,
                       static_cast<size_t>(H) * W, act, red);
}

// ---------------------------------------------------------------------------
// K4a: sum over streams of ConvTranspose2d(k=3, s=2, p=1, output_padding=1).
// Tile: TIH = TY * 2 input rows x 32 input columns, giving twice that in
// each axis of output; a thread owns 2 input rows of one column, i.e. their
// 4 output parities, for 8 output channels. The stage holds one extra row
// and column at the bottom and right (zero past the image).
// ---------------------------------------------------------------------------

template <int COP>
struct ConvTCfg {
  static constexpr int G = COP / kCPT;
  static constexpr int TY = kWarps / G;
  static constexpr int RP = 2;
  static constexpr int TIH = TY * RP;
  static constexpr int SH = TIH + 1, SW = kTX + 1;
  static constexpr int CK = 8;
};

template <typename T, int COP>
__global__ void __launch_bounds__(kThreads, 2)
convt_pair_kernel(Streams ss, const float* __restrict__ bias, T* __restrict__ out,
                  float* __restrict__ psum, float* __restrict__ psq, int H, int W, int Co,
                  int co_blocks, int co_pad, int act) {
  using Cfg = ConvTCfg<COP>;
  constexpr int G = Cfg::G, RP = Cfg::RP, SH = Cfg::SH, SW = Cfg::SW, CK = Cfg::CK;
  __shared__ __align__(16) float stage[CK * SH * SW];
  __shared__ __align__(16) float ws[CK * 9 * COP];
  __shared__ float red[2 * Cfg::TY * COP];

  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * COP;
  const int m0 = blockIdx.y * Cfg::TIH, n0 = blockIdx.x * kTX;
  const int tx = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = warp % G, ty = warp / G;

  // acc[r][py * 2 + px][o]: input row m0 + ty * RP + r, output parity (py, px)
  float acc[RP][4][kCPT];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int o = 0; o < kCPT; ++o) acc[r][q][o] = 0.f;

  for (int s = 0; s < ss.count; ++s) {
    const Stream& st = ss.s[s];
    for (int c0 = 0; c0 < st.C; c0 += CK) {
      stage_chunk<T, COP>(st, n, c0, CK, H, W, m0, n0, SH, SW, co0, co_pad, stage, ws);
      __syncthreads();
      const int nch = min(CK, st.C - c0);
      for (int ch = 0; ch < nch; ++ch) {
        const float* sb = stage + ch * SH * SW + ty * RP * SW + tx;
        const float* wb = ws + ch * 9 * COP + g * kCPT;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          // ky = 1: even output rows from input row m; ky = 2: odd rows from
          // row m; ky = 0: odd rows from row m + 1
          const int py = ky == 1 ? 0 : 1;
          const int dr = ky == 0 ? 1 : 0;
          float wr[3][kCPT];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float4 a = *reinterpret_cast<const float4*>(wb + (ky * 3 + kx) * COP);
            const float4 b = *reinterpret_cast<const float4*>(wb + (ky * 3 + kx) * COP + 4);
            wr[kx][0] = a.x; wr[kx][1] = a.y; wr[kx][2] = a.z; wr[kx][3] = a.w;
            wr[kx][4] = b.x; wr[kx][5] = b.y; wr[kx][6] = b.z; wr[kx][7] = b.w;
          }
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float v0 = sb[(r + dr) * SW];      // column n
            const float v1 = sb[(r + dr) * SW + 1];  // column n + 1
#pragma unroll
            for (int o = 0; o < kCPT; ++o) {
              // even output column: kx = 1 at n; odd: kx = 0 at n + 1, kx = 2 at n
              acc[r][py * 2][o] = fmaf(wr[1][o], v0, acc[r][py * 2][o]);
              acc[r][py * 2 + 1][o] =
                  fmaf(wr[2][o], v0, fmaf(wr[0][o], v1, acc[r][py * 2 + 1][o]));
            }
          }
        }
      }
      __syncthreads();
    }
  }

  constexpr int NP = RP * 4;
  float vals[NP][kCPT];
  bool valid[NP];
  size_t offs[NP];
  const int W2 = 2 * W;
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int m = m0 + ty * RP + r, c = n0 + tx;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = r * 4 + q;
      valid[p] = m < H && c < W;
      offs[p] = static_cast<size_t>(2 * m + q / 2) * W2 + 2 * c + q % 2;
#pragma unroll
      for (int o = 0; o < kCPT; ++o) vals[p][o] = acc[r][q][o];
    }
  }
  epilogue<T, COP, NP>(vals, valid, offs, bias, out, psum, psq, n, co0, Co,
                       static_cast<size_t>(H) * W * 4, act, red);
}

// ---------------------------------------------------------------------------
// K4b, bf16 on the tensor cores: an implicit GEMM with M = a tile of TH x 64
// output pixels, N = the COP output channels of the block and K = 9 C, taken
// in chunks of 16 input channels (see the header).
// ---------------------------------------------------------------------------

constexpr int kMmaCK = 16;  // input channels a chunk

// the C extent of the packed weights: C rounded up to the chunk
int mma_c_pad(int C) { return (C + kMmaCK - 1) / kMmaCK * kMmaCK; }

template <int COP>
struct MmaCfg {
  static constexpr int MT = COP == 64 ? 2 : 4;     // m16 tiles (of 16 pixels) a warp keeps
  static constexpr int NT = COP / 8;               // n8 tiles a warp keeps
  static constexpr int TW = 64;                    // tile columns: 128 bytes a channel row
  static constexpr int WPR = TW / (16 * MT);       // warps a tile row
  static constexpr int TH = kWarps / WPR;          // tile rows: 4 or 8
  static constexpr int SH = TH + 2, SW = TW + 2;   // the tile and its one-pixel halo
  static constexpr int CK = kMmaCK;
  static constexpr int SP = CK + 8;                // staged pixel stride: 48 bytes
  static constexpr int RW = TW + 16;               // raw row: columns x0 - 8 .. x0 + TW + 7
  static constexpr int WS = COP + 8;               // weight row stride
  static constexpr int kRaw = CK * SH * RW;        // bf16 a raw buffer
  static constexpr int kStage = SH * SW * SP;      // bf16
  static constexpr int kW = 9 * CK * WS;           // bf16 a weight buffer
  static constexpr int OP = TH * TW + 8;           // output plane stride in the epilogue
  static constexpr size_t kMain =
      sizeof(__nv_bfloat16) * (2 * kRaw + kStage + 2 * kW) + sizeof(float) * 4 * CK;
  static constexpr size_t kEpi =
      sizeof(__nv_bfloat16) * COP * OP + sizeof(float) * 2 * kWarps * COP;
  static constexpr size_t kSmem = kMain > kEpi ? kMain : kEpi;
};

// x [N, C, H, W] and out [N, Co, H, W] bf16; wp [9][c_pad][co_pad] bf16 (tap,
// input channel, output channel; zero past C and Co); A, B [N, C] f32 and the
// prologue's activation PRO (< 0: no prologue); bias [co_pad] f32; psum, psq
// [N, Co, tiles] or null. W % 8 == 0 and 16-byte aligned x and out.
template <int COP, int PRO>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                   const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ psum, float* __restrict__ psq, int C, int c_pad, int H,
                   int W, int Co, int co_blocks, int co_pad, int act) {
  using namespace fmi_mma;
  using Cfg = MmaCfg<COP>;
  constexpr int MT = Cfg::MT, NT = Cfg::NT, TW = Cfg::TW, TH = Cfg::TH, SH = Cfg::SH,
                SW = Cfg::SW, CK = Cfg::CK, SP = Cfg::SP, RW = Cfg::RW, WS = Cfg::WS,
                OP = Cfg::OP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][CK][SH][RW]
  __nv_bfloat16* stage = raw + 2 * Cfg::kRaw;                        // [SH * SW][SP]
  __nv_bfloat16* ws = stage + Cfg::kStage;                           // [2][9][CK][WS]
  float* ab = reinterpret_cast<float*>(ws + 2 * Cfg::kW);            // [2][A, B][CK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lm = lane >> 3, li = lane & 7;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * COP;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int wrow = warp / Cfg::WPR, wcol = (warp % Cfg::WPR) * 16 * MT;
  const __nv_bfloat16* xn = x + static_cast<size_t>(n) * C * H * W;

  // chunk [c0, c0 + CK) into buffer buf: the raw rows y0 - 1 .. y0 + TH of
  // the input as they lie in memory (16-byte pieces, zeros outside the
  // image and past C), the chunk's weights and its prologue affine
  auto prefetch = [&](int c0, int buf) {
    constexpr int kPieces = RW / 8;
    __nv_bfloat16* rb = raw + buf * Cfg::kRaw;
    for (int i = tid; i < CK * SH * kPieces; i += kThreads) {
      const int j = i % kPieces, rest = i / kPieces;  // rest = ch * SH + r
      const int r = rest % SH, c = c0 + rest / SH;
      const int y = y0 - 1 + r, xx = x0 - 8 + 8 * j;
      const bool ok = c < C && y >= 0 && y < H && xx >= 0 && xx < W;
      cp_async16(rb + rest * RW + 8 * j, ok ? xn + (static_cast<size_t>(c) * H + y) * W + xx : xn,
                 ok ? 16 : 0);
    }
    __nv_bfloat16* wb = ws + buf * Cfg::kW;
    for (int i = tid; i < 9 * CK * NT; i += kThreads) {
      const int p = i % NT, rest = i / NT;  // rest = tap * CK + ch
      const int ch = rest % CK, tap = rest / CK;
      cp_async16(wb + rest * WS + 8 * p,
                 wp + (static_cast<size_t>(tap) * c_pad + c0 + ch) * co_pad + co0 + 8 * p, 16);
    }
    if (PRO >= 0 && tid < 2 * CK) {
      const int c = c0 + tid % CK;
      const bool ok = c < C;
      cp_async4(ab + buf * 2 * CK + tid,
                (tid < CK ? A : B) + static_cast<size_t>(n) * C + (ok ? c : 0), ok ? 4 : 0);
    }
  };

  // raw buffer buf -> stage, channel-innermost, with the prologue: two
  // roundings and no FMA, then one rounding to bf16 (in pack_bf16); zeros
  // outside the image, written after the prologue. A thread takes 8 channels
  // (one group per half block, so the prologue's A and B are warp-uniform)
  // of one pixel at a time.
  auto transpose = [&](int buf) {
    const __nv_bfloat16* rb = raw + buf * Cfg::kRaw;
    const float* abb = ab + buf * 2 * CK;
    const int cg = tid / (kThreads / 2);
    for (int p = tid % (kThreads / 2); p < SH * SW; p += kThreads / 2) {
      const int r = p / SW, s = p - r * SW;
      const int y = y0 - 1 + r, xx = x0 - 1 + s;
      const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
      unsigned packed[4];
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = cg * 8 + k + e;
          float f = __bfloat162float(rb[(ch * SH + r) * RW + s + 7]);
          if constexpr (PRO >= 0)
            f = apply_act(__fadd_rn(__fmul_rn(f, abb[ch]), abb[CK + ch]), PRO);
          v[e] = inside ? f : 0.f;
        }
        packed[k / 2] = pack_bf16(v[0], v[1]);
      }
      *reinterpret_cast<uint4*>(stage + p * SP + cg * 8) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int n_chunks = c_pad / CK;
  prefetch(0, 0);
  cp_async_commit();
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int buf = ck & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ck landed; every warp is done with chunk ck - 1
    if (ck + 1 < n_chunks) prefetch((ck + 1) * CK, buf ^ 1);
    cp_async_commit();
    transpose(buf);
    __syncthreads();
    const __nv_bfloat16* wb = ws + buf * Cfg::kW;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      unsigned bf[NT][2];
      if constexpr (NT == 1) {
        ldmatrix_x2_trans(bf[0], wb + (tap * CK + (lane & 15)) * WS);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned b[4];
          ldmatrix_x4_trans(b, wb + (tap * CK + (lm & 1) * 8 + li) * WS + np * 16 + (lm >> 1) * 8);
          bf[2 * np][0] = b[0];
          bf[2 * np][1] = b[1];
          bf[2 * np + 1][0] = b[2];
          bf[2 * np + 1][1] = b[3];
        }
      }
      // the tap is a shift of the staged tile: row address per lane
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        ldmatrix_x4(a, stage + ((wrow + ky) * SW + wcol + mt * 16 + (lane & 15) + kx) * SP +
                           (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
      }
    }
  }
  __syncthreads();  // the epilogue reuses the staging memory

  // bias, stats from the f32 value, act, one rounding; the tile goes through
  // shared memory so that each channel row leaves in 16-byte pieces
  __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [COP][OP]
  float* red = reinterpret_cast<float*>(ot + COP * OP);            // [2][kWarps][COP]
  const bool row_in = y0 + wrow < H;
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = wcol + mt * 16 + g + 8 * (e >> 1);
        const int co = j * 8 + 2 * t + (e & 1);
        const float yv = acc[mt][j][e] + bias[co0 + co];  // bias is padded to co_pad
        if (row_in && x0 + col < W && co0 + co < Co) {
          s1[j][e & 1] += yv;
          s2[j][e & 1] += yv * yv;
        }
        ot[co * OP + wrow * TW + col] = __float2bfloat16(apply_act(yv, act));
      }
  if (psum != nullptr) {
    // over the 8 pixel rows g of the fragments, then the warps in order
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = s1[j][h], b = s2[j][h];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, m);
          b += __shfl_xor_sync(0xffffffffu, b, m);
        }
        if (lane < 4) {
          red[warp * COP + j * 8 + 2 * lane + h] = a;
          red[(kWarps + warp) * COP + j * 8 + 2 * lane + h] = b;
        }
      }
  }
  __syncthreads();
  if (psum != nullptr && tid < COP && co0 + tid < Co) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * COP + tid];
      b += red[(kWarps + w) * COP + tid];
    }
    const int tiles = gridDim.x * gridDim.y;
    const size_t k = (static_cast<size_t>(n) * Co + co0 + tid) * tiles +
                     blockIdx.y * gridDim.x + blockIdx.x;
    psum[k] = a;
    psq[k] = b;
  }
  constexpr int kPieces = TW / 8;
  for (int i = tid; i < COP * TH * kPieces; i += kThreads) {
    const int kc = i % kPieces, rest = i / kPieces;  // rest = co * TH + r
    const int r = rest % TH, co = rest / TH;
    const int y = y0 + r, xx = x0 + 8 * kc;
    if (co0 + co < Co && y < H && xx < W) {
      const size_t dst = ((static_cast<size_t>(n) * Co + co0 + co) * H + y) * W + xx;
      *reinterpret_cast<uint4*>(out + dst) =
          *reinterpret_cast<const uint4*>(ot + co * OP + r * TW + 8 * kc);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b, f32 on the tensor cores in split precision (3xTF32, see csrc/mma.cuh):
// the bf16 kernel's implicit GEMM, M = TH x 64 output pixels, N = COP output
// channels, K = 9 C in chunks of 8 input channels (one m16n8k8 step a tap).
// Each operand is split into tf32 hi and lo once: the weights by the wrapper,
// packed [2][9][co_pad][c_pad] (hi, lo; tap; output channel; input channel),
// N-major and K-contiguous because ldmatrix cannot transpose 32-bit data;
// the input where the staging pass applies the prologue, into a hi and a lo
// tile. A chunk's nine taps take their products in zeroed fragments, which
// are then added to the f32 totals with one rounded add each: the tensor
// cores' accumulate drifts over the 9 C products of a whole sum (mma.cuh).
// Holds the f32 gates; torch.backends.cuda.matmul.allow_tf32 does not
// govern it.
// ---------------------------------------------------------------------------

constexpr int kTf32CK = 8;  // input channels a chunk: one k8 step a tap

template <int COP>
struct Tf32Cfg {
  static constexpr int MT = MmaCfg<COP>::MT;       // m16 tiles a warp keeps
  static constexpr int NT = COP / 8;               // n8 tiles a warp keeps
  static constexpr int TW = MmaCfg<COP>::TW;       // tile columns
  static constexpr int WPR = TW / (16 * MT);       // warps a tile row
  static constexpr int TH = kWarps / WPR;          // tile rows, as the bf16 kernel's
  static constexpr int SH = TH + 2, SW = TW + 2;   // the tile and its one-pixel halo
  static constexpr int CK = kTf32CK;
  static constexpr int SP = CK + 4;                // staged pixel stride: 48 bytes
  static constexpr int RW = TW + 8;                // raw row: columns x0 - 4 .. x0 + TW + 3
  static constexpr int WS = CK + 4;                // weight row stride: 48 bytes
  static constexpr int kRaw = CK * SH * RW;        // f32 a raw buffer
  static constexpr int kStage = SH * SW * SP;      // f32 a staged tile (hi or lo)
  static constexpr int kW = 9 * COP * WS;          // f32 a weight tile (hi or lo)
  static constexpr int OP = TH * TW + 4;           // output plane stride in the epilogue
  static constexpr size_t kMain = sizeof(float) * (2 * kRaw + 2 * kStage + 4 * kW + 4 * CK);
  static constexpr size_t kEpi = sizeof(float) * (COP * OP + 2 * kWarps * COP);
  static constexpr size_t kSmem = kMain > kEpi ? kMain : kEpi;
  static_assert(TH == MmaCfg<COP>::TH, "the tiles (and so psum's extent) of the bf16 kernel");
};

// the A fragments (hi and lo) of MT m16 tiles of 16 staged pixels each, k8
// channels: tile mt starts at staged pixel p0 + 16 mt, a row address per lane
template <int MT, int SP>
__device__ __forceinline__ void tf32x3_load_a(unsigned (&ah)[MT][4], unsigned (&al)[MT][4],
                                              const float* sh, const float* sl, int p0,
                                              int lane) {
  using namespace fmi_mma;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = p0 + mt * 16 + (lane & 15);
    ldmatrix_x4(ah[mt], sh + p * SP + (lane >> 4) * 4);
    ldmatrix_x4(al[mt], sl + p * SP + (lane >> 4) * 4);
  }
}

// one tap's k8 step: c[mt] += A_mt B_tap in split precision, from the given A
// fragments and the tap's hi/lo weights ([9][NT * 8][WS], N-major)
template <int MT, int NT, int WS>
__device__ __forceinline__ void tf32x3_tap(float (&c)[MT][NT][4], const unsigned (&ah)[MT][4],
                                           const unsigned (&al)[MT][4], const float* wh,
                                           const float* wl, int tap, int lane) {
  using namespace fmi_mma;
  constexpr int COP = NT * 8;
  const int lm = lane >> 3, li = lane & 7;
  if constexpr (NT == 1) {
    unsigned bh[2], bl[2];
    const int row = tap * COP + li, col = (lm & 1) * 4;
    ldmatrix_x2(bh, wh + row * WS + col);
    ldmatrix_x2(bl, wl + row * WS + col);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      mma_tf32x3(c[mt][0], ah[mt], al[mt], bh[0], bh[1], bl[0], bl[1]);
  } else {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // b0, b1 of n-tile 2 np and b2, b3 of 2 np + 1
      unsigned bh[4], bl[4];
      const int row = tap * COP + np * 16 + (lm >> 1) * 8 + li, col = (lm & 1) * 4;
      ldmatrix_x4(bh, wh + row * WS + col);
      ldmatrix_x4(bl, wl + row * WS + col);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32x3(c[mt][2 * np], ah[mt], al[mt], bh[0], bh[1], bl[0], bl[1]);
        mma_tf32x3(c[mt][2 * np + 1], ah[mt], al[mt], bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
}

// the chunk's nine taps, each one k8 step: c += A_tap B_tap in split
// precision, from the staged hi/lo tiles and the chunk's hi/lo weights
template <typename Cfg>
__device__ __forceinline__ void tf32x3_taps(float (&c)[Cfg::MT][Cfg::NT][4], const float* sh,
                                            const float* sl, const float* wh, const float* wl,
                                            int wrow, int wcol, int lane) {
  constexpr int MT = Cfg::MT, NT = Cfg::NT, SW = Cfg::SW, SP = Cfg::SP, WS = Cfg::WS;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    // the tap is a shift of the staged tile: a row address per lane
    unsigned ah[MT][4], al[MT][4];
    tf32x3_load_a<MT, SP>(ah, al, sh, sl, (wrow + ky) * SW + wcol + kx, lane);
    tf32x3_tap<MT, NT, WS>(c, ah, al, wh, wl, tap, lane);
  }
}

// x [N, C, H, W] and out [N, Co, H, W] f32; wp [2][9][co_pad][c_pad] f32 (hi,
// lo; zero past C and Co); A, B [N, C] f32 and the prologue's activation PRO
// (< 0: no prologue); bias [co_pad] f32; psum, psq [N, Co, tiles] or null.
// W % 4 == 0 and 16-byte aligned x and out.
template <int COP, int PRO>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                      const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ psum, float* __restrict__ psq, int C, int c_pad, int H,
                      int W, int Co, int co_blocks, int co_pad, int act) {
  using namespace fmi_mma;
  using Cfg = Tf32Cfg<COP>;
  constexpr int MT = Cfg::MT, NT = Cfg::NT, TW = Cfg::TW, TH = Cfg::TH, SH = Cfg::SH,
                SW = Cfg::SW, CK = Cfg::CK, SP = Cfg::SP, RW = Cfg::RW, WS = Cfg::WS,
                OP = Cfg::OP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw = reinterpret_cast<float*>(smem_raw);  // [2][CK][SH][RW]
  float* stage = raw + 2 * Cfg::kRaw;               // [hi, lo][SH * SW][SP]
  float* ws = stage + 2 * Cfg::kStage;              // [2][hi, lo][9][COP][WS]
  float* ab = ws + 4 * Cfg::kW;                     // [2][A, B][CK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * COP;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int wrow = warp / Cfg::WPR, wcol = (warp % Cfg::WPR) * 16 * MT;
  const float* xn = x + static_cast<size_t>(n) * C * H * W;

  // chunk [c0, c0 + CK) into buffer buf: the raw rows y0 - 1 .. y0 + TH as
  // they lie in memory (16-byte pieces, zeros outside the image and past C),
  // the chunk's hi and lo weights and its prologue affine
  auto prefetch = [&](int c0, int buf) {
    constexpr int kPieces = RW / 4;
    float* rb = raw + buf * Cfg::kRaw;
    for (int i = tid; i < CK * SH * kPieces; i += kThreads) {
      const int j = i % kPieces, rest = i / kPieces;  // rest = ch * SH + r
      const int r = rest % SH, c = c0 + rest / SH;
      const int y = y0 - 1 + r, xx = x0 - 4 + 4 * j;
      const bool ok = c < C && y >= 0 && y < H && xx >= 0 && xx < W;
      cp_async16(rb + rest * RW + 4 * j, ok ? xn + (static_cast<size_t>(c) * H + y) * W + xx : xn,
                 ok ? 16 : 0);
    }
    float* wb = ws + buf * 2 * Cfg::kW;
    constexpr int kWP = CK / 4;  // 16-byte pieces a weight row
    for (int i = tid; i < 2 * 9 * COP * kWP; i += kThreads) {
      const int p = i % kWP, rest = i / kWP;  // rest = (part * 9 + tap) * COP + co
      const int co = rest % COP, pt = rest / COP;
      cp_async16(wb + rest * WS + 4 * p,
                 wp + (static_cast<size_t>(pt) * co_pad + co0 + co) * c_pad + c0 + 4 * p, 16);
    }
    if (PRO >= 0 && tid < 2 * CK) {
      const int c = c0 + tid % CK;
      const bool ok = c < C;
      cp_async4(ab + buf * 2 * CK + tid,
                (tid < CK ? A : B) + static_cast<size_t>(n) * C + (ok ? c : 0), ok ? 4 : 0);
    }
  };

  // raw buffer buf -> the hi and lo tiles, channel-innermost: the prologue
  // in f32 (two roundings, no FMA), zeros outside the image written after
  // it, then the split. A thread takes all CK channels of one pixel.
  auto stage_split = [&](int buf) {
    const float* rb = raw + buf * Cfg::kRaw;
    const float* abb = ab + buf * 2 * CK;
    for (int p = tid; p < SH * SW; p += kThreads) {
      const int r = p / SW, s = p - r * SW;
      const int y = y0 - 1 + r, xx = x0 - 1 + s;
      const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
      unsigned hi[CK], lo[CK];
#pragma unroll
      for (int ch = 0; ch < CK; ++ch) {
        float f = rb[(ch * SH + r) * RW + s + 3];
        if constexpr (PRO >= 0)
          f = apply_act(__fadd_rn(__fmul_rn(f, abb[ch]), abb[CK + ch]), PRO);
        split_tf32(inside ? f : 0.f, hi[ch], lo[ch]);
      }
#pragma unroll
      for (int q = 0; q < CK; q += 4) {
        *reinterpret_cast<uint4*>(stage + p * SP + q) =
            make_uint4(hi[q], hi[q + 1], hi[q + 2], hi[q + 3]);
        *reinterpret_cast<uint4*>(stage + Cfg::kStage + p * SP + q) =
            make_uint4(lo[q], lo[q + 1], lo[q + 2], lo[q + 3]);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int n_chunks = (C + CK - 1) / CK;
  prefetch(0, 0);
  cp_async_commit();
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int buf = ck & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ck landed; every warp is done with chunk ck - 1
    if (ck + 1 < n_chunks) prefetch((ck + 1) * CK, buf ^ 1);
    cp_async_commit();
    stage_split(buf);
    __syncthreads();
    const float* wh = ws + buf * 2 * Cfg::kW;
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
    tf32x3_taps<Cfg>(part, stage, stage + Cfg::kStage, wh, wh + Cfg::kW, wrow, wcol, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = __fadd_rn(acc[mt][j][e], part[mt][j][e]);
  }
  __syncthreads();  // the epilogue reuses the staging memory

  // bias, stats from the f32 value, act; the tile goes through shared
  // memory so that each channel row leaves in 16-byte pieces
  float* ot = reinterpret_cast<float*>(smem_raw);  // [COP][OP]
  float* red = ot + COP * OP;                       // [2][kWarps][COP]
  const bool row_in = y0 + wrow < H;
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = wcol + mt * 16 + g + 8 * (e >> 1);
        const int co = j * 8 + 2 * t + (e & 1);
        const float yv = acc[mt][j][e] + bias[co0 + co];  // bias is padded to co_pad
        if (row_in && x0 + col < W && co0 + co < Co) {
          s1[j][e & 1] += yv;
          s2[j][e & 1] += yv * yv;
        }
        ot[co * OP + wrow * TW + col] = apply_act(yv, act);
      }
  if (psum != nullptr) {
    // over the 8 pixel rows g of the fragments, then the warps in order
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = s1[j][h], b = s2[j][h];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, m);
          b += __shfl_xor_sync(0xffffffffu, b, m);
        }
        if (lane < 4) {
          red[warp * COP + j * 8 + 2 * lane + h] = a;
          red[(kWarps + warp) * COP + j * 8 + 2 * lane + h] = b;
        }
      }
  }
  __syncthreads();
  if (psum != nullptr && tid < COP && co0 + tid < Co) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * COP + tid];
      b += red[(kWarps + w) * COP + tid];
    }
    const int tiles = gridDim.x * gridDim.y;
    const size_t k = (static_cast<size_t>(n) * Co + co0 + tid) * tiles +
                     blockIdx.y * gridDim.x + blockIdx.x;
    psum[k] = a;
    psq[k] = b;
  }
  constexpr int kPieces = TW / 4;
  for (int i = tid; i < COP * TH * kPieces; i += kThreads) {
    const int kc = i % kPieces, rest = i / kPieces;  // rest = co * TH + r
    const int r = rest % TH, co = rest / TH;
    const int y = y0 + r, xx = x0 + 4 * kc;
    if (co0 + co < Co && y < H && xx < W) {
      const size_t dst = ((static_cast<size_t>(n) * Co + co0 + co) * H + y) * W + xx;
      *reinterpret_cast<float4*>(out + dst) =
          *reinterpret_cast<const float4*>(ot + co * OP + r * TW + 4 * kc);
    }
  }
}

// ---------------------------------------------------------------------------
// K4a, bf16 on the tensor cores: an implicit GEMM per output parity over one
// staged tile of TH x 64 input pixels plus the row and column below and to
// the right (the zero of output_padding at row H and column W). With the
// taps of ConvT per axis (even o = 2m reads k = 1 at m; odd o = 2m + 1 reads
// k = 2 at m and k = 0 at m + 1), each of the nine taps feeds one parity:
//   (2m, 2n)         <- w[1,1] x[m,n]
//   (2m, 2n + 1)     <- w[1,2] x[m,n] + w[1,0] x[m,n+1]
//   (2m + 1, 2n)     <- w[2,1] x[m,n] + w[0,1] x[m+1,n]
//   (2m + 1, 2n + 1) <- w[2,2] x[m,n] + w[2,0] x[m,n+1] + w[0,2] x[m+1,n]
//                       + w[0,0] x[m+1,n+1]
// M = the tile's input pixels, N = the block's COP output channels, K =
// (taps of the parity) x 16-channel chunks of both streams, summed into one
// set of accumulators per parity. A warp keeps MT m16 tiles of one input row
// for all four parities and all COP channels (128 f32 registers for COP >=
// 16), so one block of 8 warps fills an SM. (Splitting the parities between
// the two warps of a pair, so that a weight fragment serves more pixels,
// and a ring of four chunks in place of two measured no faster on the
// H100.) The chunk's raw rows, weights
// and prologue affine are copied by cp.async into the other half of a
// double buffer while the current chunk computes; one pass applies the
// stream's prologue (a template argument, chosen per chunk) and lays the
// chunk out channel-innermost in 48-byte pixel rows, as K4b does; a tap is a
// shifted ldmatrix row address into it. The epilogue interleaves the
// parities in shared memory, so that each output row leaves in 16-byte
// pieces.
// ---------------------------------------------------------------------------

template <int COP>
struct ConvTMmaCfg {
  static constexpr int NT = COP / 8;                        // n8 tiles a warp keeps
  static constexpr int MT = COP == 64 ? 1 : COP == 32 ? 2 : 4;  // m16 tiles a warp keeps
  static constexpr int TW = 64;                             // tile columns (input)
  static constexpr int WPR = TW / (16 * MT);                // warps a tile row
  static constexpr int TH = kWarps / WPR;                   // tile rows (input): 2, 4 or 8
  static constexpr int SH = TH + 1, SW = TW + 1;            // plus the row and column after
  static constexpr int CK = kMmaCK;
  static constexpr int SP = CK + 8;                         // staged pixel stride: 48 bytes
  static constexpr int RW = TW + 8;                         // raw row: columns n0 .. n0 + TW + 7
  static constexpr int WS = COP + 8;                        // weight row stride
  static constexpr int kRaw = CK * SH * RW;                 // bf16 a raw buffer
  static constexpr int kStage = SH * SW * SP;               // bf16
  static constexpr int kW = 9 * CK * WS;                    // bf16 a weight buffer
  static constexpr int OW = 2 * TW;                         // output row in the epilogue
  static constexpr int OP = 2 * TH * OW + 8;                // output channel stride: the
                                                            // four lanes t land 8 banks apart
  static constexpr size_t kMain =
      sizeof(__nv_bfloat16) * (2 * kRaw + kStage + 2 * kW) + sizeof(float) * 4 * CK;
  static constexpr size_t kEpi =
      sizeof(__nv_bfloat16) * COP * OP + sizeof(float) * 2 * kWarps * COP;
  static constexpr size_t kSmem = kMain > kEpi ? kMain : kEpi;
};

// One stream of a tensor-core K4a: x [N, C, H, W] of type T (bf16, or f32
// on the split-precision route), packed weights w of type T (bf16
// [9][c_pad][co_pad]: tap ky * 3 + kx, input channel, output channel; f32
// [2][9][co_pad][c_pad]: hi, lo, tap, output channel, input channel), the
// prologue's A, B [N, C] f32 and its activation pro (< 0: none).
template <typename T>
struct MmaStream {
  const T* x;
  const T* w;
  const float* A;
  const float* B;
  int C, c_pad, pro;
};

template <typename T>
struct MmaStreams {
  MmaStream<T> s[2];
  int count;
};

// stream 0 or 1, field by field: an indexed kernel parameter would be
// copied to local memory
template <typename T>
__device__ __forceinline__ MmaStream<T> pick_stream(const MmaStreams<T>& ss, bool second) {
  const MmaStream<T>& a = ss.s[0];
  const MmaStream<T>& b = ss.s[1];
  return MmaStream<T>{second ? b.x : a.x, second ? b.w : a.w, second ? b.A : a.A,
                      second ? b.B : a.B, second ? b.C : a.C, second ? b.c_pad : a.c_pad,
                      second ? b.pro : a.pro};
}

// raw chunk -> staged tile, channel-innermost, with the prologue PRO: two
// roundings and no FMA, then one rounding to bf16 (in pack_bf16); zeros
// past row H and column W, written after the prologue
template <typename Cfg, int PRO>
__device__ __forceinline__ void convt_stage(const __nv_bfloat16* rb, const float* abb,
                                            __nv_bfloat16* stage, int m0, int n0, int H,
                                            int W) {
  using namespace fmi_mma;
  constexpr int CK = Cfg::CK, SH = Cfg::SH, SW = Cfg::SW, RW = Cfg::RW, SP = Cfg::SP;
  const int cg = threadIdx.x / (kThreads / 2);
  for (int p = threadIdx.x % (kThreads / 2); p < SH * SW; p += kThreads / 2) {
    const int r = p / SW, s = p - r * SW;
    const bool inside = m0 + r < H && n0 + s < W;
    unsigned packed[4];
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = cg * 8 + k + e;
        float f = __bfloat162float(rb[(ch * SH + r) * RW + s]);
        if constexpr (PRO >= 0)
          f = apply_act(__fadd_rn(__fmul_rn(f, abb[ch]), abb[CK + ch]), PRO);
        v[e] = inside ? f : 0.f;
      }
      packed[k / 2] = pack_bf16(v[0], v[1]);
    }
    *reinterpret_cast<uint4*>(stage + p * SP + cg * 8) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// out [N, Co, 2H, 2W] bf16; bias [co_pad] f32 (the streams' biases summed);
// psum, psq [N, Co, tiles] or null. W % 8 == 0 and 16-byte aligned maps.
template <int COP>
__global__ void __launch_bounds__(kThreads, 1)
convt_pair_mma_kernel(MmaStreams<__nv_bfloat16> ss, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ psum,
                      float* __restrict__ psq, int H, int W, int Co, int co_blocks, int co_pad,
                      int act) {
  using namespace fmi_mma;
  using Cfg = ConvTMmaCfg<COP>;
  constexpr int MT = Cfg::MT, NT = Cfg::NT, TW = Cfg::TW, TH = Cfg::TH, SH = Cfg::SH,
                SW = Cfg::SW, CK = Cfg::CK, SP = Cfg::SP, RW = Cfg::RW, WS = Cfg::WS,
                OW = Cfg::OW, OP = Cfg::OP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][CK][SH][RW]
  __nv_bfloat16* stage = raw + 2 * Cfg::kRaw;                        // [SH * SW][SP]
  __nv_bfloat16* ws = stage + Cfg::kStage;                           // [2][9][CK][WS]
  float* ab = reinterpret_cast<float*>(ws + 2 * Cfg::kW);            // [2][A, B][CK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lm = lane >> 3, li = lane & 7;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * COP;
  const int m0 = blockIdx.y * TH, n0 = blockIdx.x * TW;
  const int wrow = warp / Cfg::WPR, wcol = (warp % Cfg::WPR) * 16 * MT;
  const int chunks0 = ss.s[0].c_pad / CK;
  const int n_chunks = chunks0 + (ss.count > 1 ? ss.s[1].c_pad / CK : 0);

  // chunk ck (of stream 0, then stream 1) into buffer buf: the raw rows
  // m0 .. m0 + TH as they lie in memory (16-byte pieces, zeros past the
  // image and past C), the chunk's weights and its prologue affine
  auto prefetch = [&](int ck, int buf) {
    const auto st = pick_stream(ss, ck >= chunks0);
    const int c0 = (ck < chunks0 ? ck : ck - chunks0) * CK;
    const __nv_bfloat16* xn = st.x + static_cast<size_t>(n) * st.C * H * W;
    constexpr int kPieces = RW / 8;
    __nv_bfloat16* rb = raw + buf * Cfg::kRaw;
    for (int i = tid; i < CK * SH * kPieces; i += kThreads) {
      const int j = i % kPieces, rest = i / kPieces;  // rest = ch * SH + r
      const int r = rest % SH, c = c0 + rest / SH;
      const int y = m0 + r, xx = n0 + 8 * j;
      const bool ok = c < st.C && y < H && xx < W;
      cp_async16(rb + rest * RW + 8 * j, ok ? xn + (static_cast<size_t>(c) * H + y) * W + xx : xn,
                 ok ? 16 : 0);
    }
    __nv_bfloat16* wb = ws + buf * Cfg::kW;
    for (int i = tid; i < 9 * CK * NT; i += kThreads) {
      const int p = i % NT, rest = i / NT;  // rest = tap * CK + ch
      const int ch = rest % CK, tap = rest / CK;
      cp_async16(wb + rest * WS + 8 * p,
                 st.w + (static_cast<size_t>(tap) * st.c_pad + c0 + ch) * co_pad + co0 + 8 * p,
                 16);
    }
    if (st.pro >= 0 && tid < 2 * CK) {
      const int c = c0 + tid % CK;
      const bool ok = c < st.C;
      cp_async4(ab + buf * 2 * CK + tid,
                (tid < CK ? st.A : st.B) + static_cast<size_t>(n) * st.C + (ok ? c : 0),
                ok ? 4 : 0);
    }
  };

  // acc[py * 2 + px][mt][j]: output parity (py, px) of the warp's m16 tile mt
  float acc[4][MT][NT][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][j][e] = 0.f;

  prefetch(0, 0);
  cp_async_commit();
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int buf = ck & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ck landed; every warp is done with chunk ck - 1
    if (ck + 1 < n_chunks) prefetch(ck + 1, buf ^ 1);
    cp_async_commit();
    const __nv_bfloat16* rb = raw + buf * Cfg::kRaw;
    const float* abb = ab + buf * 2 * CK;
    switch (pick_stream(ss, ck >= chunks0).pro) {  // the stream's prologue, block-uniform
      case 0: convt_stage<Cfg, 0>(rb, abb, stage, m0, n0, H, W); break;
      case 1: convt_stage<Cfg, 1>(rb, abb, stage, m0, n0, H, W); break;
      case 2: convt_stage<Cfg, 2>(rb, abb, stage, m0, n0, H, W); break;
      default: convt_stage<Cfg, -1>(rb, abb, stage, m0, n0, H, W); break;
    }
    __syncthreads();
    const __nv_bfloat16* wb = ws + buf * Cfg::kW;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {  // each tap feeds one parity
      const int ky = tap / 3, kx = tap % 3;
      // ky = 1: even rows from row m; 2: odd rows from m; 0: odd rows from
      // m + 1 (and the same for kx and the columns)
      const int q = (ky == 1 ? 0 : 2) + (kx == 1 ? 0 : 1);
      const int dr = ky == 0 ? 1 : 0, dc = kx == 0 ? 1 : 0;
      unsigned bf[NT][2];
      if constexpr (NT == 1) {
        ldmatrix_x2_trans(bf[0], wb + (tap * CK + (lane & 15)) * WS);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned b[4];
          ldmatrix_x4_trans(b, wb + (tap * CK + (lm & 1) * 8 + li) * WS + np * 16 + (lm >> 1) * 8);
          bf[2 * np][0] = b[0];
          bf[2 * np][1] = b[1];
          bf[2 * np + 1][0] = b[2];
          bf[2 * np + 1][1] = b[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        ldmatrix_x4(a, stage + ((wrow + dr) * SW + wcol + mt * 16 + (lane & 15) + dc) * SP +
                           (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[q][mt][j], a, bf[j][0], bf[j][1]);
      }
    }
  }
  __syncthreads();  // the epilogue reuses the staging memory

  // bias, stats from the f32 value, act, one rounding; the two column
  // parities of a pixel are neighbours in the output row, one 4-byte store
  __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [COP][2 TH][OW]
  float* red = reinterpret_cast<float*>(ot + COP * OP);            // [2][kWarps][COP]
  const bool row_in = m0 + wrow < H;
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
#pragma unroll
  for (int py = 0; py < 2; ++py)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = wcol + mt * 16 + g + 8 * (e >> 1);
          const int co = j * 8 + 2 * t + (e & 1);
          const float b = bias[co0 + co];  // bias is padded to co_pad
          const float y0 = acc[2 * py][mt][j][e] + b, y1 = acc[2 * py + 1][mt][j][e] + b;
          if (row_in && n0 + col < W && co0 + co < Co) {
            s1[j][e & 1] += y0 + y1;
            s2[j][e & 1] += y0 * y0 + y1 * y1;
          }
          *reinterpret_cast<__nv_bfloat162*>(ot + co * OP + (2 * wrow + py) * OW + 2 * col) =
              __floats2bfloat162_rn(apply_act(y0, act), apply_act(y1, act));
        }
  if (psum != nullptr) {
    // over the 8 pixel rows g of the fragments, then the warps in order
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = s1[j][h], b = s2[j][h];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, m);
          b += __shfl_xor_sync(0xffffffffu, b, m);
        }
        if (lane < 4) {
          red[warp * COP + j * 8 + 2 * lane + h] = a;
          red[(kWarps + warp) * COP + j * 8 + 2 * lane + h] = b;
        }
      }
  }
  __syncthreads();
  if (psum != nullptr && tid < COP && co0 + tid < Co) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * COP + tid];
      b += red[(kWarps + w) * COP + tid];
    }
    const int tiles = gridDim.x * gridDim.y;
    const size_t k = (static_cast<size_t>(n) * Co + co0 + tid) * tiles +
                     blockIdx.y * gridDim.x + blockIdx.x;
    psum[k] = a;
    psq[k] = b;
  }
  constexpr int kPieces = OW / 8;
  const int H2 = 2 * H, W2 = 2 * W;
  for (int i = tid; i < COP * 2 * TH * kPieces; i += kThreads) {
    const int kc = i % kPieces, rest = i / kPieces;  // rest = co * 2 TH + r
    const int r = rest % (2 * TH), co = rest / (2 * TH);
    const int y = 2 * m0 + r, xx = 2 * n0 + 8 * kc;
    if (co0 + co < Co && y < H2 && xx < W2) {
      const size_t dst = ((static_cast<size_t>(n) * Co + co0 + co) * H2 + y) * W2 + xx;
      *reinterpret_cast<uint4*>(out + dst) =
          *reinterpret_cast<const uint4*>(ot + co * OP + r * OW + 8 * kc);
    }
  }
}

// ---------------------------------------------------------------------------
// K4a, f32 on the tensor cores in split precision (3xTF32, see csrc/mma.cuh):
// the bf16 kernel's four parity GEMMs over one staged tile, K = (taps of the
// parity) x 8-channel chunks of both streams (one m16n8k8 step a tap). As
// K4b's f32 route: each operand split into tf32 hi and lo once, the weights
// by the wrapper ([2][9][co_pad][c_pad] a stream, N-major and K-contiguous:
// there is no transposed ldmatrix for 32-bit data), the input where the
// staging pass applies the stream's prologue, into a hi and a lo tile with
// 48-byte pixel rows; three TF32 products a k8 step (lo hi, hi lo, hi hi).
// The tensor cores' accumulate drifts over long sums (mma.cuh), so a chunk's
// products of one parity go to a zeroed fragment that is then added to that
// parity's f32 totals with one rounded add. Registers decide the schedule:
// the four parities' totals of a warp are 128 f32 a thread (as in bf16) and
// a second set of partials for all four would spill, so a warp takes its
// parities one after another within a chunk, one partial set live (4 totals
// + 1 partial: 160 f32 at COP = 32, MT = 2). A block takes at most 32 output
// channels (convt_tf32x3_cop). Two other schedules measured slower on the
// H100 (decoders 3 + 4, f32, batch 16, tools/tensor_core_variants.py):
// splitting the parities between the two warps of a pair, 1 + 4 taps
// against 2 + 2, so that a weight fragment serves twice the pixels (5.75 +
// 5.70 ms against 5.56 + 5.32 ms: its second partial set spills, and half
// the time lies outside the products), and blocks of 64 channels at
// decoder 3 (5.50-5.65 ms against 4.84-4.93 ms: the chunk's hi/lo weight
// copies outweigh reading the input once per 32 channels). The epilogue is
// the bf16 route's: bias, the stats from the f32 value in a fixed order, the
// activation, the parities interleaved in shared memory so that each output
// row leaves in 16-byte pieces.
// ---------------------------------------------------------------------------

template <int COP>
struct ConvTTf32Cfg {
  static constexpr int NT = COP / 8;                        // n8 tiles a warp keeps
  static constexpr int MT0 = 128 / (4 * NT * 4);            // 128 totals a thread
  static constexpr int MT = MT0 < 1 ? 1 : MT0 > 4 ? 4 : MT0;  // m16 tiles a warp keeps
  static constexpr int PW = 16 * MT;                        // pixels of a warp
  static constexpr int TW = 64;                             // tile columns (input)
  static constexpr int WPR = TW / PW;                       // pixel groups a tile row
  static constexpr int TH = kWarps / WPR;                   // tile rows (input)
  static constexpr int SH = TH + 1, SW = TW + 1;            // plus the row and column after
  static constexpr int CK = kTf32CK;
  static constexpr int SP = CK + 4;                         // staged pixel stride: 48 bytes
  static constexpr int RW = TW + 4;                         // raw row: columns n0 .. n0 + TW + 3
  static constexpr int WS = CK + 4;                         // weight row stride: 48 bytes
  static constexpr int kRaw = CK * SH * RW;                 // f32 a raw buffer
  static constexpr int kStage = SH * SW * SP;               // f32 a staged tile (hi or lo)
  static constexpr int kW = 9 * COP * WS;                   // f32 a weight tile (hi or lo)
  static constexpr int OW = 2 * TW;                         // output row in the epilogue
  static constexpr int OP = 2 * TH * OW + 4;                // output channel stride
  static constexpr size_t kMain = sizeof(float) * (2 * kRaw + 2 * kStage + 4 * kW + 4 * CK);
  static constexpr size_t kEpi = sizeof(float) * (COP * OP + 2 * kWarps * COP);
  static constexpr size_t kSmem = kMain > kEpi ? kMain : kEpi;
  static_assert(TH >= 1 && TW % PW == 0, "a block's pixel groups tile whole rows");
};

// raw chunk -> the hi and lo tiles, channel-innermost: the prologue PRO in
// f32 (two roundings, no FMA), zeros past row H and column W written after
// it, then the split. A thread takes all CK channels of one pixel.
template <typename Cfg, int PRO>
__device__ __forceinline__ void convt_stage_tf32x3(const float* rb, const float* abb,
                                                   float* stage, int m0, int n0, int H, int W) {
  using namespace fmi_mma;
  constexpr int CK = Cfg::CK, SH = Cfg::SH, SW = Cfg::SW, RW = Cfg::RW, SP = Cfg::SP;
  for (int p = threadIdx.x; p < SH * SW; p += kThreads) {
    const int r = p / SW, s = p - r * SW;
    const bool inside = m0 + r < H && n0 + s < W;
    unsigned hi[CK], lo[CK];
#pragma unroll
    for (int ch = 0; ch < CK; ++ch) {
      float f = rb[(ch * SH + r) * RW + s];
      if constexpr (PRO >= 0) f = apply_act(__fadd_rn(__fmul_rn(f, abb[ch]), abb[CK + ch]), PRO);
      split_tf32(inside ? f : 0.f, hi[ch], lo[ch]);
    }
#pragma unroll
    for (int q = 0; q < CK; q += 4) {
      *reinterpret_cast<uint4*>(stage + p * SP + q) =
          make_uint4(hi[q], hi[q + 1], hi[q + 2], hi[q + 3]);
      *reinterpret_cast<uint4*>(stage + Cfg::kStage + p * SP + q) =
          make_uint4(lo[q], lo[q + 1], lo[q + 2], lo[q + 3]);
    }
  }
}

// parity Q = py * 2 + px of the warp's pixels over one chunk: its taps (1, 2
// or 4; even o = 2m reads k = 1 at m, odd o = 2m + 1 reads k = 2 at m and
// k = 0 at m + 1) in split precision into a zeroed fragment, then added to
// the parity's f32 totals with one rounded add each
template <typename Cfg, int Q>
__device__ __forceinline__ void convt_tf32x3_parity(float (&acc)[Cfg::MT][Cfg::NT][4],
                                                    const float* stage, const float* wt,
                                                    int wrow, int wcol, int lane) {
  constexpr int MT = Cfg::MT, NT = Cfg::NT, SW = Cfg::SW, SP = Cfg::SP, WS = Cfg::WS;
  constexpr int PY = Q >> 1, PX = Q & 1;
  float pq[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pq[mt][j][e] = 0.f;
#pragma unroll
  for (int iy = 0; iy < 1 + PY; ++iy)
#pragma unroll
    for (int ix = 0; ix < 1 + PX; ++ix) {
      const int ky = PY ? (iy ? 0 : 2) : 1, kx = PX ? (ix ? 0 : 2) : 1;
      const int dr = ky == 0 ? 1 : 0, dc = kx == 0 ? 1 : 0;
      unsigned ah[MT][4], al[MT][4];
      tf32x3_load_a<MT, SP>(ah, al, stage, stage + Cfg::kStage, (wrow + dr) * SW + wcol + dc,
                            lane);
      tf32x3_tap<MT, NT, WS>(pq, ah, al, wt, wt + Cfg::kW, ky * 3 + kx, lane);
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = __fadd_rn(acc[mt][j][e], pq[mt][j][e]);
}

// the chunk's products of the warp's four parities, in order
template <typename Cfg>
__device__ __forceinline__ void convt_tf32x3_products(float (&acc)[4][Cfg::MT][Cfg::NT][4],
                                                      const float* stage, const float* wt,
                                                      int wrow, int wcol, int lane) {
  convt_tf32x3_parity<Cfg, 0>(acc[0], stage, wt, wrow, wcol, lane);
  convt_tf32x3_parity<Cfg, 1>(acc[1], stage, wt, wrow, wcol, lane);
  convt_tf32x3_parity<Cfg, 2>(acc[2], stage, wt, wrow, wcol, lane);
  convt_tf32x3_parity<Cfg, 3>(acc[3], stage, wt, wrow, wcol, lane);
}

// out [N, Co, 2H, 2W] f32; bias [co_pad] f32 (the streams' biases summed);
// psum, psq [N, Co, tiles] or null. W % 4 == 0 and 16-byte aligned maps.
template <int COP>
__global__ void __launch_bounds__(kThreads, 1)
convt_pair_tf32x3_kernel(MmaStreams<float> ss, const float* __restrict__ bias,
                         float* __restrict__ out, float* __restrict__ psum,
                         float* __restrict__ psq, int H, int W, int Co, int co_blocks, int co_pad,
                         int act) {
  using namespace fmi_mma;
  using Cfg = ConvTTf32Cfg<COP>;
  constexpr int MT = Cfg::MT, NT = Cfg::NT, TW = Cfg::TW, TH = Cfg::TH,
                SH = Cfg::SH, CK = Cfg::CK, RW = Cfg::RW, WS = Cfg::WS, OW = Cfg::OW,
                OP = Cfg::OP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw = reinterpret_cast<float*>(smem_raw);  // [2][CK][SH][RW]
  float* stage = raw + 2 * Cfg::kRaw;               // [hi, lo][SH * SW][SP]
  float* ws = stage + 2 * Cfg::kStage;              // [2][hi, lo][9][COP][WS]
  float* ab = ws + 4 * Cfg::kW;                     // [2][A, B][CK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * COP;
  const int m0 = blockIdx.y * TH, n0 = blockIdx.x * TW;
  const int wrow = warp / Cfg::WPR, wcol = (warp % Cfg::WPR) * Cfg::PW;  // its pixels
  const int chunks0 = (ss.s[0].C + CK - 1) / CK;
  const int n_chunks = chunks0 + (ss.count > 1 ? (ss.s[1].C + CK - 1) / CK : 0);

  // chunk ck (of stream 0, then stream 1) into buffer buf: the raw rows
  // m0 .. m0 + TH as they lie in memory (16-byte pieces, zeros past the
  // image and past C), the chunk's hi and lo weights and its prologue affine
  auto prefetch = [&](int ck, int buf) {
    const auto st = pick_stream(ss, ck >= chunks0);
    const int c0 = (ck < chunks0 ? ck : ck - chunks0) * CK;
    const float* xn = st.x + static_cast<size_t>(n) * st.C * H * W;
    constexpr int kPieces = RW / 4;
    float* rb = raw + buf * Cfg::kRaw;
    for (int i = tid; i < CK * SH * kPieces; i += kThreads) {
      const int j = i % kPieces, rest = i / kPieces;  // rest = ch * SH + r
      const int r = rest % SH, c = c0 + rest / SH;
      const int y = m0 + r, xx = n0 + 4 * j;
      const bool ok = c < st.C && y < H && xx < W;
      cp_async16(rb + rest * RW + 4 * j, ok ? xn + (static_cast<size_t>(c) * H + y) * W + xx : xn,
                 ok ? 16 : 0);
    }
    float* wb = ws + buf * 2 * Cfg::kW;
    constexpr int kWP = CK / 4;  // 16-byte pieces a weight row
    for (int i = tid; i < 2 * 9 * COP * kWP; i += kThreads) {
      const int p = i % kWP, rest = i / kWP;  // rest = (part * 9 + tap) * COP + co
      const int co = rest % COP, pt = rest / COP;
      cp_async16(wb + rest * WS + 4 * p,
                 st.w + (static_cast<size_t>(pt) * co_pad + co0 + co) * st.c_pad + c0 + 4 * p,
                 16);
    }
    if (st.pro >= 0 && tid < 2 * CK) {
      const int c = c0 + tid % CK;
      const bool ok = c < st.C;
      cp_async4(ab + buf * 2 * CK + tid,
                (tid < CK ? st.A : st.B) + static_cast<size_t>(n) * st.C + (ok ? c : 0),
                ok ? 4 : 0);
    }
  };

  // acc[q][mt][j]: parity q = py * 2 + px of the warp's pixels
  float acc[4][MT][NT][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][j][e] = 0.f;

  prefetch(0, 0);
  cp_async_commit();
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int buf = ck & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ck landed; every warp is done with chunk ck - 1
    if (ck + 1 < n_chunks) prefetch(ck + 1, buf ^ 1);  // overlaps this chunk's work
    cp_async_commit();
    const float* rb = raw + buf * Cfg::kRaw;
    const float* abb = ab + buf * 2 * CK;
    switch (pick_stream(ss, ck >= chunks0).pro) {  // the stream's prologue, block-uniform
      case 0: convt_stage_tf32x3<Cfg, 0>(rb, abb, stage, m0, n0, H, W); break;
      case 1: convt_stage_tf32x3<Cfg, 1>(rb, abb, stage, m0, n0, H, W); break;
      case 2: convt_stage_tf32x3<Cfg, 2>(rb, abb, stage, m0, n0, H, W); break;
      default: convt_stage_tf32x3<Cfg, -1>(rb, abb, stage, m0, n0, H, W); break;
    }
    __syncthreads();
    convt_tf32x3_products<Cfg>(acc, stage, ws + buf * 2 * Cfg::kW, wrow, wcol, lane);
  }
  __syncthreads();  // the epilogue reuses the staging memory

  // bias, stats from the f32 value, act; the parities interleave in shared
  // memory so that each output row leaves in 16-byte pieces
  float* ot = reinterpret_cast<float*>(smem_raw);  // [COP][2 TH][OW]
  float* red = ot + COP * OP;                       // [2][kWarps][COP]
  const bool row_in = m0 + wrow < H;
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int py = q >> 1, px = q & 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = wcol + mt * 16 + g + 8 * (e >> 1);
          const int co = j * 8 + 2 * t + (e & 1);
          const float yv = acc[q][mt][j][e] + bias[co0 + co];  // bias is padded to co_pad
          if (row_in && n0 + col < W && co0 + co < Co) {
            s1[j][e & 1] += yv;
            s2[j][e & 1] += yv * yv;
          }
          ot[co * OP + (2 * wrow + py) * OW + 2 * col + px] = apply_act(yv, act);
        }
  }
  if (psum != nullptr) {
    // over the 8 pixel rows g of the fragments, then the warps in order
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = s1[j][h], b = s2[j][h];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, m);
          b += __shfl_xor_sync(0xffffffffu, b, m);
        }
        if (lane < 4) {
          red[warp * COP + j * 8 + 2 * lane + h] = a;
          red[(kWarps + warp) * COP + j * 8 + 2 * lane + h] = b;
        }
      }
  }
  __syncthreads();
  if (psum != nullptr && tid < COP && co0 + tid < Co) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * COP + tid];
      b += red[(kWarps + w) * COP + tid];
    }
    const int tiles = gridDim.x * gridDim.y;
    const size_t k = (static_cast<size_t>(n) * Co + co0 + tid) * tiles +
                     blockIdx.y * gridDim.x + blockIdx.x;
    psum[k] = a;
    psq[k] = b;
  }
  constexpr int kPieces = OW / 4;
  const int H2 = 2 * H, W2 = 2 * W;
  for (int i = tid; i < COP * 2 * TH * kPieces; i += kThreads) {
    const int kc = i % kPieces, rest = i / kPieces;  // rest = co * 2 TH + r
    const int r = rest % (2 * TH), co = rest / (2 * TH);
    const int y = 2 * m0 + r, xx = 2 * n0 + 4 * kc;
    if (co0 + co < Co && y < H2 && xx < W2) {
      const size_t dst = ((static_cast<size_t>(n) * Co + co0 + co) * H2 + y) * W2 + xx;
      *reinterpret_cast<float4*>(out + dst) =
          *reinterpret_cast<const float4*>(ot + co * OP + r * OW + 4 * kc);
    }
  }
}

int pick_cop(int Co) {
  int cop = kCPT;
  while (cop < Co && cop < kCoMax) cop *= 2;
  return cop;
}

// the split-precision K4a's channel block, at most 32 (co_pad stays a
// multiple of it)
int convt_tf32x3_cop(int Co) { return pick_cop(Co) < 32 ? pick_cop(Co) : 32; }

bool bad_act(int act) { return act < 0 || act > 2; }

template <typename T, int COP>
int launch_conv3(const Stream& st, const float* bias, void* out, float* psum, float* psq,
                 int N, int H, int W, int Co, int co_pad, int act, cudaStream_t stream) {
  const int co_blocks = co_pad / COP;
  const dim3 grid((W + kTX - 1) / kTX, (H + Conv3Cfg<COP>::TH - 1) / Conv3Cfg<COP>::TH,
                  N * co_blocks);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv3x3_kernel<T, COP><<<grid, kThreads, 0, stream>>>(
      st, bias, static_cast<T*>(out), psum, psq, H, W, Co, co_blocks, co_pad, act);
  return static_cast<int>(cudaGetLastError());
}

template <int COP, int PRO>
int launch_conv3_mma(const __nv_bfloat16* x, const __nv_bfloat16* wp, const float* A,
                     const float* B, const float* bias, __nv_bfloat16* out, float* psum,
                     float* psq, int N, int C, int H, int W, int Co, int co_pad, int act,
                     cudaStream_t stream) {
  using Cfg = MmaCfg<COP>;
  const int co_blocks = co_pad / COP;
  const dim3 grid((W + Cfg::TW - 1) / Cfg::TW, (H + Cfg::TH - 1) / Cfg::TH, N * co_blocks);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_mma_kernel<COP, PRO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_mma_kernel<COP, PRO><<<grid, kThreads, Cfg::kSmem, stream>>>(
      x, wp, A, B, bias, out, psum, psq, C, mma_c_pad(C), H, W, Co, co_blocks, co_pad, act);
  return static_cast<int>(cudaGetLastError());
}

// the prologue's activation as a template argument: no per-element branches
template <int COP>
int launch_conv3_mma(const __nv_bfloat16* x, const __nv_bfloat16* wp, const float* A,
                     const float* B, int pro, const float* bias, __nv_bfloat16* out, float* psum,
                     float* psq, int N, int C, int H, int W, int Co, int co_pad, int act,
                     cudaStream_t s) {
  switch (pro) {
    case 0:
      return launch_conv3_mma<COP, 0>(x, wp, A, B, bias, out, psum, psq, N, C, H, W, Co,
                                      co_pad, act, s);
    case 1:
      return launch_conv3_mma<COP, 1>(x, wp, A, B, bias, out, psum, psq, N, C, H, W, Co,
                                      co_pad, act, s);
    case 2:
      return launch_conv3_mma<COP, 2>(x, wp, A, B, bias, out, psum, psq, N, C, H, W, Co,
                                      co_pad, act, s);
    default:
      return launch_conv3_mma<COP, -1>(x, wp, A, B, bias, out, psum, psq, N, C, H, W, Co,
                                       co_pad, act, s);
  }
}

template <int COP, int PRO>
int launch_conv3_tf32x3(const float* x, const float* wp, const float* A, const float* B,
                        const float* bias, float* out, float* psum, float* psq, int N, int C,
                        int H, int W, int Co, int co_pad, int act, cudaStream_t stream) {
  using Cfg = Tf32Cfg<COP>;
  const int co_blocks = co_pad / COP;
  const dim3 grid((W + Cfg::TW - 1) / Cfg::TW, (H + Cfg::TH - 1) / Cfg::TH, N * co_blocks);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_tf32x3_kernel<COP, PRO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_tf32x3_kernel<COP, PRO><<<grid, kThreads, Cfg::kSmem, stream>>>(
      x, wp, A, B, bias, out, psum, psq, C, mma_c_pad(C), H, W, Co, co_blocks, co_pad, act);
  return static_cast<int>(cudaGetLastError());
}

template <int COP>
int launch_conv3_tf32x3(const float* x, const float* wp, const float* A, const float* B, int pro,
                        const float* bias, float* out, float* psum, float* psq, int N, int C,
                        int H, int W, int Co, int co_pad, int act, cudaStream_t s) {
  switch (pro) {
    case 0:
      return launch_conv3_tf32x3<COP, 0>(x, wp, A, B, bias, out, psum, psq, N, C, H, W, Co,
                                         co_pad, act, s);
    case 1:
      return launch_conv3_tf32x3<COP, 1>(x, wp, A, B, bias, out, psum, psq, N, C, H, W, Co,
                                         co_pad, act, s);
    case 2:
      return launch_conv3_tf32x3<COP, 2>(x, wp, A, B, bias, out, psum, psq, N, C, H, W, Co,
                                         co_pad, act, s);
    default:
      return launch_conv3_tf32x3<COP, -1>(x, wp, A, B, bias, out, psum, psq, N, C, H, W, Co,
                                          co_pad, act, s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

template <typename T, int COP>
int launch_convt(const Streams& ss, const float* bias, void* out, float* psum, float* psq,
                 int N, int H, int W, int Co, int co_pad, int act, cudaStream_t stream) {
  const int co_blocks = co_pad / COP;
  const dim3 grid((W + kTX - 1) / kTX, (H + ConvTCfg<COP>::TIH - 1) / ConvTCfg<COP>::TIH,
                  N * co_blocks);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  convt_pair_kernel<T, COP><<<grid, kThreads, 0, stream>>>(
      ss, bias, static_cast<T*>(out), psum, psq, H, W, Co, co_blocks, co_pad, act);
  return static_cast<int>(cudaGetLastError());
}

template <int COP>
int launch_convt_mma(const MmaStreams<__nv_bfloat16>& ss, const float* bias,
                     __nv_bfloat16* out, float* psum, float* psq, int N, int H, int W, int Co,
                     int co_pad, int act, cudaStream_t stream) {
  using Cfg = ConvTMmaCfg<COP>;
  const int co_blocks = co_pad / COP;
  const dim3 grid((W + Cfg::TW - 1) / Cfg::TW, (H + Cfg::TH - 1) / Cfg::TH, N * co_blocks);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err =
      cudaFuncSetAttribute(convt_pair_mma_kernel<COP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  convt_pair_mma_kernel<COP><<<grid, kThreads, Cfg::kSmem, stream>>>(
      ss, bias, out, psum, psq, H, W, Co, co_blocks, co_pad, act);
  return static_cast<int>(cudaGetLastError());
}

template <int COP>
int launch_convt_tf32x3(const MmaStreams<float>& ss, const float* bias, float* out, float* psum,
                        float* psq, int N, int H, int W, int Co, int co_pad, int act,
                        cudaStream_t stream) {
  using Cfg = ConvTTf32Cfg<COP>;
  const int co_blocks = co_pad / COP;
  const dim3 grid((W + Cfg::TW - 1) / Cfg::TW, (H + Cfg::TH - 1) / Cfg::TH, N * co_blocks);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(convt_pair_tf32x3_kernel<COP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  convt_pair_tf32x3_kernel<COP><<<grid, kThreads, Cfg::kSmem, stream>>>(
      ss, bias, out, psum, psq, H, W, Co, co_blocks, co_pad, act);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int N, int H, int W, int Co) {
  // offsets inside one (output) plane are ints
  return N < 1 || H < 1 || W < 1 || Co < 1 || static_cast<long long>(H) * W * 4 > 0x7fffffff;
}

template <typename T>
int conv3(const void* x, const void* w, const void* A, const void* B, const void* bias,
          void* out, void* psum, void* psq, int N, int C, int H, int W, int Co, int co_pad,
          int pro, int act, void* stream) {
  if (bad_shape(N, H, W, Co) || C < 1 || pro > 2 || bad_act(act) ||
      co_pad != (Co + pick_cop(Co) - 1) / pick_cop(Co) * pick_cop(Co))
    return static_cast<int>(cudaErrorInvalidValue);
  const Stream st{x, static_cast<const float*>(w), static_cast<const float*>(A),
                  static_cast<const float*>(B), C, pro < 0 ? -1 : pro};
  const float* b = static_cast<const float*>(bias);
  float* s1 = static_cast<float*>(psum);
  float* s2 = static_cast<float*>(psq);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (pick_cop(Co)) {
    case 8: return launch_conv3<T, 8>(st, b, out, s1, s2, N, H, W, Co, co_pad, act, cs);
    case 16: return launch_conv3<T, 16>(st, b, out, s1, s2, N, H, W, Co, co_pad, act, cs);
    case 32: return launch_conv3<T, 32>(st, b, out, s1, s2, N, H, W, Co, co_pad, act, cs);
    default: return launch_conv3<T, 64>(st, b, out, s1, s2, N, H, W, Co, co_pad, act, cs);
  }
}

template <typename T>
int convt(const void* x0, const void* w0, const void* A0, const void* B0, int C0, int pro0,
          const void* x1, const void* w1, const void* A1, const void* B1, int C1, int pro1,
          int count, const void* bias, void* out, void* psum, void* psq, int N, int H, int W,
          int Co, int co_pad, int act, void* stream) {
  if (bad_shape(N, H, W, Co) || count < 1 || count > 2 || C0 < 1 ||
      (count == 2 && C1 < 1) || pro0 > 2 || pro1 > 2 || bad_act(act) ||
      co_pad != (Co + pick_cop(Co) - 1) / pick_cop(Co) * pick_cop(Co))
    return static_cast<int>(cudaErrorInvalidValue);
  Streams ss;
  ss.s[0] = Stream{x0, static_cast<const float*>(w0), static_cast<const float*>(A0),
                   static_cast<const float*>(B0), C0, pro0 < 0 ? -1 : pro0};
  ss.s[1] = Stream{x1, static_cast<const float*>(w1), static_cast<const float*>(A1),
                   static_cast<const float*>(B1), C1, pro1 < 0 ? -1 : pro1};
  ss.count = count;
  const float* b = static_cast<const float*>(bias);
  float* s1 = static_cast<float*>(psum);
  float* s2 = static_cast<float*>(psq);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (pick_cop(Co)) {
    case 8: return launch_convt<T, 8>(ss, b, out, s1, s2, N, H, W, Co, co_pad, act, cs);
    case 16: return launch_convt<T, 16>(ss, b, out, s1, s2, N, H, W, Co, co_pad, act, cs);
    case 32: return launch_convt<T, 32>(ss, b, out, s1, s2, N, H, W, Co, co_pad, act, cs);
    default: return launch_convt<T, 64>(ss, b, out, s1, s2, N, H, W, Co, co_pad, act, cs);
  }
}

}  // namespace

// K4b. x [N, C, H, W] and out [N, Co, H, W] contiguous, of one type; w
// [C, 9, co_pad] f32; A, B [N, C] f32 (read when pro >= 0); bias [co_pad]
// f32; psum, psq [N, Co, tiles] f32 or null for no stats. pro < 0: no
// prologue, else its activation (0 none, 1 ReLU, 2 LeakyReLU(0.1)); act the
// output's. co_pad is fmi_decoder_conv_co_pad(Co), tiles
// fmi_decoder_conv_tiles(0, H, W, Co). Returns a cudaError_t code; 0 means
// launched.
extern "C" int fmi_conv3x3_stats_f32(const void* x, const void* w, const void* A,
                                     const void* B, const void* bias, void* out, void* psum,
                                     void* psq, int N, int C, int H, int W, int Co, int co_pad,
                                     int pro, int act, void* stream) {
  return conv3<float>(x, w, A, B, bias, out, psum, psq, N, C, H, W, Co, co_pad, pro, act,
                      stream);
}

extern "C" int fmi_conv3x3_stats_bf16(const void* x, const void* w, const void* A,
                                      const void* B, const void* bias, void* out, void* psum,
                                      void* psq, int N, int C, int H, int W, int Co,
                                      int co_pad, int pro, int act, void* stream) {
  return conv3<__nv_bfloat16>(x, w, A, B, bias, out, psum, psq, N, C, H, W, Co, co_pad, pro,
                              act, stream);
}

// Which K4b kernel takes a call: 1 the tensor-core kernel (bf16, W % 8 == 0,
// x and out 16-byte aligned), 2 the split-precision tensor-core kernel (f32,
// W % 4 == 0, x and out 16-byte aligned), 0 the CUDA-core kernel. By type,
// shape and alignment only.
extern "C" int fmi_conv3x3_route(int bf16, const void* x, const void* out, int W) {
  if (!aligned16(x) || !aligned16(out)) return 0;
  if (bf16) return W % 8 == 0 ? 1 : 0;
  return W % 4 == 0 ? 2 : 0;
}

// K4b on the tensor cores, for the calls fmi_conv3x3_route sends there: as
// fmi_conv3x3_stats_bf16, but w is bf16 [9][c_pad][co_pad] (tap ky * 3 + kx,
// input channel, output channel; c_pad = fmi_decoder_conv_c_pad(C); zeros
// past C and Co) and tiles is fmi_decoder_conv_tiles(2, H, W, Co).
extern "C" int fmi_conv3x3_stats_bf16_mma(const void* x, const void* w, const void* A,
                                          const void* B, const void* bias, void* out,
                                          void* psum, void* psq, int N, int C, int H, int W,
                                          int Co, int co_pad, int pro, int act, void* stream) {
  if (bad_shape(N, H, W, Co) || C < 1 || pro > 2 || bad_act(act) ||
      co_pad != (Co + pick_cop(Co) - 1) / pick_cop(Co) * pick_cop(Co) ||
      !fmi_conv3x3_route(1, x, out, W) ||
      !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  using B16 = __nv_bfloat16;
  const B16* xb = static_cast<const B16*>(x);
  const B16* wb = static_cast<const B16*>(w);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* bs = static_cast<const float*>(bias);
  B16* o = static_cast<B16*>(out);
  float* s1 = static_cast<float*>(psum);
  float* s2 = static_cast<float*>(psq);
  const int p = pro < 0 ? -1 : pro;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (pick_cop(Co)) {
    case 8:
      return launch_conv3_mma<8>(xb, wb, a, b, p, bs, o, s1, s2, N, C, H, W, Co, co_pad, act, cs);
    case 16:
      return launch_conv3_mma<16>(xb, wb, a, b, p, bs, o, s1, s2, N, C, H, W, Co, co_pad, act, cs);
    case 32:
      return launch_conv3_mma<32>(xb, wb, a, b, p, bs, o, s1, s2, N, C, H, W, Co, co_pad, act, cs);
    default:
      return launch_conv3_mma<64>(xb, wb, a, b, p, bs, o, s1, s2, N, C, H, W, Co, co_pad, act, cs);
  }
}

// K4b in f32 on the tensor cores in split precision, for the calls
// fmi_conv3x3_route sends there: as fmi_conv3x3_stats_f32, but w is f32
// [2][9][co_pad][c_pad] (tf32 hi, then lo = tf32(w - hi); tap ky * 3 + kx,
// output channel, input channel; c_pad = fmi_decoder_conv_c_pad(C); zeros
// past C and Co) and tiles is fmi_decoder_conv_tiles(2, H, W, Co).
extern "C" int fmi_conv3x3_stats_f32_tf32x3(const void* x, const void* w, const void* A,
                                            const void* B, const void* bias, void* out,
                                            void* psum, void* psq, int N, int C, int H, int W,
                                            int Co, int co_pad, int pro, int act,
                                            void* stream) {
  if (bad_shape(N, H, W, Co) || C < 1 || pro > 2 || bad_act(act) ||
      co_pad != (Co + pick_cop(Co) - 1) / pick_cop(Co) * pick_cop(Co) ||
      fmi_conv3x3_route(0, x, out, W) != 2 || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* bs = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* s1 = static_cast<float*>(psum);
  float* s2 = static_cast<float*>(psq);
  const int p = pro < 0 ? -1 : pro;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (pick_cop(Co)) {
    case 8:
      return launch_conv3_tf32x3<8>(xf, wf, a, b, p, bs, o, s1, s2, N, C, H, W, Co, co_pad, act,
                                    cs);
    case 16:
      return launch_conv3_tf32x3<16>(xf, wf, a, b, p, bs, o, s1, s2, N, C, H, W, Co, co_pad, act,
                                     cs);
    case 32:
      return launch_conv3_tf32x3<32>(xf, wf, a, b, p, bs, o, s1, s2, N, C, H, W, Co, co_pad, act,
                                     cs);
    default:
      return launch_conv3_tf32x3<64>(xf, wf, a, b, p, bs, o, s1, s2, N, C, H, W, Co, co_pad, act,
                                     cs);
  }
}

// K4a. Streams 0 and 1 (count of them live): x_s [N, C_s, H, W], w_s
// [C_s, 9, co_pad] f32 from torch's [C_s, Co, 3, 3], A_s, B_s and pro_s as
// for K4b; bias [co_pad] f32, the streams' biases summed; out
// [N, Co, 2H, 2W]; psum, psq [N, Co, tiles] f32 or null, tiles being
// fmi_decoder_conv_tiles(1, H, W, Co).
extern "C" int fmi_convt_pair_f32(const void* x0, const void* w0, const void* A0,
                                  const void* B0, int C0, int pro0, const void* x1,
                                  const void* w1, const void* A1, const void* B1, int C1,
                                  int pro1, int count, const void* bias, void* out, void* psum,
                                  void* psq, int N, int H, int W, int Co, int co_pad, int act,
                                  void* stream) {
  return convt<float>(x0, w0, A0, B0, C0, pro0, x1, w1, A1, B1, C1, pro1, count, bias, out,
                      psum, psq, N, H, W, Co, co_pad, act, stream);
}

extern "C" int fmi_convt_pair_bf16(const void* x0, const void* w0, const void* A0,
                                   const void* B0, int C0, int pro0, const void* x1,
                                   const void* w1, const void* A1, const void* B1, int C1,
                                   int pro1, int count, const void* bias, void* out,
                                   void* psum, void* psq, int N, int H, int W, int Co,
                                   int co_pad, int act, void* stream) {
  return convt<__nv_bfloat16>(x0, w0, A0, B0, C0, pro0, x1, w1, A1, B1, C1, pro1, count, bias,
                              out, psum, psq, N, H, W, Co, co_pad, act, stream);
}

// Which K4a kernel takes a call: 1 the tensor-core kernel (bf16, W % 8 == 0),
// 2 the split-precision tensor-core kernel (f32, W % 4 == 0), both with
// every map 16-byte aligned (x1 null for one stream), 0 the CUDA-core
// kernel. By type, shape and alignment only.
extern "C" int fmi_convt_pair_route(int bf16, const void* x0, const void* x1, const void* out,
                                    int W) {
  if (!aligned16(x0) || !aligned16(x1) || !aligned16(out)) return 0;
  if (bf16) return W % 8 == 0 ? 1 : 0;
  return W % 4 == 0 ? 2 : 0;
}

// K4a on the tensor cores, for the calls fmi_convt_pair_route sends there:
// as fmi_convt_pair_bf16, but each w_s is bf16 [9][c_pad_s][co_pad] (tap
// ky * 3 + kx of torch's [C_s, Co, 3, 3], input channel, output channel;
// c_pad_s = fmi_decoder_conv_c_pad(C_s); zeros past C_s and Co) and tiles is
// fmi_decoder_conv_tiles(3, H, W, Co).
extern "C" int fmi_convt_pair_bf16_mma(const void* x0, const void* w0, const void* A0,
                                       const void* B0, int C0, int pro0, const void* x1,
                                       const void* w1, const void* A1, const void* B1, int C1,
                                       int pro1, int count, const void* bias, void* out,
                                       void* psum, void* psq, int N, int H, int W, int Co,
                                       int co_pad, int act, void* stream) {
  if (bad_shape(N, H, W, Co) || count < 1 || count > 2 || C0 < 1 ||
      (count == 2 && C1 < 1) || pro0 > 2 || pro1 > 2 || bad_act(act) ||
      co_pad != (Co + pick_cop(Co) - 1) / pick_cop(Co) * pick_cop(Co) ||
      fmi_convt_pair_route(1, x0, count == 2 ? x1 : nullptr, out, W) != 1 || !aligned16(w0) ||
      (count == 2 && !aligned16(w1)))
    return static_cast<int>(cudaErrorInvalidValue);
  using B16 = __nv_bfloat16;
  MmaStreams<B16> ss;
  ss.s[0] = MmaStream<B16>{static_cast<const B16*>(x0), static_cast<const B16*>(w0),
                      static_cast<const float*>(A0), static_cast<const float*>(B0), C0,
                      mma_c_pad(C0), pro0 < 0 ? -1 : pro0};
  ss.s[1] = MmaStream<B16>{static_cast<const B16*>(x1), static_cast<const B16*>(w1),
                      static_cast<const float*>(A1), static_cast<const float*>(B1), C1,
                      count == 2 ? mma_c_pad(C1) : 0, pro1 < 0 ? -1 : pro1};
  ss.count = count;
  const float* b = static_cast<const float*>(bias);
  B16* o = static_cast<B16*>(out);
  float* s1 = static_cast<float*>(psum);
  float* s2 = static_cast<float*>(psq);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (pick_cop(Co)) {
    case 8: return launch_convt_mma<8>(ss, b, o, s1, s2, N, H, W, Co, co_pad, act, cs);
    case 16: return launch_convt_mma<16>(ss, b, o, s1, s2, N, H, W, Co, co_pad, act, cs);
    case 32: return launch_convt_mma<32>(ss, b, o, s1, s2, N, H, W, Co, co_pad, act, cs);
    default: return launch_convt_mma<64>(ss, b, o, s1, s2, N, H, W, Co, co_pad, act, cs);
  }
}

// K4a in f32 on the tensor cores in split precision, for the calls
// fmi_convt_pair_route sends there: as fmi_convt_pair_f32, but each w_s is
// f32 [2][9][co_pad][c_pad_s] (tf32 hi, then lo = tf32(w - hi); tap ky * 3 +
// kx of torch's [C_s, Co, 3, 3], output channel, input channel; c_pad_s =
// fmi_decoder_conv_c_pad(C_s); zeros past C_s and Co) and tiles is
// fmi_decoder_conv_tiles(4, H, W, Co).
extern "C" int fmi_convt_pair_f32_tf32x3(const void* x0, const void* w0, const void* A0,
                                         const void* B0, int C0, int pro0, const void* x1,
                                         const void* w1, const void* A1, const void* B1, int C1,
                                         int pro1, int count, const void* bias, void* out,
                                         void* psum, void* psq, int N, int H, int W, int Co,
                                         int co_pad, int act, void* stream) {
  if (bad_shape(N, H, W, Co) || count < 1 || count > 2 || C0 < 1 ||
      (count == 2 && C1 < 1) || pro0 > 2 || pro1 > 2 || bad_act(act) ||
      co_pad != (Co + pick_cop(Co) - 1) / pick_cop(Co) * pick_cop(Co) ||
      fmi_convt_pair_route(0, x0, count == 2 ? x1 : nullptr, out, W) != 2 || !aligned16(w0) ||
      (count == 2 && !aligned16(w1)))
    return static_cast<int>(cudaErrorInvalidValue);
  MmaStreams<float> ss;
  ss.s[0] = MmaStream<float>{static_cast<const float*>(x0), static_cast<const float*>(w0),
                             static_cast<const float*>(A0), static_cast<const float*>(B0), C0,
                             mma_c_pad(C0), pro0 < 0 ? -1 : pro0};
  ss.s[1] = MmaStream<float>{static_cast<const float*>(x1), static_cast<const float*>(w1),
                             static_cast<const float*>(A1), static_cast<const float*>(B1), C1,
                             count == 2 ? mma_c_pad(C1) : 0, pro1 < 0 ? -1 : pro1};
  ss.count = count;
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* s1 = static_cast<float*>(psum);
  float* s2 = static_cast<float*>(psq);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (convt_tf32x3_cop(Co)) {
    case 8: return launch_convt_tf32x3<8>(ss, b, o, s1, s2, N, H, W, Co, co_pad, act, cs);
    case 16: return launch_convt_tf32x3<16>(ss, b, o, s1, s2, N, H, W, Co, co_pad, act, cs);
    default: return launch_convt_tf32x3<32>(ss, b, o, s1, s2, N, H, W, Co, co_pad, act, cs);
  }
}

// co_pad for Co output channels: Co rounded up to the kernels' channel
// block (8, 16, 32 or 64). The wrapper sizes the weights and bias with it.
extern "C" int fmi_decoder_conv_co_pad(int Co) {
  const int cop = pick_cop(Co);
  return (Co + cop - 1) / cop * cop;
}

// c_pad for C input channels: the C extent of the tensor-core K4b's packed
// weights (bf16 and f32), C rounded up to the bf16 kernel's channel chunk
// (16, a multiple of the f32 kernel's 8).
extern "C" int fmi_decoder_conv_c_pad(int C) { return mma_c_pad(C); }

// The number of tiles, i.e. the last dimension of psum and psq, of K4b on
// the CUDA cores (kind 0), K4a on the CUDA cores (kind 1), K4b on the tensor
// cores (kind 2: bf16, and f32 in split precision, whose tiles are the same),
// K4a on the tensor cores in bf16 (kind 3) or in f32 in split precision
// (kind 4) at H x W input and Co outputs.
extern "C" int fmi_decoder_conv_tiles(int kind, int H, int W, int Co) {
  if (kind == 4) {
    int th = 0;
    switch (convt_tf32x3_cop(Co)) {
      case 8: th = ConvTTf32Cfg<8>::TH; break;
      case 16: th = ConvTTf32Cfg<16>::TH; break;
      default: th = ConvTTf32Cfg<32>::TH; break;
    }
    return ((W + ConvTTf32Cfg<32>::TW - 1) / ConvTTf32Cfg<32>::TW) * ((H + th - 1) / th);
  }
  if (kind == 3) {
    int th = 0;
    switch (pick_cop(Co)) {
      case 8: th = ConvTMmaCfg<8>::TH; break;
      case 16: th = ConvTMmaCfg<16>::TH; break;
      case 32: th = ConvTMmaCfg<32>::TH; break;
      default: th = ConvTMmaCfg<64>::TH; break;
    }
    return ((W + ConvTMmaCfg<64>::TW - 1) / ConvTMmaCfg<64>::TW) * ((H + th - 1) / th);
  }
  if (kind == 2) {
    int th = 0;
    switch (pick_cop(Co)) {
      case 8: th = MmaCfg<8>::TH; break;
      case 16: th = MmaCfg<16>::TH; break;
      case 32: th = MmaCfg<32>::TH; break;
      default: th = MmaCfg<64>::TH; break;
    }
    return ((W + MmaCfg<64>::TW - 1) / MmaCfg<64>::TW) * ((H + th - 1) / th);
  }
  int th = 0;
  switch (pick_cop(Co)) {
    case 8: th = kind ? ConvTCfg<8>::TIH : Conv3Cfg<8>::TH; break;
    case 16: th = kind ? ConvTCfg<16>::TIH : Conv3Cfg<16>::TH; break;
    case 32: th = kind ? ConvTCfg<32>::TIH : Conv3Cfg<32>::TH; break;
    default: th = kind ? ConvTCfg<64>::TIH : Conv3Cfg<64>::TH; break;
  }
  return ((W + kTX - 1) / kTX) * ((H + th - 1) / th);
}
