"""Time kernel K3's tensor-core route against variants of its own source on
one NVIDIA GPU.

    python -m face_mask_inpaint_tpu_torch.tools.output_head_variants

A variant is ``csrc/output_head.cu`` with one part of the "mma_sync"
kernel's work taken out: the second of the flagship's two 16-channel
chunks, the whole staging pass, the tensor-core products, the act(h + s)
of the staging pass (the raw words are combined without the sums,
roundings and activations), the staged tile's writes to shared memory, the
TMA loads of h and s from device memory (the raw units keep what they
held), the epilogue's tanh, its cell sums, or the stores of the pooled
output. Each computes a wrong result, so its time says what that part
costs, not what a kernel could do; the committed source is checked against
``output_head_plain`` at the bf16 gate. Every variant is timed with CUDA
events through its C entry point (without the wrapper's weight packing) at
the flagship head ([16, 32, 1024, 1024], co = 3, f = 4, bf16, with the
pair bias the decoder hands it), twice, in
turns (a, b, ..., b, a), beside the wrapper's own call and the CUDA-core
kernel's entry point on the same inputs. Prints one line with the bytes and
bound, and the card's name and power limit. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from face_mask_inpaint_tpu_torch.kernels import output_head as oh
from face_mask_inpaint_tpu_torch.tools import tensor_core_variants as tcv

_MMA = ("              mma_bf16(acc[(R - ky) * CB + cb], a, bw[ky * 3 + kx][0], "
        "bw[ky * 3 + kx][1]);")
_ACT = """      for (int i = 0; i < 4; ++i)
        a[k][i] = act_sum2<LEAKY>(word(hv[k], i), word(sv[k], i), b[k]);"""
_STAGE = "      *reinterpret_cast<uint4*>(stage + (r * SW + 1 + 8 * j + p) * SP + half * 8) ="
_TMA = """    mbar_expect_tx(&full[b], 2 * kRaw * static_cast<unsigned>(sizeof(bf16)));
    tma_load_4d(raw + 2 * b * kRaw, &hmap, &full[b], x0 - 8, y0 - 1, c, n);
    tma_load_4d(raw + (2 * b + 1) * kRaw, &smap, &full[b], x0 - 8, y0 - 1, c, n);"""
_TANH = "          ot[(ch * TH + row) * TW + col] = tanhf(acc[mt][e] + bias[ch]);"
_STORE = """      out[((static_cast<size_t>(n) * co + o) * hc + cy0 + cy) * wc + cx0 + cx] =
          __float2bfloat16(sum * inv);"""
_CHUNKS = "  const int tiles = tiles_x * tiles_y * N, chunks = c_pad / CK;"
_STAGING = ("    stage_unit<TH, LEAKY>(raw + 2 * b * kRaw, raw + (2 * b + 1) * kRaw, stage, ws, wp, "
            "pb, half,")
_CELLS = "    for (int task = tid; task < cells * co; task += kThreads) {"
VARIANTS = {
    "as committed": {},
    "one chunk": {_CHUNKS: "  const int tiles = tiles_x * tiles_y * N, chunks = 1;"},
    "no staging": {_STAGING: "    if (c_pad < 0) " + _STAGING.strip()},
    "no cell sums": {_CELLS: "    for (int task = tid; task < cells * co * (f < 0); task += kThreads) {"},
    "no products": {_MMA: "              ;  // no products"},
    # the raw unit's words are still read and combined
    "no act": {_ACT: "      for (int i = 0; i < 4; ++i) a[k][i] = word(hv[k], i) ^ word(sv[k], i);"},
    "no staged stores": {_STAGE: "      if (a[0][0] == 0x12345678u && a[7][3] == 0x9abcdef0u)\n" + _STAGE},
    # the barrier completes on the arrival alone: the raw units keep what they held
    "no loads from device memory": {_TMA: "    mbar_arrive(&full[b]);"},
    "no tanh": {_TANH: "          ot[(ch * TH + row) * TW + col] = acc[mt][e] + bias[ch];"},
    "no stores": {_STORE: "      if (sum == 12345.f)\n" + _STORE},
}
SHAPE, CO, POOL = (16, 32, 1024, 1024), 3, 4


def main() -> int:
    if not torch.cuda.is_available():
        print("output_head_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = tcv._build("output_head", VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, c, height, width = SHAPE
    h = (torch.randn(SHAPE, device="cuda", generator=gen) * 2).bfloat16()
    s = torch.randn(SHAPE, device="cuda", generator=gen).bfloat16()
    w = torch.randn(CO, c, 3, 3, device="cuda", generator=gen) / (3 * c ** 0.5)
    b = torch.randn(CO, device="cuda", generator=gen) * 0.1
    pb = torch.randn(c, device="cuda", generator=gen)
    assert oh.output_head_route(SHAPE, torch.bfloat16, POOL) == "mma_sync"
    c_pad = -(-c // 16) * 16
    wp, bias = oh._weights_mma(w, c_pad), b.float().contiguous()
    w_cores = torch.zeros((c, 9, 4), device="cuda")
    w_cores[:, :, :CO] = w.bfloat16().float().permute(1, 2, 3, 0).reshape(c, 9, CO)
    out = torch.empty((n, CO, height // POOL, width // POOL), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for variant, lib in libs.items():
        fn = tcv._c_function(lib, "fmi_output_head_bf16_mma",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])

        def call(fn=fn):
            tcv._checked(fn(h.data_ptr(), s.data_ptr(), wp.data_ptr(), bias.data_ptr(), pb.data_ptr(),
                            out.data_ptr(), n, c, c_pad, height, width, CO, POOL, 1, stream))
        calls[variant] = call
    calls["as committed"]()
    torch.cuda.synchronize()
    ref = oh.output_head_plain(h, s, w, b, "LeakyReLU", POOL, pb).float()
    err = (out.float() - ref).abs()
    if not bool((err <= 1e-3 + 2.0 ** -7 * ref.abs()).all()):
        raise RuntimeError(f"K3: the committed kernel misses the bf16 gate ({float(err.max())})")
    cores = tcv._c_function(libs["as committed"], "fmi_output_head_bf16",
                            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    calls["CUDA-core kernel"] = lambda: tcv._checked(cores(
        h.data_ptr(), s.data_ptr(), w_cores.data_ptr(), bias.data_ptr(), pb.data_ptr(), out.data_ptr(), n,
        c, height, width, CO, POOL, 1, stream))
    calls["wrapper"] = lambda: oh.output_head(h, s, w, b, "LeakyReLU", POOL, pb)
    nbytes = 2 * h.numel() * h.element_size() + out.numel() * out.element_size()
    tcv._report(f"K3 flagship head {list(SHAPE)} co={CO} f={POOL} bf16 ({nbytes / 1e9:.3f} GB, "
                f"bound {nbytes / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s)",
                tcv._in_turns(calls, 10), card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
