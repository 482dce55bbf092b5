"""Time the tensor-core kernels K4b, K4a, K5 and K1 against diagnostic
variants of their own sources on one NVIDIA GPU.

    python -m face_mask_inpaint_tpu_torch.tools.tensor_core_variants

A variant is ``csrc/decoder_conv.cu``, ``csrc/flash_attention_bwd.cu`` or
``csrc/flash_attention_fwd.cu`` with one part of one kernel's work taken out
(K4b and K4a: the staging pass that applies the prologue and lays the chunk
out channel-innermost, the tensor-core products, the cp.async copies of the
next chunk; K5: the f32 atomics of dq's query role; K1: the P V products,
the exp2 of the softmax, the rescale of O) or moved (K5: v_c's A fragments
read from shared memory instead of kept in registers), built with the
port's nvcc flags into ``build/kernels/variants/``. A variant that takes work out
computes a wrong result: its time says what that work costs, not what a
kernel could do. The committed source is checked against its plain version.
Every variant is timed with CUDA events through its C entry point (so
without the wrapper's host work) at the flagship shapes (K4b and K4a:
decoders 3 and 4 at batch 16; K5: config 5; K1: the flagship's 128^2
attention at batch 16), twice, in turns (a, b, ..., b, a), beside the
wrapper's own call (the C entry point plus the wrapper's host work: weight
packing, padding, the stats sum) and the PyTorch call that computes the same
function. Prints one line per kernel and shape and the card's name and power
limit. Exits non-zero without CUDA.

The variants are made by replacing fragments of the committed sources, and
the tool raises when a fragment is not found. It backs the breakdown of the
four kernels in PERF.md; a redesign that changes these fragments retires the
variants of that kernel rather than carrying them along.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.kernels import build
from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa

_K5_ATOMICS = """        atomicAdd(reinterpret_cast<float2*>(dst_row + j * 8 + 2 * t),
                  make_float2(dqr[j][2 * h], dqr[j][2 * h + 1]));
    }
  }"""
_K5_VF_LOAD = """  for (int kk = 0; kk < CP / 16; ++kk)
    ldmatrix_x4(vf[kk],"""
_K5_VF_USE = """        mma_bf16(dp[2 * jp], vf[kk], b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], vf[kk], b[2], b[3]);"""
_K4A_STAGE = "    switch (pick_stream(ss, ck >= chunks0).pro) {"
_K4A_MMA = "    for (int tap = 0; tap < 9; ++tap) {  // each tap feeds one parity"
_K4A_PREFETCH = "    if (ck + 1 < n_chunks) prefetch(ck + 1, buf ^ 1);"
_K1_PV = "      for (int kk = 0; kk < 4; ++kk) wgmma_m64n256k16_rs(oacc, pa[kk], vdesc + 128 * kk);"
_K1_EXP2 = "            sacc[4 * j + e] = exp2f(fmaf(sacc[4 * j + e], kLog2e, -m_new));"
_K1_RESCALE = """          oacc[4 * j + 2 * h] *= alpha[h];
          oacc[4 * j + 2 * h + 1] *= alpha[h];"""
# each variant's name starts with the kernel it is timed for
VARIANTS = {
    "decoder_conv": {
        "as committed": {},
        "K4b no staging pass": {"    transpose(buf);\n": "    if (n_chunks < 0) transpose(buf);\n"},
        "K4b no products": {"    for (int tap = 0; tap < 9; ++tap) {":
                            "    for (int tap = 0; tap < 9 * (n_chunks < 0); ++tap) {"},
        "K4b no prefetch of the next chunk": {
            "    if (ck + 1 < n_chunks) prefetch((ck + 1) * CK":
            "    if (ck + 1 < n_chunks && n_chunks < 0) prefetch((ck + 1) * CK"},
        "K4a no staging pass": {_K4A_STAGE: "    if (n_chunks < 0)\n" + _K4A_STAGE},
        "K4a no products": {_K4A_MMA: _K4A_MMA.replace("tap < 9;", "tap < 9 * (n_chunks < 0);")},
        "K4a no prefetch of the next chunk": {
            _K4A_PREFETCH: _K4A_PREFETCH.replace("n_chunks)", "n_chunks && n_chunks < 0)")},
    },
    "flash_attention_fwd": {
        "as committed": {},
        "K1 no P V products": {_K1_PV: _K1_PV.replace("kk < 4;", "kk < 4 * (n_tiles < 0);")},
        "K1 no exp2": {_K1_EXP2: _K1_EXP2.replace("exp2f(", "(")},
        "K1 no rescale of O": {_K1_RESCALE: ""},
    },
    "flash_attention_bwd": {
        "as committed": {},
        "K5 no query-role atomics": {_K5_ATOMICS: _K5_ATOMICS.replace(
            "        atomicAdd(", "        if (dqr[j][2 * h] == -1e30f) atomicAdd(")},
        "K5 v_c fragments from shared memory": {
            _K5_VF_LOAD: _K5_VF_LOAD.replace("kk < CP / 16", "kk < 0"),
            _K5_VF_USE: """        unsigned a[4];
        ldmatrix_x4(a, &vc[(kw * 16 + (lm & 1) * 8 + li) * CS + kk * 16 + (lm >> 1) * 8]);
        mma_bf16(dp[2 * jp], a, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], a, b[2], b[3]);"""},
    },
}
# (name, C, Co, H = W) of the flagship's decoders 3 and 4, batch 16
DECODERS = [("decoder 3", 128, 64, 256), ("decoder 4", 64, 32, 512)]
CONFIG5 = (16, 16384, 64, 256)  # N, L, d, C


def _build(name: str) -> dict[str, ctypes.CDLL]:
    source = (build.CSRC / f"{name}.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (variant, edits) in enumerate(VARIANTS[name].items()):
        text = source
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"{name} variant {variant!r}: {old!r} not in the source")
            text = text.replace(old, new, 1)
        src, lib = out_dir / f"{name}_v{i}.cu", out_dir / f"{name}_v{i}.so"
        src.write_text(text)
        procs[variant] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {variant!r}:\n{log}")
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _in_turns(calls: dict, reps: int) -> dict[str, list[float]]:
    """Each call timed twice, in the order a, b, ..., b, a."""
    times = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            times[k].append(_time_ms(calls[k], reps))
    return times


def _report(label: str, times: dict[str, list[float]], card: str) -> None:
    print(f"{label} on {card}: " + "; ".join(
        f"{k} {' / '.join(f'{t:.3f}' for t in v)} ms" for k, v in times.items()), flush=True)


def _mine(libs: dict, kernel: str) -> dict:
    """The committed build and the variants of one kernel."""
    return {k: v for k, v in libs.items() if k == "as committed" or k.startswith(kernel + " ")}


def _c_function(lib, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _checked(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")


def _k4b(libs, gen, card: str) -> None:
    for label, c, co, hw in DECODERS:
        n = 16
        x = (torch.randn(n, c, hw, hw, device="cuda", generator=gen) * 1.5 + 0.2).bfloat16()
        w = torch.randn(co, c, 3, 3, device="cuda", generator=gen) / (3 * c ** 0.5)
        b = 0.5 * torch.randn(co, device="cuda", generator=gen)
        a_ = (0.5 + torch.rand(n, c, device="cuda", generator=gen)).contiguous()
        b_ = 0.3 * torch.randn(n, c, device="cuda", generator=gen)
        co_pad = dc._function("fmi_decoder_conv_co_pad")(co)
        c_pad = dc._function("fmi_decoder_conv_c_pad")(c)
        wp, bias = dc._weights_mma(w, c_pad, co_pad), dc._padded(b, co_pad)
        out = torch.empty(n, co, hw, hw, dtype=torch.bfloat16, device="cuda")
        calls = {}
        for variant, lib in _mine(libs, "K4b").items():
            fn = _c_function(lib, "fmi_conv3x3_stats_bf16_mma",
                             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            tiles = _c_function(lib, "fmi_decoder_conv_tiles", [ctypes.c_int] * 4)
            parts = torch.empty((2, n, co, tiles(2, hw, hw, co)), device="cuda")

            def call(fn=fn, parts=parts):
                _checked(fn(x.data_ptr(), wp.data_ptr(), a_.data_ptr(), b_.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), parts[0].data_ptr(),
                            parts[1].data_ptr(), n, c, hw, hw, co, co_pad, 2, 0,
                            torch.cuda.current_stream().cuda_stream))
            calls[variant] = call
        calls["as committed"]()
        want = dc.conv3x3_stats_plain(x, w, b, (a_, b_, "LeakyReLU"))
        err = (out.float() - want.float()).abs()
        if not bool((err <= 1e-3 + 2.0 ** -7 * want.float().abs()).all()):
            raise RuntimeError(f"K4b {label}: the committed kernel disagrees with its plain "
                               f"version (max_abs_err {float(err.max()):.3e})")
        wb, bb = w.bfloat16(), b.bfloat16()
        calls["wrapper"] = lambda: dc.conv3x3_stats(x, w, b, (a_, b_, "LeakyReLU"),
                                                    with_stats=True)
        calls["cuDNN conv2d (no prologue, no stats)"] = lambda: F.conv2d(x, wb, bb, padding=1)
        _report(f"K4b {label} N={n} C={c} Co={co} H=W={hw} bf16", _in_turns(calls, 10), card)


def _k4a(libs, gen, card: str) -> None:
    """Decoder 3 with stats and no activation, decoder 4 with LeakyReLU and
    no stats, as the packed-convt forward runs them: the h stream (Co
    channels) with the LeakyReLU prologue, the x stream (C) without."""
    for label, c, co, hw in DECODERS:
        n = 16
        with_stats = label == "decoder 3"
        act = None if with_stats else "LeakyReLU"
        h = (torch.randn(n, co, hw, hw, device="cuda", generator=gen) * 1.5 + 0.2).bfloat16()
        x = (torch.randn(n, c, hw, hw, device="cuda", generator=gen) * 1.5 + 0.2).bfloat16()
        w2 = torch.randn(co, co, 3, 3, device="cuda", generator=gen) / (3 * co ** 0.5)
        wb = torch.randn(c, co, 3, 3, device="cuda", generator=gen) / (3 * c ** 0.5)
        b2, bb = (0.5 * torch.randn(co, device="cuda", generator=gen) for _ in range(2))
        a_ = (0.5 + torch.rand(n, co, device="cuda", generator=gen)).contiguous()
        b_ = 0.3 * torch.randn(n, co, device="cuda", generator=gen)
        streams = [(h, w2, b2, (a_, b_, "LeakyReLU")), (x, wb, bb)]
        c_pad = dc._function("fmi_decoder_conv_c_pad")
        co_pad = dc._function("fmi_decoder_conv_co_pad")(co)
        p2, pb = (dc._convt_weights_mma(w, c_pad(w.shape[0]), co_pad) for w in (w2, wb))
        bias = dc._padded(b2 + bb, co_pad)
        out = torch.empty(n, co, 2 * hw, 2 * hw, dtype=torch.bfloat16, device="cuda")
        calls = {}
        for variant, lib in _mine(libs, "K4a").items():
            fn = _c_function(lib, "fmi_convt_pair_bf16_mma", dc._ARGTYPES["fmi_convt_pair"])
            tiles = _c_function(lib, "fmi_decoder_conv_tiles", [ctypes.c_int] * 4)
            parts = (torch.empty((2, n, co, tiles(3, hw, hw, co)), device="cuda")
                     if with_stats else None)

            def call(fn=fn, parts=parts):
                _checked(fn(h.data_ptr(), p2.data_ptr(), a_.data_ptr(), b_.data_ptr(), co, 2,
                            x.data_ptr(), pb.data_ptr(), None, None, c, -1, 2, bias.data_ptr(),
                            out.data_ptr(), None if parts is None else parts[0].data_ptr(),
                            None if parts is None else parts[1].data_ptr(), n, hw, hw, co,
                            co_pad, dc._ACT_CODE[act], torch.cuda.current_stream().cuda_stream))
            calls[variant] = call
        calls["as committed"]()
        want = dc.convt_pair_plain(streams, act)
        err = (out.float() - want.float()).abs()
        if not bool((err <= 1e-3 + 2.0 ** -7 * want.float().abs()).all()):
            raise RuntimeError(f"K4a {label}: the committed kernel disagrees with its plain "
                               f"version (max_abs_err {float(err.max()):.3e})")
        del want
        w2b, wbb, b2b, bbb = w2.bfloat16(), wb.bfloat16(), b2.bfloat16(), bb.bfloat16()
        calls["wrapper"] = lambda: dc.convt_pair(streams, act, with_stats)
        calls["cuDNN conv_transpose2d x2 + add (no prologue, no stats)"] = lambda: (
            F.conv_transpose2d(h, w2b, b2b, 2, 1, 1) + F.conv_transpose2d(x, wbb, bbb, 2, 1, 1))
        _report(f"K4a {label} N={n} C_h={co} C_x={c} Co={co} H=W={hw} bf16",
                _in_turns(calls, 10), card)


def _k5(libs, gen, card: str) -> None:
    n, l, d, c = CONFIG5
    q = (torch.randn(n, l, d, device="cuda", generator=gen) / d ** 0.5 * 2).bfloat16()
    v = torch.randn(n, l, c, device="cuda", generator=gen).bfloat16()
    (o,), lse = fa.flash_attention(q, [v], with_lse=True)
    do = torch.randn(n, l, c, device="cuda", generator=gen).bfloat16()
    dsum = (do.float() * o.float()).sum(-1)
    dq, dv = torch.empty_like(q), torch.empty_like(v)
    work = torch.empty(n, l, d, device="cuda")
    calls = {}
    for variant, lib in _mine(libs, "K5").items():
        fn = _c_function(lib, "fmi_flash_attention_bwd_bf16",
                         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

        def call(fn=fn):
            _checked(fn(q.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        dsum.data_ptr(), dq.data_ptr(), dv.data_ptr(), work.data_ptr(), n, l, d, c,
                        torch.cuda.current_stream().cuda_stream))
        calls[variant] = call
    calls["as committed"]()
    for got, want in zip((dq, dv), fa.flash_attention_bwd_plain(q, v, lse, do, dsum)):
        err = float((got.float() - want.float()).abs().max())
        if err > 1e-2 * float(want.float().abs().max()):
            raise RuntimeError(f"K5: the committed kernel disagrees with its plain version "
                               f"(max_abs_err {err:.3e})")
    calls["wrapper"] = lambda: fa.flash_attention_bwd(q, v, lse, do, dsum)
    q4, v4 = q[:, None].detach().requires_grad_(), v[:, None].detach().requires_grad_()
    out = F.scaled_dot_product_attention(q4, q4, v4, scale=1.0)
    calls["SDPA backward"] = lambda: torch.autograd.grad(out, (q4, v4), do[:, None],
                                                         retain_graph=True)
    _report(f"K5 config 5 N={n} L={l} d={d} C={c} bf16", _in_turns(calls, 5), card)


def _k1(libs, gen, card: str) -> None:
    n, l, d, c = CONFIG5  # the flagship's attention: the same shape
    q = (torch.randn(n, l, d, device="cuda", generator=gen) / d ** 0.5 * 2).bfloat16()
    v = torch.randn(n, l, c, device="cuda", generator=gen).bfloat16()
    o = torch.empty_like(v)
    lse = torch.empty(n, l, device="cuda")
    if fa.flash_attention_route(q, [v]) != "wgmma":
        raise RuntimeError("K1: the flagship shape does not take the wgmma route")
    calls = {}
    for variant, lib in _mine(libs, "K1").items():
        fn = _c_function(lib, "fmi_flash_attention_fwd_bf16",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

        def call(fn=fn):
            _checked(fn(q.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), n, l, d, c,
                        torch.cuda.current_stream().cuda_stream))
        calls[variant] = call
    calls["as committed"]()
    (want,), want_lse = fa.flash_attention_plain(q, [v], with_lse=True)
    err = (o.float() - want.float()).abs()
    if (not bool((err <= 1e-3 + 2.0 ** -7 * want.float().abs()).all())
            or float((lse - want_lse).abs().max()) > 1e-3):
        raise RuntimeError(f"K1: the committed kernel disagrees with its plain version "
                           f"(max_abs_err {float(err.max()):.3e})")
    del want, want_lse
    calls["wrapper"] = lambda: fa.flash_attention(q, [v], with_lse=True)
    q4, v4 = q[:, None], v[:, None]
    calls["SDPA"] = lambda: F.scaled_dot_product_attention(q4, q4, v4, scale=1.0)
    _report(f"K1 flagship N={n} L={l} d={d} C={c} bf16", _in_turns(calls, 10), card)


def main() -> int:
    if not torch.cuda.is_available():
        print("tensor_core_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = _build("decoder_conv")
    _k4b(conv, gen, card)
    _k4a(conv, gen, card)
    _k5(_build("flash_attention_bwd"), gen, card)
    _k1(_build("flash_attention_fwd"), gen, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
