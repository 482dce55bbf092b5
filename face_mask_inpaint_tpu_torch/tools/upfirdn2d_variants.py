"""Time kernel K6 (upfirdn2d) against variants of its own source on one
NVIDIA GPU.

    python -m face_mask_inpaint_tpu_torch.tools.upfirdn2d_variants

A variant is ``csrc/upfirdn2d.cu`` with one part of the fused kernel's work
taken out: the H pass, the W pass's loads from the H pass's tile, the
staging pass's loads from device memory (the window is staged from
registers instead), or the stores of the output. Each computes a wrong
result, so its time says what that part costs, not what a kernel could do;
the committed source is checked against ``upfirdn2d_plain`` (value for
value). Every variant is timed with CUDA events through its C entry point
(without the wrapper's host work) at the largest calls of the paths that run
K6: the 1024^2 and 512^2 blurs of a config-4 forward (bf16, batch 16) and the
1024^2 blur's gradient of a config-4 training step (f32, batch 8), twice, in
turns (a, b, ..., b, a), beside the wrapper's own call and the depthwise
cuDNN call that computes the same function. Prints one line per call with
its bytes and bound, and the card's name and power limit. Exits non-zero
without CUDA.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
from face_mask_inpaint_tpu_torch.tools import tensor_core_variants as tcv

_H_LOOP = "      for (int i = threadIdx.x; i < groups * nw; i += kThreads) {"
_W_LOAD = "        for (int k = 0; k < R::NV; ++k) v[k] = m[swz(a + k)];"
_LOAD = "        raw = __ldg(reinterpret_cast<const uint4*>(xa + row0 + col));"
_STORE = "          *reinterpret_cast<uint4*>(d + c0) = pack16(o);"
_STORE1 = "            if (c0 + k < c1) d[c0 + k] = from_f<T>(o[k]);"
VARIANTS = {
    "as committed": {},
    "no H pass": {_H_LOOP: _H_LOOP.replace("groups * nw;", "groups * nw * (P < 0);")},
    "no W pass loads": {_W_LOAD: "        for (int k = 0; k < R::NV; ++k) v[k] = 0.f;"},
    "no loads from device memory": {_LOAD: "        raw = make_uint4(row, col, 0u, 0u);"},
    "no stores": {_STORE: "          if (o[0] == 12345.f) " + _STORE.strip(),
                  _STORE1: _STORE1.replace("if (c0 + k < c1)",
                                           "if (c0 + k < c1 && o[k] == 12345.f)")},
}
# (label, input shape, dtype, pad) of mode (1, 1) with StyleGAN2's 4-tap blur
CALLS = [("config-4 forward, 1024^2 blur", (16, 32, 1025, 1025), torch.bfloat16, (1, 1)),
         ("config-4 forward, 512^2 blur", (16, 64, 513, 513), torch.bfloat16, (1, 1)),
         ("config-4 step, the 1024^2 blur's gradient", (8, 32, 1024, 1024), torch.float32,
          (2, 2))]
TAPS = [0.25, 0.75, 0.75, 0.25]  # make_taps([1, 3, 3, 1], 4): gain 2 an axis


def _cudnn(x: torch.Tensor, pad: int) -> torch.Tensor:
    """The same function as one depthwise cuDNN call (the taps are symmetric)."""
    k = torch.tensor(TAPS, dtype=x.dtype, device=x.device)
    w = (k[:, None] * k[None, :]).expand(x.shape[1], 1, 4, 4).contiguous()
    return F.conv2d(x, w, padding=pad, groups=x.shape[1])


def main() -> int:
    if not torch.cuda.is_available():
        print("upfirdn2d_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = tcv._build("upfirdn2d", VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = fir._flipped(TAPS)
    kp = k.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
                + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    for label, shape, dtype, pad in CALLS:
        n, c, h, w = shape
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        ho, wo = (fir.out_len(s, 1, 1, *pad, len(TAPS)) for s in (h, w))
        out = torch.empty(n, c, ho, wo, dtype=dtype, device="cuda")
        calls = {}
        for variant, lib in libs.items():
            fn = tcv._c_function(lib, fir._SYMBOLS[dtype], argtypes)

            def call(fn=fn):
                tcv._checked(fn(x.data_ptr(), out.data_ptr(), kp, len(TAPS), n * c, h, w, 1, 1,
                                pad[0], ho, wo, torch.cuda.current_stream().cuda_stream))
            calls[variant] = call
        calls["as committed"]()
        torch.cuda.synchronize()
        if not torch.equal(out, fir.upfirdn2d_plain(x, TAPS, 1, 1, pad)):
            raise RuntimeError(f"K6 {label}: the committed kernel disagrees with its plain "
                               "version")
        calls["wrapper"] = lambda: fir.upfirdn2d(x, TAPS, 1, 1, pad)
        calls["cuDNN depthwise conv2d"] = lambda: _cudnn(x, pad[0])
        nbytes = (x.numel() + out.numel()) * x.element_size()
        tcv._report(f"K6 {label} {list(shape)} {str(dtype).split('.')[-1]} ({nbytes / 1e9:.3f} "
                    f"GB, bound {nbytes / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s)",
                    tcv._in_turns(calls, 10), card)
        del x, out
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
