"""K6: separable upfirdn2d as two 1-D passes (CUDA C++, ``csrc/upfirdn2d.cu``).

Replaces face_mask_inpaint_tpu/ops/pallas/upfirdn2d_pallas.py
``upfirdn2d_pallas`` (``upfirdn1d_axis``, run once along H and once along
W). For x [N, C, H, W], 1-D taps k and a mode (up, down):

    1. zero-upsample by ``up`` along each axis,
    2. pad by (pad0, pad1) per edge (a negative pad crops),
    3. filter with the separable 2-D kernel outer(k, k) as a true
       convolution (the taps are flipped, upfirdn2d_pallas.py:219-220),
    4. keep every ``down``-th sample.

Output side (L * up + pad0 + pad1 - len(k)) // down + 1. Each pass sums in
f32 and rounds once to x's dtype; the H pass's result is stored in x's dtype
before the W pass reads it, as ``upfirdn1d_axis`` writes it. The taps come
from the caller's 1-D list (``ops.upfirdn2d.make_taps``), with any gain
already split evenly between the two axes: no decomposition of a 2-D kernel.

``upfirdn2d`` is a ``torch.autograd.Function``. Its forward launches the
kernel for CUDA tensors in the modes (1, 1), (2, 1) and (1, 2), the ones
StyleGAN2 uses, and raises for any other mode; for CPU tensors it runs
``upfirdn2d_plain``, which is also what the kernel is held against on the
card. It saves only x's shape, as the JAX ``_make_op.fwd`` does
(upfirdn2d_pallas.py:222-223). Its backward is ``upfirdn2d_bwd``: the same
Function with (up, down) swapped, the taps reversed and the pads transposed
(upfirdn2d_pallas.py:225-235), so the StyleGAN2 modes map onto the kernel's
own, (1, 1) -> (1, 1), (2, 1) -> (1, 2), (1, 2) -> (2, 1), and grad-of-grad
runs the forward mode again. ``upfirdn2d.launches`` counts the forward
calls and ``upfirdn2d_bwd.launches`` the backward ones, on CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.kernels import build

__all__ = ["upfirdn2d", "upfirdn2d_bwd", "upfirdn2d_plain", "transposed_pads", "out_len",
           "MODES"]

MODES = ((1, 1), (2, 1), (1, 2))
_MAX_TAPS = 16
_SYMBOLS = {torch.float32: "fmi_upfirdn1d_f32", torch.bfloat16: "fmi_upfirdn1d_bf16"}


def out_len(n: int, up: int, down: int, pad0: int, pad1: int, k: int) -> int:
    return (n * up + pad0 + pad1 - k) // down + 1


def _flipped(taps: Sequence[float]) -> np.ndarray:
    k = np.asarray(taps, np.float32).reshape(-1)
    return np.ascontiguousarray(k[::-1])


def _pass_plain(x: torch.Tensor, k: np.ndarray, dim: int, up: int, down: int,
                pad: tuple[int, int]) -> torch.Tensor:
    """One 1-D pass along ``dim``: correlation with the (flipped) taps k,
    summed in f32 and rounded once to x's dtype."""
    xf = x.float().movedim(dim, -1)
    if up > 1:  # zero-insertion: [..., L] -> [..., L * up]
        zeros = torch.zeros_like(xf)
        xf = torch.stack([xf] + [zeros] * (up - 1), dim=-1).flatten(-2)
    xf = F.pad(xf, (int(pad[0]), int(pad[1])))  # a negative pad crops
    n_out = (xf.shape[-1] - len(k)) // down + 1
    acc = 0.0
    for t, kt in enumerate(k):
        acc = acc + float(kt) * xf[..., t: t + (n_out - 1) * down + 1: down]
    return acc.movedim(-1, dim).to(x.dtype)


def upfirdn2d_plain(x: torch.Tensor, taps: Sequence[float], up: int = 1, down: int = 1,
                    pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch version over NCHW, any (up, down): the H pass, rounded
    to x's dtype, then the W pass, as the kernel computes it."""
    if x.dim() != 4:
        raise ValueError(f"upfirdn2d takes NCHW, got {tuple(x.shape)}")
    k = _flipped(taps)
    return _pass_plain(_pass_plain(x, k, 2, up, down, pad), k, 3, up, down, pad)


def _check(x: torch.Tensor, k: np.ndarray, up: int, down: int, pad) -> None:
    if x.dim() != 4:
        raise ValueError(f"upfirdn2d takes NCHW, got {tuple(x.shape)}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"upfirdn2d takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("upfirdn2d takes a contiguous NCHW tensor")
    if (up, down) not in MODES:
        raise NotImplementedError(f"upfirdn2d mode (up={up}, down={down}) has no CUDA kernel; "
                                  f"the kernel takes (up, down) in {MODES}")
    if not 1 <= len(k) <= _MAX_TAPS:
        raise ValueError(f"upfirdn2d takes 1..{_MAX_TAPS} taps, got {len(k)}")
    h, w = x.shape[2:]
    if min(out_len(h, up, down, *pad, len(k)), out_len(w, up, down, *pad, len(k))) < 1:
        raise ValueError(f"upfirdn2d of {h}x{w} with pad {pad} and {len(k)} taps is empty")


def _function(dtype: torch.dtype):
    fn = getattr(build.load("upfirdn2d"), _SYMBOLS[dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, taps: Sequence[float], up: int, down: int,
            pad: tuple[int, int]) -> torch.Tensor:
    """One K6 call (two CUDA launches, the H pass and the W pass)."""
    k = _flipped(taps)
    _check(x, k, up, down, pad)
    n, c, h, w = x.shape
    ho = out_len(h, up, down, *pad, len(k))
    wo = out_len(w, up, down, *pad, len(k))
    kp = k.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    fn = _function(x.dtype)
    mid = torch.empty((n, c, ho, w), dtype=x.dtype, device=x.device)
    out = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for src, dst, hh, axis, length in ((x, mid, h, 0, ho), (mid, out, ho, 1, wo)):
            rc = fn(src.data_ptr(), dst.data_ptr(), kp, len(k), n * c, hh, w, axis, up,
                    down, pad[0], length, stream)
            if rc != 0:
                raise RuntimeError(f"upfirdn2d launch failed: cudaError {rc}")
    return out


def transposed_pads(in_len: int, out_len_: int, ktaps: int, up: int, down: int,
                    pad0: int) -> tuple[int, int]:
    """Pads of the gradient's upfirdn2d along one axis of length ``in_len``
    whose forward output had ``out_len_`` samples (upfirdn2d_pallas.py:229-
    230): (k - pad0 - 1, in_len * up - out_len * down + pad0 - up + 1)."""
    return ktaps - pad0 - 1, in_len * up - out_len_ * down + pad0 - up + 1


class _Upfirdn2d(torch.autograd.Function):
    """upfirdn2d over NCHW; ``counter`` is the wrapper whose ``launches``
    this call adds to on a CUDA tensor."""

    @staticmethod
    def forward(ctx, x, taps, up, down, pad, counter):
        ctx.consts = tuple(x.shape[2:]), taps, up, down, pad
        if x.device.type == "cpu":
            return upfirdn2d_plain(x, taps, up, down, pad)
        if x.device.type != "cuda":
            raise ValueError(f"upfirdn2d runs on cpu or cuda, not {x.device}")
        out = _launch(x, taps, up, down, pad)
        counter.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        in_hw, taps, up, down, pad = ctx.consts
        return upfirdn2d_bwd(g, taps, up, down, pad, in_hw), None, None, None, None, None


def upfirdn2d(x: torch.Tensor, taps: Sequence[float], up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """upfirdn2d of NCHW x with the separable kernel outer(taps, taps).

    x: [N, C, H, W] contiguous, float32 or bfloat16; taps: the 1-D filter
    (at most 16). CPU tensors take the plain version; CUDA tensors launch
    K6. ``launches`` counts calls: one call makes two CUDA launches, the H
    pass and the W pass.
    """
    taps = tuple(float(t) for t in np.asarray(taps, np.float32).reshape(-1))
    return _Upfirdn2d.apply(x, taps, int(up), int(down), (int(pad[0]), int(pad[1])),
                            upfirdn2d)


def upfirdn2d_bwd(g: torch.Tensor, taps: Sequence[float], up: int, down: int,
                  pad: tuple[int, int], in_hw: tuple[int, int]) -> torch.Tensor:
    """The gradient of ``upfirdn2d(x, taps, up, down, pad)`` with respect to
    x of spatial size ``in_hw``, from the output gradient g: upfirdn2d of g
    with (down, up), the taps reversed and the transposed pads, themselves
    differentiable. CUDA tensors launch K6 (counted in ``launches``)."""
    taps = tuple(float(t) for t in taps)
    pads = {transposed_pads(n, m, len(taps), up, down, pad[0])
            for n, m in zip(in_hw, g.shape[2:])}
    if len(pads) != 1:
        raise ValueError(f"upfirdn2d_bwd: the H and W axes need different pads {pads}; "
                         "the kernel takes one pair for both")
    (gpad,) = pads
    return _Upfirdn2d.apply(g.contiguous(), taps[::-1], down, up, gpad, upfirdn2d_bwd)


upfirdn2d.launches = 0
upfirdn2d_bwd.launches = 0
