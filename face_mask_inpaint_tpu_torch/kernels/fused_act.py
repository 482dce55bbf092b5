"""K7a and K7b: the StyleGAN2 activation (CUDA C++) and its backward (Triton).

K7a replaces face_mask_inpaint_tpu/ops/pallas/fused_act_pallas.py
``fused_leaky_relu_pallas`` (``_run_fwd``):

    y = leaky_relu(x + bias, slope) * scale,   bias over dim 1 (channels)

computed in f32 and rounded once to x's dtype. x is [N, C, ...] (an NCHW map
or an [N, C] row batch); ``bias`` may be None (``scaled_leaky_relu``). Its
kernel is ``csrc/fused_act.cu``, built by nvcc at first use and called
through its C entry points. What bounds it on an H100: one read and one write
of each element and four operations, so bytes bound it: the 17 calls of a
config-4 forward (bf16, batch 16) move 8.410 GB, 2.510 ms at 3.35 TB/s. On
the card it runs them in 2.81 ms of device time (89% of the bound; 3.02 TB/s
at 1024^2), where the Triton kernel it replaced read 3.637-5.670 ms through
its wrapper; the 4^2 to 32^2 calls move 1% of the bytes and are bound by
the host's work, about 35 us a call (PERF.md, chip_smoke.py phase 8).
Design: 16-byte vectors, several loads a thread before its first
store; a block on a chunk of one plane reads that plane's bias once in its
own dtype (f32 or bf16, so no copy), the "plane" route; planes under 256
elements (4^2, 8^2 maps, [N, C] rows) take the "flat" route, each vector
finding its channel. ``_plan`` mirrors the C side's choice of route and
block size, and ``fused_leaky_relu_route`` names the route. Where x lies at
another offset from a 16-byte boundary than y (a view one element into its
allocation), or a plane's size is no multiple of the vector, single elements
take what vectors cannot, in the same launch.

K7b replaces ``_run_mask`` (fused_act_pallas.py:88), the backward from the
saved OUTPUT (the reference CUDA op's trick, fused_bias_act_kernel.cu):

    dx = g * (scale if y >= 0 else slope * scale)

in f32, rounded once to g's dtype; y >= 0 exactly where x + bias >= 0, as
scale > 0. dbias is dx summed per channel in f32 and cast to the bias's
dtype (g's, at every call site), a torch reduction outside the kernel, as
the JAX package computes it (fused_act_pallas.py:137-139). K7b is a Triton
kernel: two reads and one write an element, bytes bound it too; at NCHW
every (n, c) plane is contiguous, so one program covers up to 2048 elements
of one plane.

``fused_leaky_relu`` is one ``torch.autograd.Function``: its forward
launches K7a and saves y, its backward launches K7b through
``fused_leaky_relu_bwd``, itself a Function, so grad-of-grad works as the
JAX ``_mask_apply`` custom_vjp gives it: d/dg applies the same mask again
and d/dy is zero. CUDA tensors launch the kernels (or raise on what they
cannot take); CPU tensors run the same Functions with the plain versions,
``fused_leaky_relu_plain`` and ``fused_leaky_relu_bwd_plain``, which are
also what the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from face_mask_inpaint_tpu_torch.kernels import build

__all__ = ["fused_leaky_relu", "fused_leaky_relu_plain", "fused_leaky_relu_bwd",
           "fused_leaky_relu_bwd_plain", "fused_leaky_relu_route", "SQRT2"]

SQRT2 = math.sqrt(2.0)
_MAX_BLOCK = 2048
_MIN_BLOCK = 128
_SYMBOLS = {torch.float32: "fmi_fused_leaky_relu_f32",
            torch.bfloat16: "fmi_fused_leaky_relu_bf16"}
# K7a's block (csrc/fused_act.cu): at most _THREADS threads, _UNROLL 16-byte
# vectors a thread; planes under _FLAT_BELOW elements take the flat route
_THREADS = 256
_UNROLL = 4
_FLAT_BELOW = 256


def fused_leaky_relu_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                           negative_slope: float = 0.2, scale: float = SQRT2) -> torch.Tensor:
    """Plain PyTorch version: f32 arithmetic, one rounding to x's dtype."""
    y = x.float()
    if bias is not None:
        y = y + bias.float().view(1, -1, *([1] * (x.dim() - 2)))
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu_bwd_plain(y: torch.Tensor, g: torch.Tensor, negative_slope: float = 0.2,
                               scale: float = SQRT2) -> torch.Tensor:
    """Plain PyTorch version of the mask apply: g * (scale if y >= 0 else
    slope * scale), in f32, one rounding to g's dtype."""
    factor = torch.where(y >= 0, scale, negative_slope * scale)
    return (g.float() * factor).to(g.dtype)


class Plan(NamedTuple):
    """K7a's cut of a call with planes of ``hw`` elements: ``route`` "plane"
    (a block on a chunk of one plane) or "flat" (blocks on chunks of the
    flat tensor), ``threads`` a block and ``chunk`` elements a block (its
    threads times _UNROLL vectors of 16 bytes)."""
    route: str
    threads: int
    chunk: int


@functools.lru_cache(maxsize=None)
def _plan(hw: int, itemsize: int) -> Plan:
    """What csrc/fused_act.cu's ``fmi_fused_act_route`` and
    ``fmi_fused_act_threads`` choose for planes of hw elements of itemsize
    bytes: a plane smaller than a full block's chunk gets the warps its
    vectors fill."""
    vec = 16 // itemsize
    if hw < _FLAT_BELOW:
        return Plan("flat", _THREADS, _THREADS * _UNROLL * vec)
    threads = min(_THREADS, -(-hw // (32 * vec)) * 32)
    return Plan("plane", threads, threads * _UNROLL * vec)


def fused_leaky_relu_route(shape, dtype: torch.dtype) -> str:
    """"plane" or "flat": the route K7a takes for x of this shape and dtype."""
    if len(shape) < 2:
        raise ValueError(f"fused_leaky_relu takes [N, C, ...], got {tuple(shape)}")
    if dtype not in _SYMBOLS:
        raise TypeError(f"fused_leaky_relu takes float32 or bfloat16, got {dtype}")
    return _plan(math.prod(shape[2:]), torch.empty((), dtype=dtype).element_size()).route


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def bwd_kernel(y_ptr, g_ptr, dx_ptr, hw, neg_factor, pos_factor, BLOCK: tl.constexpr):
        plane = tl.program_id(0)
        idx = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        mask = idx < hw
        base = plane.to(tl.int64) * hw
        y = tl.load(y_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
        dx = g * tl.where(y >= 0, pos_factor, neg_factor)
        tl.store(dx_ptr + base + idx, dx.to(dx_ptr.dtype.element_ty), mask=mask)

    return triton.cdiv, triton.next_power_of_2, bwd_kernel


_ARGTYPES = {
    "fmi_fused_leaky_relu": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, ctypes.c_void_p],
    "fmi_fused_act_route": [ctypes.c_longlong],
    "fmi_fused_act_threads": [ctypes.c_longlong, ctypes.c_int],
}


@functools.lru_cache(maxsize=None)
def _function(name: str, dtype: Optional[torch.dtype] = None):
    """The C entry point ``name`` (K7a's ``_SYMBOLS`` entry for a dtype)."""
    fn = getattr(build.load("fused_act"), name if dtype is None else _SYMBOLS[dtype])
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.dim() < 2:
        raise ValueError(f"fused_leaky_relu takes [N, C, ...], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_leaky_relu takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_leaky_relu takes a contiguous tensor")
    if bias is not None and (bias.shape != (x.shape[1],) or bias.device != x.device):
        raise ValueError(f"bias must be [{x.shape[1]}] on the input's device, got "
                         f"{tuple(bias.shape)} on {bias.device}")


def _grid(x: torch.Tensor, what: str):
    cdiv, next_pow2 = _triton_kernel()[:2]
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    block = min(_MAX_BLOCK, max(_MIN_BLOCK, next_pow2(hw)))
    grid = (n * c, cdiv(hw, block))
    if grid[1] > 65535:
        raise ValueError(f"{what}: {hw} elements a channel is more than the grid "
                         f"takes ({65535 * block})")
    return grid, hw, block


def _call(x: torch.Tensor, bias: Optional[torch.Tensor], y: torch.Tensor,
          negative_slope: float, scale: float) -> None:
    """K7a's C entry point on x into y, checked tensors of one shape, and a
    bias in float32 or bfloat16 or None."""
    n, c = x.shape[:2]
    with torch.cuda.device(x.device):
        rc = _function("fmi_fused_leaky_relu", x.dtype)(
            x.data_ptr(), None if bias is None else bias.data_ptr(),
            int(bias is not None and bias.dtype == torch.bfloat16), y.data_ptr(), n * c,
            math.prod(x.shape[2:]), c, negative_slope, scale,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_leaky_relu launch failed: cudaError {rc}")


def _launch_fwd(x: torch.Tensor, bias: Optional[torch.Tensor], negative_slope: float,
                scale: float) -> torch.Tensor:
    """One K7a launch on CUDA tensors."""
    _check(x, bias)
    y = torch.empty_like(x)
    if bias is not None:
        if bias.dtype not in _SYMBOLS:
            bias = bias.float()
        bias = bias.contiguous()
    _call(x, bias, y, negative_slope, scale)
    fused_leaky_relu.launches += 1
    return y


def _launch_bwd(y: torch.Tensor, g: torch.Tensor, negative_slope: float,
                scale: float) -> torch.Tensor:
    """One K7b launch on CUDA tensors."""
    _check(g, None)
    if y.shape != g.shape or y.device != g.device or not y.is_contiguous():
        raise ValueError(f"fused_leaky_relu_bwd takes y and g of one shape, contiguous, on "
                         f"one device; got {tuple(y.shape)} on {y.device} and "
                         f"{tuple(g.shape)} on {g.device}")
    grid, hw, block = _grid(g, "fused_leaky_relu_bwd")
    dx = torch.empty_like(g)
    with torch.cuda.device(g.device):
        _triton_kernel()[2][grid](y, g, dx, hw, float(negative_slope * scale), float(scale),
                                  BLOCK=block, num_warps=4)
    fused_leaky_relu_bwd.launches += 1
    return dx


def _device(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return x.device.type


class _MaskApply(torch.autograd.Function):
    """dx = g * mask(y): K7b on CUDA tensors, the plain version on CPU ones.
    Its own backward applies the same mask to the incoming gradient (d/dg)
    and gives y none (the sign's derivative is zero almost everywhere)."""

    @staticmethod
    def forward(ctx, y, g, negative_slope, scale):
        ctx.save_for_backward(y)
        ctx.consts = negative_slope, scale
        if _device(g, "fused_leaky_relu_bwd") == "cpu":
            return fused_leaky_relu_bwd_plain(y, g, negative_slope, scale)
        return _launch_bwd(y, g, negative_slope, scale)

    @staticmethod
    def backward(ctx, gg):
        (y,) = ctx.saved_tensors
        return None, _MaskApply.apply(y, gg.contiguous(), *ctx.consts), None, None


def _forward(x: torch.Tensor, bias: Optional[torch.Tensor], negative_slope: float,
             scale: float) -> torch.Tensor:
    """K7a on CUDA tensors, the plain version on CPU ones."""
    if _device(x, "fused_leaky_relu") == "cpu":
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    return _launch_fwd(x, bias, negative_slope, scale)


class _FusedLeakyReLU(torch.autograd.Function):
    """y = leaky_relu(x + bias) * scale through ``_forward``, saving y; the
    backward is ``_MaskApply``."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        y = _forward(x, bias, negative_slope, scale)
        ctx.save_for_backward(y)
        ctx.consts = negative_slope, scale
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        dx = _MaskApply.apply(y, g.contiguous(), *ctx.consts)
        dbias = None
        if ctx.needs_input_grad[1]:
            dims = [d for d in range(dx.dim()) if d != 1]
            dbias = dx.float().sum(dim=dims).to(ctx.bias_dtype)
        return dx, dbias, None, None


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = SQRT2) -> torch.Tensor:
    """leaky_relu(x + bias, negative_slope) * scale, bias over dim 1.

    x: [N, C, ...] contiguous, float32 or bfloat16; bias: [C] or None. CPU
    tensors take the plain version; CUDA tensors launch K7a (one launch a
    call, counted in ``launches``) and, in the backward, K7b. Where autograd
    records nothing (no grad mode, or neither x nor bias requires grad) the
    call skips the Function's own host work.
    """
    if torch.is_grad_enabled() and (x.requires_grad or (bias is not None and bias.requires_grad)):
        return _FusedLeakyReLU.apply(x, bias, float(negative_slope), float(scale))
    return _forward(x, bias, float(negative_slope), float(scale))


def fused_leaky_relu_bwd(y: torch.Tensor, g: torch.Tensor, negative_slope: float = 0.2,
                         scale: float = SQRT2) -> torch.Tensor:
    """K7a's backward from its output y: g * (scale if y >= 0 else slope *
    scale). CPU tensors take the plain version; CUDA tensors launch K7b (one
    launch a call, counted in ``launches``). Differentiable in g."""
    return _MaskApply.apply(y.contiguous(), g.contiguous(), float(negative_slope), float(scale))


fused_leaky_relu.launches = 0
fused_leaky_relu_bwd.launches = 0
