"""K7a: fused bias + LeakyReLU + gain, the StyleGAN2 activation (Triton).

Replaces face_mask_inpaint_tpu/ops/pallas/fused_act_pallas.py
``fused_leaky_relu_pallas`` (``_run_fwd``):

    y = leaky_relu(x + bias, slope) * scale,   bias over dim 1 (channels)

computed in f32 and rounded once to x's dtype. x is [N, C, ...] (an NCHW map
or an [N, C] row batch); ``bias`` may be None (``scaled_leaky_relu``).

What bounds it on an H100: one read and one write of x, a handful of
operations an element, no reuse and no matrix products, so bytes bound it.
Triton's vectorized loads reach that floor as well as CUDA C++ would. Design:
at NCHW every (n, c) plane is contiguous, so one program covers up to 2048
elements of one plane and loads that plane's bias once.

``fused_leaky_relu`` launches the kernel for CUDA tensors and raises on what
it cannot take; for CPU tensors it runs ``fused_leaky_relu_plain``, which is
also what the kernel is held against on the card. Its backward (K7b,
``_run_mask``) comes with Stack B training, so on CUDA tensors the wrapper
raises when a gradient would be needed; the plain version is differentiable.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from face_mask_inpaint_tpu_torch.kernels.output_head import _no_grad_needed

__all__ = ["fused_leaky_relu", "fused_leaky_relu_plain", "SQRT2"]

SQRT2 = math.sqrt(2.0)
_MAX_BLOCK = 2048
_MIN_BLOCK = 128


def fused_leaky_relu_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                           negative_slope: float = 0.2, scale: float = SQRT2) -> torch.Tensor:
    """Plain PyTorch version: f32 arithmetic, one rounding to x's dtype."""
    y = x.float()
    if bias is not None:
        y = y + bias.float().view(1, -1, *([1] * (x.dim() - 2)))
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def fwd_kernel(x_ptr, b_ptr, y_ptr, hw, channels, slope, scale,
                   HAS_BIAS: tl.constexpr, BLOCK: tl.constexpr):
        plane = tl.program_id(0)
        idx = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        mask = idx < hw
        base = plane.to(tl.int64) * hw
        v = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
        if HAS_BIAS:
            v = v + tl.load(b_ptr + plane % channels)
        y = tl.where(v >= 0, v, v * slope) * scale
        tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton.cdiv, triton.next_power_of_2, fwd_kernel


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


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = SQRT2) -> torch.Tensor:
    """leaky_relu(x + bias, negative_slope) * scale, bias over dim 1.

    x: [N, C, ...] contiguous, float32 or bfloat16; bias: [C] or None. CPU
    tensors take the plain version; CUDA tensors launch K7a (one launch a
    call).
    """
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu runs on cpu or cuda, not {x.device}")
    _check(x, bias)
    _no_grad_needed("fused_leaky_relu", (x, bias))
    cdiv, next_pow2, fwd_kernel = _triton_kernel()
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    block = min(_MAX_BLOCK, max(_MIN_BLOCK, next_pow2(hw)))
    grid = (n * c, cdiv(hw, block))
    if grid[1] > 65535:
        raise ValueError(f"fused_leaky_relu: {hw} elements a channel is more than the grid "
                         f"takes ({65535 * block})")
    b = bias.float().contiguous() if bias is not None else x  # x stands in, unread
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fwd_kernel[grid](x, b, y, hw, c, float(negative_slope), float(scale),
                         HAS_BIAS=bias is not None, BLOCK=block, num_warps=4)
    fused_leaky_relu.launches += 1
    return y


fused_leaky_relu.launches = 0
