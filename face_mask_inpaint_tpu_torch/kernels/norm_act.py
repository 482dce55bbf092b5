"""K2: fused instance norm + activation (Triton).

Replaces face_mask_inpaint_tpu/ops/pallas/norm_act.py ``instance_norm_act``
(``_stats_kernel`` and ``_apply_kernel``):

    pass 1: per-(n, c) sum x and sum x^2 in f32          (one read)
    finish: the [N, C] affine a, b (plain torch, as the JAX package leaves it
            to XLA), var = E[x^2] - mu^2 clamped at 0, eps 1e-5
    pass 2: y = act(a * x + b), act in LeakyReLU(slope) | ReLU | none
                                                         (one read, one write)

What bounds it on an H100: it is a reduction followed by an elementwise pass
with no matrix products, so bytes moved bound it: two reads and one write of
the map. Triton's block reductions reach that floor as well as CUDA C++
would. Design: at NCHW every (n, c) plane is contiguous; pass 1 splits each
plane into 16K-element chunks (one program each, partial sums summed in
torch) so the 512^2 decoder planes spread over the whole card, and pass 2 is
one program per 2K elements of a plane, reading that plane's a, b once.

``instance_norm_act`` launches the kernels for CUDA tensors and raises on what
they cannot take; for CPU tensors it runs ``instance_norm_act_plain``, a port
of ``instance_norm_act_reference``, which is also what the kernel is held
against on the card. Where a gradient is needed it runs inside a
``torch.autograd.Function`` whose backward recomputes the plain version under
autograd and differentiates it, as the JAX ``custom_vjp`` does
(norm_act.py:143-159): JAX has no Pallas backward for K2, so neither has the
port.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

__all__ = ["instance_norm_act", "instance_norm_act_plain", "ACTS"]

ACTS = ("LeakyReLU", "ReLU", "none")
_STATS_CHUNK = 16384
_STATS_BLOCK = 1024
_APPLY_BLOCK = 2048


def _act(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "LeakyReLU":
        return torch.where(y >= 0, y, y * slope)
    if act == "ReLU":
        return torch.clamp_min(y, 0.0)
    if act == "none":
        return y
    raise NotImplementedError(act)


def instance_norm_act_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                            bias: Optional[torch.Tensor], act: str = "LeakyReLU",
                            slope: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version over NCHW: f32 stats, E[x^2] - mu^2 clamped at 0."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    sq = x32.square().mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min(sq - mean.square(), 0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()[None, :, None, None] + bias.float()[None, :, None, None]
    return _act(y, act, slope).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, part_ptr, hw, CHUNK: tl.constexpr, BLOCK: tl.constexpr):
        plane = tl.program_id(0)
        split = tl.program_id(1)
        base = x_ptr + plane.to(tl.int64) * hw
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, CHUNK, BLOCK):
            idx = split * CHUNK + off + tl.arange(0, BLOCK)
            v = tl.load(base + idx, mask=idx < hw, other=0.0).to(tl.float32)
            acc += v
            acc2 += v * v
        out = part_ptr + (plane.to(tl.int64) * tl.num_programs(1) + split) * 2
        tl.store(out, tl.sum(acc, axis=0))
        tl.store(out + 1, tl.sum(acc2, axis=0))

    @triton.jit
    def apply_kernel(x_ptr, a_ptr, b_ptr, y_ptr, hw, slope,
                     ACT: tl.constexpr, BLOCK: tl.constexpr):
        plane = tl.program_id(0)
        idx = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        mask = idx < hw
        base = plane.to(tl.int64) * hw
        x = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
        y = x * tl.load(a_ptr + plane) + tl.load(b_ptr + plane)
        if ACT == 0:
            y = tl.where(y >= 0, y, y * slope)
        elif ACT == 1:
            y = tl.maximum(y, 0.0)
        tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton.cdiv, stats_kernel, apply_kernel


def _check(x, weight, bias, act) -> None:
    if x.dim() != 4:
        raise ValueError(f"instance_norm_act takes NCHW, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm_act takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("instance_norm_act takes a contiguous NCHW tensor")
    if act not in ACTS:
        raise NotImplementedError(act)
    if (weight is None) != (bias is None):
        raise ValueError("give both weight and bias, or neither")
    for p in (weight, bias):
        if p is not None and (p.shape != (x.shape[1],) or p.device != x.device):
            raise ValueError("weight/bias must be [C] on the input's device")


def _forward(x, weight, bias, act, slope, eps) -> torch.Tensor:
    """K2 for CUDA tensors, the plain version for CPU tensors (no autograd)."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, weight, bias, act, slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act runs on cpu or cuda, not {x.device}")
    _check(x, weight, bias, act)
    n, c, h, w = x.shape
    hw = h * w
    cdiv, stats_kernel, apply_kernel = _triton_kernels()
    n_split = cdiv(hw, _STATS_CHUNK)
    with torch.cuda.device(x.device):
        parts = torch.empty((n * c, n_split, 2), dtype=torch.float32, device=x.device)
        stats_kernel[(n * c, n_split)](x, parts, hw, CHUNK=_STATS_CHUNK,
                                       BLOCK=_STATS_BLOCK, num_warps=4)
        sums = parts.sum(dim=1)
        mean = sums[:, 0] / hw
        var = torch.clamp_min(sums[:, 1] / hw - mean * mean, 0.0)
        a = torch.rsqrt(var + eps).view(n, c)
        mean = mean.view(n, c)
        if weight is not None:
            a = a * weight.float()[None, :]
            b = bias.float()[None, :] - mean * a
        else:
            b = -mean * a
        y = torch.empty_like(x)
        apply_kernel[(n * c, cdiv(hw, _APPLY_BLOCK))](
            x, a.contiguous(), b.contiguous(), y, hw, float(slope),
            ACT=ACTS.index(act), BLOCK=_APPLY_BLOCK, num_warps=4)
    instance_norm_act.launches += 1
    return y


class _InstanceNormAct(torch.autograd.Function):
    """K2 forward; the backward differentiates the plain version, recomputed
    from the saved input (JAX ``_ina_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, act, slope, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.config = (act, slope, eps)
        return _forward(x, weight, bias, act, slope, eps)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_() if need else t
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = instance_norm_act_plain(*inputs, *ctx.config)
            grads = iter(torch.autograd.grad(
                y, [t for t, need in zip(inputs, ctx.needs_input_grad) if need], dy))
        return (*(next(grads) if need else None
                  for need in ctx.needs_input_grad[:3]), None, None, None)


def instance_norm_act(x: torch.Tensor, weight: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor], act: str = "LeakyReLU",
                      slope: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Fused instance norm (+ optional affine) + activation over NCHW.

    x: [N, C, H, W] float32 or bfloat16; weight/bias: [C] or None. CPU
    tensors take the plain version; CUDA tensors launch K2. Differentiable
    in x, weight and bias.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _InstanceNormAct.apply(x, weight, bias, act, slope, eps)
    return _forward(x, weight, bias, act, slope, eps)


instance_norm_act.launches = 0
