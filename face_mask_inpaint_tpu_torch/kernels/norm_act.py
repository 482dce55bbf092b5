"""K2: fused instance norm + activation (CUDA C++, ``csrc/norm_act.cu``).

Replaces face_mask_inpaint_tpu/ops/pallas/norm_act.py ``instance_norm_act``
(``_stats_kernel``, ``_apply_kernel`` and the finish between them):

    per (n, c): sum x and sum x^2 in f32; mean, var = E[x^2] - mu^2 clamped
    at 0, a = rsqrt(var + eps) * weight; y = act(a * (x - mean) + bias),
    act in LeakyReLU(slope) | ReLU | none, rounded once to x's dtype

The CUDA source says what bounds the kernel on the card and what its design
does about that. ``_plan`` chooses its route by the plane's size:
"cluster" (one launch a call; each plane read once into the shared memory of
a group of warps or of a cluster of up to 8 blocks) or "two_pass" (a plane no
cluster holds: a sums kernel, then a kernel that finishes and applies);
``norm_act_route`` names it.

``instance_norm_act`` launches the kernel for CUDA tensors and raises on what
it cannot take; for CPU tensors it runs ``instance_norm_act_plain``, a port
of ``instance_norm_act_reference``, which is also what the kernel is held
against on the card. Where a gradient is needed it runs inside a
``torch.autograd.Function`` whose backward recomputes the plain version under
autograd and differentiates it, as the JAX ``custom_vjp`` does
(norm_act.py:143-159): JAX has no Pallas backward for K2, so neither has the
port.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from face_mask_inpaint_tpu_torch.kernels import build

__all__ = ["instance_norm_act", "instance_norm_act_plain", "norm_act_route", "ACTS"]

ACTS = ("LeakyReLU", "ReLU", "none")
_SYMBOLS = {torch.float32: "fmi_norm_act_f32", torch.bfloat16: "fmi_norm_act_bf16"}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_ROUTES = {"cluster": 0, "two_pass": 1}
_WARPS = 8                 # a block of the kernels: 8 warps
_SMALL_PLANE = 16 * 1024   # bytes: planes up to this size go several to a block
_SMALL_BLOCK = 48 * 1024   # bytes of such planes a block holds at most
_SLICE = 64 * 1024         # bytes of a plane a cluster's block holds, where 8 blocks suffice
_SMEM = 226 * 1024         # shared memory a block takes at most (csrc: kSmemMax - kStatic)
_CLUSTERS = (1, 2, 4, 8)   # cluster sizes; 8 is the portable maximum
_CHUNK = 16384             # elements a block of the two-pass route takes


class Plan(NamedTuple):
    """How the kernel cuts a plane of ``hw`` elements: ``route``; on
    "cluster", ``cluster`` blocks a plane of ``slice`` elements each, or
    ``planes_per_block`` whole planes a block (8 / that many warps a plane);
    on "two_pass", ``cluster`` chunks of ``slice`` elements a plane."""
    route: str
    cluster: int
    planes_per_block: int
    slice: int


def _cap(elements: int, itemsize: int) -> int:
    """Shared memory of one slice: its bytes rounded up to 16, plus the 16
    that a slice off a 16-byte boundary may need (csrc ``cluster_smem``)."""
    return -(-elements * itemsize // 16) * 16 + 16


@functools.lru_cache(maxsize=None)
def _plan(hw: int, itemsize: int) -> Plan:
    """The kernel's cut of a plane of hw elements of itemsize bytes."""
    if hw * itemsize <= _SMALL_PLANE:
        ppb = _WARPS
        while ppb > 1 and ppb * _cap(hw, itemsize) > _SMALL_BLOCK:
            ppb //= 2
        return Plan("cluster", 1, ppb, hw)
    per_piece = 16 // itemsize  # slices start on 16-byte boundaries of the plane
    for cs in _CLUSTERS:
        sl = -(-(-(-hw // cs)) // per_piece) * per_piece
        if sl * itemsize <= _SLICE or (cs == _CLUSTERS[-1] and _cap(sl, itemsize) <= _SMEM):
            return Plan("cluster", -(-hw // sl), 1, sl)
    return Plan("two_pass", -(-hw // _CHUNK), 1, _CHUNK)


def norm_act_route(shape, dtype: torch.dtype) -> str:
    """"cluster" or "two_pass": the route K2 takes for an NCHW map of this
    shape and dtype (alignment changes only how a slice is loaded)."""
    if len(shape) != 4:
        raise ValueError(f"instance_norm_act takes NCHW, got {tuple(shape)}")
    if dtype not in _SYMBOLS:
        raise TypeError(f"instance_norm_act takes float32 or bfloat16, got {dtype}")
    n, c, h, w = shape
    if n * c >= 2 ** 31 or h * w >= 2 ** 31:
        raise ValueError(f"instance_norm_act: {tuple(shape)} is too large for the kernel")
    return _plan(h * w, _ITEMSIZE[dtype]).route


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
    """Plain PyTorch version over NCHW: f32 stats (f64 for an f64 input),
    E[x^2] - mu^2 clamped at 0."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.mean(dim=(2, 3), keepdim=True)
    sq = x32.square().mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min(sq - mean.square(), 0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = (y * weight.to(x32.dtype)[None, :, None, None]
             + bias.to(x32.dtype)[None, :, None, None])
    return _act(y, act, slope).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _function(dtype: torch.dtype):
    fn = getattr(build.load("norm_act"), _SYMBOLS[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, weight, bias, act) -> None:
    norm_act_route(x.shape, x.dtype)
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
    plan = _plan(h * w, x.element_size())
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    w32 = b32 = parts = None
    with torch.cuda.device(x.device):
        if weight is not None:
            w32, b32 = weight.float().contiguous(), bias.float().contiguous()
        if plan.route == "two_pass":
            parts = torch.empty((n * c, plan.cluster, 2), dtype=torch.float32, device=x.device)
        rc = _function(x.dtype)(
            x.data_ptr(), None if w32 is None else w32.data_ptr(),
            None if b32 is None else b32.data_ptr(), y.data_ptr(),
            None if parts is None else parts.data_ptr(), n * c, c, h * w, _ROUTES[plan.route],
            plan.cluster, plan.planes_per_block, plan.slice, ACTS.index(act), float(slope),
            float(eps), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"instance_norm_act launch failed: cudaError {rc}")
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
    tensors take the plain version; CUDA tensors launch K2 on the route
    ``norm_act_route`` names. Differentiable in x, weight and bias.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _InstanceNormAct.apply(x, weight, bias, act, slope, eps)
    return _forward(x, weight, bias, act, slope, eps)


instance_norm_act.launches = 0
