"""The decoder block's residual sum with its convs' biases (CUDA C++,
``csrc/residual_add.cu``).

Replaces no TPU kernel. ``ResBlockDecoder`` in eval mode runs conv2 and the
bypass without their biases, sums the two in f32 and hands the sum here:

    y = (h + s) + bias[c]

in f32, each add rounded to nearest, rounded once to h's dtype; where cuDNN
would run each biased conv as the conv and a separate broadcast add over
its output, and the block would then add the pair in a third pass. The CUDA
source says what bounds the kernel on the card and what its design does
about that: the plan of K7a, a block on a chunk of one plane with the
plane's bias read once (route "plane"), or, for planes under 256 elements,
blocks on chunks of the flat tensors (route "flat"); ``_plan`` mirrors the
C side's choice and ``residual_bias_add_route`` names it.

s may be channels-last. A conv writes channels-last where its input is: in
the flagship the bypass of decoder blocks 0 and 2, whose input comes
channels-last from the latent branch's sum and from the attention, while
their conv2 reads K2's NCHW output. An NCHW h with a channels-last s takes
route "transpose" (a tile of 32 channels x 64 pixels through shared memory;
the output NCHW); h and s both channels-last (norm "none": both convs read
the block's input) take route "flat" over their [N, H, W, C] elements (the
output channels-last).

``residual_bias_add`` launches the kernel for CUDA tensors and raises on
what it cannot take; for CPU tensors it runs ``residual_bias_add_plain``,
which is also what the kernel is held against, bit for bit, on the card.
The kernel has no backward: on CUDA tensors it raises when a gradient would
be needed, as K3 does (training runs the block's differentiable ``h + s``);
the plain version is differentiable.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from face_mask_inpaint_tpu_torch.kernels import build
from face_mask_inpaint_tpu_torch.kernels.output_head import _no_grad_needed

__all__ = ["residual_bias_add", "residual_bias_add_plain", "residual_bias_add_route"]

_SYMBOLS = {torch.float32: "fmi_residual_bias_add_f32",
            torch.bfloat16: "fmi_residual_bias_add_bf16"}
# the kernel's block (csrc/residual_add.cu): at most _THREADS threads,
# _UNROLL 16-byte vectors of each input a thread; planes under _FLAT_BELOW
# elements take the flat route
_THREADS = 256
_UNROLL = 4
_FLAT_BELOW = 256


def residual_bias_add_plain(h: torch.Tensor, s: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (h + s) + bias over dim 1 in f32 (f64 for an
    f64 map), one rounding to h's dtype."""
    acc = torch.promote_types(h.dtype, torch.float32)
    b = bias.to(acc).view(1, -1, *([1] * (h.dim() - 2)))
    return (h.to(acc) + s.to(acc) + b).to(h.dtype)


class Plan(NamedTuple):
    """The kernel's cut of a call with planes of ``hw`` elements: ``route``
    "plane" or "flat", ``threads`` a block and ``chunk`` elements a block."""
    route: str
    threads: int
    chunk: int


@functools.lru_cache(maxsize=None)
def _plan(hw: int, itemsize: int) -> Plan:
    """What csrc/residual_add.cu's ``fmi_residual_add_route`` and
    ``fmi_residual_add_threads`` choose for planes of hw elements of
    itemsize bytes."""
    vec = 16 // itemsize
    if hw < _FLAT_BELOW:
        return Plan("flat", _THREADS, _THREADS * _UNROLL * vec)
    threads = min(_THREADS, -(-hw // (32 * vec)) * 32)
    return Plan("plane", threads, threads * _UNROLL * vec)


def _layout(t: torch.Tensor) -> Optional[str]:
    """"nchw" for a contiguous map, "cl" for a channels-last one, else None."""
    if t.is_contiguous():
        return "nchw"
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return "cl"
    return None


def residual_bias_add_route(h: torch.Tensor, s: torch.Tensor) -> str:
    """"plane", "flat" or "transpose": the route the kernel takes for h and s."""
    if h.dim() < 2:
        raise ValueError(f"residual_bias_add takes [N, C, ...], got {tuple(h.shape)}")
    if h.dtype not in _SYMBOLS:
        raise TypeError(f"residual_bias_add takes float32 or bfloat16, got {h.dtype}")
    layouts = (_layout(h), _layout(s))
    if None in layouts:
        raise ValueError("residual_bias_add takes NCHW or channels-last maps, each dense")
    if layouts == ("cl", "nchw"):
        raise ValueError("residual_bias_add takes a channels-last h only with a "
                         "channels-last s")
    if layouts == ("cl", "cl"):
        return "flat"
    if layouts == ("nchw", "cl"):
        return "transpose"
    return _plan(math.prod(h.shape[2:]), h.element_size()).route


_ARGTYPES = {
    "fmi_residual_bias_add": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                             + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "fmi_residual_add_route": [ctypes.c_longlong],
    "fmi_residual_add_threads": [ctypes.c_longlong, ctypes.c_int],
}


@functools.lru_cache(maxsize=None)
def _function(name: str, dtype: Optional[torch.dtype] = None):
    """The C entry point ``name`` (the ``_SYMBOLS`` entry for a dtype)."""
    fn = getattr(build.load("residual_add"), name if dtype is None else _SYMBOLS[dtype])
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(h: torch.Tensor, s: torch.Tensor, bias: torch.Tensor) -> str:
    """The route, once h, s and the bias are found fit for the kernel."""
    if s.shape != h.shape or s.dtype != h.dtype or s.device != h.device:
        raise ValueError(f"h and s must be one shape, dtype and device, got {tuple(h.shape)} "
                         f"{h.dtype} on {h.device} and {tuple(s.shape)} {s.dtype} on {s.device}")
    route = residual_bias_add_route(h, s)
    if bias.shape != (h.shape[1],) or bias.device != h.device:
        raise ValueError(f"the bias must be [{h.shape[1]}] on the maps' device, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    return route


def residual_bias_add(h: torch.Tensor, s: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(h + s) + bias over dim 1, in f32, rounded once to h's dtype.

    h, s: [N, C, ...] of one dtype, float32 or bfloat16, h contiguous and s
    contiguous or channels-last, or both channels-last; bias: [C]. CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch a call, counted in ``launches``) on the route
    ``residual_bias_add_route`` names. The output takes h's layout.
    """
    if h.device.type == "cpu":
        return residual_bias_add_plain(h, s, bias)
    if h.device.type != "cuda":
        raise ValueError(f"residual_bias_add runs on cpu or cuda, not {h.device}")
    route = _check(h, s, bias)
    _no_grad_needed("residual_bias_add", (h, s, bias))
    y = torch.empty_like(h)
    n, c = h.shape[:2]
    planes, hw = n * c, math.prod(h.shape[2:])
    if _layout(h) == "cl":
        planes, hw = h.numel(), 1  # route "flat": element i's channel is i % C
    with torch.cuda.device(h.device):
        b = bias.float().contiguous()
        rc = _function("fmi_residual_bias_add", h.dtype)(
            h.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(), planes, hw, c,
            int(route == "transpose"), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"residual_bias_add launch failed: cudaError {rc}")
    residual_bias_add.launches += 1
    return y


residual_bias_add.launches = 0
