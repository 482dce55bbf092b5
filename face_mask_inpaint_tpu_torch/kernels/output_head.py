"""K3: the fused Output head (CUDA C++, ``csrc/output_head.cu``).

Replaces face_mask_inpaint_tpu/ops/pallas/packed_convt.py ``packed_output_head``
(``_output_head_kernel``) together with the reflection-ring correction and the
pool that its caller adds (nn/blocks.py ``Output`` on the decoder's pair):

    out = avg_pool_f(tanh(conv3x3(reflect_pad1(act(h + s)), weight) + bias))

for the last decoder block's pre-add pair h, s [N, C, H, W]. The sum and the
activation are rounded to the input dtype, as the TPU kernel adds and
activates in the stream dtype (packed_convt.py:592-606). ``pair_bias`` [C],
the block's two transposed convs' biases summed (which ``ResBlockDecoder``
leaves to this kernel in eval mode), joins the sum: (h + s) + pair_bias in
f32, rounded once to the input dtype. The conv accumulates
in f32, bias, tanh and the mean stay in f32, and the result is rounded once
(packed_convt.py:634-655). The weight is rounded to the input dtype first, as
the TPU kernel casts its packed weight to the stream dtype. The CUDA source
says what bounds the kernel on the card and what its design does about that.

``output_head`` launches the kernel for CUDA tensors on the route
``output_head_route`` names ("mma_sync": bf16 on the tensor cores, its
weights packed once a call as bf16 [9, c_pad, 8]; "cuda_cores": the rest)
and raises on what it cannot take; for CPU tensors it runs
``output_head_plain``, which is also what the kernel is held against on the
card. The kernel has no backward (the JAX
package runs it in inference only, ``use_packed_output_kernel(train)``), so on
CUDA tensors it raises when a gradient would be needed; the plain version is
differentiable.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.kernels import build

__all__ = ["output_head", "output_head_plain", "output_head_route", "ACTS"]

ACTS = ("LeakyReLU", "ReLU")
_SLOPE = 0.1  # the reference registry's LeakyReLU slope
_CO_MAX = 4   # the kernels keep up to four output channels
_SYMBOLS = {torch.float32: "fmi_output_head_f32", torch.bfloat16: "fmi_output_head_bf16"}
_CK = 16      # the tensor-core kernel's channels a chunk
_N_PAD = 8    # its output channels, padded to one n8 tile
_MMA_POOLS = (1, 2, 4, 8, 16, 32)  # f a power of two up to 32: a tile holds whole cells


def _check(h: torch.Tensor, s: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           act: str, pool: int, pair_bias: Optional[torch.Tensor]) -> None:
    if h.dim() != 4 or h.shape != s.shape:
        raise ValueError(f"h and s must be one [N, C, H, W] shape, got {tuple(h.shape)} "
                         f"and {tuple(s.shape)}")
    if h.dtype not in _SYMBOLS or s.dtype != h.dtype:
        raise TypeError(f"output_head takes float32 or bfloat16 pairs, got {h.dtype}, "
                        f"{s.dtype}")
    n, c, height, width = h.shape
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(f"weight must be [co, {c}, 3, 3], got {tuple(weight.shape)}")
    if not 1 <= weight.shape[0] <= _CO_MAX:
        raise ValueError(f"output_head takes 1..{_CO_MAX} output channels, "
                         f"got {weight.shape[0]}")
    if bias.shape != (weight.shape[0],):
        raise ValueError(f"bias must be [{weight.shape[0]}], got {tuple(bias.shape)}")
    if pair_bias is not None and pair_bias.shape != (c,):
        raise ValueError(f"pair_bias must be [{c}], got {tuple(pair_bias.shape)}")
    if act not in ACTS:
        raise NotImplementedError(f"output_head activation {act!r}: one of {ACTS}")
    if not isinstance(pool, int) or pool < 1:
        raise ValueError(f"pool must be an integer >= 1, got {pool!r}")
    if height < 2 or width < 2:
        raise ValueError(f"the reflection pad needs H, W >= 2, got {height}x{width}")
    if height % pool or width % pool:
        raise ValueError(f"pool {pool} does not divide {height}x{width}")


def output_head_plain(h: torch.Tensor, s: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, act: str = "LeakyReLU", pool: int = 1,
                      pair_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: act(h + s [+ pair_bias]) -> reflect pad ->
    conv -> tanh -> avg_pool2d(pool), rounding where the kernel rounds."""
    _check(h, s, weight, bias, act, pool, pair_bias)
    if pair_bias is None:
        a = h + s
    else:
        acc = torch.promote_types(h.dtype, torch.float32)
        a = ((h.to(acc) + s.to(acc)) + pair_bias.to(acc)[None, :, None, None]).to(h.dtype)
    a = F.leaky_relu(a, _SLOPE) if act == "LeakyReLU" else F.relu(a)
    a = F.pad(a, (1, 1, 1, 1), mode="reflect").float()
    y = F.conv2d(a, weight.to(h.dtype).float(), bias.float())
    return F.avg_pool2d(torch.tanh(y), pool).to(h.dtype)


def _no_grad_needed(what: str, tensors) -> None:
    """Raise where a kernel without a backward would cut a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; run it under "
                           "torch.no_grad() (inference), or train with the module in "
                           "training mode, which takes the differentiable path")


def output_head_route(shape, dtype: torch.dtype, pool: int, aligned: bool = True) -> str:
    """"mma_sync" or "cuda_cores": the K3 kernel a call on [N, C, H, W] maps
    of this dtype with this pool launches. ``aligned``: whether h and s start
    on 16-byte boundaries (fresh tensors do). The C side's
    ``fmi_output_head_route`` decides the same."""
    if (dtype == torch.bfloat16 and shape[3] % 8 == 0 and pool in _MMA_POOLS and aligned):
        return "mma_sync"
    return "cuda_cores"


@functools.lru_cache(maxsize=None)
def _function(symbol: str, n_ints: int):
    fn = getattr(build.load("output_head"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _weights_mma(weight: torch.Tensor, c_pad: int) -> torch.Tensor:
    """The tensor-core kernel's weights: [9, c_pad, 8] bf16 (tap ky * 3 + kx,
    input channel, output channel) from [co, C, 3, 3], zeros past C and co."""
    co, c = weight.shape[:2]
    return F.pad(weight.to(torch.bfloat16).permute(2, 3, 1, 0),
                 (0, _N_PAD - co, 0, c_pad - c)).reshape(9, c_pad, _N_PAD).contiguous()


def output_head(h: torch.Tensor, s: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, act: str = "LeakyReLU", pool: int = 1,
                pair_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """avg_pool(tanh(conv3x3(reflect_pad(act(h + s [+ pair_bias])))))
    -> [N, co, H/pool, W/pool].

    h, s: [N, C, H, W] contiguous, float32 or bfloat16; weight [co, C, 3, 3]
    (the effective, spectral-normed weight) and bias [co] in any float
    dtype; pair_bias [C] or None. CPU tensors take the plain version; CUDA
    tensors launch K3.
    """
    if h.device.type == "cpu":
        return output_head_plain(h, s, weight, bias, act, pool, pair_bias)
    if h.device.type != "cuda":
        raise ValueError(f"output_head runs on cpu or cuda, not {h.device}")
    _check(h, s, weight, bias, act, pool, pair_bias)
    _no_grad_needed("output_head", (h, s, weight, bias, pair_bias))
    for t in (s, weight, bias, pair_bias):
        if t is not None and t.device != h.device:
            raise ValueError("h, s, weight, bias and pair_bias must lie on one device")
    if not (h.is_contiguous() and s.is_contiguous()):
        raise ValueError("output_head takes contiguous NCHW tensors")
    n, c, height, width = h.shape
    co = weight.shape[0]
    aligned = h.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0
    route = output_head_route(h.shape, h.dtype, pool, aligned)
    out = torch.empty((n, co, height // pool, width // pool), dtype=h.dtype, device=h.device)
    leaky = int(act == "LeakyReLU")
    with torch.cuda.device(h.device):
        b = bias.float().contiguous()
        pb = None if pair_bias is None else pair_bias.float().contiguous()
        pb_ptr = None if pb is None else pb.data_ptr()
        stream = torch.cuda.current_stream().cuda_stream
        if route == "mma_sync":
            c_pad = -(-c // _CK) * _CK
            w = _weights_mma(weight, c_pad)
            rc = _function("fmi_output_head_bf16_mma", 8)(
                h.data_ptr(), s.data_ptr(), w.data_ptr(), b.data_ptr(), pb_ptr, out.data_ptr(),
                n, c, c_pad, height, width, co, pool, leaky, stream)
        else:
            # [C, 9, 4] f32, tap-major, co padded to four: the weight rounded
            # to the stream dtype, as the TPU kernel rounds it
            w = torch.zeros((c, 9, _CO_MAX), dtype=torch.float32, device=h.device)
            w[:, :, :co] = weight.to(h.dtype).float().permute(1, 2, 3, 0).reshape(c, 9, co)
            rc = _function(_SYMBOLS[h.dtype], 7)(
                h.data_ptr(), s.data_ptr(), w.data_ptr(), b.data_ptr(), pb_ptr, out.data_ptr(),
                n, c, height, width, co, pool, leaky, stream)
    if rc != 0:
        raise RuntimeError(f"output_head launch failed: cudaError {rc}")
    output_head.launches += 1
    return out


output_head.launches = 0
