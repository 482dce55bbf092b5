"""K4b and K4a: the decoder tail's convs with norm prologues and stats
epilogues (CUDA C++, ``csrc/decoder_conv.cu``).

Replaces face_mask_inpaint_tpu/ops/pallas/packed_convt.py
``packed_conv3x3_stats`` (K4b) and ``packed_convt_pair`` (K4a) over dense
NCHW maps: the space-to-depth packing those kernels run on is a TPU layout and
is not ported.

    K4b  h = conv3x3_s1_p1(pro(x), w) + b
    K4a  y = sum_s convT_k3_s2_p1_op1(pro_s(x_s), w_s) + sum_s b_s

A prologue ``(A, B, act)`` with A, B [N, C] f32 applies ``act(x * A + B)``
before the conv (the previous stage's instance-norm affine, from
``instance_affine_from_stats``), computed in f32 and rounded to the input
dtype; the conv's zero padding lies in that normalised domain. Weights are
rounded to the input dtype, products accumulate in f32, the bias is added in
f32, and ``with_stats`` returns the f32 per-(n, c) sums of y and y^2 of that
value; the optional ``act`` and one rounding to the input dtype follow
(packed_convt.py:114-130, :214-217, :394-441). Activations: LeakyReLU(0.1)
and ReLU.

The CUDA kernels are chosen by the C side by dtype, shape and alignment only
(``conv3x3_route``, ``convt_pair_route``): bf16 maps with W % 8 == 0 run on
the tensor cores, with the weights packed once per call as bf16
[9, c_pad, co_pad] (K4a: one such operand a stream, its four output parities
computed as four GEMMs over one staged tile); float32 maps with W % 4 == 0
run on the tensor cores in split precision ("tf32x3": each f32 operand split
into tf32 hi + lo, three TF32 products, the weights split and packed once per
call as f32 [2, 9, co_pad, c_pad] by ``tf32_split``, one such operand a K4a
stream), which holds the float32 gates whatever
``torch.backends.cuda.matmul.allow_tf32`` says; everything else (other
widths, misaligned maps) runs on the CUDA cores with f32 [C, 9, co_pad]
weights.

Weights are the port's own: ``Conv2d`` [Co, Ci, 3, 3] and ``ConvTranspose2d``
torch's [Ci, Co, 3, 3] (nn/layers.py). Each wrapper launches its kernel for
CUDA tensors and raises on what it cannot take; for CPU tensors it runs its
plain version, which is also what the kernel is held against on the card.
The kernels have no backward (the JAX package runs the fused tail in
inference only, ``use_packed_convt_kernel(train)``): on CUDA tensors the
wrappers raise when a gradient would be needed. The plain versions are
differentiable in the input, the prologue, the weight and the bias.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.kernels import build
from face_mask_inpaint_tpu_torch.kernels.output_head import _no_grad_needed

__all__ = ["conv3x3_stats", "conv3x3_stats_plain", "conv3x3_route", "convt_pair",
           "convt_pair_plain", "convt_pair_route", "instance_affine_from_stats", "tf32_split",
           "ACTS"]

ACTS = ("LeakyReLU", "ReLU")
_SLOPE = 0.1  # the reference registry's LeakyReLU slope
_ACT_CODE = {None: 0, "none": 0, "ReLU": 1, "LeakyReLU": 2}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def instance_affine_from_stats(s: torch.Tensor, sq: torch.Tensor, count: int,
                               gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
                               eps: float = 1e-5):
    """(sum y, sum y^2, elements per plane) -> per-(n, c) A, B [N, C] f32 with
    InstanceNorm2d(y) == y * A + B (JAX packed_convt.py:90-101)."""
    mean = s / count
    var = torch.clamp_min(sq / count - mean.square(), 0.0)
    a = torch.rsqrt(var + eps)
    if gamma is not None:
        a = a * gamma.float()[None]
    b = -mean * a
    if beta is not None:
        b = b + beta.float()[None]
    return a, b


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "LeakyReLU":
        return torch.where(y >= 0, y, y * _SLOPE)
    if act == "ReLU":
        return torch.clamp_min(y, 0.0)
    return y


def _check_act(act: Optional[str], what: str) -> None:
    if act not in _ACT_CODE:
        raise NotImplementedError(f"{what} activation {act!r}: one of {ACTS} or None")


def _check_input(x: torch.Tensor, prologue, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what} takes [N, C, H, W] maps, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 maps, got {x.dtype}")
    if prologue is not None:
        a, b, pact = prologue
        _check_act(pact, f"{what} prologue")
        if a.shape != x.shape[:2] or b.shape != x.shape[:2]:
            raise ValueError(f"{what} prologue A, B must be [N, C] = {tuple(x.shape[:2])}, "
                             f"got {tuple(a.shape)} and {tuple(b.shape)}")


def _check_bias(b: Optional[torch.Tensor], co: int, what: str) -> None:
    if b is not None and tuple(b.shape) != (co,):
        raise ValueError(f"{what} bias must be [{co}], got {tuple(b.shape)}")


def _prologued(x: torch.Tensor, prologue) -> torch.Tensor:
    """pro(x) in f32, rounded to x's dtype where the kernel rounds it."""
    if prologue is None:
        return x.float()
    a, b, pact = prologue
    v = x.float() * a.float()[:, :, None, None] + b.float()[:, :, None, None]
    return _act(v, pact).to(x.dtype).float()


def _finish(y: torch.Tensor, act: Optional[str], with_stats: bool, dtype: torch.dtype):
    out = _act(y, act).to(dtype)
    if with_stats:
        return out, (y.sum(dim=(2, 3)), y.square().sum(dim=(2, 3)))
    return out


def _bias32(b: Optional[torch.Tensor], co: int, device) -> torch.Tensor:
    if b is None:
        return torch.zeros(co, dtype=torch.float32, device=device)
    return b.float()


def _check_conv3(x, w, b, prologue, act) -> None:
    _check_input(x, prologue, "conv3x3_stats")
    _check_act(act, "conv3x3_stats")
    if w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"conv3x3_stats weight must be [Co, {x.shape[1]}, 3, 3], "
                         f"got {tuple(w.shape)}")
    _check_bias(b, w.shape[0], "conv3x3_stats")


def conv3x3_stats_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                        prologue=None, act: Optional[str] = None, with_stats: bool = False):
    """Plain PyTorch version of K4b: F.conv2d(padding=1) over the prologue'd,
    rounded input, rounding where the kernel rounds."""
    _check_conv3(x, w, b, prologue, act)
    y = F.conv2d(_prologued(x, prologue), w.to(x.dtype).float(), padding=1)
    y = y + _bias32(b, w.shape[0], x.device)[None, :, None, None]
    return _finish(y, act, with_stats, x.dtype)


def _streams(streams: Sequence) -> list:
    return [tuple(s) if len(s) == 4 else (*s, None) for s in streams]


def _check_convt(streams, act) -> None:
    if not 1 <= len(streams) <= 2:
        raise ValueError(f"convt_pair takes one or two streams, got {len(streams)}")
    _check_act(act, "convt_pair")
    x0, w0 = streams[0][0], streams[0][1]
    for x, w, b, prologue in streams:
        _check_input(x, prologue, "convt_pair")
        if x.shape[0] != x0.shape[0] or x.shape[2:] != x0.shape[2:] or x.dtype != x0.dtype:
            raise ValueError("convt_pair streams must share N, H, W and dtype")
        if w.dim() != 4 or tuple(w.shape) != (x.shape[1], w0.shape[1], 3, 3):
            raise ValueError(f"convt_pair weight must be [{x.shape[1]}, Co, 3, 3] with one "
                             f"Co across streams, got {tuple(w.shape)}")
        _check_bias(b, w0.shape[1], "convt_pair")


def _pair_bias(streams, co: int, device) -> torch.Tensor:
    bias = torch.zeros(co, dtype=torch.float32, device=device)
    for _, _, b, _ in streams:
        if b is not None:
            bias = bias + b.float()
    return bias


def convt_pair_plain(streams: Sequence, act: Optional[str] = None, with_stats: bool = False):
    """Plain PyTorch version of K4a: the sum of F.conv_transpose2d(stride 2,
    padding 1, output_padding 1) over the prologue'd, rounded streams."""
    streams = _streams(streams)
    _check_convt(streams, act)
    x0, co = streams[0][0], streams[0][1].shape[1]
    y = None
    for x, w, _, prologue in streams:
        t = F.conv_transpose2d(_prologued(x, prologue), w.to(x.dtype).float(),
                               stride=2, padding=1, output_padding=1)
        y = t if y is None else y + t
    y = y + _pair_bias(streams, co, x0.device)[None, :, None, None]
    return _finish(y, act, with_stats, x0.dtype)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_STREAM_ARGS = [_PTR] * 4 + [_INT] * 2  # x, w, A, B, C, pro
_ARGTYPES = {
    "fmi_conv3x3_stats": [_PTR] * 8 + [_INT] * 8 + [_PTR],
    "fmi_conv3x3_stats_bf16_mma": [_PTR] * 8 + [_INT] * 8 + [_PTR],
    "fmi_conv3x3_stats_f32_tf32x3": [_PTR] * 8 + [_INT] * 8 + [_PTR],
    "fmi_conv3x3_route": [_INT, _PTR, _PTR, _INT],
    "fmi_convt_pair": _STREAM_ARGS * 2 + [_INT] + [_PTR] * 4 + [_INT] * 6 + [_PTR],
    "fmi_convt_pair_bf16_mma": _STREAM_ARGS * 2 + [_INT] + [_PTR] * 4 + [_INT] * 6 + [_PTR],
    "fmi_convt_pair_f32_tf32x3": _STREAM_ARGS * 2 + [_INT] + [_PTR] * 4 + [_INT] * 6 + [_PTR],
    "fmi_convt_pair_route": [_INT, _PTR, _PTR, _PTR, _INT],
    "fmi_decoder_conv_co_pad": [_INT],
    "fmi_decoder_conv_c_pad": [_INT],
    "fmi_decoder_conv_tiles": [_INT] * 4,
}


@functools.lru_cache(maxsize=None)
def _function(name: str, dtype: Optional[torch.dtype] = None):
    """The C entry point ``name`` (``name_f32``/``name_bf16`` for a dtype)."""
    symbol = name if dtype is None else f"{name}_{_DTYPES[dtype]}"
    fn = getattr(build.load("decoder_conv"), symbol)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_device(x: torch.Tensor, tensors, what: str) -> None:
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: all tensors must lie on {x.device}, one is on {t.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous NCHW maps")


def _weights_mma(w: torch.Tensor, c_pad: int, co_pad: int) -> torch.Tensor:
    """K4b's tensor-core operand: [9, c_pad, co_pad] bf16 (tap ky * 3 + kx,
    input channel, output channel) from [Co, C, 3, 3], zeros past C and Co;
    c_pad is fmi_decoder_conv_c_pad(C)."""
    co, c = w.shape[:2]
    # without padding F.pad may return the permuted view itself: the kernel
    # reads the operand by its pointer, so it must be contiguous
    return F.pad(w.to(torch.bfloat16).permute(2, 3, 1, 0),
                 (0, co_pad - co, 0, c_pad - c)).reshape(9, c_pad, co_pad).contiguous()


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 x -> (hi, lo) with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
    hi): 10 mantissa bits each, rounded to nearest with ties away from zero
    (the magnitude's bits rounded half up at bit 13, as csrc/mma.cuh's
    rna_tf32 does); hi + lo keeps about 21 of f32's 24 bits."""
    def rna(v: torch.Tensor) -> torch.Tensor:
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _weights_tf32x3(w: torch.Tensor, c_pad: int, co_pad: int) -> torch.Tensor:
    """K4b's split-precision operand: [2, 9, co_pad, c_pad] f32 (tf32 hi,
    then lo; tap ky * 3 + kx; output channel; input channel) from
    [Co, C, 3, 3], zeros past C and Co; c_pad is fmi_decoder_conv_c_pad(C)."""
    co, c = w.shape[:2]
    taps = F.pad(w.float().permute(2, 3, 0, 1), (0, c_pad - c, 0, co_pad - co))
    return torch.stack(tf32_split(taps.reshape(9, co_pad, c_pad)))


def _convt_weights_mma(w: torch.Tensor, c_pad: int, co_pad: int) -> torch.Tensor:
    """The tensor-core K4a's operand of one stream: [9, c_pad, co_pad] bf16
    (tap ky * 3 + kx, input channel, output channel) from torch's
    ConvTranspose2d weight [C, Co, 3, 3], zeros past C and Co; c_pad is
    fmi_decoder_conv_c_pad(C)."""
    return _weights_mma(w.transpose(0, 1), c_pad, co_pad)


def _convt_weights_tf32x3(w: torch.Tensor, c_pad: int, co_pad: int) -> torch.Tensor:
    """The split-precision K4a's operand of one stream: [2, 9, co_pad, c_pad]
    f32 (tf32 hi, then lo; tap ky * 3 + kx; output channel; input channel)
    from torch's ConvTranspose2d weight [C, Co, 3, 3], zeros past C and Co;
    c_pad is fmi_decoder_conv_c_pad(C)."""
    return _weights_tf32x3(w.transpose(0, 1), c_pad, co_pad)


def _weights(w: torch.Tensor, dtype: torch.dtype, co_pad: int, transposed: bool):
    """[Ci, 9, co_pad] f32, tap-major, rounded to the stream dtype."""
    w = w.to(dtype).float()
    w = w.permute(0, 2, 3, 1) if transposed else w.permute(1, 2, 3, 0)
    ci, co = w.shape[0], w.shape[3]
    out = torch.zeros((ci, 9, co_pad), dtype=torch.float32, device=w.device)
    out[:, :, :co] = w.reshape(ci, 9, co)
    return out


def _padded(v: torch.Tensor, co_pad: int) -> torch.Tensor:
    """[co_pad] f32, contiguous (the kernels read it by its pointer)."""
    return F.pad(v.float(), (0, co_pad - v.shape[0])).contiguous()


def _prologue_args(prologue):
    """(A, B, code) for the C interface: code -1 means no prologue."""
    if prologue is None:
        return None, None, -1
    a, b, pact = prologue
    return a.float().contiguous(), b.float().contiguous(), _ACT_CODE[pact]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stats_buffers(n: int, co: int, tiles: int, device, with_stats: bool):
    if not with_stats:
        return None, None
    return (torch.empty((n, co, tiles), dtype=torch.float32, device=device),
            torch.empty((n, co, tiles), dtype=torch.float32, device=device))


_ROUTES = {1: "tensor_cores", 2: "tf32x3", 0: "cuda_cores"}


def _route(x: torch.Tensor, out: torch.Tensor) -> str:
    """The K4b kernel this call runs: "tensor_cores" (bf16, W % 8 == 0),
    "tf32x3" (float32, W % 4 == 0), both with 16-byte aligned maps, or
    "cuda_cores": the C side decides, by dtype, shape and alignment."""
    return _ROUTES[_function("fmi_conv3x3_route")(x.dtype == torch.bfloat16, x.data_ptr(),
                                                   out.data_ptr(), x.shape[3])]


def conv3x3_route(x: torch.Tensor) -> str:
    """"tensor_cores", "tf32x3" or "cuda_cores": the K4b kernel a call on the
    CUDA map x launches (its output is allocated as x is, so x's alignment
    decides)."""
    return _route(x, x)


def _convt_route(streams, out: torch.Tensor) -> str:
    """The K4a kernel this call runs: "tensor_cores" (bf16, W % 8 == 0),
    "tf32x3" (float32, W % 4 == 0), both with every map 16-byte aligned, or
    "cuda_cores": the C side decides, by dtype, shape and alignment."""
    x0 = streams[0][0]
    x1 = streams[1][0].data_ptr() if len(streams) == 2 else None
    return _ROUTES[_function("fmi_convt_pair_route")(x0.dtype == torch.bfloat16, x0.data_ptr(),
                                                      x1, out.data_ptr(), x0.shape[3])]


def convt_pair_route(x: torch.Tensor) -> str:
    """"tensor_cores", "tf32x3" or "cuda_cores": the K4a kernel a call
    launches whose streams lie as the CUDA map x does (its output is
    allocated, so x's alignment decides)."""
    return _convt_route([(x,)], x)


def conv3x3_stats(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  prologue=None, act: Optional[str] = None, with_stats: bool = False):
    """K4b: conv3x3_s1_p1(pro(x), w) + b -> [N, Co, H, W] in x's dtype, or
    (out, (sum y, sum y^2)) with f32 [N, Co] sums when ``with_stats``.

    x [N, C, H, W] contiguous, float32 or bfloat16; w [Co, C, 3, 3] (the
    effective weight) and b [Co] or None in any float dtype; prologue None or
    (A, B, act) with A, B [N, C]. CPU tensors take the plain version; CUDA
    tensors launch K4b on the route ``conv3x3_route`` names. Its float32
    route "tf32x3" runs on the tensor cores in split precision and holds the
    float32 gates whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
    """
    if x.device.type == "cpu":
        return conv3x3_stats_plain(x, w, b, prologue, act, with_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_stats runs on cpu or cuda, not {x.device}")
    _check_conv3(x, w, b, prologue, act)
    _no_grad_needed("conv3x3_stats", [x, w, b, *(prologue or (None, None))[:2]])
    a_, b_, pro = _prologue_args(prologue)
    _check_device(x, [w, b, a_, b_], "conv3x3_stats")
    n, c, h, wd = x.shape
    co = w.shape[0]
    co_pad = _function("fmi_decoder_conv_co_pad")(co)
    bias = _padded(_bias32(b, co, x.device), co_pad)
    out = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    route = _route(x, out)
    if route == "tensor_cores":
        wt = _weights_mma(w, _function("fmi_decoder_conv_c_pad")(c), co_pad)
        kernel = _function("fmi_conv3x3_stats_bf16_mma")
    elif route == "tf32x3":
        wt = _weights_tf32x3(w, _function("fmi_decoder_conv_c_pad")(c), co_pad)
        kernel = _function("fmi_conv3x3_stats_f32_tf32x3")
    else:
        wt, kernel = (_weights(w, x.dtype, co_pad, transposed=False),
                      _function("fmi_conv3x3_stats", x.dtype))
    tiles = _function("fmi_decoder_conv_tiles")(0 if route == "cuda_cores" else 2, h, wd, co)
    # the partial sums of y and y^2 in one buffer, summed by one reduction
    parts = (torch.empty((2, n, co, tiles), dtype=torch.float32, device=x.device)
             if with_stats else None)
    with torch.cuda.device(x.device):
        rc = kernel(
            x.data_ptr(), wt.data_ptr(), _ptr(a_), _ptr(b_), bias.data_ptr(), out.data_ptr(),
            _ptr(parts), None if parts is None else parts[1].data_ptr(), n, c, h, wd, co,
            co_pad, pro, _ACT_CODE[act], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_stats launch failed: cudaError {rc}")
    conv3x3_stats.launches += 1
    if with_stats:
        sums = parts.sum(dim=3)
        return out, (sums[0], sums[1])
    return out


conv3x3_stats.launches = 0


# K4a's tensor-core routes: (weight packing, C entry point, tiles kind)
_CONVT_TENSOR_CORES = {
    "tensor_cores": (_convt_weights_mma, "fmi_convt_pair_bf16_mma", 3),
    "tf32x3": (_convt_weights_tf32x3, "fmi_convt_pair_f32_tf32x3", 4),
}


def convt_pair(streams: Sequence, act: Optional[str] = None, with_stats: bool = False):
    """K4a: sum over streams of convT_k3_s2_p1_op1(pro(x), w) + b ->
    [N, Co, 2H, 2W] in the streams' dtype, or (out, (sum y, sum y^2)) with
    f32 [N, Co] sums of the pre-activation output when ``with_stats``.

    streams: one or two (x, w, b) or (x, w, b, prologue) with x [N, C_s, H, W]
    contiguous, float32 or bfloat16, one dtype; w [C_s, Co, 3, 3] (torch's
    ConvTranspose2d layout, the effective weight); b [Co] or None; prologue
    None or (A, B, act) with A, B [N, C_s]. CPU tensors take the plain
    version; CUDA tensors launch K4a on the route ``convt_pair_route`` names.
    Its float32 route "tf32x3" runs on the tensor cores in split precision
    and holds the float32 gates whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says.
    """
    streams = _streams(streams)
    x0 = streams[0][0]
    if x0.device.type == "cpu":
        return convt_pair_plain(streams, act, with_stats)
    if x0.device.type != "cuda":
        raise ValueError(f"convt_pair runs on cpu or cuda, not {x0.device}")
    _check_convt(streams, act)
    for x, w, b, prologue in streams:
        _no_grad_needed("convt_pair", [x, w, b, *(prologue or (None, None))[:2]])
    n, _, h, wd = x0.shape
    co = streams[0][1].shape[1]
    co_pad = _function("fmi_decoder_conv_co_pad")(co)
    out = torch.empty((n, co, 2 * h, 2 * wd), dtype=x0.dtype, device=x0.device)
    route = _convt_route(streams, out)
    if route == "cuda_cores":
        kernel, kind = _function("fmi_convt_pair", x0.dtype), 1
    else:
        pack, name, kind = _CONVT_TENSOR_CORES[route]
        kernel = _function(name)
    args, keep = [], []  # the C arguments, and the tensors behind their pointers
    for x, w, b, prologue in streams + [(None, None, None, None)] * (2 - len(streams)):
        if x is None:
            args += [None, None, None, None, 0, -1]
            continue
        a_, b_, pro = _prologue_args(prologue)
        _check_device(x, [x0, w, b, a_, b_], "convt_pair")
        wt = (_weights(w, x.dtype, co_pad, transposed=True) if route == "cuda_cores"
              else pack(w, _function("fmi_decoder_conv_c_pad")(x.shape[1]), co_pad))
        keep += [wt, a_, b_]  # alive until the launch: the kernel reads them
        args += [x.data_ptr(), wt.data_ptr(), _ptr(a_), _ptr(b_), x.shape[1], pro]
    bias = _padded(_pair_bias(streams, co, x0.device), co_pad)
    tiles = _function("fmi_decoder_conv_tiles")(kind, h, wd, co)
    psum, psq = _stats_buffers(n, co, tiles, x0.device, with_stats)
    with torch.cuda.device(x0.device):
        rc = kernel(
            *args, len(streams), bias.data_ptr(), out.data_ptr(), _ptr(psum), _ptr(psq),
            n, h, wd, co, co_pad, _ACT_CODE[act], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"convt_pair launch failed: cudaError {rc}")
    convt_pair.launches += 1
    if with_stats:
        return out, (psum.sum(dim=2), psq.sum(dim=2))
    return out


convt_pair.launches = 0
