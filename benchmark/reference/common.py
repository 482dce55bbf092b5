"""Plain PyTorch operations that the references share.

The references compute in float32; ``tf32_off`` turns TF32 off around them,
so a float32 product on the card is a float32 product. ``Ops`` carries the
operand precision of every convolution, linear layer and attention product:
``Ops()`` is float32; ``Ops("bf16")`` rounds each such operand and result to
bfloat16, the configurations' precision (the check's measure of how far
rounding alone moves this seed's outputs); ``Ops("fp8")`` is the control,
which rounds each such operand and result to float8 e4m3 with one scale a
tensor (the precision below bfloat16: every activation that enters or
leaves a product is stored in it). Everything else is computed in float32.

``WeightSpec`` says how the benchmark draws one weight from the seed; each
reference lists its model's weights with one, by the state-dict names of the
configuration's model.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


class WeightSpec(NamedTuple):
    """``normal``: mean + std * N(0, 1); ``unit``: N(0, 1) scaled to unit
    L2 norm; ``lognormal``: exp(std * N(0, 1))."""
    kind: str
    mean: float = 0.0
    std: float = 1.0


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, as its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, as float32."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@contextlib.contextmanager
def tf32_off():
    """float32 products in float32 on the card (cuBLAS and cuDNN)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Ops:
    """Convolutions, linear layers and products with operands in the
    reference's precision (float32, bfloat16, or float8 e4m3 for the
    control)."""

    ROUNDING = {None: lambda t: t, "bf16": round_bf16, "fp8": round_fp8}

    def __init__(self, quant: Optional[str] = None):
        if quant not in self.ROUNDING:
            raise ValueError(f"unknown operand precision {quant!r}")
        self.q = self.ROUNDING[quant]

    def conv2d(self, x, w, b=None, stride=1, padding=0, groups=1):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding, 1, groups))

    def conv_transpose2d(self, x, w, b=None, stride=1, padding=0, output_padding=0):
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), b, stride, padding,
                                         output_padding))

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def attention(self, q: torch.Tensor, values: list[torch.Tensor],
                  chunk: int = 2048) -> list[torch.Tensor]:
        """out_j[n, i] = sum_k softmax_k(q_i . q_k) v_j[n, k], query == key
        and no scale, the PICNet attention; q [N, L, d], values [N, L, C].
        Computed in blocks of query rows so that the [L, L] map never
        exists whole."""
        qq = self.q(q)
        vs = [self.q(v) for v in values]
        outs = [[] for _ in values]
        for start in range(0, q.shape[1], chunk):
            att = torch.softmax(torch.matmul(qq[:, start:start + chunk], qq.transpose(1, 2)),
                                dim=-1)
            att = self.q(att)
            for out, v in zip(outs, vs):
                out.append(self.q(torch.matmul(att, v)))
        return [torch.cat(o, dim=1) for o in outs]


def l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_weight(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The weight over its largest singular value, estimated by one power
    iteration from the stored ``u`` (Miyato et al., arXiv:1802.05957). The
    weight is read as a matrix of rows (kh, kw, dim 1) against columns
    (dim 0), for a conv's OIHW and a transposed conv's IOHW weight alike."""
    w_mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
    v = l2normalize(w_mat @ u)
    u = l2normalize(w_mat.t() @ v)
    return w / (v @ w_mat @ u)


def bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resampling with align_corners=True (the reference's
    ``scale_img``); the identity at the same size."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def fan_in_normal(shape, gain: float = 1.0) -> WeightSpec:
    """N(0, gain^2 / fan_in) with fan_in the product of all but dim 0."""
    return WeightSpec("normal", 0.0, gain / math.sqrt(math.prod(shape[1:])))
