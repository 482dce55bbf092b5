"""Convolution primitives over NCHW tensors with OIHW / IOHW weights.

Port of face_mask_inpaint_tpu/ops/conv.py. The JAX package leaves its
convolutions to XLA and emulates torch's padding rules; here they are the
torch operators, so ``conv_transpose2d`` has torch's (stride, padding,
output_padding) semantics by construction.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "conv_transpose2d", "pixel_shuffle"]


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """Cross-correlation; weight [Cout, Cin // groups, kh, kw]."""
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride=1, padding=0,
                     output_padding=0) -> torch.Tensor:
    """Transposed conv; weight [Cin, Cout, kh, kw]. Output size is
    (H - 1) * s - 2p + k + op."""
    return F.conv_transpose2d(x, weight, bias, stride, padding, output_padding)


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """``nn.PixelShuffle``."""
    return F.pixel_shuffle(x, upscale_factor)
