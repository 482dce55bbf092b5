"""fused_bias_act: bias add + LeakyReLU(0.2) + sqrt(2) gain, over NCHW.

Port of face_mask_inpaint_tpu/ops/fused_act.py with the bias on dim 1. A CUDA
tensor launches kernel K7a (kernels/fused_act.py); a CPU tensor takes its
plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from face_mask_inpaint_tpu_torch.kernels import fused_act as fa

__all__ = ["fused_leaky_relu", "scaled_leaky_relu"]


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = fa.SQRT2) -> torch.Tensor:
    """y = leaky_relu(x + bias) * scale, bias over the channel dim
    (reference op/fused_act.py:72-85)."""
    return fa.fused_leaky_relu(x.contiguous(), bias, negative_slope, scale)


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """ScaledLeakyReLU (stylegan2/model.py:174-184): leaky_relu * sqrt(2)."""
    return fa.fused_leaky_relu(x.contiguous(), None, negative_slope, fa.SQRT2)
