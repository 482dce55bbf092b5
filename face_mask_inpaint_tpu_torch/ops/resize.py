"""Spatial resampling with PyTorch semantics, over NCHW tensors.

Port of face_mask_inpaint_tpu/ops/resize.py. The JAX package emulates these
torch resamplers with dense interpolation matrices (XLA has no
align_corners=True bilinear and no adaptive pooling); here they are the torch
operators themselves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["bilinear_resize", "scale_img", "adaptive_avg_pool2d", "nearest_resize",
           "reflection_pad2d", "avg_pool2d", "max_pool2d"]


def _size2(size) -> tuple[int, int]:
    if isinstance(size, int):
        return size, size
    return int(size[0]), int(size[1])


def bilinear_resize(x: torch.Tensor, size, align_corners: bool = True) -> torch.Tensor:
    """``F.interpolate(mode='bilinear')``; identity when the size matches."""
    size = _size2(size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


def scale_img(img: torch.Tensor, size) -> torch.Tensor:
    """The reference's ``scale_img`` (modules/model.py:10-12): bilinear,
    align_corners=True."""
    return bilinear_resize(img, size, align_corners=True)


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d``; identity when the size matches."""
    size = _size2(output_size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.adaptive_avg_pool2d(x, size)


def nearest_resize(x: torch.Tensor, size) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` (source index floor(i * in / out));
    identity when the size matches."""
    size = _size2(size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="nearest")


def reflection_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``nn.ReflectionPad2d(pad)``."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """``nn.AvgPool2d`` without padding."""
    return F.avg_pool2d(x, window, window if stride is None else stride)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """``nn.MaxPool2d`` without padding."""
    return F.max_pool2d(x, window, window if stride is None else stride)
