"""UNet mask detector (Stack C), over NCHW tensors.

Port of face_mask_inpaint_tpu/models/unet.py (dense execution): the classic
4-down/4-up UNet, bilinear (align_corners=True) or transposed-conv
upsampling, odd-size padding before the skip concat ``[skip, upsampled]``,
and a 1x1 head. Built in eval mode (BatchNorm on running statistics);
``train()`` runs its BatchNorm layers on the batch's statistics and moves the
running ones, with the JAX package's flax semantics (nn/layers.py), for the
Stack C trainer (train/unet.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.nn.layers import (
    BatchNorm2d, Conv2d, ConvTranspose2d, init_weights)
from face_mask_inpaint_tpu_torch.ops.resize import bilinear_resize, max_pool2d
from face_mask_inpaint_tpu_torch.utils.profiling import spanned

__all__ = ["UNet", "MaskDetector"]


class DoubleConv(nn.Module):
    """(conv 3x3 -> BN -> ReLU) x 2 (unet_parts.py:8-25)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None):
        super().__init__()
        mid = out_channels if mid_channels is None else mid_channels
        self.conv1 = Conv2d(in_channels, mid, 3, padding=1)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = Conv2d(mid, out_channels, 3, padding=1)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Down(nn.Module):
    """maxpool(2) + DoubleConv (unet_parts.py:28-39)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(max_pool2d(x, 2))


class Up(nn.Module):
    """Upsample x1, pad it to the skip's size, concat [skip, x1], DoubleConv
    (unet_parts.py:42-68)."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 bilinear: bool = True):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(skip_channels + in_channels, out_channels, in_channels)
        else:
            self.up = ConvTranspose2d(in_channels, in_channels // 2, 2, 2, 0, 0)
            self.conv = DoubleConv(skip_channels + in_channels // 2, out_channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.bilinear:
            x1 = bilinear_resize(x1, (2 * x1.shape[2], 2 * x1.shape[3]), align_corners=True)
        else:
            x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class UNet(nn.Module):
    """Full UNet (unet_model.py:6-36): NCHW image -> NCHW logits."""

    def __init__(self, n_channels: int = 3, n_classes: int = 2, bilinear: bool = True):
        super().__init__()
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024 // factor)
        self.up1 = Up(1024 // factor, 512, 512 // factor, bilinear)
        self.up2 = Up(512 // factor, 256, 256 // factor, bilinear)
        self.up3 = Up(256 // factor, 128, 128 // factor, bilinear)
        self.up4 = Up(128 // factor, 64, 64, bilinear)
        self.outc = Conv2d(64, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y)


class MaskDetector(nn.Module):
    """Mask detector wrapper (modules/mask_detector.py:7-30), built in eval
    mode with weights drawn from ``generator``."""

    def __init__(self, n_channels: int = 3, bilinear: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.model = UNet(n_channels, 2, bilinear)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.eval()

    @spanned("detector")
    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] image -> [N, H, W, 2] logits (the reference's
        mode='train')."""
        return self.model(image.permute(0, 3, 1, 2).to(self.dtype)).permute(0, 2, 3, 1)

    @spanned("detector")
    def predict_mask(self, image: torch.Tensor) -> torch.Tensor:
        """The argmax decision every inference harness uses: [N, H, W] float
        mask, 1 where logits[1] > logits[0] (a tie picks class 0)."""
        logits = self.model(image.permute(0, 3, 1, 2).to(self.dtype))
        return (logits[:, 1] > logits[:, 0]).float()
