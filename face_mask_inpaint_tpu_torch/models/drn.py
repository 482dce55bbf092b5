"""Dilated Residual Networks (DRN-C and DRN-D), over NCHW tensors.

Port of face_mask_inpaint_tpu/models/drn.py, the rebuild of the reference's
modules/drn.py: ReferenceFill's alternative source and reference encoder is
``drn_c_42`` with its classifier replaced by a 1x1 conv head
(modules/model.py:48-62).

DRN-C-42: BasicBlock, layers (1, 1, 3, 4, 6, 3, 1, 1), channels (16, 32, 64,
128, 256, 512, 512, 512); strides 1/2/2/2, then dilations 2/4/2/1 with
residual=False on the last two groups. Total stride 8. Each conv's padding
equals its dilation, so the dilated groups keep their input's size.

Submodules carry the flax names (``layer3.block0.downsample_conv``, ``bn1``),
so convert.py maps the JAX variables onto the state_dict by a tree walk.
Input channel counts, which flax infers, are tracked here. BatchNorm is the
port's flax-semantics ``BatchNorm2d``: eval mode normalizes with the running
statistics, training mode with the batch's (in f32) and moves the running
ones. Built in eval mode; constructors only allocate (``init_weights`` or
``load_state_dict`` sets the weights).

``DRN.forward`` is two spans (``utils/profiling.span``): ``drn_strided``
(conv1 and layer1-4, the levels that stride to 1/8) and ``drn_dilated``
(layer5 on and the head, at 1/8 with dilated convs).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.nn.layers import BatchNorm2d, Conv2d
from face_mask_inpaint_tpu_torch.utils.profiling import span

__all__ = ["BasicBlock", "Bottleneck", "DRN", "drn_c_42", "drn_c_26", "drn_c_58",
           "drn_d_22", "drn_d_38"]


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN (+ residual), then ReLU (drn.py:33-66);
    one dilation a conv; ``residual=False`` drops the shortcut."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: tuple[int, int] = (1, 1), residual: bool = True,
                 use_downsample: bool = False):
        super().__init__()
        self.residual = residual
        self.conv1 = Conv2d(in_planes, planes, 3, stride, padding=dilation[0],
                            dilation=dilation[0], bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation[1], dilation=dilation[1],
                            bias=False)
        self.bn2 = BatchNorm2d(planes)
        if use_downsample:
            self.downsample_conv = Conv2d(in_planes, planes, 1, stride, bias=False)
            self.downsample_bn = BatchNorm2d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x
        if hasattr(self, "downsample_conv"):  # run even when not residual, as in
            res = self.downsample_bn(self.downsample_conv(x))  # JAX (its BN moves)
        if self.residual:
            out = out + res
        return F.relu(out)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilated) -> 1x1 to 4 planes, always residual
    (drn.py:69-107; drn_c_58 and deeper)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: tuple[int, int] = (1, 1), residual: bool = True,
                 use_downsample: bool = False):
        super().__init__()
        del residual  # the reference's Bottleneck is always residual
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, padding=dilation[1],
                            dilation=dilation[1], bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        if use_downsample:
            self.downsample_conv = Conv2d(in_planes, planes * 4, 1, stride, bias=False)
            self.downsample_bn = BatchNorm2d(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x
        if hasattr(self, "downsample_conv"):
            res = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + res)


class _ConvLayers(nn.Module):
    """conv-BN-ReLU stack (DRN._make_conv_layers, drn.py:312-322; arch D's
    layer1/2/7/8)."""

    def __init__(self, in_channels: int, channels: int, convs: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.convs = convs
        for i in range(convs):
            self.add_module(f"conv{i}", Conv2d(
                in_channels if i == 0 else channels, channels, 3,
                stride if i == 0 else 1, padding=dilation, dilation=dilation, bias=False))
            self.add_module(f"bn{i}", BatchNorm2d(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.convs):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class _LayerGroup(nn.Module):
    """DRN._make_layer (drn.py:288-310): the first block takes the stride,
    the shortcut conv (where the stride or the width changes) and, on a new
    level, half the dilation in its first conv."""

    def __init__(self, in_planes: int, planes: int, blocks: int, stride: int = 1,
                 dilation: int = 1, new_level: bool = True, residual: bool = True,
                 block: type = BasicBlock):
        super().__init__()
        self.blocks = blocks
        use_down = stride != 1 or in_planes != planes * block.expansion
        if dilation == 1:
            first_dil = (1, 1)
        else:
            first_dil = (dilation // 2 if new_level else dilation, dilation)
        self.block0 = block(in_planes, planes, stride, first_dil, residual, use_down)
        for i in range(1, blocks):
            self.add_module(f"block{i}", block(planes * block.expansion, planes, 1,
                                               (dilation, dilation), residual, False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class DRN(nn.Module):
    """DRN trunk, arch 'C' or 'D', with an optional 1x1 conv head
    (``head_features``, the ReferenceFill usage of modules/model.py:50-55).

    arch C: residual layer1/2 and non-residual BasicBlock layer7/8; arch D:
    conv-BN-ReLU stacks at layer1/2/7/8 (drn.py:120-163). ``layers[5..7]``
    of 0 drop that group."""

    def __init__(self, layers: Sequence[int] = (1, 1, 3, 4, 6, 3, 1, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512, 512, 512),
                 arch: str = "C", block: type = BasicBlock,
                 head_features: Optional[int] = 128):
        super().__init__()
        ch, ly = tuple(channels), tuple(layers)
        exp = block.expansion
        self.conv1 = Conv2d(3, ch[0], 7, padding=3, bias=False)
        self.bn1 = BatchNorm2d(ch[0])
        if arch == "C":
            self.layer1 = _LayerGroup(ch[0], ch[0], ly[0], 1)
            self.layer2 = _LayerGroup(ch[0], ch[1], ly[1], 2)
        elif arch == "D":
            self.layer1 = _ConvLayers(ch[0], ch[0], ly[0], 1)
            self.layer2 = _ConvLayers(ch[0], ch[1], ly[1], 2)
        else:
            raise NotImplementedError(f"DRN arch [{arch}]")
        self.layer3 = _LayerGroup(ch[1], ch[2], ly[2], 2, block=block)
        self.layer4 = _LayerGroup(ch[2] * exp, ch[3], ly[3], 2, block=block)
        self.layer5 = _LayerGroup(ch[3] * exp, ch[4], ly[4], 1, dilation=2, new_level=False,
                                  block=block)
        in_planes = ch[4] * exp
        self.groups = ["layer1", "layer2", "layer3", "layer4", "layer5"]
        if ly[5]:
            self.layer6 = _LayerGroup(in_planes, ch[5], ly[5], 1, dilation=4,
                                      new_level=False, block=block)
            in_planes = ch[5] * exp
            self.groups.append("layer6")
        for name, i, dil in (("layer7", 6, 2), ("layer8", 7, 1)):
            if not ly[i]:
                continue
            if arch == "C":
                group = _LayerGroup(in_planes, ch[i], ly[i], 1, dilation=dil,
                                    new_level=False, residual=False)
            else:
                group = _ConvLayers(in_planes, ch[i], ly[i], dilation=dil)
            self.add_module(name, group)
            in_planes = ch[i]
            self.groups.append(name)
        self.out_channels = in_planes
        if head_features is not None:
            self.fc = Conv2d(in_planes, head_features, 1)
            self.out_channels = head_features
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, C, H, W] -> [N, out_channels, ~H/8, ~W/8]."""
        with span("drn_strided"):
            x = F.relu(self.bn1(self.conv1(x)))
            for name in self.groups[:4]:
                x = getattr(self, name)(x)
        with span("drn_dilated"):
            for name in self.groups[4:]:
                x = getattr(self, name)(x)
            if hasattr(self, "fc"):
                x = self.fc(x)
        return x


def drn_c_42(head_features: Optional[int] = 128) -> DRN:
    return DRN(layers=(1, 1, 3, 4, 6, 3, 1, 1), head_features=head_features)


def drn_c_26(head_features: Optional[int] = 128) -> DRN:
    return DRN(layers=(1, 1, 2, 2, 2, 2, 1, 1), head_features=head_features)


def drn_c_58(head_features: Optional[int] = 128) -> DRN:
    return DRN(layers=(1, 1, 3, 4, 6, 3, 1, 1), block=Bottleneck,
               head_features=head_features)


def drn_d_22(head_features: Optional[int] = 128) -> DRN:
    return DRN(layers=(1, 1, 2, 2, 2, 2, 1, 1), arch="D", head_features=head_features)


def drn_d_38(head_features: Optional[int] = 128) -> DRN:
    return DRN(layers=(1, 1, 3, 4, 6, 3, 1, 1), arch="D", head_features=head_features)
