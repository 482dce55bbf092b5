"""IR-SE ResNet backbones and the pSp encoders, over NCHW.

Port of face_mask_inpaint_tpu/models/irse.py: the bottleneck units and block
specs (reference encoders/helpers.py), the GradualStyleEncoder with the
reference fusion (psp_encoders.py:40-152), the two last-layer backbone
encoders and the ArcFace ``Backbone`` of the identity loss
(model_irse.py:8-46). ``train()`` and ``eval()`` select the BatchNorm mode
(nn/layers.py: batch statistics with flax's running-stat update, or the
running statistics), as the JAX modules' ``train`` argument does. The submodules
carry the flax names (``input_layer``, ``body.body_<i>``, ``latlayer1``,
``attention1``, ``styles_<j>.conv<i>``), so convert.py maps the JAX variables
by path. The 18 style heads are plain modules, one for each w vector.

Constructors only allocate; weights come from ``init_weights(module,
generator)`` (flax's defaults: lecun-normal convs and dense layers, BatchNorm
ones and zeros, PReLU 0.25) or from ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.models.stylegan2 import EqualLinear
from face_mask_inpaint_tpu_torch.nn.blocks import ExampleGuidedAttention
from face_mask_inpaint_tpu_torch.nn.layers import BatchNorm2d, Conv2d, Dense, PReLU
from face_mask_inpaint_tpu_torch.ops.resize import (
    adaptive_avg_pool2d, bilinear_resize, scale_img)

__all__ = ["get_blocks", "tap_indices", "SEModule", "BottleneckIR", "IRBody", "InputLayer",
           "GradualStyleBlock", "GradualStyleEncoder", "BackboneEncoderUsingLastLayerIntoW",
           "BackboneEncoderUsingLastLayerIntoWPlus", "Backbone"]


class BlockSpec(NamedTuple):
    in_channel: int
    depth: int
    stride: int


def _block(in_channel, depth, num_units, stride=2):
    return [BlockSpec(in_channel, depth, stride)] + [
        BlockSpec(depth, depth, 1) for _ in range(num_units - 1)]


def get_blocks(num_layers: int) -> list[list[BlockSpec]]:
    """Layer specs (helpers.py:28-53); ``num_layers=4`` is one unit a stage
    with the same channels and strides, for small test configurations."""
    units = {50: (3, 4, 14, 3), 100: (3, 13, 30, 3), 152: (3, 8, 36, 3), 4: (1, 1, 1, 1)}
    if num_layers not in units:
        raise ValueError(f"Invalid number of layers: {num_layers}")
    chans = ((64, 64), (64, 128), (128, 256), (256, 512))
    return [_block(i, d, u) for (i, d), u in zip(chans, units[num_layers])]


def tap_indices(num_layers: int) -> tuple[int, int, int]:
    """Flat body indices of the last unit of stages 2, 3 and 4, the feature
    pyramid's taps (6, 20, 23 for IR-50, psp_encoders.py:104-112)."""
    cum, ends = 0, []
    for block in get_blocks(num_layers):
        cum += len(block)
        ends.append(cum - 1)
    return ends[1], ends[2], ends[3]


class SEModule(nn.Module):
    """Squeeze-excite (helpers.py:57-73)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class BottleneckIR(nn.Module):
    """bottleneck_IR / bottleneck_IR_SE (helpers.py:76-119). Shortcut: a
    stride slice when in == depth, else 1x1 conv + BN. Residual: BN, conv3x3,
    PReLU, conv3x3 (stride), BN [, SE]."""

    def __init__(self, in_channel: int, depth: int, stride: int, use_se: bool = False):
        super().__init__()
        self.stride = stride
        if in_channel != depth:
            self.shortcut_conv = Conv2d(in_channel, depth, 1, stride=stride, bias=False)
            self.shortcut_bn = BatchNorm2d(depth)
        else:
            self.shortcut_conv = self.shortcut_bn = None
        self.bn0 = BatchNorm2d(in_channel)
        self.conv1 = Conv2d(in_channel, depth, 3, padding=1, bias=False)
        self.prelu = PReLU(depth)
        self.conv2 = Conv2d(depth, depth, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(depth)
        self.se = SEModule(depth) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_conv is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_bn(self.shortcut_conv(x))
        res = self.bn2(self.conv2(self.prelu(self.conv1(self.bn0(x)))))
        if self.se is not None:
            res = self.se(res)
        return res + shortcut


class IRBody(nn.Module):
    """The flat stack of bottleneck units ``body_<i>``, so the tap indices
    line up with the reference's Sequential body."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se"):
        super().__init__()
        self.n_units = 0
        for block in get_blocks(num_layers):
            for spec in block:
                setattr(self, f"body_{self.n_units}", BottleneckIR(
                    spec.in_channel, spec.depth, spec.stride, use_se=mode == "ir_se"))
                self.n_units += 1

    def forward(self, x: torch.Tensor, tap_indices: Sequence[int] = ()):
        taps = {}
        for i in range(self.n_units):
            x = getattr(self, f"body_{i}")(x)
            if i in tap_indices:
                taps[i] = x
        return x, taps


class InputLayer(nn.Module):
    """conv3x3(64) + BN + PReLU(64), the stem of every IR encoder."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv = Conv2d(in_channels, 64, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(64)
        self.prelu = PReLU(64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.bn(self.conv(x)))


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 conv3x3 + LeakyReLU(0.01), then EqualLinear
    (psp_encoders.py:13-37)."""

    def __init__(self, in_c: int, out_c: int, spatial: int):
        super().__init__()
        self.out_c = out_c
        self.num_pools = int(math.log2(spatial))
        for i in range(self.num_pools):
            setattr(self, f"conv{i}", Conv2d(in_c if i == 0 else out_c, out_c, 3, stride=2,
                                             padding=1))
        self.linear = EqualLinear(out_c, out_c, lr_mul=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_pools):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.01)
        return self.linear(x.reshape(x.shape[0], self.out_c))


class GradualStyleEncoder(nn.Module):
    """FPN-style pSp encoder with reference fusion (psp_encoders.py:40-152).

    Taps c1, c2, c3 at the ends of stages 2-4. With a reference image and a
    mask, the reference's taps are fused in: ExampleGuidedAttention on c3
    and c2 with ``use_attention`` (a mask lerp otherwise), a mask lerp on c1.
    The FPN adds bilinear (align_corners=True) upsampled levels to 1x1
    lateral convs; the style heads read c3 (coarse), p2 (middle) and p1
    (fine).
    """

    coarse_ind = 3
    middle_ind = 7

    def __init__(self, num_layers: int = 50, mode: str = "ir_se", n_styles: int = 18,
                 use_attention: bool = False):
        super().__init__()
        self.num_layers, self.n_styles, self.use_attention = num_layers, n_styles, use_attention
        self.input_layer = InputLayer()
        self.body = IRBody(num_layers, mode)
        self.latlayer1 = Conv2d(256, 512, 1)
        self.latlayer2 = Conv2d(128, 512, 1)
        if use_attention:
            self.attention1 = ExampleGuidedAttention(512, out_channels=512)
            self.attention2 = ExampleGuidedAttention(256, out_channels=256)
        for j in range(n_styles):
            spatial = 16 if j < self.coarse_ind else 32 if j < self.middle_ind else 64
            setattr(self, f"styles_{j}", GradualStyleBlock(512, 512, spatial))

    def backbone_taps(self, x: torch.Tensor):
        """One IR-SE backbone pass -> the (c1, c2, c3) pyramid taps."""
        t1, t2, t3 = tap_indices(self.num_layers)
        _, taps = self.body(self.input_layer(x), tap_indices=(t1, t2, t3))
        return taps[t1], taps[t2], taps[t3]

    def _fused_taps(self, src_taps, ref_taps, mask):
        c1, c2, c3 = src_taps
        if ref_taps is None:
            return c1, c2, c3
        if mask is None:
            raise ValueError("ref and mask should both be provided")
        m = mask[:, None].to(c3.dtype)  # [N, 1, H, W]
        r1, r2, r3 = ref_taps
        mask_3, mask_2, mask_1 = (scale_img(m, r.shape[2:]) for r in (r3, r2, r1))
        if self.use_attention:
            c3 = self.attention1(mask_3, c3, r3)
            c2 = self.attention2(mask_2, c2, r2)
        else:
            c3 = mask_3 * r3 + (1 - mask_3) * c3
            c2 = mask_2 * r2 + (1 - mask_2) * c2
        c1 = mask_1 * r1 + (1 - mask_1) * c1
        return c1, c2, c3

    def fuse_pyramid(self, src_taps, ref_taps=None, mask=None):
        """Reference fusion + FPN -> (c3, p2, p1), the style heads' inputs."""
        c1, c2, c3 = self._fused_taps(src_taps, ref_taps, mask)
        lat1 = self.latlayer1(c2)
        p2 = bilinear_resize(c3, lat1.shape[2:], align_corners=True) + lat1
        lat2 = self.latlayer2(c1)
        p1 = bilinear_resize(p2, lat2.shape[2:], align_corners=True) + lat2
        return c3, p2, p1

    def fuse_styles(self, src_taps, ref_taps=None, mask=None) -> torch.Tensor:
        """Reference fusion + FPN + the style heads -> [N, n_styles, 512]."""
        c3, p2, p1 = self.fuse_pyramid(src_taps, ref_taps, mask)
        levels = [(c3, range(self.coarse_ind)),
                  (p2, range(self.coarse_ind, self.middle_ind)),
                  (p1, range(self.middle_ind, self.n_styles))]
        return torch.stack([getattr(self, f"styles_{j}")(x) for x, idx in levels for j in idx],
                           dim=1)

    def forward(self, x: torch.Tensor, ref: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, ref: [N, 3, H, W]; mask: [N, H, W] -> [N, n_styles, 512]."""
        src_taps = self.backbone_taps(x)
        ref_taps = self.backbone_taps(ref) if ref is not None else None
        return self.fuse_styles(src_taps, ref_taps, mask)


class BackboneEncoderUsingLastLayerIntoW(nn.Module):
    """psp_encoders.py:155-185: the last feature map pooled to one w."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se"):
        super().__init__()
        self.input_layer = InputLayer()
        self.body = IRBody(num_layers, mode)
        self.linear = EqualLinear(512, 512, lr_mul=1)

    def forward(self, x, ref=None, mask=None) -> torch.Tensor:
        """The reference variants ignore ``ref`` and ``mask``."""
        h, _ = self.body(self.input_layer(x))
        return self.linear(h.mean(dim=(2, 3)))


class BackboneEncoderUsingLastLayerIntoWPlus(nn.Module):
    """psp_encoders.py:188-221: the last feature map -> n_styles w. The 7x7
    pool is flattened in NHWC order, the JAX package's, so its Dense weight
    carries over as it is."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se", n_styles: int = 18):
        super().__init__()
        self.n_styles = n_styles
        self.input_layer = InputLayer()
        self.body = IRBody(num_layers, mode)
        self.out_bn = BatchNorm2d(512)
        self.out_linear = Dense(512 * 7 * 7, 512)
        self.linear = EqualLinear(512, 512 * n_styles, lr_mul=1)

    def forward(self, x, ref=None, mask=None) -> torch.Tensor:
        h, _ = self.body(self.input_layer(x))
        h = adaptive_avg_pool2d(self.out_bn(h), (7, 7))
        h = self.out_linear(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
        return self.linear(h).reshape(-1, self.n_styles, 512)


class Backbone(nn.Module):
    """ArcFace recognition net of the identity loss (model_irse.py:8-46):
    the IR-SE body, ``out_bn``, the 7x7 map flattened in NHWC order (the JAX
    package's, so its Dense weight carries over as it is), ``out_linear``,
    a BatchNorm1d on the buffers ``out_bn1d_mean``/``out_bn1d_var`` with the
    affine ``out_bn1d_scale``/``out_bn1d_bias``, and the l2 norm. It runs in
    eval mode only, as the identity loss runs it (id_loss.py:18), so its
    dropout is never active and ``train()`` raises. Its parameters are
    frozen (``requires_grad`` off)."""

    def __init__(self, input_size: int = 112, num_layers: int = 50, mode: str = "ir_se",
                 drop_ratio: float = 0.6, affine: bool = True):
        super().__init__()
        if input_size not in (112, 224):
            raise ValueError(f"input_size should be 112 or 224, got {input_size}")
        self.drop_ratio, self.affine = drop_ratio, affine
        side = input_size // 16
        self.input_layer = InputLayer()
        self.body = IRBody(num_layers, mode)
        self.out_bn = BatchNorm2d(512)
        self.out_linear = Dense(512 * side * side, 512)
        self.register_buffer("out_bn1d_mean", torch.empty(512))
        self.register_buffer("out_bn1d_var", torch.empty(512))
        if affine:
            self.out_bn1d_scale = nn.Parameter(torch.empty(512))
            self.out_bn1d_bias = nn.Parameter(torch.empty(512))
        self.requires_grad_(False)
        self.eval()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.out_bn1d_mean.zero_()
            self.out_bn1d_var.fill_(1.0)
            if self.affine:
                self.out_bn1d_scale.fill_(1.0)
                self.out_bn1d_bias.zero_()

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError("Backbone runs in eval mode only, as the identity "
                                      "loss runs it")
        return super().train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 3, S, S] -> l2-normalized [N, 512] embeddings."""
        h, _ = self.body(self.input_layer(x))
        h = self.out_bn(h)
        h = self.out_linear(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
        h32 = h.float()
        h = ((h32 - self.out_bn1d_mean) * torch.rsqrt(self.out_bn1d_var + 1e-5)).to(h.dtype)
        if self.affine:
            h = h * self.out_bn1d_scale.to(h.dtype) + self.out_bn1d_bias.to(h.dtype)
        return h / torch.linalg.vector_norm(h, dim=1, keepdim=True)
