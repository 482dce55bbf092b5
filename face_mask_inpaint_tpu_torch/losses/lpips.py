"""LPIPS, Learned Perceptual Image Patch Similarity (v0.1).

Port of face_mask_inpaint_tpu/losses/lpips.py (reference
modules/psp/criteria/lpips/): a frozen AlexNet, VGG16 or SqueezeNet-1.1
feature trunk, unit normalization of each tap over channels, the squared
difference through a frozen 1x1 ``lin`` conv, the spatial mean, summed over
the taps and averaged over the batch. The submodules carry the flax names
(``trunk.conv1``, ``trunk.fire3.squeeze``, ``lin0`` ...), so convert.py maps
the JAX parameters by path. The parameters are frozen (``requires_grad``
off); gradients flow to the images.

Images enter as NHWC in LPIPS's [-1, 1] convention, the JAX package's layout;
the taps are NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.nn.layers import Conv2d
from face_mask_inpaint_tpu_torch.ops.resize import max_pool2d

__all__ = ["LPIPSNet", "N_CHANNELS"]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

N_CHANNELS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}
_VGG = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# (name, in, squeeze, expand) of the SqueezeNet-1.1 Fire modules
_FIRES = (("fire3", 64, 16, 64), ("fire4", 128, 16, 64), ("fire6", 128, 32, 128),
          ("fire7", 256, 32, 128), ("fire9", 256, 48, 192), ("fire10", 384, 48, 192),
          ("fire11", 384, 64, 256), ("fire12", 512, 64, 256))


def _normalize_activation(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def _max_pool3_2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel=3, stride=2), no padding."""
    return F.max_pool2d(x, 3, 2)


class _Fire(nn.Module):
    """SqueezeNet Fire module: squeeze 1x1, then expand 1x1 and 3x3, joined."""

    def __init__(self, in_c: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = Conv2d(in_c, squeeze, 1)
        self.expand1x1 = Conv2d(squeeze, expand, 1)
        self.expand3x3 = Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(s)), torch.relu(self.expand3x3(s))], dim=1)


class _Trunk(nn.Module):
    """The feature trunk; returns the taps, NCHW."""

    def __init__(self, net_type: str = "alex"):
        super().__init__()
        self.net_type = net_type
        if net_type == "alex":
            for i, (cin, cout, k, stride, pad) in enumerate(
                    ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
                     (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))):
                setattr(self, f"conv{i + 1}", Conv2d(cin, cout, k, stride=stride, padding=pad))
        elif net_type == "vgg":
            cin = 3
            for b, (n_convs, ch) in enumerate(_VGG):
                for c in range(n_convs):
                    setattr(self, f"conv{b + 1}_{c + 1}", Conv2d(cin, ch, 3, padding=1))
                    cin = ch
        elif net_type == "squeeze":
            self.conv1 = Conv2d(3, 64, 3, stride=2)
            for name, cin, sq, ex in _FIRES:
                setattr(self, name, _Fire(cin, sq, ex))
        else:
            raise NotImplementedError("choose net_type from [alex, squeeze, vgg].")

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        if self.net_type == "alex":
            for i in range(5):
                if i in (1, 2):
                    x = _max_pool3_2(x)
                x = torch.relu(getattr(self, f"conv{i + 1}")(x))
                taps.append(x)
        elif self.net_type == "vgg":
            for b, (n_convs, _) in enumerate(_VGG):
                if b > 0:
                    x = max_pool2d(x, 2)
                for c in range(n_convs):
                    x = torch.relu(getattr(self, f"conv{b + 1}_{c + 1}")(x))
                taps.append(x)
        else:
            x = torch.relu(self.conv1(x))
            taps.append(x)
            # a max pool before fire3, fire6 and fire9; a tap after fire4,
            # fire7 and each of fire9 .. fire12
            for name, _, _, _ in _FIRES:
                if name in ("fire3", "fire6", "fire9"):
                    x = _max_pool3_2(x)
                x = getattr(self, name)(x)
                if name not in ("fire3", "fire6"):
                    taps.append(x)
        return taps


class LPIPSNet(nn.Module):
    """Feature trunk + frozen lin heads; ``forward(x, y)`` returns the
    scalar LPIPS distance of two NHWC batches."""

    def __init__(self, net_type: str = "alex"):
        super().__init__()
        self.net_type = net_type
        self.trunk = _Trunk(net_type)
        for i, c in enumerate(N_CHANNELS[net_type]):
            setattr(self, f"lin{i}", Conv2d(c, 1, 1, bias=False))
        self.requires_grad_(False)

    def distance(self, fx: Sequence[torch.Tensor], fy: Sequence[torch.Tensor]) -> torch.Tensor:
        """The lin-head stage over two lists of NCHW taps: the layer sum of
        the spatial mean of lin((unit(a) - unit(b))^2), over the batch."""
        total = torch.zeros((), dtype=torch.float32, device=fx[0].device)
        n = fx[0].shape[0]
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_normalize_activation(a) - _normalize_activation(b)) ** 2
            lin = getattr(self, f"lin{i}")(d)
            total = total + torch.sum(torch.mean(lin.float(), dim=(2, 3))) / n
        return total

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        fx = self.trunk(((x - shift) / scale).permute(0, 3, 1, 2))
        fy = self.trunk(((y - shift) / scale).permute(0, 3, 1, 2))
        return self.distance(fx, fy)
