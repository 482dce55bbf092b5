"""Plain float32 reference of the mask detector, shared by the configurations.

The UNet of milesial/Pytorch-UNet (unet_model.py, unet_parts.py) with
bilinear upsampling, in eval mode: (3x3 conv, BatchNorm on running
statistics, ReLU) x 2 a level, 2x2 max pool down, bilinear
(align_corners=True) x2 up, the skip concatenated first, a 1x1 head to two
logits. The mask is 1 where logit 1 exceeds logit 0. Weights are read by the
state-dict names under ``prefix``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import common
from benchmark.reference.common import Ops, WeightSpec, fan_in_normal


def _widths(n_channels: int) -> dict[str, tuple[int, int, int]]:
    """level -> (in, mid, out) channels of each double conv (bilinear UNet)."""
    f = 2
    return {"inc": (n_channels, 64, 64), "down1": (64, 128, 128), "down2": (128, 256, 256),
            "down3": (256, 512, 512), "down4": (512, 1024 // f, 1024 // f),
            "up1": (1024, 512, 512 // f), "up2": (512, 256, 256 // f),
            "up3": (256, 128, 128 // f), "up4": (128, 64, 64)}


def weight_specs(prefix: str, n_channels: int = 3,
                 bilinear: bool = True) -> dict[str, tuple[tuple[int, ...], WeightSpec]]:
    """name -> (shape, how it is drawn) for every weight of the detector.
    Convolutions N(0, 2 / fan_in) (ReLU gain), biases N(0, 0.05^2),
    BatchNorm scale 1 + N(0, 0.1^2), shift and running mean N(0, 0.1^2),
    running variance exp(N(0, 0.2^2))."""
    if not bilinear:
        raise NotImplementedError("the reference covers the bilinear UNet")
    specs = {}
    for level, (cin, mid, cout) in _widths(n_channels).items():
        base = f"{prefix}{level}" + ("" if level == "inc" else ".conv")
        for i, (ci, co) in enumerate(((cin, mid), (mid, cout)), start=1):
            w = (co, ci, 3, 3)
            specs[f"{base}.conv{i}.weight"] = (w, fan_in_normal(w, 2 ** 0.5))
            specs[f"{base}.conv{i}.bias"] = ((co,), WeightSpec("normal", 0.0, 0.05))
            specs[f"{base}.bn{i}.weight"] = ((co,), WeightSpec("normal", 1.0, 0.1))
            specs[f"{base}.bn{i}.bias"] = ((co,), WeightSpec("normal", 0.0, 0.1))
            specs[f"{base}.bn{i}.running_mean"] = ((co,), WeightSpec("normal", 0.0, 0.1))
            specs[f"{base}.bn{i}.running_var"] = ((co,), WeightSpec("lognormal", 0.0, 0.2))
    specs[f"{prefix}outc.weight"] = ((2, 64, 1, 1), fan_in_normal((2, 64, 1, 1)))
    specs[f"{prefix}outc.bias"] = ((2,), WeightSpec("normal", 0.0, 0.05))
    return specs


def _double_conv(w: dict, base: str, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    for i in (1, 2):
        x = ops.conv2d(x, w[f"{base}.conv{i}.weight"], w[f"{base}.conv{i}.bias"], padding=1)
        x = F.batch_norm(x, w[f"{base}.bn{i}.running_mean"], w[f"{base}.bn{i}.running_var"],
                         w[f"{base}.bn{i}.weight"], w[f"{base}.bn{i}.bias"], False, 0.0, 1e-5)
        x = F.relu(x)
    return x


def logits(w: dict, prefix: str, image: torch.Tensor, ops: Ops) -> torch.Tensor:
    """image [N, H, W, 3] -> logits [N, 2, H, W]."""
    x = image.permute(0, 3, 1, 2).float()
    skips = [_double_conv(w, f"{prefix}inc", x, ops)]
    for level in ("down1", "down2", "down3", "down4"):
        skips.append(_double_conv(w, f"{prefix}{level}.conv", F.max_pool2d(skips[-1], 2), ops))
    y = skips.pop()
    for level in ("up1", "up2", "up3", "up4"):
        skip = skips.pop()
        y = common.bilinear(y, (2 * y.shape[2], 2 * y.shape[3]))
        dh, dw = skip.shape[2] - y.shape[2], skip.shape[3] - y.shape[3]
        if dh or dw:
            y = F.pad(y, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        y = _double_conv(w, f"{prefix}{level}.conv", torch.cat([skip, y], dim=1), ops)
    return ops.conv2d(y, w[f"{prefix}outc.weight"], w[f"{prefix}outc.bias"])


def calibrate(w: dict, prefix: str, image: torch.Tensor, share: float) -> dict:
    """Shift logit 1's bias so that the mask covers ``share`` of the pixels
    of ``image`` (random weights alone give a mask of almost none or almost
    all pixels, by seed). The shift comes from this float32 reference, so
    it is a function of the seed alone. Returns the entries it changed."""
    lg = logits(w, prefix, image, Ops())
    gap = (lg[:, 1] - lg[:, 0]).flatten()
    cut = torch.quantile(gap, 1.0 - share)
    name = f"{prefix}outc.bias"
    bias = w[name].clone()
    bias[1] -= cut
    w[name] = bias
    return {name: bias}


def gap(w: dict, prefix: str, image: torch.Tensor, ops: Ops) -> torch.Tensor:
    """Logit 1 minus logit 0, [N, H, W]: the mask is 1 where it is positive,
    and its size is the margin by which a pixel is decided."""
    lg = logits(w, prefix, image, ops)
    return lg[:, 1] - lg[:, 0]
