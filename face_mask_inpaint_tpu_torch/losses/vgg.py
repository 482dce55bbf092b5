"""VGG16 feature losses: perceptual, style (Gram) and contextual.

Port of face_mask_inpaint_tpu/losses/vgg.py (the reference's VGGLoss,
modules/loss.py:16-65, StyleLoss and contextual_loss,
external_function.py:180-273). ``VGG16Features`` is torchvision's
``vgg16().features[:23]`` with taps after relu1_2, relu2_2, relu3_3 and
relu4_3; its submodules carry the JAX names (``conv1_1`` ...), and
``convert.vgg16_state_dict_from_torchvision`` maps a torchvision state_dict
onto them. Its parameters are frozen (``requires_grad`` off).

Images enter ``vgg_loss`` as NHWC in the JAX package's layout; feature maps
are NCHW inside this module. The trunk runs in ``dtype`` (bf16-mixed
training passes bfloat16); every loss reduction is float32. The contextual
loss keeps the JAX guards: d = max(1 - cos, 0) and norms floored at 1e-12.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from face_mask_inpaint_tpu_torch.nn.layers import Conv2d
from face_mask_inpaint_tpu_torch.ops.resize import max_pool2d, scale_img

__all__ = ["VGG16Features", "gram_matrix", "style_loss_gram", "contextual_loss",
           "vgg_loss"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
# (convs per block, channels) of the four tapped VGG16 blocks
_BLOCKS: Sequence[tuple[int, int]] = ((2, 64), (2, 128), (3, 256), (3, 512))


class VGG16Features(nn.Module):
    """VGG16 trunk up to relu4_3, returning the four tap activations (NCHW).
    Weights: ``init_weights`` from a generator (random features) or a
    converted state_dict."""

    def __init__(self):
        super().__init__()
        cin = 3
        for b, (n_convs, ch) in enumerate(_BLOCKS):
            for c in range(n_convs):
                self.add_module(f"conv{b + 1}_{c + 1}", Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for b, (n_convs, _) in enumerate(_BLOCKS):
            if b > 0:
                x = max_pool2d(x, 2)
            for c in range(n_convs):
                x = torch.relu(getattr(self, f"conv{b + 1}_{c + 1}")(x))
            taps.append(x)
        return taps


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """GramMatrix on NCHW: [N, C, C] / (C H W), accumulated in float32."""
    n, c, h, w = feats.shape
    f = feats.reshape(n, c, h * w).float()
    return torch.matmul(f, f.transpose(1, 2)) / (c * h * w)


def style_loss_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """StyleLoss: L1 between Gram matrices, the target's detached."""
    return torch.mean(torch.abs(gram_matrix(x) - gram_matrix(y).detach()))


def contextual_loss(x: torch.Tensor, y: torch.Tensor, h: float = 0.5) -> torch.Tensor:
    """Contextual loss on NCHW feature maps; cosines in float32."""
    n, c = x.shape[:2]
    y_mu = y.mean(dim=(0, 2, 3), keepdim=True)  # per channel, over N, H, W
    x_c, y_c = x - y_mu, y - y_mu
    x_n = x_c / torch.clamp_min(torch.linalg.vector_norm(x_c, dim=1, keepdim=True), 1e-12)
    y_n = y_c / torch.clamp_min(torch.linalg.vector_norm(y_c, dim=1, keepdim=True), 1e-12)
    x_n = x_n.reshape(n, c, -1).float()
    y_n = y_n.reshape(n, c, -1).float()
    cos = torch.matmul(x_n.transpose(1, 2), y_n)            # [N, HW_x, HW_y]
    d = torch.clamp_min(1.0 - cos, 0.0)
    d_min = d.amin(dim=2, keepdim=True)
    d_tilde = d / (d_min + 1e-5)
    w = torch.exp((1.0 - d_tilde) / h)
    cx_ij = w / w.sum(dim=2, keepdim=True)
    cx = cx_ij.amax(dim=1).mean(dim=1)
    return torch.mean(-torch.log(cx + 1e-5))


def _preprocess(img: torch.Tensor) -> torch.Tensor:
    """NHWC image -> NCHW, rescaled to 224 when larger ("Filter HQ",
    loss.py:48-49), ImageNet-normalized in the image's dtype."""
    x = img.permute(0, 3, 1, 2)
    if x.shape[2] > 224:
        x = scale_img(x, (224, 224))
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)[None, :, None, None]
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)[None, :, None, None]
    return (x - mean) / std


def vgg_loss(vgg: VGG16Features, input_img: torch.Tensor, target_img: torch.Tensor,
             loss_type: str = "perceptual", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """VGGLoss.forward (loss.py:45-65) on NHWC images; the sum of per-block
    normalized losses:

    perceptual: sum_i L1(x_i, y_i) / dim_i
    style:      sum_i StyleLoss / (C_i^2 dim_i)
    contextual: contextual_loss on block 4 only, / dim_4
    """
    xs = vgg(_preprocess(input_img).to(dtype))
    ys = vgg(_preprocess(target_img).to(dtype))
    loss = torch.zeros((), dtype=torch.float32, device=input_img.device)
    for i, (x, y) in enumerate(zip(xs, ys)):
        c = x.shape[1]
        dim = float(x.shape[1] * x.shape[2] * x.shape[3])
        if loss_type == "perceptual":
            loss = loss + torch.mean(torch.abs(x.float() - y.float())) / dim
        elif loss_type == "style":
            loss = loss + style_loss_gram(x, y) / (c * c * dim)
        elif loss_type == "contextual" and i == 3:
            loss = loss + contextual_loss(x, y) / dim
    return loss
