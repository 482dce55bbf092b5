"""FID, the Fréchet Inception Distance.

Port of face_mask_inpaint_tpu/evaluations/fid.py: the torchvision
InceptionV3 trunk through Mixed_7c, global-average-pooled to [N, 2048]
(``InceptionV3Features``), its activations over a set of images
(``get_activations``, on an explicit device), and the Fréchet distance of two
activation sets' statistics on the host with scipy's ``sqrtm``, with the
eps-regularized retry and the imaginary-component check of the reference
(fid.py:106-156).

The modules carry the flax module names (``Conv2d_1a_3x3``, ``Mixed_5b`` ...
``Mixed_7c``, each branch a ``BasicConv2d`` of ``conv`` and ``bn``), which
are also torchvision's, so ``convert.py`` maps the JAX variables with its
existing rules and a torchvision ``inception_v3`` state dict loads through
``tools/convert_torch.convert_inception_v3``. Inputs are NHWC in [0, 1] at
299x299, rescaled to [-1, 1] inside as PartialInceptionNetwork does.
"""

from __future__ import annotations

import logging
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.nn.layers import BatchNorm2d, Conv2d, init_weights
from face_mask_inpaint_tpu_torch.ops.resize import max_pool2d, scale_img

__all__ = ["InceptionV3Features", "get_activations", "statistics_from_activations",
           "calculate_frechet_distance", "frechet_from_activations", "build_inception",
           "FIDAccumulator"]


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm(eps 1e-3) -> relu."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride, padding, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(3, 1, 1) dividing by 9 everywhere (count_include_pad)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                  self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionV3Features(nn.Module):
    """torchvision Inception3 through Mixed_7c -> [N, 2048] pooled
    activations; input NHWC in [0, 1] at 299x299. Built in eval mode
    (BatchNorm on running statistics) with weights from ``generator``."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:]) != (299, 299, 3):
            raise ValueError(f"Expected input shape to be: (N,299,299,3), but got "
                             f"{tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2) * 2 - 1
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive_avg_pool2d((1, 1)) -> [N, 2048]


@torch.no_grad()
def get_activations(images, batch_size: int, model: InceptionV3Features,
                    device=None) -> np.ndarray:
    """[N, 299, 299, 3] in [0, 1] (numpy or tensor) -> [N, 2048] float32
    activations, ``batch_size`` images a forward on ``device`` (the model's
    own by default) (fid.py:58-85)."""
    device = next(model.parameters()).device if device is None else torch.device(device)
    num = images.shape[0]
    out = np.zeros((num, 2048), np.float32)
    for start in range(0, num, batch_size):
        chunk = torch.as_tensor(images[start:start + batch_size], dtype=torch.float32)
        out[start:start + chunk.shape[0]] = model(chunk.to(device)).float().cpu().numpy()
    return out


def statistics_from_activations(act: np.ndarray):
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy's matrix square root, quietly: ``disp=False`` where scipy still
    takes it (the reference's call), the plain call where it was removed."""
    from scipy import linalg

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        try:
            return linalg.sqrtm(a, disp=False)[0]
        except TypeError:
            return linalg.sqrtm(a)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance of two Gaussians, on the host, with the reference's
    eps-regularized ``sqrtm`` retry and imaginary-component check
    (fid.py:106-156)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError("the two sets' statistics differ in shape")
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        warnings.warn(f"fid calculation produces singular product; adding {eps} to the "
                      "diagonal of cov estimates")
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def frechet_from_activations(act1: np.ndarray, act2: np.ndarray) -> float:
    """One Fréchet distance of two whole activation sets."""
    return calculate_frechet_distance(*statistics_from_activations(act1),
                                      *statistics_from_activations(act2))


def build_inception(weights: str, device, generator: Optional[torch.Generator] = None,
                    warning: str = "") -> InceptionV3Features:
    """InceptionV3Features on ``device``: a torchvision ``inception_v3``
    state dict (or the port's own) from ``weights`` through the CLIs'
    loader, or, without the file, random weights from ``generator`` and
    ``warning`` logged."""
    from face_mask_inpaint_tpu_torch.convert import load_checkpoint, read_checkpoint
    from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_inception_v3

    model = InceptionV3Features(generator)
    state = read_checkpoint(weights, "InceptionV3") if weights else None
    if state is not None:
        load_checkpoint(model, state, convert_inception_v3, "InceptionV3", weights)
    elif warning:
        logging.warning(warning)
    return model.to(device).eval()


class FIDAccumulator:
    """Dataset-level FID over a set of batches (test_evaluate.py:96-116, and
    a validation round of train_psp.py:290-343, train_reference_fill.py:
    287-345): ``add`` takes each batch's ground
    truth and generated images (NHWC in [0, 1], any size), resizes them to
    299^2 (bilinear, align_corners=True; the generated ones clipped to
    [0, 1]) and keeps their activations; ``value`` is one Fréchet distance
    of all of them."""

    def __init__(self, model: InceptionV3Features):
        self.model = model
        self.gt: list[np.ndarray] = []
        self.gen: list[np.ndarray] = []

    @staticmethod
    def _299(x: torch.Tensor) -> torch.Tensor:
        return scale_img(x.float().permute(0, 3, 1, 2), (299, 299)).permute(0, 2, 3, 1)

    def add(self, gt: torch.Tensor, gen: torch.Tensor) -> None:
        n = gen.shape[0]
        self.gt.append(get_activations(self._299(gt), n, self.model))
        self.gen.append(get_activations(self._299(gen).clamp(0.0, 1.0), n, self.model))

    def value(self) -> float:
        return frechet_from_activations(np.concatenate(self.gt), np.concatenate(self.gen))
