"""SSIM / MS-SSIM with the ``pytorch_msssim`` defaults the reference uses.

Port of face_mask_inpaint_tpu/evaluations/ssim.py: gaussian window 11, sigma
1.5, K = (0.01, 0.03), valid (no-pad) separable filtering; MS-SSIM with
weights (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), 2x2 average-pool
downsampling with odd-size padding, relu on the intermediate cs terms.

Inputs are NHWC float tensors in [0, data_range]; the math runs in f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ssim", "ms_ssim"]

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@functools.lru_cache(maxsize=None)
def _gauss_1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode blur of NCHW, one filter per channel."""
    c, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_and_cs(x, y, win, data_range, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _gaussian_filter(x, win)
    mu2 = _gaussian_filter(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _gaussian_filter(x * x, win) - mu1_sq
    sigma2_sq = _gaussian_filter(y * y, win) - mu2_sq
    sigma12 = _gaussian_filter(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3)), cs_map.mean(dim=(1, 2, 3))


def _prepare(x: torch.Tensor, win_size: int, win_sigma: float):
    win = torch.from_numpy(_gauss_1d(win_size, win_sigma)).to(x.device)
    return x.permute(0, 3, 1, 2).float(), win


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5,
         size_average: bool = True) -> torch.Tensor:
    """SSIM over NHWC images; ``size_average`` takes the batch mean."""
    x, win = _prepare(x, win_size, win_sigma)
    y = y.permute(0, 3, 1, 2).float()
    s, _ = _ssim_and_cs(x, y, win, data_range)
    return s.mean() if size_average else s


def _avg_pool_pad_odd(x: torch.Tensor) -> torch.Tensor:
    """pytorch_msssim downsample: avg_pool2d(kernel=2) after zero-padding odd
    sizes on the bottom/right."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph))
    return F.avg_pool2d(x, 2)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            win_size: int = 11, win_sigma: float = 1.5, size_average: bool = True,
            weights=_MS_WEIGHTS) -> torch.Tensor:
    """MS-SSIM over NHWC images (5 scales by default); needs spatial sizes
    above (win_size - 1) * 2**4, as pytorch_msssim asserts."""
    x, win = _prepare(x, win_size, win_sigma)
    y = y.permute(0, 3, 1, 2).float()
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    mcs = []
    s = None
    for i in range(len(weights)):
        s, cs = _ssim_and_cs(x, y, win, data_range)
        if i < len(weights) - 1:
            mcs.append(torch.relu(cs))
            x, y = _avg_pool_pad_odd(x), _avg_pool_pad_odd(y)
    s = torch.relu(s)
    mcs_stack = torch.stack(mcs, dim=0)
    out = torch.prod(mcs_stack ** w[:-1, None], dim=0) * (s ** w[-1])
    return out.mean() if size_average else out
