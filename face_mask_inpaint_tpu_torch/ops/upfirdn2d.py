"""upfirdn2d, the StyleGAN2 resampling primitive, over NCHW.

Port of face_mask_inpaint_tpu/ops/upfirdn2d.py with the same pads:

  1. zero-upsample by ``up`` (insert up-1 zeros between samples),
  2. pad spatially by (pad0, pad1) per edge (a negative pad crops),
  3. FIR filter (true convolution),
  4. downsample by ``down`` (keep every down-th sample).

Output size: (H*up + pad0 + pad1 - k) // down + 1 (the same for W).

Every StyleGAN2 filter is separable: ``make_kernel`` outer-products a 1-D
tap list. The functions here take that 1-D list as ``taps``
(``make_taps``), the filter being outer(taps, taps), and a gain is split
evenly between the two axes. A CUDA tensor launches kernel K6
(kernels/upfirdn2d.py) in the modes (up, down) in {(1, 1), (2, 1), (1, 2)}
and raises in any other; a CPU tensor takes its plain version.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir

__all__ = ["make_kernel", "make_taps", "upfirdn2d", "upsample_2d", "downsample_2d", "blur"]


def make_kernel(k) -> np.ndarray:
    """Normalized 2-D FIR kernel from a 1-D or 2-D tap list
    (stylegan2/model.py:19-27): a 1-D list is outer-producted, then the
    kernel is scaled to unit sum."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / np.sum(k)


def make_taps(k: Sequence[float], gain: float = 1.0) -> np.ndarray:
    """1-D taps t with outer(t, t) == make_kernel(k) * gain: the list scaled
    to unit sum, times sqrt(gain) on each axis."""
    k = np.asarray(k, dtype=np.float64).reshape(-1)
    return (k / k.sum() * math.sqrt(gain)).astype(np.float32)


def upfirdn2d(x: torch.Tensor, taps: Sequence[float], up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """up-FIR-down of NCHW x with the separable filter outer(taps, taps)."""
    return fir.upfirdn2d(x.contiguous(), taps, up, down, pad)


def upsample_2d(x: torch.Tensor, taps: Sequence[float], factor: int = 2) -> torch.Tensor:
    """StyleGAN2 Upsample module (stylegan2/model.py:30-49): gain factor**2,
    split as ``factor`` on each axis."""
    k = len(taps)
    p = k - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return upfirdn2d(x, np.asarray(taps, np.float32) * factor, up=factor, down=1,
                     pad=(pad0, pad1))


def downsample_2d(x: torch.Tensor, taps: Sequence[float], factor: int = 2) -> torch.Tensor:
    """StyleGAN2 Downsample module (stylegan2/model.py:52-71)."""
    k = len(taps)
    p = k - factor
    return upfirdn2d(x, taps, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur(x: torch.Tensor, taps: Sequence[float], pad: tuple[int, int],
         upsample_factor: int = 1) -> torch.Tensor:
    """StyleGAN2 Blur module (stylegan2/model.py:74-91): gain
    upsample_factor**2, split as ``upsample_factor`` on each axis."""
    return upfirdn2d(x, np.asarray(taps, np.float32) * upsample_factor, up=1, down=1, pad=pad)
