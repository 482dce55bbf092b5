"""W-norm latent regularizer (reference modules/psp/criteria/w_norm.py).

Port of face_mask_inpaint_tpu/losses/w_norm.py.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["w_norm_loss"]


def w_norm_loss(latent: torch.Tensor, latent_avg: Optional[torch.Tensor] = None,
                start_from_latent_avg: bool = True) -> torch.Tensor:
    """sum_n ||latent_n - latent_avg||_2 / N over the [N, n_styles, 512] block."""
    if start_from_latent_avg:
        latent = latent - latent_avg
    norms = torch.sqrt(torch.sum(latent.float() ** 2, dim=(1, 2)))
    return torch.sum(norms) / latent.shape[0]
