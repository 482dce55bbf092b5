"""Adversarial objectives: lsgan, vanilla, hinge, wgangp.

Port of face_mask_inpaint_tpu/losses/gan.py ``gan_loss`` (the reference's
GANLoss, external_function.py:80-131). The prediction is reduced in float32
whatever its dtype. ``cal_gradient_penalty``, which no entry point calls,
is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gan_loss"]


def gan_loss(prediction: torch.Tensor, target_is_real: bool, is_disc: bool = False,
             gan_mode: str = "lsgan", target_real_label: float = 1.0,
             target_fake_label: float = 0.0) -> torch.Tensor:
    """lsgan: MSE to the label; vanilla: BCE with logits; hinge and wgangp
    switch on ``is_disc`` as the reference does."""
    pred = prediction.float()
    if gan_mode in ("lsgan", "vanilla"):
        label = target_real_label if target_is_real else target_fake_label
        if gan_mode == "lsgan":
            return torch.mean((pred - label) ** 2)
        return torch.mean(F.relu(pred) - pred * label + torch.log1p(torch.exp(-pred.abs())))
    if gan_mode in ("hinge", "wgangp"):
        if is_disc:
            if target_is_real:
                pred = -pred
            if gan_mode == "hinge":
                return torch.mean(F.relu(1.0 + pred))
            return torch.mean(pred)
        return -torch.mean(pred)
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")
