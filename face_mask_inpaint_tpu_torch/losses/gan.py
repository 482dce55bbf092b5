"""Adversarial objectives: lsgan, vanilla, hinge, wgangp, and the WGAN-GP
gradient penalty.

Port of face_mask_inpaint_tpu/losses/gan.py: ``gan_loss`` (the reference's
GANLoss, external_function.py:80-131), whose prediction is reduced in
float32 whatever its dtype, and ``cal_gradient_penalty``
(external_function.py:134-166), which no entry point calls.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["gan_loss", "cal_gradient_penalty"]


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


def cal_gradient_penalty(disc: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                         fake: torch.Tensor, penalty_type: str = "mixed", constant: float = 1.0,
                         lambda_gp: float = 10.0, alpha: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
    """WGAN-GP penalty: lambda_gp * mean((||d sum(disc(x)) / dx + 1e-16|| -
    constant)^2) over the batch, at x = real, fake or, for 'mixed', alpha *
    real + (1 - alpha) * fake.

    ``alpha`` ([N, 1, 1, 1]) is drawn with ``torch.rand`` from ``generator``
    when None. The gradient is taken with ``create_graph=True``, so
    ``penalty.backward()`` reaches the discriminator's parameters (a double
    backward). Returns (penalty, the gradient in x's shape), or (0.0, None)
    when ``lambda_gp <= 0``, as the JAX function does."""
    if lambda_gp <= 0.0:
        return 0.0, None
    if penalty_type == "real":
        x = real
    elif penalty_type == "fake":
        x = fake
    elif penalty_type == "mixed":
        if alpha is None:
            alpha = torch.rand((real.shape[0], 1, 1, 1), generator=generator,
                               device=real.device, dtype=real.dtype)
        x = alpha * real + (1 - alpha) * fake
    else:
        raise NotImplementedError(f"{penalty_type} not implemented")
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    out = disc(x)
    (grads,) = torch.autograd.grad(out, x, torch.ones_like(out), create_graph=True)
    norms = torch.linalg.vector_norm(grads.reshape(real.shape[0], -1) + 1e-16, dim=1)
    return torch.mean((norms - constant) ** 2) * lambda_gp, grads
