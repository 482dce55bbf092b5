"""The composite pSp training loss.

Port of face_mask_inpaint_tpu/losses/psp_loss.py (reference
modules/psp/criteria/__init__.py, pSpLoss): the lambda-gated sum of the
identity, masked L2 and masked LPIPS terms against the ground truth, the
reference-side LPIPS and L2 inside the mask, and the W-norm, with the
reference's quirk kept: the style and contextual terms are COMPUTED and
logged but NEVER ADDED to the loss (criteria/__init__.py:74-76, 88-90).
They carry no gradient in the JAX package either, so they run under
``torch.no_grad()`` here, which keeps their VGG activations out of memory.

The sub-nets come in ``nets``: ``lpips`` (LPIPSNet), ``facenet``
(Backbone) and ``vgg`` (VGG16Features), only those whose lambdas are
active. Images are NHWC, masks [N, H, W].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from face_mask_inpaint_tpu_torch.losses.id_loss import id_loss
from face_mask_inpaint_tpu_torch.losses.vgg import vgg_loss
from face_mask_inpaint_tpu_torch.losses.w_norm import w_norm_loss

__all__ = ["PSPLossConfig", "psp_loss"]


@dataclass(frozen=True)
class PSPLossConfig:
    """Loss lambdas, mirroring the train_psp.py flag surface (:71-96)."""

    id_lambda: float = 0.0
    lpips_lambda: float = 0.8
    l2_lambda: float = 1.0
    style_lambda: float = 250.0
    lpips_lambda_ref: float = 0.0
    l2_lambda_ref: float = 0.0
    cx_lambda: float = 1.0
    w_norm_lambda: float = 0.0
    start_from_latent_avg: bool = False


def psp_loss(cfg: PSPLossConfig, nets: dict, x: torch.Tensor, y: torch.Tensor,
             y_hat: torch.Tensor, latent: Optional[torch.Tensor],
             latent_avg: Optional[torch.Tensor] = None, ref: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None):
    """Returns (loss, loss_dict, id_logs), as the JAX ``psp_loss`` does."""
    loss_dict: dict[str, torch.Tensor] = {}
    loss = torch.zeros((), dtype=torch.float32, device=y_hat.device)
    id_logs = None
    m = mask[..., None].to(y_hat.dtype) if mask is not None else None

    if cfg.id_lambda > 0:
        loss_id, sim_improvement, id_logs = id_loss(nets["facenet"], y_hat, y, x)
        loss_dict["loss_id"] = loss_id
        loss_dict["id_improve"] = sim_improvement
        loss = loss_id * cfg.id_lambda
    if cfg.l2_lambda > 0:
        if m is not None:
            inv = 1.0 - m
            loss_l2 = torch.mean((y_hat * inv - y * inv) ** 2)
        else:
            loss_l2 = torch.mean((y_hat - y) ** 2)
        loss_dict["loss_l2"] = loss_l2
        loss = loss + loss_l2 * cfg.l2_lambda
    if cfg.lpips_lambda > 0:
        if m is not None:
            inv = 1.0 - m
            loss_lp = nets["lpips"](y_hat * inv, y * inv)
        else:
            loss_lp = nets["lpips"](y_hat, y)
        loss_dict["loss_lpips"] = loss_lp
        loss = loss + loss_lp * cfg.lpips_lambda
    if cfg.style_lambda > 0 and m is not None:
        with torch.no_grad():  # computed + logged, not added (criteria/__init__.py:74-76)
            loss_dict["loss_style"] = vgg_loss(nets["vgg"], y_hat * (1.0 - m), x,
                                               "style") * cfg.style_lambda

    if ref is not None:
        if cfg.lpips_lambda_ref > 0:
            loss_lp_ref = nets["lpips"](y_hat * m, ref * m)
            loss_dict["loss_lpips_ref"] = loss_lp_ref
            loss = loss + loss_lp_ref * cfg.lpips_lambda_ref
        if cfg.l2_lambda_ref > 0:
            loss_l2_ref = torch.mean((y_hat * m - ref * m) ** 2)
            loss_dict["loss_l2_ref"] = loss_l2_ref
            loss = loss + loss_l2_ref * cfg.l2_lambda_ref
        if cfg.cx_lambda > 0:
            with torch.no_grad():  # computed + logged, not added (criteria/__init__.py:88-90)
                loss_dict["loss_context"] = vgg_loss(nets["vgg"], y_hat * m, ref * m,
                                                     "contextual") * cfg.cx_lambda

    if cfg.w_norm_lambda > 0 and latent_avg is not None:
        loss_w = w_norm_loss(latent, latent_avg, cfg.start_from_latent_avg)
        loss_dict["loss_w_norm"] = loss_w
        loss = loss + loss_w * cfg.w_norm_lambda

    loss_dict["loss"] = loss
    return loss, loss_dict, id_logs
