"""ArcFace identity loss.

Port of face_mask_inpaint_tpu/losses/id_loss.py (reference
modules/psp/criteria/id_loss.py): crop the face region ([35:223, 32:220]),
adaptive-pool to 112, embed with the frozen IR-SE-50 ``Backbone`` in eval
mode; loss = mean(1 - <e(y_hat), e(y)>) with y's embedding detached, the
similarity improvement over the masked input, and per-sample logs. Images
are NHWC in [-1, 1].
"""

from __future__ import annotations

import torch

from face_mask_inpaint_tpu_torch.models.irse import Backbone
from face_mask_inpaint_tpu_torch.ops.resize import adaptive_avg_pool2d

__all__ = ["make_backbone", "extract_feats", "id_loss"]


def make_backbone() -> Backbone:
    """IDLoss facenet config (id_loss.py:12-16)."""
    return Backbone(input_size=112, num_layers=50, mode="ir_se", drop_ratio=0.6)


def extract_feats(facenet: Backbone, x: torch.Tensor) -> torch.Tensor:
    """Crop + pool + embed (id_loss.py:20-24). x: NHWC in [-1, 1]."""
    x = x[:, 35:223, 32:220, :].permute(0, 3, 1, 2)
    return facenet(adaptive_avg_pool2d(x, (112, 112)))


def id_loss(facenet: Backbone, y_hat: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """Returns (loss, sim_improvement, id_logs), id_logs holding the
    per-sample ``diff_target``, ``diff_input`` and ``diff_views``."""
    x_feats = extract_feats(facenet, x)
    y_feats = extract_feats(facenet, y).detach()
    y_hat_feats = extract_feats(facenet, y_hat)
    diff_target = torch.sum(y_hat_feats * y_feats, dim=1)
    diff_input = torch.sum(y_hat_feats * x_feats, dim=1)
    diff_views = torch.sum(y_feats * x_feats, dim=1)
    loss = torch.mean(1.0 - diff_target)
    sim_improvement = torch.mean(diff_target - diff_views)
    return loss, sim_improvement, {"diff_target": diff_target, "diff_input": diff_input,
                                   "diff_views": diff_views}
