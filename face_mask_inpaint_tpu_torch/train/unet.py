"""Mask-detector (UNet, Stack C) training and evaluation steps.

Port of face_mask_inpaint_tpu/train/unet.py (reference
train_mask_detector.py:61-181): the loss is cross-entropy plus the
multiclass Dice of the f32 softmax against the one-hot labels (:129-134);
validation is the Dice of the argmax one-hot without the background channel
(:24-58). The train step runs the model in training mode, so its
``BatchNorm2d`` layers normalize with the batch's statistics and move their
running ones (flax semantics, nn/layers.py); the eval step runs it on the
running statistics. ``--amp`` is the model's bf16 compute dtype over f32
parameters, as the JAX trainer builds it: bf16 has f32's exponent range, so
no loss scaling.

Given a ``group`` (parallel/dist.py), the train step runs on this rank's
slice of a global batch and computes the one-process step on the global
batch: BatchNorm's moments and the Dice's sums are global, the gradients
are averaged over the ranks before Adam steps, and the loss is the ranks'
mean.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.losses.dice import dice_loss, multiclass_dice_coeff
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.parallel import dist as _dp

__all__ = ["unet_loss", "make_unet_train_step", "make_unet_eval_step"]


def unet_loss(logits: torch.Tensor, true_mask: torch.Tensor, n_classes: int = 2
              ) -> torch.Tensor:
    """CE + multiclass Dice. logits [N, H, W, C]; true_mask [N, H, W] int.
    Computed in f32 (f64 for f64 logits)."""
    logits32 = logits.to(torch.promote_types(logits.dtype, torch.float32))
    ce = F.cross_entropy(logits32.permute(0, 3, 1, 2), true_mask.long())
    onehot = F.one_hot(true_mask.long(), n_classes).to(logits32.dtype)
    return ce + dice_loss(torch.softmax(logits32, dim=-1), onehot, multiclass=True)


def make_unet_train_step(model: MaskDetector, optimizer: torch.optim.Optimizer,
                         group=None) -> Callable[[dict], dict]:
    """``step(batch)`` with batch["image"] [N, H, W, 3] and batch["mask"]
    [N, H, W] int labels on the model's device (with a ``group``, this
    rank's slice of the global batch): one Adam update, the batch
    statistics moved; returns {"loss"} (a 0-d tensor)."""

    def step(batch: dict) -> dict:
        model.train()
        with _dp.data_parallel(group):
            loss = unet_loss(model(batch["image"]), batch["mask"])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            params = [p for p in model.parameters() if p.grad is not None]
            for p, g in zip(params, _dp.all_reduce_mean([p.grad for p in params], group)):
                p.grad = g
            loss = _dp.mean_over_ranks({"loss": loss}, group)["loss"]
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_unet_eval_step(model: MaskDetector) -> Callable[[dict], dict]:
    """``step(batch)`` -> {"dice"}: the Dice of the argmax one-hot against the
    labels, foreground channels only, averaged over the batch."""

    @torch.no_grad()
    def step(batch: dict) -> dict:
        model.eval()
        logits = model(batch["image"])
        n_classes = logits.shape[-1]
        pred = F.one_hot(logits.argmax(dim=-1), n_classes).float()
        true = F.one_hot(batch["mask"].long(), n_classes).float()
        return {"dice": multiclass_dice_coeff(pred[..., 1:], true[..., 1:],
                                              reduce_batch_first=False)}

    return step
