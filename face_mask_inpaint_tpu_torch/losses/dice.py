"""Dice coefficient and loss of the UNet mask-detector trainer.

Port of face_mask_inpaint_tpu/losses/dice.py (reference modules/loss.py:148-186):
the per-sample Dice as a batched reduction, with the ``sets_sum == 0 ->
2 * inter`` guard that keeps Dice at 1 when both masks are empty. One-hot
maps are NHWC, the class axis last, as in the JAX package.

Inside a data-parallel train step (``parallel.dist.data_parallel``) the Dice
of the whole batch (``reduce_batch_first``, the loss's form) sums its three
terms over the ranks, differentiably, so it is the Dice of the global batch.
"""

from __future__ import annotations

import torch

from face_mask_inpaint_tpu_torch.parallel import dist as _dp

__all__ = ["dice_coeff", "multiclass_dice_coeff", "dice_loss"]


def _dice_flat(inp: torch.Tensor, tgt: torch.Tensor, epsilon: float = 1e-6,
               group=None) -> torch.Tensor:
    """Dice over the last axis of [..., K] inputs; with a ``group``, of the
    inputs of every rank."""
    inter = torch.sum(inp * tgt, dim=-1)
    if group is None:
        sets_sum = torch.sum(inp, dim=-1) + torch.sum(tgt, dim=-1)
    else:
        inter, s_inp, s_tgt = _dp.all_reduce_sum(
            torch.stack([inter, torch.sum(inp, dim=-1), torch.sum(tgt, dim=-1)]))
        sets_sum = s_inp + s_tgt
    sets_sum = torch.where(sets_sum == 0, 2 * inter, sets_sum)
    return (2 * inter + epsilon) / (sets_sum + epsilon)


def dice_coeff(inp: torch.Tensor, tgt: torch.Tensor, reduce_batch_first: bool = False,
               epsilon: float = 1e-6) -> torch.Tensor:
    """Mean Dice over the batch, or one Dice of the whole batch with
    ``reduce_batch_first`` (or 2-d inputs). inp/tgt: [N, ...], same shape."""
    if inp.dim() == 2 or reduce_batch_first:
        return _dice_flat(inp.reshape(-1), tgt.reshape(-1), epsilon,
                          _dp.active() if reduce_batch_first else None)
    n = inp.shape[0]
    return _dice_flat(inp.reshape(n, -1), tgt.reshape(n, -1), epsilon).mean()


def multiclass_dice_coeff(inp: torch.Tensor, tgt: torch.Tensor,
                          reduce_batch_first: bool = False,
                          epsilon: float = 1e-6) -> torch.Tensor:
    """Mean Dice over the classes of [N, H, W, C] one-hot maps."""
    return torch.stack([dice_coeff(inp[..., i], tgt[..., i], reduce_batch_first, epsilon)
                        for i in range(inp.shape[-1])]).mean()


def dice_loss(inp: torch.Tensor, tgt: torch.Tensor, multiclass: bool = False) -> torch.Tensor:
    fn = multiclass_dice_coeff if multiclass else dice_coeff
    return 1.0 - fn(inp, tgt, reduce_batch_first=True)
