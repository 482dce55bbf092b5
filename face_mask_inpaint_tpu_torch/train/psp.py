"""pSp (Stack B) training and eval steps.

Port of face_mask_inpaint_tpu/train/psp.py (reference train_psp.py:245-391):
the encoder is optimized and the decoder frozen unless ``train_decoder``
(``partition_params``, the counterpart of ``partitioned_tx``: the frozen
parameters get ``requires_grad=False`` and no optimizer state), and the
non-finite guard of train_psp.py:328-335 as the JAX step implements it: on a
non-finite loss the gradients are zeroed and the optimizer still steps, so
Adam's moments decay and its count advances (Ranger's slow buffer too, at a
sync step), but the parameters stay where they were. The encoder's
BatchNorm running statistics keep that step's update, as ``merged(mut)``
keeps it in the JAX step.

Images are NHWC and masks [N, H, W] in {0, 1}, on the model's device.

Given a ``group`` (parallel/dist.py), the train step runs on this rank's
slice of a global batch and computes the one-process step on the global
batch: the trainable partition's gradients are averaged over the ranks, the
encoder's BatchNorm moments, the contextual term's feature mean and the
randomized noise are global, the loss dict is the ranks' mean, and the guard
decides on that mean, so every rank skips or steps together.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from face_mask_inpaint_tpu_torch.losses.psp_loss import PSPLossConfig, psp_loss
from face_mask_inpaint_tpu_torch.parallel import dist as _dp

__all__ = ["partition_params", "make_psp_train_step", "make_psp_eval_step"]


def partition_params(model: nn.Module, train_decoder: bool) -> list[tuple[str, nn.Parameter]]:
    """Mark the encoder's parameters (and the decoder's with
    ``train_decoder``) trainable and freeze the rest (train_psp.py:287-289);
    returns the trainable (name, parameter) pairs."""
    named = []
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        p.requires_grad_(top == "encoder" or (top == "decoder" and train_decoder))
        if p.requires_grad:
            named.append((name, p))
    return named


def _forward_loss(model, cfg: PSPLossConfig, nets: dict, batch: dict, use_ref: bool,
                  randomize_noise: bool, resize: bool, noise: Optional[torch.Generator]):
    ref = batch["ref_img"] if use_ref else None
    y_hat, latent = model(batch["src_img"], ref=ref,
                          src_mask=batch["mask"] if use_ref else None, resize=resize,
                          randomize_noise=randomize_noise, return_latents=True,
                          generator=noise)
    loss, loss_dict, _ = psp_loss(cfg, nets, x=batch["src_img"], y=batch["gt_img"],
                                  y_hat=y_hat, latent=latent, latent_avg=model.latent_avg,
                                  ref=ref, mask=batch["mask"])
    return loss, loss_dict, y_hat


def make_psp_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                        cfg: PSPLossConfig, nets: dict, use_ref: bool = True,
                        randomize_noise: bool = True, resize: bool = True, group=None):
    """``step(batch, noise=None, return_grads=False) -> loss_dict``: one
    update in place on the model and the optimizer, over the model's
    trainable parameters (``partition_params``). ``resize`` pools the output
    to 256^2 as pSp.forward does; tests on tiny shapes turn it off. The loss
    dict holds detached scalars, ``skipped_nonfinite`` (1.0 when the guard
    held the parameters) and, with ``return_grads``, ``grads``: name ->
    gradient, zero on a skipped step. Randomized noise comes from
    ``noise``. With a ``group`` the batch is this rank's slice of the
    global batch."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]

    def step(batch: dict, noise: Optional[torch.Generator] = None,
             return_grads: bool = False) -> dict:
        with _dp.data_parallel(group):
            return _step(batch, noise, return_grads)

    def _step(batch: dict, noise: Optional[torch.Generator], return_grads: bool) -> dict:
        model.train()
        loss, loss_dict, _ = _forward_loss(model, cfg, nets, batch, use_ref,
                                           randomize_noise, resize, noise)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if group is not None:
            loss_dict = _dp.mean_over_ranks(loss_dict, group)
            loss = loss_dict["loss"]
        finite = bool(torch.isfinite(loss))
        if finite and group is not None:
            grads = _dp.all_reduce_mean(grads, group)
        if not finite:
            grads = [torch.zeros_like(p) for p in params]
            held = [p.detach().clone() for p in params]
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        if not finite:
            with torch.no_grad():
                for p, h in zip(params, held):
                    p.copy_(h)
        out = {k: v.detach() for k, v in loss_dict.items()}
        out["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0)
        if return_grads:
            out["grads"] = {n: g for (n, _), g in zip(named, grads)}
        return out

    return step


def make_psp_eval_step(model: nn.Module, cfg: PSPLossConfig, nets: dict, use_ref: bool = True):
    """``step(batch) -> {loss, gen, **loss_dict}``: the losses in eval mode
    with the fixed noise, under ``torch.no_grad()``; the model returns to
    its previous mode after it."""

    @torch.no_grad()
    def step(batch: dict) -> dict:
        mode = model.training
        model.eval()
        try:
            loss, loss_dict, gen = _forward_loss(model, cfg, nets, batch, use_ref,
                                                 randomize_noise=False, resize=True,
                                                 noise=None)
        finally:
            model.train(mode)
        return {**loss_dict, "loss": loss, "gen": gen}

    return step
