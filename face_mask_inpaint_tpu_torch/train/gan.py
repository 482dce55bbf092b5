"""The two-optimizer GAN training step of Stack A, and its eval step.

Port of face_mask_inpaint_tpu/train/gan.py (``gan_losses``,
``make_gan_train_step``, ``make_gan_eval_step``), the reference's
GANOptimizer (modules/loss.py:79-144):

1. G step: gradients of lsgan(D(fake), real) * lambda_g + L1(fake, gt)
   + 0.1 perceptual + 250 style + 1 contextual with respect to the
   generator's parameters only (``torch.autograd.grad``): D's parameters get
   no update from the G loss.
2. D step: gradients of 0.5 (lsgan(D(gt), real) + lsgan(D(fake.detach()),
   fake)) with respect to the discriminator's parameters.

The spectral-norm u vectors advance in the JAX package's D-call order:
D(fake), D(real), D(fake.detach()); the generator's advance once per step.
Images are NHWC, as the JAX package passes them; the discriminator runs on
NCHW in the generator's compute dtype. bf16-mixed training is a bfloat16
``ReferenceFill.dtype`` with float32 parameters, optimizer state and loss
reductions. The sampling noise comes from an explicit ``torch.Generator`` or
is passed in (``eps_q``/``eps_p``, NHWC like the encoders' mu).

With the DRN encoder the generator has BatchNorm layers. The train step
applies G once, in training mode, so they normalize with the batch's
statistics and move the running ones once a step, as the JAX step's one
apply with ``mutable=["spectral", "batch_stats"]`` does; the eval step runs
them on the running statistics.

Given a ``group`` (parallel/dist.py), the train step runs on this rank's
slice of a global batch and computes the one-process step on the global
batch: G's gradients and then D's are averaged over the ranks before each
optimizer steps, the batch-coupled reductions (the DRN's BatchNorm, the
contextual loss's feature mean) and the sampling noise are global, and the
metrics are the ranks' mean. The spectral-norm vectors move from the
weights alone, which stay equal on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from face_mask_inpaint_tpu_torch.losses.gan import gan_loss
from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features, vgg_loss
from face_mask_inpaint_tpu_torch.parallel import dist as _dp

__all__ = ["gan_losses", "make_gan_train_step", "make_gan_eval_step",
           "LAMBDA_PERC", "LAMBDA_STYLE", "LAMBDA_CX"]

LAMBDA_PERC = 0.1
LAMBDA_STYLE = 250.0
LAMBDA_CX = 1.0


def _apply_d(discriminator: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """D on an NHWC image, in the compute dtype."""
    return discriminator(x.permute(0, 3, 1, 2).to(dtype))


def gan_losses(generator: nn.Module, discriminator: nn.Module, vgg: VGG16Features,
               batch: dict, eps_q: Optional[torch.Tensor] = None,
               eps_p: Optional[torch.Tensor] = None, noise: Optional[torch.Generator] = None,
               lambda_g: float = 0.01, gan_mode: str = "lsgan"):
    """(G total loss, aux) with aux holding ``gen`` and each weighted term.

    batch: ``src_img``, ``gt_img``, ``ref_img`` [N, H, W, 3] and ``mask``
    [N, H, W] in {0, 1}, on the models' device."""
    src, gt, ref, mask = batch["src_img"], batch["gt_img"], batch["ref_img"], batch["mask"]
    gen = generator(src, ref, mask, eps_q=eps_q, eps_p=eps_p, generator=noise)
    d_fake = _apply_d(discriminator, gen, gen.dtype)
    loss_ad_g = gan_loss(d_fake, True, False, gan_mode) * lambda_g
    loss_l1_g = torch.mean(torch.abs(gen.float() - gt.float()))
    perc = vgg_loss(vgg, gen, gt, "perceptual", dtype=gen.dtype) * LAMBDA_PERC
    mm = mask[..., None].to(gen.dtype)
    style = vgg_loss(vgg, gen * (1.0 - mm), src, "style", dtype=gen.dtype) * LAMBDA_STYLE
    cx = vgg_loss(vgg, gen * mm, ref * mm, "contextual", dtype=gen.dtype) * LAMBDA_CX
    g_total = loss_ad_g + loss_l1_g + perc + style + cx
    return g_total, dict(gen=gen, loss_ad_g=loss_ad_g, loss_l1_g=loss_l1_g,
                         perc_loss=perc, style_loss=style, cx_loss=cx)


def _trainable(module: nn.Module) -> list[tuple[str, nn.Parameter]]:
    return [(n, p) for n, p in module.named_parameters() if p.requires_grad]


def _grads(loss: torch.Tensor, named: list, group=None) -> list[torch.Tensor]:
    """d loss / d parameters; with a ``group``, their mean over the ranks."""
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
    return grads if group is None else _dp.all_reduce_mean(grads, group)


def make_gan_train_step(generator: nn.Module, discriminator: nn.Module, vgg: VGG16Features,
                        g_opt: torch.optim.Optimizer, d_opt: torch.optim.Optimizer,
                        lambda_g: float = 0.01, gan_mode: str = "lsgan", group=None):
    """``step(batch, eps_q=None, eps_p=None, noise=None, return_grads=False)
    -> metrics``: one G update and one D update, in place on the modules and
    optimizers. Metrics are detached scalar tensors (``D_loss``, ``G_loss``,
    ``perc_loss``, ``style_loss``, ``cx_loss``, ``l1_loss``, ``adv_loss``);
    ``return_grads`` adds ``g_grads``/``d_grads``, name -> gradient. With a
    ``group`` the batch (and any ``eps_q``/``eps_p``) is this rank's slice
    of the global batch."""
    g_named, d_named = _trainable(generator), _trainable(discriminator)

    def step(batch: dict, eps_q=None, eps_p=None, noise=None, return_grads: bool = False):
        with _dp.data_parallel(group):
            return _step(batch, eps_q, eps_p, noise, return_grads)

    def _step(batch: dict, eps_q, eps_p, noise, return_grads: bool):
        generator.train()
        discriminator.train()
        # ---- generator update (D constant: only G's parameters get grads)
        g_total, aux = gan_losses(generator, discriminator, vgg, batch, eps_q, eps_p, noise,
                                  lambda_g, gan_mode)
        g_grads = _grads(g_total, g_named, group)
        for (_, p), g in zip(g_named, g_grads):
            p.grad = g
        g_opt.step()
        g_opt.zero_grad(set_to_none=True)
        gen = aux["gen"].detach()
        # ---- discriminator update on the stop-gradiented fake
        d_real = _apply_d(discriminator, batch["gt_img"], gen.dtype)
        d_fake = _apply_d(discriminator, gen, gen.dtype)
        d_loss = 0.5 * (gan_loss(d_real, True, True, gan_mode)
                        + gan_loss(d_fake, False, True, gan_mode))
        d_grads = _grads(d_loss, d_named, group)
        for (_, p), g in zip(d_named, d_grads):
            p.grad = g
        d_opt.step()
        d_opt.zero_grad(set_to_none=True)
        metrics = {"D_loss": d_loss.detach(), "G_loss": g_total.detach(),
                   "perc_loss": aux["perc_loss"].detach(),
                   "style_loss": aux["style_loss"].detach(),
                   "cx_loss": aux["cx_loss"].detach(), "l1_loss": aux["loss_l1_g"].detach(),
                   "adv_loss": aux["loss_ad_g"].detach()}
        if group is not None:
            metrics = _dp.mean_over_ranks(metrics, group)
        if return_grads:
            metrics["g_grads"] = {n: g for (n, _), g in zip(g_named, g_grads)}
            metrics["d_grads"] = {n: g for (n, _), g in zip(d_named, d_grads)}
        return metrics

    return step


def make_gan_eval_step(generator: nn.Module, discriminator: nn.Module, vgg: VGG16Features,
                       lambda_g: float = 0.01, gan_mode: str = "lsgan"):
    """``step(batch, eps_q=None, eps_p=None, noise=None) -> {D_loss, G_loss,
    gen}``: the losses without updates (loss.py:136-144), in eval mode under
    ``torch.no_grad()``; the modules return to training mode after it."""

    @torch.no_grad()
    def step(batch: dict, eps_q=None, eps_p=None, noise=None):
        modes = generator.training, discriminator.training
        generator.eval()
        discriminator.eval()
        try:
            g_total, aux = gan_losses(generator, discriminator, vgg, batch, eps_q, eps_p,
                                      noise, lambda_g, gan_mode)
            gen = aux["gen"]
            d_real = _apply_d(discriminator, batch["gt_img"], gen.dtype)
            d_fake = _apply_d(discriminator, gen, gen.dtype)
            d_loss = 0.5 * (gan_loss(d_real, True, True, gan_mode)
                            + gan_loss(d_fake, False, True, gan_mode))
        finally:
            generator.train(modes[0])
            discriminator.train(modes[1])
        return {"D_loss": d_loss, "G_loss": g_total, "gen": gen}

    return step
