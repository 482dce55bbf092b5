"""pSp, the Stack B composite (encoder -> StyleGAN2), over NCHW inside.

Port of face_mask_inpaint_tpu/models/psp.py (reference modules/psp/psp.py):
an IR-SE encoder maps the image (and, for the GradualStyleEncoder, a
reference image and mask) to n_styles = 2 log2(output_size) - 2 w vectors,
optionally offset by the average latent; the StyleGAN2 generator decodes them
with optional latent-mask style mixing; the image is adaptive-average pooled
to 256^2. The public entry points take NHWC images and [N, H, W] masks and
return NHWC images, as the JAX package's do.

``latent_avg`` is a buffer ([1 or n_styles, 512]), zero until loaded or
set from ``compute_latent_avg``. Weights are drawn from ``generator`` at
construction, with the JAX initialisers' distributions; ``init=False``
leaves them unset, for a state_dict that is loaded next. ``train()`` and
``eval()`` select the encoder's BatchNorm mode, as the JAX ``train``
argument does; the decoder has no mode-dependent layer.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from face_mask_inpaint_tpu_torch.models.irse import (
    BackboneEncoderUsingLastLayerIntoW, BackboneEncoderUsingLastLayerIntoWPlus,
    GradualStyleEncoder)
from face_mask_inpaint_tpu_torch.models.stylegan2 import Generator
from face_mask_inpaint_tpu_torch.nn.layers import init_weights
from face_mask_inpaint_tpu_torch.ops.resize import adaptive_avg_pool2d

__all__ = ["PSP"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class PSP(nn.Module):
    """Encoder + StyleGAN2 decoder (psp.py:21-130).

    ``num_layers`` 4 and ``decoder_base_channels`` below 512 are the JAX
    package's small test configurations; the reference is 50 and 512.
    """

    def __init__(self, encoder_type: str = "GradualStyleEncoder", output_size: int = 1024,
                 start_from_latent_avg: bool = False, learn_in_w: bool = False,
                 use_attention: bool = False, num_layers: int = 50,
                 decoder_base_channels: int = 512, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, init: bool = True):
        super().__init__()
        self.output_size, self.dtype = output_size, dtype
        self.start_from_latent_avg, self.learn_in_w = start_from_latent_avg, learn_in_w
        self.n_styles = int(math.log2(output_size)) * 2 - 2
        if encoder_type == "GradualStyleEncoder":
            self.encoder = GradualStyleEncoder(num_layers, "ir_se", self.n_styles,
                                               use_attention=use_attention)
        elif encoder_type == "BackboneEncoderUsingLastLayerIntoW":
            self.encoder = BackboneEncoderUsingLastLayerIntoW(num_layers, "ir_se")
        elif encoder_type == "BackboneEncoderUsingLastLayerIntoWPlus":
            self.encoder = BackboneEncoderUsingLastLayerIntoWPlus(num_layers, "ir_se",
                                                                  self.n_styles)
        else:
            raise ValueError(f"{encoder_type} is not a valid encoders")
        self.decoder = Generator(output_size, 512, 8, base_channels=decoder_base_channels,
                                 dtype=dtype)
        self.register_buffer("latent_avg",
                             torch.zeros(1 if learn_in_w else self.n_styles, 512))
        if init:
            init_weights(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def compute_latent_avg(self, n_latent: int = 100_000,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """decoder.mean_latent repeated to [1 or n_styles, 512]
        (psp.py:206-210, train_psp.py:133-134); the caller stores it in
        ``latent_avg``."""
        avg = self.decoder.mean_latent(n_latent, generator)
        return avg.float().repeat(self.latent_avg.shape[0], 1)

    def _add_latent_avg(self, codes: torch.Tensor) -> torch.Tensor:
        if not self.start_from_latent_avg:
            return codes
        avg = self.latent_avg.to(codes.dtype)
        return codes + (avg[0][None, :] if self.learn_in_w else avg[None])

    def encode(self, x: torch.Tensor, ref: Optional[torch.Tensor] = None,
               src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder half: NHWC image(s) -> w+ codes [N, n_styles, 512] (or
        [N, 512] with learn_in_w), plus the latent_avg offset."""
        x = _nchw(x).to(self.dtype)
        ref = _nchw(ref).to(self.dtype) if ref is not None else None
        return self._add_latent_avg(self.encoder(x, ref=ref, mask=src_mask))

    def decode(self, codes: torch.Tensor, resize: bool = True, randomize_noise: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decoder half: w+ codes -> NHWC image, pooled to 256^2 when resize."""
        images, _ = self.decoder([codes], input_is_latent=True,
                                 randomize_noise=randomize_noise, generator=generator)
        if resize:
            images = adaptive_avg_pool2d(images, (256, 256))
        return images.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, ref: Optional[torch.Tensor] = None,
                src_mask: Optional[torch.Tensor] = None, resize: bool = True,
                latent_mask: Optional[Sequence[int]] = None, input_code: bool = False,
                randomize_noise: bool = True, inject_latent: Optional[torch.Tensor] = None,
                return_latents: bool = False, alpha: Optional[float] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC image [N, H, W, 3] (or codes with input_code); ref: NHWC
        reference; src_mask: [N, H, W]. Returns the NHWC image, and the
        latent with return_latents. Randomized noise comes from
        ``generator``."""
        if input_code:
            codes = x
        else:
            codes = self.encode(x, ref, src_mask)
        if latent_mask is not None:
            codes = codes.clone()
            for i in latent_mask:
                if inject_latent is None:
                    codes[:, i] = 0
                elif alpha is not None:
                    codes[:, i] = alpha * inject_latent[:, i] + (1 - alpha) * codes[:, i]
                else:
                    codes[:, i] = inject_latent[:, i]
        images, latent = self.decoder([codes], input_is_latent=not input_code,
                                      randomize_noise=randomize_noise,
                                      return_latents=return_latents, generator=generator)
        if resize:
            images = adaptive_avg_pool2d(images, (256, 256))
        images = images.permute(0, 2, 3, 1)
        return (images, latent) if return_latents else images
