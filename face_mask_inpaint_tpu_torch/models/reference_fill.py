"""ReferenceFill, the composite inpainting generator (Stack A).

Port of face_mask_inpaint_tpu/models/reference_fill.py: two encoders, fused
by ExampleGuidedAttention (or a mask lerp), the ResGenerator, and an adaptive
average pool to ``out_size``. The encoders are pluralistic ResEncoders, whose
distributions give the latent z the decoder adds to the fused features, or
(``encoder_params["type"] == "drn"``) two DRN-C-42 trunks with a 1x1 head to
``img_f`` channels, which give no distribution: the decoder is then built
without its latent branch and decodes the features alone.

``no_prior`` is the old-model path of ``PICNet_inference.py --old_model 1``:
the decoder runs without z (the latent branch's weights stay in the module,
unused, as the JAX CLI initialises them), no pool is folded into its head,
and the image is resized bilinearly (align_corners=True) to 218x178.

When the decoded size is an integer multiple of ``out_size``, equal on both
axes, the decoder folds the final pool into its Output head (``fuse_pool``,
as the JAX model does): the head takes the last decoder's pre-add pair and
returns the pooled image through kernel K3, so the full-resolution image is
never written. The adaptive pool after it is then the identity.

``decoder_params`` go to ``define_g`` as they are, ``pack_threshold`` and
``packed_convt`` included. With ``packed_convt`` the last decoder block runs
its fused tail (kernels K4b and K4a) and hands the head a pre-activated map
instead of a pair, as the JAX model does under ``FMI_PACKED_CONVT=1``; the
head then runs at full size and the adaptive pool after it does the pooling.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from face_mask_inpaint_tpu_torch.models.drn import drn_c_42
from face_mask_inpaint_tpu_torch.models.picnet import define_e, define_g, sample_z
from face_mask_inpaint_tpu_torch.nn.blocks import ExampleGuidedAttention
from face_mask_inpaint_tpu_torch.nn.layers import init_weights
from face_mask_inpaint_tpu_torch.ops.resize import adaptive_avg_pool2d, scale_img
from face_mask_inpaint_tpu_torch.utils.profiling import span, spanned

__all__ = ["ReferenceFill"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class ReferenceFill(nn.Module):
    """Composite generator (modules/model.py:15-113).

    encoder_params / decoder_params are the reference dicts built by
    ``process_params``; only the keys the architecture uses are read. The
    model is built in eval mode with weights drawn from ``generator``.
    """

    def __init__(self, encoder_params: dict, decoder_params: dict, use_att: bool = True,
                 out_size: tuple[int, int] = (256, 256), dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        enc_p = dict(encoder_params)
        encoder_type = enc_p.pop("type", "pluralistic")
        self.encoder_type = encoder_type
        self.use_att, self.out_size, self.dtype = use_att, tuple(out_size), dtype
        if encoder_type == "drn":
            self.src_encoder = drn_c_42(head_features=enc_p.get("img_f", 128))
            self.ref_encoder = drn_c_42(head_features=enc_p.get("img_f", 128))
            z_channels = None
        elif encoder_type == "pluralistic":
            self.src_encoder = define_e(**enc_p, encoder_type="src")
            self.ref_encoder = define_e(**enc_p, encoder_type="ref")
            z_nc = enc_p.get("z_nc", 512)
            z_channels = 2 * z_nc if use_att else z_nc
        else:
            raise NotImplementedError(f"encoder_type [{encoder_type}]")
        c = self.src_encoder.out_channels
        if use_att:
            self.attention = ExampleGuidedAttention(
                c, init_type=enc_p.get("init_type", "orthogonal"))
        self.decoder = define_g(**decoder_params, input_nc=2 * c if use_att else c,
                                z_channels=z_channels)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.eval()

    def _fuse_pool(self, enc: torch.Tensor) -> Optional[int]:
        """h_dec // out_h when the decoded size divides by out_size with one
        factor on both axes (JAX models/reference_fill.py:100-109)."""
        scale = 2 ** self.decoder.layers
        h_dec, w_dec = enc.shape[2] * scale, enc.shape[3] * scale
        out_h, out_w = self.out_size
        if h_dec % out_h == 0 and w_dec % out_w == 0 and h_dec // out_h == w_dec // out_w:
            return h_dec // out_h
        return None

    def _encode(self, encoder: nn.Module, image: torch.Tensor):
        """One encoder's pass: (its distribution, or None for DRN, and its
        features)."""
        with span("encoder"):
            out = encoder(image)
        return (None, out) if self.encoder_type == "drn" else out

    @spanned("generator")
    def forward(self, src_image: torch.Tensor, ref_image: torch.Tensor,
                src_mask: torch.Tensor, eps_q: Optional[torch.Tensor] = None,
                eps_p: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                resize: bool = True, no_prior: bool = False) -> torch.Tensor:
        """src/ref_image: [N, H, W, 3]; src_mask: [N, H, W] in [0, 1].

        The latent noise is ``eps_q``/``eps_p`` (NHWC, shaped like the
        encoders' mu: [N, H/8, W/8, z_nc] at five encoder layers) or is drawn
        from ``generator``; the DRN encoder and ``no_prior`` draw none.
        Returns [N, out_h, out_w, 3] in [-1, 1], or [N, 218, 178, 3] with
        ``no_prior``.
        """
        src = _nchw(src_image).to(self.dtype)
        ref = _nchw(ref_image).to(self.dtype)
        src_dist, src_features = self._encode(self.src_encoder, src)
        ref_dist, ref_features = self._encode(self.ref_encoder, ref)
        with span("fusion"):
            scaled_mask = scale_img(src_mask[:, None].to(src_features.dtype),
                                    src_features.shape[2:])
            if self.use_att:
                enc = self.attention(scaled_mask, src_features, ref_features)
            else:
                enc = (1.0 - scaled_mask) * src_features + scaled_mask * ref_features
        fuse_pool = self._fuse_pool(enc) if resize and not no_prior else None
        z = None
        if src_dist is not None and not no_prior:
            z = sample_z(src_dist, ref_dist,
                         _nchw(eps_q) if eps_q is not None else None,
                         _nchw(eps_p) if eps_p is not None else None,
                         generator, return_zq=not self.use_att)
        with span("decoder"):
            dec = self.decoder(enc, z=z, fuse_pool=fuse_pool)
        if resize and no_prior:
            dec = scale_img(dec, (218, 178))
        elif resize:  # the identity when the decoder already pooled
            dec = adaptive_avg_pool2d(dec, self.out_size)
        return dec.permute(0, 2, 3, 1)
