"""PICNet pluralistic encoder and generator, over NCHW tensors.

Port of face_mask_inpaint_tpu/models/picnet.py (``ResEncoder``, ``sample_z``,
``ResGenerator``, ``define_e``, ``define_g``; the discriminators wait for the
training slice). Input channel counts, which flax infers from the data, are
explicit: the generator takes ``input_nc`` (the fused encoder features) and
``z_channels`` (the sampled latent), and checks that ``encoded + f`` adds
tensors of one width (picnet.py:215).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.nn.blocks import (
    AutoAttention, Output, ResBlock, ResBlockDecoder, ResBlockEncoderOptimized)

__all__ = ["ResEncoder", "ResGenerator", "sample_z", "define_e", "define_g"]


class ResEncoder(nn.Module):
    """ResNet encoder (network.py:76-178). Returns ((mu, std), features), std
    through softplus; 'src' runs L infer_prior blocks and the prior head,
    'ref' the posterior head."""

    def __init__(self, input_nc: int = 3, ngf: int = 64, z_nc: int = 512,
                 img_f: int = 512, L: int = 6, layers: int = 5, norm: str = "none",
                 activation: str = "ReLU", use_spect: bool = True,
                 use_coord: bool = False, encoder_type: str = "src",
                 init_type: str = "orthogonal"):
        super().__init__()
        if encoder_type not in ("src", "ref"):
            raise NotImplementedError(f"encoder_type [{encoder_type}]")
        kw = dict(norm=norm, activation=activation, use_spect=use_spect,
                  use_coord=use_coord, init_type=init_type)
        self.encoder_type, self.layers, self.L = encoder_type, layers, L
        self.block0 = ResBlockEncoderOptimized(input_nc, ngf, **kw)
        mult = 1
        for i in range(layers - 1):
            mult_prev = mult
            mult = min(2 ** (i + 1), img_f // ngf)
            self.add_module(f"encoder{i}", ResBlock(
                ngf * mult_prev, ngf * mult, ngf * mult_prev,
                sample_type="none" if i % 2 == 0 else "down", **kw))
        ch = ngf * mult
        self.out_channels = ch
        if encoder_type == "src":
            for i in range(L):
                self.add_module(f"infer_prior{i}", ResBlock(ch, ch, ch, **kw))
            self.prior = ResBlock(ch, 2 * z_nc, ch, **kw)
        else:
            self.posterior = ResBlock(ch, 2 * z_nc, ch, **kw)

    def forward(self, img: torch.Tensor):
        out = self.block0(img)
        for i in range(self.layers - 1):
            out = getattr(self, f"encoder{i}")(out)
        if self.encoder_type == "src":
            h = out
            for i in range(self.L):
                h = getattr(self, f"infer_prior{i}")(h)
            o = self.prior(h)
        else:
            o = self.posterior(out)
        mu, std = torch.chunk(o, 2, dim=1)
        return (mu, F.softplus(std)), out


def sample_z(src_distribution, ref_distribution, eps_q: Optional[torch.Tensor] = None,
             eps_p: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             return_zq: bool = False) -> torch.Tensor:
    """Reparameterized sample (network.py:275-307): z = concat([z_q, z_p]) on
    channels with z_q = mu_q + sigma_q * eps_q, z_p likewise. The noise is
    given (``eps_q``/``eps_p``, NCHW like mu) or drawn from ``generator``."""
    q_mu, q_sigma = src_distribution
    p_mu, p_sigma = ref_distribution

    def noise(eps, like):
        if eps is None:
            return torch.randn(like.shape, generator=generator, device=like.device,
                               dtype=like.dtype)
        return eps.to(like.dtype)

    z_q = q_mu + q_sigma * noise(eps_q, q_mu)
    if return_zq:
        return z_q
    z_p = p_mu + p_sigma * noise(eps_p, p_mu)
    return torch.cat([z_q, z_p], dim=1)


class ResGenerator(nn.Module):
    """ResNet generator (network.py:181-273): z feeds a ResBlock chain added
    to the encoder features; ``layers`` ResBlockDecoders upsample x2 each;
    self-attention after decoder1; a tanh Output head on the last layer,
    which folds in the caller's pool when given one (``fuse_pool``).

    ``packed_convt`` is the port of the JAX generator under
    ``FMI_PACKED_CONVT=1``: the decoder blocks the JAX package packs run as
    their fused tail, kernels K4b and K4a, with instance-norm statistics
    handed from block to block. A block packs when its output side exceeds
    ``pack_threshold`` or the block before it packed, the attention after
    decoder 1 ending such a run (JAX picnet.py:227-237, :280-288)."""

    def __init__(self, input_nc: int, z_channels: Optional[int] = None,
                 output_nc: int = 3, ngf: int = 64, z_nc: int = 512,
                 img_f: int = 512, L: int = 1, layers: int = 5,
                 norm: str = "instance", activation: str = "ReLU",
                 use_spect: bool = True, use_coord: bool = False,
                 use_attn: bool = True, init_type: str = "orthogonal",
                 pack_threshold: int = 256, packed_convt: bool = False):
        super().__init__()
        del z_nc  # the latent width comes from the encoders (z_channels)
        kw = dict(activation=activation, use_spect=use_spect, init_type=init_type)
        self.layers, self.L, self.use_attn = layers, L, use_attn
        self.norm, self.pack_threshold, self.packed_convt = norm, pack_threshold, packed_convt
        ch = ngf * min(2 ** (layers - 1), img_f // ngf)
        if z_channels is not None:
            if input_nc != ch:
                raise ValueError(
                    f"encoded features have {input_nc} channels but the latent "
                    f"branch gives {ch} (ngf * min(2**(layers-1), img_f // ngf)); "
                    "with use_att the decoder img_f must match 2 x encoder img_f")
            self.generator = ResBlock(z_channels, ch, ch, norm="none",
                                      use_coord=use_coord, **kw)
            for i in range(L):
                self.add_module(f"generator{i}", ResBlock(
                    ch, ch, ch, norm="none", use_coord=use_coord, **kw))
        in_c = input_nc
        for i in range(layers):
            ch = ngf * min(2 ** (layers - i - 1), img_f // ngf)
            self.add_module(f"decoder{i}", ResBlockDecoder(in_c, ch, ch, norm=norm, **kw))
            in_c = ch
            if i == 1 and use_attn:
                self.add_module(f"attn{i}", AutoAttention(ch, init_type=init_type))
        self.add_module(f"out{layers - 1}", Output(
            in_c, output_nc, 3, norm="none", use_coord=use_coord, **kw))

    def forward(self, encoded: torch.Tensor, z: Optional[torch.Tensor] = None,
                fuse_pool: Optional[int] = None) -> torch.Tensor:
        """fuse_pool: an integer factor of the caller's average pool. The
        last decoder then hands the Output head its (h, bypass) pair, and the
        head returns the pooled image through kernel K3 (JAX picnet.py:243-262,
        without the packing conditions). When the last decoder runs its fused
        tail instead, it hands the head one pre-activated map, as in JAX; the
        head then works at full size and leaves the pool to the caller."""
        out = encoded
        if z is not None:
            f = self.generator(z)
            for i in range(self.L):
                f = getattr(self, f"generator{i}")(f)
            out = encoded + f
        last = self.layers - 1
        head = getattr(self, f"out{last}")
        pair = (isinstance(fuse_pool, int) and head.pair_ok()
                and not (last == 1 and self.use_attn))
        packable = self.norm in ("instance", "none")
        r, stats, pre_activated = 1, None, False  # r: the JAX space-to-depth factor
        for i in range(self.layers):
            dec = getattr(self, f"decoder{i}")
            pack_out = r > 1 or (packable and 2 * min(out.shape[2:]) > self.pack_threshold)
            if self.packed_convt and pack_out and dec.fused_ok():
                # the Output head's leading activation, unless the attention
                # (i == 1) still reads the raw map (JAX picnet.py:243-249)
                fuse_act = (dec.activation if i == last and not (i == 1 and self.use_attn)
                            else None)
                want_stats = i < last and self.norm == "instance"
                res = dec(out, fused=True, in_stats=stats, want_stats=want_stats,
                          fuse_act=fuse_act)
                out, stats = res if want_stats else (res, None)
                pre_activated = fuse_act is not None
            elif i == last and pair:
                return head(dec(out, return_pair=True), pool=fuse_pool)
            else:
                out, stats = dec(out), None
            if pack_out:
                r *= 2
            if i == 1 and self.use_attn:
                r, stats = 1, None  # the attention rewrites the map: stale stats
                out = getattr(self, f"attn{i}")(out)
        return head(out, pre_activated=pre_activated)


def define_e(encoder_type: str = "src", input_nc: int = 3, ngf: int = 64,
             z_nc: int = 512, img_f: int = 512, L: int = 6, layers: int = 5,
             norm: str = "none", activation: str = "ReLU", use_spect: bool = True,
             use_coord: bool = False, init_type: str = "orthogonal",
             **_unused) -> ResEncoder:
    return ResEncoder(input_nc, ngf, z_nc, img_f, L, layers, norm, activation,
                      use_spect, use_coord, encoder_type, init_type)


def define_g(input_nc: int, z_channels: Optional[int] = None, output_nc: int = 3,
             ngf: int = 64, z_nc: int = 512, img_f: int = 512, L: int = 1,
             layers: int = 5, norm: str = "instance", activation: str = "ReLU",
             use_spect: bool = True, use_coord: bool = False, use_attn: bool = True,
             init_type: str = "orthogonal", pack_threshold: int = 256,
             packed_convt: bool = False, **_unused) -> ResGenerator:
    return ResGenerator(input_nc, z_channels, output_nc, ngf, z_nc, img_f, L, layers,
                        norm, activation, use_spect, use_coord, use_attn, init_type,
                        pack_threshold, packed_convt)
