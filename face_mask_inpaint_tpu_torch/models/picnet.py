"""PICNet pluralistic encoder and generator, over NCHW tensors.

Port of face_mask_inpaint_tpu/models/picnet.py (``ResEncoder``, ``sample_z``,
``ResGenerator``, ``ResDiscriminator``, ``PatchDiscriminator``, ``define_e``,
``define_g``, ``define_d``). Input channel counts, which flax infers from the
data, are explicit: the generator takes ``input_nc`` (the fused encoder
features) and ``z_channels`` (the sampled latent), and checks that
``encoded + f`` adds tensors of one width (picnet.py:215); the
discriminators take ``input_nc``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.nn.blocks import (
    AutoAttention, CoordConvWrap, Output, ResBlock, ResBlockDecoder,
    ResBlockEncoderOptimized)
from face_mask_inpaint_tpu_torch.nn.layers import Activation, Conv2d
from face_mask_inpaint_tpu_torch.parallel import dist as _dp

__all__ = ["ResEncoder", "ResGenerator", "ResDiscriminator", "PatchDiscriminator",
           "sample_z", "define_e", "define_g", "define_d"]


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
    given (``eps_q``/``eps_p``, NCHW like mu) or drawn from ``generator``;
    inside a data-parallel train step, at the global batch's shape, this
    rank keeping its slice (``parallel.dist.randn_batch``)."""
    q_mu, q_sigma = src_distribution
    p_mu, p_sigma = ref_distribution

    def noise(eps, like):
        if eps is None:
            return _dp.randn_batch(like.shape, _dp.active(), generator=generator,
                                   device=like.device, dtype=like.dtype)
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
    decoder 1 ending such a run (JAX picnet.py:227-237, :280-288).

    The K3 pair and the fused tail run in eval mode only: their kernels have
    no backward, and the JAX generator takes both only when ``not train``
    (``use_packed_output_kernel(train)``, ``use_packed_convt_kernel(train)``).
    In training mode every block runs its dense, differentiable path. Under
    ``use_coord`` no block packs, so neither runs (JAX picnet.py:224, :261).

    ``attn_pre_channels`` gives the attention after decoder 1 its long-term
    branch (``AutoAttention``'s ``pre``, with a ResBlock of this module's
    norm); ``forward`` then takes ``f_e`` and ``mask`` and hands them to it,
    as the JAX generator does (picnet.py:187-188, :289-292). No CLI feeds
    them."""

    def __init__(self, input_nc: int, z_channels: Optional[int] = None,
                 output_nc: int = 3, ngf: int = 64, z_nc: int = 512,
                 img_f: int = 512, L: int = 1, layers: int = 5,
                 norm: str = "instance", activation: str = "ReLU",
                 use_spect: bool = True, use_coord: bool = False,
                 use_attn: bool = True, init_type: str = "orthogonal",
                 pack_threshold: int = 256, packed_convt: bool = False,
                 attn_pre_channels: Optional[int] = None):
        super().__init__()
        del z_nc  # the latent width comes from the encoders (z_channels)
        kw = dict(activation=activation, use_spect=use_spect, init_type=init_type)
        self.layers, self.L, self.use_attn = layers, L, use_attn
        self.norm, self.pack_threshold, self.packed_convt = norm, pack_threshold, packed_convt
        self.use_coord = use_coord
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
                self.add_module(f"attn{i}", AutoAttention(
                    ch, attn_pre_channels, norm=norm, init_type=init_type))
        self.add_module(f"out{layers - 1}", Output(
            in_c, output_nc, 3, norm="none", use_coord=use_coord, **kw))

    def forward(self, encoded: torch.Tensor, z: Optional[torch.Tensor] = None,
                f_e: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                fuse_pool: Optional[int] = None) -> torch.Tensor:
        """f_e [N, attn_pre_channels, H, W] and mask [N, 1, H, W], at the
        attention's resolution (decoder 1's output), feed its ``pre`` branch.
        fuse_pool: an integer factor of the caller's average pool. In eval
        mode the last decoder then hands the Output head its (h, bypass)
        pair, and the head returns the pooled image through kernel K3 (JAX
        picnet.py:243-262, without the packing conditions). When the last
        decoder runs its fused tail instead, it hands the head one
        pre-activated map, as in JAX; the head then works at full size and
        leaves the pool to the caller, as it does in training mode."""
        out = encoded
        if z is not None:
            f = self.generator(z)
            for i in range(self.L):
                f = getattr(self, f"generator{i}")(f)
            out = encoded + f
        last = self.layers - 1
        head = getattr(self, f"out{last}")
        pair = (not self.training and isinstance(fuse_pool, int) and head.pair_ok()
                and not (last == 1 and self.use_attn))
        packable = self.norm in ("instance", "none") and not self.use_coord
        r, stats, pre_activated = 1, None, False  # r: the JAX space-to-depth factor
        for i in range(self.layers):
            dec = getattr(self, f"decoder{i}")
            pack_out = r > 1 or (packable and 2 * min(out.shape[2:]) > self.pack_threshold)
            if self.packed_convt and not self.training and pack_out and dec.fused_ok():
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
                out = getattr(self, f"attn{i}")(out, f_e, mask)
        return head(out, pre_activated=pre_activated)


class ResDiscriminator(nn.Module):
    """ResNet discriminator (network.py:310-370): a stem, ``layers - 1``
    downsampling ResBlocks with self-attention before the one at i == 2, a
    ResBlock, the activation and a spectral-norm 3x3 valid conv to one
    channel. The attention sees (H/8)^2 tokens, 1,024 at 256^2: under
    ``block_threshold``, so its map is materialized and runs no kernel."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, img_f: int = 512,
                 layers: int = 6, norm: str = "none", activation: str = "LeakyReLU",
                 use_spect: bool = True, use_coord: bool = False, use_attn: bool = True,
                 init_type: str = "orthogonal"):
        super().__init__()
        kw = dict(norm=norm, activation=activation, use_spect=use_spect,
                  use_coord=use_coord, init_type=init_type)
        self.layers, self.use_attn = layers, use_attn
        self.block0 = ResBlockEncoderOptimized(input_nc, ndf, **kw)
        mult = 1
        for i in range(layers - 1):
            mult_prev = mult
            mult = min(2 ** (i + 1), img_f // ndf)
            if i == 2 and use_attn:
                self.add_module(f"attn{i}", AutoAttention(ndf * mult_prev,
                                                          init_type=init_type))
            self.add_module(f"encoder{i}", ResBlock(
                ndf * mult_prev, ndf * mult, ndf * mult_prev, sample_type="down", **kw))
        self.block1 = ResBlock(ndf * mult, ndf * mult, ndf * mult, sample_type="none", **kw)
        self.act = Activation(activation)
        self.conv = Conv2d(ndf * mult, 1, 3, padding=0, use_spect=True, init_type=init_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, input_nc, H, W] -> [N, 1, H/2^layers - 2, W/2^layers - 2]."""
        out = self.block0(x)
        for i in range(self.layers - 1):
            if i == 2 and self.use_attn:
                out = getattr(self, f"attn{i}")(out)
            out = getattr(self, f"encoder{i}")(out)
        return self.conv(self.act(self.block1(out)))


class PatchDiscriminator(nn.Module):
    """70x70 PatchGAN discriminator (network.py:373-430): 4x4 convs without
    bias, stride 2 then 1, each followed by the activation but the last. The
    reference builds a norm but never applies it, and so does this port."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, img_f: int = 512,
                 layers: int = 3, norm: str = "batch", activation: str = "LeakyReLU",
                 use_spect: bool = True, use_coord: bool = False, use_attn: bool = False,
                 init_type: str = "orthogonal"):
        super().__init__()
        del norm, use_attn  # unused by the reference's forward
        self.layers = layers
        self.act = Activation(activation)

        def cc(cin, cout, stride):
            return CoordConvWrap(cin, cout, 4, stride, 1, bias=False, use_spect=use_spect,
                                 use_coord=use_coord, init_type=init_type)

        self.conv0 = cc(input_nc, ndf, 2)
        mult = 1
        for i in range(1, layers):
            mult_prev, mult = mult, min(2 ** i, img_f // ndf)
            self.add_module(f"conv{i}", cc(ndf * mult_prev, ndf * mult, 2))
        self.conv_pre = cc(ndf * mult, ndf * mult, 1)
        self.conv_out = cc(ndf * mult, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.conv0(x))
        for i in range(1, self.layers):
            out = self.act(getattr(self, f"conv{i}")(out))
        return self.conv_out(self.act(self.conv_pre(out)))


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
             packed_convt: bool = False, attn_pre_channels: Optional[int] = None,
             **_unused) -> ResGenerator:
    return ResGenerator(input_nc, z_channels, output_nc, ngf, z_nc, img_f, L, layers,
                        norm, activation, use_spect, use_coord, use_attn, init_type,
                        pack_threshold, packed_convt, attn_pre_channels)


def define_d(input_nc: int = 3, ndf: int = 64, img_f: int = 512, layers: int = 6,
             norm: str = "none", activation: str = "LeakyReLU", use_spect: bool = True,
             use_coord: bool = False, use_attn: bool = True, model_type: str = "ResDis",
             init_type: str = "orthogonal", **_unused) -> nn.Module:
    if model_type == "ResDis":
        return ResDiscriminator(input_nc, ndf, img_f, layers, norm, activation, use_spect,
                                use_coord, use_attn, init_type)
    if model_type == "PatchDis":
        return PatchDiscriminator(input_nc, ndf, img_f, layers, norm, activation, use_spect,
                                  use_coord, use_attn, init_type)
    raise NotImplementedError(f"model_type [{model_type}]")
