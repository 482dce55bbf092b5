"""StyleGAN2 generator (synthesis network and style MLP) and discriminator,
over NCHW.

Port of face_mask_inpaint_tpu/models/stylegan2.py (dense execution; the
packed space-to-depth execution of the JAX package computes the same
function and is not ported). The submodules carry the flax names
(``style_1``, ``conv1``, ``to_rgb1``, ``convs_<i>``, ``to_rgbs_<i>``, the
buffers ``noise_<i>``), so convert.py maps the JAX variables by path.

ModulatedConv2d runs in the JAX package's input/output-scaling form:
``conv(x * s, scale * W) * demod``, one convolution with shared weights for
the whole batch, with the style scale s and the demodulation applied
elementwise. The rounding points follow the JAX package: x * s and
scale * W in x's dtype, the f32 demodulation applied to the conv output in
its dtype, the noise added in the image dtype.

Kernels on this path: every StyledConv's bias + LeakyReLU is K7a
(ops/fused_act.py), and the blur after each upsampling convolution and
every ToRGB skip upsample are K6 (ops/upfirdn2d.py). At size 1024 one
forward makes 17 K7a and 16 K6 calls; its backward makes 17 K7b calls and
16 more K6 calls (the gradients of the blurs and skip upsamples).

The discriminator (``ConvLayer``, ``DResBlock``, ``Discriminator``; JAX
``models/stylegan2.py:623-716``) blurs through K6 in mode (1, 1) before
each stride-2 convolution, pads (2, 2) before a 3x3 and (1, 1) before a 1x1
skip, and runs K7a after every activated ConvLayer and ``final_linear1``
(on [N, C] rows). At size 1024 one forward makes 16 K6 and 19 K7a calls.

Weights are drawn from a ``torch.Generator`` with the distributions of the
JAX initialisers: EqualLinear N(0, 1) / lr_mul with its bias_init (1 for the
modulation), the conv weights and the input constant N(0, 1), the noise
weights and biases 0, the fixed noise buffers N(0, 1).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from face_mask_inpaint_tpu_torch.ops.upfirdn2d import blur, make_taps, upsample_2d
from face_mask_inpaint_tpu_torch.parallel import dist as _dp

__all__ = ["channels_for", "PixelNorm", "EqualLinear", "EqualConv2d", "ModulatedConv2d",
           "NoiseInjection", "StyledConv", "ToRGB", "Generator", "ConvLayer", "DResBlock",
           "Discriminator"]

BLUR_KERNEL = (1, 3, 3, 1)


def channels_for(size: int, channel_multiplier: int = 2,
                 base_channels: int = 512) -> dict[int, int]:
    """Per-resolution channel table (model.py:398-408); ``base_channels``
    scales every entry, as the JAX package's small test configurations do."""
    scale = base_channels / 512
    return {
        4: int(512 * scale), 8: int(512 * scale),
        16: int(512 * scale), 32: int(512 * scale),
        64: int(256 * channel_multiplier * scale),
        128: int(128 * channel_multiplier * scale),
        256: int(64 * channel_multiplier * scale),
        512: int(32 * channel_multiplier * scale),
        1024: int(16 * channel_multiplier * scale),
    }


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """Equalized-lr linear (model.py:135-171): weight [out, in] stored
    N(0, 1) / lr_mul, used scaled by lr_mul / sqrt(in); bias scaled by
    lr_mul; ``activation='fused_lrelu'`` applies fused_leaky_relu."""

    def __init__(self, in_dim: int, out_dim: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: Optional[str] = None):
        super().__init__()
        self.lr_mul, self.bias_init, self.activation = lr_mul, bias_init, activation
        self.scale = lr_mul / math.sqrt(in_dim)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / self.lr_mul, generator=generator)
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, (self.weight * self.scale).to(x.dtype))
        b = (self.bias * self.lr_mul).to(y.dtype)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(y, b)
        return y + b


class EqualConv2d(nn.Module):
    """Equalized-lr conv (model.py:94-132): OIHW weight N(0, 1), used scaled
    by 1 / sqrt(in * k^2)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(out_channel, in_channel, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channel)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv2d(x, (self.weight * self.scale).to(x.dtype), b, self.stride,
                        self.padding)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv (model.py:187-279) in the input/output-scaling
    form, the generator's: plain or upsampling (the downsampling form
    serves only the discriminator, which no entry point builds). The
    OIHW weight serves the transposed convolution of the upsampling form as
    well, transposed to IOHW: the JAX package reads its one HWIO kernel as
    Cin -> Cout for both (ops/conv.py:61-100)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int = 512, demodulate: bool = True, upsample: bool = False,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.demodulate, self.upsample = k, demodulate, upsample
        self.scale = 1.0 / math.sqrt(in_channel * k ** 2)
        self.weight = nn.Parameter(torch.empty(out_channel, in_channel, k, k))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        if upsample:
            factor = 2
            p = (len(blur_kernel) - factor) - (k - 1)
            self.blur_pad = ((p + 1) // 2 + factor - 1, p // 2 + 1)
            self.blur_taps = make_taps(blur_kernel, gain=factor ** 2)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """x: [N, Cin, H, W]; style: [N, style_dim]."""
        s = self.modulation(style.float())  # [N, Cin] f32
        ws = self.weight * self.scale
        xs = x * s[:, :, None, None].to(x.dtype)
        wd = ws.to(x.dtype)
        if self.upsample:
            out = F.conv_transpose2d(xs, wd.transpose(0, 1), stride=2, padding=0)
            out = blur(out, self.blur_taps, self.blur_pad)
        else:
            out = F.conv2d(xs, wd, padding=self.kernel_size // 2)
        if self.demodulate:
            # demod[b, o] = rsqrt(sum_ihw (scale * W * s_b)^2 + 1e-8), in f32
            demod = torch.rsqrt(torch.einsum("oihw,bi->bo", ws * ws, s * s) + 1e-8)
            out = out * demod[:, :, None, None].to(out.dtype)
        return out


class NoiseInjection(nn.Module):
    """model.py:282-294: image + weight * noise, weight a scalar from 0."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.zero_()

    def forward(self, image: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """noise: [N or 1, 1, H, W]; drawn from ``generator`` when None,
        inside a data-parallel train step at the global batch's shape, this
        rank keeping its slice (``parallel.dist.randn_batch``)."""
        if noise is None:
            n, _, h, w = image.shape
            noise = _dp.randn_batch((n, 1, h, w), _dp.active(), generator=generator,
                                    device=image.device)
        return image + self.weight.to(image.dtype) * noise.to(image.dtype)


class StyledConv(nn.Module):
    """ModulatedConv2d + NoiseInjection + fused bias/LeakyReLU
    (model.py:311-346)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int = 512, upsample: bool = False,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size, style_dim,
                                    upsample=upsample, blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate_bias = nn.Parameter(torch.empty(out_channel))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.activate_bias.zero_()

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.noise(self.conv(x, style), noise, generator)
        return fused_leaky_relu(out, self.activate_bias.to(out.dtype))


class ToRGB(nn.Module):
    """model.py:349-369: 1x1 modulated conv without demodulation, bias, and
    the upsampled skip added."""

    def __init__(self, in_channel: int, style_dim: int = 512,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(3))
        self.skip_taps = make_taps(blur_kernel)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.conv(x, style)
        out = out + self.bias.to(out.dtype)[None, :, None, None]
        if skip is not None:
            out = out + upsample_2d(skip, self.skip_taps, factor=2)
        return out


class Generator(nn.Module):
    """StyleGAN2 synthesis network and style MLP (model.py:372-550).

    Computes in ``dtype`` (the input constant is cast to it; every layer
    follows its input's dtype), with float32 parameters.
    """

    def __init__(self, size: int = 1024, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, blur_kernel: Sequence[int] = BLUR_KERNEL,
                 lr_mlp: float = 0.01, base_channels: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.size, self.style_dim, self.n_mlp, self.dtype = size, style_dim, n_mlp, dtype
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2
        self.channels = channels_for(size, channel_multiplier, base_channels)
        for i in range(n_mlp):
            setattr(self, f"style_{i + 1}", EqualLinear(style_dim, style_dim, lr_mul=lr_mlp,
                                                        activation="fused_lrelu"))
        self.pixel_norm = PixelNorm()
        c4 = self.channels[4]
        self.input = nn.Parameter(torch.empty(1, c4, 4, 4))
        self.conv1 = StyledConv(c4, c4, 3, style_dim, blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(c4, style_dim)
        in_ch = c4
        for j, i in enumerate(range(3, self.log_size + 1)):
            out_ch = self.channels[2 ** i]
            setattr(self, f"convs_{2 * j}", StyledConv(in_ch, out_ch, 3, style_dim,
                                                       upsample=True, blur_kernel=blur_kernel))
            setattr(self, f"convs_{2 * j + 1}", StyledConv(out_ch, out_ch, 3, style_dim,
                                                           blur_kernel=blur_kernel))
            setattr(self, f"to_rgbs_{j}", ToRGB(out_ch, style_dim, blur_kernel))
            in_ch = out_ch
        # the fixed per-layer noise maps (model.py:428-431)
        for layer_idx in range(self.num_layers):
            res = 2 ** ((layer_idx + 5) // 2)
            self.register_buffer(f"noise_{layer_idx}", torch.empty(1, 1, res, res))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.input.normal_(0.0, 1.0, generator=generator)
            for buf in self.noise_buffers():
                buf.normal_(0.0, 1.0, generator=generator)

    def noise_buffers(self) -> list[torch.Tensor]:
        return [getattr(self, f"noise_{i}") for i in range(self.num_layers)]

    def map_style(self, z: torch.Tensor) -> torch.Tensor:
        """The style MLP: PixelNorm, then n_mlp EqualLinear + fused lrelu."""
        h = self.pixel_norm(z)
        for i in range(self.n_mlp):
            h = getattr(self, f"style_{i + 1}")(h)
        return h

    def mean_latent(self, n_latent: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = torch.randn((n_latent, self.style_dim), device=self.input.device,
                        generator=generator)
        return self.map_style(z).mean(dim=0, keepdim=True)

    def forward(self, styles: Sequence[torch.Tensor], return_latents: bool = False,
                inject_index: Optional[int] = None,
                truncation: float = 1.0, truncation_latent: Optional[torch.Tensor] = None,
                input_is_latent: bool = False,
                noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
                randomize_noise: bool = True,
                generator: Optional[torch.Generator] = None):
        """styles: one or two [N, style_dim] z (or w with input_is_latent),
        or one [N, n_latent, style_dim] w+. Returns (image [N, 3, size,
        size], the latent or None). Style mixing takes an explicit
        ``inject_index``; randomized noise is drawn from ``generator``."""
        if not input_is_latent:
            styles = [self.map_style(s) for s in styles]
        if noise is None:
            noise = [None] * self.num_layers if randomize_noise else self.noise_buffers()
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]

        if len(styles) < 2:
            latent = styles[0]
            if latent.dim() < 3:
                latent = latent[:, None, :].expand(-1, self.n_latent, -1)
        else:
            if inject_index is None:
                raise ValueError("style mixing needs an explicit inject_index")
            latent = torch.cat([
                styles[0][:, None, :].expand(-1, inject_index, -1),
                styles[1][:, None, :].expand(-1, self.n_latent - inject_index, -1)], dim=1)

        out = self.input.to(self.dtype).expand(latent.shape[0], -1, -1, -1)
        out = self.conv1(out, latent[:, 0], noise[0], generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for j in range(self.log_size - 2):
            conv_a, conv_b = getattr(self, f"convs_{2 * j}"), getattr(self, f"convs_{2 * j + 1}")
            out = conv_a(out, latent[:, i], noise[1 + 2 * j], generator)
            out = conv_b(out, latent[:, i + 1], noise[2 + 2 * j], generator)
            skip = getattr(self, f"to_rgbs_{j}")(out, latent[:, i + 2], skip)
            i += 2
        return skip, latent if return_latents else None


class ConvLayer(nn.Module):
    """Discriminator conv layer (model.py:553-599): an optional blur and
    stride-2 downsample, EqualConv2d, then the fused bias + LeakyReLU
    (``activate_bias``) or, without a bias, the scaled LeakyReLU. The
    convolution carries its own bias only when the layer is not activated."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 downsample: bool = False, blur_kernel: Sequence[int] = BLUR_KERNEL,
                 bias: bool = True, activate: bool = True):
        super().__init__()
        self.downsample, self.activate = downsample, activate
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            self.blur_pad = ((p + 1) // 2, p // 2)
            self.blur_taps = make_taps(blur_kernel)
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        self.conv = EqualConv2d(in_channel, out_channel, kernel_size, stride, padding,
                                bias=bias and not activate)
        self.activate_bias = (nn.Parameter(torch.empty(out_channel))
                              if activate and bias else None)

    def reset_parameters(self, generator=None) -> None:
        if self.activate_bias is not None:
            with torch.no_grad():
                self.activate_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = blur(x, self.blur_taps, self.blur_pad)
        x = self.conv(x)
        if not self.activate:
            return x
        if self.activate_bias is None:
            return scaled_leaky_relu(x)
        return fused_leaky_relu(x, self.activate_bias.to(x.dtype))


class DResBlock(nn.Module):
    """Discriminator residual block (model.py:602-624): two 3x3 ConvLayers,
    the second downsampling, plus a 1x1 downsampling skip, over sqrt(2)."""

    def __init__(self, in_channel: int, out_channel: int,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3, blur_kernel=blur_kernel)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True,
                               blur_kernel=blur_kernel)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True,
                              blur_kernel=blur_kernel, bias=False, activate=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


class Discriminator(nn.Module):
    """StyleGAN2 discriminator with minibatch stddev (model.py:627-685).

    Computes in its input's dtype with float32 parameters. ``final_linear1``
    reads the final 4x4 map flattened in (h, w, c) order, as the JAX package
    flattens NHWC (JAX stylegan2.py:712), so JAX weights carry across by the
    converter's plain transpose; the reference flattens NCHW."""

    def __init__(self, size: int = 1024, channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = BLUR_KERNEL, stddev_group: int = 4,
                 stddev_feat: int = 1):
        super().__init__()
        self.stddev_group, self.stddev_feat = stddev_group, stddev_feat
        channels = channels_for(size, channel_multiplier)
        self.log_size = int(math.log2(size))
        self.conv_in = ConvLayer(3, channels[size], 1, blur_kernel=blur_kernel)
        in_ch = channels[size]
        for i in range(self.log_size, 2, -1):
            out_ch = channels[2 ** (i - 1)]
            setattr(self, f"res_{i}", DResBlock(in_ch, out_ch, blur_kernel))
            in_ch = out_ch
        c4 = channels[4]
        self.final_conv = ConvLayer(in_ch + stddev_feat, c4, 3, blur_kernel=blur_kernel)
        self.final_linear1 = EqualLinear(c4 * 4 * 4, c4, activation="fused_lrelu")
        self.final_linear2 = EqualLinear(c4, 1)

    def minibatch_stddev(self, out: torch.Tensor) -> torch.Tensor:
        """The features with their group stddev appended as ``stddev_feat``
        channels (model.py:671-678): the batch split into ``group`` interleaved
        slices, the population variance across them plus 1e-8, its root
        averaged over each feature's channels and space, tiled back."""
        n, c, h, w = out.shape
        group, feat = min(n, self.stddev_group), self.stddev_feat
        s = out.view(group, n // group, feat, c // feat, h, w)
        s = torch.sqrt(s.var(dim=0, correction=0) + 1e-8).mean(dim=(2, 3, 4))
        s = s.view(n // group, feat, 1, 1).repeat(group, 1, h, w)
        return torch.cat([out, s], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 3, size, size] -> [N, 1]."""
        out = self.conv_in(x)
        for i in range(self.log_size, 2, -1):
            out = getattr(self, f"res_{i}")(out)
        out = self.final_conv(self.minibatch_stddev(out))
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
        return self.final_linear2(self.final_linear1(out))
