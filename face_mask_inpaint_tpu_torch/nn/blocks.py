"""PICNet building blocks and the attention modules, over NCHW tensors.

Port of face_mask_inpaint_tpu/nn/blocks.py (dense paths). Submodule names
mirror the flax module names, so a JAX variable path maps onto a state_dict
key by a tree walk (convert.py). Input channel counts, which flax infers
from the data, are constructor arguments here.

The last decoder block can hand the Output head its (h, bypass) pair before
the add; the head then runs act(h + s) -> conv -> tanh -> pool as kernel K3
(kernels/output_head.py), the port of the JAX pair path with
``FMI_OUTPUT_KERNEL=1``. A decoder block can instead run as its fused tail
(``ResBlockDecoder(fused=True)``), the port of the JAX path with
``FMI_PACKED_CONVT=1``: kernel K4b (conv1 with norm1's affine and activation
as its prologue, norm2's statistics as its epilogue), then kernel K4a (the
conv2 + bypass transposed-conv pair with norm2's prologue), both in
kernels/decoder_conv.py; on the last block K4a also applies the Output head's
leading activation, and the head runs ``pre_activated``. Not ported, because
their outputs equal the dense math computed here: the space-to-depth packing
of the decoder tail and the conv->avg-pool fold (``fuse_avgpool2``: conv then
``avg_pool2d`` here).

In eval mode the dense decoder block adds no conv bias in a pass of its own
(cuDNN would run each biased conv as the conv and then a broadcast add over
its output): conv1's bias goes to norm2's kernel K2 as its ``in_bias``,
where norm2 runs as K2; conv2's and the bypass's go to the residual sum's
kernel (kernels/residual_add.py), or, with ``return_pair``, to K3 as its
``pair_bias``. Training mode keeps the biased convs and the differentiable
``h + s``.

CoordConv (``use_coord``) appends coordinate channels to a conv's input.
Under it the fused forms are off (K3's pair head, the fused tail), as the
JAX blocks turn theirs off, and the dense forms run.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
from face_mask_inpaint_tpu_torch.kernels import output_head as oh
from face_mask_inpaint_tpu_torch.kernels import residual_add as ra
from face_mask_inpaint_tpu_torch.nn.layers import (
    Activation, Conv2d, ConvTranspose2d, InstanceNorm2d, make_norm)
from face_mask_inpaint_tpu_torch.ops.attention import attention_apply
from face_mask_inpaint_tpu_torch.ops.conv import pixel_shuffle
from face_mask_inpaint_tpu_torch.ops.resize import avg_pool2d, reflection_pad2d

__all__ = ["add_coords", "AddCoords", "CoordConvWrap", "ResBlock", "ResBlockEncoderOptimized",
           "ResBlockDecoder", "Output", "AutoAttention", "ExampleGuidedAttention"]


def _norm_act_module(norm: str, activation: str, channels: int) -> Optional[nn.Module]:
    """The [norm -> act] pair's norm: instance norm + (Leaky)ReLU fuse into one
    InstanceNorm2d(fuse_act) (kernel K2), as the JAX ``_norm_act`` does."""
    if norm == "instance" and activation in ("LeakyReLU", "ReLU"):
        return InstanceNorm2d(channels, fuse_act=activation)
    return make_norm(norm, channels)


def _norm_act(x: torch.Tensor, norm: Optional[nn.Module], act: nn.Module) -> torch.Tensor:
    if isinstance(norm, InstanceNorm2d) and norm.fuse_act is not None:
        return norm(x)
    if norm is not None:
        x = norm(x)
    return act(x)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> contiguous [N, H*W, C] (tokens by channels)."""
    return x.flatten(2).transpose(1, 2).contiguous()


def _unflat(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, H*W, C] -> [N, C, H, W]."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def add_coords(x: torch.Tensor, with_r: bool = False) -> torch.Tensor:
    """AddCoords (base_function.py:152-184) on NCHW: append the row and column
    coordinates, each evenly spaced over [-1, 1], and with ``with_r`` their
    radius, as channels."""
    n, _, h, w = x.shape
    hh = torch.linspace(-1.0, 1.0, h, device=x.device).to(x.dtype).view(1, 1, h, 1)
    ww = torch.linspace(-1.0, 1.0, w, device=x.device).to(x.dtype).view(1, 1, 1, w)
    hh, ww = hh.expand(n, 1, h, w), ww.expand(n, 1, h, w)
    feats = [x, hh, ww]
    if with_r:
        feats.append(torch.sqrt(hh ** 2 + ww ** 2))
    return torch.cat(feats, dim=1)


class AddCoords(nn.Module):
    def __init__(self, with_r: bool = False):
        super().__init__()
        self.with_r = with_r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return add_coords(x, self.with_r)


class CoordConvWrap(nn.Module):
    """coord_conv factory (base_function.py:136-146): a (spectral-norm) conv
    named ``conv``; with ``use_coord`` the coordinates (2 channels, 3 with
    ``with_r``) are appended to its input first."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 use_spect: bool = False, use_coord: bool = False, with_r: bool = False,
                 init_type: str = "lecun_normal"):
        super().__init__()
        self.use_coord, self.with_r = use_coord, with_r
        extra = (3 if with_r else 2) if use_coord else 0
        self.conv = Conv2d(in_channels + extra, out_channels, kernel_size, stride, padding,
                           bias=bias, use_spect=use_spect, init_type=init_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_coord:
            x = add_coords(x, self.with_r)
        return self.conv(x)


class ResBlock(nn.Module):
    """Pre-activation residual block with none/up/down sampling
    (base_function.py:207-268)."""

    def __init__(self, input_nc: int, output_nc: int, hidden_nc: Optional[int] = None,
                 norm: str = "none", activation: str = "LeakyReLU",
                 sample_type: str = "none", use_spect: bool = False,
                 use_coord: bool = False, init_type: str = "lecun_normal"):
        super().__init__()
        hidden_nc = output_nc if hidden_nc is None else hidden_nc
        if sample_type not in ("none", "up", "down"):
            raise NotImplementedError(f"sample type [{sample_type}] is not found")
        self.sample_type = sample_type
        out_nc = output_nc * 4 if sample_type == "up" else output_nc
        kw = dict(use_spect=use_spect, use_coord=use_coord, init_type=init_type)
        self.act = Activation(activation)
        self.norm1 = _norm_act_module(norm, activation, input_nc)
        self.conv1 = CoordConvWrap(input_nc, hidden_nc, 3, padding=1, **kw)
        self.norm2 = _norm_act_module(norm, activation, hidden_nc)
        self.conv2 = CoordConvWrap(hidden_nc, out_nc, 3, padding=1, **kw)
        self.bypass = CoordConvWrap(input_nc, out_nc, 1, padding=0, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_norm_act(x, self.norm1, self.act))
        h = self.conv2(_norm_act(h, self.norm2, self.act))
        s = self.bypass(x)
        if self.sample_type == "down":
            h, s = avg_pool2d(h, 2), avg_pool2d(s, 2)
        elif self.sample_type == "up":
            h, s = pixel_shuffle(h, 2), pixel_shuffle(s, 2)
        return h + s


class ResBlockEncoderOptimized(nn.Module):
    """Stem block (base_function.py:271-305): conv, norm, act, conv, avg-pool;
    the shortcut pools, then a 1x1 conv."""

    def __init__(self, input_nc: int, output_nc: int, norm: str = "none",
                 activation: str = "LeakyReLU", use_spect: bool = False,
                 use_coord: bool = False, init_type: str = "lecun_normal"):
        super().__init__()
        kw = dict(use_spect=use_spect, use_coord=use_coord, init_type=init_type)
        self.act = Activation(activation)
        self.conv1 = CoordConvWrap(input_nc, output_nc, 3, padding=1, **kw)
        self.norm1 = make_norm(norm, output_nc)
        self.conv2 = CoordConvWrap(output_nc, output_nc, 3, padding=1, **kw)
        self.bypass = CoordConvWrap(input_nc, output_nc, 1, padding=0, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        if self.norm1 is not None:
            h = self.norm1(h)
        h = avg_pool2d(self.conv2(self.act(h)), 2)
        return h + self.bypass(avg_pool2d(x, 2))


class ResBlockDecoder(nn.Module):
    """Upsampling decoder block (base_function.py:308-364): [norm, act] 3x3
    conv, [norm, act] stride-2 ConvTranspose (k=3, p=1, op=1), plus a
    transposed-conv shortcut."""

    def __init__(self, input_nc: int, output_nc: int, hidden_nc: Optional[int] = None,
                 norm: str = "instance", activation: str = "LeakyReLU",
                 use_spect: bool = False, use_coord: bool = False,
                 init_type: str = "lecun_normal"):
        super().__init__()
        hidden_nc = output_nc if hidden_nc is None else hidden_nc
        kw = dict(use_spect=use_spect, init_type=init_type)
        # the reference block's convs take no coordinates; like the JAX
        # block, use_coord only turns its fused tail off
        self.activation, self.use_coord = activation, use_coord
        self.act = Activation(activation)
        self.norm1 = _norm_act_module(norm, activation, input_nc)
        self.conv1 = Conv2d(input_nc, hidden_nc, 3, padding=1, **kw)
        self.norm2 = _norm_act_module(norm, activation, hidden_nc)
        self.conv2 = ConvTranspose2d(hidden_nc, output_nc, 3, 2, 1, 1, **kw)
        self.bypass = ConvTranspose2d(input_nc, output_nc, 3, 2, 1, 1, **kw)

    def fused_ok(self) -> bool:
        """Whether the block can run as its fused tail (JAX nn/blocks.py:277-284:
        instance norm or none, a (Leaky)ReLU, no CoordConv)."""
        norms_ok = all(m is None or isinstance(m, InstanceNorm2d)
                       for m in (self.norm1, self.norm2))
        return norms_ok and self.activation in dc.ACTS and not self.use_coord

    def forward(self, x: torch.Tensor, return_pair: bool = False, fused: bool = False,
                in_stats=None, want_stats: bool = False, fuse_act: Optional[str] = None):
        """Returns h + bypass(x), or, in eval mode with ``return_pair``, the
        triple (h, bypass(x), pair bias) before the add, for the Output
        head's kernel: both convs' biases left out of h and bypass(x) and
        summed in f32 (f64 for f64 biases) as the pair bias.

        ``fused`` runs the block as kernels K4b and K4a (JAX
        ``_fused_tail``): ``in_stats`` are the f32 per-(n, c) (sum x,
        sum x^2) of x from the previous block's K4a, or None to sum x here;
        ``want_stats`` returns (out, stats of out) for the next block;
        ``fuse_act`` applies that activation to the output."""
        if fused:
            return self._fused_tail(x, in_stats, want_stats, fuse_act)
        if not self.training:
            return self._biases_to_kernels(x, return_pair)
        assert not return_pair, "the Output head takes the decoder's pair in eval mode only"
        h = self.conv1(_norm_act(x, self.norm1, self.act))
        h = self.conv2(_norm_act(h, self.norm2, self.act))
        return h + self.bypass(x)

    def _biases_to_kernels(self, x, return_pair):
        """The dense block in eval mode, each conv's bias added by the kernel
        that next reads the conv's output: conv1's by K2 (norm2), where
        norm2 runs as K2; conv2's and the bypass's by the residual sum's
        kernel, or, with ``return_pair``, by K3."""
        in_bias = isinstance(self.norm2, InstanceNorm2d) and self.norm2.fuses_in_bias()
        h = self.conv1(_norm_act(x, self.norm1, self.act), with_bias=not in_bias)
        h = (self.norm2(h, in_bias=self.conv1.bias) if in_bias
             else _norm_act(h, self.norm2, self.act))
        h = self.conv2(h, with_bias=False)
        s = self.bypass(x, with_bias=False)
        acc = torch.promote_types(self.conv2.bias.dtype, torch.float32)
        pair_bias = self.conv2.bias.to(acc) + self.bypass.bias.to(acc)
        if return_pair:
            return h, s, pair_bias
        return ra.residual_bias_add(h, s, pair_bias)

    def _fused_tail(self, x, in_stats, want_stats, fuse_act):
        assert self.fused_ok(), "the fused tail needs instance norm or none and a (Leaky)ReLU"
        x = x.contiguous()
        n, c_in, height, width = x.shape
        instance = self.norm1 is not None

        def affine(norm, stats, c):
            """(A, B) with x * A + B == norm(x), or the identity."""
            if not instance:
                ones = torch.ones((n, c), dtype=torch.float32, device=x.device)
                return ones, torch.zeros_like(ones)
            return dc.instance_affine_from_stats(stats[0], stats[1], height * width,
                                                 norm.weight, norm.bias, norm.eps)

        if instance and in_stats is None:
            xf = x.float()
            in_stats = (xf.sum(dim=(2, 3)), xf.square().sum(dim=(2, 3)))
        a1, b1 = affine(self.norm1, in_stats, c_in)
        h = dc.conv3x3_stats(x, self.conv1.effective_weight(),
                             _bias(self.conv1, x.dtype), prologue=(a1, b1, self.activation),
                             with_stats=instance)
        h_stats = None
        if instance:
            h, h_stats = h
        a2, b2 = affine(self.norm2, h_stats, h.shape[1])
        return dc.convt_pair(
            [(h, self.conv2.effective_weight(), _bias(self.conv2, x.dtype),
              (a2, b2, self.activation)),
             (x, self.bypass.effective_weight(), _bias(self.bypass, x.dtype))],
            act=fuse_act, with_stats=want_stats)


def _bias(conv, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A conv's bias in the compute dtype, as the JAX layers hand it to their
    fused consumers (nn/layers.py ``return_weights``)."""
    return conv.bias.to(dtype) if conv.bias is not None else None


class Output(nn.Module):
    """Output head (base_function.py:367-398): [norm] act, reflection pad,
    valid conv, tanh."""

    def __init__(self, input_nc: int, output_nc: int, kernel_size: int = 3,
                 norm: str = "none", activation: str = "LeakyReLU",
                 use_spect: bool = False, use_coord: bool = False,
                 init_type: str = "lecun_normal"):
        super().__init__()
        self.kernel_size, self.norm, self.use_coord = kernel_size, norm, use_coord
        self.activation = activation
        self.act = Activation(activation)
        self.norm1 = make_norm(norm, input_nc)
        self.conv1 = CoordConvWrap(input_nc, output_nc, kernel_size, padding=0,
                                   use_spect=use_spect, use_coord=use_coord,
                                   init_type=init_type)

    def pair_ok(self) -> bool:
        """Whether the head can take a decoder pair (JAX ``kern_ok``,
        nn/blocks.py:424-427)."""
        return (self.norm == "none" and self.kernel_size == 3 and not self.use_coord
                and self.activation in oh.ACTS)

    def forward(self, x, pool: Optional[int] = None,
                pre_activated: bool = False) -> torch.Tensor:
        """x: a map [N, C, H, W] -> [N, co, H, W]; or the decoder's triple
        (h, s, pair bias [C]) with an integer ``pool``, which runs
        act(h + s + pair bias) -> conv -> tanh -> pool as kernel K3 ->
        [N, co, H/pool, W/pool].
        ``pre_activated``: the decoder's fused tail already applied this
        head's leading activation (norm 'none' only)."""
        if isinstance(x, (tuple, list)):
            assert self.pair_ok() and isinstance(pool, int), \
                "the pair head needs norm 'none', a 3x3 conv without CoordConv, " \
                "a (Leaky)ReLU and an integer pool"
            h, s, pair_bias = x
            conv = self.conv1.conv
            return oh.output_head(h.contiguous(), s.contiguous(), conv.effective_weight(),
                                  conv.bias, self.activation, pool, pair_bias)
        if pre_activated:
            assert self.norm1 is None, "a pre-activated input needs norm 'none'"
        else:
            if self.norm1 is not None:
                x = self.norm1(x)
            x = self.act(x)
        return torch.tanh(self.conv1(reflection_pad2d(x, self.kernel_size // 2)))


class AutoAttention(nn.Module):
    """Short- and long-term self-attention (Auto_Attn, base_function.py:401-448).

    out = gamma * A(x) + x with A(x)[i] = sum_j softmax_j(q_i . q_j) x[j] and
    q a 1x1 projection to C/4 channels. Above ``block_threshold`` tokens the
    map streams through kernel K1.

    With ``pre_channels`` the module also has the long-term branch (JAX
    nn/blocks.py:678-702): ``pre`` [N, C_pre, H, W] is a second value set of
    the same map (K1 then runs with C + C_pre value channels), the context
    flow alpha * (1 - mask) * A(pre) + mask * pre joins ``out`` on the
    channels, and the ResBlock ``model`` (spectral norm, this module's norm)
    maps the pair back to C channels. gamma and alpha start at zero.
    """

    def __init__(self, in_channels: int, pre_channels: Optional[int] = None,
                 norm: str = "none", block_threshold: int = 4096,
                 init_type: str = "lecun_normal"):
        super().__init__()
        self.block_threshold = block_threshold
        self.query_conv = Conv2d(in_channels, in_channels // 4, 1, init_type=init_type)
        self.gamma = nn.Parameter(torch.empty(1))
        self.alpha = self.model = None
        if pre_channels is not None:
            self.alpha = nn.Parameter(torch.empty(1))
            self.model = ResBlock(in_channels + pre_channels, in_channels, in_channels,
                                  norm=norm, use_spect=True, init_type=init_type)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.gamma.zero_()
            if self.alpha is not None:
                self.alpha.zero_()

    def forward(self, x: torch.Tensor, pre: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [N, C, H, W]; ``pre`` [N, C_pre, H, W] and ``mask`` [N, 1, H, W]
        (or broadcastable) feed the long-term branch."""
        _, _, h, w = x.shape
        if (pre is None) != (self.model is None):
            raise ValueError("pre is given exactly when the module has pre_channels")
        values = [_flat(x)] + ([_flat(pre)] if pre is not None else [])
        outs = attention_apply(_flat(self.query_conv(x)), values,
                               block_threshold=self.block_threshold)
        out = self.gamma.to(x.dtype) * _unflat(outs[0], h, w) + x
        if pre is not None:
            context_flow = (self.alpha.to(x.dtype) * (1.0 - mask) * _unflat(outs[1], h, w)
                            + mask * pre)
            out = self.model(torch.cat([out, context_flow], dim=1))
        return out


class ExampleGuidedAttention(nn.Module):
    """Example-guided cross attention (modules/example_guided_att.py:5-41).

    One map from the masked-source features re-assembles both source and
    reference features; inside the mask the raw reference passes through.
    Output: channel-concat [ex_guide_flow, src_att] (2C channels), optionally
    projected by a 1x1 ``out_conv``.
    """

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 block_threshold: int = 4096, init_type: str = "lecun_normal"):
        super().__init__()
        self.block_threshold = block_threshold
        self.conv = Conv2d(in_channels, in_channels // 4, 1, bias=False,
                           init_type=init_type)
        self.out_conv = (Conv2d(2 * in_channels, out_channels, 1, init_type=init_type)
                         if out_channels is not None else None)

    def forward(self, src_mask: torch.Tensor, src_feature: torch.Tensor,
                ref_feature: torch.Tensor) -> torch.Tensor:
        """src_mask: [N, 1, H, W]; src/ref_feature: [N, C, H, W]."""
        _, _, h, w = src_feature.shape
        src_att, ref_att = attention_apply(
            _flat(self.conv(src_feature)), [_flat(src_feature), _flat(ref_feature)],
            block_threshold=self.block_threshold)
        src_att, ref_att = _unflat(src_att, h, w), _unflat(ref_att, h, w)
        ex_guide_flow = (1.0 - src_mask) * ref_att + src_mask * ref_feature
        out = torch.cat([ex_guide_flow, src_att], dim=1)
        return self.out_conv(out) if self.out_conv is not None else out
