"""Plain float32 reference of the ``psp_config4`` configuration.

The mask detector (``unet.py``, fed (src + 1) / 2), then pSp
(arXiv:2008.00951; syncdoth/face_mask_inpaint modules/psp) in eval mode as
``psp_inference.py --use_ref --use_attention 1`` runs it:

- the GradualStyleEncoder on IR-SE50 (encoders/helpers.py,
  psp_encoders.py): a stem (3x3 conv, BatchNorm, PReLU), 24 bottleneck
  units with squeeze-excite, the taps c1, c2, c3 at the ends of stages 2-4,
  the same backbone over the reference image, its taps fused in by
  example-guided attention with a 1x1 projection on c3 and c2 and by a mask
  lerp on c1, the FPN (bilinear, align_corners=True, plus 1x1 laterals), and
  18 style heads (stride-2 3x3 convs with LeakyReLU(0.01), an equalized
  linear layer);
- the StyleGAN2 config-f synthesis network at 1024^2 (arXiv:1912.04958,
  rosinality/stylegan2-pytorch model.py) on those w+ codes with its fixed
  noise maps: modulated and demodulated 3x3 convs (transposed, stride 2,
  then the [1, 3, 3, 1] blur where they upsample), noise injection, bias +
  LeakyReLU(0.2) x sqrt(2), 1x1 ToRGB without demodulation and the
  upsampled skip;
- an adaptive average pool to 256^2.

Weights are read by the state-dict names of the configuration's model.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from benchmark.reference import unet
from benchmark.reference.common import (
    Ops, WeightSpec, bilinear, fan_in_normal, leaky)

DETECTOR = "detector."
PSP = "psp."
BLUR = (1.0, 3.0, 3.0, 1.0)
UNITS = {50: (3, 4, 14, 3), 4: (1, 1, 1, 1)}
STAGES = ((64, 64), (64, 128), (128, 256), (256, 512))


def _units(num_layers: int) -> list[tuple[int, int, int]]:
    """(in, depth, stride) of each bottleneck unit (helpers.py:28-53)."""
    out = []
    for (cin, depth), n in zip(STAGES, UNITS[num_layers]):
        out += [(cin, depth, 2)] + [(depth, depth, 1)] * (n - 1)
    return out


def _taps(num_layers: int) -> tuple[int, int, int]:
    """Indices of the last unit of stages 2, 3 and 4 (psp_encoders.py:104-112)."""
    ends = list(itertools.accumulate(UNITS[num_layers]))
    return ends[1] - 1, ends[2] - 1, ends[3] - 1


def channels(size: int, multiplier: int, base: int) -> dict[int, int]:
    """StyleGAN2's channels by resolution (model.py:398-408)."""
    s = base / 512
    return {4: int(512 * s), 8: int(512 * s), 16: int(512 * s), 32: int(512 * s),
            64: int(256 * multiplier * s), 128: int(128 * multiplier * s),
            256: int(64 * multiplier * s), 512: int(32 * multiplier * s),
            1024: int(16 * multiplier * s)}


def _bn_specs(specs, name, c):
    specs[f"{name}.weight"] = ((c,), WeightSpec("normal", 1.0, 0.1))
    specs[f"{name}.bias"] = ((c,), WeightSpec("normal", 0.0, 0.1))
    specs[f"{name}.running_mean"] = ((c,), WeightSpec("normal", 0.0, 0.1))
    specs[f"{name}.running_var"] = ((c,), WeightSpec("lognormal", 0.0, 0.2))


def _conv_specs(specs, name, shape, bias=True, gain=1.0):
    specs[f"{name}.weight"] = (shape, fan_in_normal(shape, gain))
    if bias:
        specs[f"{name}.bias"] = ((shape[0],), WeightSpec("normal", 0.0, 0.05))


def n_styles(size: int) -> int:
    return 2 * int(math.log2(size)) - 2


def weight_specs(config: dict) -> dict:
    """name -> (shape, how the benchmark draws it). Convolutions
    N(0, gain^2 / fan_in), BatchNorm as the detector's, PReLU slopes
    0.25 + N(0, 0.05^2); the StyleGAN2 weights with their published
    distributions (equalized weights, the input constant and the noise maps
    N(0, 1), the modulations' biases 1 + N(0, 0.1^2)), except that the
    noise strengths and the biases, zero at initialisation, are drawn
    nonzero (noise 0.1 + N(0, 0.02^2)), so that every layer reaches the
    image."""
    p = config["psp"]
    specs = dict(unet.weight_specs(f"{DETECTOR}model.", **config["detector"]))
    e = f"{PSP}encoder."
    size = p["output_size"]
    styles = n_styles(size)
    specs[f"{PSP}latent_avg"] = ((styles, 512), WeightSpec("normal", 0.0, 1.0))
    _conv_specs(specs, f"{e}input_layer.conv", (64, 3, 3, 3), bias=False, gain=2 ** 0.5)
    _bn_specs(specs, f"{e}input_layer.bn", 64)
    specs[f"{e}input_layer.prelu.alpha"] = ((64,), WeightSpec("normal", 0.25, 0.05))
    for i, (cin, depth, _) in enumerate(_units(p["num_layers"])):
        b = f"{e}body.body_{i}."
        if cin != depth:
            _conv_specs(specs, f"{b}shortcut_conv", (depth, cin, 1, 1), bias=False)
            _bn_specs(specs, f"{b}shortcut_bn", depth)
        _bn_specs(specs, f"{b}bn0", cin)
        _conv_specs(specs, f"{b}conv1", (depth, cin, 3, 3), bias=False, gain=2 ** 0.5)
        specs[f"{b}prelu.alpha"] = ((depth,), WeightSpec("normal", 0.25, 0.05))
        _conv_specs(specs, f"{b}conv2", (depth, depth, 3, 3), bias=False)
        _bn_specs(specs, f"{b}bn2", depth)
        _conv_specs(specs, f"{b}se.fc1", (depth // 16, depth, 1, 1), bias=False, gain=2 ** 0.5)
        _conv_specs(specs, f"{b}se.fc2", (depth, depth // 16, 1, 1), bias=False)
    _conv_specs(specs, f"{e}latlayer1", (512, 256, 1, 1))
    _conv_specs(specs, f"{e}latlayer2", (512, 128, 1, 1))
    for j, c in ((1, 512), (2, 256)):
        _conv_specs(specs, f"{e}attention{j}.conv", (c // 4, c, 1, 1), bias=False)
        _conv_specs(specs, f"{e}attention{j}.out_conv", (c, 2 * c, 1, 1))
    for j in range(styles):
        spatial = 16 if j < 3 else 32 if j < 7 else 64
        for i in range(int(math.log2(spatial))):
            _conv_specs(specs, f"{e}styles_{j}.conv{i}", (512, 512, 3, 3), gain=2 ** 0.5)
        specs[f"{e}styles_{j}.linear.weight"] = ((512, 512), WeightSpec("normal", 0.0, 1.0))
        specs[f"{e}styles_{j}.linear.bias"] = ((512,), WeightSpec("normal", 0.0, 0.1))
    d = f"{PSP}decoder."
    ch = channels(size, 2, p["decoder_base_channels"])
    lr_mlp = 0.01
    for i in range(1, 9):  # the style MLP: built, unused on w+ codes
        specs[f"{d}style_{i}.weight"] = ((512, 512), WeightSpec("normal", 0.0, 1.0 / lr_mlp))
        specs[f"{d}style_{i}.bias"] = ((512,), WeightSpec("normal", 0.0, 0.1))
    specs[f"{d}input"] = ((1, ch[4], 4, 4), WeightSpec("normal", 0.0, 1.0))

    def styled(name, cin, cout):
        specs[f"{name}.conv.weight"] = ((cout, cin, 3, 3), WeightSpec("normal", 0.0, 1.0))
        specs[f"{name}.conv.modulation.weight"] = ((cin, 512), WeightSpec("normal", 0.0, 1.0))
        specs[f"{name}.conv.modulation.bias"] = ((cin,), WeightSpec("normal", 1.0, 0.1))
        specs[f"{name}.noise.weight"] = ((1,), WeightSpec("normal", 0.1, 0.02))
        specs[f"{name}.activate_bias"] = ((cout,), WeightSpec("normal", 0.0, 0.1))

    def to_rgb(name, cin):
        specs[f"{name}.conv.weight"] = ((3, cin, 1, 1), WeightSpec("normal", 0.0, 1.0))
        specs[f"{name}.conv.modulation.weight"] = ((cin, 512), WeightSpec("normal", 0.0, 1.0))
        specs[f"{name}.conv.modulation.bias"] = ((cin,), WeightSpec("normal", 1.0, 0.1))
        specs[f"{name}.bias"] = ((3,), WeightSpec("normal", 0.0, 0.1))

    styled(f"{d}conv1", ch[4], ch[4])
    to_rgb(f"{d}to_rgb1", ch[4])
    cin = ch[4]
    for j, lvl in enumerate(range(3, int(math.log2(size)) + 1)):
        cout = ch[2 ** lvl]
        styled(f"{d}convs_{2 * j}", cin, cout)
        styled(f"{d}convs_{2 * j + 1}", cout, cout)
        to_rgb(f"{d}to_rgbs_{j}", cout)
        cin = cout
    for i in range((int(math.log2(size)) - 2) * 2 + 1):
        res = 2 ** ((i + 5) // 2)
        specs[f"{d}noise_{i}"] = ((1, 1, res, res), WeightSpec("normal", 0.0, 1.0))
    return specs


def _fir(taps=BLUR, gain: float = 1.0) -> torch.Tensor:
    """make_kernel (model.py:19-27): the outer product scaled to unit sum,
    times ``gain``."""
    k = torch.tensor(taps, dtype=torch.float64)
    k = k[None, :] * k[:, None]
    return (k / k.sum() * gain).float()


def _upfirdn(x: torch.Tensor, kernel: torch.Tensor, up: int, pad: tuple[int, int]):
    """upfirdn2d (op/upfirdn2d.py upfirdn2d_native) with down = 1: insert
    up - 1 zeros between samples, pad, convolve with the flipped kernel."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(n, c, h * up, w * up)
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.flip(kernel, [0, 1]).to(x)[None, None].expand(c, 1, -1, -1)
    return F.conv2d(x, k, groups=c)


def calibrate(config: dict, weights: dict, batch: dict) -> dict:
    """Fix the detector's bias so that its mask covers the configuration's
    ``mask_share`` of the first four source photos (``unet.calibrate``),
    and set every BatchNorm's running statistics of the encoder to the
    statistics of its input over the first four source and reference
    photos, as a trained network's are its data's: with random running
    statistics the 24 residual units double the activations' variance
    each, and the attention and the style codes see values of 10^3 and
    more. The statistics come from this float32 reference, so they are a
    function of the seed alone. Returns the entries it changed."""
    changed = unet.calibrate(weights, f"{DETECTOR}model.", (batch["src"][:4] + 1) / 2,
                             config["mask_share"])
    ref = Reference(config, weights, Ops())
    ref.calibrating = True
    images = torch.cat([batch["src"][:4], batch["ref"][:4]]).permute(0, 3, 1, 2).float()
    ref._backbone(images)
    changed.update({k: weights[k] for k in ref.calibrated})
    return changed


class Reference:
    """The configuration's forward in float32 (or the control's precision)
    over the weights ``w``."""

    def __init__(self, config: dict, w: dict, ops: Ops):
        self.config, self.w, self.ops = config, w, ops
        self.num_layers = config["psp"]["num_layers"]
        self.size = config["psp"]["output_size"]
        self.calibrating, self.calibrated = False, []

    # -- encoder ----------------------------------------------------------
    def _bn(self, name, x):
        w = self.w
        if self.calibrating:  # running statistics := this input's (calibrate)
            w[f"{name}.running_mean"] = x.mean(dim=(0, 2, 3))
            w[f"{name}.running_var"] = x.var(dim=(0, 2, 3), correction=0)
            self.calibrated += [f"{name}.running_mean", f"{name}.running_var"]
        return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                            w[f"{name}.weight"], w[f"{name}.bias"], False, 0.0, 1e-5)

    def _prelu(self, name, x):
        return F.prelu(x, self.w[f"{name}.alpha"])

    def _conv(self, name, x, stride=1, padding=0):
        return self.ops.conv2d(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"),
                               stride, padding)

    def _unit(self, i, x, cin, depth, stride):
        b = f"{PSP}encoder.body.body_{i}."
        if cin == depth:
            shortcut = x[:, :, ::stride, ::stride]
        else:
            shortcut = self._bn(f"{b}shortcut_bn", self._conv(f"{b}shortcut_conv", x, stride))
        r = self._conv(f"{b}conv1", self._bn(f"{b}bn0", x), padding=1)
        r = self._bn(f"{b}bn2", self._conv(f"{b}conv2", self._prelu(f"{b}prelu", r), stride, 1))
        s = F.relu(self._conv(f"{b}se.fc1", r.mean(dim=(2, 3), keepdim=True)))
        r = r * torch.sigmoid(self._conv(f"{b}se.fc2", s))
        return r + shortcut

    def _backbone(self, x):
        e = f"{PSP}encoder."
        x = self._prelu(f"{e}input_layer.prelu",
                        self._bn(f"{e}input_layer.bn", self._conv(f"{e}input_layer.conv", x,
                                                                  padding=1)))
        taps, want = [], _taps(self.num_layers)
        for i, spec in enumerate(_units(self.num_layers)):
            x = self._unit(i, x, *spec)
            if i in want:
                taps.append(x)
        return taps

    def _attention(self, j, m, src, ref):
        n, c, h, wd = src.shape
        q = self._conv(f"{PSP}encoder.attention{j}.conv", src).flatten(2).transpose(1, 2)
        src_att, ref_att = (t.transpose(1, 2).reshape(n, c, h, wd) for t in self.ops.attention(
            q, [src.flatten(2).transpose(1, 2), ref.flatten(2).transpose(1, 2)]))
        out = torch.cat([(1.0 - m) * ref_att + m * ref, src_att], dim=1)
        return self._conv(f"{PSP}encoder.attention{j}.out_conv", out)

    def _style(self, j, x):
        e = f"{PSP}encoder.styles_{j}."
        spatial = 16 if j < 3 else 32 if j < 7 else 64
        for i in range(int(math.log2(spatial))):
            x = leaky(self._conv(f"{e}conv{i}", x, 2, 1), 0.01)
        x = x.reshape(x.shape[0], 512)
        return self.ops.linear(x, self.w[f"{e}linear.weight"] / math.sqrt(512),
                               self.w[f"{e}linear.bias"])

    def codes(self, src, ref, mask) -> torch.Tensor:
        """src/ref NHWC in [-1, 1], mask [N, H, W] -> w+ [N, n_styles, 512]."""
        c1, c2, c3 = self._backbone(src.permute(0, 3, 1, 2).float())
        r1, r2, r3 = self._backbone(ref.permute(0, 3, 1, 2).float())
        m = mask[:, None].float()
        c3 = self._attention(1, bilinear(m, r3.shape[2:]), c3, r3)
        c2 = self._attention(2, bilinear(m, r2.shape[2:]), c2, r2)
        m1 = bilinear(m, r1.shape[2:])
        c1 = m1 * r1 + (1 - m1) * c1
        e = f"{PSP}encoder."
        lat1 = self._conv(f"{e}latlayer1", c2)
        p2 = bilinear(c3, lat1.shape[2:]) + lat1
        lat2 = self._conv(f"{e}latlayer2", c1)
        p1 = bilinear(p2, lat2.shape[2:]) + lat2
        levels = [c3] * 3 + [p2] * 4 + [p1] * (n_styles(self.size) - 7)
        return torch.stack([self._style(j, x) for j, x in enumerate(levels)], dim=1)

    # -- decoder ----------------------------------------------------------
    def _modconv(self, name, x, style, demodulate=True, upsample=False):
        """Modulated conv (model.py:187-279) in its input/output-scaling
        form: conv(x * s, scale * W) * demod, with demod[b, o] =
        rsqrt(sum_ihw (scale * W[o] * s[b])^2 + 1e-8); where it upsamples,
        a stride-2 transposed conv and the blur (pad (1, 1), gain 4)."""
        w = self.w
        weight = w[f"{name}.weight"]
        cin, k = weight.shape[1], weight.shape[-1]
        s = self.ops.linear(style, w[f"{name}.modulation.weight"] / math.sqrt(512),
                            w[f"{name}.modulation.bias"])
        ws = weight / math.sqrt(cin * k * k)
        xs = x * s[:, :, None, None]
        if upsample:
            out = self.ops.conv_transpose2d(xs, ws.transpose(0, 1), stride=2)
            out = _upfirdn(out, _fir(gain=4.0), 1, (1, 1))
        else:
            out = self.ops.conv2d(xs, ws, padding=k // 2)
        if demodulate:
            demod = torch.rsqrt(torch.einsum("oihw,bi->bo", ws * ws, s * s) + 1e-8)
            out = out * demod[:, :, None, None]
        return out

    def _styled(self, name, x, style, noise, upsample=False):
        w = self.w
        out = self._modconv(f"{name}.conv", x, style, upsample=upsample)
        out = out + w[f"{name}.noise.weight"] * noise
        return leaky(out + w[f"{name}.activate_bias"][None, :, None, None], 0.2) * math.sqrt(2)

    def _to_rgb(self, name, x, style, skip=None):
        out = self._modconv(f"{name}.conv", x, style, demodulate=False)
        out = out + self.w[f"{name}.bias"][None, :, None, None]
        if skip is not None:
            out = out + _upfirdn(skip, _fir(gain=4.0), 2, (2, 1))
        return out

    def image(self, codes: torch.Tensor) -> torch.Tensor:
        """w+ codes [N, n_styles, 512] -> the image [N, 256, 256, 3]."""
        w, d = self.w, f"{PSP}decoder."
        noise = [w[f"{d}noise_{i}"] for i in range((int(math.log2(self.size)) - 2) * 2 + 1)]
        out = w[f"{d}input"].expand(codes.shape[0], -1, -1, -1)
        out = self._styled(f"{d}conv1", out, codes[:, 0], noise[0])
        skip = self._to_rgb(f"{d}to_rgb1", out, codes[:, 1])
        i = 1
        for j in range(int(math.log2(self.size)) - 2):
            out = self._styled(f"{d}convs_{2 * j}", out, codes[:, i], noise[1 + 2 * j],
                               upsample=True)
            out = self._styled(f"{d}convs_{2 * j + 1}", out, codes[:, i + 1], noise[2 + 2 * j])
            skip = self._to_rgb(f"{d}to_rgbs_{j}", out, codes[:, i + 2], skip)
            i += 2
        return F.adaptive_avg_pool2d(skip, (256, 256)).permute(0, 2, 3, 1)

    # -- forward ----------------------------------------------------------
    def mask_gap(self, batch: dict) -> torch.Tensor:
        """The detector's logit gap [N, H, W] on ``batch['src']`` (NHWC in
        [-1, 1]); the mask is 1 where it is positive."""
        return unet.gap(self.w, f"{DETECTOR}model.", (batch["src"] + 1) / 2, self.ops)

    def mask(self, batch: dict) -> torch.Tensor:
        """The detected mask [N, H, W]."""
        return (self.mask_gap(batch) > 0).float()

    def generate(self, batch: dict, mask: torch.Tensor) -> torch.Tensor:
        """``batch``: src/ref NHWC in [-1, 1]; ``mask`` [N, H, W] -> the
        image [N, 256, 256, 3]."""
        return self.image(self.codes(batch["src"], batch["ref"], mask))
