"""Plain float32 reference of the ``refill_flagship`` configuration.

The mask detector (``unet.py``), then the reference-guided PICNet generator
of syncdoth/face_mask_inpaint (modules/model.py, network.py,
base_function.py, example_guided_att.py) in eval mode, as
``PICNet_inference.py --use_att 1`` runs it:

- two pluralistic ResEncoders (the source's with its prior, the
  reference's with its posterior), every conv spectrally normalised by one
  power iteration from the stored ``u``, LeakyReLU(0.1), no norm;
- example-guided attention over the encoders' features, with the detected
  mask resized bilinearly to them;
- z = [mu_q + sigma_q * eps_q, mu_p + sigma_p * eps_p] with the noise given,
  sigma = softplus;
- the ResGenerator: a ResBlock from z added to the features, five
  ResBlockDecoders (instance norm + LeakyReLU, a 3x3 conv, a stride-2
  transposed conv, a transposed-conv shortcut), self-attention after the
  second, the tanh Output head after a reflection pad;
- an adaptive average pool to ``out_size``.

Weights are read by the state-dict names of the configuration's model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import unet
from benchmark.reference.common import (
    Ops, WeightSpec, bilinear, fan_in_normal, leaky, spectral_weight)

DETECTOR = "detector."
GENERATOR = "generator."
SLOPE = 0.1  # the LeakyReLU of base_function.py's registry


def _encoder_plan(enc: dict, kind: str) -> list[tuple[str, int, int, int, str]]:
    """(block name, in, hidden, out, sample) of each ResBlock after the stem."""
    ngf, img_f, layers = enc["ngf"], enc["img_f"], enc["layers"]
    plan, mult = [], 1
    for i in range(layers - 1):
        prev, mult = mult, min(2 ** (i + 1), img_f // ngf)
        plan.append((f"encoder{i}", ngf * prev, ngf * prev, ngf * mult,
                     "none" if i % 2 == 0 else "down"))
    ch = ngf * mult
    if kind == "src":
        plan += [(f"infer_prior{i}", ch, ch, ch, "none") for i in range(enc["L"])]
        plan.append(("prior", ch, ch, 2 * enc["z_nc"], "none"))
    else:
        plan.append(("posterior", ch, ch, 2 * enc["z_nc"], "none"))
    return plan


def _decoder_plan(dec: dict) -> list[tuple[int, int]]:
    """(in, out) channels of each ResBlockDecoder."""
    ngf, img_f, layers = dec["ngf"], dec["img_f"], dec["layers"]
    chans = [ngf * min(2 ** (layers - i - 1), img_f // ngf) for i in range(layers)]
    return list(zip([chans[0]] + chans[:-1], chans))


def _spect_conv_specs(specs: dict, name: str, shape) -> None:
    """A spectrally normalised conv: weight, bias, u (dim 0), v (the rest)."""
    specs[f"{name}.weight"] = (shape, fan_in_normal(shape))
    specs[f"{name}.bias"] = ((shape[0],), WeightSpec("normal", 0.0, 0.05))
    specs[f"{name}.u"] = ((shape[0],), WeightSpec("unit"))
    specs[f"{name}.v"] = ((shape[2] * shape[3] * shape[1],), WeightSpec("unit"))


def weight_specs(config: dict) -> dict:
    """name -> (shape, how the benchmark draws it) for the detector and the
    generator. Weights N(0, 1 / fan_in) (the spectral norm rescales them),
    biases N(0, 0.05^2), instance-norm scale 1 + N(0, 0.1^2) and shift
    N(0, 0.1^2), u and v unit vectors, the decoder attention's gamma
    1 + N(0, 0.1^2): nonzero, so the attention reaches the image."""
    specs = dict(unet.weight_specs(f"{DETECTOR}model.", **config["detector"]))
    enc, dec = config["encoder"], config["decoder"]
    for kind in ("src", "ref"):
        p = f"{GENERATOR}{kind}_encoder."
        ngf = enc["ngf"]
        _spect_conv_specs(specs, f"{p}block0.conv1.conv", (ngf, 3, 3, 3))
        _spect_conv_specs(specs, f"{p}block0.conv2.conv", (ngf, ngf, 3, 3))
        _spect_conv_specs(specs, f"{p}block0.bypass.conv", (ngf, 3, 1, 1))
        for name, cin, hid, cout, _ in _encoder_plan(enc, kind):
            _spect_conv_specs(specs, f"{p}{name}.conv1.conv", (hid, cin, 3, 3))
            _spect_conv_specs(specs, f"{p}{name}.conv2.conv", (cout, hid, 3, 3))
            _spect_conv_specs(specs, f"{p}{name}.bypass.conv", (cout, cin, 1, 1))
    feat = _encoder_plan(enc, "src")[enc["layers"] - 2][3]
    specs[f"{GENERATOR}attention.conv.weight"] = (
        (feat // 4, feat, 1, 1), fan_in_normal((feat // 4, feat, 1, 1)))
    g = f"{GENERATOR}decoder."
    plan = _decoder_plan(dec)
    ch = plan[0][0]
    z = 2 * enc["z_nc"]
    _spect_conv_specs(specs, f"{g}generator.conv1.conv", (ch, z, 3, 3))
    _spect_conv_specs(specs, f"{g}generator.conv2.conv", (ch, ch, 3, 3))
    _spect_conv_specs(specs, f"{g}generator.bypass.conv", (ch, z, 1, 1))
    for i, (cin, cout) in enumerate(plan):
        b = f"{g}decoder{i}."
        for n, c in (("norm1", cin), ("norm2", cout)):
            specs[f"{b}{n}.weight"] = ((c,), WeightSpec("normal", 1.0, 0.1))
            specs[f"{b}{n}.bias"] = ((c,), WeightSpec("normal", 0.0, 0.1))
        _spect_conv_specs(specs, f"{b}conv1", (cout, cin, 3, 3))
        # transposed convs: IOHW weights, the bias over dim 1
        for n, ci in (("conv2", cout), ("bypass", cin)):
            shape = (ci, cout, 3, 3)
            specs[f"{b}{n}.weight"] = (shape, fan_in_normal(shape))
            specs[f"{b}{n}.bias"] = ((cout,), WeightSpec("normal", 0.0, 0.05))
            specs[f"{b}{n}.u"] = ((ci,), WeightSpec("unit"))
            specs[f"{b}{n}.v"] = ((9 * cout,), WeightSpec("unit"))
        if i == 1:
            specs[f"{g}attn1.gamma"] = ((1,), WeightSpec("normal", 1.0, 0.1))
            q = (cout // 4, cout, 1, 1)
            specs[f"{g}attn1.query_conv.weight"] = (q, fan_in_normal(q))
            specs[f"{g}attn1.query_conv.bias"] = ((cout // 4,), WeightSpec("normal", 0.0, 0.05))
    _spect_conv_specs(specs, f"{g}out{dec['layers'] - 1}.conv1.conv", (3, plan[-1][1], 3, 3))
    return specs


def calibrate(config: dict, weights: dict, batch: dict) -> dict:
    """Fix the detector's bias so that its mask covers the configuration's
    ``mask_share`` of the first four source photos (``unet.calibrate``)."""
    return unet.calibrate(weights, f"{DETECTOR}model.", batch["src"][:4],
                          config["mask_share"])


class Reference:
    """The configuration's forward in float32 (or the control's precision)
    over the weights ``w``."""

    def __init__(self, config: dict, w: dict, ops: Ops):
        self.config, self.w, self.ops = config, w, ops

    # -- layers -----------------------------------------------------------
    def _conv(self, name, x, stride=1, padding=0):
        w = self.w
        return self.ops.conv2d(x, spectral_weight(w[f"{name}.weight"], w[f"{name}.u"]),
                               w[f"{name}.bias"], stride, padding)

    def _convt(self, name, x):
        w = self.w
        return self.ops.conv_transpose2d(
            x, spectral_weight(w[f"{name}.weight"], w[f"{name}.u"]), w[f"{name}.bias"],
            2, 1, 1)

    def _res_block(self, name, x, sample="none"):
        h = self._conv(f"{name}.conv1.conv", leaky(x, SLOPE), padding=1)
        h = self._conv(f"{name}.conv2.conv", leaky(h, SLOPE), padding=1)
        s = self._conv(f"{name}.bypass.conv", x)
        if sample == "down":
            h, s = F.avg_pool2d(h, 2), F.avg_pool2d(s, 2)
        return h + s

    def _norm_act(self, name, x):
        w = self.w
        y = F.instance_norm(x, weight=w[f"{name}.weight"], bias=w[f"{name}.bias"], eps=1e-5)
        return leaky(y, SLOPE)

    def _encoder(self, kind, img):
        p = f"{GENERATOR}{kind}_encoder."
        h = self._conv(f"{p}block0.conv1.conv", img, padding=1)
        h = F.avg_pool2d(self._conv(f"{p}block0.conv2.conv", leaky(h, SLOPE), padding=1), 2)
        out = h + self._conv(f"{p}block0.bypass.conv", F.avg_pool2d(img, 2))
        plan = _encoder_plan(self.config["encoder"], kind)
        n_trunk = self.config["encoder"]["layers"] - 1
        for name, _, _, _, sample in plan[:n_trunk]:
            out = self._res_block(f"{p}{name}", out, sample)
        h = out
        for name, _, _, _, sample in plan[n_trunk:]:
            h = self._res_block(f"{p}{name}", h, sample)
        mu, std = torch.chunk(h, 2, dim=1)
        return mu, F.softplus(std), out

    @staticmethod
    def _flat(x):
        return x.flatten(2).transpose(1, 2)

    @staticmethod
    def _unflat(t, h, wd):
        return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, wd)

    # -- forward ----------------------------------------------------------
    def mask_gap(self, batch: dict) -> torch.Tensor:
        """The detector's logit gap [N, H, W] on ``batch['src']`` ([N, H, W, 3]
        in [0, 1]); the mask is 1 where it is positive."""
        return unet.gap(self.w, f"{DETECTOR}model.", batch["src"], self.ops)

    def mask(self, batch: dict) -> torch.Tensor:
        """The detected mask [N, H, W]."""
        return (self.mask_gap(batch) > 0).float()

    def generate(self, batch: dict, mask: torch.Tensor) -> torch.Tensor:
        """``batch``: src/ref [N, H, W, 3] in [0, 1], eps_q/eps_p NHWC like
        mu; ``mask`` [N, H, W] -> the image [N, out, out, 3] in [-1, 1]."""
        w, ops = self.w, self.ops
        eps_q, eps_p = batch["eps_q"], batch["eps_p"]
        src = batch["src"].permute(0, 3, 1, 2).float()
        ref = batch["ref"].permute(0, 3, 1, 2).float()
        q_mu, q_sigma, src_f = self._encoder("src", src)
        p_mu, p_sigma, ref_f = self._encoder("ref", ref)
        n, c, h, wd = src_f.shape
        m = bilinear(mask[:, None].float(), (h, wd))
        q = ops.conv2d(src_f, w[f"{GENERATOR}attention.conv.weight"])
        src_att, ref_att = ops.attention(self._flat(q), [self._flat(src_f), self._flat(ref_f)])
        src_att, ref_att = self._unflat(src_att, h, wd), self._unflat(ref_att, h, wd)
        enc = torch.cat([(1.0 - m) * ref_att + m * ref_f, src_att], dim=1)
        z = torch.cat([q_mu + q_sigma * eps_q.permute(0, 3, 1, 2).float(),
                       p_mu + p_sigma * eps_p.permute(0, 3, 1, 2).float()], dim=1)
        g = f"{GENERATOR}decoder."
        out = enc + self._res_block(f"{g}generator", z)
        for i in range(self.config["decoder"]["layers"]):
            b = f"{g}decoder{i}."
            hh = self._conv(f"{b}conv1", self._norm_act(f"{b}norm1", out), padding=1)
            hh = self._convt(f"{b}conv2", self._norm_act(f"{b}norm2", hh))
            out = hh + self._convt(f"{b}bypass", out)
            if i == 1:
                ah, aw = out.shape[2:]
                qa = ops.conv2d(out, w[f"{g}attn1.query_conv.weight"],
                                w[f"{g}attn1.query_conv.bias"])
                att = ops.attention(self._flat(qa), [self._flat(out)])[0]
                out = w[f"{g}attn1.gamma"] * self._unflat(att, ah, aw) + out
        head = f"{g}out{self.config['decoder']['layers'] - 1}.conv1.conv"
        img = torch.tanh(self._conv(head, F.pad(leaky(out, SLOPE), (1, 1, 1, 1),
                                                mode="reflect")))
        size = self.config["out_size"]
        return F.adaptive_avg_pool2d(img, (size, size)).permute(0, 2, 3, 1)
