"""Plain float32 reference of the ``refill_drn`` configuration.

The mask detector (``unet.py``), then the reference-guided PICNet generator
of syncdoth/face_mask_inpaint with ``--encoder_type drn`` (modules/model.py,
modules/drn.py) in eval mode, as ``PICNet_inference.py --encoder_type drn
--use_att 1`` runs it:

- two DRN-C-42 trunks (Yu, Koltun and Funkhouser, arXiv:1705.09914; fyu/drn
  ``drn_c_42``), one over the source photo and one over the reference: a
  7x7 conv, BatchNorm on running statistics and ReLU, then eight groups of
  BasicBlocks (3x3 conv, BatchNorm, ReLU, 3x3 conv, BatchNorm, the
  shortcut added, ReLU), the first block of a group striding and taking a
  1x1 conv + BatchNorm shortcut where the stride or the width changes;
  strides 1, 2, 2, 2 to 1/8, then dilations 2, 4, 2, 1 with each conv's
  padding its dilation, and no shortcut in the last two groups (DRN-C's
  degridding layers); the classifier replaced by a 1x1 conv with a bias to
  ``img_f`` channels;
- example-guided attention over the two trunks' features, with the
  detected mask resized bilinearly to them (``refill_flagship``);
- the flagship's ResGenerator without its latent branch: the decoder's
  first block takes the attention's output itself;
- an adaptive average pool to ``out_size``.

Departures from syncdoth/fyu: the trunks take the photos in [0, 1] as the
port does (no mean and std normalisation); the shortcut's BatchNorm is
computed only where a block adds it (in DRN-C-42 every block with a
shortcut conv adds it); the dilated convs go through ``_dconv``, since
``Ops.conv2d`` takes no dilation, with their operands and results rounded
as ``Ops`` rounds every product.

Weights are read by the state-dict names of the configuration's model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import refill_flagship, unet
from benchmark.reference.common import Ops, WeightSpec, bilinear, fan_in_normal, leaky
from benchmark.reference.refill_flagship import (
    DETECTOR, GENERATOR, SLOPE, _decoder_plan, _spect_conv_specs)

STRIDES = (1, 2, 2, 2, 1, 1, 1, 1)
DILATIONS = (1, 1, 1, 1, 2, 4, 2, 1)
RESIDUAL = (True, True, True, True, True, True, False, False)
N_STRIDED = 4  # groups 1-4 stride to 1/8; the rest are the dilated levels


def drn_plan(enc: dict) -> list[tuple[str, int, int, int, int, int, bool]]:
    """(group, in, out channels, blocks, stride, dilation, residual) of each
    of DRN-C's eight groups, from the configuration's ``channels`` and
    ``blocks``; the groups of 0 blocks left out. Every conv of a group has
    the group's dilation (DRN-C's groups 5-8 are not new levels)."""
    if enc.get("arch", "C") != "C":
        raise NotImplementedError(f"DRN arch {enc['arch']!r}")
    ch, blocks = enc["channels"], enc["blocks"]
    plan, cin = [], ch[0]
    for i in range(8):
        if blocks[i]:
            plan.append((f"layer{i + 1}", cin, ch[i], blocks[i], STRIDES[i], DILATIONS[i],
                         RESIDUAL[i]))
            cin = ch[i]
    return plan


def _block_convs(cin, cout, stride, dil, first):
    """(name, weight shape, stride, dilation) of one BasicBlock's convs."""
    convs = [("conv1", (cout, cin if first else cout, 3, 3), stride if first else 1, dil),
             ("conv2", (cout, cout, 3, 3), 1, dil)]
    if first and (stride != 1 or cin != cout):
        convs.append(("downsample_conv", (cout, cin, 1, 1), stride, 1))
    return convs


def _bn_of(conv: str) -> str:
    """The BatchNorm after a trunk's conv: ``conv1`` -> ``bn1``,
    ``downsample_conv`` -> ``downsample_bn``."""
    head, _, tail = conv.rpartition("conv")
    return f"{head}bn{tail}"


def drn_convs(enc: dict, dilated: bool) -> list[tuple[str, tuple, int, int]]:
    """(name, weight shape, stride, dilation) of every conv of one trunk's
    strided levels (conv1, groups 1-4) or dilated levels (groups 5-8 and the
    head), in the order the trunk runs them."""
    plan = drn_plan(enc)
    convs = [] if dilated else [("conv1", (enc["channels"][0], 3, 7, 7), 1, 1)]
    for name, cin, cout, blocks, stride, dil, _ in plan:
        if (int(name[5:]) > N_STRIDED) != dilated:
            continue
        for b in range(blocks):
            convs += [(f"{name}.block{b}.{c}", shape, s, d)
                      for c, shape, s, d in _block_convs(cin, cout, stride, dil, b == 0)]
    if dilated:
        convs.append(("fc", (enc["img_f"], plan[-1][2], 1, 1), 1, 1))
    return convs


def weight_specs(config: dict) -> dict:
    """name -> (shape, how the benchmark draws it) for the detector and the
    generator. The DRN's convs N(0, 1 / fan_in), its head's bias N(0, 0.05^2),
    its BatchNorm scale 1 + N(0, 0.1^2), shift and running mean
    N(0, 0.1^2), running variance exp(N(0, 0.2^2)) (``calibrate`` sets the
    running statistics); the attention and the decoder as the flagship's.

    The last BatchNorm of each residual branch (``bn2`` in groups 1-6) has
    scale 0.1 (1 + N(0, 0.1^2)), as a trained residual network's learns a
    small one (Goyal et al., arXiv:1706.02677, start it at 0). With scale 1
    the 46 conv + BatchNorm layers at random weights carry bfloat16's
    rounding to 40-46% of the trunk's output, so the check's bfloat16
    witness and its float8 control move the image alike (the control read
    1.27-1.48 witnesses on an H100); with 0.1 the witness moves the
    features 6-7% and the control 4-5 times as far as it in the image."""
    specs = dict(unet.weight_specs(f"{DETECTOR}model.", **config["detector"]))
    enc, dec = config["encoder"], config["decoder"]
    residual = {group for group, *_, res in drn_plan(enc) if res}
    for kind in ("src", "ref"):
        p = f"{GENERATOR}{kind}_encoder."
        for name, shape, _, _ in drn_convs(enc, False) + drn_convs(enc, True):
            specs[f"{p}{name}.weight"] = (shape, fan_in_normal(shape))
            if name == "fc":
                specs[f"{p}fc.bias"] = ((shape[0],), WeightSpec("normal", 0.0, 0.05))
                continue
            bn, c = f"{p}{_bn_of(name)}", shape[0]
            branch_end = name.endswith(".conv2") and name.split(".")[0] in residual
            specs[f"{bn}.weight"] = ((c,), WeightSpec("normal", 0.1, 0.01) if branch_end
                                     else WeightSpec("normal", 1.0, 0.1))
            specs[f"{bn}.bias"] = ((c,), WeightSpec("normal", 0.0, 0.1))
            specs[f"{bn}.running_mean"] = ((c,), WeightSpec("normal", 0.0, 0.1))
            specs[f"{bn}.running_var"] = ((c,), WeightSpec("lognormal", 0.0, 0.2))
    feat = enc["img_f"]
    specs[f"{GENERATOR}attention.conv.weight"] = (
        (feat // 4, feat, 1, 1), fan_in_normal((feat // 4, feat, 1, 1)))
    g = f"{GENERATOR}decoder."
    plan = _decoder_plan(dec)
    plan[0] = (2 * feat, plan[0][1])  # block 0 takes the attention's concat
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
    ``mask_share`` of the first four source photos (``unet.calibrate``), and
    set every BatchNorm's running statistics of each trunk to the
    statistics of its input over the first four photos that trunk reads
    (source or reference), as a trained network's are its data's: with
    random running statistics the 20 residual blocks let the activations'
    variance grow block by block. The statistics come from this float32
    reference, so they are a function of the seed alone. Returns the
    entries it changed."""
    changed = unet.calibrate(weights, f"{DETECTOR}model.", batch["src"][:4],
                             config["mask_share"])
    ref = Reference(config, weights, Ops())
    ref.calibrating = True
    for kind in ("src", "ref"):
        ref._drn(kind, batch[kind][:4].permute(0, 3, 1, 2).float())
    changed.update({k: weights[k] for k in ref.calibrated})
    return changed


class Reference(refill_flagship.Reference):
    """The configuration's forward in float32 (or the control's precision)
    over the weights ``w``."""

    def __init__(self, config: dict, w: dict, ops: Ops):
        super().__init__(config, w, ops)
        self.calibrating, self.calibrated = False, []

    # -- the DRN trunk ------------------------------------------------------
    def _bn(self, name, x):
        w = self.w
        if self.calibrating:  # running statistics := this input's (calibrate)
            w[f"{name}.running_mean"] = x.mean(dim=(0, 2, 3))
            w[f"{name}.running_var"] = x.var(dim=(0, 2, 3), correction=0)
            self.calibrated += [f"{name}.running_mean", f"{name}.running_var"]
        return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                            w[f"{name}.weight"], w[f"{name}.bias"], False, 0.0, 1e-5)

    def _dconv(self, name, x, stride=1, dilation=1):
        """A conv with padding (k // 2) x dilation, rounded as ``Ops`` rounds
        a product."""
        w = self.w[f"{name}.weight"]
        q = self.ops.q
        pad = (w.shape[-1] // 2) * dilation
        return q(F.conv2d(q(x), q(w), self.w.get(f"{name}.bias"), stride, pad, dilation))

    def _basic_block(self, p, x, cin, cout, stride, dil, residual, first):
        convs = _block_convs(cin, cout, stride, dil, first)
        _, _, s1, d1 = convs[0]
        out = F.relu(self._bn(f"{p}bn1", self._dconv(f"{p}conv1", x, s1, d1)))
        out = self._bn(f"{p}bn2", self._dconv(f"{p}conv2", out, 1, dil))
        if residual:
            res = x
            if len(convs) == 3:
                res = self._bn(f"{p}downsample_bn", self._dconv(f"{p}downsample_conv", x,
                                                                stride))
            out = out + res
        return F.relu(out)

    def _drn(self, kind, x):
        """One trunk over x [N, 3, H, W] -> features [N, img_f, H/8, W/8]."""
        p = f"{GENERATOR}{kind}_encoder."
        x = F.relu(self._bn(f"{p}bn1", self._dconv(f"{p}conv1", x)))
        for name, cin, cout, blocks, stride, dil, residual in drn_plan(self.config["encoder"]):
            for b in range(blocks):
                x = self._basic_block(f"{p}{name}.block{b}.", x, cin, cout, stride, dil,
                                      residual, b == 0)
        return self._dconv(f"{p}fc", x)

    # -- forward ----------------------------------------------------------
    def generate(self, batch: dict, mask: torch.Tensor) -> torch.Tensor:
        """``batch``: src/ref [N, H, W, 3] in [0, 1] (its noise unread);
        ``mask`` [N, H, W] -> the image [N, out, out, 3] in [-1, 1]."""
        w, ops = self.w, self.ops
        src_f = self._drn("src", batch["src"].permute(0, 3, 1, 2).float())
        ref_f = self._drn("ref", batch["ref"].permute(0, 3, 1, 2).float())
        n, c, h, wd = src_f.shape
        m = bilinear(mask[:, None].float(), (h, wd))
        q = ops.conv2d(src_f, w[f"{GENERATOR}attention.conv.weight"])
        src_att, ref_att = ops.attention(self._flat(q), [self._flat(src_f), self._flat(ref_f)])
        src_att, ref_att = self._unflat(src_att, h, wd), self._unflat(ref_att, h, wd)
        out = torch.cat([(1.0 - m) * ref_att + m * ref_f, src_att], dim=1)
        g = f"{GENERATOR}decoder."
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
