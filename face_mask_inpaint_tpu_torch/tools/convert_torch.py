"""Reference PyTorch checkpoints -> JAX-layout variable trees, in numpy.

The port's own copy of the JAX package's ``tools/convert_torch.py``: the
same numpy code, so that given the same state dict it returns a tree equal
leaf for leaf. ``face_mask_inpaint_tpu_torch.convert`` then maps each tree onto the
port's modules with the rules of ``state_dict_from_jax``.

Covers the pretrained assets the reference depends on: torchvision VGG16
(VGGLoss) and InceptionV3 (FID), the LPIPS trunks and lin heads, ArcFace
ir_se50 (IDLoss and the pSp encoder backbone), StyleGAN2 FFHQ g_ema, the
reference's own UNet/MaskDetector, PICNet latest_net_{G,E,D}, the DRN-C
encoder and pSp combined checkpoints.

Layout transforms:
- conv OIHW            -> HWIO: transpose(2, 3, 1, 0)
- conv-transpose IOHW  -> HWIO: transpose(2, 3, 0, 1)
- linear [out, in]     -> [in, out]: T
- BatchNorm weight/bias/running_mean/running_var -> scale/bias/mean/var
- SpectralNorm-wrapped convs: ``weight_bar`` is the true weight; the u power-
  iteration vector converts directly, v is recomputed as l2norm(W^T u) (sigma
  is invariant to the column flattening order, so one extra iteration
  re-converges it).

Each converter takes a torch-style state dict of numpy arrays (use
``load_torch_state_dict``) and returns a nested dict of numpy arrays under
the flax collection names.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np

__all__ = [
    "load_torch_state_dict",
    "convert_unet",
    "convert_vgg16_features",
    "convert_vgg16_split_features",
    "convert_lpips_alex",
    "convert_lpips",
    "convert_irse_backbone",
    "convert_gradual_style_encoder",
    "convert_stylegan2_generator",
    "convert_picnet_module",
    "convert_drn_c",
    "convert_inception_v3",
    "convert_psp",
]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def load_torch_state_dict(path) -> dict[str, np.ndarray]:
    """Read a .pth into numpy (torch used only for deserialization)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if hasattr(v, "numpy"):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = v
    return out


def strip_module_prefix(sd: dict) -> dict:
    """Drop DataParallel 'module.' prefixes (train_reference_fill.py:117-119)."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def conv_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def convt_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 0, 1))


def linear_w_after_flatten(w: np.ndarray, c: int, h: int, ww: int) -> np.ndarray:
    """torch Linear weight [out, c*h*w] applied after flattening an NCHW map
    -> flax kernel [h*w*c, out] for the NHWC flatten order."""
    out = w.shape[0]
    return np.ascontiguousarray(
        w.reshape(out, c, h, ww).transpose(2, 3, 1, 0).reshape(h * ww * c, out))


def linear_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def bn(sd: dict, prefix: str) -> dict:
    return {
        "scale": sd[f"{prefix}.weight"],
        "bias": sd[f"{prefix}.bias"],
        "mean": sd[f"{prefix}.running_mean"],
        "var": sd[f"{prefix}.running_var"],
    }


def _l2n(v, eps=1e-12):
    return v / (np.linalg.norm(v) + eps)


def sn_conv(sd: dict, prefix: str, transpose: bool = False):
    """SpectralNorm(nn.Conv2d/.ConvTranspose2d) -> (params, spectral).

    Reference SpectralNorm registers weight_bar/weight_u/weight_v on the
    wrapped module (external_function.py:52-68), which lives under
    '<prefix>.module.'.
    """
    base = f"{prefix}.module"
    w = sd[f"{base}.weight_bar"]
    u = sd[f"{base}.weight_u"]
    kernel = convt_w(w) if transpose else conv_w(w)
    if transpose:
        # ConvTranspose2d matricizes with the IN axis as torch does
        # ([in, out*k*k] rows = torch's dim0 = u's axis; nn/layers.py
        # ConvTranspose2d applies the same unfolding) — torch u carries over
        # directly, v is recomputed in our flattening order.
        in_ch = kernel.shape[2]
        w_mat = kernel.transpose(0, 1, 3, 2).reshape(-1, in_ch)
        u_ours = u
        assert u.shape[0] == in_ch, "convT weight_u is on the in axis"
    else:
        out_dim = kernel.shape[-1]
        w_mat = kernel.reshape(-1, out_dim)
        if u.shape[0] == out_dim:
            u_ours = u
        else:
            u_ours = _l2n(np.random.RandomState(0).normal(size=out_dim))
            for _ in range(50):
                v_it = _l2n(w_mat @ u_ours)
                u_ours = _l2n(w_mat.T @ v_it)
    v_ours = _l2n(w_mat @ u_ours)
    params = {"kernel": kernel}
    if f"{base}.bias" in sd:
        params["bias"] = sd[f"{base}.bias"]
    return params, {"u": _l2n(u_ours), "v": v_ours}


def plain_conv(sd: dict, prefix: str):
    p = {"kernel": conv_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


# ---------------------------------------------------------------------------
# UNet / MaskDetector (modules/unet)
# ---------------------------------------------------------------------------

def _double_conv(sd, prefix):
    return {
        "conv1": plain_conv(sd, f"{prefix}.0"),
        "bn1": {"bn": bn(sd, f"{prefix}.1")},
        "conv2": plain_conv(sd, f"{prefix}.3"),
        "bn2": {"bn": bn(sd, f"{prefix}.4")},
    }


def convert_unet(sd: dict, bilinear: bool = True) -> dict:
    """MaskDetector state dict ('model.' prefixed UNet) -> flax variables."""
    sd = strip_module_prefix(sd)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def split(tree):
        params, stats = {}, {}
        for k, v in tree.items():
            if isinstance(v, dict):
                p, s = split(v)
                if p:
                    params[k] = p
                if s:
                    stats[k] = s
            elif k in ("mean", "var"):
                stats[k] = v
            else:
                params[k] = v
        return params, stats

    tree: dict[str, Any] = {"inc": _double_conv(sd, "inc.double_conv")}
    for i in range(1, 5):
        tree[f"down{i}"] = {"conv": _double_conv(sd, f"down{i}.maxpool_conv.1.double_conv")}
    for i in range(1, 5):
        up = {"conv": _double_conv(sd, f"up{i}.conv.double_conv")}
        if not bilinear:
            up["up"] = {
                "kernel": convt_w(sd[f"up{i}.up.weight"]),
                "bias": sd[f"up{i}.up.bias"],
            }
        tree[f"up{i}"] = up
    tree["outc"] = plain_conv(sd, "outc.conv")

    params, stats = split(tree)
    return {
        "params": {"model": params},
        "batch_stats": {"model": stats},
    }


# ---------------------------------------------------------------------------
# VGG16 features (torchvision) for VGGLoss
# ---------------------------------------------------------------------------

_VGG_IDX = {
    "conv1_1": 0, "conv1_2": 2,
    "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
    "conv4_1": 17, "conv4_2": 19, "conv4_3": 21,
}


def convert_vgg16_features(sd: dict) -> dict:
    """torchvision vgg16 state dict -> VGG16Features params (up to relu4_3)."""
    params = {}
    for name, idx in _VGG_IDX.items():
        params[name] = {
            "kernel": conv_w(sd[f"features.{idx}.weight"]),
            "bias": sd[f"features.{idx}.bias"],
        }
    return params


_VGG_SPLIT_IDX = dict(_VGG_IDX, conv5_1=24, conv5_2=26, conv5_3=28)


def convert_vgg16_split_features(sd: dict) -> dict:
    """torchvision vgg16 -> VGG16SplitFeatures params (full 13-conv trunk for
    the get_features splitter, external_function.py:215-229)."""
    params = {}
    for name, idx in _VGG_SPLIT_IDX.items():
        params[name] = {
            "kernel": conv_w(sd[f"features.{idx}.weight"]),
            "bias": sd[f"features.{idx}.bias"],
        }
    return params


# ---------------------------------------------------------------------------
# LPIPS (alexnet trunk + lin heads)
# ---------------------------------------------------------------------------

_ALEX_IDX = {"conv1": 0, "conv2": 3, "conv3": 6, "conv4": 8, "conv5": 10}


def convert_lpips_alex(alexnet_sd: dict, lin_sd: dict) -> dict:
    """torchvision alexnet + richzhang lin weights -> LPIPSNet('alex') params.

    lin_sd uses the renamed keys of lpips/utils.py:22-30 ('0.1.weight', ...).
    """
    params = {"trunk": {}}
    for name, idx in _ALEX_IDX.items():
        params["trunk"][name] = {
            "kernel": conv_w(alexnet_sd[f"features.{idx}.weight"]),
            "bias": alexnet_sd[f"features.{idx}.bias"],
        }
    for i in range(5):
        key = f"{i}.1.weight" if f"{i}.1.weight" in lin_sd else f"{i}.weight"
        params[f"lin{i}"] = {"kernel": conv_w(lin_sd[key])}
    return params


# LPIPS squeeze trunk: torchvision squeezenet1_1.features indices of the
# Fire modules tapped by lpips/networks.py (squeeze has 7 taps/lin heads)
_SQUEEZE_FIRE_IDX = {"fire3": 3, "fire4": 4, "fire6": 6, "fire7": 7,
                     "fire9": 9, "fire10": 10, "fire11": 11, "fire12": 12}
# LPIPS vgg trunk uses the full conv5 range (taps after relu{1_2..5_3})
_VGG16_FULL_IDX = dict(_VGG_IDX, **{"conv5_1": 24, "conv5_2": 26,
                                    "conv5_3": 28})
_LPIPS_N_LINS = {"alex": 5, "vgg": 5, "squeeze": 7}


def convert_lpips(trunk_sd: dict, lin_sd: dict, net_type: str = "alex") -> dict:
    """torchvision trunk (alexnet / squeezenet1_1 / vgg16) + richzhang lin
    weights -> LPIPSNet(net_type) params (reference lpips/networks.py:66-95
    supports all three; lin key renames per lpips/utils.py:22-30)."""
    params = {"trunk": {}}
    if net_type == "alex":
        for name, idx in _ALEX_IDX.items():
            params["trunk"][name] = {
                "kernel": conv_w(trunk_sd[f"features.{idx}.weight"]),
                "bias": trunk_sd[f"features.{idx}.bias"],
            }
    elif net_type == "vgg":
        for name, idx in _VGG16_FULL_IDX.items():
            params["trunk"][name] = {
                "kernel": conv_w(trunk_sd[f"features.{idx}.weight"]),
                "bias": trunk_sd[f"features.{idx}.bias"],
            }
    elif net_type == "squeeze":
        params["trunk"]["conv1"] = {
            "kernel": conv_w(trunk_sd["features.0.weight"]),
            "bias": trunk_sd["features.0.bias"],
        }
        for name, idx in _SQUEEZE_FIRE_IDX.items():
            params["trunk"][name] = {
                sub: {
                    "kernel": conv_w(trunk_sd[f"features.{idx}.{sub}.weight"]),
                    "bias": trunk_sd[f"features.{idx}.{sub}.bias"],
                }
                for sub in ("squeeze", "expand1x1", "expand3x3")
            }
    else:
        raise NotImplementedError(net_type)
    for i in range(_LPIPS_N_LINS[net_type]):
        key = f"{i}.1.weight" if f"{i}.1.weight" in lin_sd else f"{i}.weight"
        params[f"lin{i}"] = {"kernel": conv_w(lin_sd[key])}
    return params


# ---------------------------------------------------------------------------
# IR-SE-50 (ArcFace / pSp encoder backbone)
# ---------------------------------------------------------------------------

def _irse_unit(sd, prefix, use_se=True):
    unit = {
        "bn0": {"bn": bn(sd, f"{prefix}.res_layer.0")},
        "conv1": plain_conv(sd, f"{prefix}.res_layer.1"),
        "prelu": {"alpha": sd[f"{prefix}.res_layer.2.weight"]},
        "conv2": plain_conv(sd, f"{prefix}.res_layer.3"),
        "bn2": {"bn": bn(sd, f"{prefix}.res_layer.4")},
    }
    if use_se and f"{prefix}.res_layer.5.fc1.weight" in sd:
        unit["se"] = {
            "fc1": plain_conv(sd, f"{prefix}.res_layer.5.fc1"),
            "fc2": plain_conv(sd, f"{prefix}.res_layer.5.fc2"),
        }
    if f"{prefix}.shortcut_layer.0.weight" in sd:
        unit["shortcut_conv"] = plain_conv(sd, f"{prefix}.shortcut_layer.0")
        unit["shortcut_bn"] = {"bn": bn(sd, f"{prefix}.shortcut_layer.1")}
    return unit


def _irse_trunk(sd, n_units=24):
    input_layer = {
        "conv": plain_conv(sd, "input_layer.0"),
        "bn": {"bn": bn(sd, "input_layer.1")},
        # reference input_layer = Sequential(Conv2d, BatchNorm2d, PReLU):
        # the PReLU is index 2 (model_irse.py:20-21, psp_encoders.py:51-53)
        "prelu": {"alpha": sd.get("input_layer.2.weight",
                                  sd.get("input_layer.3.weight"))},
    }
    body = {f"body_{i}": _irse_unit(sd, f"body.{i}") for i in range(n_units)}
    return input_layer, body


def convert_irse_backbone(sd: dict, input_size: int = 112) -> dict:
    """ir_se50 ArcFace state dict -> Backbone variables (models/irse.py)."""
    input_layer, body = _irse_trunk(sd)
    params = {
        "input_layer": input_layer,
        "body": body,
        "out_bn": {"bn": bn(sd, "output_layer.0")},
        "out_linear": {
            # torch flattens NCHW (c,h,w); the flax Backbone flattens NHWC
            "kernel": linear_w_after_flatten(
                sd["output_layer.3.weight"], 512,
                input_size // 16, input_size // 16),
            "bias": sd["output_layer.3.bias"],
        },
    }
    stats: dict[str, Any] = {}
    # BatchNorm1d(512) after the linear; affine=True in IDLoss's Backbone
    if "output_layer.4.weight" in sd:
        params["out_bn1d_scale"] = sd["output_layer.4.weight"]
        params["out_bn1d_bias"] = sd["output_layer.4.bias"]
    stats["out_bn1d_mean"] = sd["output_layer.4.running_mean"]
    stats["out_bn1d_var"] = sd["output_layer.4.running_var"]

    params, bstats = _split_bn(params)
    bstats.update(stats)
    return {"params": params, "batch_stats": bstats}


def _split_bn(tree):
    """Pull {'bn': {scale,bias,mean,var}} leaves apart into params/batch_stats."""
    params, stats = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if set(v.keys()) == {"bn"}:
                params[k] = {"bn": {"scale": v["bn"]["scale"], "bias": v["bn"]["bias"]}}
                stats[k] = {"bn": {"mean": v["bn"]["mean"], "var": v["bn"]["var"]}}
            else:
                p, s = _split_bn(v)
                params[k] = p
                if s:
                    stats[k] = s
        else:
            params[k] = v
    return params, stats


def convert_gradual_style_encoder(sd: dict, n_styles: int = 18) -> dict:
    """pSp GradualStyleEncoder state dict -> flax variables.

    Also accepts a bare ir_se50 checkpoint (strict=False semantics,
    psp.py:58-60): only the backbone keys convert, style heads stay at init.
    """
    input_layer, body = _irse_trunk(sd)
    params: dict[str, Any] = {"input_layer": input_layer, "body": body}
    for j in range(n_styles):
        pre = f"styles.{j}"
        if f"{pre}.convs.0.weight" not in sd:
            continue
        block: dict[str, Any] = {}
        i = 0
        while f"{pre}.convs.{2 * i}.weight" in sd:
            block[f"conv{i}"] = plain_conv(sd, f"{pre}.convs.{2 * i}")
            i += 1
        block["linear"] = {
            "weight": linear_w(sd[f"{pre}.linear.weight"]),
            "bias": sd[f"{pre}.linear.bias"],
        }
        params[f"styles_{j}"] = block
    for lat in ("latlayer1", "latlayer2"):
        if f"{lat}.weight" in sd:
            params[lat] = plain_conv(sd, lat)
    for att, ours in (("attention1", "attention1"), ("attention2", "attention2")):
        if f"{att}.conv.weight" in sd:
            params[ours] = {
                "conv": plain_conv(sd, f"{att}.conv"),
                "out_conv": plain_conv(sd, f"{att}.out_conv"),
            }
    params, stats = _split_bn(params)
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# StyleGAN2 generator (g_ema)
# ---------------------------------------------------------------------------

def _modulated(sd, prefix):
    w = sd[f"{prefix}.weight"]  # [1, out, in, k, k]
    return {
        "weight": conv_w(w[0]),
        "modulation": {
            "weight": linear_w(sd[f"{prefix}.modulation.weight"]),
            "bias": sd[f"{prefix}.modulation.bias"],
        },
    }


def _styled_conv(sd, prefix):
    return {
        "conv": _modulated(sd, f"{prefix}.conv"),
        "noise": {"weight": sd[f"{prefix}.noise.weight"]},
        "activate_bias": sd[f"{prefix}.activate.bias"],
    }


def _to_rgb(sd, prefix):
    return {
        "conv": _modulated(sd, f"{prefix}.conv"),
        "bias": sd[f"{prefix}.bias"].reshape(-1),
    }


def convert_stylegan2_generator(sd: dict, size: int = 1024) -> dict:
    """StyleGAN2 g_ema state dict -> Generator variables (incl. noise buffers)."""
    import math

    params: dict[str, Any] = {"input": sd["input.input"].transpose(0, 2, 3, 1)}
    n_mlp = 0
    while f"style.{n_mlp + 1}.weight" in sd:
        n_mlp += 1
    for i in range(1, n_mlp + 1):
        params[f"style_{i}"] = {
            "weight": linear_w(sd[f"style.{i}.weight"]),
            "bias": sd[f"style.{i}.bias"],
        }
    params["conv1"] = _styled_conv(sd, "conv1")
    params["to_rgb1"] = _to_rgb(sd, "to_rgb1")

    log_size = int(math.log2(size))
    n_pairs = log_size - 2
    for i in range(2 * n_pairs):
        params[f"convs_{i}"] = _styled_conv(sd, f"convs.{i}")
    for i in range(n_pairs):
        params[f"to_rgbs_{i}"] = _to_rgb(sd, f"to_rgbs.{i}")

    noises = {}
    num_layers = (log_size - 2) * 2 + 1
    for i in range(num_layers):
        key = f"noises.noise_{i}"
        if key in sd:
            noises[f"noise_{i}"] = sd[key].transpose(0, 2, 3, 1)
    out = {"params": params}
    if noises:
        out["noises"] = noises
    return out


# ---------------------------------------------------------------------------
# PICNet (Stack A) modules — spectral-norm heavy
# ---------------------------------------------------------------------------

def convert_picnet_module(sd: dict) -> dict:
    """Generic converter for PICNet ResEncoder/ResGenerator/ResDiscriminator
    checkpoints (latest_net_{G,E,D}.pth): walks the key space, converting
    every '<path>.module.weight_bar' (spectral conv) and plain conv/linear.

    Returns {'params', 'spectral'} trees keyed by the torch module path with
    '.' -> nested dicts, matching our flax module names (block0.conv1 ->
    block0/conv1/conv for CoordConvWrap-wrapped convs).
    """
    sd = strip_module_prefix(sd)
    params: dict[str, Any] = {}
    spectral: dict[str, Any] = {}

    def assign(tree, path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    sn_prefixes = sorted({
        k[: -len(".module.weight_bar")]
        for k in sd
        if k.endswith(".module.weight_bar")
    })
    consumed = set()
    for prefix in sn_prefixes:
        transpose = sd[f"{prefix}.module.weight_bar"].ndim == 4 and _is_convt(prefix)
        p, s = sn_conv(sd, prefix, transpose=transpose)
        path = prefix.split(".")
        # CoordConvWrap adds a 'conv' level for ResBlock convs; ResBlockDecoder
        # and the final D conv are plain spectral convs (no wrapper).
        if _is_wrapped(path):
            assign(params, path + ["conv"], p)
            assign(spectral, path + ["conv"], s)
        else:
            assign(params, path, p)
            assign(spectral, path, s)
        for suffix in ("weight_bar", "weight_u", "weight_v", "bias"):
            consumed.add(f"{prefix}.module.{suffix}")

    for k, v in sd.items():
        if k in consumed or k.endswith(("weight_u", "weight_v")):
            continue
        path = k.split(".")
        leaf_name = path[-1]
        if leaf_name == "weight" and v.ndim == 4:
            assign(params, path[:-1] + ["kernel"], conv_w(v))
        elif leaf_name == "weight" and v.ndim == 2:
            assign(params, path[:-1] + ["kernel"], linear_w(v))
        elif leaf_name == "weight" and v.ndim == 1:
            # InstanceNorm2d(affine=True) scale (ResBlockDecoder norms)
            assign(params, path[:-1] + ["scale"], v)
        elif leaf_name in ("gamma", "alpha"):
            assign(params, path, v)
        elif leaf_name == "bias":
            assign(params, path, v)
    return {"params": params, "spectral": spectral}


def _is_convt(prefix: str) -> bool:
    """ResBlockDecoder conv2/bypass are the only transposed convs in PICNet."""
    return bool(re.search(r"decoder\d+\.(conv2|bypass)$", prefix)) or bool(
        re.search(r"\.(conv2|bypass)$", prefix) and "decoder" in prefix
    )


def _is_wrapped(path: list[str]) -> bool:
    """convs created via coord_conv get a CoordConvWrap 'conv' sublevel."""
    return path[-1] in ("conv1", "conv2", "bypass") and not (
        len(path) > 1 and path[-2].startswith("decoder")
    )


# ---------------------------------------------------------------------------
# DRN-C (alternative ReferenceFill encoder; pretrained at dl.yf.io, drn.py:15)
# ---------------------------------------------------------------------------

def convert_drn_c(sd: dict, layers=(1, 1, 3, 4, 6, 3, 1, 1)) -> dict:
    """drn_c_* state dict -> models/drn.DRN variables (arch 'C', BasicBlock).

    The replaced 1x1 'fc' head (modules/model.py:50-55) converts when present.
    """
    params: dict[str, Any] = {
        "conv1": plain_conv(sd, "conv1"),
        "bn1": {"bn": bn(sd, "bn1")},
    }

    def basic_block(prefix):
        blk = {
            "conv1": plain_conv(sd, f"{prefix}.conv1"),
            "bn1": {"bn": bn(sd, f"{prefix}.bn1")},
            "conv2": plain_conv(sd, f"{prefix}.conv2"),
            "bn2": {"bn": bn(sd, f"{prefix}.bn2")},
        }
        if f"{prefix}.downsample.0.weight" in sd:
            blk["downsample_conv"] = plain_conv(sd, f"{prefix}.downsample.0")
            blk["downsample_bn"] = {"bn": bn(sd, f"{prefix}.downsample.1")}
        return blk

    for li, n_blocks in enumerate(layers, start=1):
        if n_blocks == 0:
            continue
        group = {}
        for bi in range(n_blocks):
            group[f"block{bi}"] = basic_block(f"layer{li}.{bi}")
        params[f"layer{li}"] = group
    if "fc.weight" in sd and sd["fc.weight"].ndim == 4:
        params["fc"] = plain_conv(sd, "fc")
    params, stats = _split_bn(params)
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# InceptionV3 (FID)
# ---------------------------------------------------------------------------

def convert_inception_v3(sd: dict) -> dict:
    """torchvision inception_v3 state dict -> InceptionV3Features variables.

    Branch/block names match the torch attribute names exactly, so the
    conversion is mechanical: every '<path>.conv.weight' becomes a kernel and
    '<path>.bn.*' splits into params (scale/bias) + batch_stats (mean/var).
    AuxLogits / fc are dropped (the FID trunk stops at Mixed_7c).
    """
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    def assign(tree, path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    for k, v in sd.items():
        if k.startswith(("AuxLogits", "fc")):
            continue
        path = k.split(".")
        if path[-2] == "conv" and path[-1] == "weight":
            assign(params, path[:-1] + ["kernel"], conv_w(v))
        elif path[-2] == "bn":
            if path[-1] == "weight":
                assign(params, path[:-1] + ["scale"], v)
            elif path[-1] == "bias":
                assign(params, path, v)
            elif path[-1] == "running_mean":
                assign(stats, path[:-1] + ["mean"], v)
            elif path[-1] == "running_var":
                assign(stats, path[:-1] + ["var"], v)
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# pSp combined checkpoint
# ---------------------------------------------------------------------------

def get_keys(sd: dict, name: str) -> dict:
    """Prefix filter (psp.py:14-17)."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len(name) + 1:]: v for k, v in sd.items() if k[: len(name)] == name}


def convert_psp(sd: dict, output_size: int = 1024) -> dict:
    """Combined pSp checkpoint -> PSP variables (encoder + decoder +
    latent_avg), mirroring pSp.load_weights (psp.py:50-70)."""
    import math

    n_styles = int(math.log2(output_size)) * 2 - 2
    enc = convert_gradual_style_encoder(get_keys(sd, "encoder"), n_styles)
    dec = convert_stylegan2_generator(get_keys(sd, "decoder"), output_size)
    variables: dict[str, Any] = {
        "params": {"encoder": enc["params"], "decoder": dec["params"]},
        "batch_stats": {"encoder": enc.get("batch_stats", {})},
    }
    if "noises" in dec:
        variables["noises"] = {"decoder": dec["noises"]}
    if "latent_avg" in sd:
        variables["latent_avg"] = {"value": np.asarray(sd["latent_avg"])}
    return variables
