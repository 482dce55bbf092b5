"""JAX variables of the reference package -> this port's ``state_dict``.

The JAX variables are a nested dict of arrays under the collections
``params``, ``spectral``, ``batch_stats``, ``noises`` and ``latent_avg``. The
port's submodules carry the flax module names, so each leaf's path, joined
with dots, is its state_dict key; the rules below only rename leaves and
change layouts:

- conv kernel HWIO -> OIHW, transposed-conv kernel HWIO -> IOHW (the port
  module at the path says which it is); Dense kernel [in, out] -> weight
  [out, in];
- StyleGAN2 ``weight``: EqualLinear [in, out] -> [out, in], EqualConv2d and
  ModulatedConv2d HWIO -> OIHW, NoiseInjection's scalar as it is; the
  generator's ``input`` constant NHWC -> NCHW; ``activate_bias`` and PReLU's
  ``alpha`` as they are;
- the generator's fixed noise maps ``noises/noise_<i>`` [1, H, W, 1] ->
  buffers ``noise_<i>`` [1, 1, H, W]; pSp's ``latent_avg/value`` -> the
  buffer ``latent_avg``;
- instance-norm and batch-norm ``scale``/``bias`` -> ``weight``/``bias``;
- the ArcFace ``Backbone``'s BatchNorm1d leaves ``out_bn1d_{scale,bias}``
  and ``out_bn1d_{mean,var}`` as they are;
- batch-norm ``mean``/``var`` -> ``running_mean``/``running_var``; flax's
  ``BatchNorm2d`` wraps an ``nn.BatchNorm`` named ``bn``, a level the port's
  BatchNorm2d does not have;
- spectral ``u`` and ``v`` -> buffers of the same names and layout.

The result loads with ``load_state_dict(strict=True)``; ``merge_from_jax``
is the partial form of the JAX CLIs' merge (each leaf whose key and shape
match is copied). ``jax_leading_dims``
reads the same layout rules the other way: it says which port dimension
holds each JAX leaf's axis 0, for the Ranger optimizer's centralization.

``vgg16_state_dict_from_torchvision`` maps torchvision's ``vgg16()`` layout
(``features.<index>.weight``, OIHW already) onto ``VGG16Features``, the
port's counterpart of the JAX ``tools/convert_torch.convert_vgg16_features``.

Reference checkpoints (the reference's ``.pth``/``.pt`` state dicts) take
two steps: the port's copy of the JAX converter (``tools/convert_torch.py``)
turns them into JAX-layout variables, and the rules above into the port's
keys. ``read_checkpoint`` and ``load_checkpoint`` are the one loader every
CLI calls; they tell a file's kind by its content, not its suffix:

- a dict whose keys are exactly the model's ``state_dict()`` keys is the
  port's own and loads with ``strict=True``;
- a reference state dict (raw or under ``"state_dict"``, with or without
  ``module.`` prefixes) goes through its converter, and is either loaded
  whole (``strict=True``) or merged by key and shape;
- a directory (an Orbax checkpoint of the JAX trainers) raises
  ``NotImplementedError``; anything else raises ``ValueError`` naming the
  path.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence

import logging
import pickle
from pathlib import Path

import numpy as np
import torch
from torch import nn

from face_mask_inpaint_tpu_torch.evaluations.fid import InceptionV3Features

from face_mask_inpaint_tpu_torch.losses.lpips import LPIPSNet
from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
from face_mask_inpaint_tpu_torch.models.drn import DRN
from face_mask_inpaint_tpu_torch.models.irse import Backbone, GradualStyleEncoder
from face_mask_inpaint_tpu_torch.models.picnet import PatchDiscriminator, ResDiscriminator
from face_mask_inpaint_tpu_torch.models.psp import PSP
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.models.stylegan2 import (
    EqualConv2d, EqualLinear, Generator, ModulatedConv2d, NoiseInjection)
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.nn.layers import BatchNorm2d, Conv2d, ConvTranspose2d, Dense

__all__ = ["state_dict_from_jax", "convert_mask_detector", "convert_reference_fill",
           "convert_drn", "convert_discriminator", "convert_vgg16",
           "vgg16_state_dict_from_torchvision", "convert_stylegan2_generator", "convert_gradual_style_encoder", "convert_psp",
           "convert_lpips", "convert_backbone", "convert_inception", "jax_leading_dims",
           "merge_from_jax", "read_checkpoint", "load_checkpoint"]

# torchvision vgg16().features index of each conv in features[:23]
_VGG16_TORCHVISION = {0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
                      10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
                      17: "conv4_1", 19: "conv4_2", 21: "conv4_3"}

_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("params", "gamma"): "gamma",
    ("params", "alpha"): "alpha",
    ("params", "weight"): "weight",
    ("params", "input"): "input",
    ("params", "activate_bias"): "activate_bias",
    ("params", "out_bn1d_scale"): "out_bn1d_scale",
    ("params", "out_bn1d_bias"): "out_bn1d_bias",
    ("batch_stats", "out_bn1d_mean"): "out_bn1d_mean",
    ("batch_stats", "out_bn1d_var"): "out_bn1d_var",
    ("latent_avg", "value"): "latent_avg",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    ("spectral", "u"): "u",
    ("spectral", "v"): "v",
}


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _perm(module: nn.Module, key: str) -> Optional[tuple[int, ...]]:
    """The transpose that takes the JAX leaf of the port parameter ``key``
    of ``module`` to the port's layout (port dim d holds JAX axis perm[d]),
    or None where the layouts agree."""
    if key == "weight":
        if isinstance(module, ConvTranspose2d):
            return 2, 3, 0, 1
        if isinstance(module, (Conv2d, EqualConv2d, ModulatedConv2d)):
            return 3, 2, 0, 1
        if isinstance(module, (Dense, EqualLinear)):
            return 1, 0
    if key == "input":
        return 0, 3, 1, 2
    return None


def _layout(collection: str, name: str, module: nn.Module, prefix: str,
            arr: np.ndarray) -> np.ndarray:
    """The leaf in the port module's layout."""
    if collection != "params":
        return arr
    owners = {"kernel": (Conv2d, ConvTranspose2d, Dense),
              "weight": (EqualLinear, EqualConv2d, ModulatedConv2d, NoiseInjection)}
    if name in owners and not isinstance(module, owners[name]):
        raise TypeError(f"{name} at {prefix} belongs to {type(module).__name__}")
    perm = _perm(module, _LEAF_NAMES[(collection, name)])
    return arr if perm is None else arr.transpose(perm)


def jax_leading_dims(model: nn.Module) -> dict[str, int]:
    """For each parameter of two or more dimensions whose layout differs
    from the JAX leaf's: the dimension of the port tensor that holds the JAX
    leaf's axis 0 (the H of an HWIO conv kernel, the ``in`` of an [in, out]
    dense one). Where the layouts agree it is dim 0."""
    dims = {}
    for name, p in model.named_parameters():
        prefix, _, key = name.rpartition(".")
        perm = _perm(model.get_submodule(prefix), key)
        if p.dim() >= 2:
            dims[name] = perm.index(0) if perm is not None else 0
    return dims


def _port_leaves(model: nn.Module, variables: dict, strict: bool = True
                 ) -> Iterator[tuple[Optional[str], Optional[np.ndarray]]]:
    """(state_dict key, array in the port's layout) for every leaf of
    ``variables``; with ``strict=False`` a leaf that maps onto no module of
    ``model`` gives (None, None) instead of raising."""
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            *mods, name = path
            try:
                if (mods and mods[-1] == "bn" and isinstance(
                        model.get_submodule(".".join(mods[:-1])), BatchNorm2d)):
                    mods = mods[:-1]
                prefix = ".".join(mods)
                module = model.get_submodule(prefix)
                arr = np.array(leaf, dtype=np.float32)
                if collection == "noises":  # [1, H, W, 1] -> [1, 1, H, W]
                    key, arr = name, arr.transpose(0, 3, 1, 2)
                elif (collection, name) in _LEAF_NAMES:
                    key = _LEAF_NAMES[(collection, name)]
                    arr = _layout(collection, name, module, prefix, arr)
                else:
                    raise KeyError(f"no rule for {collection}/{'/'.join(path)}")
            except (AttributeError, KeyError, TypeError, ValueError):
                if strict:
                    raise
                yield None, None
                continue
            yield (f"{prefix}.{key}" if prefix else key), np.ascontiguousarray(arr)


def state_dict_from_jax(model: nn.Module, variables: dict) -> dict[str, torch.Tensor]:
    """Map every leaf of ``variables`` onto ``model``'s state_dict keys."""
    return {k: torch.from_numpy(a) for k, a in _port_leaves(model, variables)}


def merge_from_jax(model: nn.Module, variables: dict) -> int:
    """The JAX CLIs' merge (``PICNet_inference.py:123-131``,
    ``psp_inference.py:107-127``): copy each leaf of ``variables`` whose port
    key exists in ``model`` with the same shape; leave the rest of the model
    as it is. Returns the number of leaves copied."""
    own = model.state_dict()
    merged = 0
    with torch.no_grad():
        for key, arr in _port_leaves(model, variables, strict=False):
            if key in own and tuple(own[key].shape) == arr.shape:
                own[key].copy_(torch.from_numpy(arr))
                merged += 1
    return merged


def convert_mask_detector(model: MaskDetector, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``MaskDetector`` variables (params + batch_stats) -> state_dict."""
    if not isinstance(model, MaskDetector):
        raise TypeError(f"expected a MaskDetector, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_reference_fill(model: ReferenceFill, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``ReferenceFill`` variables (params + spectral, and batch_stats
    with the DRN encoder) -> state_dict."""
    if not isinstance(model, ReferenceFill):
        raise TypeError(f"expected a ReferenceFill, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_drn(model: DRN, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``DRN`` variables (params + batch_stats), or the tree of
    ``tools/convert_torch.convert_drn_c``, -> state_dict."""
    if not isinstance(model, DRN):
        raise TypeError(f"expected a DRN, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_discriminator(model: nn.Module, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``ResDiscriminator``/``PatchDiscriminator`` variables (params +
    spectral) -> state_dict."""
    if not isinstance(model, (ResDiscriminator, PatchDiscriminator)):
        raise TypeError(f"expected a discriminator, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_vgg16(model: VGG16Features, params: dict) -> dict[str, torch.Tensor]:
    """JAX ``VGG16Features`` params -> state_dict."""
    if not isinstance(model, VGG16Features):
        raise TypeError(f"expected a VGG16Features, got {type(model).__name__}")
    return state_dict_from_jax(model, {"params": params})


def convert_stylegan2_generator(model: Generator, variables: dict) -> dict[str, torch.Tensor]:
    """JAX StyleGAN2 ``Generator`` variables (params + noises) -> state_dict."""
    if not isinstance(model, Generator):
        raise TypeError(f"expected a Generator, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_gradual_style_encoder(model: GradualStyleEncoder,
                                  variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``GradualStyleEncoder`` variables (params + batch_stats) -> state_dict."""
    if not isinstance(model, GradualStyleEncoder):
        raise TypeError(f"expected a GradualStyleEncoder, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_psp(model: PSP, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``PSP`` variables (params, batch_stats, noises, latent_avg) ->
    state_dict."""
    if not isinstance(model, PSP):
        raise TypeError(f"expected a PSP, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_lpips(model: LPIPSNet, params: dict) -> dict[str, torch.Tensor]:
    """JAX ``LPIPSNet`` params (trunk and lin heads) -> state_dict."""
    if not isinstance(model, LPIPSNet):
        raise TypeError(f"expected an LPIPSNet, got {type(model).__name__}")
    return state_dict_from_jax(model, {"params": params})


def convert_backbone(model: Backbone, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ArcFace ``Backbone`` variables (params + batch_stats, the
    BatchNorm1d's ``out_bn1d_*`` included) -> state_dict."""
    if not isinstance(model, Backbone):
        raise TypeError(f"expected a Backbone, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_inception(model: InceptionV3Features, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``InceptionV3Features`` variables (params + batch_stats) -> state_dict."""
    if not isinstance(model, InceptionV3Features):
        raise TypeError(f"expected an InceptionV3Features, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def vgg16_state_dict_from_torchvision(sd: dict) -> dict[str, torch.Tensor]:
    """A torchvision ``vgg16()`` state_dict (or its ``features`` part, with or
    without the ``features.`` prefix) -> ``VGG16Features`` state_dict."""
    out = {}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "features":
            parts = parts[1:]
        if len(parts) != 2 or not parts[0].isdigit():
            continue  # the classifier, or another module's keys
        name = _VGG16_TORCHVISION.get(int(parts[0]))
        if name is not None:
            out[f"{name}.{parts[1]}"] = torch.as_tensor(value).float().contiguous()
    if len(out) != 2 * len(_VGG16_TORCHVISION):
        raise KeyError(f"expected the {len(_VGG16_TORCHVISION)} convs of vgg16().features[:23], "
                       f"found {len(out) // 2}")
    return out


# -- the CLIs' loader ----------------------------------------------------------

_ORBAX = ("is a directory: Orbax checkpoints of the JAX trainers do not load in the port "
          "(ROADMAP.md queue 1, item 3c)")


def _flat_tensors(obj: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Tensor leaves of nested dicts, keys joined with dots (a rosinality
    StyleGAN2 file nests ``g_ema``); other leaves are dropped."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flat_tensors(v, f"{prefix}{k}."))
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        out[prefix[:-1]] = torch.as_tensor(obj)
    return out


def read_checkpoint(path, what: str) -> Optional[dict[str, torch.Tensor]]:
    """The tensors of the checkpoint at ``path`` on the CPU, or None (with a
    warning) where ``path`` is empty or names nothing. A state dict under a
    ``"state_dict"`` key is taken from there, as the JAX converter's
    ``load_torch_state_dict`` takes it. Raises for a directory and for a file
    that holds no state dict."""
    if not path:
        return None
    p = Path(path)
    if p.is_dir():
        raise NotImplementedError(f"{what} checkpoint {path} {_ORBAX}")
    if not p.exists():
        logging.warning('%s checkpoint %s not found; using random init', what, path)
        return None
    try:
        obj = torch.load(p, map_location="cpu", weights_only=False)
    except (pickle.UnpicklingError, EOFError, RuntimeError) as e:
        raise ValueError(f"{what} checkpoint {path} is not a PyTorch checkpoint: {e}") from e
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    state = _flat_tensors(obj)
    if not state:
        raise ValueError(f"{what} checkpoint {path} holds no state dict")
    return state


def load_checkpoint(model: nn.Module, state: dict[str, torch.Tensor],
                    convert_reference: Callable[[dict], dict], what: str, path="",
                    merge: Optional[Sequence[str]] = None) -> str:
    """Load ``state`` (from ``read_checkpoint``) into ``model``.

    The port's own state dict (exactly the model's keys) loads strictly. Any
    other is a reference state dict: ``module.`` prefixes go, its tensors go
    to numpy, ``convert_reference`` (a converter of ``tools/convert_torch``)
    makes JAX-layout variables of it, and these load strictly, or, with
    ``merge`` naming the collections to take, merge by key and shape with
    "Merged m/n" logged. Returns "port" or "reference"."""
    if set(state) == set(model.state_dict()):
        model.load_state_dict(state, strict=True)
        logging.info('Loaded %s from %s (the port\'s own state dict)', what, path)
        return "port"
    if all(k.startswith("module.") for k in state):
        state = {k[len("module."):]: v for k, v in state.items()}
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()}
    try:
        variables = convert_reference(sd)
    except KeyError as e:
        raise ValueError(f"{what} checkpoint {path} is neither the port's state dict nor a "
                         f"reference one of this model (no key {e})") from e
    if merge is None:
        model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
        logging.info('Converted %s from the reference checkpoint %s', what, path)
    else:
        merged = merge_from_jax(model, {c: variables[c] for c in merge if c in variables})
        # the JAX CLIs count the model's leaves of the merged collections
        total = (len(list(model.parameters())) if tuple(merge) == ("params",)
                 else len(model.state_dict()))
        logging.info('Merged %d/%d converted tensors of %s from %s', merged, total, what, path)
    return "reference"
