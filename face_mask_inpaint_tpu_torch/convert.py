"""JAX variables of the reference package -> this port's ``state_dict``.

The JAX variables are a nested dict of arrays under the collections
``params``, ``spectral`` and ``batch_stats``. The port's submodules carry the
flax module names, so each leaf's path, joined with dots, is its state_dict
key; the rules below only rename leaves and change layouts:

- conv kernel HWIO -> OIHW, transposed-conv kernel HWIO -> IOHW (the port
  module at the path says which it is);
- instance-norm and batch-norm ``scale``/``bias`` -> ``weight``/``bias``;
- batch-norm ``mean``/``var`` -> ``running_mean``/``running_var``; flax's
  ``BatchNorm2d`` wraps an ``nn.BatchNorm`` named ``bn``, a level the port's
  BatchNorm2d does not have;
- spectral ``u`` and ``v`` -> buffers of the same names and layout.

The result loads with ``load_state_dict(strict=True)``.

``vgg16_state_dict_from_torchvision`` maps torchvision's ``vgg16()`` layout
(``features.<index>.weight``, OIHW already) onto ``VGG16Features``, the
port's counterpart of the JAX ``tools/convert_torch.convert_vgg16_features``.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
from face_mask_inpaint_tpu_torch.models.picnet import PatchDiscriminator, ResDiscriminator
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.nn.layers import BatchNorm2d, Conv2d, ConvTranspose2d

__all__ = ["state_dict_from_jax", "convert_mask_detector", "convert_reference_fill",
           "convert_discriminator", "convert_vgg16", "vgg16_state_dict_from_torchvision"]

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


def state_dict_from_jax(model: nn.Module, variables: dict) -> dict[str, torch.Tensor]:
    """Map every leaf of ``variables`` onto ``model``'s state_dict keys."""
    sd = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            *mods, name = path
            if (mods and mods[-1] == "bn" and isinstance(
                    model.get_submodule(".".join(mods[:-1])), BatchNorm2d)):
                mods = mods[:-1]
            prefix = ".".join(mods)
            module = model.get_submodule(prefix)
            if (collection, name) not in _LEAF_NAMES:
                raise KeyError(f"no rule for {collection}/{'/'.join(path)}")
            arr = np.array(leaf, dtype=np.float32)
            if collection == "params" and name == "kernel":
                if isinstance(module, ConvTranspose2d):
                    arr = arr.transpose(2, 3, 0, 1)
                elif isinstance(module, Conv2d):
                    arr = arr.transpose(3, 2, 0, 1)
                else:
                    raise TypeError(f"kernel at {prefix} belongs to {type(module).__name__}")
            key = _LEAF_NAMES[(collection, name)]
            sd[f"{prefix}.{key}" if prefix else key] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return sd


def convert_mask_detector(model: MaskDetector, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``MaskDetector`` variables (params + batch_stats) -> state_dict."""
    if not isinstance(model, MaskDetector):
        raise TypeError(f"expected a MaskDetector, got {type(model).__name__}")
    return state_dict_from_jax(model, variables)


def convert_reference_fill(model: ReferenceFill, variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``ReferenceFill`` variables (params + spectral) -> state_dict."""
    if not isinstance(model, ReferenceFill):
        raise TypeError(f"expected a ReferenceFill, got {type(model).__name__}")
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
