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
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.nn.layers import BatchNorm2d, Conv2d, ConvTranspose2d

__all__ = ["state_dict_from_jax", "convert_mask_detector", "convert_reference_fill"]

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
