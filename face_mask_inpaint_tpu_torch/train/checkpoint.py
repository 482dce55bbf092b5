"""Checkpoints of the GAN trainer, in the port's own ``.pt`` format.

Port of face_mask_inpaint_tpu/train/checkpoint.py (``checkpoint_dir``,
``save_state``, ``restore_state``, ``latest_epoch``) with the JAX package's
names, ``<checkpoint_path>/<run_name>/{G,D}_checkpoint_epoch{n}``, each one
file written by ``torch.save``. The trainer saves the full state: the
modules' state dicts (spectral-norm u and v buffers included), the
optimizers, the plateau trackers, the step and the sampling generator's RNG
state, so that training resumes where it stopped. Orbax directories written
by the JAX package do not load here.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

__all__ = ["checkpoint_dir", "save_state", "restore_state", "latest_epoch"]


def checkpoint_dir(checkpoint_path, run_name: str) -> Path:
    d = Path(checkpoint_path) / run_name
    d.mkdir(parents=True, exist_ok=True)
    return d


def save_state(base_dir, tag: str, epoch: int, state: Any) -> Path:
    """Save ``state`` (tensors, dicts, numbers) under
    <base_dir>/<tag>_checkpoint_epoch<epoch>, atomically."""
    path = Path(base_dir) / f"{tag}_checkpoint_epoch{epoch}"
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_state(path, map_location="cpu") -> Any:
    return torch.load(Path(path), map_location=map_location, weights_only=False)


def latest_epoch(base_dir, tag: str) -> Optional[int]:
    """Highest epoch among <tag>_checkpoint_epoch* files, or None."""
    base = Path(base_dir)
    if not base.exists():
        return None
    pat = re.compile(rf"^{re.escape(tag)}_checkpoint_epoch(\d+)$")
    epochs = [int(m.group(1)) for p in base.iterdir() if (m := pat.match(p.name))]
    return max(epochs) if epochs else None
