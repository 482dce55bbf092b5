"""Adam and the host-side ReduceLROnPlateau of the GAN trainer.

Port of face_mask_inpaint_tpu/train/optim.py ``adam`` and ``PlateauTracker``
(train/optim.py:75-131). The reference steps two ReduceLROnPlateau schedulers
on the validation losses with mode 'max', patience 2 and factor 0.8
(train_reference_fill.py:310-319, :403-404); ``PlateauTracker.step`` returns
the new learning rate and ``set_learning_rate`` writes it into a torch
optimizer, the counterpart of the JAX ``set_learning_rate`` on an
``inject_hyperparams`` state.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

__all__ = ["adam", "set_learning_rate", "PlateauTracker"]


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """torch.optim.Adam with the defaults the reference uses
    (train_reference_fill.py:309-312)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


class PlateauTracker:
    """torch ReduceLROnPlateau semantics on the host: threshold_mode 'rel',
    cooldown 0, min_lr 0; ``step(metric)`` once per validation round."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.lr = float(base_lr)
        self.mode, self.factor = mode, factor
        self.patience, self.threshold = patience, threshold
        self.best: Optional[float] = None
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr *= self.factor
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": math.nan if self.best is None else self.best,
                "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        best = float(d["best"])
        self.best = None if math.isnan(best) else best
        self.num_bad = int(d["num_bad"])
