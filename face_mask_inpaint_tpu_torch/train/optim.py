"""Adam, Ranger, the host-side ReduceLROnPlateau of the trainers, and the
learning-rate schedules.

Port of face_mask_inpaint_tpu/train/optim.py ``adam``, ``ranger``,
``PlateauTracker`` (train/optim.py:75-219), ``get_scheduler`` and
``plateau_scheduler`` (:222-270), which no trainer uses. The reference steps its
ReduceLROnPlateau schedulers on the validation losses with mode 'max',
patience 2 and factor 0.8 (train_reference_fill.py:310-319, :403-404,
train_psp.py:294-298); ``PlateauTracker.step`` returns the new learning rate
and ``set_learning_rate`` writes it into a torch optimizer's param_groups.
A torch optimizer always holds its learning rate there, so ``adam`` and
``ranger`` are already the counterparts of the JAX ``adam_injected`` and
``ranger_injected`` (an ``inject_hyperparams`` state).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

__all__ = ["adam", "ranger", "Ranger", "set_learning_rate", "PlateauTracker", "get_scheduler",
           "plateau_scheduler", "PlateauScheduler"]


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


class Ranger(torch.optim.Optimizer):
    """RAdam + Lookahead(k, alpha) + gradient centralization, the JAX
    package's ``ranger`` (train/optim.py:140-219; reference
    modules/psp/ranger.py:29-184): betas (0.95, 0.999), eps 1e-5, the
    rectification threshold 5, and a slow copy of each parameter, taken at
    construction as optax's init takes it, that every k-th step pulls the
    fast weights halfway to.

    Gradient centralization subtracts from each gradient of two or more
    dimensions its mean over the axes 1.. of the parameter's JAX layout, as
    the JAX package does: HWIO for convolutions, [in, out] for dense layers,
    where the reference centralizes OIHW and [out, in] per output channel.
    ``keep_dims`` maps each parameter of two or more dimensions to the
    dimension of its port layout that holds the JAX layout's axis 0
    (``convert.jax_leading_dims``): the mean is taken over every other
    dimension.
    """

    def __init__(self, params, lr: float = 1e-3, alpha: float = 0.5, k: int = 6,
                 n_sma_threshold: int = 5, betas: tuple[float, float] = (0.95, 0.999),
                 eps: float = 1e-5, weight_decay: float = 0.0, use_gc: bool = True, *,
                 keep_dims: Mapping[torch.Tensor, int]):
        defaults = dict(lr=lr, alpha=alpha, k=k, n_sma_threshold=n_sma_threshold,
                        betas=betas, eps=eps, weight_decay=weight_decay, use_gc=use_gc)
        super().__init__(params, defaults)
        self.keep_dims = dict(keep_dims)
        for group in self.param_groups:
            for p in group["params"]:
                if p.dim() >= 2 and p not in self.keep_dims:
                    raise ValueError(f"keep_dims has no entry for a parameter of shape "
                                     f"{tuple(p.shape)}")
                self.state[p]["slow"] = p.detach().clone()

    def _centralize(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if g.dim() < 2:
            return g
        dims = [d for d in range(g.dim()) if d != self.keep_dims[p]]
        return g - g.mean(dim=dims, keepdim=True)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Ranger.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                state = self.state[p]
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if group["use_gc"]:
                    g = self._centralize(p, g)
                if "exp_avg" not in state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                beta2_t = b2 ** t
                n_sma_max = 2.0 / (1.0 - b2) - 1.0
                n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
                if n_sma > group["n_sma_threshold"]:
                    step_size = math.sqrt(
                        (1.0 - beta2_t) * (n_sma - 4.0) / (n_sma_max - 4.0)
                        * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0)
                    ) / (1.0 - b1 ** t)
                    direction = m / (v.sqrt() + eps)
                else:
                    step_size = 1.0 / (1.0 - b1 ** t)
                    direction = m
                fast = p - lr * step_size * direction
                if group["weight_decay"]:
                    fast = fast - group["weight_decay"] * lr * p
                if t % group["k"] == 0:
                    slow = state["slow"]
                    slow.add_(fast - slow, alpha=group["alpha"])
                    p.copy_(slow)
                else:
                    p.copy_(fast)
        return None


def ranger(params: Iterable[torch.nn.Parameter], learning_rate: float,
           keep_dims: Mapping[torch.Tensor, int]) -> Ranger:
    """Ranger with the JAX package's defaults and centralization axes."""
    return Ranger(params, lr=learning_rate, keep_dims=keep_dims)


def get_scheduler(lr_policy: str, base_lr: float, niter: int = 100, niter_decay: int = 100,
                  iter_count: int = 0, lr_decay_iters: int = 50) -> Callable[[int], float]:
    """The schedule registry of the reference's get_scheduler
    (base_function.py:69-88): a callable from epoch to learning rate.

    'lambda': base_lr * (1 - max(0, epoch + 2 + iter_count - niter) /
    (niter_decay + 1)); 'step': x0.1 every ``lr_decay_iters`` epochs
    (staircase); 'exponent': x0.95 per epoch (not staircase). Computed in
    float32, as the JAX schedules are."""
    f32 = np.float32
    if lr_policy == "lambda":
        def sched(epoch):
            late = max(f32(0.0), f32(epoch + 2.0 + iter_count - niter))
            return float(f32(base_lr) * (f32(1.0) - late / f32(niter_decay + 1)))
        return sched
    if lr_policy in ("step", "exponent"):
        steps, rate = (lr_decay_iters, 0.1) if lr_policy == "step" else (1, 0.95)

        def sched(epoch):
            if epoch <= 0:
                return float(f32(base_lr))
            p = f32(epoch / steps)
            if lr_policy == "step":
                p = np.floor(p)
            return float(f32(base_lr) * np.power(f32(rate), p))
        return sched
    raise NotImplementedError(f"learning rate policy [{lr_policy}] is not implemented")


class PlateauScheduler:
    """The state machine of ``optax.contrib.reduce_on_plateau`` (one value a
    step, atol 0), in float32 as optax keeps it: ``update(value)`` returns
    the scale to multiply the learning rate by. A value improves when it is
    below (1 - rtol) * best; after ``patience`` steps without improvement
    the scale drops by ``factor`` (not below ``min_scale``) and ``cooldown``
    steps follow in which the plateau count stays 0 (the best value still
    updates)."""

    def __init__(self, factor: float = 0.1, patience: int = 10, rtol: float = 1e-4,
                 cooldown: int = 0, min_scale: float = 0.0):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got factor = {factor}.")
        if not 0.0 < rtol <= 1.0:
            raise ValueError(f"rtol must be in (0, 1], got rtol = {rtol}.")
        self.factor, self.patience, self.rtol = factor, patience, rtol
        self.cooldown, self.min_scale = cooldown, min_scale
        self.scale = np.float32(1.0)
        self.best = np.float32(np.inf)
        self.plateau_count = self.cooldown_count = 0

    def update(self, value: float) -> float:
        value = np.float32(value)
        improved = value < np.float32(1 - self.rtol) * self.best
        if improved:
            self.best = value
        count = 0 if improved else self.plateau_count + 1
        if self.cooldown_count > 0:
            self.plateau_count, self.cooldown_count = 0, self.cooldown_count - 1
        else:
            reduce = count == self.patience
            self.plateau_count = 0 if reduce else count
            scale = self.scale * np.float32(self.factor) if reduce else self.scale
            self.scale = np.maximum(scale, np.float32(self.min_scale))
            self.cooldown_count = self.cooldown if reduce else 0
        return float(self.scale)


def plateau_scheduler(factor: float = 0.1, patience: int = 10, mode: str = "min",
                      rtol: float = 1e-4, cooldown: int = 0,
                      min_scale: float = 0.0) -> PlateauScheduler:
    """torch ReduceLROnPlateau's counterpart of the JAX function, which
    returns ``optax.contrib.reduce_on_plateau`` with these arguments. For
    mode 'max' pass the negated metric, as there."""
    del mode  # the caller negates for 'max'
    return PlateauScheduler(factor, patience, rtol, cooldown, min_scale)
