"""Experiment metric logging: JSONL per run, mirrored to wandb when asked.

Port of face_mask_inpaint_tpu/utils/metrics_logger.py. The reference logs
per-step scalars, periodic weight and gradient histograms and image samples
to wandb (train_reference_fill.py:283-291, :352-357, :372-398); here the same
keys go to ``<run_dir>/metrics.jsonl`` (arrays as their moments), and to
wandb when it is importable and enabled. ``write_metrics_csv`` writes the
inference and evaluation CLIs' ``metrics.csv`` with the ``csv`` module, in
the layout of the JAX CLIs' ``pandas.DataFrame.to_csv(index=False)``.
"""

from __future__ import annotations

import csv
import json
import math
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["MetricsLogger", "NullLogger", "histogram_summary", "write_metrics_csv"]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return v


def _to_scalar(v):
    v = _host(v)
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {k: _to_scalar(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_to_scalar(x) for x in v]
    arr = np.asarray(v)
    if arr.dtype == object:
        return str(v)
    if arr.size == 1:
        return float(arr.reshape(()))
    return {"mean": float(arr.mean()), "std": float(arr.std()), "min": float(arr.min()),
            "max": float(arr.max()), "shape": list(arr.shape)}


def histogram_summary(named_tensors, prefix: str) -> dict:
    """``{prefix/name: host array}`` for (name, tensor) pairs, such as
    ``module.named_parameters()`` or a gradient dict's items()."""
    items = named_tensors.items() if isinstance(named_tensors, dict) else named_tensors
    return {f"{prefix}/{name.replace('.', '/')}": _host(t) for name, t in items}


class MetricsLogger:
    """JSONL writer with an optional wandb mirror."""

    def __init__(self, run_dir, project: str = "face_mask_inpaint_tpu", run_name: str = "",
                 config: Optional[dict] = None, use_wandb: bool = False):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / "metrics.jsonl"
        self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=run_name or None,
                                         resume="allow", config=config or {})
            except Exception:  # wandb absent or offline: the JSONL stays the record
                self._wandb = None
        if config:
            self.log({"_config": config}, step=0)

    def log(self, metrics: dict[str, Any], step: Optional[int] = None) -> None:
        record = {"_time": time.time()}
        if step is not None:
            record["step"] = int(step)
        for k, v in metrics.items():
            record[k] = _to_scalar(v)
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            import wandb

            payload = {}
            for k, v in metrics.items():
                arr = np.asarray(_host(v)) if not isinstance(v, (dict, str)) else None
                if arr is None or arr.dtype == object:
                    continue
                payload[k] = (float(arr.reshape(())) if arr.size == 1
                              else wandb.Histogram(arr.reshape(-1)))
            self._wandb.log(payload, step=step)

    def log_image(self, name: str, image, step: Optional[int] = None) -> None:
        """Save an image sample ([H, W, C] float in [0, 1], or [H, W]) under
        <run_dir>/images/."""
        from PIL import Image

        img_dir = self.run_dir / "images"
        img_dir.mkdir(exist_ok=True)
        arr = np.asarray(_host(image), np.float32)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        arr = np.clip(arr, 0.0, 1.0)
        Image.fromarray((arr * 255).astype("uint8")).save(
            img_dir / f"{name}_{step if step is not None else 0}.png")
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(arr)}, step=step)

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """The logger of a rank that writes nothing (every rank but 0 of a
    data-parallel trainer)."""

    def log(self, metrics: dict[str, Any], step: Optional[int] = None) -> None:
        pass

    def log_image(self, name: str, image, step: Optional[int] = None) -> None:
        pass

    def close(self) -> None:
        pass


def write_metrics_csv(path, columns: dict[str, list]) -> None:
    """``columns`` (name -> one value per row) as a CSV with a header line:
    each float as its shortest round-trip repr and NaN as an empty field, as
    pandas writes them. The table is printed too."""
    names = list(columns)
    n_rows = max((len(v) for v in columns.values()), default=0)

    def field(v):
        v = float(v)
        return "" if math.isnan(v) else repr(v)

    rows = [[field(columns[k][i]) for k in names] for i in range(n_rows)]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        writer.writerows(rows)
    print("  ".join(names))
    for row in rows:
        print("  ".join(v or "NaN" for v in row))
