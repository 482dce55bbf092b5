"""The general traffic generator: a mix file's parameters -> the inputs.

A mix (``benchmark/traffic/<mix>.json``) holds only numbers:

- ``loop``: ``closed`` (one client sends its next batch when the last
  one's result is on the host);
- ``batch``, ``height``, ``width``: the size of every batch;
- ``pool``: how many distinct batches are made; the window cycles them;
- ``image``: how the photos are drawn: a ``coarse`` x ``coarse`` grid of
  uniform colours resized bicubically to the image size, plus ``detail``
  times Gaussian pixel noise, clamped to the range; so each image has
  regions large enough for a mask;
- ``warmup_rounds``: how many times set-up runs each pooled batch;
- ``check_rows``: how many images of every batch the check compares, drawn
  from the seed, as many from each quarter of the batch;
- ``check_block``: how many images the reference computes at once;
- ``trace_batches``: how many batches the traced run profiles.

The configuration's pipeline says which tensors a batch has and their
shapes and ranges (``input_spec``); this module draws them on the device
from the seed, each pooled batch with its own stream.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["sub_seed", "make_pool", "check_rows"]


def sub_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one named stream of ``seed`` (any whole number)."""
    words = [seed % 2 ** 32, seed // 2 ** 32 % 2 ** 32, seed // 2 ** 64 % 2 ** 32]
    for s in stream:
        words += [ord(ch) for ch in str(s)] + [0]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _images(shape, lo, hi, image: dict, gen: torch.Generator, device) -> torch.Tensor:
    n, h, w, c = shape
    g = int(image["coarse"])
    coarse = torch.rand((n, c, g, g), generator=gen, device=device)
    x = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    x = x + float(image["detail"]) * torch.randn((n, c, h, w), generator=gen, device=device)
    x = x.clamp(0.0, 1.0) * (hi - lo) + lo
    return x.permute(0, 2, 3, 1).contiguous()


def make_pool(spec: dict, traffic: dict, seed: int, device) -> list[dict]:
    """``traffic['pool']`` batches, each a dict name -> tensor on ``device``.
    ``spec`` maps each input name to (kind, shape): kind ``image01`` or
    ``image11`` (NHWC photos in [0, 1] or [-1, 1]) or ``normal`` (standard
    Gaussian noise)."""
    pool = []
    for j in range(int(traffic["pool"])):
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic", j))
        batch = {}
        for name, (kind, shape) in spec.items():
            if kind == "image01":
                batch[name] = _images(shape, 0.0, 1.0, traffic["image"], gen, device)
            elif kind == "image11":
                batch[name] = _images(shape, -1.0, 1.0, traffic["image"], gen, device)
            elif kind == "normal":
                batch[name] = torch.randn(shape, generator=gen, device=device)
            else:
                raise ValueError(f"unknown input kind {kind!r} for {name}")
        pool.append(batch)
    return pool


def check_rows(traffic: dict, seed: int) -> list[int]:
    """The rows of every batch that the check compares: ``check_rows`` of
    them, as many from each quarter of the batch, drawn from the seed."""
    n, k = int(traffic["batch"]), int(traffic["check_rows"])
    rng = np.random.default_rng(sub_seed(seed, "rows"))
    quarters = np.array_split(np.arange(n), 4)
    per = [k // 4 + (1 if i < k % 4 else 0) for i in range(4)]
    rows = []
    for q, m in zip(quarters, per):
        rows += rng.choice(q, size=min(m, len(q)), replace=False).tolist()
    return sorted(rows)
