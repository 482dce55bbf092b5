"""A few batches under ``torch.profiler``, reduced to what the per-layer
metrics read.

The profile is kept in memory, never written. Device events are the kernels,
copies and fills that the profiler saw on the card; their union over the
traced window is the device's busy time (overlapping kernels count once).
A gap is a stretch of the window that no device event covers; it is named by
the host span or operation that was running when it began (the shortest one
that covers its start), so ``breakdown`` says what the host was doing while
the card waited.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Iterable

import torch

COPY_PREFIXES = ("Memcpy", "Memset")
SPANS = ("traced_window", "batch")  # the benchmark's own host spans


def union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Summary:
    """``device``: (name, start_s, end_s) of each device event; ``host``:
    (name, start_s, end_s) of each host span and operation; ``window``:
    (start_s, end_s) of the traced batches on the same clock."""

    def __init__(self, device: list, host: list, window: tuple[float, float], batches: int):
        self.device, self.host, self.batches = device, host, batches
        self.window = window
        self.window_s = window[1] - window[0]

    def _busy(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        return union((max(s, lo), min(e, hi)) for _, s, e in self.device)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy())

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s if self.window_s > 0 else 0.0

    def kernels(self) -> list:
        return [d for d in self.device if not d[0].startswith(COPY_PREFIXES)]

    def kernel_seconds(self, patterns: tuple[str, ...]) -> float:
        """Summed device time of the kernels whose name holds a pattern."""
        return sum(e - s for n, s, e in self.kernels() if any(p in n for p in patterns))

    def gaps(self) -> list[tuple[float, float]]:
        """(start, seconds) of every idle stretch of the window."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self._busy() for x in iv] + [hi]
        return [(s, e - s) for s, e in zip(edges[0::2], edges[1::2]) if e > s]

    def host_at(self, t: float) -> str:
        """The shortest host span or operation running at time ``t``."""
        covering = [h for h in self.host if h[1] <= t < h[2]]
        return min(covering, key=lambda h: h[2] - h[1])[0] if covering else "no host span"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest gaps
        by what the host was doing when each began."""
        by_name = Counter()
        for n, s, e in self.device:
            by_name[n] += e - s
        longest = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:160], t] for n, t in by_name.most_common(top)],
                "idle_gaps": [[self.host_at(s)[:160], t] for s, t in longest]}


def profile(run_batch: Callable[[int], object], n: int, device) -> Summary:
    """Profile ``n`` calls of ``run_batch`` (each ends with its result on the
    host) after one untraced call."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    run_batch(0)
    with torch_profile(activities=activities) as prof:
        with torch.profiler.record_function(SPANS[0]):
            for i in range(n):
                with torch.profiler.record_function(SPANS[1]):
                    run_batch(i)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    dev, host, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the spans' shadows on the device timeline are no device work
            if not (getattr(e, "is_user_annotation", False) or e.name in SPANS):
                dev.append((e.name, s, t))
        elif e.name == SPANS[0]:
            window = (s, t)
        elif not e.is_async:
            host.append((e.name, s, t))
    if window is None:
        raise RuntimeError("the profile holds no traced_window span")
    return Summary(dev, host, window, n)


__all__ = ["union", "Summary", "profile"]
