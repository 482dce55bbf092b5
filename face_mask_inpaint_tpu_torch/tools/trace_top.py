"""Sum device time by kernel from a ``torch.profiler`` Chrome trace.

Port of face_mask_inpaint_tpu/tools/trace_top.py for the traces the port's
CLIs write (``--profile_dir``, utils/profiling.py ``ProfileWindow``): it
reads the newest ``trace.json`` under a directory and prints the device
kernels by summed time, with their counts, merged across the steps of the
window.

    python -m face_mask_inpaint_tpu_torch.tools.trace_top TRACE_DIR [N_TOP]

Device events are the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events. A trace without any (a ``--device cpu`` run) is read by its
top-level ``cpu_op`` events instead (ops not nested in another op on the
same thread); the output says which kind it read. No device is needed.
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

__all__ = ["load_trace_events", "timed_events", "op_totals", "device_op_stats", "main"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DEVICE_KIND = "device kernels"
CPU_KIND = "top-level CPU ops"


def load_trace_events(root) -> tuple[list | None, Path | None]:
    """(events, path) of the newest ``trace.json`` under ``root``, (None,
    None) if there is none."""
    paths = sorted(Path(root).rglob("trace.json"), key=lambda p: p.stat().st_mtime)
    if not paths:
        return None, None
    path = paths[-1]
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return events, path


def _top_level(ops: list) -> list:
    """The ops of ``ops`` that no other op of the same thread encloses."""
    out = []
    by_thread = collections.defaultdict(list)
    for e in ops:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        end = float("-inf")
        for e in evs:
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e.get("dur", 0)
    return out


def timed_events(events: list) -> tuple[list, str]:
    """(the complete events that carry the time, their kind): the device
    events where the trace has any, else the top-level CPU ops."""
    complete = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS]
    if dev:
        return dev, DEVICE_KIND
    return _top_level([e for e in complete if e.get("cat") == "cpu_op"]), CPU_KIND


def op_totals(events: list) -> tuple[collections.Counter, collections.Counter, str]:
    """(summed microseconds by name, counts by name, the kind read)."""
    timed, kind = timed_events(events)
    tot, cnt = collections.Counter(), collections.Counter()
    for e in timed:
        name = e.get("name", "?")
        tot[name] += e.get("dur", 0)
        cnt[name] += 1
    return tot, cnt, kind


def device_op_stats(root) -> tuple[float, int]:
    """(summed seconds of the timed events, executions-per-op median) for the
    window: the median count over the names that hold at least 0.5% of the
    largest name's time is the number of steps the window captured, as in
    the JAX tool (tiny glue ops have odd counts)."""
    events, _ = load_trace_events(root)
    if events is None:
        return 0.0, 0
    tot, cnt, _ = op_totals(events)
    if not tot:
        return 0.0, 0
    floor = 0.005 * max(tot.values())
    counts = sorted(cnt[n] for n, us in tot.items() if us >= floor)
    return sum(tot.values()) / 1e6, counts[len(counts) // 2] if counts else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.strip().split("\n\n")[1].strip(), file=sys.stderr)
        return 2
    n_top = int(argv[1]) if len(argv) > 1 else 30
    events, path = load_trace_events(argv[0])
    if events is None:
        print(f"no trace.json under {argv[0]}")
        return 1
    tot, cnt, kind = op_totals(events)
    print(f"trace: {path}")
    print(f"read: {kind}")
    print(f"total {kind} time: {sum(tot.values()) / 1e3:.3f} ms (all steps summed)")
    for name, us in tot.most_common(n_top):
        print(f"{us / 1e3:10.3f} ms  x{cnt[name]:<5d} {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
