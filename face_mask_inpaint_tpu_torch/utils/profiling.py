"""Profiler hooks for the CLIs, on ``torch.profiler``, and the port's spans.

Port of face_mask_inpaint_tpu/utils/profiling.py: every trainer and inference
CLI takes ``--profile_dir``; when it is set, a window of steps is traced and
written as a Chrome trace (``trace.json``, readable in ui.perfetto.dev or
chrome://tracing) under that directory. The default window skips steps 0 and
1, as the JAX package's does, so warm-up stays out of the trace.

The trace records shapes and the profiler's flop counts. Where the export
leaves the counts out of an op's args, ``_write`` adds them as ``flops``,
keyed by the op's ``External id``: ``tools/trace_sweep.py`` reads them there.

Spans mark the models' layer boundaries (``step``, ``detector``,
``generator``, ``encoder``, ``fusion``, ``decoder``). While a
``torch.profiler`` session runs, a span is a host range ``fmi.<name>`` in
the profiler's trace, a pair of CUDA events on the current stream (once CUDA
is initialised) and a record in this module's list, which ``span_table()``
sums by name. While none runs, ``span()`` returns one shared object that
does nothing, so the spans cost a flag read when the profiler is off.
"""

from __future__ import annotations

import functools
import json
import logging
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["ProfileWindow", "add_profile_args", "add_flops", "span", "spanned",
           "span_table", "reset_spans", "SPAN_PREFIX"]

SPAN_PREFIX = "fmi."
_records: list = []  # (name, parent, host start ns, host end ns, start event, end event)
_open: list = []  # names of the spans entered and not yet left, innermost last


class _Off:
    """The span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    """A span while a profiler runs: a ``record_function`` range, CUDA events
    on the current stream where CUDA is initialised, and a record."""

    __slots__ = ("name", "parent", "_range", "_t0", "_ev0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self._range.__enter__()
        self._ev0 = None
        if torch.cuda.is_initialized():
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        self.parent = _open[-1] if _open else None
        _open.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _open.pop()
        ev1 = None
        if self._ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        _records.append((self.name, self.parent, self._t0, t1, self._ev0, ev1))
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that makes one call of a layer the span ``name``
    while a profiler runs; the shared no-op object while none runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """The decorator form of ``span``: each call of the function is the span
    ``name``. (``span`` itself cannot decorate: a function is defined before
    any profiler starts, when ``span`` gives the shared no-op object.)"""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def span_table() -> dict:
    """name -> {"calls", "device_ms", "host_ms", "parent"}, summed over the
    spans recorded since the last ``reset_spans()``, in the order they were
    first entered; the records are kept. ``device_ms`` sums each call's CUDA
    event pair (None where CUDA was not initialised); ``parent`` is the span
    that the name's first call ran inside (None at the top)."""
    if any(r[4] is not None for r in _records):
        torch.cuda.synchronize()
    table = {}
    for name, parent, t0, t1, ev0, ev1 in sorted(_records, key=lambda r: r[2]):
        row = table.setdefault(name, {"calls": 0, "device_ms": None, "host_ms": 0.0,
                                      "parent": parent})
        row["calls"] += 1
        row["host_ms"] += (t1 - t0) / 1e6
        if ev0 is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + ev0.elapsed_time(ev1)
    return table


def reset_spans() -> None:
    """Forget the spans recorded so far."""
    _records.clear()


class ProfileWindow:
    """Traces steps [start_step, start_step + num_steps) of a loop: call
    ``tick(step)`` once per iteration, before the step, and ``close()`` at
    the end. Traces the card's kernels too when CUDA is available. The spans
    are reset when the window opens, and their table is logged, in ms a
    step, when the trace is written."""

    def __init__(self, profile_dir: str, num_steps: int = 5, start_step: int = 2):
        self.dir = profile_dir
        self.start, self.stop = start_step, start_step + num_steps
        self._prof = None
        self._steps = 0

    def tick(self, step: int) -> None:
        if not self.dir:
            return
        if step == self.start and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            logging.info("profiler: starting trace (%s)", self.dir)
            reset_spans()
            self._steps = 0
            self._prof = torch.profiler.profile(activities=activities, record_shapes=True,
                                                with_flops=True)
            self._prof.__enter__()
        elif step >= self.stop and self._prof is not None:
            self._write()
        if self._prof is not None:
            self._steps += 1

    def _write(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        out = Path(self.dir)
        out.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(out / "trace.json"))
        add_flops(out / "trace.json", self._prof)
        self._prof = None
        logging.info("profiler: trace written to %s", out / "trace.json")
        steps = max(self._steps, 1)
        for name, row in span_table().items():
            device = "-" if row["device_ms"] is None else f"{row['device_ms'] / steps:.3f}"
            logging.info("profiler: span %s%s (in %s): %s device ms, %.3f host ms, %g calls "
                         "a step over %d steps", SPAN_PREFIX, name, row["parent"] or "-", device,
                         row["host_ms"] / steps, row["calls"] / steps, steps)

    def close(self) -> None:
        if self._prof is not None:
            self._write()


def add_flops(path, prof) -> int:
    """Write the profiler's flop count of each op (``prof.events()``, whose
    ids are the trace's ``External id``) into that op's args in the Chrome
    trace at ``path``, where the export left it out. Returns the number of
    ops given a count."""
    flops = {e.id: int(e.flops) for e in prof.events() if e.flops}
    if not flops:
        return 0
    path = Path(path)
    trace = json.loads(path.read_text())
    added = 0
    for e in trace.get("traceEvents", []):
        args = e.get("args")
        if (e.get("cat") == "cpu_op" and isinstance(args, dict) and "flops" not in args
                and args.get("External id") in flops):
            args["flops"] = flops[args["External id"]]
            added += 1
    if added:
        path.write_text(json.dumps(trace))
    return added


def add_profile_args(parser) -> None:
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler Chrome trace of the profiled steps here")
    parser.add_argument("--profile_steps", type=int, default=5,
                        help="how many steps the trace window covers")
