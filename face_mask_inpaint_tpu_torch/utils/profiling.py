"""Profiler hooks for the CLIs, on ``torch.profiler``.

Port of face_mask_inpaint_tpu/utils/profiling.py: every trainer and inference
CLI takes ``--profile_dir``; when it is set, a window of steps is traced and
written as a Chrome trace (``trace.json``, readable in ui.perfetto.dev or
chrome://tracing) under that directory. The default window skips steps 0 and
1, as the JAX package's does, so warm-up stays out of the trace.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

__all__ = ["ProfileWindow", "add_profile_args"]


class ProfileWindow:
    """Traces steps [start_step, start_step + num_steps) of a loop: call
    ``tick(step)`` once per iteration, before the step, and ``close()`` at
    the end. Traces the card's kernels too when CUDA is available."""

    def __init__(self, profile_dir: str, num_steps: int = 5, start_step: int = 2):
        self.dir = profile_dir
        self.start, self.stop = start_step, start_step + num_steps
        self._prof = None

    def tick(self, step: int) -> None:
        if not self.dir:
            return
        if step == self.start and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            logging.info("profiler: starting trace (%s)", self.dir)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif step >= self.stop and self._prof is not None:
            self._write()

    def _write(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        out = Path(self.dir)
        out.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(out / "trace.json"))
        self._prof = None
        logging.info("profiler: trace written to %s", out / "trace.json")

    def close(self) -> None:
        if self._prof is not None:
            self._write()


def add_profile_args(parser) -> None:
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler Chrome trace of the profiled steps here")
    parser.add_argument("--profile_steps", type=int, default=5,
                        help="how many steps the trace window covers")
