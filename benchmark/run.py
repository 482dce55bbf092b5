"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Prints one JSON object as the last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (a few batches under the profiler after the window); the
numbers that decided ``correct`` come last, under ``checks``, and again as
the last lines of standard error. Exits non-zero, printing no result, without
CUDA or with fewer cards than the cell asks for, and when the process has
loaded JAX or the JAX package.

The kernels' libraries (``build/kernels``) and Triton's cache
(``build/triton``) live in the checkout at fixed paths, so only a cell's
first run in a checkout builds them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "face_mask_inpaint_tpu")


def process_start() -> float:
    """This process's start on time.time()'s clock (from /proc where the
    system has it, else now)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(ROOT)  # import the benchmark as a package, from the root
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    cell = harness.Cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.set_num_threads(1)  # the host only launches; spare cores keep its timing steady
    from face_mask_inpaint_tpu_torch.kernels import build

    build.build_all()  # a cold checkout builds every library at once, in set-up
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: the benchmark measures the port alone",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
