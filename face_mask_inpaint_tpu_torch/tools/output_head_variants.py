"""Time kernel K3 against variants of its own source on one NVIDIA GPU.

    python -m face_mask_inpaint_tpu_torch.tools.output_head_variants

Each variant is ``csrc/output_head.cu`` with one tile parameter changed
(rows a thread, the blocks-per-SM hint of ``__launch_bounds__``), built with
the port's nvcc flags into ``build/kernels/variants/``. Every variant is
checked against ``output_head_plain`` and timed with CUDA events at the
flagship shape ([16, 32, 1024, 1024], co = 3, f = 4) in bfloat16 and float32,
in turns (a, b, ..., b, a) so that drift hits all alike. Prints one line per
dtype and the card's name and power limit. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from face_mask_inpaint_tpu_torch.kernels import build
from face_mask_inpaint_tpu_torch.kernels import output_head as oh

ROWS, BOUNDS = "constexpr int kRows = 8; ", "__launch_bounds__(kThreads, 2)"
VARIANTS = {
    "as committed": {},
    "4 rows a thread, 3 blocks an SM": {ROWS: ROWS.replace("8", "4"),
                                        BOUNDS: BOUNDS.replace("2)", "3)")},
    "4 rows a thread": {ROWS: ROWS.replace("8", "4")},
    "no register cap (1 block an SM)": {BOUNDS: BOUNDS.replace("2)", "1)")},
}
SHAPE, CO, POOL = (16, 32, 1024, 1024), 3, 4


def _build() -> dict[str, ctypes.CDLL]:
    source = (build.CSRC / "output_head.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        src = out_dir / f"v{i}.cu"
        src.write_text(text)
        procs[name] = (out_dir / f"v{i}.so", subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"v{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("output_head_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    libs = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        h = (torch.randn(SHAPE, device="cuda", generator=gen) * 2).to(dtype)
        s = torch.randn(SHAPE, device="cuda", generator=gen).to(dtype)
        w = torch.randn(CO, SHAPE[1], 3, 3, device="cuda", generator=gen) / (3 * SHAPE[1] ** 0.5)
        b = torch.randn(CO, device="cuda", generator=gen) * 0.1
        ref = oh.output_head_plain(h, s, w, b, "LeakyReLU", POOL).float()

        def run(name):
            build._loaded["output_head"] = libs[name]  # the wrapper then calls this variant
            return oh.output_head(h, s, w, b, "LeakyReLU", POOL)

        times = {name: [] for name in libs}
        for _ in range(3):
            for name in list(libs) + list(libs)[::-1]:
                times[name].append(_time_ms(lambda: run(name)))
        parts = []
        for name in libs:
            err = float((run(name).float() - ref).abs().max())
            parts.append(f"{name}: {statistics.median(times[name]):.4f} ms (max_abs_err {err:.2e})")
        print(f"{str(dtype).split('.')[-1]}: " + "; ".join(parts), flush=True)
        del h, s
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
