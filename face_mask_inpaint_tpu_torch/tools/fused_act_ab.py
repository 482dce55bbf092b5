"""Time K7a (fused_leaky_relu) of two checkouts of the port on one card, in
turns A, B, B, A, then the host's share of a small call in checkout B.

    python -m face_mask_inpaint_tpu_torch.tools.fused_act_ab DIR_A DIR_B

Each turn is a fresh process in that checkout's root, which builds its own
kernel there and runs the 17 K7a calls of a config-4 forward, in bf16 at
batch 16 and in f32 at batch 8 (the inference CLI's and the training step's
shapes; the bias in x's dtype, as the models pass it), under no_grad,
through that checkout's wrapper: each call alone in a CUDA-event window
(the median of 7, summed over the calls) and the 17 calls back to back in
one window (median of 7). The host lines time each piece of checkout B's
wrapper on a [16, 512, 4, 4] call (host clock, the mean of 3000 calls).
Compare the two only within one run of this script (same card, same host).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

TIMES = """
import statistics, torch
from face_mask_inpaint_tpu_torch.kernels import fused_act as act
from face_mask_inpaint_tpu_torch.models.stylegan2 import channels_for

def window(fn, reps=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

ch = channels_for(1024)
gen = torch.Generator(device="cuda").manual_seed(0)
for dtype, batch in ((torch.bfloat16, 16), (torch.float32, 8)):
    shapes = [(batch, ch[4], 4, 4)] + [(batch, ch[r], r, r) for r in (2 ** i for i in range(3, 11))
                                       for _ in (0, 1)]
    xs = [torch.randn(s, device="cuda", generator=gen).to(dtype) for s in shapes]
    bs = [torch.randn(s[1], device="cuda", generator=gen).to(dtype) for s in shapes]
    with torch.no_grad():
        calls = [window(lambda: act.fused_leaky_relu(x, b)) for x, b in zip(xs, bs)]
        seq = window(lambda: [act.fused_leaky_relu(x, b) for x, b in zip(xs, bs)])
    print(f"[k7a] {str(dtype).split('.')[-1]} batch {batch}, 17 calls: one a window "
          f"{sum(calls):.3f} ms (each: {' '.join(f'{t:.4f}' for t in calls)}), back to back "
          f"{seq:.3f} ms", flush=True)
    del xs, bs
"""

HOST = """
import time, torch
from face_mask_inpaint_tpu_torch.kernels import fused_act as act

def per_call_us(fn, n=3000):
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6

def device_context():
    with torch.cuda.device(x.device):
        pass

for dtype in (torch.bfloat16, torch.float32):
    x = torch.randn(16, 512, 4, 4, device="cuda").to(dtype)
    b = torch.randn(512, device="cuda").to(dtype)
    y = torch.empty_like(x)
    route = act._function("fmi_fused_act_route")
    pieces = {
        "the wrapper, no graph": lambda: act.fused_leaky_relu(x, b),
        "_FusedLeakyReLU.apply": lambda: act._FusedLeakyReLU.apply(x, b, 0.2, act.SQRT2),
        "_launch_fwd": lambda: act._launch_fwd(x, b, 0.2, act.SQRT2),
        "_call (device context, stream, ctypes, launch)": lambda: act._call(x, b, y, 0.2,
                                                                            act.SQRT2),
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "with torch.cuda.device(x.device)": device_context,
        "a ctypes call of a trivial C export": lambda: route(16),
        "_check": lambda: act._check(x, b),
    }
    for name, fn in pieces.items():
        print(f"[host] {str(dtype).split('.')[-1]} [16, 512, 4, 4] {name}: "
              f"{per_call_us(fn):.2f} us a call", flush=True)
"""


def _child(code: str, root: Path, label: str) -> int:
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        print(f"{label} {line}", flush=True)
    if proc.returncode != 0:
        print(f"{label} exited {proc.returncode}:\n{proc.stderr[-2000:]}", flush=True)
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    args = ap.parse_args(argv)
    dirs = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    rc = 0
    for turn, side in enumerate("ABBA"):
        rc |= _child(TIMES, dirs[side], f"{side}{turn}")
    rc |= _child(HOST, dirs["B"], "B")
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
