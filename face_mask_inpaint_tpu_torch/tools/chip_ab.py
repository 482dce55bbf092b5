"""Time two checkouts of the port on one card, in turns A, B, B, A: chip_smoke.py's
flagship bf16 batch-16 forward (phase 5: default, packed-convt and plain
configurations), its profile (phase 6: the program's span table and the
summed device time of three forwards of each configuration), its config-5
bf16-mixed training step (phase 7) and the number of device kernels (copies
and fills aside) of one default bf16 forward, from a profiler window.

    python -m face_mask_inpaint_tpu_torch.tools.chip_ab DIR_A DIR_B

Each turn is a fresh process in that checkout's root, which builds its own
kernels there and runs that checkout's chip_smoke.phase_timing,
phase_profile and phase_train; its [time] and [train] lines and the
[profile] lines of spans (of stages, in a checkout before the spans) and
device time are printed with the turn's
label.
The order A, B, B, A lets drift over the run hit both checkouts alike.
Compare the two only within one run of this script (same card, same host).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

# the settings of chip_smoke.main: TF32 off for f32 matmuls and convolutions
CHILD = """
import subprocess, torch, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
cs.phase_build()
run = cs.Run()
cs.phase_timing(run, 0, {}, card)
cs.phase_profile(run, 0, cs.PROFILE_ROUNDS, card)
cs.phase_train(run, 0, card)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
detector, model = cs._models(0, torch.bfloat16)
gen = torch.Generator(device="cuda").manual_seed(0)
src = torch.rand(16, cs.HW, cs.HW, 3, device="cuda", generator=gen)
ref = torch.rand(16, cs.HW, cs.HW, 3, device="cuda", generator=gen)
noise = torch.Generator(device="cuda").manual_seed(1)
def forward():
    with torch.no_grad():
        return model(src, ref, detector.predict_mask(src), generator=noise)
forward()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    forward()
    torch.cuda.synchronize()
rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
        and e.self_device_time_total > 0 and not e.is_user_annotation
        and not e.key.startswith(("Memcpy", "Memset"))]
print(f"[count] device kernels of one default bf16 forward: {sum(e.count for e in rows)}")
raise SystemExit(1 if run.failures else 0)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    args = ap.parse_args(argv)
    dirs = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    rc = 0
    for turn, side in enumerate("ABBA"):
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=dirs[side],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if (line.startswith(("[time] flagship", "[time] peak", "[train] config-5",
                                 "[train] profile", "[count]", "FAIL"))
                    or line.startswith("[profile]") and any(
                        k in line for k in ("spans", "per stage", "device time"))):
                print(f"{side}{turn} {line}", flush=True)
        if proc.returncode != 0:
            print(f"{side}{turn} exited {proc.returncode}:\n{proc.stderr[-2000:]}", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
