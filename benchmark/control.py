"""The readings that a cell's check limits are set from, in one process.

    python benchmark/control.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 7 8 9] [--seconds 3]

For each of ``--seeds`` a run of the cell as ``run.py`` makes it, with a
short window at the cell's own load, gives the program's readings (the
lower ones). For each of ``--control-seeds`` the control takes the
program's place: the float32 reference with every product's operands in
float8 e4m3, the precision below the configurations' bfloat16, on the same
sampled images of the same batches; the check then reads it as it reads the
program (the upper readings). One JSON line a reading, then a summary line:
the largest program reading and the smallest control reading of each
number. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(ROOT)

    import torch

    from benchmark import harness, traffic

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from face_mask_inpaint_tpu_torch.kernels import build

    build.build_all()
    cell = harness.Cell(args.workload)
    program, control = {}, {}
    for seed in args.seeds:
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda")
        for k, c in res["checks"].items():
            program.setdefault(k, []).append(c["value"])
        print(json.dumps({"side": "program", "seed": seed, "correct": res["correct"],
                          "failed": res["failed"],
                          "readings": {k: c["value"] for k, c in res["checks"].items()}}),
              flush=True)
    for seed in args.control_seeds:
        pool = traffic.make_pool(cell.pipeline.input_spec(cell.config, cell.mix), cell.mix,
                                 seed, "cuda")
        _, calib = harness.cell_weights(cell, seed, pool, "cuda")
        rows = traffic.check_rows(cell.mix, seed)
        produced = harness.control_outputs(cell, seed, pool, rows, "cuda", calib)
        readings = harness.judge(cell, seed, pool, rows, produced, "cuda", calib)
        for k, v in readings.items():
            control.setdefault(k, []).append(v)
        print(json.dumps({"side": "control", "seed": seed, "readings": readings}), flush=True)
        del pool, produced
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "card": torch.cuda.get_device_name(0),
                      "program_max": {k: max(v) for k, v in program.items()},
                      "control_min": {k: min(v) for k, v in control.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
