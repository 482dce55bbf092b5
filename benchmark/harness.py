"""One run of one cell: set-up, the measured window, the traced batches and
the check of what the window produced.

Everything that belongs to one configuration, mix or metric is a file found
by its name in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the model's sizes, its dtype, the
  pipeline that drives the port (``benchmark/pipelines/<pipeline>.py``) and
  the limits of the check;
- ``benchmark/reference/<config>.py``: the configuration's plain reference;
- ``benchmark/traffic/<mix>.json``: the mix's parameters (``traffic.py``);
- ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

``run_cell`` returns the result line's object; ``run.py`` prints it.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

import torch

from benchmark import devtrace, roofline, traffic
from benchmark.reference.common import Ops, tf32_off

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


# -- finding the cell's files -------------------------------------------------
def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_file_module(path: Path) -> ModuleType:
    """A module from its file, whose name may hold dots (a metric's)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with its configuration, mix, pipeline,
    reference and metrics, read from their files."""

    def __init__(self, name: str, manifest: Optional[dict] = None,
                 config: Optional[dict] = None, mix: Optional[dict] = None):
        manifest = load_manifest() if manifest is None else manifest
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, cells[name]
        conf_entry = {c["name"]: c for c in manifest["configs"]}[self.entry["config"]]
        self.config = load_json(ROOT / conf_entry["file"]) if config is None else config
        self.mix = (load_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
                    if mix is None else mix)
        self.pipeline = importlib.import_module(f"benchmark.pipelines.{self.config['pipeline']}")
        self.reference = importlib.import_module(f"benchmark.reference.{self.entry['config']}")
        self.end_to_end = [m for m in manifest["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def metric_reader(self, name: str) -> Callable:
        return load_file_module(BENCH_DIR / "metrics" / f"{name}.py").read


# -- weights --------------------------------------------------------------------
def make_weights(specs: dict, seed: int, device) -> dict:
    """name -> tensor, every weight drawn from ``seed`` on ``device`` in one
    call, then shaped and scaled leaf by leaf as its WeightSpec says."""
    total = sum(math.prod(shape) for shape, _ in specs.values())
    if torch.device(device).type == "meta":
        flat = torch.empty(total, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(traffic.sub_seed(seed, "weights"))
        flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, spec) in specs.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if spec.kind == "normal":
            t.mul_(spec.std).add_(spec.mean)
        elif spec.kind == "unit":
            t.div_(torch.linalg.vector_norm(t) + 1e-12)
        elif spec.kind == "lognormal":
            t.mul_(spec.std).exp_()
        else:
            raise ValueError(f"unknown weight kind {spec.kind!r} for {name}")
        out[name] = t
    return out


def cell_weights(cell: Cell, seed: int, pool: list[dict], device,
                 calib: Optional[dict] = None) -> tuple[dict, dict]:
    """The cell's weights from ``seed`` and the entries its reference
    calibrates on the first pooled batch (``calib``, computed once and
    given back later, so every side gets the same values)."""
    weights = make_weights(cell.reference.weight_specs(cell.config), seed, device)
    if calib is None:
        with torch.no_grad(), tf32_off():
            calib = cell.reference.calibrate(cell.config, weights, pool[0])
    weights.update(calib)
    return weights, calib


# -- the check ------------------------------------------------------------------
MARGIN = 0.3  # a mask pixel is judged where |gap| >= MARGIN x its image's median |gap|


def judge(cell: Cell, seed: int, pool: list[dict], rows: list[int], produced: dict,
          device, calib: dict) -> dict:
    """Compare what was produced with the float32 reference.

    ``produced`` maps a pooled batch's index to the list of (images, masks)
    that the window returned for it, each restricted to ``rows``. The
    reference computes each pooled batch's rows once, in blocks. Returns:

    - ``mask_flip_pct``: over the compared images, the largest share (in %)
      of an image's pixels whose produced mask differs from the reference's,
      among the pixels that the reference decides by a margin: a logit gap
      of at least ``MARGIN`` times the image's median gap. (The mask is an
      argmax; pixels nearer a tie flip under rounding alone.)
    - ``image_err_ratio``: ||images - ref|| / ||witness - ref|| over all
      compared images together, where ``ref`` is the float32 reference's
      image and ``witness`` the same reference with every product's operands
      and results rounded to bfloat16, the configuration's precision. So it
      reads the program's departure from float32 in units of the departure
      that bfloat16 rounding alone makes at this seed's weights. Both are
      given the produced mask, since a mask pixel flipped near a tie moves
      the generator's whole output (the detector is judged by itself)."""
    weights, _ = cell_weights(cell, seed, pool, device, calib)
    ref = cell.reference.Reference(cell.config, weights, Ops())
    witness = cell.reference.Reference(cell.config, weights, Ops("bf16"))
    block = int(cell.mix["check_block"])
    flip_pct, err2, wit2 = 0.0, 0.0, 0.0
    with torch.no_grad(), tf32_off():
        for j, outs in produced.items():
            if not outs:
                continue
            for start in range(0, len(rows), block):
                sel = rows[start:start + block]
                idx = torch.tensor(sel, device=pool[j]["src"].device)
                batch = {k: v.index_select(0, idx) for k, v in pool[j].items()}
                gap = ref.mask_gap(batch)
                median = gap.abs().flatten(1).median(dim=1).values
                decided = gap.abs() >= MARGIN * median[:, None, None]
                given = outs[-1][1][start:start + block].to(device).float()
                ref_img = ref.generate(batch, given)
                wit_img = witness.generate(batch, given)
                for images, masks in outs:
                    m = masks[start:start + block].to(device).float()
                    flips = ((m != (gap > 0).float()) & decided).flatten(1).sum(1)
                    share = 100.0 * flips / decided.flatten(1).sum(1)
                    flip_pct = max(flip_pct, float(share.max()))
                    img = images[start:start + block].to(device).float()
                    err2 += float((img - ref_img).double().pow(2).sum())
                    wit2 += float((wit_img - ref_img).double().pow(2).sum())
    del ref, witness, weights
    ratio = math.sqrt(err2 / wit2) if wit2 > 0 else math.inf
    return {"mask_flip_pct": flip_pct,
            "image_err_ratio": ratio if math.isfinite(ratio) else math.inf}


def control_outputs(cell: Cell, seed: int, pool: list[dict], rows: list[int],
                    device, calib: dict) -> dict:
    """The control in the program's place: the reference with every product's
    operands and results in float8 e4m3, on the rows the check compares."""
    weights, _ = cell_weights(cell, seed, pool, device, calib)
    ctl = cell.reference.Reference(cell.config, weights, Ops("fp8"))
    idx = torch.tensor(rows, device=device)
    produced = {}
    with torch.no_grad(), tf32_off():
        for j, full in enumerate(pool):
            batch = {k: v.index_select(0, idx) for k, v in full.items()}
            mask = ctl.mask(batch)
            produced[j] = [(ctl.generate(batch, mask).cpu(), mask.cpu())]
    return produced


# -- timing helpers --------------------------------------------------------------
def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class HostCopy:
    """Brings a batch's result (images, masks) to the host as the program
    made it: copied into page-locked host buffers made at the first call and
    reused (the copy is the card's DMA, not the host's memcpy), then waited
    for. The buffers are overwritten by the next call."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.bufs = None

    def __call__(self, out):
        if not self.cuda:
            return out
        if self.bufs is None:
            self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out]
        for buf, t in zip(self.bufs, out):
            buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return self.bufs


def time_cli_copy(out, device, copies: int = 8) -> float:
    """Seconds a copy of one batch's result (images, masks) to the host takes
    as the CLIs make it, ``images.float().cpu()`` and ``masks.cpu()`` into
    pageable memory: ``copies`` of them timed together."""
    _sync(device)
    t = time.perf_counter()
    for _ in range(copies):
        out[0].float().cpu()
        out[1].cpu()
    return (time.perf_counter() - t) / copies


class StageTimer:
    """CUDA events on a module's forward pre- and post-hooks (one pair a
    call), read after the batch has finished."""

    def __init__(self, module: torch.nn.Module):
        self.pending, self.ms = [], []
        self._hooks = [module.register_forward_pre_hook(self._pre),
                       module.register_forward_hook(self._post)]

    def _pre(self, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pending.append([ev, None])

    def _post(self, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pending[-1][1] = ev

    def collect(self) -> None:
        self.ms += [a.elapsed_time(b) for a, b in self.pending]
        self.pending = []

    def close(self) -> None:
        for h in self._hooks:
            h.remove()


def quantile(values: list[float], q: float) -> float:
    """The q-quantile of all values (linear between order statistics)."""
    return float(torch.tensor(values, dtype=torch.float64).quantile(q))


# -- one run -------------------------------------------------------------------------
def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, fault: Optional[Callable] = None) -> dict:
    """Set up, warm up, measure for ``seconds``, profile (with ``trace``),
    check. ``t_start`` is the process's start on ``time.time()``'s clock.
    ``fault`` wraps the step (the tests break the timed path with it).
    Returns the result line's object, with the compared numbers under
    ``checks`` last."""
    t_start = time.time() if t_start is None else t_start
    mix, config = cell.mix, cell.config
    if mix["loop"] != "closed":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    phases = {"start": time.time() - t_start}  # seconds from the process's start
    pool = traffic.make_pool(cell.pipeline.input_spec(config, mix), mix, seed, device)
    weights = make_weights(cell.reference.weight_specs(config), seed, device)
    _sync(device)
    phases["inputs_weights"] = time.time() - t_start
    # the reference's calibration is the check's work, not the system's set-up
    t_calib = time.time()
    with torch.no_grad(), tf32_off():
        calib = cell.reference.calibrate(config, weights, pool[0])
    weights.update(calib)
    _sync(device)
    calib_s = time.time() - t_calib
    system = cell.pipeline.System(config, weights, device)
    del weights
    _sync(device)
    phases["system"] = time.time() - t_start
    step = system.step if fault is None else fault(system.step)
    rows = traffic.check_rows(mix, seed)
    rows_t = torch.tensor(rows)
    to_host = HostCopy(device)
    for _ in range(int(mix["warmup_rounds"])):
        for batch in pool:
            to_host(step(batch))
    _sync(device)
    gc.collect()
    phases["warmup"] = time.time() - t_start
    setup_s = time.time() - t_start - calib_s

    timers = {}
    if trace and torch.device(device).type == "cuda":
        timers = {name: StageTimer(m) for name, m in system.stages.items()}
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    produced = {j: [] for j in range(len(pool))}
    latencies, enqueue, attempted = [], [], 0
    nonfinite = torch.zeros((), dtype=torch.int64, device=device)
    last = None  # (pooled batch, host result) whose rows are still to keep
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_done = t0
    while time.perf_counter() < deadline:
        j = attempted % len(pool)
        attempted += 1
        t_call = time.perf_counter()
        out = step(pool[j])
        t_enq = time.perf_counter()
        nonfinite += (~torch.isfinite(out[0])).any()  # read after the window
        if last is not None:  # while the card works on this batch
            produced[last[0]].append(tuple(t[rows_t] for t in last[1]))
        last = (j, to_host(out))
        t_done = time.perf_counter()
        del out
        latencies.append(t_done - t_call)
        enqueue.append(t_enq - t_call)
        for t in timers.values():
            t.collect()
    if last is not None:
        produced[last[0]].append(tuple(t[rows_t] for t in last[1]))
    window_s = t_done - t0
    failed = int(nonfinite)  # batches whose images hold a non-finite value
    n_batch = int(mix["batch"])
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    for t in timers.values():
        t.close()

    summary, cli_copy_s = None, None
    if trace:
        summary = devtrace.profile(lambda i: to_host(step(pool[i % len(pool)])),
                                   int(mix["trace_batches"]), device)
        cli_copy_s = time_cli_copy(step(pool[0]), device)
    del step, system
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    readings = judge(cell, seed, pool, rows, produced, device, calib)
    limits = config["checks"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    completed = len(latencies)
    if trace:
        ctx = Context(cell=cell, summary=summary, enqueue_s=enqueue, cli_copy_s=cli_copy_s,
                      stage_ms={k: t.ms for k, t in timers.items()}, peak_bytes=peak,
                      batch=n_batch, batches_per_s=completed / window_s if window_s else 0.0)
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"images_per_s": completed * n_batch / window_s if window_s else 0.0,
               "batch_p90_ms": quantile(latencies, 0.9) * 1e3 if latencies else math.inf,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info(device, peak, summary)}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    ms = [round(x * 1e3, 2) for x in latencies]
    marks = ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
    print(f"[run] {cell.name} seed {seed}: {completed} batches of {n_batch} in "
          f"{window_s:.3f} s, set-up {setup_s:.3f} s (calibration {calib_s:.3f} s apart; "
          f"phases to {marks}); batch ms first {ms[:3]}, "
          f"sorted {sorted(ms)[:: max(1, len(ms) // 8)]}, max {max(ms, default=0)}",
          file=sys.stderr)
    return result


def device_info(device, peak: int, summary) -> dict:
    if torch.device(device).type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": peak}
    if summary is not None:
        info["busy_s"] = summary.busy_s()
        info["window_s"] = summary.window_s
    return info


class Context:
    """What a per-layer metric's reader reads: the traced batches'
    ``summary`` (devtrace.Summary), the window's host enqueue times and
    stage times, the CLIs' copy of a result (``cli_copy_s``), the peak
    memory, the cell (config and mix) and the rate."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def kernel_share(self, patterns: tuple[str, ...], calls: list) -> Optional[float]:
        """A kernel's roofline share in %: the bound of its ``calls`` of one
        batch ((bytes, operations, peak rate) each) over the device time a
        batch of the kernels whose name holds one of ``patterns``, or None
        where it has no call or the trace none of its launches."""
        dev = self.summary.kernel_seconds(patterns)
        if not calls or dev <= 0.0:
            return None
        bound = sum(roofline.bound_of(*c) for c in calls)
        return 100.0 * bound / (dev / self.summary.batches)


__all__ = ["Cell", "make_weights", "judge", "control_outputs", "run_cell", "Context"]
