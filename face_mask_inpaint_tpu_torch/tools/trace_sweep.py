"""Per-op roofline sweep over a ``torch.profiler`` Chrome trace.

Port of face_mask_inpaint_tpu/tools/trace_sweep.py: ``trace_top`` says where
the device time goes; this says which ops run far below the card's peak. It
reads the newest ``trace.json`` under a directory and aggregates the device
kernels by the aten op that launched them, one row per op name, input type
and input shapes (a row per convolution shape, as the JAX sweep has a row
per XLA op), each with its TFLOP/s from the profiler's own flop counts,
which ``utils/profiling.ProfileWindow`` records (``record_shapes``,
``with_flops``) in the args of the op that has a count (``flops``).

    python -m face_mask_inpaint_tpu_torch.tools.trace_sweep TRACE_DIR
        [--max-frac 0.25] [--min-ms 0.05] [--top 25]

Attribution: every aten op nested in an op with a count (on the same
thread) belongs to it; a kernel belongs to the op whose ``External id`` it
carries (or, failing that, the id of the CUDA runtime call with its
``correlation``). An op's row sums the time of all the kernels it launched
(a cuDNN convolution's layout transposes too) against its count, and names
its longest kernel. Kernels of no op with a count, the port's hand-written
kernels among them, make rows of their own by kernel name with flops 0, as
the Pallas kernels do in the JAX sweep: read their cost from ``trace_top``
and ``PERF.md``. A trace without device events (a ``--device cpu`` run) is
swept by its top-level CPU ops, each with the counts of the ops inside it;
the output says which kind it read.
"""

from __future__ import annotations

import argparse
import collections

from face_mask_inpaint_tpu_torch.tools.trace_top import CPU_KIND, load_trace_events, timed_events

__all__ = ["PEAK_TFLOPS", "sweep", "main"]

# dense peaks of one H100 SXM, TFLOP/s, by the aten op's input type: bf16
# and fp16 on the tensor cores, f32 on the CUDA cores (the port runs f32 with
# TF32 off)
PEAK_TFLOPS = {"c10::BFloat16": 989.0, "c10::Half": 989.0, "float": 67.0}
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _owners(ops: list) -> tuple[dict, dict]:
    """(External id of every aten op -> the innermost op with a count that
    encloses it, itself included, as (id, flops, row key); the id of every
    op with a count -> the id of its top-level op). A row key is (op name,
    input type, input shapes)."""
    owner_of, top_of = {}, {}
    by_thread = collections.defaultdict(list)
    for e in ops:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []  # (end, owner or None, top-level id)
        for e in evs:
            while stack and e["ts"] >= stack[-1][0]:
                stack.pop()
            args = e.get("args") or {}
            ext = args.get("External id")
            owner, top = stack[-1][1:] if stack else (None, ext)
            if args.get("flops"):
                types = [t for t in args.get("Input type", []) if t]
                dims = "x".join(str(d) for d in args.get("Input Dims", []) if d)
                owner = (ext, float(args["flops"]),
                         (e.get("name", "?"), types[0] if types else "", dims))
                top_of[ext] = top
            stack.append((e["ts"] + e.get("dur", 0), owner, top))
            if owner is not None and ext is not None:
                owner_of[ext] = owner
    return owner_of, top_of


def _row():
    return {"ms": 0.0, "calls": 0, "flops": 0.0, "op": "", "dtype": "", "dims": "",
            "kernels": collections.Counter()}


def sweep(root: str):
    """Aggregate by op row: {row name: {ms, calls, flops (summed), op,
    dtype, dims, kernels (time by kernel name)}}, the trace's path and the
    kind of events read."""
    events, path = load_trace_events(root)
    if events is None:
        raise FileNotFoundError(f"no trace.json under {root}")
    complete = [e for e in events if e.get("ph") == "X"]
    owner_of, top_of = _owners([e for e in complete if e.get("cat") == "cpu_op"])
    timed, kind = timed_events(events)
    agg = collections.defaultdict(_row)
    owners = set(owner_of.values())

    def owned(key):
        name = f"{key[0]} [{key[1]}] {key[2]}".strip()
        r = agg[name]
        r["op"], r["dtype"], r["dims"] = key
        return r

    if kind == CPU_KIND:
        inside = collections.defaultdict(list)
        for o in owners:
            inside[top_of.get(o[0])].append(o)
        for e in timed:
            mine = inside.get((e.get("args") or {}).get("External id"), [])
            r = owned(mine[0][2]) if len(mine) == 1 else agg[e.get("name", "?")]
            r["ms"] += e.get("dur", 0) / 1e3
            r["calls"] += 1
            r["flops"] += sum(o[1] for o in mine)
            r["kernels"][e.get("name", "?")] += e.get("dur", 0)
        return agg, path, kind
    by_corr = {}
    for e in complete:
        args = e.get("args") or {}
        if e.get("cat") in _RUNTIME_CATS and "correlation" in args:
            by_corr[args["correlation"]] = args.get("External id")
    launched = set()
    for e in timed:
        args = e.get("args") or {}
        ext = args.get("External id")
        owner = owner_of.get(ext if ext in owner_of else by_corr.get(args.get("correlation")))
        r = agg[e.get("name", "?")] if owner is None else owned(owner[2])
        r["ms"] += e.get("dur", 0) / 1e3
        r["kernels"][e.get("name", "?")] += e.get("dur", 0)
        if owner is None:
            r["calls"] += 1
        elif owner[0] not in launched:
            launched.add(owner[0])
            r["calls"] += 1
            r["flops"] += owner[1]
    return agg, path, kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--max-frac", type=float, default=0.25,
                    help="show rows at or below this fraction of the H100's dense peak for "
                         "their op's type (default 0.25: 989 TFLOP/s bf16 and fp16, 67 f32 on "
                         "the CUDA cores); rows without a flop count show at 0")
    ap.add_argument("--min-ms", type=float, default=0.05,
                    help="only show rows with at least this much time a call")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    agg, path, kind = sweep(args.trace_dir)
    print(f"trace: {path}")
    print(f"read: {kind}")
    rows = []
    for name, r in agg.items():
        per = r["ms"] / max(r["calls"], 1)
        tfs = r["flops"] / (r["ms"] * 1e9) if r["ms"] > 0 else 0.0
        peak = PEAK_TFLOPS.get(r["dtype"])
        frac = tfs / peak if peak else 0.0
        if per >= args.min_ms and frac <= args.max_frac:
            rows.append((r["ms"], per, tfs, frac, name, r))
    rows.sort(key=lambda row: -row[0])
    for ms, per, tfs, frac, name, r in rows[: args.top]:
        print(f"{ms:9.3f} ms total {per:8.3f} ms/call {tfs:7.1f} TF/s {100 * frac:5.1f}% "
              f"{r['flops'] / max(r['calls'], 1) / 1e9:9.2f} GF/call x{r['calls']:<4d} "
              f"{name[:100]}")
        if r["op"] and r["kernels"]:
            top, us = r["kernels"].most_common(1)[0]
            print(f"          {len(r['kernels'])} kernel(s), longest {us / 1e3:.3f} ms: {top[:80]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
