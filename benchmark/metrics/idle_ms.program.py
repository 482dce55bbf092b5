"""idle_ms.program: the device's idle time a batch, in ms, over the profiled
batches, in the gaps between device operations that began while the host
was inside one of the port's ``fmi.*`` spans (the CLI step, or the detector
and the generator where the caller runs them itself): idle time that the
program's own enqueue caused, not the caller's wait for a result or its
copy. Gaps from the device trace, spans' host ranges from the profiler.
None where the program has no spans. Program span."""


def read(ctx):
    try:
        from face_mask_inpaint_tpu_torch.utils.profiling import SPAN_PREFIX
    except ImportError:  # a program without spans
        return None
    summary = ctx.summary
    spans = [(s, e) for name, s, e in summary.host if name.startswith(SPAN_PREFIX)]
    if not spans or not summary.batches:
        return None
    idle = sum(sec for t, sec in summary.gaps() if any(s <= t < e for s, e in spans))
    return 1e3 * idle / summary.batches
