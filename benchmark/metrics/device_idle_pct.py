"""device_idle_pct: the share of the profiled batches' window in which no
device operation runs (one minus the union of kernel, copy and fill
intervals over the window), in %; device trace. It counts the host's sync
and relaunch between batches, and the profiler's own host work where the
host sets the pace. (Set against a batch's time in the unprofiled window
instead, it read below zero at batch 128, where the profiler lengthens the
kernels themselves.)"""


def read(ctx):
    if not ctx.summary.device or ctx.summary.window_s <= 0:
        return None
    return 100.0 * ctx.summary.idle_share()
