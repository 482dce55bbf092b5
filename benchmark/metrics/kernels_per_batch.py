"""kernels_per_batch: device kernels a batch in the profiled batches,
copies and fills apart; the host's launch load. Device trace."""


def read(ctx):
    n = len(ctx.summary.kernels())
    return n / ctx.summary.batches if n else None
