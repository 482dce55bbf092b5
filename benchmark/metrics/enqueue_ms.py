"""enqueue_ms: the host's time from the call into the per-batch step to its
return, before the wait for the result (all launches enqueued), mean over
the traced run's window, in ms. Host clock."""


def read(ctx):
    if not ctx.enqueue_s:
        return None
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
