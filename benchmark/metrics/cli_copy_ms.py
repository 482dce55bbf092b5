"""cli_copy_ms: the host's time to copy one batch's result to the host as the
CLIs do after each batch (``images.float().cpu()``, ``masks.cpu()``, into
pageable memory), in ms: eight copies of one result timed together after the
traced batches. The window copies each result into page-locked buffers
instead, so this is what a CLI user's batch costs beyond the window's.
Host clock."""


def read(ctx):
    return 1e3 * ctx.cli_copy_s if ctx.cli_copy_s else None
