"""stage_ms.generator: device time from the generator module's forward pre-hook to its
post-hook (CUDA events), mean per batch over the traced run's window, in
ms."""


def read(ctx):
    ms = ctx.stage_ms.get("generator")
    return sum(ms) / len(ms) if ms else None
