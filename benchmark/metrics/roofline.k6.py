"""roofline.k6: K6, StyleGAN2's upfirdn2d (csrc/upfirdn2d.cu), its bound at
the cell's call shapes over its device time a batch in the profiled
batches, in %. None where the configuration or the trace has no call of it.

Two calls at each side r of the synthesis network from 8 up to
``psp.output_size``: the blur after the upsampling conv
([N, C, r + 1, r + 1] -> r x r, 4 taps) and the ToRGB skip's x2 upsample
([N, 3, r/2, r/2] -> r x r); x read once, y written once, two passes of
4 / up multiply-adds an output element."""

from benchmark import roofline, shapes

NAMES = ("upfirdn2d_kernel",)


def calls(config: dict, batch: int, side: int) -> list[tuple[float, float, float]]:
    """(bytes, operations, peak rate) of each call of one batch."""
    if "psp" not in config:
        return []
    ch, es, out = shapes.stylegan_channels(config), roofline.DTYPE_BYTES[config["dtype"]], []
    for r in shapes.stylegan_sides(config):
        for c, x_side, up in ((ch[r], r + 1, 1), (3, r // 2, 2)):
            x, y = batch * c * x_side * x_side, batch * c * r * r
            out.append(((x + y) * es, 2.0 * 2 * y * 4 / up, roofline.F32_RATE))
    return out


def read(ctx):
    return ctx.kernel_share(NAMES, calls(ctx.cell.config, ctx.batch, ctx.cell.mix["height"]))
