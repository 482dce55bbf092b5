"""roofline.k7a: K7a, the StyledConvs' bias + LeakyReLU x sqrt(2)
(csrc/fused_act.cu), its bound at the cell's call shapes over its device
time a batch in the profiled batches, in %. None where the configuration or
the trace has no call of it.

One call at 4 x 4 and two at each side from 8 up to ``psp.output_size``;
x read, y written, the f32 bias read once, four FLOPs an element."""

from benchmark import roofline, shapes

NAMES = ("fused_lrelu_",)


def calls(config: dict, batch: int, side: int) -> list[tuple[float, float, float]]:
    """(bytes, operations, peak rate) of each call of one batch."""
    if "psp" not in config:
        return []
    ch, es = shapes.stylegan_channels(config), roofline.DTYPE_BYTES[config["dtype"]]
    sides = [(ch[4], 4)] + [(ch[r], r) for r in shapes.stylegan_sides(config) for _ in range(2)]
    return [(2.0 * batch * c * r * r * es + 4.0 * c, 4.0 * batch * c * r * r,
             roofline.F32_RATE) for c, r in sides]


def read(ctx):
    return ctx.kernel_share(NAMES, calls(ctx.cell.config, ctx.batch, ctx.cell.mix["height"]))
