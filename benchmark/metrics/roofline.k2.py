"""roofline.k2: K2, the decoder blocks' instance norm + LeakyReLU
(csrc/norm_act.cu), its bound at the cell's call shapes over its device
time a batch in the profiled batches, in %. None where the configuration or
the trace has no call of it.

Two calls a decoder block where ``decoder.norm`` is ``instance``: norm1 on
the block's input, norm2 on its hidden map, both at the input's side; x
read once, y written once, about 5 FLOPs an element."""

from benchmark import roofline, shapes

NAMES = ("norm_act_",)


def calls(config: dict, batch: int, side: int) -> list[tuple[float, float, float]]:
    """(bytes, operations, peak rate) of each call of one batch."""
    if config.get("decoder", {}).get("norm") != "instance":
        return []
    chans = shapes.decoder_channels(config["decoder"])
    es = roofline.DTYPE_BYTES[config["dtype"]]
    h, cin, out = shapes.feature_side(config, side), chans[0], []
    for c in chans:
        for ch in (cin, c):
            n = batch * ch * h * h
            out.append((2.0 * n * es, 5.0 * n, roofline.F32_RATE))
        cin, h = c, 2 * h
    return out


def read(ctx):
    return ctx.kernel_share(NAMES, calls(ctx.cell.config, ctx.batch, ctx.cell.mix["height"]))
