"""roofline.k1: K1, the decoder's self-attention (csrc/flash_attention_fwd.cu),
its bound at the cell's call shapes over its device time a batch in the
profiled batches, in %. None where the configuration or the trace has no
call of it.

One call a forward after the decoder's second block where ``use_att`` is
on: L tokens, q of C/4 channels, one value set of C; QK^T and PV,
2 N L^2 (d + C) FLOPs; q and v read, the output written."""

from benchmark import roofline, shapes

NAMES = ("flash_fwd",)


def calls(config: dict, batch: int, side: int) -> list[tuple[float, float, float]]:
    """(bytes, operations, peak rate) of each call of one batch."""
    if "decoder" not in config or not config.get("use_att"):
        return []
    c = shapes.decoder_channels(config["decoder"])[1]
    d = c // 4
    tokens = (shapes.feature_side(config, side) * 4) ** 2
    es = roofline.DTYPE_BYTES[config["dtype"]]
    ops = 2.0 * batch * tokens * tokens * (d + c)
    nbytes = es * batch * tokens * (d + 2 * c)
    return [(nbytes, ops, roofline.BF16_RATE if es == 2 else roofline.F32_RATE)]


def read(ctx):
    return ctx.kernel_share(NAMES, calls(ctx.cell.config, ctx.batch, ctx.cell.mix["height"]))
