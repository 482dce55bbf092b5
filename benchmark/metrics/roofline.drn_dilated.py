"""roofline.drn_dilated: the DRN trunks' dilated levels (groups 5-8 and the
1x1 head, inside the ``drn_dilated`` spans), their bound at the cell's
shapes over the spans' device time a batch in the profiled batches, in %.
None where the configuration has no DRN encoder or the program no such
span.

The bound is the larger of the levels' FLOPs over the bf16 tensor-core peak
and their bytes over the memory rate, counted from the configuration's
``encoder`` keys alone (``channels``, ``blocks``, ``img_f``): every conv at
the feature side (the photo's over 8), 2 k^2 C_in C_out FLOPs a pixel,
two trunks a batch; the levels' input read once, every conv's weight read
once in float32 and the head's output written once. The span also holds
the BatchNorms, ReLUs and residual adds, which add no FLOPs to the count.
Program span."""

import math

from benchmark import roofline
from benchmark.reference.refill_drn import N_STRIDED, drn_convs

TRUNKS = 2  # the source's and the reference's


def counts(config: dict, batch: int, side: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one batch's dilated levels, both trunks."""
    enc = config["encoder"]
    feat = side // 8
    convs = drn_convs(enc, dilated=True)
    flops = sum(2.0 * math.prod(shape) * feat * feat for _, shape, _, _ in convs)
    params = sum(math.prod(shape) for _, shape, _, _ in convs) + enc["img_f"]
    es = roofline.DTYPE_BYTES[config["dtype"]]
    cin = enc["channels"][N_STRIDED - 1]  # group 4's output, the levels' input
    acts = batch * feat * feat * (cin + enc["img_f"]) * es
    return TRUNKS * (acts + 4.0 * params), TRUNKS * batch * flops


def bound_s(config: dict, batch: int, side: int):
    """Seconds, or None without a DRN encoder."""
    if config.get("encoder", {}).get("type") != "drn":
        return None
    nbytes, flops = counts(config, batch, side)
    rate = roofline.BF16_RATE if roofline.DTYPE_BYTES[config["dtype"]] == 2 \
        else roofline.F32_RATE
    return roofline.bound_of(nbytes, flops, rate)


def read(ctx):
    try:
        from face_mask_inpaint_tpu_torch.utils.profiling import span_table
    except ImportError:  # a program without spans
        return None
    bound = bound_s(ctx.cell.config, ctx.batch, ctx.cell.mix["height"])
    table = span_table()
    gen, row = table.get("generator"), table.get("drn_dilated")
    if bound is None or not gen or not row or not row["device_ms"]:
        return None
    return 100.0 * bound / (row["device_ms"] / gen["calls"] / 1e3)
