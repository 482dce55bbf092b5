"""mfu: the whole step's model FLOPs a batch, times the traced run's batches
a second, over the H100's dense bf16 peak (989 TFLOP/s), in %.

The FLOPs are counted once, from the configuration's plain reference:
``torch.utils.flop_counter.FlopCounterMode`` over the reference's forward
(detector and generator) of one image on the meta device, times the batch.
So the count is the same whatever implements the work."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import roofline
from benchmark.harness import make_weights
from benchmark.reference.common import Ops


def model_flops(cell, n: int = 1) -> int:
    """FLOPs of the reference's forward of ``n`` images."""
    spec = cell.pipeline.input_spec(cell.config, dict(cell.mix, batch=n))
    batch = {k: torch.empty(shape, device="meta") for k, (_, shape) in spec.items()}
    weights = make_weights(cell.reference.weight_specs(cell.config), 0, "meta")
    ref = cell.reference.Reference(cell.config, weights, Ops())
    with FlopCounterMode(display=False) as counter:
        ref.generate(batch, ref.mask(batch))
    return counter.get_total_flops()


def read(ctx):
    if ctx.batches_per_s <= 0:
        return None
    flops = model_flops(ctx.cell) * ctx.batch
    return 100.0 * flops * ctx.batches_per_s / roofline.BF16_RATE
