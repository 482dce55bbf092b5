"""span_ms.drn_dilated: the device time a batch of the port's
``drn_dilated`` spans, in ms, over the profiled batches: each DRN-C-42
trunk's groups 5-8 and the 1x1 head, the dilated levels at 1/8 (256-512
channels at 32^2), two a batch (source and reference), inside the
``encoder`` spans. Each span's time is its CUDA event pair; the sum is
divided by the ``generator`` span's calls, one a batch. None where the
program has no such span. Program span."""


def read(ctx):
    try:
        from face_mask_inpaint_tpu_torch.utils.profiling import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    gen, row = table.get("generator"), table.get("drn_dilated")
    if not gen or not row or row["device_ms"] is None:
        return None
    return row["device_ms"] / gen["calls"]
