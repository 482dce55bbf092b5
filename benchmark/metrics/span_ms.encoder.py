"""span_ms.encoder: the device time a batch of the port's ``encoder`` spans,
in ms, over the profiled batches: Stack A's two ResEncoder passes (source
and reference), Stack B's two IR-SE50 backbone passes. Each span's time is
its CUDA event pair; the sum is divided by the ``generator`` span's calls,
one a batch. None where the program has no spans. Program span."""


def read(ctx):
    try:
        from face_mask_inpaint_tpu_torch.utils.profiling import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    gen, row = table.get("generator"), table.get("encoder")
    if not gen or not row or row["device_ms"] is None:
        return None
    return row["device_ms"] / gen["calls"]
