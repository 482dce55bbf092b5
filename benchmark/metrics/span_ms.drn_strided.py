"""span_ms.drn_strided: the device time a batch of the port's
``drn_strided`` spans, in ms, over the profiled batches: each DRN-C-42
trunk's conv1 and groups 1-4, the levels that stride the photo to 1/8
(16-128 channels at 256^2 to 32^2), two a batch (source and reference),
inside the ``encoder`` spans. Each span's time is its CUDA event pair; the
sum is divided by the ``generator`` span's calls, one a batch. None where
the program has no such span. Program span."""


def read(ctx):
    try:
        from face_mask_inpaint_tpu_torch.utils.profiling import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    gen, row = table.get("generator"), table.get("drn_strided")
    if not gen or not row or row["device_ms"] is None:
        return None
    return row["device_ms"] / gen["calls"]
