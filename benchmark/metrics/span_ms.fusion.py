"""span_ms.fusion: the device time a batch of the port's ``fusion`` span, in
ms, over the profiled batches: Stack A's mask scaling and example-guided
attention over the two encoders' features; Stack B's reference fusion at
the FPN taps, the FPN and the 18 style heads. The span's time is its CUDA
event pair, divided by the ``generator`` span's calls, one a batch. None
where the program has no spans. Program span."""


def read(ctx):
    try:
        from face_mask_inpaint_tpu_torch.utils.profiling import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    gen, row = table.get("generator"), table.get("fusion")
    if not gen or not row or row["device_ms"] is None:
        return None
    return row["device_ms"] / gen["calls"]
