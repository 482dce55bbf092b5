"""span_ms.decoder: the device time a batch of the port's ``decoder`` span,
in ms, over the profiled batches: Stack A's ResGenerator with its latent
branch (K1, ten K2, K3); Stack B's StyleGAN2 synthesis at 1024^2 (K6, K7a).
The span's time is its CUDA event pair, divided by the ``generator`` span's
calls, one a batch. None where the program has no spans. Program span."""


def read(ctx):
    try:
        from face_mask_inpaint_tpu_torch.utils.profiling import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    gen, row = table.get("generator"), table.get("decoder")
    if not gen or not row or row["device_ms"] is None:
        return None
    return row["device_ms"] / gen["calls"]
