"""span_ms.generator_self: the ``generator`` span's device time a batch less
that of the spans inside it (``encoder``, ``fusion``, ``decoder``), in ms,
over the profiled batches: the generator's glue (Stack A: dtype casts and
permutes, sample_z, the final pool; Stack B: the latent average's add, the
1024^2 -> 256^2 pool, the permutes). Times are CUDA event pairs; the
``generator`` span has one call a batch. None where the program has no
spans. Program span."""


def read(ctx):
    try:
        from face_mask_inpaint_tpu_torch.utils.profiling import span_table
    except ImportError:  # a program without spans
        return None
    table = span_table()
    gen = table.get("generator")
    if not gen or gen["device_ms"] is None:
        return None
    children = [r["device_ms"] for r in table.values() if r["parent"] == "generator"]
    if None in children:
        return None
    return (gen["device_ms"] - sum(children)) / gen["calls"]
