"""The yardstick of the kernels: one H100's peaks and a kernel call's bound.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the peak rate of the units it runs on: each input read once
and each output written once, whatever the kernel reads again. Each
``metrics/roofline.<kernel>.py`` counts its kernel's calls, bytes and
operations from the configuration's shapes alone (never from what the
program reports) and names the kernel's launches in the device trace.
"""

from __future__ import annotations

# one H100 SXM (NVIDIA's data sheet; dense, without sparsity)
MEM_RATE = 3.35e12   # HBM3 bytes/s
BF16_RATE = 989e12   # tensor-core FLOP/s, bf16 and fp16
F32_RATE = 67e12     # CUDA-core FLOP/s, float32
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_of(nbytes: float, ops: float, rate: float) -> float:
    """Seconds: the larger of the bytes' and the operations' time."""
    return max(nbytes / MEM_RATE, ops / rate)
