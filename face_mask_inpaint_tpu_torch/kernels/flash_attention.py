"""K1: flash-attention forward (CUDA C++, ``csrc/flash_attention_fwd.cu``).

Replaces face_mask_inpaint_tpu/ops/pallas/flash_attention.py ``_forward``
(and ``_sym_forward``, the same function on another tile schedule):

    out_j[n, i] = sum_k softmax_k(q_i . q_k) v_j[n, k]

for q [N, L, d] and values v_j [N, L, C_j] sharing one map; query == key and
no 1/sqrt(d) scale. The CUDA source says what bounds it on the card and what
its design does about that.

``flash_attention`` launches the kernel for CUDA tensors and raises on what it
cannot take; for CPU tensors it runs ``flash_attention_plain``, a port of
``ops/attention.py:blockwise_attention`` chunked over keys, which is also what
the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from face_mask_inpaint_tpu_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain"]

_LOG2E = 1.4426950408889634
_D_MAX = 128  # the kernel's shared-memory plan holds d <= 128
_SYMBOLS = {torch.float32: "fmi_flash_attention_fwd_f32",
            torch.bfloat16: "fmi_flash_attention_fwd_bf16"}


def _split(out: torch.Tensor, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return list(torch.split(out, [v.shape[-1] for v in values], dim=-1))


def flash_attention_plain(q: torch.Tensor, values: Sequence[torch.Tensor],
                          block_size: int = 4096, with_lse: bool = False):
    """Plain PyTorch version: streaming softmax over key blocks in f32.

    Returns the outputs (each in its value's dtype) and, with ``with_lse``,
    the per-row log-sum-exp in base 2, ``[N, L]`` f32, as the kernel does.
    """
    n, l, _ = q.shape
    qf = q.float()
    v_cat = torch.cat([v.float() for v in values], dim=-1)
    m = torch.full((n, l, 1), -math.inf, dtype=torch.float32, device=q.device)
    denom = torch.zeros((n, l, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, l, v_cat.shape[-1]), dtype=torch.float32, device=q.device)
    for start in range(0, l, block_size):
        s = torch.matmul(qf, qf[:, start:start + block_size].transpose(1, 2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v_cat[:, start:start + block_size])
        m = m_new
    outs = [o.to(v.dtype) for o, v in zip(_split(acc / denom, values), values)]
    if with_lse:
        return outs, (m + torch.log(denom))[..., 0] * _LOG2E
    return outs


def _check(q: torch.Tensor, values: Sequence[torch.Tensor]) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be [N, L, d], got {tuple(q.shape)}")
    n, l, d = q.shape
    if q.dtype not in _SYMBOLS:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if not 1 <= d <= _D_MAX:
        raise ValueError(f"head dim {d} outside the kernel's 1..{_D_MAX}")
    if not values:
        raise ValueError("flash_attention needs at least one value tensor")
    for t in (q, *values):
        if t.device != q.device:
            raise ValueError("q and values must lie on one device")
        if t.dtype != q.dtype:
            raise TypeError(f"value dtype {t.dtype} differs from q's {q.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous tensors")
    for v in values:
        if v.dim() != 3 or v.shape[:2] != (n, l):
            raise ValueError(f"value {tuple(v.shape)} does not match q {tuple(q.shape)}")


def _function(dtype: torch.dtype):
    fn = getattr(build.load("flash_attention_fwd"), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, values: Sequence[torch.Tensor],
                    with_lse: bool = False):
    """out_j = softmax(q q^T) v_j for each value, one shared map.

    q: [N, L, d]; values: list of [N, L, C_j], same dtype as q (float32 or
    bfloat16). CPU tensors take the plain version; CUDA tensors launch K1.
    Returns the list of outputs, plus lse [N, L] (base 2) with ``with_lse``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, values, with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, values)
    n, l, d = q.shape
    v_cat = values[0] if len(values) == 1 else torch.cat(list(values), dim=-1)
    out = torch.empty((n, l, v_cat.shape[-1]), dtype=q.dtype, device=q.device)
    lse = (torch.empty((n, l), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = _function(q.dtype)(
            q.data_ptr(), v_cat.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            n, l, d, v_cat.shape[-1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {rc}")
    flash_attention.launches += 1
    outs = _split(out, values)
    return (outs, lse) if with_lse else outs


flash_attention.launches = 0
