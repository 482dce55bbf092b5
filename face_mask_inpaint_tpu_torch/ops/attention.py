"""Attention over the PICNet [HW, HW] self-similarity maps.

Port of face_mask_inpaint_tpu/ops/attention.py:

    out_j[n, i] = sum_k softmax_k(q_i . q_k) v_j[n, k]

(query == key, no 1/sqrt(d) scale, one shared map for several value tensors).
Up to ``block_threshold`` tokens the map is materialized; above it the
streaming formulation runs: kernel K1 forward and K5 backward on CUDA tensors,
their plain versions on CPU tensors, joined in one autograd Function.
"""

from __future__ import annotations

from typing import Sequence

import torch

from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa

__all__ = ["blockwise_attention", "attention_apply"]


def blockwise_attention(q: torch.Tensor, values: Sequence[torch.Tensor],
                        block_size: int = 4096) -> list[torch.Tensor]:
    """Streaming softmax over key blocks (query == key), f32 recurrence."""
    return fa.flash_attention_plain(q, values, block_size=block_size)


def attention_apply(query: torch.Tensor, values: Sequence[torch.Tensor],
                    block_threshold: int = 4096) -> list[torch.Tensor]:
    """query: [N, L, d]; values: each [N, L, C]. Returns one [N, L, C] per
    value."""
    if query.shape[1] <= block_threshold:
        q32 = query.to(torch.promote_types(query.dtype, torch.float32))
        att = torch.softmax(torch.matmul(q32, q32.transpose(1, 2)), dim=-1)
        att = att.to(query.dtype)
        return [torch.matmul(att.to(v.dtype), v) for v in values]
    return fa.flash_attention_autograd(query, values)
