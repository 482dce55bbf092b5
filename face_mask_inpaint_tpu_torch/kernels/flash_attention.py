"""K1 and K5: flash-attention forward and backward (CUDA C++,
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``).

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

K5 replaces the backward kernels of the JAX ``custom_vjp`` (``_backward_sym``,
``_backward_fused`` and ``_backward``, one function): from K1's base-2 lse and
D = rowsum(dO * O) it returns dq (both roles of the tied q == k summed) and
dv. ``flash_attention_bwd`` launches it for CUDA tensors and runs
``flash_attention_bwd_plain`` for CPU tensors. ``flash_attention_autograd``
joins K1 and K5 in one ``torch.autograd.Function``.

Both kernels choose their route on the C side, by type, shape and alignment
only (``flash_attention_route``, ``flash_attention_bwd_route``). At d in
{32, 64} (K1 in bf16: d = 64) and C <= 256 with C % 8 == 0, bf16 runs on the
tensor cores and f32 on the tensor cores in split precision ("tf32x3": each
f32 operand as two TF32 parts, three products, held to the f32 gates; not
the one-product TF32 that ``torch.backends.cuda.matmul.allow_tf32`` means,
and not governed by it); everything else on the CUDA cores. On K5's tensor
core routes dq's two roles meet through f32 atomics, so dq is not
bit-deterministic there.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from face_mask_inpaint_tpu_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_route",
           "flash_attention_bwd", "flash_attention_bwd_plain", "flash_attention_bwd_route",
           "flash_attention_autograd"]

_LOG2E = 1.4426950408889634
_D_MAX = 128  # the kernel's shared-memory plan holds d <= 128
_SYMBOLS = {torch.float32: "fmi_flash_attention_fwd_f32",
            torch.bfloat16: "fmi_flash_attention_fwd_bf16"}
_BWD_SYMBOLS = {torch.float32: "fmi_flash_attention_bwd_f32",
                torch.bfloat16: "fmi_flash_attention_bwd_bf16"}


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


@functools.lru_cache(maxsize=None)
def _route_function():
    fn = build.load("flash_attention_fwd").fmi_flash_attention_fwd_route
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


_ROUTES = {2: "wgmma", 1: "tf32x3", 0: "cuda_cores"}


def flash_attention_route(q: torch.Tensor, values: Sequence[torch.Tensor]) -> str:
    """"wgmma", "tf32x3" or "cuda_cores": the K1 kernel that a call on these
    CUDA tensors launches. The C side decides, by type, shape and alignment
    only: with C <= 256, C % 8 == 0 and 16-byte aligned rows, bf16 at d = 64
    takes the warpgroup kernel and f32 at d in {32, 64} the split-precision
    (3xTF32) kernel; the rest the CUDA cores. The values are concatenated
    and the output allocated as the call does it, so v_cat's alignment
    stands for both."""
    _check(q, values)
    n, l, d = q.shape
    v_cat = values[0] if len(values) == 1 else torch.cat(list(values), dim=-1)
    return _ROUTES[_route_function()(q.dtype == torch.bfloat16, q.data_ptr(), v_cat.data_ptr(),
                                     v_cat.data_ptr(), n, l, d, v_cat.shape[-1])]


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


def flash_attention_bwd_plain(q: torch.Tensor, v_cat: torch.Tensor, lse: torch.Tensor,
                              do_cat: torch.Tensor, dsum: torch.Tensor,
                              block_size: int = 1024):
    """Plain PyTorch version of K5: the explicit backward, chunked over
    column blocks in f32, with no autograd through the forward.

    q [N, L, d]; v_cat, do_cat [N, L, C]; lse [N, L] (base 2, from K1);
    dsum [N, L] = rowsum(dO * O) in f32. With S2 = log2(e) q q^T (S
    symmetric, so both probability maps come from one score block):
    P[r, c] = exp2(S2 - lse_r), P[c, r] = exp2(S2 - lse_c),
    dq_r = sum_c (P[r, c](dO_r v_c - D_r) + P[c, r](v_r dO_c - D_c)) q_c,
    dv_r = sum_c P[c, r] dO_c. P and the summed dS are rounded to the input
    dtype before their products, as the kernels round them. Returns (dq in
    q's dtype, dv [N, L, C] in v_cat's dtype).
    """
    dtype = q.dtype
    qf, vf, dof = q.float(), v_cat.float(), do_cat.float()
    q2 = qf * _LOG2E
    lse_r, d_r = lse[:, :, None].float(), dsum[:, :, None].float()
    dq = torch.zeros_like(qf)
    dv = torch.zeros_like(vf)
    for start in range(0, q.shape[1], block_size):
        cols = slice(start, start + block_size)
        s2 = torch.matmul(q2, qf[:, cols].transpose(1, 2))        # [N, L, B]
        p_cr = torch.exp2(s2 - lse[:, None, cols].float())         # P[c, r] as [r, c]
        ds = torch.exp2(s2 - lse_r) * (torch.matmul(dof, vf[:, cols].transpose(1, 2)) - d_r)
        ds += p_cr * (torch.matmul(vf, dof[:, cols].transpose(1, 2))
                      - dsum[:, None, cols].float())
        dq += torch.matmul(ds.to(dtype).float(), qf[:, cols])
        dv += torch.matmul(p_cr.to(v_cat.dtype).float(), dof[:, cols])
    return dq.to(dtype), dv.to(v_cat.dtype)


def _bwd_function(dtype: torch.dtype):
    """The C entry point; bf16's takes an f32 dq scratch after dv."""
    fn = getattr(build.load("flash_attention_bwd"), _BWD_SYMBOLS[dtype])
    n_ptrs = 8 if dtype == torch.bfloat16 else 7
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_route_function():
    fn = build.load("flash_attention_bwd").fmi_flash_attention_bwd_route
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn


_BWD_ROUTES = {1: "tensor_cores", 2: "tf32x3", 0: "cuda_cores"}


def _bwd_route(q, v_cat, do_cat, dq, dv) -> str:
    """The K5 route of a call: the C side decides, by type, shape and
    alignment (d in {32, 64}, C <= 256 with C % 8 == 0, 16-byte aligned:
    bf16 on the tensor cores, f32 in split precision)."""
    return _BWD_ROUTES[_bwd_route_function()(
        q.dtype == torch.bfloat16, q.data_ptr(), v_cat.data_ptr(), do_cat.data_ptr(),
        dq.data_ptr(), dv.data_ptr(), q.shape[-1], v_cat.shape[-1])]


def flash_attention_bwd_route(q: torch.Tensor, v_cat: torch.Tensor) -> str:
    """"tensor_cores" (bf16), "tf32x3" (f32) or "cuda_cores": the K5 route of
    a call on these CUDA tensors (dO and the outputs are allocated as they
    are, so q's and v_cat's alignment decides)."""
    return _bwd_route(q, v_cat, v_cat, q, v_cat)


def flash_attention_bwd(q: torch.Tensor, v_cat: torch.Tensor, lse: torch.Tensor,
                        do_cat: torch.Tensor, dsum: torch.Tensor):
    """K5: (dq, dv) of out = softmax(q q^T) v_cat for the output gradient
    do_cat, from K1's base-2 lse and dsum = rowsum(dO * O) (f32 [N, L]).

    q [N, L, d]; v_cat, do_cat [N, L, C], all of q's dtype (float32 or
    bfloat16). CPU tensors take the plain version; CUDA tensors launch K5.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, v_cat, lse, do_cat, dsum)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not {q.device}")
    _check(q, [v_cat, do_cat])
    n, l, d = q.shape
    if do_cat.shape != v_cat.shape:
        raise ValueError(f"do_cat {tuple(do_cat.shape)} differs from v {tuple(v_cat.shape)}")
    for t in (lse, dsum):
        if (t.shape != (n, l) or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError("lse and dsum must be contiguous float32 [N, L] on q's device")
    dq = torch.empty_like(q)
    dv = torch.empty_like(v_cat)
    ptrs = [q.data_ptr(), v_cat.data_ptr(), do_cat.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), dq.data_ptr(), dv.data_ptr()]
    if q.dtype == torch.bfloat16:
        # the tensor-core kernels sum dq's two roles in f32 here
        work = (torch.empty((n, l, d), dtype=torch.float32, device=q.device)
                if _bwd_route(q, v_cat, do_cat, dq, dv) == "tensor_cores" else None)
        ptrs.append(None if work is None else work.data_ptr())
    with torch.cuda.device(q.device):
        rc = _bwd_function(q.dtype)(*ptrs, n, l, d, v_cat.shape[-1],
                                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {rc}")
    flash_attention_bwd.launches += 1
    return dq, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward and K5 backward (JAX ``custom_vjp``, flash_attention.py
    :791-841): the forward saves q, the concatenated values, the outputs and
    the base-2 lse; the backward forms D = rowsum(dO * O) in f32 and returns
    dq in q's dtype and each dv in its value's dtype."""

    @staticmethod
    def forward(ctx, q, *values):
        outs, lse = flash_attention(q, list(values), with_lse=True)
        ctx.widths = [v.shape[-1] for v in values]
        v_cat = values[0] if len(values) == 1 else torch.cat(values, dim=-1)
        o_cat = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        ctx.save_for_backward(q, v_cat, o_cat, lse)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        q, v_cat, o_cat, lse = ctx.saved_tensors
        do_cat = torch.cat([torch.zeros(q.shape[:2] + (c,), dtype=v_cat.dtype, device=q.device)
                            if g is None else g.to(v_cat.dtype)
                            for g, c in zip(grads, ctx.widths)], dim=-1).contiguous()
        dsum = (do_cat.float() * o_cat.float()).sum(dim=-1)
        dq, dv = flash_attention_bwd(q, v_cat, lse, do_cat, dsum)
        return (dq, *torch.split(dv, ctx.widths, dim=-1))


def flash_attention_autograd(q: torch.Tensor, values: Sequence[torch.Tensor]):
    """``flash_attention`` with gradients: K1 forward, K5 backward on CUDA
    tensors, the plain versions on CPU tensors. Without grad mode or inputs
    that need one, it is ``flash_attention`` itself (no lse is kept)."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, *values))):
        return flash_attention(q, values)
    return list(_FlashAttention.apply(q, *values))
