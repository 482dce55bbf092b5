"""The flash-attention backward of the port on the CPU: the K1/K5 autograd
Function (plain forward and ``flash_attention_bwd_plain`` here) against
autograd of the plain forward, and ``flash_attention_bwd_plain`` against
``jax.grad`` of the JAX ``flash_attention`` (Pallas in interpret mode, as
tests/test_attention.py runs it) in its triangular (``FMI_FLASH_SYM_BWD=1``)
and split (``FMI_FLASH_SYM_BWD=0``, ``FMI_FLASH_FUSED_BWD=0``) backward.
The kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
from face_mask_inpaint_tpu_torch.ops.attention import attention_apply


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, n, l, d, widths, scale=1.0):
    rs = np.random.RandomState(seed)
    q = (rs.randn(n, l, d) * scale).astype(np.float32)
    vs = [rs.randn(n, l, c).astype(np.float32) for c in widths]
    gs = [rs.randn(n, l, c).astype(np.float32) for c in widths]
    return q, vs, gs


# max |got - want| <= tol * max |want|: float32 differs from the float64
# reference by f32 rounding; bfloat16 rounds the inputs, P and the summed dS
# to bf16 (2^-8 relative) before f32 products
FN_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [[24], [16, 8]])
def test_autograd_function_matches_autograd_of_plain(dtype, widths):
    """Ragged L = 300; one value (AutoAttention) and two sharing a map
    (ExampleGuidedAttention). The reference is float64 autograd of the plain
    forward on the same (rounded) inputs. Outputs and grads keep their
    dtypes."""
    q, vs, gs = _inputs(0, 2, 300, 12, widths, scale=0.7)
    qt = torch.from_numpy(q).to(dtype).requires_grad_()
    vt = [torch.from_numpy(v).to(dtype).requires_grad_() for v in vs]
    outs = fa.flash_attention_autograd(qt, vt)
    got = torch.autograd.grad(outs, [qt, *vt], [torch.from_numpy(g).to(dtype) for g in gs])
    q64 = qt.detach().double().requires_grad_()
    v64 = [v.detach().double().requires_grad_() for v in vt]
    ref = fa.flash_attention_plain(q64, v64, block_size=128)
    want = torch.autograd.grad(ref, [q64, *v64], [torch.from_numpy(g).double() for g in gs])
    for g, w, t in zip(got, want, (qt, *vt)):
        assert g.dtype == t.dtype and g.shape == t.shape
        err = float((g.double() - w).abs().max())
        assert err <= FN_TOL[dtype] * float(w.abs().max()), err


def test_attention_apply_streams_through_the_function():
    """Above block_threshold, attention_apply's gradients are those of the
    materialized map (f32 max-abs 1e-5 relative)."""
    q, vs, gs = _inputs(1, 2, 200, 8, [16])
    grads = []
    for threshold in (100, 4096):
        qt = torch.from_numpy(q).requires_grad_()
        vt = torch.from_numpy(vs[0]).requires_grad_()
        (out,) = attention_apply(qt, [vt], block_threshold=threshold)
        grads.append(torch.autograd.grad(out, [qt, vt], torch.from_numpy(gs[0])))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_plain_backward_is_independent_of_its_block():
    """Column blocks of 64 (ragged last block) and one block of all L give
    the same dq and dv (f32 max-abs 1e-6 relative)."""
    q, vs, gs = _inputs(2, 1, 300, 8, [24])
    qt, vt, dt = (torch.from_numpy(a) for a in (q, vs[0], gs[0]))
    (out,), lse = fa.flash_attention_plain(qt, [vt], with_lse=True)
    dsum = (dt * out).sum(-1)
    a = fa.flash_attention_bwd_plain(qt, vt, lse, dt, dsum, block_size=64)
    b = fa.flash_attention_bwd_plain(qt, vt, lse, dt, dsum, block_size=300)
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max())


@pytest.mark.parametrize("variant", ["sym", "split"])
def test_plain_backward_matches_jax_grad(monkeypatch, variant):
    """flash_attention_bwd_plain from the plain forward's lse against the VJP
    of the JAX flash_attention (tiles of 128, L = 300: ragged), two values:
    the triangular backward (FMI_FLASH_SYM_BWD=1, FMI_FLASH_SYM_T=128) and
    the split dq/dkv kernels. f32 max-abs 1e-4 of each gradient's largest
    entry (sums in another order)."""
    if variant == "sym":
        monkeypatch.setenv("FMI_FLASH_SYM_BWD", "1")
        monkeypatch.setenv("FMI_FLASH_SYM_T", "128")
    else:
        monkeypatch.setenv("FMI_FLASH_SYM_BWD", "0")
        monkeypatch.setenv("FMI_FLASH_FUSED_BWD", "0")
    monkeypatch.setenv("FMI_FLASH_SYM", "0")
    q, vs, gs = _inputs(3, 2, 300, 8, [24, 16], scale=1.5)

    def run(q, v1, v2):
        return tuple(j_flash(q, [v1, v2], tq=128, tk=128))

    _, vjp = jax.vjp(run, *(jnp.asarray(a) for a in (q, *vs)))
    want = vjp(tuple(jnp.asarray(g) for g in gs))

    qt = torch.from_numpy(q)
    vt = [torch.from_numpy(v) for v in vs]
    outs, lse = fa.flash_attention_plain(qt, vt, with_lse=True)
    do_cat = torch.from_numpy(np.concatenate(gs, -1))
    dsum = (do_cat * torch.cat(outs, -1)).sum(-1)
    dq, dv = fa.flash_attention_bwd_plain(qt, torch.cat(vt, -1), lse, do_cat, dsum)
    got = (dq, *torch.split(dv, [24, 16], -1))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


_LOG2E = 1.4426950408889634


def _column_owned(q, v_cat, lse, do_cat, dsum, tile=64):
    """The tensor-core K5's decomposition on the CPU: each 64-key tile sweeps
    every 64-row tile; dv and the key role of dq stay with the key tile, the
    query role of dq is added to an f32 accumulator that also takes the key
    role; P and each dS rounded to the input dtype before their products.
    Returns (dq, dv)."""
    dtype = q.dtype
    n, l, _ = q.shape
    qf, vf, dof = q.float(), v_cat.float(), do_cat.float()
    acc = torch.zeros_like(qf)
    dv = torch.zeros_like(vf)
    tiles = -(-l // tile)
    for ct in range(tiles):
        keys = slice(ct * tile, (ct + 1) * tile)
        dq_key = torch.zeros_like(qf[:, keys])
        for rt in range(tiles):
            rows = slice(rt * tile, (rt + 1) * tile)
            s_t = torch.matmul(qf[:, keys], qf[:, rows].transpose(1, 2))   # [N, keys, rows]
            p_t = torch.exp2(s_t * _LOG2E - lse[:, None, rows].float())
            dv[:, keys] += torch.matmul(p_t.to(dtype).float(), dof[:, rows])
            dp_t = torch.matmul(vf[:, keys], dof[:, rows].transpose(1, 2))
            ds_t = (p_t * (dp_t - dsum[:, None, rows].float())).to(dtype).float()
            dq_key += torch.matmul(ds_t, qf[:, rows])
            acc[:, rows] += torch.matmul(ds_t.transpose(1, 2), qf[:, keys])
        acc[:, keys] += dq_key
    return acc.to(dtype), dv.to(v_cat.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [40, 300])
def test_column_owned_decomposition_matches_plain(dtype, l):
    """The tensor-core K5's decomposition (each dS[r, c] rounded apart, as
    the JAX `_backward` rounds it, where the plain version rounds the summed
    dS once) gives the plain version's dq and dv: float32 within 1e-5 and
    bfloat16 within 1e-2 of each output's largest entry (the card's BWD_TOL;
    one rounding per term more or less, inside sums of hundreds)."""
    q, vs, gs = _inputs(4, 2, l, 16, [24, 16], scale=0.7)
    qt = torch.from_numpy(q).to(dtype)
    vt = [torch.from_numpy(v).to(dtype) for v in vs]
    outs, lse = fa.flash_attention_plain(qt, vt, with_lse=True)
    v_cat, do_cat = torch.cat(vt, -1), torch.from_numpy(np.concatenate(gs, -1)).to(dtype)
    dsum = (do_cat.float() * torch.cat(outs, -1).float()).sum(-1)
    dq, dv = _column_owned(qt, v_cat, lse, do_cat, dsum)
    want = fa.flash_attention_bwd_plain(qt, v_cat, lse, do_cat, dsum)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, ref in zip((dq, dv), want):
        assert got.dtype == ref.dtype
        err = float((got.float() - ref.float()).abs().max())
        assert err <= tol * float(ref.float().abs().max()), err
