"""The split-precision (3xTF32) arithmetic of K1's and K5's f32 tensor-core
route, emulated in plain torch on the CPU, against the plain versions.

The kernels (csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu)
split each f32 operand x into hi = cvt.rna.tf32(x) and lo =
cvt.rna.tf32(x - hi) and form each product as lo·hi + hi·lo + hi·hi with f32
accumulation (csrc/mma.cuh). Here cvt.rna (round to 10 mantissa bits, ties
away from zero) is done with integer bit operations, and each product of
TF32 parts is an f32 matmul, which is exact per term (11 x 11 significant
bits) and sums in f32. The forward runs K1's schedule (32-key tiles, online
base-2 softmax, P kept in f32 and split), the backward K5's column-owned one
(64-key tiles sweeping 32-row tiles: S^T, dP^T, dv, both roles of dq). Both
are held to the card's f32 gates (chip_smoke.py,
tests/test_torch_kernels_cuda.py): |out - plain| <= 1e-4 + 1e-4 |plain|
with the lse within 1e-3, and K5's dq and dv within 1e-4 of the largest
plain entry. q is scaled as chip_smoke.py
scales it (|q|^2 ~ 4, as at the flagship). The negative control: one TF32
product (hi·hi alone, what torch's allow_tf32 means) misses those gates.
These sums round to nearest; the tensor cores' accumulate does not, and
drifts over long sums, which the kernels meet with a zeroed fragment a tile
and a rounded add (csrc/mma.cuh). So the kernels themselves are held
against the plain versions on the card, at L up to 16384.
"""

import math

import numpy as np
import pytest
import torch

from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa

_LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from zero
    (the magnitude's bits rounded half up, the sign kept)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in split precision: three TF32 products, the small ones first."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def _mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product."""
    return torch.matmul(_tf32(a), _tf32(b))


def _forward(q, v_cat, mm, tile=32):
    """K1's split-precision schedule: (out, base-2 lse)."""
    n, l, _ = q.shape
    m = torch.full((n, l, 1), -math.inf)
    den = torch.zeros(n, l, 1)
    acc = torch.zeros(n, l, v_cat.shape[-1])
    for k0 in range(0, l, tile):
        s = mm(q, q[:, k0:k0 + tile].transpose(1, 2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * _LOG2E)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * _LOG2E - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, v_cat[:, k0:k0 + tile])
        m = m_new
    return acc / den, (m + torch.log2(den))[..., 0]


def _backward(q, v_cat, lse, do_cat, dsum, mm, keys_tile=64, rows_tile=32):
    """K5's column-owned split-precision schedule: (dq, dv)."""
    l = q.shape[1]
    dq = torch.zeros_like(q)
    dv = torch.zeros_like(v_cat)
    for c0 in range(0, l, keys_tile):
        keys = slice(c0, c0 + keys_tile)
        dq_key = torch.zeros_like(q[:, keys])
        for r0 in range(0, l, rows_tile):
            rows = slice(r0, r0 + rows_tile)
            p_t = torch.exp2(mm(q[:, keys], q[:, rows].transpose(1, 2)) * _LOG2E
                             - lse[:, None, rows])
            dp_t = mm(v_cat[:, keys], do_cat[:, rows].transpose(1, 2))
            ds_t = p_t * (dp_t - dsum[:, None, rows])
            dv[:, keys] += mm(p_t, do_cat[:, rows])
            dq_key += mm(ds_t, q[:, rows])
            dq[:, rows] += mm(ds_t.transpose(1, 2), q[:, keys])
        dq[:, keys] += dq_key
    return dq, dv


def _inputs(seed, l, d, widths):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy((rs.randn(2, l, d) / d ** 0.5 * 2).astype(np.float32))
    vs = [torch.from_numpy(rs.randn(2, l, c).astype(np.float32)) for c in widths]
    do_cat = torch.from_numpy(rs.randn(2, l, sum(widths)).astype(np.float32))
    return q, vs, do_cat


def _gate_used(mm, seed, l, d, widths):
    """The largest share of its gate that the emulated forward (out, lse)
    and backward (dq, dv) use."""
    q, vs, do_cat = _inputs(seed, l, d, widths)
    v_cat = torch.cat(vs, -1)
    refs, lse_ref = fa.flash_attention_plain(q, vs, with_lse=True)
    ref = torch.cat(refs, -1)
    out, lse = _forward(q, v_cat, mm)
    fwd = float(((out - ref).abs() / (1e-4 + 1e-4 * ref.abs())).max())
    fwd = max(fwd, float((lse - lse_ref).abs().max()) / 1e-3)
    dsum = (do_cat * ref).sum(-1)
    want = fa.flash_attention_bwd_plain(q, v_cat, lse_ref, do_cat, dsum)
    got = _backward(q, v_cat, lse_ref, do_cat, dsum, mm)
    bwd = max(float((g - w).abs().max()) / (1e-4 * float(w.abs().max()))
              for g, w in zip(got, want))
    return fwd, bwd


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna.tf32.f32 keeps 10 mantissa bits, rounds a tie
    away from zero on either sign, and leaves tf32 values as they are."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 3 * ulp, 0.0, 3.0 * 2.0 ** -20], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 3 * ulp, 0.0, 3.0 * 2.0 ** -20])
    assert torch.equal(_tf32(x), want)
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11
    lo = _tf32(r - hi)
    assert float(((r - hi - lo).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("widths", [[24, 16], [64]])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [40, 300])
def test_split_precision_forward_meets_f32_gate(l, d, widths):
    """K1's three-product forward: out within 1e-4 + 1e-4 |plain|, lse within
    1e-3 of flash_attention_plain in f32 (L = 40: under one 128-row block
    and two key tiles; L = 300: ragged)."""
    fwd, _ = _gate_used(_mm3, 5, l, d, widths)
    assert fwd <= 1.0, fwd


@pytest.mark.parametrize("widths", [[24, 16], [64]])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [40, 300])
def test_split_precision_backward_meets_f32_gate(l, d, widths):
    """K5's three-product column-owned backward: dq and dv within 1e-4 of
    the largest entry of flash_attention_bwd_plain in f32."""
    _, bwd = _gate_used(_mm3, 6, l, d, widths)
    assert bwd <= 1.0, bwd


@pytest.mark.parametrize("direction", [0, 1])
def test_one_tf32_product_misses_the_gate(direction):
    """The negative control, at a fixed seed: with hi·hi alone, the forward
    (direction 0) and the backward (1) leave their f32 gates, where the
    three products stay inside them on the same inputs."""
    one = _gate_used(_mm1, 7, 300, 64, [64])[direction]
    three = _gate_used(_mm3, 7, 300, 64, [64])[direction]
    assert one > 1.0 and three <= 1.0, (one, three)
