"""K1, K5, K2, K3, K4a, K4b, K6 (forward and backward), K7a and K7b against
their plain versions on an NVIDIA GPU, on each of their routes (K1: the
warpgroup kernel in bf16, the split-precision (3xTF32) kernel in f32 and the
CUDA-core kernel; K5: tensor cores in bf16, split precision in f32 and CUDA
cores; K4a and K4b: tensor cores and CUDA cores), with each route's choice
by shape and alignment.
Marked ``cuda``: they skip where torch.cuda.is_available() is False (the
decision is taken in a fixture, at run time). Run on the card, where JAX need
not be installed, with
``python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest``.

K5 (the flash-attention backward) is held against
``flash_attention_bwd_plain`` for dq and each dv at ragged L, on both of its
paths (CUDA cores, tensor cores), and through the autograd Function that joins
it with K1. K2's autograd Function is held against autograd of its plain
version, and so are the K6 Function (its backward K6 again, with the modes
swapped) and the K7a/K7b Function, grad-of-grad included. K3, K4a and K4b
have no backward: their wrappers raise under grad mode when an input or
weight requires grad, and run under ``torch.no_grad()``. K6 rounds its H pass and its output, each once, so its
bfloat16 tolerance adds rtol times the sum of the output's terms' magnitudes
(see the test).

Tolerance: |kernel - plain| <= atol + rtol |plain| with (1e-4, 1e-4) in
float32 (TF32 off; only the order of f32 sums differs, and on K1's and K5's
split-precision route the about 21 bits the split keeps of each operand)
and (1e-3, 2^-7) in
bfloat16 (each side rounds an f32 result once: one bf16 ulp apart at most).
K5's dq and dv are held to max |kernel - plain| <= tol * max |plain| with tol
1e-4 in float32 and 1e-2 in bfloat16: in bfloat16 both sides round P and dS
before their products, from f32 values summed in another order (the
tensor-core route rounds each dS[r, c] apart where the plain version rounds
the summed dS[r, c] + dS[c, r], and adds dq's terms with atomics in a
run-dependent order), so single rounded terms may differ by one bf16 ulp
(2^-8 relative) inside sums of thousands.
The f32 sums of y and y^2 that K4a and K4b return are held to rtol 1e-4
(f32) and 1e-3 (bf16), with an atol of rtol times the largest sum: the two
sides add the same f32 values in another order.
"""

import pytest
import torch

from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
from face_mask_inpaint_tpu_torch.kernels import norm_act as na
from face_mask_inpaint_tpu_torch.kernels import output_head as oh

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2.0 ** -7)}
STATS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,l,d,widths", [
    (2, 320, 8, [24, 16]), (2, 257, 128, [130]),                        # CUDA-core path
    (1, 4100, 64, [256]),     # bf16: warpgroup (wgmma) path; f32: split precision (tf32x3)
    (2, 300, 128, [264]),                                               # CUDA-core path
    (2, 257, 32, [128, 8]),              # bf16: CUDA-core path; f32: split precision
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, n, l, d, widths):
    q = (torch.randn(n, l, d, device="cuda", generator=cuda) * 0.5).to(dtype)
    vs = [torch.randn(n, l, c, device="cuda", generator=cuda).to(dtype) for c in widths]
    before = fa.flash_attention.launches
    outs, lse = fa.flash_attention(q, vs, with_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    refs, lse_ref = fa.flash_attention_plain(q, vs, with_lse=True)
    for o, r in zip(outs, refs):
        assert o.dtype == dtype
        _assert_close(o, r, dtype)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


# d = 64 in bf16 with C <= 256: the warpgroup kernel, at L of one key, under,
# at and just over one 128-row query block, and ragged over many; C of the
# flagship (256), of Stack A's two values (200 + 56), of one 64-wide box,
# and C that ends inside a box or before the second, third or fourth one
# (TMA zero-fills the channels past C)
@pytest.mark.parametrize("l", [1, 100, 128, 130, 4100])
@pytest.mark.parametrize("widths", [[256], [200, 56], [64], [8], [72], [200]])
def test_flash_attention_wgmma_route_matches_plain(cuda, l, widths):
    q = (torch.randn(2, l, 64, device="cuda", generator=cuda) / 4).to(torch.bfloat16)
    vs = [torch.randn(2, l, c, device="cuda", generator=cuda).to(torch.bfloat16) for c in widths]
    assert fa.flash_attention_route(q, vs) == "wgmma"
    before = fa.flash_attention.launches
    outs, lse = fa.flash_attention(q, vs, with_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    refs, lse_ref = fa.flash_attention_plain(q, vs, with_lse=True)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        _assert_close(o, r, torch.bfloat16)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


# f32 at d in {32, 64} with C <= 256: the split-precision (3xTF32) kernel, at
# L of one key, under and just over one 128-row query block, and ragged over
# many key tiles; C of the flagship (256), of Stack A's two values (200 +
# 56), of one n-tile (8) and ending inside a 64-channel group (72). It is
# held to the f32 gate (TF32 off), not to a TF32 one.
@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("l", [1, 100, 130, 4100])
@pytest.mark.parametrize("widths", [[256], [200, 56], [8], [72]])
def test_flash_attention_tf32x3_route_matches_plain(cuda, d, l, widths):
    q = torch.randn(2, l, d, device="cuda", generator=cuda) / d ** 0.5 * 2
    vs = [torch.randn(2, l, c, device="cuda", generator=cuda) for c in widths]
    assert fa.flash_attention_route(q, vs) == "tf32x3"
    before = fa.flash_attention.launches
    outs, lse = fa.flash_attention(q, vs, with_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    refs, lse_ref = fa.flash_attention_plain(q, vs, with_lse=True)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32 and o.shape == r.shape
        _assert_close(o, r, torch.float32)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


def test_flash_attention_routes(cuda):
    """bf16 at d = 64 and C <= 256 (C % 8 == 0) takes the warpgroup kernel,
    the flagship and config 5 (C = 256) among them; f32 at d in {32, 64}
    and C <= 256 the split-precision (tf32x3) kernel; other shapes (d = 48
    among them, and bf16 at d in {32, 128} or C > 256), misaligned tensors
    the CUDA cores."""
    def route(d, widths, dtype=torch.bfloat16, offset=0):
        q = torch.zeros(2, 8, d, device="cuda", dtype=dtype)
        return fa.flash_attention_route(q, [
            torch.zeros(2 * 8 * c + offset, device="cuda", dtype=dtype)[offset:].view(2, 8, c)
            for c in widths])
    assert route(64, [256]) == route(64, [200, 56]) == route(64, [8]) == "wgmma"
    assert route(64, [264]) == route(32, [256]) == route(128, [64]) == "cuda_cores"
    assert route(48, [256]) == route(64, [60]) == "cuda_cores"
    assert route(64, [256], offset=1) == "cuda_cores"
    assert route(64, [200, 56], offset=1) == "wgmma"  # concatenated into a new tensor
    f32 = torch.float32
    assert route(64, [256], f32) == route(64, [200, 56], f32) == route(32, [8], f32) == "tf32x3"
    assert route(48, [256], f32) == route(64, [264], f32) == route(64, [60], f32) == "cuda_cores"
    assert route(128, [64], f32) == route(64, [256], f32, offset=1) == "cuda_cores"


def test_flash_attention_kernel_rejects_bad_input(cuda):
    q = torch.randn(1, 64, 8, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention(q, [torch.randn(1, 64, 4, device="cuda", dtype=torch.bfloat16)])
    with pytest.raises(ValueError):
        fa.flash_attention(q, [torch.randn(1, 4, 64, device="cuda").transpose(1, 2)])
    with pytest.raises(ValueError):
        fa.flash_attention(torch.randn(1, 64, 256, device="cuda"),
                           [torch.randn(1, 64, 4, device="cuda")])


def _assert_bwd_close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert err <= BWD_TOL[dtype] * float(want.float().abs().max()), err


def _bwd_inputs(gen, n, l, d, widths, dtype):
    # |q|^2 ~ 2: spread maps, so dq is not a near-cancelling sum (with a
    # near one-hot map dS ~ 0 and dq is rounding noise on both sides)
    q = (torch.randn(n, l, d, device="cuda", generator=gen) * 1.5 / d ** 0.5).to(dtype)
    vs = [torch.randn(n, l, c, device="cuda", generator=gen).to(dtype) for c in widths]
    outs, lse = fa.flash_attention_plain(q, vs, with_lse=True)
    v_cat, o_cat = torch.cat(vs, dim=-1), torch.cat(outs, dim=-1)
    do_cat = torch.randn(v_cat.shape, device="cuda", generator=gen).to(dtype)
    dsum = (do_cat.float() * o_cat.float()).sum(dim=-1)
    return q, v_cat, lse, do_cat, dsum


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,l,d,widths", [
    (2, 320, 8, [24, 16]), (2, 257, 128, [130]), (1, 300, 48, [64]),   # CUDA cores
    (2, 300, 128, [264]), (1, 130, 64, [264]), (1, 90, 64, [36]),      # CUDA cores (C)
    # bf16: tensor cores; f32: split precision (tf32x3)
    (1, 4100, 64, [256]), (2, 257, 32, [128, 8]),
    (2, 40, 64, [256]), (2, 4100, 64, [200, 56]), (1, 333, 32, [64]),  # L < one tile, ragged
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, dtype, n, l, d, widths):
    q, v_cat, lse, do_cat, dsum = _bwd_inputs(cuda, n, l, d, widths, dtype)
    before = fa.flash_attention_bwd.launches
    dq, dv = fa.flash_attention_bwd(q, v_cat, lse, do_cat, dsum)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    dq_ref, dv_ref = fa.flash_attention_bwd_plain(q, v_cat, lse, do_cat, dsum)
    assert dq.dtype == dtype and dv.dtype == dtype
    _assert_bwd_close(dq, dq_ref, dtype)
    for got, want in zip(torch.split(dv, widths, -1), torch.split(dv_ref, widths, -1)):
        _assert_bwd_close(got, want, dtype)


# f32 at d in {32, 64} with C <= 256: K5's split-precision (3xTF32) kernel,
# at L of one key, under one 64-key tile and ragged over many (L = 4100 runs
# dv and dq's key role over 129 row tiles, where the tensor cores'
# accumulate would drift without the rounded adds); the widths of K1's case
@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("l", [1, 100, 130, 4100])
@pytest.mark.parametrize("widths", [[256], [200, 56], [8], [72]])
def test_flash_attention_bwd_tf32x3_route_matches_plain(cuda, d, l, widths):
    q = torch.randn(2, l, d, device="cuda", generator=cuda) / d ** 0.5 * 2
    vs = [torch.randn(2, l, c, device="cuda", generator=cuda) for c in widths]
    outs, lse = fa.flash_attention_plain(q, vs, with_lse=True)
    v_cat = torch.cat(vs, dim=-1)
    do_cat = torch.randn(v_cat.shape, device="cuda", generator=cuda)
    dsum = (do_cat * torch.cat(outs, dim=-1)).sum(dim=-1)
    assert fa.flash_attention_bwd_route(q, v_cat) == "tf32x3"
    before = fa.flash_attention_bwd.launches
    dq, dv = fa.flash_attention_bwd(q, v_cat, lse, do_cat, dsum)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    dq_ref, dv_ref = fa.flash_attention_bwd_plain(q, v_cat, lse, do_cat, dsum)
    assert dq.dtype == dv.dtype == torch.float32
    if l == 1:
        # one key: P = 1 and dS = dO.v - D is exactly 0, so dq = 2 dS q is,
        # on both sides, what is left of two terms of size sum_k |dO_k v_k|
        # that cancel; it is held to 1e-4 of 2 sum_k |dO_k v_k| |q|, the
        # size dq would have from either term alone
        size = 2 * (do_cat * v_cat).abs().sum(-1, keepdim=True) * q.abs()
        assert bool(((dq - dq_ref).abs() <= 1e-4 * size).all())
    else:
        _assert_bwd_close(dq, dq_ref, torch.float32)
    for got, want in zip(torch.split(dv, widths, -1), torch.split(dv_ref, widths, -1)):
        _assert_bwd_close(got, want, torch.float32)


def test_flash_attention_bwd_routes(cuda):
    """bf16 at d in {32, 64} and C <= 256 (C % 8 == 0) takes the tensor
    cores, config 5 (d = 64, C = 256) among them, and f32 at the same shapes
    the split-precision (tf32x3) kernel; other shapes and misaligned tensors
    take the CUDA cores."""
    def route(d, c, dtype=torch.bfloat16, offset=0):
        q = torch.zeros(2, 8, d, device="cuda", dtype=dtype)
        v = torch.zeros(2 * 8 * c + offset, device="cuda", dtype=dtype)[offset:].view(2, 8, c)
        return fa.flash_attention_bwd_route(q, v)
    assert route(64, 256) == "tensor_cores"  # config 5
    assert route(64, 200 + 56) == route(32, 136) == route(64, 8) == "tensor_cores"
    assert route(48, 256) == route(128, 256) == route(64, 264) == route(64, 60) == "cuda_cores"
    assert route(64, 256, offset=1) == "cuda_cores"
    f32 = torch.float32
    assert route(64, 256, f32) == route(64, 200 + 56, f32) == route(32, 8, f32) == "tf32x3"
    assert route(48, 256, f32) == route(64, 264, f32) == route(64, 60, f32) == "cuda_cores"
    assert route(64, 256, f32, offset=1) == "cuda_cores"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_launches_k1_and_k5(cuda, dtype):
    q = (torch.randn(2, 700, 64, device="cuda", generator=cuda) * 0.2).to(dtype)
    vs = [torch.randn(2, 700, c, device="cuda", generator=cuda).to(dtype) for c in (64, 32)]
    gs = [torch.randn(2, 700, c, device="cuda", generator=cuda).to(dtype) for c in (64, 32)]
    leaves = [t.clone().requires_grad_() for t in (q, *vs)]
    k1, k5 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    outs = fa.flash_attention_autograd(leaves[0], leaves[1:])
    grads = torch.autograd.grad(outs, leaves, gs)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == (k1 + 1, k5 + 1)
    outs_ref, lse = fa.flash_attention_plain(q, vs, with_lse=True)
    do_cat = torch.cat(gs, -1)
    dsum = (do_cat.float() * torch.cat(outs, -1).detach().float()).sum(-1)
    dq_ref, dv_ref = fa.flash_attention_bwd_plain(q, torch.cat(vs, -1), lse, do_cat, dsum)
    _assert_bwd_close(grads[0], dq_ref, dtype)
    for got, want in zip(grads[1:], torch.split(dv_ref, [64, 32], -1)):
        _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_act_function_grads_match_plain_autograd(cuda, dtype):
    x = (torch.randn(2, 5, 33, 40, device="cuda", generator=cuda) * 2 + 1).to(dtype)
    w = torch.randn(5, device="cuda", generator=cuda)
    b = torch.randn(5, device="cuda", generator=cuda)
    dy = torch.randn(x.shape, device="cuda", generator=cuda).to(dtype)
    got_in = [t.clone().requires_grad_() for t in (x, w, b)]
    want_in = [t.clone().requires_grad_() for t in (x, w, b)]
    before = na.instance_norm_act.launches
    got = torch.autograd.grad(na.instance_norm_act(*got_in, "LeakyReLU"), got_in, dy)
    assert na.instance_norm_act.launches == before + 1
    want = torch.autograd.grad(na.instance_norm_act_plain(*want_in, "LeakyReLU"), want_in, dy)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        torch.testing.assert_close(g.float(), w_.float(), atol=1e-4, rtol=1e-4)


def test_kernels_without_backward_raise_under_grad(cuda):
    h, s, w, b = _head_inputs(cuda, (1, 4, 16, 16), 3, torch.float32)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        oh.output_head(h, s, w, b, "LeakyReLU", 2)
    x = torch.randn(1, 4, 8, 8, device="cuda", requires_grad=True)
    wc = torch.randn(5, 4, 3, 3, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        dc.conv3x3_stats(x, wc, None)
    wt = torch.randn(4, 5, 3, 3, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        dc.convt_pair([(x.detach(), wt, None)])
    a = torch.ones(1, 4, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        dc.convt_pair([(x.detach(), wt.detach(), None, (a, torch.zeros_like(a), "ReLU"))])
    with torch.no_grad():  # inference: the kernels run
        oh.output_head(h, s, w, b, "LeakyReLU", 2)
        dc.conv3x3_stats(x, wc, None)
        dc.convt_pair([(x, wt, None)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU", "none"])
@pytest.mark.parametrize("affine", [True, False])
def test_norm_act_kernel_matches_plain(cuda, dtype, act, affine):
    x = (torch.randn(3, 5, 37, 141, device="cuda", generator=cuda) * 2 + 1).to(dtype)
    w = torch.randn(5, device="cuda", generator=cuda) if affine else None
    b = torch.randn(5, device="cuda", generator=cuda) if affine else None
    before = na.instance_norm_act.launches
    y = na.instance_norm_act(x, w, b, act)
    torch.cuda.synchronize()
    assert na.instance_norm_act.launches == before + 1
    assert y.dtype == dtype
    _assert_close(y, na.instance_norm_act_plain(x, w, b, act), dtype)


def test_norm_act_kernel_rejects_non_contiguous(cuda):
    x = torch.randn(2, 4, 8, 8, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError):
        na.instance_norm_act(x, None, None)


def _head_inputs(gen, shape, co, dtype):
    n, c, _, _ = shape
    h = (torch.randn(shape, device="cuda", generator=gen) * 2).to(dtype)
    s = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    w = torch.randn(co, c, 3, 3, device="cuda", generator=gen) / (3 * c ** 0.5)
    b = torch.randn(co, device="cuda", generator=gen) * 0.1
    return h, s, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,co,pool,act", [
    ((2, 5, 36, 44), 3, 1, "LeakyReLU"), ((2, 5, 36, 44), 3, 2, "ReLU"),
    ((2, 5, 36, 44), 3, 4, "LeakyReLU"), ((1, 7, 30, 42), 2, 3, "LeakyReLU"),
    ((1, 3, 128, 192), 4, 64, "ReLU"),                  # f > 32: one cell per block
    ((16, 32, 1024, 1024), 3, 4, "LeakyReLU"),          # the flagship head
])
def test_output_head_kernel_matches_plain(cuda, dtype, shape, co, pool, act):
    h, s, w, b = _head_inputs(cuda, shape, co, dtype)
    before = oh.output_head.launches
    y = oh.output_head(h, s, w, b, act, pool)
    torch.cuda.synchronize()
    assert oh.output_head.launches == before + 1
    assert y.dtype == dtype and y.shape == (shape[0], co, shape[2] // pool, shape[3] // pool)
    _assert_close(y, oh.output_head_plain(h, s, w, b, act, pool), dtype)


def test_output_head_kernel_rejects_bad_input(cuda):
    h, s, w, b = _head_inputs(cuda, (1, 4, 16, 16), 3, torch.float32)
    with pytest.raises(ValueError):
        oh.output_head(h, s, w, b, "LeakyReLU", 3)               # 3 does not divide 16
    with pytest.raises(ValueError):
        oh.output_head(h, s.transpose(2, 3), w, b, "LeakyReLU", 2)
    with pytest.raises(TypeError):
        oh.output_head(h, s.to(torch.bfloat16), w, b, "LeakyReLU", 2)
    with pytest.raises(NotImplementedError):
        oh.output_head(h, s, w, b, "SELU", 2)
    with pytest.raises(ValueError):
        oh.output_head(h[:, :, :1], s[:, :, :1], w, b, "ReLU", 1)  # H < 2


def _assert_stats(got, want, dtype):
    rtol = STATS_RTOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * float(w.abs().max()))


def _prologue(gen, n, c, act):
    a = 0.5 + torch.rand(n, c, device="cuda", generator=gen)
    b = 0.3 * torch.randn(n, c, device="cuda", generator=gen)
    return (a, b, act)


def _map(gen, shape, dtype):
    return (torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.2).to(dtype)


# (N, C, H, W, Co, prologue act, output act): the flagship's decoder 3 and 4
# widths on smaller maps; odd sizes, C not a multiple of the staged chunk
# (8 on the CUDA cores, 16 on the tensor cores), Co of 3, 8, 32, 64 and 80
# (two channel blocks). bf16 with W % 8 == 0 takes the tensor cores, with H
# and W not multiples of its 64-column tile (4 or 8 rows) among them; W of
# 41, 70 and 33 the CUDA cores.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,co,pro,act", [
    (2, 128, 64, 64, 64, "LeakyReLU", None), (2, 64, 96, 80, 32, "LeakyReLU", None),
    (3, 13, 37, 41, 3, "ReLU", "LeakyReLU"), (1, 21, 17, 70, 64, None, "ReLU"),
    (2, 5, 9, 33, 80, "LeakyReLU", None),
    (3, 13, 37, 72, 3, "ReLU", "LeakyReLU"), (2, 21, 19, 136, 8, None, "ReLU"),
    (2, 40, 13, 24, 80, "LeakyReLU", None), (1, 70, 30, 200, 32, "ReLU", None),
    (2, 16, 5, 8, 64, "LeakyReLU", "ReLU"), (1, 33, 66, 64, 16, "none", None),
])
def test_conv3x3_stats_kernel_matches_plain(cuda, dtype, n, c, h, w, co, pro, act):
    x = _map(cuda, (n, c, h, w), dtype)
    wt = torch.randn(co, c, 3, 3, device="cuda", generator=cuda) / (3 * c ** 0.5)
    b = 0.5 * torch.randn(co, device="cuda", generator=cuda)
    prologue = _prologue(cuda, n, c, pro) if pro else None
    before = dc.conv3x3_stats.launches
    y, stats = dc.conv3x3_stats(x, wt, b, prologue, act, with_stats=True)
    torch.cuda.synchronize()
    assert dc.conv3x3_stats.launches == before + 1
    want, want_stats = dc.conv3x3_stats_plain(x, wt, b, prologue, act, with_stats=True)
    assert y.dtype == dtype and y.shape == (n, co, h, w)
    _assert_close(y, want, dtype)
    _assert_stats(stats, want_stats, dtype)
    _assert_close(dc.conv3x3_stats(x, wt, None, prologue, act),
                  dc.conv3x3_stats_plain(x, wt, None, prologue, act), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co", [(64, 32), (21, 80)])
def test_conv3x3_stats_takes_strided_weight_and_bias(cuda, dtype, c, co):
    """A weight and bias that are strided views (no padding needed at
    C = 64, Co = 32; padding at C = 21, Co = 80) give the plain version's
    output: the wrapper hands the kernels contiguous copies."""
    x = _map(cuda, (2, c, 16, 24), dtype)
    wt = (torch.randn(3, 3, c, co, device="cuda", generator=cuda) / (3 * c ** 0.5)
          ).permute(3, 2, 0, 1)
    b = torch.randn(2 * co, device="cuda", generator=cuda)[::2]
    prologue = _prologue(cuda, 2, c, "LeakyReLU")
    assert not wt.is_contiguous() and not b.is_contiguous()
    got = dc.conv3x3_stats(x, wt, b, prologue, "ReLU")
    torch.cuda.synchronize()
    _assert_close(got, dc.conv3x3_stats_plain(x, wt, b, prologue, "ReLU"), dtype)


def test_conv3x3_routes(cuda):
    """bf16 maps with W % 8 == 0 take the tensor cores, the flagship's
    decoders 3 and 4 among them; other widths, misaligned maps and float32
    the CUDA cores."""
    def route(c, h, w, dtype=torch.bfloat16, offset=0):
        flat = torch.zeros(c * h * w + offset, device="cuda", dtype=dtype)
        return dc.conv3x3_route(flat[offset:].view(1, c, h, w))
    assert route(128, 256, 256) == route(64, 512, 512) == "tensor_cores"  # decoders 3, 4
    assert route(5, 9, 72) == "tensor_cores"
    assert route(5, 9, 70) == route(5, 9, 33) == "cuda_cores"
    assert route(5, 9, 72, offset=1) == "cuda_cores"
    assert route(5, 9, 72, torch.float32) == "cuda_cores"


def test_decoder_conv_pads(cuda):
    """The pads the wrapper sizes K4b's operands with come from the C side:
    Co rounded up to its channel block (8, 16, 32 or 64), C up to the
    tensor-core kernel's 16-channel chunk (the values the CPU packing test
    takes)."""
    co_pad = dc._function("fmi_decoder_conv_co_pad")
    c_pad = dc._function("fmi_decoder_conv_c_pad")
    assert [co_pad(co) for co in (3, 8, 32, 64, 80)] == [8, 8, 32, 64, 128]
    assert [c_pad(c) for c in (13, 16, 21, 64, 128)] == [16, 16, 32, 64, 128]


# (N, C_h, C_x, H, W, Co, act, with_stats): two streams with the prologue on
# the first, as the decoder runs them, and one stream without
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,ch,cx,h,w,co,act,with_stats", [
    (2, 64, 128, 64, 64, 64, None, True), (2, 32, 64, 80, 96, 32, "LeakyReLU", False),
    (3, 5, 13, 37, 41, 3, "ReLU", True), (1, 0, 21, 17, 70, 64, None, True),
    (2, 9, 5, 9, 33, 80, "LeakyReLU", True),
])
def test_convt_pair_kernel_matches_plain(cuda, dtype, n, ch, cx, h, w, co, act, with_stats):
    streams = []
    if ch:
        streams.append((_map(cuda, (n, ch, h, w), dtype),
                        torch.randn(ch, co, 3, 3, device="cuda", generator=cuda) / (3 * ch ** 0.5),
                        0.5 * torch.randn(co, device="cuda", generator=cuda),
                        _prologue(cuda, n, ch, "LeakyReLU")))
    streams.append((_map(cuda, (n, cx, h, w), dtype),
                    torch.randn(cx, co, 3, 3, device="cuda", generator=cuda) / (3 * cx ** 0.5),
                    0.5 * torch.randn(co, device="cuda", generator=cuda)))
    before = dc.convt_pair.launches
    got = dc.convt_pair(streams, act, with_stats)
    torch.cuda.synchronize()
    assert dc.convt_pair.launches == before + 1
    want = dc.convt_pair_plain(streams, act, with_stats)
    if with_stats:
        (got, stats), (want, want_stats) = got, want
        _assert_stats(stats, want_stats, dtype)
    assert got.dtype == dtype and got.shape == (n, co, 2 * h, 2 * w)
    _assert_close(got, want, dtype)


# (N, (C_s), (prologue act_s), H, W, Co, act, with_stats) on the tensor
# cores (bf16, W % 8 == 0): one or two streams, each prologue activation and
# none, with and without stats, odd H, Co of 3, 8, 16, 32, 64 and 80 (two
# channel blocks), H and W off the 64-column tile
@pytest.mark.parametrize("n,cs,pros,h,w,co,act,with_stats", [
    (2, (64, 128), ("LeakyReLU", None), 20, 64, 64, None, True),
    (2, (32, 64), ("LeakyReLU", None), 24, 72, 32, "LeakyReLU", False),
    (3, (5, 13), ("ReLU", "none"), 37, 48, 3, "ReLU", True),
    (1, (21,), (None,), 17, 80, 64, None, True),
    (2, (40,), ("LeakyReLU",), 9, 16, 80, "LeakyReLU", True),
    (2, (16, 8), ("none", "ReLU"), 11, 136, 8, None, False),
    (1, (33,), ("ReLU",), 7, 8, 16, "ReLU", True),
])
def test_convt_pair_tensor_cores_match_plain(cuda, n, cs, pros, h, w, co, act, with_stats):
    dtype = torch.bfloat16
    streams = [(_map(cuda, (n, c, h, w), dtype),
                torch.randn(c, co, 3, 3, device="cuda", generator=cuda) / (3 * c ** 0.5),
                0.5 * torch.randn(co, device="cuda", generator=cuda),
                _prologue(cuda, n, c, pro) if pro else None) for c, pro in zip(cs, pros)]
    assert dc.convt_pair_route(streams[0][0]) == "tensor_cores"
    before = dc.convt_pair.launches
    got = dc.convt_pair(streams, act, with_stats)
    torch.cuda.synchronize()
    assert dc.convt_pair.launches == before + 1
    want = dc.convt_pair_plain(streams, act, with_stats)
    if with_stats:
        (got, stats), (want, want_stats) = got, want
        _assert_stats(stats, want_stats, dtype)
    assert got.dtype == dtype and got.shape == (n, co, 2 * h, 2 * w)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co", [(64, 32), (21, 80)])
def test_convt_pair_takes_strided_weight_and_bias(cuda, dtype, c, co):
    """A weight and bias that are strided views give the plain version's
    output on both routes (bf16 at W = 24 takes the tensor cores): the
    wrapper hands the kernels contiguous copies."""
    x = _map(cuda, (2, c, 16, 24), dtype)
    wt = (torch.randn(3, 3, c, co, device="cuda", generator=cuda) / (3 * c ** 0.5)
          ).permute(2, 3, 0, 1)
    b = torch.randn(2 * co, device="cuda", generator=cuda)[::2]
    streams = [(x, wt, b, _prologue(cuda, 2, c, "LeakyReLU"))]
    assert not wt.is_contiguous() and not b.is_contiguous()
    got = dc.convt_pair(streams, "ReLU")
    torch.cuda.synchronize()
    _assert_close(got, dc.convt_pair_plain(streams, "ReLU"), dtype)


def test_convt_pair_routes(cuda):
    """bf16 maps with W % 8 == 0 take the tensor cores, the flagship's
    decoders 3 and 4 among them; other widths, misaligned maps and float32
    the CUDA cores."""
    def route(c, h, w, dtype=torch.bfloat16, offset=0):
        flat = torch.zeros(c * h * w + offset, device="cuda", dtype=dtype)
        return dc.convt_pair_route(flat[offset:].view(1, c, h, w))
    assert route(128, 256, 256) == route(64, 512, 512) == "tensor_cores"  # decoders 3, 4
    assert route(5, 9, 72) == route(5, 9, 8) == "tensor_cores"
    assert route(5, 9, 70) == route(5, 9, 41) == "cuda_cores"
    assert route(5, 9, 72, offset=1) == "cuda_cores"
    assert route(5, 9, 72, torch.float32) == "cuda_cores"


def test_decoder_conv_kernels_reject_bad_input(cuda):
    x = torch.randn(1, 4, 8, 8, device="cuda")
    w = torch.randn(5, 4, 3, 3, device="cuda")
    with pytest.raises(ValueError):
        dc.conv3x3_stats(x.transpose(2, 3), w, None)
    with pytest.raises(ValueError):
        dc.conv3x3_stats(x, w.cpu(), None)
    with pytest.raises(TypeError):
        dc.conv3x3_stats(x.half(), w, None)
    wt = torch.randn(4, 5, 3, 3, device="cuda")
    with pytest.raises(ValueError):
        dc.convt_pair([(x, wt, None), (x.transpose(2, 3), wt, None)])
    with pytest.raises(ValueError):
        dc.convt_pair([(x, wt, None, (torch.ones(1, 4), torch.zeros(1, 4, device="cuda"),
                                      "ReLU"))])


# K6 cases (shape, up, down, pad, taps, gain): the StyleGAN2 blur, skip
# upsample and downsample on ragged shapes, and an asymmetric filter that a
# missing flip gets wrong
K6_CASES = [((2, 3, 37, 41), 1, 1, (1, 1), [1, 3, 3, 1], 4.0),
            ((3, 1, 19, 27), 2, 1, (2, 1), [1, 3, 3, 1], 4.0),
            ((2, 5, 33, 21), 1, 2, (1, 1), [1, 3, 3, 1], 1.0),
            ((2, 3, 23, 17), 1, 1, (2, 1), [1, 2, 3, 4], 1.0),
            ((2, 3, 23, 17), 2, 1, (1, 2), [1, 2, 3, 4], 4.0),
            ((2, 3, 23, 17), 1, 2, (2, 2), [1, 2, 3, 4], 1.0),
            ((1, 2, 20, 30), 1, 1, (-1, 2), [1, 2, 3, 4], 1.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,up,down,pad,taps,gain", K6_CASES)
def test_upfirdn2d_kernel_matches_plain(cuda, dtype, shape, up, down, pad, taps, gain):
    """|kernel - plain| <= atol + rtol (|plain| + upfirdn2d(|x|, |taps|)):
    each side rounds the H pass once, so where their f32 sums straddle a
    rounding boundary an intermediate moves by one ulp."""
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
    from face_mask_inpaint_tpu_torch.ops.upfirdn2d import make_taps

    k = [float(t) for t in make_taps(taps, gain)]
    x = torch.randn(shape, device="cuda", generator=cuda).to(dtype)
    before = fir.upfirdn2d.launches
    got = fir.upfirdn2d(x, k, up, down, pad)
    torch.cuda.synchronize()
    assert fir.upfirdn2d.launches == before + 1
    want = fir.upfirdn2d_plain(x, k, up, down, pad)
    assert got.dtype == dtype and got.shape == want.shape
    atol, rtol = TOL[dtype]
    m = fir.upfirdn2d_plain(x.float().abs(), [abs(t) for t in k], up, down, pad)
    assert bool(((got.float() - want.float()).abs() <= atol + rtol * (want.float().abs() + m))
                .all())


def test_upfirdn2d_kernel_rejects_bad_input(cuda):
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir

    x = torch.randn(1, 2, 8, 8, device="cuda")
    with pytest.raises(NotImplementedError, match=r"up=2, down=2"):
        fir.upfirdn2d(x, [0.5, 0.5], 2, 2, (0, 0))
    with pytest.raises(ValueError):
        fir.upfirdn2d(x.transpose(2, 3), [0.5, 0.5])
    with pytest.raises(TypeError):
        fir.upfirdn2d(x.half(), [0.5, 0.5])
    with pytest.raises(ValueError):
        fir.upfirdn2d(x, [0.1] * 17)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,with_bias", [((3, 5, 37, 41), True), ((2, 32, 64, 64), True),
                                             ((7, 13), True), ((2, 3, 9, 11), False)])
def test_fused_leaky_relu_kernel_matches_plain(cuda, dtype, shape, with_bias):
    from face_mask_inpaint_tpu_torch.kernels import fused_act as act

    x = (torch.randn(shape, device="cuda", generator=cuda) * 2).to(dtype)
    b = torch.randn(shape[1], device="cuda", generator=cuda) if with_bias else None
    before = act.fused_leaky_relu.launches
    got = act.fused_leaky_relu(x, b)
    torch.cuda.synchronize()
    assert act.fused_leaky_relu.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_close(got, act.fused_leaky_relu_plain(x, b), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 512, 4, 4), (2, 32, 64, 64), (2, 1, 37, 41),
                                   (3, 3, 19, 27), (2, 5, 33, 21), (7, 13)])
def test_fused_leaky_relu_bwd_kernel_matches_plain(cuda, dtype, shape):
    """K7b against its plain version, at a StyleGAN2 shape and ragged ones."""
    from face_mask_inpaint_tpu_torch.kernels import fused_act as act

    y = (torch.randn(shape, device="cuda", generator=cuda) * 2).to(dtype)
    g = torch.randn(shape, device="cuda", generator=cuda).to(dtype)
    before = act.fused_leaky_relu_bwd.launches
    got = act.fused_leaky_relu_bwd(y, g)
    torch.cuda.synchronize()
    assert act.fused_leaky_relu_bwd.launches == before + 1
    assert got.dtype == dtype and got.shape == g.shape
    _assert_close(got, act.fused_leaky_relu_bwd_plain(y, g), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_leaky_relu_function_grads_launch_k7a_and_k7b(cuda, dtype):
    """dx through K7b and dbias, the f32 channel sum of dx in g's dtype,
    against the plain versions; one K7a and one K7b launch."""
    from face_mask_inpaint_tpu_torch.kernels import fused_act as act

    x = torch.randn(4, 6, 17, 19, device="cuda", generator=cuda).to(dtype).requires_grad_()
    b = torch.randn(6, device="cuda", generator=cuda).to(dtype).requires_grad_()
    g = torch.randn(4, 6, 17, 19, device="cuda", generator=cuda).to(dtype)
    before = act.fused_leaky_relu.launches, act.fused_leaky_relu_bwd.launches
    y = act.fused_leaky_relu(x, b)
    dx, db = torch.autograd.grad(y, (x, b), g)
    torch.cuda.synchronize()
    assert (act.fused_leaky_relu.launches - before[0],
            act.fused_leaky_relu_bwd.launches - before[1]) == (1, 1)
    want = act.fused_leaky_relu_bwd_plain(y.detach(), g)
    _assert_close(dx, want, dtype)
    _assert_close(db, want.float().sum(dim=(0, 2, 3)).to(dtype), dtype)


def test_fused_leaky_relu_grad_of_grad_matches_plain(cuda):
    """grad-of-grad through the Function against autograd of the plain
    version (f32): d/dg applies the mask again, d/dy is zero."""
    from face_mask_inpaint_tpu_torch.kernels import fused_act as act

    x = torch.randn(2, 5, 9, 11, device="cuda", generator=cuda, requires_grad=True)
    b = torch.randn(5, device="cuda", generator=cuda, requires_grad=True)
    outs = []
    for fn in (act.fused_leaky_relu, act.fused_leaky_relu_plain):
        y = fn(x, b)
        g = torch.linspace(-1, 1, y.numel(), device="cuda").view_as(y).requires_grad_()
        dx, db = torch.autograd.grad(y, (x, b), g, create_graph=True)
        (dg,) = torch.autograd.grad((dx * dx).sum() + db.sum(), g)
        outs.append((dx, db, dg))
    for got, want in zip(*outs):
        _assert_close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,up,down,pad", [((2, 32, 65, 65), 1, 1, (1, 1)),
                                               ((2, 3, 32, 32), 2, 1, (2, 1)),
                                               ((2, 5, 33, 21), 1, 2, (1, 1)),
                                               ((2, 1, 38, 42), 1, 1, (1, 1))])
def test_upfirdn2d_bwd_kernel_matches_autograd_of_plain(cuda, dtype, shape, up, down, pad):
    """K6's backward (mode (down, up), taps reversed, pads transposed)
    against the plain version of the same call; in f32 also against
    autograd of the plain forward. K6's tolerance (see
    test_upfirdn2d_kernel_matches_plain)."""
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
    from face_mask_inpaint_tpu_torch.ops.upfirdn2d import make_taps

    k = [float(t) for t in make_taps([1, 2, 3, 4], float(up * up))]
    h, w = shape[2:]
    ho, wo = (fir.out_len(n, up, down, *pad, len(k)) for n in (h, w))
    gpad = fir.transposed_pads(h, ho, len(k), up, down, pad[0])
    assert min(gpad) >= 0
    g = torch.randn(shape[0], shape[1], ho, wo, device="cuda", generator=cuda).to(dtype)
    before = fir.upfirdn2d_bwd.launches
    got = fir.upfirdn2d_bwd(g, k, up, down, pad, (h, w))
    torch.cuda.synchronize()
    assert fir.upfirdn2d_bwd.launches == before + 1 and tuple(got.shape) == shape
    want = fir.upfirdn2d_plain(g, k[::-1], down, up, gpad)
    atol, rtol = TOL[dtype]
    m = fir.upfirdn2d_plain(g.float().abs(), [abs(t) for t in k[::-1]], down, up, gpad)
    assert bool(((got.float() - want.float()).abs()
                 <= atol + rtol * (want.float().abs() + m)).all())
    if dtype == torch.float32:
        x = torch.zeros(shape, device="cuda", requires_grad=True)
        (auto,) = torch.autograd.grad(fir.upfirdn2d_plain(x, k, up, down, pad), x, g)
        _assert_close(got, auto, dtype)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1))])
def test_upfirdn2d_function_grad_and_grad_of_grad(cuda, up, down, pad):
    """The K6 Function's gradient and grad-of-grad against autograd of the
    plain version (f32); the forward and the backward each launch once."""
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
    from face_mask_inpaint_tpu_torch.ops.upfirdn2d import make_taps

    k = [float(t) for t in make_taps([1, 2, 3, 4], 4.0)]
    x = torch.randn(2, 3, 18, 18, device="cuda", generator=cuda, requires_grad=True)
    outs = []
    for fn in (fir.upfirdn2d, fir.upfirdn2d_plain):
        before = fir.upfirdn2d.launches, fir.upfirdn2d_bwd.launches
        y = fn(x, k, up, down, pad)
        g = torch.linspace(-1, 1, y.numel(), device="cuda").view_as(y).requires_grad_()
        (dx,) = torch.autograd.grad(y, x, g, create_graph=True)
        if fn is fir.upfirdn2d:
            assert (fir.upfirdn2d.launches - before[0],
                    fir.upfirdn2d_bwd.launches - before[1]) == (1, 1)
        (dg,) = torch.autograd.grad((dx * dx).sum(), g)
        outs.append((dx, dg))
    for got, want in zip(*outs):
        _assert_close(got, want, torch.float32)


def test_small_psp_train_step_launches_stackb_kernels(cuda):
    """One pSp training step (output_size 64: 4 upsampling stages, so 8 K6
    calls and 9 K7a calls a forward) launches each kernel once forward and
    once backward, with finite losses."""
    from face_mask_inpaint_tpu_torch.kernels import WRAPPERS, reset_launch_counts
    from face_mask_inpaint_tpu_torch.losses.psp_loss import PSPLossConfig
    from face_mask_inpaint_tpu_torch.models.psp import PSP
    from face_mask_inpaint_tpu_torch.train.optim import adam
    from face_mask_inpaint_tpu_torch.train.psp import make_psp_train_step, partition_params

    with torch.device("cuda"):
        psp = PSP(output_size=64, num_layers=4, decoder_base_channels=32, use_attention=True,
                  generator=torch.Generator(device="cuda").manual_seed(0))
    opt = adam([p for _, p in partition_params(psp, True)], 1e-4)
    cfg = PSPLossConfig(l2_lambda=1.0, lpips_lambda=0.0, style_lambda=0.0, cx_lambda=0.0)
    step = make_psp_train_step(psp, opt, cfg, {}, use_ref=True, resize=False)
    img = lambda: torch.rand(2, 64, 64, 3, device="cuda", generator=cuda) * 2 - 1
    batch = {"src_img": img(), "gt_img": img(), "ref_img": img(),
             "mask": (torch.rand(2, 64, 64, device="cuda", generator=cuda) > 0.5).float()}
    reset_launch_counts()
    out = step(batch, noise=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in WRAPPERS}
    assert counts == dict({k: 0 for k in counts}, upfirdn2d=8, upfirdn2d_bwd=8,
                          fused_leaky_relu=9, fused_leaky_relu_bwd=9)
    assert float(out["skipped_nonfinite"]) == 0.0 and bool(torch.isfinite(out["loss"]))


def test_small_psp_launches_k6_and_k7a_and_matches_plain(cuda):
    """PSP(output_size=32, num_layers=4, decoder_base_channels=32) on the
    card: 3 upsampling stages make 6 K6 calls, conv1 and 6 StyledConvs 7 K7a
    calls, and the output matches the plain versions' (float32)."""
    from face_mask_inpaint_tpu_torch.kernels import fused_act as act
    from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
    from face_mask_inpaint_tpu_torch.models.psp import PSP

    with torch.device("cuda"):
        psp = PSP(output_size=32, num_layers=4, decoder_base_channels=32, use_attention=True,
                  generator=torch.Generator(device="cuda").manual_seed(0)).eval()
    x = torch.rand(2, 64, 64, 3, device="cuda", generator=cuda) * 2 - 1
    mask = (torch.rand(2, 64, 64, device="cuda", generator=cuda) > 0.5).float()
    before = (fir.upfirdn2d.launches, act.fused_leaky_relu.launches)
    with torch.inference_mode():
        got = psp(x, x.flip(0), mask, randomize_noise=False)
    assert (fir.upfirdn2d.launches - before[0], act.fused_leaky_relu.launches - before[1]) == (6, 7)
    saved = fir.upfirdn2d, act.fused_leaky_relu
    fir.upfirdn2d, act.fused_leaky_relu = fir.upfirdn2d_plain, act.fused_leaky_relu_plain
    try:
        with torch.inference_mode():
            want = psp(x, x.flip(0), mask, randomize_noise=False)
    finally:
        fir.upfirdn2d, act.fused_leaky_relu = saved
    assert got.shape == (2, 256, 256, 3) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
