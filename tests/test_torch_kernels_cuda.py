"""K1, K5, K2, K3, K4a, K4b, K6 (forward and backward), K7a and K7b against
their plain versions on an NVIDIA GPU.
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
float32 (TF32 off; only the order of f32 sums differs) and (1e-3, 2^-7) in
bfloat16 (each side rounds an f32 result once: one bf16 ulp apart at most).
K5's dq and dv are held to max |kernel - plain| <= tol * max |plain| with tol
1e-4 in float32 and 1e-2 in bfloat16: in bfloat16 both sides round P and the
summed dS once before their products, from f32 values summed in another
order, so single rounded terms may differ by one bf16 ulp (2^-8 relative)
inside sums of thousands.
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
    (1, 4100, 64, [256]), (2, 300, 128, [264]), (2, 257, 32, [128, 8]),  # bf16: tensor cores
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
    (2, 320, 8, [24, 16]), (2, 257, 128, [130]), (1, 300, 48, [64]),   # CUDA-core path
    (1, 4100, 64, [256]), (2, 300, 128, [264]), (2, 257, 32, [128, 8]),  # bf16: tensor cores
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
# (8), Co of 3, 32, 64 and 80 (two channel blocks)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,co,pro,act", [
    (2, 128, 64, 64, 64, "LeakyReLU", None), (2, 64, 96, 80, 32, "LeakyReLU", None),
    (3, 13, 37, 41, 3, "ReLU", "LeakyReLU"), (1, 21, 17, 70, 64, None, "ReLU"),
    (2, 5, 9, 33, 80, "LeakyReLU", None),
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
