"""The decoder's conv biases, each handed to the kernel that next reads the
conv's output, against the dense math that added them in passes of their own.

In eval mode ``ResBlockDecoder`` runs its convs without their biases: conv1's
goes to norm2's kernel K2 (``in_bias``) where norm2 runs as K2, conv2's and
the bypass's to the residual sum's kernel (``residual_bias_add``) or, on the
last block's pair, to K3 (``pair_bias``). These CPU tests run the kernels'
plain versions and hold the new path against the old one: biased convs,
``h + s``, and K3's plain pair head. The two round at other places in
bfloat16 (a conv's output before its bias is added, not after; h + s + b
once, not h + b, s + b and their sum each), so results differ by about one
rounding of the largest value: bfloat16 is held to atol 2^-7 max |old| and
rtol 2^-7, float32 to 1e-5 of each. Training mode keeps the biased,
differentiable path.
"""

import pytest
import torch

from face_mask_inpaint_tpu_torch.kernels import norm_act as na
from face_mask_inpaint_tpu_torch.kernels import output_head as oh
from face_mask_inpaint_tpu_torch.kernels import residual_add as ra
from face_mask_inpaint_tpu_torch.models.picnet import ResGenerator
from face_mask_inpaint_tpu_torch.nn.blocks import Output, ResBlockDecoder, _norm_act
from face_mask_inpaint_tpu_torch.nn.layers import init_weights

DTYPES = [torch.float32, torch.bfloat16]
REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread a pytest worker, as the other model tests keep."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_near(got, want, dtype):
    rel = REL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                               atol=rel * float(want.float().abs().max()))


def _random_biases(module, gen, std=0.5):
    """Nonzero biases on every conv (init_weights zeroes them)."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "effective_weight") and m.bias is not None:
                m.bias.normal_(0.0, std, generator=gen)


def _block(norm, act, seed=0, use_spect=True):
    gen = torch.Generator().manual_seed(seed)
    blk = init_weights(ResBlockDecoder(12, 8, 10, norm=norm, activation=act,
                                       use_spect=use_spect), gen)
    _random_biases(blk, gen)
    return blk.eval(), gen


def _dense(blk, x, pair=False):
    """The block's dense math before the change: biased convs, then h + s."""
    h = blk.conv1(_norm_act(x, blk.norm1, blk.act))
    h = blk.conv2(_norm_act(h, blk.norm2, blk.act))
    s = blk.bypass(x)
    return (h, s) if pair else h + s


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU"])
@pytest.mark.parametrize("norm", ["instance", "none"])
def test_eval_block_equals_dense_block(norm, act, dtype, monkeypatch):
    """The eval block on the new path equals today's dense block, and runs
    each conv without its bias: conv1's goes to K2 under instance norm."""
    blk, gen = _block(norm, act)
    x = torch.randn(2, 12, 9, 7, generator=gen).to(dtype)
    calls = {"in_bias": [], "res": 0}
    k2, res = na.instance_norm_act, ra.residual_bias_add

    def k2_spy(*a, in_bias=None, **k):
        calls["in_bias"].append(in_bias)
        return k2(*a, in_bias=in_bias, **k)

    def res_spy(*a, **k):
        calls["res"] += 1
        return res(*a, **k)

    monkeypatch.setattr(na, "instance_norm_act", k2_spy)
    monkeypatch.setattr(ra, "residual_bias_add", res_spy)
    with torch.no_grad():
        got = blk(x)
    monkeypatch.undo()
    with torch.no_grad():
        want = _dense(blk, x)
    assert got.dtype == dtype and got.shape == (2, 8, 18, 14)
    _assert_near(got, want, dtype)
    assert calls["res"] == 1
    if norm == "instance":  # norm1 takes no bias, norm2 conv1's
        assert calls["in_bias"][0] is None and calls["in_bias"][1] is blk.conv1.bias
    else:
        assert calls["in_bias"] == []


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU"])
def test_last_block_triple_through_output_equals_old_pair(act, dtype):
    """(h, s, b2 + b3) from the eval block through Output equals the old
    biased pair through K3's plain version."""
    blk, gen = _block("instance", act, seed=1)
    head = init_weights(Output(8, 3, 3, norm="none", activation=act), gen)
    _random_biases(head, gen, 0.1)
    x = torch.randn(2, 12, 8, 8, generator=gen).to(dtype)
    with torch.no_grad():
        triple = blk(x, return_pair=True)
        h_old, s_old = _dense(blk, x, pair=True)
        got = head(triple, pool=4)
        conv = head.conv1.conv
        want = oh.output_head_plain(h_old, s_old, conv.effective_weight(), conv.bias, act, 4)
    h, s, pair_bias = triple
    torch.testing.assert_close(pair_bias, blk.conv2.bias + blk.bypass.bias)
    _assert_near(h + s + pair_bias.to(dtype)[:, None, None], h_old + s_old, dtype)
    assert got.shape == (2, 3, 4, 4)
    _assert_near(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU", "none"])
def test_plain_norm_act_in_bias_equals_norm_of_sum(act, dtype):
    """instance_norm_act_plain(x, in_bias=b) == instance_norm_act_plain(x + b):
    in f32 bit for bit; in bf16 x + b is rounded on the right side only."""
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(2, 6, 5, 7, generator=gen) * 2 + 1).to(dtype)
    w, b = 1 + 0.1 * torch.randn(6, generator=gen), 0.1 * torch.randn(6, generator=gen)
    ib = torch.randn(6, generator=gen)
    got = na.instance_norm_act_plain(x, w, b, act, 0.1, 1e-5, in_bias=ib)
    want = na.instance_norm_act_plain((x.float() + ib[:, None, None]).to(dtype), w, b, act,
                                      0.1, 1e-5)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        _assert_near(got, want, dtype)
    assert torch.equal(na.instance_norm_act(x, w, b, act, 0.1, 1e-5, in_bias=ib), got)


def test_norm_act_function_differentiates_in_bias():
    """K2's autograd Function gives in_bias the gradient of x + in_bias."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 5, 7, generator=gen, dtype=torch.float64)
    w, b = 1 + 0.1 * torch.randn(6, generator=gen), 0.1 * torch.randn(6, generator=gen)
    ib = torch.randn(6, generator=gen)
    dy = torch.randn(2, 6, 5, 7, generator=gen, dtype=torch.float64)
    leaves = [t.double().requires_grad_() for t in (x, w, b, ib)]
    got = torch.autograd.grad(na.instance_norm_act(*leaves[:3], "LeakyReLU",
                                                   in_bias=leaves[3]), leaves, dy)
    ref = [t.double().requires_grad_() for t in (x, w, b, ib)]
    want = torch.autograd.grad(na.instance_norm_act_plain(ref[0] + ref[3][:, None, None],
                                                          ref[1], ref[2]), ref, dy)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layouts", [("nchw", "nchw"), ("nchw", "cl"), ("cl", "cl")])
def test_residual_bias_add_plain_equals_sum(layouts, dtype):
    """The residual sum's plain version (and its wrapper on CPU tensors)
    equals h + s + b in f32, rounded once, for NCHW and channels-last maps."""
    gen = torch.Generator().manual_seed(4)
    h, s = ((torch.randn(2, 12, 6, 5, generator=gen) * 3).to(dtype) for _ in range(2))
    bias = torch.randn(12, generator=gen)
    want = (h.float() + s.float() + bias[:, None, None]).to(dtype)
    cl = torch.channels_last
    h, s = (t.contiguous(memory_format=cl) if lay == "cl" else t for t, lay in zip((h, s), layouts))
    assert ra.residual_bias_add_route(h, s) == ("transpose" if layouts == ("nchw", "cl")
                                                else "flat")
    got = ra.residual_bias_add_plain(h, s, bias)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(ra.residual_bias_add(h, s, bias), want)


def test_residual_bias_add_routes_and_checks():
    """Planes of 256 elements or more take the plane route; a map neither
    NCHW nor channels-last, a channels-last h beside an NCHW s, a wrong bias
    or dtype is refused."""
    x = torch.zeros(1, 2, 16, 16)
    assert ra.residual_bias_add_route(x, x) == "plane"
    y = torch.zeros(1, 2, 15, 16)
    assert ra.residual_bias_add_route(y, y) == "flat"
    with pytest.raises(ValueError, match="NCHW or channels-last"):
        ra.residual_bias_add_route(x.transpose(2, 3), x)
    with pytest.raises(ValueError, match="channels-last h only"):
        ra.residual_bias_add_route(x.contiguous(memory_format=torch.channels_last), x)
    with pytest.raises(TypeError):
        ra.residual_bias_add_route(x.half(), x.half())
    with pytest.raises(ValueError, match="the bias must be"):
        ra._check(x, x, torch.zeros(3))
    with pytest.raises(ValueError, match="one shape"):
        ra._check(x, x[:, :1], torch.zeros(2))


def test_residual_bias_add_function_grads():
    """On CPU tensors the residual sum differentiates as h + s + bias: g to
    h and s, g summed per channel to the bias. (On CUDA tensors the kernel
    has no backward and refuses a gradient, as K3 does.)"""
    gen = torch.Generator().manual_seed(5)
    leaves = [torch.randn(2, 4, 3, 5, generator=gen, requires_grad=True) for _ in range(2)]
    leaves.append(torch.randn(4, generator=gen, requires_grad=True))
    g = torch.randn(2, 4, 3, 5, generator=gen)
    got = torch.autograd.grad(ra.residual_bias_add(*leaves), leaves, g)
    want = torch.autograd.grad(leaves[0] + leaves[1] + leaves[2][:, None, None], leaves, g)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_)


def test_train_mode_block_keeps_biases_and_is_differentiable(monkeypatch):
    """A training-mode block runs each conv with its bias and h + s, takes
    neither kernel's bias input, and its gradient reaches every bias."""
    blk, gen = _block("instance", "LeakyReLU", seed=6, use_spect=False)
    blk.train()
    x = torch.randn(2, 12, 6, 6, generator=gen, requires_grad=True)
    seen = []
    for name in ("conv1", "conv2", "bypass"):
        conv = getattr(blk, name)
        fwd = conv.forward
        monkeypatch.setattr(conv, "forward",
                            lambda x, with_bias=True, fwd=fwd: seen.append(with_bias) or fwd(x, with_bias))
    monkeypatch.setattr(ra, "residual_bias_add",
                        lambda *a, **k: pytest.fail("training took the eval path"))
    y = blk(x)
    assert seen == [True, True, True]
    with torch.no_grad():
        torch.testing.assert_close(y, _dense(blk, x))
    grads = torch.autograd.grad(y.square().sum(), [x, blk.conv1.bias, blk.conv2.bias,
                                                   blk.bypass.bias])
    assert all(bool(g.abs().sum() > 0) for g in grads[2:])
    assert grads[1] is not None and torch.isfinite(grads[1]).all()


def _old_block_path(self, x, return_pair):
    """ResBlockDecoder's eval forward before the change; its pair goes to K3
    without a pair bias, as the old head took it."""
    return (*_dense(self, x, pair=True), None) if return_pair else _dense(self, x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_small_flagship_generator_eval_matches_dense_math(dtype, monkeypatch):
    """A small ResGenerator shaped like the flagship's (instance norm,
    LeakyReLU, spectral norm, the attention after decoder 1, K3's pair head
    with a pool) in eval mode matches the same weights through the old dense
    math: biased convs, separate adds, K3's old plain pair. Decoder blocks 0
    and 2 take channels-last inputs, as in the flagship, so their bypass
    writes channels-last. In float32 the two agree to 1e-5; in bfloat16,
    after five blocks and the attention, they differ by as much as the old
    path differs from float32, so the new path is held to the old one's
    distance from the float32 result: no more than 1.1 times it in norm and
    1.5 times it at the worst element (0.87-0.99 and 0.82-1.13 over six
    seeds)."""
    gen = torch.Generator().manual_seed(7)
    g = init_weights(ResGenerator(32, 16, ngf=4, img_f=32, L=0, layers=5, norm="instance",
                                  activation="LeakyReLU", use_attn=True), gen)
    _random_biases(g, gen, 0.2)
    with torch.no_grad():
        g.attn1.gamma.fill_(0.5)
    g.eval()
    enc, z = (torch.randn(2, c, 4, 4, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last) for c in (32, 16))
    counts = {"res": 0}
    res = ra.residual_bias_add

    def res_spy(h, s, *a, **k):
        counts["res"] += 1
        counts.setdefault("routes", []).append(ra.residual_bias_add_route(h, s))
        return res(h, s, *a, **k)

    monkeypatch.setattr(ra, "residual_bias_add", res_spy)
    with torch.no_grad():
        got = g(enc, z=z, fuse_pool=4)
    assert counts["res"] == 4 and "transpose" in counts["routes"]
    monkeypatch.setattr(ResBlockDecoder, "_biases_to_kernels", _old_block_path)
    with torch.no_grad():
        want = g(enc, z=z, fuse_pool=4)
        ref = g(enc.float(), z=z.float(), fuse_pool=4)
    assert got.shape == want.shape == (2, 3, 32, 32)
    if dtype == torch.float32:
        _assert_near(got, want, dtype)
    else:
        new_err, old_err = got.float() - ref, want.float() - ref
        assert float(new_err.norm()) <= 1.1 * float(old_err.norm())
        assert float(new_err.abs().max()) <= 1.5 * float(old_err.abs().max())
