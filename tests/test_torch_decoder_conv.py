"""K4b and K4a's plain versions, the fused decoder tail of ResBlockDecoder,
ResGenerator(packed_convt=True) and ReferenceFill against the JAX package's
fused tail.

The JAX side runs its Pallas kernels ``packed_conv3x3_stats`` and
``packed_convt_pair`` in interpret mode on the CPU, with
``FMI_PACKED_CONVT=1`` set by monkeypatch where a model decides the path.
Packed JAX operands are made and undone with JAX's ``space_to_depth`` /
``depth_to_space``. Inputs come from seeded numpy RandomStates; weights cross
to the port through convert.py. float32; tolerances per test.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import picnet as jp
from face_mask_inpaint_tpu.models.reference_fill import ReferenceFill as JReferenceFill
from face_mask_inpaint_tpu.nn.blocks import ResBlockDecoder as JResBlockDecoder
from face_mask_inpaint_tpu.ops import packed as jpacked
from face_mask_inpaint_tpu.ops.pallas import norm_act as jna
from face_mask_inpaint_tpu.ops.pallas import packed_convt as jpc
from face_mask_inpaint_tpu_torch.convert import convert_reference_fill, state_dict_from_jax
from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
from face_mask_inpaint_tpu_torch.models import picnet as tp
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.nn.blocks import ResBlockDecoder
from face_mask_inpaint_tpu_torch.nn.layers import Conv2d, ConvTranspose2d

KEY = jax.random.PRNGKey(0)
OUT_ATOL = 1e-4    # f32 outputs: the same products summed in another order
STATS_RTOL = 1e-5  # f32 sums of y and y^2 over at most 32^2 values


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tail_calls(monkeypatch):
    """Counts the JAX packed_conv3x3_stats / packed_convt_pair calls and the
    port's conv3x3_stats / convt_pair calls, so that each test shows that
    both sides took the fused tail. Sets FMI_PACKED_CONVT=1."""
    calls = {"jax_conv": 0, "jax_convt": 0, "port_conv": 0, "port_convt": 0}

    def counted(fn, key):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(jpc, "packed_conv3x3_stats",
                        counted(jpc.packed_conv3x3_stats, "jax_conv"))
    monkeypatch.setattr(jpc, "packed_convt_pair", counted(jpc.packed_convt_pair, "jax_convt"))
    monkeypatch.setattr(dc, "conv3x3_stats", counted(dc.conv3x3_stats, "port_conv"))
    monkeypatch.setattr(dc, "convt_pair", counted(dc.convt_pair, "port_convt"))
    monkeypatch.setenv("FMI_PACKED_CONVT", "1")
    return calls


def _reset(calls):
    for k in calls:
        calls[k] = 0


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _pack(x, r):
    return jpacked.space_to_depth(jnp.asarray(x), r) if r > 1 else jnp.asarray(x)


def _unpack(y, r):
    return np.asarray(jpacked.depth_to_space(y, r) if r > 1 else y)


def jitted_apply(module, **kw):
    """``module.apply`` with the keywords kw, under ``jax.jit``: one XLA
    program for the whole module in place of one per operation (most of an
    eager apply's time on the CPU). Traced anew at each call of this helper,
    so the FMI_* settings in force are the ones the trace reads."""
    return jax.jit(functools.partial(module.apply, **kw))


def random_variables(init, seed):
    """Variables shaped by ``jax.eval_shape(init)`` from a seeded numpy
    RandomState: kernels ~ N(0, 1/fan_in), norm scales near 1, small random
    biases, AutoAttention's gamma random, unit spectral vectors."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rs.randn(*shape).astype(np.float32)
        if name == "kernel":
            x /= np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "bias":
            x *= 0.1
        elif name in ("u", "v"):
            x /= np.linalg.norm(x)
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


def _port_weight(module, w_hwio, b):
    """A JAX HWIO kernel and bias in the port's layout, through convert.py."""
    sd = state_dict_from_jax(module, {"params": {"kernel": w_hwio, "bias": b}})
    return sd["weight"], sd["bias"]


def _prologue(rs, n, c, act):
    a = (0.5 + rs.rand(n, c)).astype(np.float32)
    b = (0.3 * rs.randn(n, c)).astype(np.float32)
    return (a, b, act)


def _assert_stats(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=STATS_RTOL,
                                   atol=STATS_RTOL * float(np.abs(np.asarray(w)).max()))


# (r, prologue act or None for no prologue, output act)
@pytest.mark.parametrize("r,pro,act", [
    (1, None, None), (1, "LeakyReLU", None), (1, "ReLU", "LeakyReLU"),
    (2, None, "ReLU"), (2, "LeakyReLU", None), (2, "ReLU", None),
])
def test_conv3x3_plain_matches_jax_kernel(r, pro, act):
    """Outputs f32 max-abs 1e-4; stats rtol 1e-5 (atol 1e-5 of the largest)."""
    rs = np.random.RandomState(11 * r + len(pro or ""))
    n, h, w, c, co = 2, 12, 16, 6, 5
    x = (rs.randn(n, h, w, c) * 1.5 + 0.3).astype(np.float32)
    wk = (rs.randn(3, 3, c, co) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.5 * rs.randn(co)).astype(np.float32)
    prologue = _prologue(rs, n, c, pro) if pro else None
    jpro = (jnp.asarray(prologue[0]), jnp.asarray(prologue[1]), pro) if pro else None
    want, want_stats = jpc.packed_conv3x3_stats(
        _pack(x, r), jnp.asarray(wk), jnp.asarray(bias), r, prologue=jpro, act=act,
        with_stats=True)
    tw, tb = _port_weight(Conv2d(c, co, 3, padding=1), wk, bias)
    tpro = (torch.from_numpy(prologue[0]), torch.from_numpy(prologue[1]), pro) if pro else None
    got, stats = dc.conv3x3_stats(_nchw(x), tw, tb, prologue=tpro, act=act, with_stats=True)
    np.testing.assert_allclose(_nhwc(got), _unpack(want, r), rtol=0, atol=OUT_ATOL)
    _assert_stats(stats, want_stats)
    assert torch.equal(dc.conv3x3_stats(_nchw(x), tw, tb, prologue=tpro, act=act), got)


@pytest.mark.parametrize("r,act,with_stats", [
    (1, None, True), (1, "LeakyReLU", False), (2, "ReLU", True), (2, None, False),
])
def test_convt_pair_plain_matches_jax_kernel(r, act, with_stats):
    """Two streams, the prologue (LeakyReLU) on the first. Outputs f32
    max-abs 1e-4; stats rtol 1e-5."""
    rs = np.random.RandomState(7 * r + (act is None))
    n, h, w, ch, cx, co = 2, 8, 6, 4, 6, 5
    hx = (rs.randn(n, h, w, ch) + 0.2).astype(np.float32)
    xx = rs.randn(n, h, w, cx).astype(np.float32)
    wh = (rs.randn(3, 3, ch, co) / np.sqrt(9 * ch)).astype(np.float32)
    wx = (rs.randn(3, 3, cx, co) / np.sqrt(9 * cx)).astype(np.float32)
    bh = (0.5 * rs.randn(co)).astype(np.float32)
    bx = (0.5 * rs.randn(co)).astype(np.float32)
    pa, pb, _ = _prologue(rs, n, ch, "LeakyReLU")
    res = jpc.packed_convt_pair(
        [(_pack(hx, r), jnp.asarray(wh), jnp.asarray(bh),
          (jnp.asarray(pa), jnp.asarray(pb), "LeakyReLU")),
         (_pack(xx, r), jnp.asarray(wx), jnp.asarray(bx))],
        r, act=act, with_stats=with_stats)
    twh, tbh = _port_weight(ConvTranspose2d(ch, co), wh, bh)
    twx, tbx = _port_weight(ConvTranspose2d(cx, co), wx, bx)
    got = dc.convt_pair(
        [(_nchw(hx), twh, tbh, (torch.from_numpy(pa), torch.from_numpy(pb), "LeakyReLU")),
         (_nchw(xx), twx, tbx)], act=act, with_stats=with_stats)
    if with_stats:
        (want, want_stats), (got, stats) = res, got
        _assert_stats(stats, want_stats)
    else:
        want = res
    assert got.shape == (n, co, 2 * h, 2 * w)
    np.testing.assert_allclose(_nhwc(got), _unpack(want, 2 * r), rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("r,in_stats,want_stats,fuse_act", [
    (1, False, True, None), (1, True, False, "LeakyReLU"), (2, True, True, None),
    (2, False, False, "LeakyReLU"),
])
def test_res_block_decoder_fused_matches_jax(tail_calls, r, in_stats, want_stats, fuse_act):
    """The block's fused tail against JAX's with pack_output=True. Given
    in_stats are the input's sums scaled, so that they decide norm1. f32
    max-abs 1e-4 on the output; stats rtol 1e-5."""
    rs = np.random.RandomState(3 + 5 * r + 2 * in_stats)
    n, h, w, c, co = 2, 8, 8, 6, 4
    x = (rs.randn(n, h, w, c) * 1.3 + 0.4).astype(np.float32)
    stats = None
    if in_stats:
        stats = (x.sum(axis=(1, 2)) * 1.1, (x ** 2).sum(axis=(1, 2)) * 1.2)
    jblock = JResBlockDecoder(output_nc=co, hidden_nc=co, norm="instance",
                              activation="LeakyReLU", use_spect=True)
    kw = dict(train=False, pack_in=r, pack_output=True, fuse_act=fuse_act,
              in_stats=None if stats is None else tuple(map(jnp.asarray, stats)),
              want_stats=want_stats)
    xj = _pack(x, r)
    variables = random_variables(lambda: jblock.init(KEY, xj, **kw), 9)
    _reset(tail_calls)  # tracing init ran the kernels too
    res = jitted_apply(jblock, **kw)(variables, xj)
    want, want_out_stats = res if want_stats else (res, None)

    block = ResBlockDecoder(c, co, co, norm="instance", activation="LeakyReLU",
                            use_spect=True)
    block.load_state_dict(state_dict_from_jax(block, variables), strict=True)
    block.eval()
    with torch.no_grad():
        got = block(_nchw(x), fused=True,
                    in_stats=None if stats is None else tuple(map(torch.from_numpy, stats)),
                    want_stats=want_stats, fuse_act=fuse_act)
    if want_stats:
        got, got_stats = got
        _assert_stats(got_stats, want_out_stats)
    assert tail_calls == {"jax_conv": 1, "jax_convt": 1, "port_conv": 1, "port_convt": 1}
    np.testing.assert_allclose(_nhwc(got), _unpack(want, 2 * r), rtol=0, atol=OUT_ATOL)


GEN = dict(ngf=8, z_nc=8, img_f=32, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="normal")


# pack_threshold 8 at a 4^2 input: decoders 1 and 2 (outputs 16^2, 32^2)
# take the fused tail. With attention the stats chain breaks after decoder 1.
@pytest.mark.parametrize("use_attn", [False, True])
def test_res_generator_packed_convt_matches_jax(tail_calls, use_attn):
    """z injected; max-abs 1e-4 against JAX (three decoder stages of
    instance norms), 3e-5 against the port's own dense generator (the JAX
    package's tolerance for its fused tail, tests/test_packed_ops.py)."""
    rs = np.random.RandomState(5 + use_attn)
    x = rs.randn(2, 4, 4, 32).astype(np.float32)
    z = rs.randn(2, 4, 4, 16).astype(np.float32)
    jgen = jp.define_g(**GEN, use_attn=use_attn, pack_threshold=8)
    variables = random_variables(
        lambda: jgen.init(KEY, jnp.asarray(x), z=jnp.asarray(z), train=False), 8)
    _reset(tail_calls)  # tracing init ran the kernels too
    want = np.asarray(jitted_apply(jgen, train=False)(variables, jnp.asarray(x), z=jnp.asarray(z)))
    sd = None
    outs = {}
    for packed in (True, False):
        tgen = tp.define_g(**GEN, use_attn=use_attn, input_nc=32, z_channels=16,
                           pack_threshold=8, packed_convt=packed)
        sd = sd or state_dict_from_jax(tgen, variables)
        tgen.load_state_dict(sd, strict=True)
        tgen.eval()
        with torch.no_grad():
            outs[packed] = tgen(_nchw(x), z=_nchw(z))
    assert tail_calls == {"jax_conv": 2, "jax_convt": 2, "port_conv": 2, "port_convt": 2}
    assert outs[True].shape == (2, 3, 32, 32)
    np.testing.assert_allclose(_nhwc(outs[True]), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(_nhwc(outs[True]), _nhwc(outs[False]), rtol=0, atol=3e-5)


def test_reference_fill_packed_convt_matches_jax(tail_calls, monkeypatch):
    """The slice as a whole: the JAX decoder fuses the blocks above
    pack_threshold 16 at a 64^2 decode (decoders 1 and 2, the attention in
    between) and pools 2x in its head; the port's head runs at full size and
    its adaptive pool pools. norm_act on 'pallas', eps injected. Max-abs 1e-4."""
    monkeypatch.setattr(jna, "_IMPL", "pallas")
    enc = dict(type="pluralistic", ngf=8, z_nc=16, img_f=32, L=1, layers=3,
               norm="none", activation="LeakyReLU", init_type="orthogonal")
    dec = dict(ngf=16, z_nc=16, img_f=64, L=0, layers=3, norm="instance",
               activation="LeakyReLU", init_type="orthogonal", pack_threshold=16)
    rs = np.random.RandomState(3)
    src = rs.rand(2, 32, 32, 3).astype(np.float32)
    ref = rs.rand(2, 32, 32, 3).astype(np.float32)
    mask = np.zeros((2, 32, 32), np.float32)
    mask[:, 16:27, 8:24] = 1.0
    jmodel = JReferenceFill(encoder_params=enc, decoder_params=dec, use_att=True,
                            out_size=(32, 32))
    args = (jnp.asarray(src), jnp.asarray(ref), jnp.asarray(mask))
    variables = random_variables(
        lambda: jmodel.init({"params": KEY, "sample": KEY}, *args, train=False), 7)
    _reset(tail_calls)  # tracing init ran the kernels too
    rng = jax.random.PRNGKey(1)
    want = np.asarray(jitted_apply(jmodel, train=False)(variables, *args, rng=rng))
    rng_q, rng_p = jax.random.split(rng)
    eps_q = np.array(jax.random.normal(rng_q, (2, 8, 8, 16)))
    eps_p = np.array(jax.random.normal(rng_p, (2, 8, 8, 16)))

    model = ReferenceFill(enc, {**dec, "packed_convt": True}, use_att=True, out_size=(32, 32))
    model.load_state_dict(convert_reference_fill(model, variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(ref), torch.from_numpy(mask),
                    eps_q=torch.from_numpy(eps_q), eps_p=torch.from_numpy(eps_p))
    assert tail_calls == {"jax_conv": 2, "jax_convt": 2, "port_conv": 2, "port_convt": 2}
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def _conv3_args():
    x = torch.zeros(2, 4, 8, 8)
    return x, torch.zeros(5, 4, 3, 3), torch.zeros(5)


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "float32 or bfloat16"),
    ("weight", ValueError, "weight must be"),
    ("bias", ValueError, "bias must be"),
    ("act", NotImplementedError, "activation"),
    ("prologue act", NotImplementedError, "prologue activation"),
    ("prologue shape", ValueError, "prologue A, B"),
    ("rank", ValueError, r"\[N, C, H, W\]"),
    ("device", ValueError, "cpu or cuda"),
])
def test_conv3x3_stats_rejects_what_the_kernel_cannot_take(case, error, match):
    x, w, b = _conv3_args()
    kw = {}
    if case == "dtype":
        x = x.double()
    elif case == "weight":
        w = torch.zeros(5, 3, 3, 3)
    elif case == "bias":
        b = torch.zeros(4)
    elif case == "act":
        kw["act"] = "SELU"
    elif case == "prologue act":
        kw["prologue"] = (torch.ones(2, 4), torch.zeros(2, 4), "PReLU")
    elif case == "prologue shape":
        kw["prologue"] = (torch.ones(2, 3), torch.zeros(2, 3), "ReLU")
    elif case == "rank":
        x = x[0]
    elif case == "device":
        x = x.to("meta")
    with pytest.raises(error, match=match):
        dc.conv3x3_stats(x, w, b, **kw)


@pytest.mark.parametrize("case,error,match", [
    ("three streams", ValueError, "one or two streams"),
    ("grid", ValueError, "share N, H, W"),
    ("dtype mix", ValueError, "share N, H, W and dtype"),
    ("co", ValueError, "one Co"),
    ("act", NotImplementedError, "activation"),
])
def test_convt_pair_rejects_what_the_kernel_cannot_take(case, error, match):
    h, x = torch.zeros(2, 4, 8, 8), torch.zeros(2, 6, 8, 8)
    wh, wx = torch.zeros(4, 5, 3, 3), torch.zeros(6, 5, 3, 3)
    streams = [(h, wh, None), (x, wx, torch.zeros(5))]
    kw = {}
    if case == "three streams":
        streams = streams + [streams[0]]
    elif case == "grid":
        streams[1] = (torch.zeros(2, 6, 8, 9), wx, None)
    elif case == "dtype mix":
        streams[1] = (x.to(torch.bfloat16), wx, None)
    elif case == "co":
        streams[1] = (x, torch.zeros(6, 3, 3, 3), None)
    elif case == "act":
        kw["act"] = "tanh"
    with pytest.raises(error, match=match):
        dc.convt_pair(streams, **kw)


def test_instance_affine_from_stats_is_instance_norm():
    """x * A + B with A, B from the f32 sums equals InstanceNorm2d(affine),
    f32 max-abs 1e-5."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy((rs.randn(2, 3, 9, 7) * 2 + 1).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rs.randn(3)).astype(np.float32))
    be = torch.from_numpy((0.1 * rs.randn(3)).astype(np.float32))
    a, b = dc.instance_affine_from_stats(x.sum(dim=(2, 3)), x.square().sum(dim=(2, 3)),
                                         63, g, be)
    want = torch.nn.functional.instance_norm(x, weight=g, bias=be, eps=1e-5)
    np.testing.assert_allclose((x * a[:, :, None, None] + b[:, :, None, None]).numpy(),
                               want.numpy(), rtol=0, atol=1e-5)


# (Co, C, co_pad, c_pad): fmi_decoder_conv_co_pad rounds Co up to its channel
# block (8, 16, 32 or 64), fmi_decoder_conv_c_pad rounds C up to 16
@pytest.mark.parametrize("co,c,co_pad,c_pad", [(64, 128, 64, 128), (32, 64, 32, 64),
                                               (3, 13, 8, 16), (80, 21, 128, 32),
                                               (8, 16, 8, 16)])
def test_tensor_core_weight_packing(co, c, co_pad, c_pad):
    """K4b's tensor-core operand [9, c_pad, co_pad] bf16, contiguous with or
    without padding: unpacked, it equals the weight rounded to bf16
    (exactly), zeros past C and Co; and the sum
    over the nine taps of the input shifted by (ky, kx) times the packed
    weights, the kernel's implicit GEMM, is the plain conv (f32 max-abs
    1e-5 relative: the same products summed in another order)."""
    rs = np.random.RandomState(co + c)
    w = torch.from_numpy(rs.randn(co, c, 3, 3).astype(np.float32))
    packed = dc._weights_mma(w, c_pad, co_pad)
    assert packed.dtype == torch.bfloat16 and packed.shape == (9, c_pad, co_pad)
    assert packed.is_contiguous()  # the kernel reads it by its pointer
    unpacked = packed[:, :c, :co].reshape(3, 3, c, co).permute(3, 2, 0, 1)
    assert torch.equal(unpacked, w.to(torch.bfloat16))
    assert not packed[:, c:].any() and not packed[:, :, co:].any()

    x = torch.from_numpy(rs.randn(2, c, 7, 9).astype(np.float32)).to(torch.bfloat16)
    xp = torch.nn.functional.pad(x.float(), (1, 1, 1, 1))
    y = torch.zeros(2, co_pad, 7, 9)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        shifted = xp[:, :, ky:ky + 7, kx:kx + 9]
        y += torch.einsum("nchw,co->nohw", shifted, packed[tap, :c].float())
    want = dc.conv3x3_stats_plain(x.float(), w.to(torch.bfloat16).float(), None)
    assert float((y[:, :co] - want).abs().max()) <= 1e-5 * float(want.abs().max())


# The taps of ConvTranspose2d(k=3, s=2, p=1, output_padding=1) as four
# GEMMs, one per output parity, as the tensor-core K4a computes them: output
# pixel (2m + py, 2n + px) sums w[:, :, ky, kx] applied to input pixel
# (m + dy, n + dx) over the (ky, kx, dy, dx) of its parity (py, px), the
# input zero past row H - 1 and column W - 1
CONVT_PARITY_TAPS = {
    (0, 0): ((1, 1, 0, 0),),
    (0, 1): ((1, 2, 0, 0), (1, 0, 0, 1)),
    (1, 0): ((2, 1, 0, 0), (0, 1, 1, 0)),
    (1, 1): ((2, 2, 0, 0), (2, 0, 0, 1), (0, 2, 1, 0), (0, 0, 1, 1)),
}


# (C per stream, Co, co_pad, c_pads, H, W, prologue activations): both
# streams, one stream without a prologue, ragged H and W, Co off the 8-wide
# channel tiles; fmi_decoder_conv_co_pad and fmi_decoder_conv_c_pad as in
# the test above
@pytest.mark.parametrize("cs,co,co_pad,c_pads,h,w,pros", [
    ((13, 21), 3, 8, (16, 32), 5, 7, ("LeakyReLU", None)),
    ((16,), 80, 128, (16,), 4, 6, ("ReLU",)),
    ((8, 40), 10, 16, (16, 48), 3, 9, (None, "LeakyReLU")),
])
def test_convt_parity_gemms_from_packed_weights(cs, co, co_pad, c_pads, h, w, pros):
    """K4a's tensor-core operand of each stream, [9, c_pad, co_pad] bf16
    (contiguous, unpacked exactly to the weight rounded to bf16, zeros past
    C and Co), and the kernel's four parity GEMMs emulated in f32 from it
    through CONVT_PARITY_TAPS: the sum over streams and taps, plus the
    biases, equals convt_pair_plain's output on the f32 streams with those
    bf16-rounded weights, and its sums of y and y^2 (f32 max-abs 1e-5
    relative: the same products summed in another order)."""
    rs = np.random.RandomState(sum(cs) + co)
    assert sorted(t for taps in CONVT_PARITY_TAPS.values() for t in
                  [(ky, kx) for ky, kx, _, _ in taps]) == [(ky, kx) for ky in range(3)
                                                           for kx in range(3)]
    streams, y = [], torch.zeros(2, co_pad, 2 * h, 2 * w)
    for c, c_pad, pro in zip(cs, c_pads, pros):
        x = torch.from_numpy(rs.randn(2, c, h, w).astype(np.float32))
        wt = torch.from_numpy((rs.randn(c, co, 3, 3) / 3).astype(np.float32))
        wt = wt.to(torch.bfloat16).float()  # the kernel's operand is bf16
        b = torch.from_numpy(rs.randn(co).astype(np.float32))
        prologue = None
        if pro is not None:
            a, b_, _ = _prologue(rs, 2, c, pro)
            prologue = (torch.from_numpy(a), torch.from_numpy(b_), pro)
        streams.append((x, wt, b, prologue))

        packed = dc._convt_weights_mma(wt, c_pad, co_pad)
        assert packed.dtype == torch.bfloat16 and packed.shape == (9, c_pad, co_pad)
        assert packed.is_contiguous()  # the kernel reads it by its pointer
        unpacked = packed[:, :c, :co].reshape(3, 3, c, co).permute(2, 3, 0, 1)
        assert torch.equal(unpacked, wt.to(torch.bfloat16))
        assert not packed[:, c:].any() and not packed[:, :, co:].any()

        w32 = packed.float()
        xp = torch.nn.functional.pad(dc._prologued(x, prologue), (0, 1, 0, 1))
        for (py, px), taps in CONVT_PARITY_TAPS.items():
            for ky, kx, dy, dx in taps:
                shifted = xp[:, :, dy:dy + h, dx:dx + w]
                y[:, :, py::2, px::2] += torch.einsum("nchw,co->nohw", shifted,
                                                      w32[ky * 3 + kx, :c])
    y = y[:, :co] + sum(b for _, _, b, _ in streams)[None, :, None, None]
    want, (s, sq) = dc.convt_pair_plain(streams, None, with_stats=True)
    scale = float(want.abs().max())
    assert float((y - want).abs().max()) <= 1e-5 * scale
    assert float((y.sum(dim=(2, 3)) - s).abs().max()) <= 1e-5 * float(s.abs().max() + 1)
    assert float((y.square().sum(dim=(2, 3)) - sq).abs().max()) <= 1e-5 * float(sq.abs().max())
