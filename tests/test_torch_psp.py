"""The port's IR-SE encoders and pSp against the JAX package on the same
weights and inputs: SEModule and BottleneckIR, the GradualStyleEncoder
(IR-SE with num_layers=4) with and without the reference fusion and its
attention, the two last-layer backbone encoders, and the slice as a whole:
the mask detector, then PSP(output_size=32, num_layers=4,
decoder_base_channels=32, use_attention=True, start_from_latent_avg=True)
with the fixed noise, at batch 2. Also the recorded reference-torch fixtures
(tests/fixtures/parity), converted by the JAX package's tools/convert_torch.py
and then by the port's convert.py.

JAX variables are shaped by ``jax.eval_shape(init)`` and filled from a seeded
numpy Generator; applies are jitted. Everything is float32. Tolerance:
max |port - JAX| <= 1e-4 * max |JAX| (convolution stacks whose f32 sums run
in another order), and the fixtures' own 5e-4 absolute
(tests/test_parity_report.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import irse as ji
from face_mask_inpaint_tpu.models.psp import PSP as JPSP
from face_mask_inpaint_tpu.models.unet import MaskDetector as JMaskDetector
from face_mask_inpaint_tpu.tools import convert_torch as ct
from face_mask_inpaint_tpu.tools.parity_report import DEFAULT_FIXTURE_DIR, _load_fixture
from face_mask_inpaint_tpu_torch.convert import (
    convert_gradual_style_encoder, convert_mask_detector, convert_psp, state_dict_from_jax)
from face_mask_inpaint_tpu_torch.models import irse as ti
from face_mask_inpaint_tpu_torch.models import stylegan2 as ts
from face_mask_inpaint_tpu_torch.models.psp import PSP
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

from tests.test_torch_stylegan2 import _assert_rel, _nchw, _nhwc, random_variables

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def dense_synthesis(monkeypatch):
    monkeypatch.setenv("FMI_PACKED_SYNTH", "0")


def _load(module, variables):
    module.load_state_dict(state_dict_from_jax(module, variables), strict=True)
    return module.eval()


@pytest.mark.parametrize("in_c,depth,stride,use_se", [(32, 64, 2, True), (64, 64, 2, True),
                                                      (64, 64, 1, False)])
def test_bottleneck_ir_matches_jax(in_c, depth, stride, use_se):
    """Both shortcuts (1x1 conv + BN, stride slice), with and without SE."""
    x = np.random.RandomState(0).randn(2, 9, 11, in_c).astype(np.float32)
    jmod = ji.BottleneckIR(depth, stride, use_se=use_se)
    variables = random_variables(lambda: jmod.init(KEY, jnp.asarray(x), train=False), 1)
    want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables, jnp.asarray(x))
    tmod = _load(ti.BottleneckIR(in_c, depth, stride, use_se=use_se), variables)
    with torch.no_grad():
        got = tmod(_nchw(x))
    _assert_rel(_nhwc(got), np.asarray(want), 1e-5)


def test_se_module_matches_jax():
    x = np.random.RandomState(2).randn(2, 5, 5, 32).astype(np.float32)
    jmod = ji.SEModule()
    variables = random_variables(lambda: jmod.init(KEY, jnp.asarray(x)), 3)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _load(ti.SEModule(32), variables)(_nchw(x))
    _assert_rel(_nhwc(got), np.asarray(want), 1e-6)


def test_get_blocks_and_taps():
    assert ti.tap_indices(50) == ji._tap_indices(50) == (6, 20, 23)
    assert ti.tap_indices(4) == ji._tap_indices(4)
    for n in (4, 50, 100, 152):
        assert [list(map(tuple, b)) for b in ti.get_blocks(n)] == [
            list(map(tuple, b)) for b in ji.get_blocks(n)]
    with pytest.raises(ValueError):
        ti.get_blocks(18)


def _images(seed, n=2, hw=64):
    rs = np.random.RandomState(seed)
    src = (rs.rand(n, hw, hw, 3) * 2 - 1).astype(np.float32)
    ref = (rs.rand(n, hw, hw, 3) * 2 - 1).astype(np.float32)
    mask = np.zeros((n, hw, hw), np.float32)
    mask[:, hw // 2: hw - 6, 10: hw - 10] = 1.0
    return src, ref, mask


@pytest.fixture(scope="module")
def encoder_variables():
    """GradualStyleEncoder(num_layers=4, n_styles=8, use_attention=True)
    variables; the encoder without attention takes the same minus the two
    attention modules."""
    src, ref, mask = _images(4)
    jenc = ji.GradualStyleEncoder(num_layers=4, n_styles=8, use_attention=True)
    return random_variables(lambda: jenc.init(KEY, jnp.asarray(src), jnp.asarray(ref),
                                              jnp.asarray(mask), train=False), 5)


@pytest.mark.parametrize("use_ref,use_attention", [(False, False), (True, False), (True, True)])
def test_gradual_style_encoder_matches_jax(encoder_variables, use_ref, use_attention):
    """IR-SE num_layers=4 at 64^2, 8 style heads (output_size 32, all three
    pyramid levels): the FPN and heads alone, with the mask-lerp fusion, with
    the attention fusion."""
    src, ref, mask = _images(4)
    variables = encoder_variables
    if not use_attention:
        variables = {col: {k: v for k, v in tree.items() if not k.startswith("attention")}
                     for col, tree in variables.items()}
    jenc = ji.GradualStyleEncoder(num_layers=4, n_styles=8, use_attention=use_attention)
    args = (jnp.asarray(src), jnp.asarray(ref) if use_ref else None,
            jnp.asarray(mask) if use_ref else None)
    want = jax.jit(lambda v, a, r, m: jenc.apply(v, a, r, m, train=False))(variables, *args)
    tenc = ti.GradualStyleEncoder(num_layers=4, n_styles=8, use_attention=use_attention)
    tenc.load_state_dict(convert_gradual_style_encoder(tenc, variables), strict=True)
    tenc.eval()
    with torch.no_grad():
        got = tenc(_nchw(src), _nchw(ref) if use_ref else None,
                   torch.from_numpy(mask) if use_ref else None)
    assert got.shape == (2, 8, 512)
    _assert_rel(got.numpy(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("kind", ["IntoW", "IntoWPlus"])
def test_backbone_encoders_match_jax(kind):
    """The last-layer encoders at 112^2 (a 7x7 last map); IntoWPlus
    flattens its pool in NHWC order for its Dense layer."""
    x = np.random.RandomState(6).randn(2, 112, 112, 3).astype(np.float32)
    if kind == "IntoW":
        jenc, tenc = ji.BackboneEncoderUsingLastLayerIntoW(4), \
            ti.BackboneEncoderUsingLastLayerIntoW(4)
    else:
        jenc, tenc = ji.BackboneEncoderUsingLastLayerIntoWPlus(4, n_styles=4), \
            ti.BackboneEncoderUsingLastLayerIntoWPlus(4, n_styles=4)
    variables = random_variables(lambda: jenc.init(KEY, jnp.asarray(x), train=False), 7)
    want = jax.jit(lambda v, a: jenc.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _load(tenc, variables)(_nchw(x))
    _assert_rel(got.numpy(), np.asarray(want), 1e-4)


def test_psp_slice_matches_jax(monkeypatch):
    """The slice as a whole, NHWC in and out: the mask detector on
    (src + 1) / 2, then pSp with the reference fusion and attention, the
    latent_avg offset, the fixed noise and the pool to 256^2, at batch 2.
    The mask's decision boundary sits at the median logit difference, so
    both classes occur; JAX runs its two-channel head for an exact mask."""
    monkeypatch.setenv("FMI_UNET_DIFF_HEAD", "0")
    src, ref, _ = _images(8)
    det_in = jnp.asarray((src + 1) / 2)
    jdet = JMaskDetector()
    md_vars = random_variables(lambda: jdet.init(KEY, det_in), 9)
    det = MaskDetector()
    det.load_state_dict(convert_mask_detector(det, md_vars), strict=True)
    with torch.no_grad():  # the port's logits equal JAX's (test_torch_models.py)
        d = det(torch.from_numpy(np.array(det_in))).numpy()
    outc = md_vars["params"]["model"]["outc"]
    outc["bias"] = outc["bias"].at[1].add(-np.median(d[..., 1] - d[..., 0]))
    det.load_state_dict(convert_mask_detector(det, md_vars), strict=True)

    cfg = dict(output_size=32, num_layers=4, decoder_base_channels=32, use_attention=True,
               start_from_latent_avg=True)
    jpsp = JPSP(**cfg)
    x0, m0 = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64))
    variables = random_variables(lambda: jpsp.init(
        {"params": KEY, "noise": KEY}, x0, ref=x0, src_mask=m0, train=False), 10)

    @jax.jit
    def jax_slice(mv, gv, s, r):
        m = jdet.apply(mv, (s + 1) / 2, method=JMaskDetector.predict_mask)
        return jpsp.apply(gv, s, ref=r, src_mask=m, resize=True, randomize_noise=False,
                          train=False), m

    want, want_mask = jax_slice(md_vars, variables, jnp.asarray(src), jnp.asarray(ref))

    psp = PSP(**cfg, init=False).eval()
    psp.load_state_dict(convert_psp(psp, variables), strict=True)
    assert float(psp.latent_avg.abs().max()) > 0  # the offset is live
    with torch.no_grad():
        s, r = torch.from_numpy(src), torch.from_numpy(ref)
        mask = det.predict_mask((s + 1) / 2)
        got = psp(s, r, mask, randomize_noise=False)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert 0 < float(mask.mean()) < 1
    assert got.shape == (2, 256, 256, 3) and torch.isfinite(got).all()
    _assert_rel(got.numpy(), np.asarray(want), 1e-4)


def test_styled_conv_fixture_matches_reference_torch():
    """The recorded reference-torch StyledConv (upsample) through the JAX
    converter, then the port's convert.py: out:y within 5e-4."""
    sd, ins, outs = _load_fixture(f"{DEFAULT_FIXTURE_DIR}/styled_conv_up.npz")
    w = sd["blk.conv.weight"]
    tmod = ts.StyledConv(w.shape[2], w.shape[1], w.shape[3], sd["blk.conv.modulation.weight"]
                         .shape[1], upsample=True)
    _load(tmod, {"params": ct._styled_conv(sd, "blk")})
    with torch.no_grad():
        got = tmod(torch.from_numpy(ins["x"]), torch.from_numpy(ins["style"]),
                   torch.from_numpy(ins["noise"]))
    assert got.shape == outs["y"].shape
    assert np.abs(got.numpy() - outs["y"]).max() < 5e-4


def test_irse_bottleneck_fixture_matches_reference_torch():
    sd, ins, outs = _load_fixture(f"{DEFAULT_FIXTURE_DIR}/irse_bottleneck.npz")
    params, stats = ct._split_bn(ct._irse_unit(sd, "unit"))
    depth, in_c = sd["unit.res_layer.1.weight"].shape[:2]
    tmod = _load(ti.BottleneckIR(in_c, depth, 2, use_se=True),
                 {"params": params, "batch_stats": stats})
    with torch.no_grad():
        got = tmod(torch.from_numpy(ins["x"]))
    assert got.shape == outs["y"].shape
    assert np.abs(got.numpy() - outs["y"]).max() < 5e-4
