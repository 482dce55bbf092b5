"""CoordConv, ``use_coord`` through the PICNet modules, AutoAttention's
long-term ``pre`` branch and ``nearest_resize`` against the JAX package, on
the same seeded variables (``random_variables``, carried across with
convert.py) and numpy inputs. JAX applies are jitted; tolerances are stated
in each test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import picnet as jp
from face_mask_inpaint_tpu.nn import blocks as jb
from face_mask_inpaint_tpu.ops import resize as jresize
from face_mask_inpaint_tpu_torch.convert import state_dict_from_jax
from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
from face_mask_inpaint_tpu_torch.kernels import output_head as oh
from face_mask_inpaint_tpu_torch.models import picnet as tp
from face_mask_inpaint_tpu_torch.nn import blocks as tb
from face_mask_inpaint_tpu_torch.ops.resize import nearest_resize
from tests.test_torch_models import random_variables

KEY = jax.random.PRNGKey(0)
ENC_ARGS = dict(ngf=8, z_nc=16, img_f=32, L=1, layers=3, norm="none",
                activation="LeakyReLU", init_type="orthogonal")
DEC = dict(ngf=16, z_nc=16, img_f=64, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="orthogonal")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(model, variables):
    model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("with_r", [False, True])
def test_add_coords_matches_jax(with_r):
    """The coordinate channels (and the radius) on a 2 x 3 x 7 x 5 map: f32
    max-abs 2.4e-7, two ulps below 2 (torch and numpy space linspace's
    points by different formulas)."""
    x = np.random.RandomState(0).randn(2, 7, 5, 3).astype(np.float32)
    want = np.asarray(jb.add_coords(jnp.asarray(x), with_r))
    got = _nhwc(tb.AddCoords(with_r)(_nchw(x)))
    assert got.shape == (2, 7, 5, 6 if with_r else 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("with_r", [False, True])
@pytest.mark.parametrize("use_spect", [False, True])
def test_coord_conv_wrap_matches_jax(with_r, use_spect):
    """CoordConvWrap(use_coord=True): the wrapped 3x3 conv takes 4 + 2 (+1
    with_r) input channels. f32 max-abs 1e-5."""
    x = np.random.RandomState(1).randn(2, 12, 10, 4).astype(np.float32)
    jm = jb.CoordConvWrap(features=5, kernel_size=3, padding=1, use_spect=use_spect,
                          use_coord=True, with_r=with_r)
    variables = random_variables(lambda: jm.init(KEY, jnp.asarray(x)), 2)
    want = jax.jit(lambda v, a: jm.apply(v, a, mutable=["spectral"])[0])(
        variables, jnp.asarray(x))
    model = _load(tb.CoordConvWrap(4, 5, 3, padding=1, use_spect=use_spect, use_coord=True,
                                   with_r=with_r), variables)
    assert model.conv.weight.shape[1] == (7 if with_r else 6)
    with torch.no_grad():
        got = _nhwc(model(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("encoder_type", ["src", "ref"])
def test_res_encoder_use_coord_matches_jax(encoder_type):
    """ResEncoder(use_coord=True) on a 30 x 26 input (every block's convs
    take the coordinates; the downsampling ones fold their pool in JAX and
    pool after the conv here): mu, std and features to f32 max-abs 1e-5."""
    x = np.random.RandomState(3).rand(2, 30, 26, 3).astype(np.float32)
    jenc = jp.define_e(**ENC_ARGS, use_coord=True, encoder_type=encoder_type)
    variables = random_variables(lambda: jenc.init(KEY, jnp.asarray(x), train=False), 4)
    (jmu, jstd), jfeat = jax.jit(lambda v, a: jenc.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    tenc = _load(tp.define_e(**ENC_ARGS, use_coord=True, encoder_type=encoder_type), variables)
    with torch.no_grad():
        (mu, std), feat = tenc(_nchw(x))
    for got, want in ((mu, jmu), (std, jstd), (feat, jfeat)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


def test_res_generator_use_coord_takes_the_dense_forms(monkeypatch):
    """ResGenerator(use_coord=True), built for the fused tail
    (packed_convt, pack_threshold 8, so without CoordConv decoders 1 and 2
    would take it) and asked for the pooled pair head (fuse_pool 2): under
    CoordConv neither K3's pair head nor the fused tail runs (no call of
    their wrappers), the head runs dense at full size, as the JAX generator
    does. Against JAX with an explicit z: f32 max-abs 1e-4 (six instance
    norms, as tests/test_torch_models.py holds the generator)."""
    rs = np.random.RandomState(5)
    encoded = rs.randn(2, 8, 8, 64).astype(np.float32)
    z = rs.randn(2, 8, 8, 32).astype(np.float32)
    dec = {**DEC, "pack_threshold": 8}
    jgen = jp.define_g(**dec, use_coord=True)
    variables = random_variables(
        lambda: jgen.init(KEY, jnp.asarray(encoded), z=jnp.asarray(z), train=False), 6)
    want = jax.jit(lambda v, e, zz: jgen.apply(v, e, z=zz, train=False, fuse_pool=2))(
        variables, jnp.asarray(encoded), jnp.asarray(z))
    tgen = _load(tp.define_g(**dec, use_coord=True, packed_convt=True, input_nc=64,
                             z_channels=32), variables)
    calls = []
    for mod, name in ((dc, "conv3x3_stats"), (dc, "convt_pair"), (oh, "output_head")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    with torch.no_grad():
        got = tgen(_nchw(encoded), z=_nchw(z), fuse_pool=2)
    assert calls == [] and got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("model_type,layers", [("ResDis", 4), ("PatchDis", 3)])
def test_discriminators_use_coord_match_jax(model_type, layers):
    """define_d(use_coord=True) at 64^2: every wrapped conv takes the
    coordinates. f32 max-abs 1e-5 of the output's largest entry."""
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    kw = dict(ndf=4, img_f=16, layers=layers, model_type=model_type, use_coord=True)
    jd = jp.define_d(**kw)
    variables = random_variables(lambda: jd.init(KEY, jnp.asarray(x), train=False), 8)
    want = np.asarray(jax.jit(lambda v, a: jd.apply(v, a, train=False,
                                                    mutable=["spectral"])[0])(
        variables, jnp.asarray(x)))
    td = _load(tp.define_d(input_nc=3, **kw), variables)
    with torch.no_grad():
        got = _nhwc(td(_nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("threshold", [4096, 128], ids=["materialized", "streaming"])
def test_auto_attention_pre_branch_matches_jax(monkeypatch, threshold):
    """AutoAttention with ``pre``: one map, two value sets (C = 16 and
    C_pre = 8), the masked context flow with alpha, and the spectral-norm
    ResBlock ``model`` (instance norm) over [out, context_flow]. 16 x 16 =
    256 tokens: under the default threshold the map is materialized; at a
    threshold of 128 it streams (the K1/K5 Function, its plain versions
    here, with both value sets in one call), while JAX's blockwise form
    runs. gamma and alpha are random, so both terms reach the output. f32
    max-abs 1e-5 of the output's largest entry."""
    rs = np.random.RandomState(9)
    x = rs.randn(2, 16, 16, 16).astype(np.float32)
    pre = rs.randn(2, 16, 16, 8).astype(np.float32)
    mask = np.zeros((2, 16, 16, 1), np.float32)
    mask[:, 4:11, 3:12] = 1.0
    jm = jb.AutoAttention(norm="instance", block_threshold=threshold)
    args = tuple(jnp.asarray(a) for a in (x, pre, mask))
    variables = random_variables(lambda: jm.init(KEY, *args, train=False), 10)
    want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, train=False,
                                                     mutable=["spectral"])[0][0])(
        variables, *args))
    model = _load(tb.AutoAttention(16, 8, norm="instance", block_threshold=threshold),
                  variables)
    seen = []
    plain = fa.flash_attention_plain

    def counted(q, values, **k):
        seen.append([v.shape[-1] for v in values])
        return plain(q, values, **k)

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
    with torch.no_grad():
        got = _nhwc(model(_nchw(x), _nchw(pre), _nchw(mask)))
    assert seen == ([] if threshold == 4096 else [[16, 8]])
    assert got.shape == want.shape == (2, 16, 16, 16)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="pre"):
        model(_nchw(x))


@pytest.mark.parametrize("in_hw,out_hw", [((15, 15), (16, 16)), ((37, 23), (16, 40)),
                                          ((8, 6), (27, 22))])
def test_nearest_resize_matches_jax(in_hw, out_hw):
    """torch's 'nearest' convention (the JAX package's own case of
    tests/test_ops_parity.py, a downscale and an upscale off the grid):
    exact."""
    x = np.random.RandomState(11).randn(2, *in_hw, 3).astype(np.float32)
    want = np.asarray(jresize.nearest_resize(jnp.asarray(x), out_hw))
    got = _nhwc(nearest_resize(_nchw(x), out_hw))
    np.testing.assert_array_equal(got, want)
