"""Port models against the JAX models on the same weights and inputs:
predict_mask, ResEncoder (src/ref), ResGenerator with an explicit z, and the
slice as a whole, ReferenceFill(use_att=True) with the JAX noise injected.

JAX weights are seeded random values in the shapes of ``init``
(``random_variables``), carried across with convert.py. The JAX side
runs in the slice's configuration, ``norm_act.set_impl("pallas")`` (Pallas
interpret mode on the CPU). Tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import picnet as jp
from face_mask_inpaint_tpu.models.reference_fill import ReferenceFill as JReferenceFill
from face_mask_inpaint_tpu.models.unet import MaskDetector as JMaskDetector
from face_mask_inpaint_tpu.ops.pallas import norm_act as jna
from face_mask_inpaint_tpu_torch.convert import (
    convert_mask_detector, convert_reference_fill, state_dict_from_jax)
from face_mask_inpaint_tpu_torch.models import picnet as tp
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

KEY = jax.random.PRNGKey(0)
ENC = dict(type="pluralistic", ngf=8, z_nc=16, img_f=32, L=1, layers=3,
           norm="none", activation="LeakyReLU", init_type="orthogonal")
DEC = dict(ngf=16, z_nc=16, img_f=64, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="orthogonal")
ENC_ARGS = {k: v for k, v in ENC.items() if k != "type"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def pallas_norm_act(monkeypatch):
    monkeypatch.setattr(jna, "_IMPL", "pallas")


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def random_variables(init, seed):
    """Variables shaped by ``jax.eval_shape(init)``, filled from a seeded
    numpy RandomState: kernels ~ N(0, 1/fan_in), norm scales near 1,
    AutoAttention's gamma (zero at init) random so the attention term
    reaches the output, positive BN variances, unit spectral vectors.
    Tracing ``init`` instead of running it keeps these tests fast."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rs.randn(*shape).astype(np.float32)
        if name == "kernel":
            x /= np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name in ("bias", "mean"):
            x *= 0.1
        elif name == "var":
            x = (0.5 + rs.rand(*shape)).astype(np.float32)
        elif name in ("u", "v"):
            x /= np.linalg.norm(x)
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


@pytest.mark.parametrize("hw", [(32, 32), (36, 28)])
def test_predict_mask_matches_jax_exactly(monkeypatch, hw):
    """The port decides logits[1] > logits[0]; JAX runs its two-channel head
    (FMI_UNET_DIFF_HEAD=0) for an exact match. The logits themselves agree
    to f32 max-abs 1e-4 (18 convs of up to 512 channels)."""
    monkeypatch.setenv("FMI_UNET_DIFF_HEAD", "0")
    rs = np.random.RandomState(0)
    x = rs.rand(2, *hw, 3).astype(np.float32)
    jdet = JMaskDetector()
    variables = random_variables(lambda: jdet.init(KEY, jnp.asarray(x)), 4)
    # put the decision boundary at the median logit difference, so that
    # both classes occur and the comparison decides something
    logits_fn = jax.jit(jdet.apply)
    d = np.asarray(logits_fn(variables, jnp.asarray(x)))
    outc = variables["params"]["model"]["outc"]
    shift = np.median(d[..., 1] - d[..., 0])
    outc["bias"] = outc["bias"].at[1].add(-shift)
    want_mask = np.asarray(jax.jit(
        lambda v, a: jdet.apply(v, a, method=JMaskDetector.predict_mask))(
            variables, jnp.asarray(x)))
    want_logits = np.asarray(logits_fn(variables, jnp.asarray(x)))

    det = MaskDetector()
    det.load_state_dict(convert_mask_detector(det, variables), strict=True)
    with torch.no_grad():
        got_mask = det.predict_mask(torch.from_numpy(x)).numpy()
        got_logits = det(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=1e-4)
    assert got_mask.shape == (2, *hw) and got_mask.dtype == np.float32
    np.testing.assert_array_equal(got_mask, want_mask)
    assert 0 < got_mask.mean() < 1  # both classes present: the test decides something


@pytest.mark.parametrize("encoder_type", ["src", "ref"])
def test_res_encoder_matches_jax(encoder_type):
    """f32 max-abs 1e-5 on mu, std and features."""
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    jenc = jp.define_e(**ENC_ARGS, encoder_type=encoder_type)
    variables = random_variables(lambda: jenc.init(KEY, jnp.asarray(x), train=False), 5)
    (jmu, jstd), jfeat = jax.jit(lambda v, a: jenc.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    tenc = tp.define_e(**ENC_ARGS, encoder_type=encoder_type)
    tenc.load_state_dict(state_dict_from_jax(tenc, variables), strict=True)
    tenc.eval()
    with torch.no_grad():
        (mu, std), feat = tenc(_nchw(x))
    for got, want in ((mu, jmu), (std, jstd), (feat, jfeat)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


def test_res_generator_matches_jax_with_explicit_z():
    """Three decoder stages (six fused instance norms), AutoAttention, the
    Output head. f32 max-abs 1e-4: the instance norms divide by per-plane
    standard deviations, which scales the ~1e-6 conv rounding differences."""
    rs = np.random.RandomState(2)
    encoded = rs.randn(2, 8, 8, 64).astype(np.float32)
    z = rs.randn(2, 8, 8, 32).astype(np.float32)
    jgen = jp.define_g(**DEC)
    variables = random_variables(
        lambda: jgen.init(KEY, jnp.asarray(encoded), z=jnp.asarray(z), train=False), 6)
    want = jax.jit(lambda v, e, zz: jgen.apply(v, e, z=zz, train=False))(
        variables, jnp.asarray(encoded), jnp.asarray(z))
    tgen = tp.define_g(**DEC, input_nc=64, z_channels=32)
    tgen.load_state_dict(state_dict_from_jax(tgen, variables), strict=True)
    tgen.eval()
    with torch.no_grad():
        got = tgen(_nchw(encoded), z=_nchw(z))
    assert got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-4)


def test_generator_rejects_inconsistent_widths():
    """PICNet_inference.py's own defaults (decoder img_f 128 with use_att)
    give encoded and latent features of different widths."""
    with pytest.raises(ValueError, match="channels"):
        tp.define_g(ngf=32, img_f=128, layers=5, input_nc=256, z_channels=256)


@pytest.mark.parametrize("use_att,dec_img_f", [(True, 64), (False, 32)])
def test_reference_fill_slice_matches_jax(use_att, dec_img_f):
    """The slice as a whole, NHWC in and out, with the JAX noise injected:
    rng_q, rng_p = split(rng); eps = normal(key, mu.shape). f32 max-abs
    1e-4 after two encoders, the example-guided attention, six instance
    norms and the decoder."""
    rs = np.random.RandomState(3)
    src = rs.rand(2, 32, 32, 3).astype(np.float32)
    ref = rs.rand(2, 32, 32, 3).astype(np.float32)
    mask = np.zeros((2, 32, 32), np.float32)
    mask[:, 16:27, 8:24] = 1.0
    dec = {**DEC, "img_f": dec_img_f}
    jmodel = JReferenceFill(encoder_params=ENC, decoder_params=dec, use_att=use_att,
                            out_size=(32, 32))
    args = (jnp.asarray(src), jnp.asarray(ref), jnp.asarray(mask))
    variables = random_variables(
        lambda: jmodel.init({"params": KEY, "sample": KEY}, *args, train=False), 7)
    rng = jax.random.PRNGKey(1)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False, rng=rng))(
        variables, *args)
    rng_q, rng_p = jax.random.split(rng)
    eps_q = np.array(jax.random.normal(rng_q, (2, 8, 8, 16)))
    eps_p = np.array(jax.random.normal(rng_p, (2, 8, 8, 16)))

    model = ReferenceFill(ENC, dec, use_att=use_att, out_size=(32, 32))
    model.load_state_dict(convert_reference_fill(model, variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(ref), torch.from_numpy(mask),
                    eps_q=torch.from_numpy(eps_q), eps_p=torch.from_numpy(eps_p))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
