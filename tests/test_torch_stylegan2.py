"""The port's StyleGAN2 pieces against the JAX package on the same weights
and inputs: K6's plain version (upfirdn2d) and K7a's plain version
(fused_leaky_relu) against the Pallas kernels in interpret mode and the lax
references, then ModulatedConv2d, StyledConv, ToRGB and a small Generator.

JAX variables are shaped by ``jax.eval_shape(init)`` and filled from a seeded
numpy Generator; applies are jitted. The JAX generator runs its dense
execution (FMI_PACKED_SYNTH=0, set by monkeypatch), the form the port
computes; the packed one is the same function (tests/test_models_stack_b.py).
Everything is float32. Tolerance: max |port - JAX| <= 1e-5 * max |JAX| for
the one-pass ops (the same f32 products summed in another order) and
<= 1e-4 * max |JAX| for the convolution stacks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import stylegan2 as js
from face_mask_inpaint_tpu.ops import upfirdn2d as jfir
from face_mask_inpaint_tpu.ops.fused_act import fused_leaky_relu as jfused_leaky_relu
from face_mask_inpaint_tpu.ops.pallas.fused_act_pallas import fused_leaky_relu_pallas
from face_mask_inpaint_tpu.ops.pallas.upfirdn2d_pallas import upfirdn2d_pallas
from face_mask_inpaint_tpu_torch.convert import convert_stylegan2_generator, state_dict_from_jax
from face_mask_inpaint_tpu_torch.kernels import fused_act as tfa
from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as tfir
from face_mask_inpaint_tpu_torch.models import stylegan2 as ts
from face_mask_inpaint_tpu_torch.ops import upfirdn2d as tops

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


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"max abs err {err:.3e} > {rtol} * max|ref| {scale:.3e}"


def random_variables(init, seed):
    """Variables shaped by ``jax.eval_shape(init)``, filled from a seeded
    numpy Generator: conv and dense kernels N(0, 1/fan_in), StyleGAN2
    weights N(0, 1), modulation biases near 1, noise weights non-zero so the
    noise reaches the output, norm scales near 1, positive variances."""
    rs = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        name, shape = names[-1], leaf.shape
        x = rs.standard_normal(shape, dtype=np.float32)
        if name == "kernel":
            x /= np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name in ("bias", "mean", "activate_bias", "value"):
            x = 0.1 * x + (1.0 if "modulation" in names else 0.0)
        elif name == "var":
            x = 0.5 + rs.random(shape, dtype=np.float32)
        elif name == "alpha":
            x = 0.25 + 0.1 * x
        elif name == "weight" and "noise" in names:
            x = 0.5 * x
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


# -- K6: upfirdn2d --------------------------------------------------------

# (up, down, pad, taps): StyleGAN2's blur after the upsampling convT, its
# skip upsample and downsample, the three modes, and an asymmetric kernel
# that a missing flip would get wrong
UPFIRDN_CASES = [
    (1, 1, (1, 1), [1, 3, 3, 1]),
    (2, 1, (2, 1), [1, 3, 3, 1]),
    (1, 2, (1, 1), [1, 3, 3, 1]),
    (1, 1, (2, 1), [1, 2, 3, 4]),
    (2, 1, (1, 2), [1, 2, 3, 4]),
    (1, 2, (2, 2), [1, 2, 3, 4]),
]


@pytest.mark.parametrize("up,down,pad,taps", UPFIRDN_CASES)
def test_upfirdn2d_plain_matches_pallas_and_lax(up, down, pad, taps):
    """K6's plain version against upfirdn2d_pallas (interpret mode) and
    upfirdn2d_lax on an odd H != W map, max-abs 1e-5 relative."""
    gain = up * up
    x = np.random.RandomState(0).randn(2, 17, 23, 5).astype(np.float32)
    k2d = jfir.make_kernel(taps) * gain
    want_lax = np.asarray(jfir.upfirdn2d_lax(jnp.asarray(x), k2d, up=up, down=down, pad=pad))
    want_pallas = np.asarray(upfirdn2d_pallas(jnp.asarray(x), k2d, up, down, pad))
    got = _nhwc(tfir.upfirdn2d(_nchw(x), tops.make_taps(taps, gain), up, down, pad))
    _assert_rel(got, want_lax, 1e-5)
    _assert_rel(got, want_pallas, 1e-5)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (-1, 2)), (1, 2, (-2, 3)), (2, 1, (-1, 0))])
def test_upfirdn2d_plain_crops_on_negative_pad(up, down, pad):
    """A negative pad crops, as upfirdn2d_lax and the reference CUDA kernel
    do. upfirdn2d_pallas's up=1 branch pads by max(pad0, 0) and does not
    crop (no StyleGAN2 call has a negative pad), so the port is held to the
    lax formulation here."""
    x = np.random.RandomState(0).randn(2, 17, 23, 5).astype(np.float32)
    k2d = jfir.make_kernel([1, 2, 3, 4]) * up * up
    want = np.asarray(jfir.upfirdn2d_lax(jnp.asarray(x), k2d, up=up, down=down, pad=pad))
    got = _nhwc(tfir.upfirdn2d(_nchw(x), tops.make_taps([1, 2, 3, 4], up * up), up, down, pad))
    _assert_rel(got, want, 1e-5)


def test_make_taps_outer_product_is_make_kernel():
    for taps, gain in (([1, 3, 3, 1], 1.0), ([1, 3, 3, 1], 4.0), ([1, 2, 3, 4], 4.0)):
        t = tops.make_taps(taps, gain)
        np.testing.assert_array_equal(tops.make_kernel(taps), jfir.make_kernel(taps))
        np.testing.assert_allclose(np.outer(t, t), tops.make_kernel(taps) * gain, rtol=1e-6)


@pytest.mark.parametrize("fn,factor", [("upsample_2d", 2), ("downsample_2d", 2), ("blur", 1)])
def test_stylegan2_resamplers_match_jax(fn, factor):
    """upsample_2d, downsample_2d and blur with the JAX package's pads."""
    x = np.random.RandomState(1).randn(2, 12, 10, 3).astype(np.float32)
    k2d = jfir.make_kernel([1, 3, 3, 1])
    taps = tops.make_taps([1, 3, 3, 1])
    if fn == "blur":
        want = jfir.blur(jnp.asarray(x), k2d * 4, pad=(1, 1))
        got = tops.blur(_nchw(x), taps, pad=(1, 1), upsample_factor=2)
    else:
        want = getattr(jfir, fn)(jnp.asarray(x), k2d, factor=factor)
        got = getattr(tops, fn)(_nchw(x), taps, factor=factor)
    _assert_rel(_nhwc(got), np.asarray(want), 1e-5)


def test_upfirdn2d_plain_is_differentiable():
    x = _nchw(np.random.RandomState(2).randn(1, 6, 6, 2)).requires_grad_()
    tfir.upfirdn2d(x, tops.make_taps([1, 3, 3, 1], 4), 2, 1, (2, 1)).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# -- K7a: fused_leaky_relu ------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 7, 5, 3), (3, 16)])
def test_fused_leaky_relu_plain_matches_pallas_and_jax(shape):
    """K7a's plain version (bias over dim 1) against fused_leaky_relu_pallas
    (interpret mode) and fused_leaky_relu (bias over the last axis)."""
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    want_pallas = np.asarray(fused_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(b)))
    want = np.asarray(jfused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    got = np.moveaxis(tfa.fused_leaky_relu(xt, torch.from_numpy(b)).numpy(), 1, -1)
    _assert_rel(got, want_pallas, 1e-6)
    _assert_rel(got, want, 1e-6)


def test_fused_leaky_relu_plain_without_bias_is_scaled_leaky_relu():
    x = np.random.RandomState(4).randn(2, 3, 4, 4).astype(np.float32)
    want = np.asarray(js.scaled_leaky_relu(jnp.asarray(x)))
    got = tfa.fused_leaky_relu(torch.from_numpy(x), None).numpy()
    _assert_rel(got, want, 1e-6)


# -- modules ---------------------------------------------------------------

@pytest.mark.parametrize("demodulate,upsample,k", [(True, False, 3), (False, False, 1),
                                                   (True, True, 3), (False, True, 3)])
def test_modulated_conv2d_matches_jax(demodulate, upsample, k):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 6, 7, 12).astype(np.float32)
    style = rs.randn(2, 16).astype(np.float32)
    jmod = js.ModulatedConv2d(8, k, demodulate=demodulate, upsample=upsample)
    variables = random_variables(lambda: jmod.init(KEY, jnp.asarray(x), jnp.asarray(style)), 6)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x), jnp.asarray(style))
    tmod = ts.ModulatedConv2d(12, 8, k, 16, demodulate=demodulate, upsample=upsample)
    tmod.load_state_dict(state_dict_from_jax(tmod, variables), strict=True)
    with torch.no_grad():
        got = tmod(_nchw(x), torch.from_numpy(style))
    _assert_rel(_nhwc(got), np.asarray(want), 1e-5)


@pytest.mark.parametrize("upsample", [False, True])
def test_styled_conv_matches_jax_with_noise(upsample):
    rs = np.random.RandomState(7)
    x = rs.randn(2, 6, 6, 12).astype(np.float32)
    style = rs.randn(2, 16).astype(np.float32)
    side = 12 if upsample else 6
    noise = rs.randn(2, side, side, 1).astype(np.float32)
    jmod = js.StyledConv(8, 3, upsample=upsample)
    args = (jnp.asarray(x), jnp.asarray(style), jnp.asarray(noise))
    variables = random_variables(lambda: jmod.init(KEY, *args), 8)
    want = jax.jit(jmod.apply)(variables, *args)
    tmod = ts.StyledConv(12, 8, 3, 16, upsample=upsample)
    tmod.load_state_dict(state_dict_from_jax(tmod, variables), strict=True)
    with torch.no_grad():
        got = tmod(_nchw(x), torch.from_numpy(style), _nchw(noise))
    _assert_rel(_nhwc(got), np.asarray(want), 1e-5)


def test_to_rgb_matches_jax_with_skip():
    rs = np.random.RandomState(9)
    x = rs.randn(2, 8, 8, 12).astype(np.float32)
    style = rs.randn(2, 16).astype(np.float32)
    skip = rs.randn(2, 4, 4, 3).astype(np.float32)
    jmod = js.ToRGB()
    args = (jnp.asarray(x), jnp.asarray(style), jnp.asarray(skip))
    variables = random_variables(lambda: jmod.init(KEY, *args), 10)
    want = jax.jit(jmod.apply)(variables, *args)
    tmod = ts.ToRGB(12, 16)
    tmod.load_state_dict(state_dict_from_jax(tmod, variables), strict=True)
    with torch.no_grad():
        got = tmod(_nchw(x), torch.from_numpy(style), _nchw(skip))
    _assert_rel(_nhwc(got), np.asarray(want), 1e-5)


@pytest.fixture(scope="module")
def small_generator():
    """JAX Generator(size=32, base_channels=32) variables and its port."""
    jgen = js.Generator(size=32, base_channels=32)
    z = jnp.zeros((2, 512))
    variables = random_variables(
        lambda: jgen.init({"params": KEY, "noise": KEY}, [z], randomize_noise=False), 11)
    tgen = ts.Generator(size=32, base_channels=32)
    tgen.load_state_dict(convert_stylegan2_generator(tgen, variables), strict=True)
    tgen.eval()
    return jgen, variables, tgen


@pytest.mark.parametrize("case", ["w_plus", "mixing_truncation"])
def test_generator_matches_jax_with_fixed_noise(small_generator, case):
    """The generator from w+ codes, and from two z (style MLP, style mixing
    at inject_index 3, truncation 0.7), with the fixed noise buffers."""
    jgen, variables, tgen = small_generator
    rs = np.random.RandomState(12)
    if case == "w_plus":
        styles = [rs.randn(2, jgen.n_latent, 512).astype(np.float32)]
        kw = dict(input_is_latent=True)
    else:
        styles = [rs.randn(2, 512).astype(np.float32) for _ in range(2)]
        trunc = rs.randn(1, 512).astype(np.float32) * 0.1
        kw = dict(inject_index=3, truncation=0.7)
    jkw = dict(kw, **({"truncation_latent": jnp.asarray(trunc)} if "truncation" in kw else {}))
    want, _ = jax.jit(lambda v, s: jgen.apply(v, s, randomize_noise=False, **jkw))(
        variables, [jnp.asarray(s) for s in styles])
    tkw = dict(kw, **({"truncation_latent": torch.from_numpy(trunc)} if "truncation" in kw
                      else {}))
    with torch.no_grad():
        got, latent = tgen([torch.from_numpy(s) for s in styles], randomize_noise=False,
                           return_latents=True, **tkw)
    assert got.shape == (2, 3, 32, 32) and latent.shape == (2, jgen.n_latent, 512)
    _assert_rel(_nhwc(got), np.asarray(want), 1e-4)


def test_generator_mean_latent_and_mixing_needs_inject_index(small_generator):
    """mean_latent is the mean of the style MLP over seeded z (checked
    against map_style of the same draws); style mixing without an explicit
    inject_index raises, as in the JAX package."""
    _, _, tgen = small_generator
    with torch.no_grad():
        avg = tgen.mean_latent(64, torch.Generator().manual_seed(0))
        z = torch.randn((64, 512), generator=torch.Generator().manual_seed(0))
        want = tgen.map_style(z).mean(dim=0, keepdim=True)
    assert avg.shape == (1, 512) and torch.equal(avg, want)
    with pytest.raises(ValueError, match="inject_index"):
        tgen([torch.zeros(1, 512)] * 2)
