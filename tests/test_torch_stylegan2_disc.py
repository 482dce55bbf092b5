"""The port's StyleGAN2 discriminator (ConvLayer, DResBlock, Discriminator)
against the JAX package on the same weights and inputs, float32 on the CPU
(K6 and K7a take their plain versions here).

JAX variables are shaped by ``jax.eval_shape(init)`` and filled from a seeded
numpy Generator (tests/test_torch_stylegan2.py's ``random_variables``), carried
across by ``convert_stylegan2_discriminator`` and loaded with ``strict=True``;
applies are jitted. Tolerance: max |port - JAX| <= 1e-5 * max |JAX| for one
ConvLayer, <= 1e-4 * max |JAX| for a DResBlock and the whole discriminator
(the same f32 products summed in another order through a conv stack).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import stylegan2 as js
from face_mask_inpaint_tpu_torch.convert import (
    convert_stylegan2_discriminator, state_dict_from_jax)
from face_mask_inpaint_tpu_torch.models import stylegan2 as ts

from tests.test_torch_stylegan2 import random_variables

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"max abs err {err:.3e} > {rtol} * max|ref| {scale:.3e}"


def _pair(jmod, tmod, x_nhwc, seed):
    """(port output in NHWC or [N, k], JAX output) for one input."""
    variables = random_variables(lambda: jmod.init(KEY, jnp.asarray(x_nhwc)), seed)
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x_nhwc)))
    tmod.load_state_dict(state_dict_from_jax(tmod, variables), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))))
    got = got.numpy()
    return (got.transpose(0, 2, 3, 1) if got.ndim == 4 else got), want


# (kernel_size, downsample, bias, activate): the residual convs, the
# downsampling conv, the skip, an activated layer without a bias (the scaled
# LeakyReLU) and an unactivated one with the conv's own bias
CONV_LAYERS = [(3, False, True, True), (3, True, True, True), (1, True, False, False),
               (3, False, False, True), (1, False, True, False)]


@pytest.mark.parametrize("k,down,bias,act", CONV_LAYERS)
def test_conv_layer_matches_jax(k, down, bias, act):
    x = np.random.RandomState(1).randn(2, 10, 10, 6).astype(np.float32)
    jmod = js.ConvLayer(8, k, downsample=down, use_bias=bias, activate=act)
    tmod = ts.ConvLayer(6, 8, k, downsample=down, bias=bias, activate=act)
    got, want = _pair(jmod, tmod, x, 3)
    assert got.shape == ((2, 5, 5, 8) if down else (2, 10, 10, 8))
    _assert_rel(got, want, 1e-5)


def test_conv_layer_pads_as_jax():
    """The blur pads ((p + 1) // 2, p // 2), p = len(k) - 2 + kernel_size - 1:
    (2, 2) before a 3x3 and (1, 1) before a 1x1 downsampling conv."""
    assert ts.ConvLayer(4, 4, 3, downsample=True).blur_pad == (2, 2)
    assert ts.ConvLayer(4, 4, 1, downsample=True).blur_pad == (1, 1)
    assert ts.ConvLayer(4, 4, 1, downsample=True, activate=False, bias=False).activate_bias is None


def test_dres_block_matches_jax():
    x = np.random.RandomState(2).randn(2, 12, 12, 6).astype(np.float32)
    got, want = _pair(js.DResBlock(6, 10), ts.DResBlock(6, 10), x, 4)
    assert got.shape == (2, 6, 6, 10)
    _assert_rel(got, want, 1e-4)


@pytest.fixture(scope="module")
def disc8():
    """The size-8 discriminator's JAX module, variables and jitted apply."""
    jd = js.Discriminator(size=8)
    x = jnp.zeros((4, 8, 8, 3), jnp.float32)
    variables = random_variables(lambda: jd.init(KEY, x), 5)
    return jd, variables, jax.jit(jd.apply)


@pytest.mark.parametrize("batch", [2, 4, 8])
def test_discriminator_size8_matches_jax(disc8, batch):
    """Batch 2 (group 2 < stddev_group), 4 (one group) and 8 (n / group =
    2): the minibatch stddev's grouping in NCHW."""
    jd, variables, apply = disc8
    x = np.random.RandomState(batch).randn(batch, 8, 8, 3).astype(np.float32)
    want = np.asarray(apply(variables, jnp.asarray(x)))
    td = ts.Discriminator(size=8)
    td.load_state_dict(convert_stylegan2_discriminator(td, variables), strict=True)
    with torch.no_grad():
        got = td(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
    assert got.shape == (batch, 1) and np.isfinite(got).all()
    _assert_rel(got, want, 1e-4)


def test_minibatch_stddev_groups_interleave():
    """Row b of the appended channel is the stddev of the group holding rows
    b mod (n / group), b mod (n / group) + n / group, ... (the JAX reshape
    to (group, n / group, ...)), here against a direct numpy computation."""
    td = ts.Discriminator(size=8)
    out = torch.from_numpy(np.random.RandomState(0).randn(8, 6, 3, 3).astype(np.float32))
    got = td.minibatch_stddev(out)
    assert got.shape == (8, 7, 3, 3)
    torch.testing.assert_close(got[:, :6], out)
    a = out.numpy().reshape(4, 2, 6, 3, 3)
    want = np.sqrt(a.var(axis=0) + 1e-8).mean(axis=(1, 2, 3))
    np.testing.assert_allclose(got[:, 6, 0, 0].numpy(), np.tile(want, 4), rtol=1e-6)


def test_convert_stylegan2_discriminator_strict(disc8):
    """Every JAX leaf lands on a port key, and every port key is covered:
    ``final_linear1``'s [(h, w, c), out] weight transposed as it is."""
    _, variables, _ = disc8
    td = ts.Discriminator(size=8)
    sd = convert_stylegan2_discriminator(td, variables)
    assert set(sd) == set(td.state_dict())
    w = np.asarray(variables["params"]["final_linear1"]["weight"])
    np.testing.assert_array_equal(sd["final_linear1.weight"].numpy(), w.T)
    assert "res_3.skip.conv.bias" not in sd and "conv_in.activate_bias" in sd
    with pytest.raises(TypeError):
        convert_stylegan2_discriminator(ts.ConvLayer(3, 4, 1), variables)


def test_discriminator_size16_matches_jax():
    jd = js.Discriminator(size=16)
    x = np.random.RandomState(16).randn(4, 16, 16, 3).astype(np.float32)
    got, want = _pair(jd, ts.Discriminator(size=16), x, 7)
    assert got.shape == (4, 1)
    _assert_rel(got, want, 1e-4)
