"""The plain K2 (instance_norm_act_plain, via the CPU branch of
instance_norm_act) against the JAX Pallas kernel in interpret mode and
against instance_norm_act_reference, for each activation, with and without
the affine. Tolerance: f32 max-abs 1e-5.

Gradients: K2's autograd Function (the CPU branch: plain forward, backward
recomputing the plain version) against autograd of the plain version and
against jax.grad of the JAX custom_vjp; and the plain versions of K3 and K4,
which no longer detach their weights, against the weight and bias gradients
of F.conv2d and F.conv_transpose2d.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch.nn.functional as F

from face_mask_inpaint_tpu.ops.pallas import norm_act as jna
from face_mask_inpaint_tpu_torch.kernels import decoder_conv as tdc
from face_mask_inpaint_tpu_torch.kernels import norm_act as tna
from face_mask_inpaint_tpu_torch.kernels import output_head as toh

ATOL = 1e-5
JAX_IMPLS = {"pallas": jna.instance_norm_act, "reference": jna.instance_norm_act_reference}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("impl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU", "none"])
@pytest.mark.parametrize("affine", [True, False])
def test_plain_norm_act_matches_jax(impl, act, affine):
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 12, 10, 6) * 2 + 0.5).astype(np.float32)  # NHWC
    scale = rs.randn(6).astype(np.float32) if affine else None
    bias = rs.randn(6).astype(np.float32) if affine else None
    want = JAX_IMPLS[impl](jnp.asarray(x), None if scale is None else jnp.asarray(scale),
                           None if bias is None else jnp.asarray(bias), act, 0.1, 1e-5)
    got = tna.instance_norm_act(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        None if scale is None else torch.from_numpy(scale),
        None if bias is None else torch.from_numpy(bias), act, 0.1, 1e-5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_plain_norm_act_keeps_dtype_and_clamps_variance():
    """bf16 in, bf16 out, f32 stats; a constant plane (E[x^2] - mu^2 rounds
    below 0) normalizes to 0 instead of NaN."""
    x = torch.full((1, 2, 8, 8), 3.1, dtype=torch.bfloat16)
    y = tna.instance_norm_act(x, None, None, "none")
    assert y.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all() and y.float().abs().max() == 0


def test_norm_act_rejects_other_devices():
    with pytest.raises(ValueError):
        tna.instance_norm_act(torch.empty(1, 2, 3, 3, device="meta"), None, None)


@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU", "none"])
def test_norm_act_function_grads_match_plain_autograd_and_jax(act):
    """d(x, weight, bias) of sum(y * dy): the Function against autograd of
    instance_norm_act_plain (f32 max-abs 1e-6) and against jax.grad of the
    JAX Pallas instance_norm_act (f32 atol 1e-5 + rtol 1e-5: the weight
    gradients sum a whole plane, up to ~30 here)."""
    rs = np.random.RandomState(1)
    x = (rs.randn(2, 6, 12, 10) * 2 + 0.5).astype(np.float32)  # NCHW
    w, b = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    dy = rs.randn(*x.shape).astype(np.float32)
    fn_in = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = torch.autograd.grad(tna.instance_norm_act(*fn_in, act), fn_in, torch.from_numpy(dy))
    plain_in = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    want = torch.autograd.grad(tna.instance_norm_act_plain(*plain_in, act), plain_in,
                               torch.from_numpy(dy))
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=0, atol=1e-6)

    def loss(xx, ww, bb):
        return jnp.sum(jna.instance_norm_act(xx, ww, bb, act, 0.1, 1e-5)
                       * jnp.asarray(dy.transpose(0, 2, 3, 1)))

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                           jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jg[0]).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    for g, j in zip(got[1:], jg[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_plain_k3_k4_weight_grads_match_torch_convs():
    """The plain versions are differentiable references: in f32 (no
    rounding), their weight and bias gradients equal those of the plain
    torch convs they wrap (f32 max-abs 1e-5)."""
    rs = np.random.RandomState(2)

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    h, s = t(2, 5, 12, 10), t(2, 5, 12, 10)
    w, b = t(3, 5, 3, 3).requires_grad_(), t(3).requires_grad_()
    got = torch.autograd.grad(toh.output_head_plain(h, s, w, b, "LeakyReLU", 2).sum(), [w, b])
    a = F.pad(F.leaky_relu(h + s, 0.1), (1, 1, 1, 1), mode="reflect")
    want = torch.autograd.grad(F.avg_pool2d(torch.tanh(F.conv2d(a, w, b)), 2).sum(), [w, b])
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=0, atol=1e-5)

    x = t(2, 4, 9, 7)
    w, b = t(6, 4, 3, 3).requires_grad_(), t(6).requires_grad_()
    got = torch.autograd.grad(tdc.conv3x3_stats_plain(x, w, b).square().sum(), [w, b])
    want = torch.autograd.grad(F.conv2d(x, w, b, padding=1).square().sum(), [w, b])
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=1e-5, atol=1e-5)

    x2 = t(2, 3, 9, 7)
    wt1, wt2 = t(4, 6, 3, 3).requires_grad_(), t(3, 6, 3, 3).requires_grad_()
    b1, b2 = t(6).requires_grad_(), t(6).requires_grad_()
    params = [wt1, wt2, b1, b2]
    got = torch.autograd.grad(
        tdc.convt_pair_plain([(x, wt1, b1), (x2, wt2, b2)]).square().sum(), params)
    y = (F.conv_transpose2d(x, wt1, b1, 2, 1, 1) + F.conv_transpose2d(x2, wt2, b2, 2, 1, 1))
    want = torch.autograd.grad(y.square().sum(), params)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=1e-5, atol=1e-5)
