"""The K6 and K7a/K7b autograd Functions on the CPU (their plain versions
inside) against ``jax.grad`` of the Pallas kernels in interpret mode:
upfirdn2d in the three modes StyleGAN2 uses and with an asymmetric filter,
the fused bias-act with and without a bias; first gradients (x, and the
bias) and grad-of-grad with respect to the output cotangent, which runs
each Function's backward through its own backward (the K6 Function calls
itself with the modes swapped; the mask apply applies its mask again).
The transposed pads of the StyleGAN2 call sites are checked as numbers.

JAX runs NHWC, the port NCHW; inputs come from seeded numpy. Tolerance:
max |port - JAX| <= 1e-5 * max |JAX| (f32; the same products summed in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.ops import upfirdn2d as jfir
from face_mask_inpaint_tpu.ops.pallas.fused_act_pallas import fused_leaky_relu_pallas
from face_mask_inpaint_tpu.ops.pallas.upfirdn2d_pallas import upfirdn2d_pallas
from face_mask_inpaint_tpu_torch.kernels import fused_act as tfa
from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as tfir
from face_mask_inpaint_tpu_torch.ops import upfirdn2d as tops

from tests.test_torch_stylegan2 import _assert_rel, _nchw, _nhwc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_grads(op, x, w):
    """(d/dx <op(x), w>, d/dw |d/dx <op(x), w>|^2) of a JAX op on NHWC, each
    under jax.jit (one XLA program, where eager runs one an operation)."""
    def f(x, w):
        return jnp.sum(op(x) * w)

    dx = jax.jit(jax.grad(f))(x, w)
    dw = jax.jit(jax.grad(lambda w: jnp.sum(jax.grad(f)(x, w) ** 2)))(w)
    return np.asarray(dx), np.asarray(dw)


def _torch_grads(op, x, w):
    """The same two gradients through the port's Function on NCHW."""
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    (dx,) = torch.autograd.grad(op(x), x, w, create_graph=True)
    (dw,) = torch.autograd.grad((dx * dx).sum(), w)
    return _nhwc(dx), _nhwc(dw)


@pytest.mark.parametrize("up,down,pad,taps", [
    (1, 1, (1, 1), [1, 3, 3, 1]),   # the blur after each upsampling convT
    (2, 1, (2, 1), [1, 3, 3, 1]),   # the ToRGB skip upsample
    (1, 2, (1, 1), [1, 3, 3, 1]),   # the downsample
    (1, 1, (2, 1), [1, 2, 3, 4]),
    (2, 1, (1, 2), [1, 2, 3, 4]),
    (1, 2, (2, 2), [1, 2, 3, 4]),
])
def test_upfirdn2d_function_grads_match_pallas(up, down, pad, taps):
    """d/dx and grad-of-grad of the K6 Function against jax.grad of
    upfirdn2d_pallas (interpret mode), on an H != W map."""
    rs = np.random.RandomState(3)
    gain = up * up
    x = rs.randn(2, 14, 18, 3).astype(np.float32)
    k2d = jfir.make_kernel(taps) * gain
    y = upfirdn2d_pallas(jnp.asarray(x), k2d, up, down, pad)
    w = rs.randn(*y.shape).astype(np.float32)
    want = _jax_grads(lambda a: upfirdn2d_pallas(a, k2d, up, down, pad), jnp.asarray(x),
                      jnp.asarray(w))
    t = tops.make_taps(taps, gain)
    got = _torch_grads(lambda a: tfir.upfirdn2d(a, t, up, down, pad), _nchw(x), _nchw(w))
    for g, j in zip(got, want):
        _assert_rel(g, j, 1e-5)


def test_upfirdn2d_transposed_pads_at_stylegan2_sites():
    """The gradient's pads at the two StyleGAN2 call sites: the upsampling
    conv's blur (pad (1, 1), 4 taps, on the 2H+1 convT output) goes to
    (2, 2) in mode (1, 1); the ToRGB skip upsample (pad (2, 1), up 2) to
    (1, 1) in mode (1, 2). Both non-negative, for every resolution."""
    for h in (4, 8, 16, 512):
        blur_out = tfir.out_len(2 * h + 1, 1, 1, 1, 1, 4)
        assert blur_out == 2 * h
        assert tfir.transposed_pads(2 * h + 1, blur_out, 4, 1, 1, 1) == (2, 2)
        skip_out = tfir.out_len(h, 2, 1, 2, 1, 4)
        assert skip_out == 2 * h
        assert tfir.transposed_pads(h, skip_out, 4, 2, 1, 2) == (1, 1)
        assert tfir.out_len(skip_out, 1, 2, 1, 1, 4) == h


def test_upfirdn2d_bwd_counts_only_on_cuda():
    """On CPU tensors the Functions run the plain versions and count no
    launch; the backward's output has the input's shape."""
    before = tfir.upfirdn2d.launches, tfir.upfirdn2d_bwd.launches
    x = torch.randn(1, 2, 9, 9, requires_grad=True)
    y = tfir.upfirdn2d(x, [0.25, 0.75, 0.75, 0.25], 1, 1, (1, 1))
    (dx,) = torch.autograd.grad(y.sum(), x)
    assert dx.shape == x.shape
    assert (tfir.upfirdn2d.launches, tfir.upfirdn2d_bwd.launches) == before


@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_leaky_relu_function_grads_match_pallas(with_bias):
    """d/dx, d/dbias and grad-of-grad (d/dw of |dx|^2 + sum dbias) of the
    K7a/K7b Function against jax.grad of fused_leaky_relu_pallas."""
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 6, 7, 5) * 2).astype(np.float32)
    b = rs.randn(5).astype(np.float32) if with_bias else np.zeros(5, np.float32)
    w = rs.randn(2, 6, 7, 5).astype(np.float32)

    def f(x, b, w):
        return jnp.sum(fused_leaky_relu_pallas(x, b) * w)

    jx, jb, jw = (jnp.asarray(a) for a in (x, b, w))
    want_dx, want_db = jax.grad(f, argnums=(0, 1))(jx, jb, jw)
    want_dw = jax.grad(lambda w: jnp.sum(jax.grad(f, argnums=0)(jx, jb, w) ** 2)
                       + jnp.sum(jax.grad(f, argnums=1)(jx, jb, w)))(jw)

    tx = _nchw(x).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_() if with_bias else None
    tw = _nchw(w).requires_grad_()
    y = tfa.fused_leaky_relu(tx, tb)
    grads = torch.autograd.grad(y, [tx] + ([tb] if with_bias else []), tw, create_graph=True)
    dx = grads[0]
    db = grads[1] if with_bias else dx.sum(dim=(0, 2, 3))
    (dw,) = torch.autograd.grad((dx * dx).sum() + db.sum(), tw)
    _assert_rel(_nhwc(dx), np.asarray(want_dx), 1e-5)
    _assert_rel(_nhwc(dw), np.asarray(want_dw), 1e-5)
    if with_bias:
        _assert_rel(db.detach().numpy(), np.asarray(want_db), 1e-5)


def test_fused_leaky_relu_bwd_plain_is_the_mask_apply():
    """The mask apply from the saved output: y >= 0 exactly where x + b >= 0,
    so it is d/dx of the plain forward; dbias is its channel sum."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(3, 4, 5, 6).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rs.randn(4).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rs.randn(3, 4, 5, 6).astype(np.float32))
    y = tfa.fused_leaky_relu_plain(x, b)
    dx, db = torch.autograd.grad(y, (x, b), g)
    mask = tfa.fused_leaky_relu_bwd_plain(y.detach(), g)
    torch.testing.assert_close(mask, dx, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mask.sum(dim=(0, 2, 3)), db, rtol=1e-5, atol=1e-5)
