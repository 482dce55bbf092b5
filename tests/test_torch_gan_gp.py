"""The port's WGAN-GP gradient penalty (losses/gan.py cal_gradient_penalty)
against the JAX package's on the CPU, float32: PICNet's discriminator
(``define_d(ndf=4, img_f=16, layers=3)`` at 32^2, eval mode, as
tests/test_gan_semantics.py uses it) and the StyleGAN2 discriminator at size
8, both carried across from the same seeded JAX variables.

For 'real', 'fake' and 'mixed' (given the alpha JAX draws from its key):
the penalty, the gradient with respect to the interpolates, and the double
backward, the port's parameter gradients of ``penalty.backward()`` against
``jax.grad`` of the JAX penalty with respect to the params. Tolerances:
the penalty 1e-4 relative, the gradient 1e-4 of its largest entry, each
parameter gradient 1e-3 of the JAX leaf's largest entry.

Last, the launches of the discriminator's forward and of the penalty's two
backwards, counted on the CPU by wrappers that run the plain versions where
the kernels would launch, against what chip_smoke.py's phase 14 derives.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from face_mask_inpaint_tpu.losses import gan as jgan
from face_mask_inpaint_tpu.models import picnet as jp
from face_mask_inpaint_tpu.models import stylegan2 as js
from face_mask_inpaint_tpu_torch.convert import state_dict_from_jax
from face_mask_inpaint_tpu_torch.kernels import fused_act as act
from face_mask_inpaint_tpu_torch.kernels import launch_counts, reset_launch_counts
from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir
from face_mask_inpaint_tpu_torch.losses import gan as tgan
from face_mask_inpaint_tpu_torch.models import picnet as tp
from face_mask_inpaint_tpu_torch.models import stylegan2 as ts
from face_mask_inpaint_tpu_torch.nn.layers import init_weights

from tests.test_torch_stylegan2 import random_variables

KEY = jax.random.PRNGKey(0)
DISC = dict(ndf=4, img_f=16, layers=3, init_type="normal")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _build(which):
    """(JAX apply(variables, x), JAX variables, the loaded port module, HW)."""
    if which == "picnet":
        hw = 32
        jd = jp.define_d(**DISC)
        variables = random_variables(
            lambda: jd.init(KEY, jnp.zeros((2, hw, hw, 3)), train=False), 11)
        td = tp.define_d(input_nc=3, **DISC)

        def apply(v, x):
            return jd.apply(v, x, train=False)
    else:
        hw = 8
        jd = js.Discriminator(size=hw)
        variables = random_variables(lambda: jd.init(KEY, jnp.zeros((4, hw, hw, 3))), 12)
        td = ts.Discriminator(size=hw)
        apply = jd.apply
    td.load_state_dict(state_dict_from_jax(td, variables), strict=True)
    td.eval()
    return apply, variables, td, hw


@pytest.fixture(scope="module", params=["picnet", "stylegan2"])
def disc(request):
    return (request.param, *_build(request.param))


def _leaf_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err:.3e} > {rtol} * {scale:.3e}"


@pytest.mark.parametrize("penalty_type", ["real", "fake", "mixed"])
def test_gradient_penalty_and_double_backward_match_jax(disc, penalty_type):
    name, apply, variables, td, hw = disc
    n = 2 if name == "picnet" else 4
    rs = np.random.RandomState(3)
    real = rs.randn(n, hw, hw, 3).astype(np.float32)
    fake = (real + 0.5 * rs.randn(n, hw, hw, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(7)

    def jax_penalty(params):
        v = dict(variables, params=params)
        return jgan.cal_gradient_penalty(lambda x: apply(v, x), jnp.asarray(real),
                                         jnp.asarray(fake), rng, penalty_type)

    (want_pen, want_grads), want_dparams = jax.jit(
        jax.value_and_grad(jax_penalty, has_aux=True))(variables["params"])

    alpha = np.array(jax.random.uniform(rng, (n, 1, 1, 1), jnp.float32))
    td.zero_grad(set_to_none=True)
    pen, grads = tgan.cal_gradient_penalty(td, _nchw(real), _nchw(fake), penalty_type,
                                           alpha=torch.from_numpy(alpha))
    pen.backward()

    assert abs(float(pen.detach()) - float(want_pen)) <= 1e-4 * abs(float(want_pen))
    _leaf_close(grads.detach().numpy().transpose(0, 2, 3, 1), want_grads, 1e-4, "grads")
    want_sd = state_dict_from_jax(td, {"params": want_dparams})
    named = dict(td.named_parameters())
    assert set(want_sd) == set(named)
    for key, want in want_sd.items():
        g = named[key].grad
        got = torch.zeros_like(named[key]) if g is None else g
        _leaf_close(got.numpy(), want.numpy(), 1e-3, f"d penalty / d {key}")


def test_gradient_penalty_off_and_unknown_type(disc):
    _, _, _, td, hw = disc
    x = torch.randn(2, 3, hw, hw)
    assert tgan.cal_gradient_penalty(td, x, x, lambda_gp=0.0) == (0.0, None)
    with pytest.raises(NotImplementedError):
        tgan.cal_gradient_penalty(td, x, x, penalty_type="both")


def test_gradient_penalty_draws_alpha_from_the_generator():
    """Without alpha, 'mixed' draws it from the given torch.Generator: the
    same seed gives the same penalty, and it is the one of that alpha."""
    td = init_weights(ts.Discriminator(size=8), torch.Generator().manual_seed(0))
    real, fake = torch.randn(4, 3, 8, 8), torch.randn(4, 3, 8, 8)
    p1, _ = tgan.cal_gradient_penalty(td, real, fake, generator=torch.Generator().manual_seed(5))
    p2, _ = tgan.cal_gradient_penalty(td, real, fake, generator=torch.Generator().manual_seed(5))
    alpha = torch.rand((4, 1, 1, 1), generator=torch.Generator().manual_seed(5))
    p3, _ = tgan.cal_gradient_penalty(td, real, fake, alpha=alpha)
    assert float(p1.detach()) == float(p2.detach()) == float(p3.detach()) > 0


@pytest.fixture
def counted_plain_versions(monkeypatch):
    """K6's and K7's Functions on CPU tensors, counting a launch where a CUDA
    tensor would launch its kernel and running the plain version there."""

    def fwd(x, bias, slope, scale):
        act.fused_leaky_relu.launches += 1
        return act.fused_leaky_relu_plain(x, bias, slope, scale)

    def bwd(y, g, slope, scale):
        act.fused_leaky_relu_bwd.launches += 1
        return act.fused_leaky_relu_bwd_plain(y, g, slope, scale)

    def fir_forward(ctx, x, taps, up, down, pad, counter):
        ctx.consts = tuple(x.shape[2:]), taps, up, down, pad
        counter.launches += 1
        return fir.upfirdn2d_plain(x, taps, up, down, pad)

    monkeypatch.setattr(act, "_device", lambda x, what: "cuda")
    monkeypatch.setattr(act, "_launch_fwd", fwd)
    monkeypatch.setattr(act, "_launch_bwd", bwd)
    monkeypatch.setattr(fir._Upfirdn2d, "forward", staticmethod(fir_forward))
    reset_launch_counts()
    yield
    reset_launch_counts()


@pytest.mark.parametrize("size", [8, 16])
def test_penalty_launches_as_chip_smoke_derives(counted_plain_versions, size):
    """One forward, the penalty's d/dx (inside cal_gradient_penalty, after
    the forward) and its double backward launch what phase 14 asserts on
    the card: chip_smoke.disc_launches."""
    fwd, dx, double = chip_smoke.disc_launches(size)
    td = init_weights(ts.Discriminator(size=size), torch.Generator().manual_seed(1))
    x = torch.randn(4, 3, size, size)
    td(x)
    assert {k: v for k, v in launch_counts().items() if v} == fwd
    reset_launch_counts()
    pen, _ = tgan.cal_gradient_penalty(td, x, x.flip(0), alpha=torch.full((4, 1, 1, 1), 0.3))
    want = {k: fwd.get(k, 0) + dx.get(k, 0) for k in set(fwd) | set(dx)}
    assert {k: v for k, v in launch_counts().items() if v} == want
    reset_launch_counts()
    pen.backward()
    assert {k: v for k, v in launch_counts().items() if v} == double
