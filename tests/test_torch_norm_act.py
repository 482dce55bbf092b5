"""The plain K2 (instance_norm_act_plain, via the CPU branch of
instance_norm_act) against the JAX Pallas kernel in interpret mode and
against instance_norm_act_reference, for each activation, with and without
the affine. Tolerance: f32 max-abs 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_mask_inpaint_tpu.ops.pallas import norm_act as jna
from face_mask_inpaint_tpu_torch.kernels import norm_act as tna

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
