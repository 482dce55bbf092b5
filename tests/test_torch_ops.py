"""Port ops (face_mask_inpaint_tpu_torch.ops) against the JAX ops.

Same numpy inputs through both; the port runs NCHW, the JAX ops NHWC.
Tolerance: f32 max-abs 1e-5 (both sides compute the same sums in f32 in a
different order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_mask_inpaint_tpu.ops import conv as jconv
from face_mask_inpaint_tpu.ops import resize as jresize
from face_mask_inpaint_tpu_torch.ops import conv as tconv
from face_mask_inpaint_tpu_torch.ops import resize as tresize

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


RESIZE_CASES = {
    "bilinear_up": (lambda x: jresize.bilinear_resize(x, (17, 13)),
                    lambda x: tresize.bilinear_resize(x, (17, 13))),
    "bilinear_down": (lambda x: jresize.bilinear_resize(x, (5, 4)),
                      lambda x: tresize.bilinear_resize(x, (5, 4))),
    "bilinear_half_pixel": (lambda x: jresize.bilinear_resize(x, (7, 20), False),
                            lambda x: tresize.bilinear_resize(x, (7, 20), False)),
    "scale_img": (lambda x: jresize.scale_img(x, (3, 3)),
                  lambda x: tresize.scale_img(x, (3, 3))),
    "adaptive_avg_pool": (lambda x: jresize.adaptive_avg_pool2d(x, (4, 3)),
                          lambda x: tresize.adaptive_avg_pool2d(x, (4, 3))),
    "adaptive_avg_pool_int": (lambda x: jresize.adaptive_avg_pool2d(x, 5),
                              lambda x: tresize.adaptive_avg_pool2d(x, 5)),
    "avg_pool2d": (lambda x: jresize.avg_pool2d(x, 2),
                   lambda x: tresize.avg_pool2d(x, 2)),
    "max_pool2d": (lambda x: jresize.max_pool2d(x, 2),
                   lambda x: tresize.max_pool2d(x, 2)),
    "max_pool2d_stride1": (lambda x: jresize.max_pool2d(x, 3, 1),
                           lambda x: tresize.max_pool2d(x, 3, 1)),
    "reflection_pad2d": (lambda x: jresize.reflection_pad2d(x, 2),
                         lambda x: tresize.reflection_pad2d(x, 2)),
    "pixel_shuffle": (lambda x: jconv.pixel_shuffle(x, 2),
                      lambda x: tconv.pixel_shuffle(x, 2)),
}


@pytest.mark.parametrize("name", sorted(RESIZE_CASES))
def test_resize_and_pool_match_jax(name):
    jfn, tfn = RESIZE_CASES[name]
    x = np.random.RandomState(0).randn(2, 11, 9, 8).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = _nhwc(tfn(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kernel,stride,padding,dilation", [
    (3, 1, 1, 1), (3, 2, 1, 1), (1, 1, 0, 1), (3, 1, 2, 2), (4, 2, 1, 1),
])
def test_conv2d_matches_jax(kernel, stride, padding, dilation):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 10, 9, 5).astype(np.float32)
    w = rs.randn(kernel, kernel, 5, 6).astype(np.float32)  # HWIO
    b = rs.randn(6).astype(np.float32)
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                   stride, padding, dilation))
    got = _nhwc(tconv.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                             torch.from_numpy(b), stride, padding, dilation))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kernel,stride,padding,output_padding", [
    (3, 2, 1, 1), (2, 2, 0, 0), (3, 1, 1, 0), (4, 2, 1, 0),
])
def test_conv_transpose2d_matches_jax(kernel, stride, padding, output_padding):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 6, 5, 4).astype(np.float32)
    w = rs.randn(kernel, kernel, 4, 3).astype(np.float32)  # HWIO
    b = rs.randn(3).astype(np.float32)
    want = np.asarray(jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                             stride, padding, output_padding))
    got = _nhwc(tconv.conv_transpose2d(
        _nchw(x), torch.from_numpy(w.transpose(2, 3, 0, 1).copy()), torch.from_numpy(b),
        stride, padding, output_padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
