"""Attention parity: the plain K1 (flash_attention_plain), attention_apply and
the attention modules against the JAX package.

The JAX flash kernels run as tests/test_attention.py runs them on the CPU, in
Pallas interpret mode. Tolerances (f32 max-abs): 1e-5 for outputs; 1e-4 for
the base-2 lse, whose magnitude is ~|q|^2 log2(e) (about 30 here) so 1e-5
would ask for 7 significant digits of an f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.nn import blocks as jb
from face_mask_inpaint_tpu.ops import attention as jatt
from face_mask_inpaint_tpu.ops.pallas import flash_attention as jfa
from face_mask_inpaint_tpu_torch.convert import state_dict_from_jax
from face_mask_inpaint_tpu_torch.kernels import flash_attention as tfa
from face_mask_inpaint_tpu_torch.nn import blocks as tb
from face_mask_inpaint_tpu_torch.ops import attention as tatt

ATOL = 1e-5
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(l, widths, seed=0, d=8):
    rs = np.random.RandomState(seed)
    q = (rs.randn(2, l, d) * 0.8).astype(np.float32)
    vs = [rs.randn(2, l, c).astype(np.float32) for c in widths]
    return q, vs


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("widths", [[24], [24, 16]])
def test_plain_flash_matches_pallas_forward(widths):
    """tq = tk = 128 over a ragged L = 320, outputs and lse."""
    q, vs = _inputs(320, widths)
    want, want_lse = jfa._forward(jnp.asarray(q), [jnp.asarray(v) for v in vs], 128, 128,
                                  with_lse=True)
    got, got_lse = tfa.flash_attention(torch.from_numpy(q), _torch(vs), with_lse=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=0, atol=1e-4)


def test_plain_flash_matches_pallas_sym_forward(monkeypatch):
    """The triangular-schedule forward (FMI_FLASH_SYM=1) computes the same
    function; the port is held against it too."""
    monkeypatch.setenv("FMI_FLASH_SYM", "1")
    monkeypatch.setenv("FMI_FLASH_SYM_T", "64")
    q, vs = _inputs(320, [24, 16], seed=1)
    want = jfa.flash_attention(jnp.asarray(q), [jnp.asarray(v) for v in vs])
    got = tfa.flash_attention(torch.from_numpy(q), _torch(vs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("widths", [[24], [24, 16]])
def test_blockwise_attention_matches_jax(widths):
    """The port's blockwise_attention (query == key) against the JAX one
    with k = q, over a ragged L = 320 in 128-key blocks."""
    q, vs = _inputs(320, widths, seed=6)
    want = jatt.blockwise_attention(jnp.asarray(q), jnp.asarray(q),
                                    [jnp.asarray(v) for v in vs], block_size=128)
    got = tatt.blockwise_attention(torch.from_numpy(q), _torch(vs), block_size=128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("l,threshold", [(64, 4096), (320, 4096), (320, 256), (200, 100)])
def test_attention_apply_matches_jax(l, threshold):
    """Both sides of the materialize/stream threshold."""
    q, vs = _inputs(l, [12, 20], seed=2)
    want = jatt.attention_apply(jnp.asarray(q), [jnp.asarray(v) for v in vs],
                                block_threshold=threshold, block_size=128)
    got = tatt.attention_apply(torch.from_numpy(q), _torch(vs), block_threshold=threshold)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_wrappers_reject_other_devices():
    """No quiet fallback: a tensor neither on the CPU nor on CUDA raises."""
    q = torch.empty(1, 8, 4, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, [torch.empty(1, 8, 4, device="meta")])


def _perturbed(variables, seed, names=("gamma",)):
    rs = np.random.RandomState(seed)

    def fix(path, a):
        if path[-1].key in names:  # zero at init: would hide the attention term
            return jnp.asarray(rs.randn(*a.shape).astype(np.float32))
        return a

    return {**variables, "params": jax.tree_util.tree_map_with_path(fix, variables["params"])}


@pytest.mark.parametrize("threshold", [4096, 100])
def test_auto_attention_matches_jax(threshold):
    x = np.random.RandomState(3).randn(2, 16, 20, 32).astype(np.float32)
    jmod = jb.AutoAttention(block_threshold=threshold)
    variables = _perturbed(jmod.init(KEY, jnp.asarray(x)), 4)
    want, _ = jmod.apply(variables, jnp.asarray(x), train=False)
    tmod = tb.AutoAttention(32, block_threshold=threshold)
    tmod.load_state_dict(state_dict_from_jax(tmod, variables), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("threshold", [4096, 100])
def test_example_guided_attention_matches_jax(threshold):
    rs = np.random.RandomState(5)
    src = rs.randn(2, 12, 10, 16).astype(np.float32)
    ref = rs.randn(2, 12, 10, 16).astype(np.float32)
    mask = (rs.rand(2, 12, 10, 1) > 0.5).astype(np.float32)
    jmod = jb.ExampleGuidedAttention(block_threshold=threshold)
    variables = jmod.init(KEY, jnp.asarray(mask), jnp.asarray(src), jnp.asarray(ref))
    want = jmod.apply(variables, jnp.asarray(mask), jnp.asarray(src), jnp.asarray(ref))
    tmod = tb.ExampleGuidedAttention(16, block_threshold=threshold)
    tmod.load_state_dict(state_dict_from_jax(tmod, variables), strict=True)

    def nchw(a):
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())

    with torch.no_grad():
        got = tmod(nchw(mask), nchw(src), nchw(ref))
    assert got.shape == (2, 32, 12, 10)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
