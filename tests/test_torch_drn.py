"""The port's DRN (models/drn.py) and its converter against the JAX package.

- ``convert_drn_c``: the port's copy returns the JAX converter's tree leaf for
  leaf (``np.array_equal``) on the reference-layout DRN-C-42 state dict of
  tests/test_converter_numeric.py, and that tree loads strictly into the
  port's ``drn_c_42``, which then matches the reference torch module.
- ``DRN`` against the JAX ``DRN`` on the same seeded variables, in eval mode
  (running statistics) and in train mode (batch statistics; outputs and the
  moved running statistics), for arch C with BasicBlock and with Bottleneck
  and for arch D, at narrow channels.
- ``drn_c_42`` at full width once, 64^2, batch 1.

JAX applies are jitted. Tolerances are stated in each test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import drn as jdrn
from face_mask_inpaint_tpu.tools import convert_torch as jct
from face_mask_inpaint_tpu_torch.convert import convert_drn, state_dict_from_jax
from face_mask_inpaint_tpu_torch.models import drn as tdrn
from face_mask_inpaint_tpu_torch.tools import convert_torch as tct
from tests import test_converter_numeric as tcn
from tests.test_torch_models import random_variables

KEY = jax.random.PRNGKey(0)
NARROW = (4, 8, 8, 12, 12, 16, 8, 8)


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


def _leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_convert_drn_c_matches_jax_and_loads_into_the_port():
    """Leaf for leaf against the JAX converter; then the port's drn_c_42 with
    the converted tree against the reference torch module at 64^2, f32
    max-abs 1e-4 (42 convs of up to 512 channels, summed in another order)."""
    torch.manual_seed(3)
    tm = tcn._TorchDRNC42().eval()
    tcn._randomize_bn(tm)
    sd = {k: v.numpy() for k, v in tm.state_dict().items() if "num_batches" not in k}
    tree = tct.convert_drn_c(sd)
    _leaves_equal(tree, jct.convert_drn_c(sd))

    model = tdrn.drn_c_42()
    model.load_state_dict(convert_drn(model, tree), strict=True)
    x = np.random.RandomState(5).rand(1, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        got, want = model(torch.from_numpy(x)), tm(torch.from_numpy(x))
    assert got.shape == (1, 128, 8, 8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def _jax_drn(case):
    if case == "C-basic":
        return jdrn.DRN(layers=(1, 1, 2, 2, 2, 1, 1, 1), channels=NARROW, head_features=6)
    if case == "C-bottleneck":
        return jdrn.DRN(layers=(1, 1, 2, 1, 2, 1, 1, 1), channels=NARROW,
                        block=jdrn.Bottleneck, head_features=6)
    return jdrn.DRN(layers=(1, 2, 2, 1, 2, 1, 2, 1), channels=NARROW, arch="D",
                    head_features=None)


def _port_drn(case):
    if case == "C-basic":
        return tdrn.DRN(layers=(1, 1, 2, 2, 2, 1, 1, 1), channels=NARROW, head_features=6)
    if case == "C-bottleneck":
        return tdrn.DRN(layers=(1, 1, 2, 1, 2, 1, 1, 1), channels=NARROW,
                        block=tdrn.Bottleneck, head_features=6)
    return tdrn.DRN(layers=(1, 2, 2, 1, 2, 1, 2, 1), channels=NARROW, arch="D",
                    head_features=None)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", ["C-basic", "C-bottleneck", "D"])
def test_drn_matches_jax(case, train):
    """Narrow trunks, 2 x 3 x 35 x 29 (odd sizes through the three stride-2
    levels). Eval: f32 max-abs 1e-5 against JAX on the running statistics.
    Train: batch statistics; outputs to 1e-4 (each BatchNorm divides by a
    batch standard deviation, scaling the ~1e-7 conv rounding differences)
    and every moved running statistic to 1e-5. C-bottleneck's layer7 is a
    non-residual BasicBlock whose width changes, so its shortcut conv and
    BatchNorm run (and move) without being added, as in JAX."""
    x = np.random.RandomState(1).rand(2, 35, 29, 3).astype(np.float32)
    jm = _jax_drn(case)
    variables = random_variables(lambda: jm.init(KEY, jnp.asarray(x), train=False), 2)
    model = _port_drn(case)
    model.load_state_dict(convert_drn(model, variables), strict=True)
    if train:
        want, mutated = jax.jit(lambda v, a: jm.apply(v, a, train=True,
                                                      mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        model.train()
        got = model(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-4)
        moved = state_dict_from_jax(model, {"batch_stats": mutated["batch_stats"]})
        state = model.state_dict()
        assert moved and all(k.endswith(("running_mean", "running_var")) for k in moved)
        for k, v in moved.items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
        if case == "C-bottleneck":
            k = "layer7.block0.downsample_bn.running_mean"
            assert not np.allclose(state[k].numpy(), np.asarray(
                variables["batch_stats"]["layer7"]["block0"]["downsample_bn"]["bn"]["mean"]))
    else:
        want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
        with torch.no_grad():
            got = model(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


def test_drn_c_42_full_width_matches_jax():
    """drn_c_42(head_features=32) at 64^2, batch 1, eval: stride 8, f32
    max-abs 1e-4 relative to the output's largest entry."""
    x = np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32)
    jm = jdrn.drn_c_42(head_features=32)
    variables = random_variables(lambda: jm.init(KEY, jnp.asarray(x), train=False), 3)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    model = tdrn.drn_c_42(head_features=32)
    model.load_state_dict(convert_drn(model, variables), strict=True)
    with torch.no_grad():
        got = _nhwc(model(_nchw(x)))
    assert got.shape == want.shape == (1, 8, 8, 32)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
