"""Port layers (face_mask_inpaint_tpu_torch.nn.layers) against the flax layers.

JAX weights come from ``init`` (then perturbed where init would make the test
trivial) and are carried across with convert.py. Tolerance: f32 max-abs 1e-5
for outputs and for the spectral-norm u/v after a training call.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.nn import layers as jl
from face_mask_inpaint_tpu.ops.pallas import norm_act as jna
from face_mask_inpaint_tpu_torch.convert import state_dict_from_jax
from face_mask_inpaint_tpu_torch.nn import layers as tl

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


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _perturb(tree, seed):
    """Replace every leaf by random values of its shape (init's ones/zeros
    would hide a swapped scale/bias or a dropped bias)."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)), tree)


def _load(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_jax(module, variables), strict=True)
    return module


SPECTRAL_CASES = {
    "conv3x3": (jl.Conv2d(6, 3, padding=1, use_spect=True),
                lambda: tl.Conv2d(5, 6, 3, padding=1, use_spect=True)),
    "conv1x1": (jl.Conv2d(7, 1, use_spect=True),
                lambda: tl.Conv2d(5, 7, 1, use_spect=True)),
    "convT": (jl.ConvTranspose2d(6, 3, stride=2, padding=1, output_padding=1,
                                 use_spect=True),
              lambda: tl.ConvTranspose2d(5, 6, 3, 2, 1, 1, use_spect=True)),
}


@pytest.mark.parametrize("name", sorted(SPECTRAL_CASES))
def test_spectral_norm_eval_and_train_match_jax(name):
    jmod, make = SPECTRAL_CASES[name]
    x = np.random.RandomState(3).randn(2, 7, 6, 5).astype(np.float32)
    variables = jmod.init(KEY, jnp.asarray(x))
    variables = {**variables, "params": _perturb(variables["params"], 4)}
    tmod = _load(make(), variables)

    tmod.eval()
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tmod.u.numpy(), np.asarray(variables["spectral"]["u"]))

    tmod.train()
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    want, updated = jmod.apply(variables, jnp.asarray(x), mutable=["spectral"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(tmod, k).numpy(),
                                   np.asarray(updated["spectral"][k]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl", ["pallas", "reference"])
@pytest.mark.parametrize("fuse_act", ["LeakyReLU", "ReLU", None])
def test_instance_norm_matches_jax(monkeypatch, impl, fuse_act):
    """InstanceNorm2d(fuse_act) against flax InstanceNorm2d under both JAX
    implementations (the slice's configuration is set_impl('pallas'), run in
    interpret mode on the CPU)."""
    monkeypatch.setattr(jna, "_IMPL", impl)
    x = (np.random.RandomState(5).randn(2, 9, 7, 6) * 3 + 1).astype(np.float32)
    jmod = jl.InstanceNorm2d(fuse_act=fuse_act)
    variables = jmod.init(KEY, jnp.asarray(x))
    variables = {"params": _perturb(variables["params"], 6)}
    tmod = _load(tl.InstanceNorm2d(6, fuse_act=fuse_act), variables)
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=ATOL)


def test_batch_norm_eval_matches_jax():
    x = np.random.RandomState(7).randn(2, 5, 4, 6).astype(np.float32)
    jmod = jl.BatchNorm2d(use_running_average=True)
    variables = jmod.init(KEY, jnp.asarray(x))
    rs = np.random.RandomState(8)
    stats = {"bn": {"mean": jnp.asarray(rs.randn(6).astype(np.float32)),
                    "var": jnp.asarray(rs.rand(6).astype(np.float32) + 0.5)}}
    variables = {"params": _perturb(variables["params"], 9), "batch_stats": stats}
    tmod = _load(tl.BatchNorm2d(6), variables).eval()
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    # eval mode reads the running statistics and leaves them as they were
    np.testing.assert_array_equal(tmod.running_mean.numpy(), np.asarray(stats["bn"]["mean"]))
    np.testing.assert_array_equal(tmod.running_var.numpy(), np.asarray(stats["bn"]["var"]))


@pytest.mark.parametrize("kind", ["ReLU", "SELU", "LeakyReLU"])
def test_activations_match_jax(kind):
    x = np.random.RandomState(10).randn(3, 4, 5, 2).astype(np.float32)
    want = np.asarray(jl.get_activation(kind)(jnp.asarray(x)))
    for fn in (tl.Activation(kind), tl.get_activation(kind)):
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("init_type", ["orthogonal", "normal", "xavier", "kaiming",
                                       "lecun_normal"])
def test_initializers_are_seeded(init_type):
    """Two generators with one seed give one weight; gain 0.02 for orthogonal
    gives rows of norm 0.02."""
    def make(seed):
        conv = tl.Conv2d(16, 8, 3, use_spect=True, init_type=init_type)
        return tl.init_weights(conv, torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.u, b.u)
    assert not torch.equal(a.weight, c.weight)
    if init_type == "orthogonal":
        norms = a.weight.flatten(1).norm(dim=1)
        np.testing.assert_allclose(norms.detach().numpy(), 0.02, rtol=1e-5)
