"""convert.py: JAX variables load into the port with strict=True at the
flagship widths (bench.py:_flagship_models). Shapes come from
``jax.eval_shape`` of ``init``, so nothing large is computed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models.reference_fill import ReferenceFill as JReferenceFill
from face_mask_inpaint_tpu.models.unet import MaskDetector as JMaskDetector
from face_mask_inpaint_tpu_torch.convert import (
    convert_mask_detector, convert_reference_fill, state_dict_from_jax)
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.nn.layers import Conv2d, ConvTranspose2d

KEY = jax.random.PRNGKey(0)
FLAGSHIP_ENC = dict(type="pluralistic", ngf=32, z_nc=128, img_f=128, L=6, layers=5,
                    norm="none", activation="LeakyReLU", init_type="orthogonal")
FLAGSHIP_DEC = dict(ngf=32, z_nc=128, img_f=256, L=0, layers=5, norm="instance",
                    activation="LeakyReLU", init_type="orthogonal")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _indexed(shapes):
    """Each leaf filled with its own running index, so a misplaced or
    wrongly transposed tensor shows up as a value mismatch."""
    counter = iter(range(10 ** 9))
    return jax.tree.map(
        lambda s: (np.arange(int(np.prod(s.shape)), dtype=np.float32) + 7 * next(counter))
        .reshape(s.shape), shapes)


def _flagship_variables(hw=64):
    x = jnp.zeros((1, hw, hw, 3))
    m = jnp.zeros((1, hw, hw))
    model = JReferenceFill(encoder_params=FLAGSHIP_ENC, decoder_params=FLAGSHIP_DEC,
                           use_att=True, out_size=(256, 256))
    return jax.eval_shape(
        lambda: model.init({"params": KEY, "sample": KEY}, x, x, m, train=False))


def test_reference_fill_flagship_loads_strict():
    shapes = _flagship_variables()
    model = ReferenceFill(FLAGSHIP_ENC, FLAGSHIP_DEC, use_att=True, out_size=(256, 256))
    sd = convert_reference_fill(model, jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(model.state_dict())
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_jax == sum(t.numel() for t in model.state_dict().values())


def test_mask_detector_loads_strict():
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: JMaskDetector().init(KEY, x))
    model = MaskDetector()
    result = model.load_state_dict(
        convert_mask_detector(model, jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes)), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert any(k.endswith("bn1.running_var") for k in model.state_dict())


@pytest.fixture(scope="module")
def indexed_flagship():
    variables = _indexed(_flagship_variables())
    model = ReferenceFill(FLAGSHIP_ENC, FLAGSHIP_DEC, use_att=True)
    return variables, model, state_dict_from_jax(model, variables)


@pytest.mark.parametrize("path,layout", [
    (("decoder", "decoder0", "conv2"), "IOHW"),     # ResBlockDecoder convT
    (("decoder", "decoder0", "conv1"), "OIHW"),     # ResBlockDecoder conv
    (("src_encoder", "block0", "conv1", "conv"), "OIHW"),
])
def test_kernel_layouts(indexed_flagship, path, layout):
    """HWIO kernels land transposed to OIHW (conv) or IOHW (convT)."""
    variables, model, sd = indexed_flagship
    kernel = variables["params"]
    for p in path:
        kernel = kernel[p]
    kernel = kernel["kernel"]
    module = model.get_submodule(".".join(path))
    got = sd[".".join(path) + ".weight"].numpy()
    perm = (2, 3, 0, 1) if layout == "IOHW" else (3, 2, 0, 1)
    assert isinstance(module, ConvTranspose2d if layout == "IOHW" else Conv2d)
    np.testing.assert_array_equal(got, kernel.transpose(perm))


def test_unknown_leaf_raises():
    model = MaskDetector()
    with pytest.raises(KeyError):
        state_dict_from_jax(model, {"params": {"model": {"outc": {"weird": np.zeros(2)}}}})


def test_port_state_dict_round_trips_through_torch_save(tmp_path):
    """The CLI's checkpoint format: a .pt of the port's own state_dict."""
    model = MaskDetector(generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), tmp_path / "md.pt")
    other = MaskDetector(generator=torch.Generator().manual_seed(4))
    other.load_state_dict(torch.load(tmp_path / "md.pt"), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k])
