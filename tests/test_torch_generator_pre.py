"""Two holds of Stack A's generator against the JAX package, on seeded
variables (``random_variables``) carried across with convert.py; JAX
applies are jitted.

- ``ResGenerator`` with ``f_e`` and ``mask`` (JAX picnet.py:187-188,
  :289-292): the attention after decoder 1 runs its long-term ``pre`` branch
  (AutoAttention's second value set, the masked context flow and its
  ResBlock), in eval and in training mode (the decoders' instance norms and
  the spectral norms' write-back), at the tolerance of
  tests/test_torch_blocks_coord.py's generator test (f32 max-abs 1e-4).
- The DRN slice of tests/test_torch_reference_fill_drn.py at its seeded
  scale, without that test's x8 on the DRN heads, in float64 on both sides
  (the JAX side inside the ``jax.enable_x64(True)`` context, this JAX's
  form of ``jax.experimental.enable_x64()``, so no other test of the worker
  changes) at that test's f32 tolerance, 1e-4: in f64 the
  near-uniform attention's planes no longer amplify the two sides'
  rounding past it. Both packages accumulate in f32 whatever the input
  dtype at the spectral norms' power iteration, the instance norms' moments,
  the attention's map and the resizes (JAX nn/layers.py:150, :160, :492,
  ops/attention.py:81-122, ops/pallas/norm_act.py:47, ops/resize.py:108);
  the port keeps an f64 input in f64 there, and the test hands those JAX
  modules a ``jnp`` whose float32 is float64 for the run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import picnet as jp
from face_mask_inpaint_tpu.models.reference_fill import ReferenceFill as JReferenceFill
from face_mask_inpaint_tpu_torch.convert import convert_reference_fill, state_dict_from_jax
from face_mask_inpaint_tpu_torch.models import picnet as tp
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from tests.test_torch_models import random_variables

KEY = jax.random.PRNGKey(0)
DEC = dict(ngf=16, z_nc=16, img_f=64, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="orthogonal")
DRN_ENC = dict(type="drn", img_f=32, init_type="orthogonal")


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


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_res_generator_f_e_and_mask_match_jax(train):
    """ResGenerator (three decoders, the attention after decoder 1 at 32^2)
    from 8^2 features with z, f_e [2, 32^2, 24] and a rectangular mask at
    the attention's size; gamma and alpha random. In training mode the
    spectral u/v written back match too (1e-5). f32 max-abs 1e-4."""
    rs = np.random.RandomState(12)
    encoded = rs.randn(2, 8, 8, 64).astype(np.float32)
    z = rs.randn(2, 8, 8, 32).astype(np.float32)
    f_e = rs.randn(2, 32, 32, 24).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[:, 9:25, 6:22] = 1.0
    jgen = jp.define_g(**DEC)
    args = tuple(jnp.asarray(a) for a in (encoded, z, f_e, mask))
    variables = random_variables(
        lambda: jgen.init(KEY, args[0], z=args[1], f_e=args[2], mask=args[3], train=False), 13)
    assert "model" in variables["params"]["attn1"]

    def apply(v, e, zz, fe, m):
        out, mut = jgen.apply(v, e, z=zz, f_e=fe, mask=m, train=train, mutable=["spectral"])
        return out, mut["spectral"]

    want, spectral = jax.jit(apply)(variables, *args)
    tgen = tp.define_g(**DEC, input_nc=64, z_channels=32, attn_pre_channels=24)
    tgen.load_state_dict(state_dict_from_jax(tgen, variables), strict=True)
    tgen.train(train)
    with torch.no_grad():
        got = tgen(_nchw(encoded), z=_nchw(z), f_e=_nchw(f_e), mask=_nchw(mask))
    assert got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-4)
    if train:
        sd = tgen.state_dict()
        for k, w in state_dict_from_jax(tgen, {"spectral": spectral}).items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="pre"):
        tgen(_nchw(encoded), z=_nchw(z))


class _F64Numpy:
    """``jax.numpy`` with float32 read as float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.mark.parametrize("use_att,dec_img_f", [(True, 64), (False, 32)])
def test_reference_fill_drn_unscaled_f64_matches_jax(monkeypatch, use_att, dec_img_f):
    """The slice of test_reference_fill_drn_matches_jax with the seeded DRN
    heads as they are, both sides in float64, compared at the decoder's full
    64^2 (``resize=False``: K3's pooled pair head takes f32 and bf16 only):
    max-abs 1e-4, and 1e-9 too: in f64 nothing is left to amplify."""
    rs = np.random.RandomState(3)
    mask = np.zeros((2, 64, 64), np.float64)
    mask[:, 32:53, 16:48] = 1.0
    src, ref = rs.rand(2, 64, 64, 3), rs.rand(2, 64, 64, 3)
    dec = {**DEC, "img_f": dec_img_f}
    from face_mask_inpaint_tpu.nn import blocks as jblocks
    from face_mask_inpaint_tpu.nn import layers as jlayers
    from face_mask_inpaint_tpu.ops import attention as jattention
    from face_mask_inpaint_tpu.ops import resize as jresize
    from face_mask_inpaint_tpu.ops.pallas import norm_act as jnorm_act

    for mod in (jblocks, jlayers, jattention, jresize, jnorm_act):
        monkeypatch.setattr(mod, "jnp", _F64Numpy())
    with jax.enable_x64(True):
        jm = JReferenceFill(encoder_params=DRN_ENC, decoder_params=dec, use_att=use_att,
                            out_size=(32, 32), dtype=jnp.float64)
        args = tuple(jnp.asarray(a) for a in (src, ref, mask))
        variables = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), random_variables(
            lambda: jm.init({"params": KEY}, *args, train=False), 7))
        want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, resize=False, train=False))(
            variables, *args))
        sd = convert_reference_fill(
            ReferenceFill(DRN_ENC, dec, use_att=use_att, out_size=(32, 32)).double(),
            jax.tree.map(np.asarray, variables))
    assert want.dtype == np.float64
    model = ReferenceFill(DRN_ENC, dec, use_att=use_att, out_size=(32, 32),
                          dtype=torch.float64).double()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (src, ref, mask)), resize=False)
    assert got.dtype == torch.float64 and got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert np.abs(got.numpy() - want).max() <= 1e-9  # f64 rounding, no amplified f32
