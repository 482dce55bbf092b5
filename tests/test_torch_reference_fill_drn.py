"""Stack A's other encoder and the old-model path against the JAX package:

- ``ReferenceFill(type="drn")`` (two DRN-C-42 trunks, a decoder without its
  latent branch) and ``no_prior`` (decode without z, 218x178 bilinear) at
  the small widths of tests/test_models_stack_a.py, in eval mode;
- ``cli/picnet_inference.main`` in-process with ``--device cpu``, once with
  ``--encoder_type drn`` and once with ``--old_model 1``.

JAX weights are seeded random values in the shapes of ``init``
(``random_variables``), carried across with convert.py; JAX applies are
jitted. Tolerances are stated in each test. tests/test_torch_drn_gan.py
holds the DRN GAN step. The DRN heads' kernels are
scaled by 8 (``_drn_variables``): at the seeded scale the trunks' features
are small, so the example-guided attention's map is nearly uniform, its
outputs nearly constant over each plane (per-plane std down to 8e-4), and
the decoder's first instance norms divide the two sides' ~3e-6 f32
rounding differences by that std (2.4e-4 at the output where the encoders
and the attention agree to 3e-6). Scaled, the map is sharp and the slice
agrees to about 1.5e-5.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.data.synthetic import make_synthetic_celeba
from face_mask_inpaint_tpu.models.reference_fill import ReferenceFill as JReferenceFill
from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli
from face_mask_inpaint_tpu_torch.convert import convert_reference_fill
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from tests.test_torch_models import random_variables

KEY = jax.random.PRNGKey(0)
# the widths of tests/test_models_stack_a.py
ENC = dict(type="pluralistic", ngf=8, z_nc=16, img_f=32, L=1, layers=3,
           norm="none", activation="LeakyReLU", init_type="orthogonal")
DRN_ENC = dict(type="drn", img_f=32, init_type="orthogonal")
DEC = dict(ngf=16, z_nc=16, img_f=64, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="orthogonal")
WIDTHS = ["--encoder_ngf", "8", "--encoder_z_nc", "16", "--encoder_img_f", "32",
          "--encoder_layers", "5",
          "--decoder_ngf", "16", "--decoder_z_nc", "16", "--decoder_img_f", "64",
          "--decoder_layers", "3", "--use_att", "1", "--out_size", "64"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n, h, w, seed):
    rs = np.random.RandomState(seed)
    mask = np.zeros((n, h, w), np.float32)
    mask[:, h // 2:h // 2 + h // 3, w // 4:3 * w // 4] = 1.0
    return (rs.rand(n, h, w, 3).astype(np.float32), rs.rand(n, h, w, 3).astype(np.float32),
            mask)


def _drn_variables(init, seed):
    """``random_variables`` with each DRN head's kernel scaled by 8 (see the
    module docstring); the pluralistic encoders' variables as they are."""
    variables = random_variables(init, seed)
    for name in ("src_encoder", "ref_encoder"):
        fc = variables["params"][name].get("fc")
        if fc is not None:
            fc["kernel"] = fc["kernel"] * 8.0
    return variables


def _port(enc, dec, use_att, out_size, variables):
    model = ReferenceFill(enc, dec, use_att=use_att, out_size=out_size)
    model.load_state_dict(convert_reference_fill(model, variables), strict=True)
    return model


@pytest.mark.parametrize("use_att,dec_img_f", [(True, 64), (False, 32)])
def test_reference_fill_drn_matches_jax(use_att, dec_img_f):
    """DRN encoders at 64^2 (8^2 features), the decoder without z to 64^2,
    pooled to 32^2 (the decoder folds the pool into its head, K3's plain
    version here). The port's decoder has no latent branch, and the
    variables (params, spectral, batch_stats) load strictly. f32 max-abs
    1e-4."""
    src, ref, mask = _inputs(2, 64, 64, 3)
    dec = {**DEC, "img_f": dec_img_f}
    jm = JReferenceFill(encoder_params=DRN_ENC, decoder_params=dec, use_att=use_att,
                        out_size=(32, 32))
    args = tuple(jnp.asarray(a) for a in (src, ref, mask))
    variables = _drn_variables(lambda: jm.init({"params": KEY}, *args, train=False), 7)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(variables, *args)
    model = _port(DRN_ENC, dec, use_att, (32, 32), variables)
    assert not hasattr(model.decoder, "generator")
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (src, ref, mask)))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("enc,use_att,dec_img_f", [(ENC, False, 32), (DRN_ENC, True, 64)],
                         ids=["pluralistic", "drn"])
def test_no_prior_matches_jax(enc, use_att, dec_img_f):
    """no_prior on a ragged 54x46 input (the encoders' floor pooling and
    strides give 13x11 and 7x6 features), initialised without no_prior as
    the JAX CLI does, so the pluralistic decoder keeps its latent branch:
    decode without z, bilinear to 218x178. f32 max-abs 1e-4. The
    pluralistic case fuses by the mask lerp: the example-guided attention
    over its small features (plane std about 0.01) is nearly uniform at
    any seed, and the decoder's instance norms then amplify the two sides'
    f32 rounding a thousandfold (module docstring); the CLI test below runs
    it with the attention."""
    src, ref, mask = _inputs(2, 54, 46, 4)
    dec = {**DEC, "img_f": dec_img_f}
    jm = JReferenceFill(encoder_params=enc, decoder_params=dec, use_att=use_att,
                        out_size=(218, 178))
    args = tuple(jnp.asarray(a) for a in (src, ref, mask))
    variables = _drn_variables(
        lambda: jm.init({"params": KEY, "sample": KEY}, *args, train=False), 8)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, no_prior=True, train=False))(
        variables, *args)
    model = _port(enc, dec, use_att, (218, 178), variables)
    assert hasattr(model.decoder, "generator") == (enc is ENC)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (src, ref, mask)), no_prior=True)
    assert got.shape == (2, 218, 178, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("flags,size", [(["--encoder_type", "drn"], (64, 64)),
                                        (["--old_model", "1"], (218, 178))],
                         ids=["drn", "old_model"])
def test_picnet_inference_cli_new_paths_cpu(tmp_path, monkeypatch, flags, size):
    """The inference CLI in-process on a 64^2 synthetic tree: every image
    written at 64^2 (DRN) or 218x178 (old model), a finite ssim, and a
    finite ms_ssim where the images exceed 160 rows (old model; NaN, an
    empty field, below). Five encoder layers, so the old model's 218x178
    input gives 13x11 features and the decoder's attention 52x44 tokens."""
    from PIL import Image

    tree = make_synthetic_celeba(tmp_path / "celeba", n_identities=2,
                                 images_per_identity=2, size=(64, 64))
    monkeypatch.chdir(tmp_path)
    cli.main(["--device", "cpu", "--data_root", str(tree["root"]), "--mask_detector_path",
              "", "--pt_ckpt_path", str(tmp_path / "run" / "model.pt"), "--batch_size", "2",
              *WIDTHS, *flags])
    out_dir = tmp_path / "test_results" / "run"
    images = sorted(out_dir.glob("gen_*.jpg"))
    assert len(images) == tree["n_images"]
    assert all(Image.open(p).size == (size[1], size[0]) for p in images)
    rows = (out_dir / "metrics.csv").read_text().splitlines()
    s, ms = (float(v) if v else math.nan for v in rows[1].split(","))
    assert math.isfinite(s) and (math.isfinite(ms) if size[0] > 160 else math.isnan(ms))
