"""Reference checkpoints in the port (tools/convert_torch.py, convert.py's
loader and the CLIs that call it), held against the JAX package on the CPU.

- Every converter of the port's copy returns the JAX converter's tree leaf
  for leaf (``np.array_equal``, dtypes equal) on the same reference-layout
  state dict. The state dicts come from the JAX tests' own torch modules
  at their widths (tests/test_converter.py, test_converter_numeric.py,
  test_converter_picnet.py); the StyleGAN2 one is written from the port's
  generator through the g_ema key table below.
- After loading the same file, the port's forward agrees with the JAX one,
  f32, to 1e-5 of the largest entry: the UNet, PICNet's encoder,
  generator and discriminator (spectral u/v as converted), the StyleGAN2
  generator with its noise buffers.
- The picnet_inference loaders, started on both sides from the same JAX
  weights carried across, give every tensor the JAX CLI gives it: the
  detector replaced whole, the generator's parameters merged by key and
  shape (the model's own spectral u/v kept), with the JAX CLI's merged
  count.
- The port's own .pt still loads strictly; a garbage file, a file without a
  state dict and a directory raise before anything is built.

The pSp, IR-SE and FID cases are in test_torch_reference_ckpt_psp.py and
test_torch_fid.py.
"""

import logging
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.tools import convert_torch as jct
from face_mask_inpaint_tpu_torch import convert
from face_mask_inpaint_tpu_torch.tools import convert_torch as tct

from tests import test_converter as tc
from tests import test_converter_numeric as tcn
from tests import test_converter_picnet as tcp
from tests.test_torch_stylegan2 import random_variables

KEY = jax.random.PRNGKey(0)
FWD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_sd(module, prefix=""):
    return {prefix + k: v.detach().numpy().copy() for k, v in module.state_dict().items()
            if "num_batches" not in k}


def assert_tree_equal(got, want, path="/"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}{k}/")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}{i}/")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want), path


def assert_rel(got, want, tol=FWD_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# -- reference-layout state dicts -------------------------------------------

def unet_reference_sd(seed=0):
    """A reference MaskDetector state dict ('model.'-prefixed UNet) from the
    JAX test's torch UNet, BatchNorm statistics and affines randomized."""
    torch.manual_seed(seed)
    tm = tc._TorchUNet().eval()
    tcn._randomize_bn(tm)
    return _np_sd(tm, "model."), tm


_G_EMA = [(r"^style_(\d+)\.", r"style.\1."), (r"^convs_(\d+)\.", r"convs.\1."),
          (r"^to_rgbs_(\d+)\.", r"to_rgbs.\1."), (r"\.activate_bias$", ".activate.bias"),
          (r"^noise_(\d+)$", r"noises.noise_\1"), (r"^input$", "input.input")]


def g_ema_sd(generator, seed=0):
    """The rosinality g_ema layout of the port ``generator``'s state dict,
    filled from ``seed``: modulated weights [1, out, in, k, k], ToRGB
    biases [1, 3, 1, 1], noise weights non-zero."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in generator.state_dict().items():
        name = k
        for pat, rep in _G_EMA:
            name = re.sub(pat, rep, name)
        shape = tuple(v.shape)
        x = rs.randn(*shape).astype(np.float32)
        if k.endswith("modulation.bias"):
            x = 1.0 + 0.1 * x
        elif k.endswith(("activate_bias", "bias")):
            x = 0.1 * x
        elif k.endswith("noise.weight"):
            x = 0.5 * np.abs(x)
        if k.endswith("conv.weight"):
            x = x[None]
        if re.search(r"to_rgbs?(_\d+|1)\.bias$", k):
            x = x.reshape(1, 3, 1, 1)
        out[name] = x
    return out


def picnet_reference_sds():
    """latest_net_{E,G,D} layouts of the JAX test's spectral-norm torch
    modules, with their power iterations converged."""
    torch.manual_seed(0)
    e = tcp._TResEncoder()
    x = torch.randn(2, 3, 32, 32)
    tcp._converge(e, lambda m: m(x))
    torch.manual_seed(1)
    g = tcp._TResGenerator()
    feat, z = torch.randn(2, 16, 4, 4), torch.randn(2, 16, 4, 4)
    tcp._converge(g, lambda m: m(feat, z))
    torch.manual_seed(2)
    d = tcp._TResDiscriminator()
    xd = torch.randn(2, 3, 64, 64)
    tcp._converge(d, lambda m: m(xd))
    return {"E": (_np_sd(e), x), "G": (_np_sd(g), (feat, z)), "D": (_np_sd(d), xd)}


@pytest.fixture(scope="module")
def picnet_sds():
    return picnet_reference_sds()


def _lin_sd(n, chans, seed):
    rs = np.random.RandomState(seed)
    return {f"{i}.1.weight": np.abs(rs.randn(1, c, 1, 1)).astype(np.float32)
            for i, c in zip(range(n), chans)}


# -- 1. the converter copies ---------------------------------------------------

def _case(name, picnet_sds):
    """(port result, JAX result) of one converter on one state dict."""
    if name == "unet":
        sd, _ = unet_reference_sd()
        return tct.convert_unet(sd), jct.convert_unet(sd)
    if name in ("vgg16_features", "vgg16_split_features"):
        torch.manual_seed(3)
        sd = _np_sd(tcn._torch_vgg16_features(), "features.")
        fn = f"convert_{name}"
        return getattr(tct, fn)(sd), getattr(jct, fn)(sd)
    if name == "lpips_alex":
        torch.manual_seed(4)
        sd = _np_sd(tcn._torch_alex_features(), "features.")
        lin = _lin_sd(5, (64, 192, 384, 256, 256), 4)
        return tct.convert_lpips_alex(sd, lin), jct.convert_lpips_alex(sd, lin)
    if name.startswith("lpips_"):
        net = name.split("_")[1]
        torch.manual_seed(5)
        trunk = {"vgg": lambda: tcn._torch_vgg16_features(),
                 "squeeze": tcn._torch_squeeze_features}[net]()
        sd = _np_sd(trunk, "features.")
        chans = {"vgg": (64, 128, 256, 512, 512),
                 "squeeze": (64, 128, 256, 384, 384, 512, 512)}[net]
        lin = {f"{i}.weight": np.ones((1, c, 1, 1), np.float32) * (i + 1)
               for i, c in enumerate(chans)}
        return tct.convert_lpips(sd, lin, net), jct.convert_lpips(sd, lin, net)
    if name == "picnet":
        sds = {k: v[0] for k, v in picnet_sds.items()}
        return ({k: tct.convert_picnet_module(v) for k, v in sds.items()},
                {k: jct.convert_picnet_module(v) for k, v in sds.items()})
    if name == "inception_v3":
        torch.manual_seed(6)
        tm = tcn._TorchInception()
        tcn._randomize_bn(tm)
        sd = dict(_np_sd(tm), **{"fc.weight": np.zeros((2, 2048), np.float32)})
        return tct.convert_inception_v3(sd), jct.convert_inception_v3(sd)
    if name == "stylegan2_generator":
        from face_mask_inpaint_tpu_torch.models.stylegan2 import Generator

        sd = g_ema_sd(Generator(32, base_channels=32), 7)
        return (tct.convert_stylegan2_generator(sd, 32),
                jct.convert_stylegan2_generator(sd, 32))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["unet", "vgg16_features", "vgg16_split_features",
                                  "lpips_alex", "lpips_vgg", "lpips_squeeze", "picnet",
                                  "inception_v3", "stylegan2_generator"])
def test_converter_copy_matches_jax(name, picnet_sds):
    got, want = _case(name, picnet_sds)
    assert_tree_equal(got, want)


def test_converter_copy_primitives_match_jax():
    """strip_module_prefix, the layout helpers and sn_conv's fixed-seed power
    iteration (a u on the wrong axis)."""
    rs = np.random.RandomState(8)
    sd = {"module.a.module.weight_bar": rs.randn(6, 4, 3, 3).astype(np.float32),
          "module.a.module.weight_u": rs.randn(4).astype(np.float32),
          "module.a.module.bias": rs.randn(6).astype(np.float32)}
    assert list(tct.strip_module_prefix(sd)) == list(jct.strip_module_prefix(sd))
    s = tct.strip_module_prefix(sd)
    assert_tree_equal(tct.sn_conv(s, "a"), jct.sn_conv(s, "a"))
    w = rs.randn(8, 3 * 2 * 2).astype(np.float32)
    assert np.array_equal(tct.linear_w_after_flatten(w, 3, 2, 2),
                          jct.linear_w_after_flatten(w, 3, 2, 2))
    assert_tree_equal(tct.get_keys({"state_dict": {"encoder.x": w}}, "encoder"),
                      jct.get_keys({"state_dict": {"encoder.x": w}}, "encoder"))


# -- 2. forwards after loading the same file --------------------------------

def test_unet_forward_after_loading_matches_jax(tmp_path):
    """The reference mask_detector file through the CLIs' loader: the port's
    logits against the JAX MaskDetector's on convert_unet's variables."""
    from face_mask_inpaint_tpu.models.unet import MaskDetector as JMaskDetector
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

    sd, _ = unet_reference_sd(1)
    path = tmp_path / "mask_detector.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    det = MaskDetector()
    kind = convert.load_checkpoint(det, convert.read_checkpoint(path, "mask detector"),
                                   tct.convert_unet, "mask detector", path)
    assert kind == "reference"
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    want = jax.jit(lambda v, a: JMaskDetector().apply(v, a, mode="train", train=False))(
        jax.tree.map(jnp.asarray, jct.convert_unet(sd)), jnp.asarray(x))
    with torch.no_grad():
        got = det(torch.from_numpy(x))
    assert_rel(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["E", "G", "D"])
def test_picnet_modules_after_loading_match_jax(picnet_sds, which):
    """latest_net_{E,G,D} through the port's converter copy and convert.py
    into the port's define_e/g/d modules (spectral u/v as converted), against
    the JAX modules on the JAX converter's variables."""
    from face_mask_inpaint_tpu.models import picnet as jp
    from face_mask_inpaint_tpu_torch.models import picnet as tp

    sd, inputs = picnet_sds[which]
    variables = jax.tree.map(jnp.asarray, jct.convert_picnet_module(sd))
    if which == "E":
        kw = dict(ngf=8, z_nc=8, img_f=16, L=1, layers=3, norm="none",
                  activation="LeakyReLU", init_type="normal")
        jmod, tmod = jp.define_e(**kw, encoder_type="src"), tp.define_e(**kw,
                                                                         encoder_type="src")
        x = inputs.numpy().transpose(0, 2, 3, 1)
        (mu, std), feat = jmod.apply(variables, jnp.asarray(x), train=False)
        want = [mu, std, feat]
    elif which == "G":
        kw = dict(ngf=8, z_nc=8, img_f=16, L=1, layers=3, norm="instance",
                  activation="LeakyReLU", init_type="normal")
        jmod, tmod = jp.define_g(**kw), tp.define_g(input_nc=16, z_channels=16, **kw)
        feat, z = (a.numpy().transpose(0, 2, 3, 1) for a in inputs)
        want = [jmod.apply(variables, jnp.asarray(feat), z=jnp.asarray(z), train=False)]
    else:
        kw = dict(ndf=8, img_f=16, layers=4, init_type="normal")
        jmod, tmod = jp.define_d(**kw), tp.define_d(**kw)
        x = inputs.numpy().transpose(0, 2, 3, 1)
        want = [jmod.apply(variables, jnp.asarray(x), train=False)]
    tmod.load_state_dict(convert.state_dict_from_jax(tmod, tct.convert_picnet_module(sd)),
                         strict=True)
    tmod.eval()
    with torch.no_grad():
        if which == "E":
            (tmu, tstd), tfeat = tmod(inputs)
            got = [tmu, tstd, tfeat]
        elif which == "G":
            got = [tmod(*inputs)]
        else:
            got = [tmod(inputs)]
    for g, w in zip(got, want):
        assert_rel(g.numpy().transpose(0, 2, 3, 1), np.asarray(w))


def test_stylegan2_generator_after_loading_matches_jax(tmp_path):
    """A g_ema file (size 32, base 32 channels) through the CLIs' loader into
    the port's Generator (noise buffers included) against the JAX
    Generator, w+ codes, the fixed noise."""
    from face_mask_inpaint_tpu.models.stylegan2 import Generator as JGenerator
    from face_mask_inpaint_tpu_torch.models.stylegan2 import Generator

    tgen = Generator(32, base_channels=32)
    sd = g_ema_sd(tgen, 9)
    path = tmp_path / "g_ema.pt"
    torch.save({"g_ema": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    convert.load_checkpoint(tgen, convert.read_checkpoint(path, "StyleGAN2"),
                            lambda s: tct.convert_stylegan2_generator(
                                {k[len("g_ema."):]: v for k, v in s.items()}, 32),
                            "StyleGAN2", path)
    tgen.eval()
    jgen = JGenerator(size=32, base_channels=32)
    variables = jax.tree.map(jnp.asarray, jct.convert_stylegan2_generator(sd, 32))
    styles = np.random.RandomState(10).randn(2, jgen.n_latent, 512).astype(np.float32)
    want, _ = jax.jit(lambda v, s: jgen.apply(v, [s], randomize_noise=False,
                                              input_is_latent=True))(variables,
                                                                     jnp.asarray(styles))
    with torch.no_grad():
        got, _ = tgen([torch.from_numpy(styles)], randomize_noise=False, input_is_latent=True)
    assert_rel(got.numpy().transpose(0, 2, 3, 1), np.asarray(want))


# -- 3. the PICNet CLI's loaders against the JAX CLI's ---------------------

SMALL_ENC = ["--encoder_ngf", "8", "--encoder_z_nc", "8", "--encoder_img_f", "16",
             "--encoder_layers", "3", "--encoder_init_type", "normal"]
SMALL_DEC = ["--decoder_ngf", "8", "--decoder_z_nc", "8", "--decoder_img_f", "16",
             "--decoder_L", "1", "--decoder_layers", "3", "--decoder_init_type", "normal"]


class _Init:
    """Stands in for a flax module in the JAX CLI functions, which only call
    its ``init``: returns ``variables()``."""

    def __init__(self, variables):
        self.init = lambda *a, **k: variables()


def _merged(records, pattern):
    for r in records:
        m = re.search(pattern, r.getMessage())
        if m:
            return int(m.group(1)), int(m.group(2))
    raise AssertionError(f"no log line matches {pattern}")


def test_picnet_cli_loaders_match_jax_cli(tmp_path, picnet_sds, caplog):
    """PICNet_inference.py's load_mask_detector_vars and load_generator_vars
    against the port CLI's build_models on the same two files. The
    generator file holds the JAX test's encoder and generator under the
    ReferenceFill paths (src_encoder., decoder.) at the CLI's small widths
    (no attention), so most of its tensors match. Both sides start from the
    JAX CLI's own init (PRNGKey 0) carried across."""
    import PICNet_inference as jcli
    from face_mask_inpaint_tpu.models.reference_fill import ReferenceFill as JRF
    from face_mask_inpaint_tpu.models.unet import MaskDetector as JMaskDetector
    from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli

    det_sd, _ = unet_reference_sd(2)
    det_path = tmp_path / "mask_detector.pth"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in det_sd.items()}}, det_path)
    gen_sd = {f"src_encoder.{k}": v for k, v in picnet_sds["E"][0].items()}
    gen_sd.update({f"decoder.{k}": v for k, v in picnet_sds["G"][0].items()})
    gen_path = tmp_path / "run" / "latest_net_G.pt"
    gen_path.parent.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in gen_sd.items()}, gen_path)

    args = cli.get_args(["--data_root", str(tmp_path), "--use_att", "0", "--out_size", "16",
                         "--mask_detector_path", str(det_path),
                         "--pt_ckpt_path", str(gen_path), *SMALL_ENC, *SMALL_DEC])
    enc, dec = cli.process_params(args)
    jgen = JRF(encoder_params=enc, decoder_params=dec, use_att=False, out_size=(16, 16))
    x0 = jnp.zeros((1, 32, 32, 3))
    init_args = (x0, x0, jnp.zeros((1, 32, 32)))
    # the JAX CLI's functions start from model.init (a minute of XLA
    # compile here); they get the same tree from jax.eval_shape and a seeded
    # fill instead, the port the same values carried across
    start = random_variables(lambda: jgen.init({"params": KEY, "sample": KEY}, *init_args), 4)
    with caplog.at_level(logging.INFO):
        jdet = jcli.load_mask_detector_vars(_Init(lambda: random_variables(
            lambda: JMaskDetector().init(KEY, x0), 5)), str(det_path), x0)
        jvars = jcli.load_generator_vars(_Init(lambda: start), str(gen_path), init_args)
        j_merged = _merged(caplog.records, r"^Merged (\d+)/(\d+) converted tensors$")
        caplog.clear()
        orig = cli.ReferenceFill

        def from_jax_init(*a, **k):  # the port starts from the JAX CLI's init
            model = orig(*a, **k)
            model.load_state_dict(convert.state_dict_from_jax(model, start), strict=True)
            return model

        cli.ReferenceFill = from_jax_init
        try:
            detector, generator = cli.build_models(args, torch.device("cpu"))
        finally:
            cli.ReferenceFill = orig
        t_merged = _merged(caplog.records, r"^Merged (\d+)/(\d+) converted tensors of generator")
    assert t_merged == j_merged and j_merged[0] > 20
    for model, jv in ((detector, jdet), (generator, jvars)):
        want = convert.state_dict_from_jax(model, jv)
        got = model.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # the generator kept its own spectral u/v (the JAX CLI drops the file's)
    uv = [k for k in generator.state_dict() if k.startswith("decoder.") and k[-2:] in (".u", ".v")]
    started = convert.state_dict_from_jax(generator, start)
    assert uv and all(torch.equal(generator.state_dict()[k], started[k]) for k in uv)


def test_own_pt_loads_strictly_and_other_files_raise(tmp_path):
    """The port's own state dict loads strictly whatever its suffix; a
    garbage file, a pickle without tensors and a directory raise in
    build_models before any model is built."""
    from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

    seeded = MaskDetector(generator=torch.Generator().manual_seed(3))
    own = tmp_path / "detector.pth"
    torch.save(seeded.state_dict(), own)
    det = MaskDetector()
    assert convert.load_checkpoint(det, convert.read_checkpoint(own, "d"), tct.convert_unet,
                                   "d", own) == "port"
    for k, v in seeded.state_dict().items():
        assert torch.equal(det.state_dict()[k], v), k

    garbage = tmp_path / "garbage.pth"
    garbage.write_bytes(b"not a checkpoint")
    empty = tmp_path / "empty.pt"
    torch.save({"opts": {"lr": 1.0}}, empty)
    base = ["--data_root", str(tmp_path), "--use_att", "0", *SMALL_ENC, *SMALL_DEC]
    for path, exc, msg in ((garbage, ValueError, "is not a PyTorch checkpoint"),
                           (empty, ValueError, "holds no state dict"),
                           (tmp_path, NotImplementedError, "queue 1, item 3c")):
        args = cli.get_args([*base, "--mask_detector_path", str(path)])
        with pytest.raises(exc, match=msg) as info:
            cli.build_models(args, torch.device("cpu"))
        assert str(path) in str(info.value)
    wrong = tmp_path / "vgg.pth"
    torch.save({"features.0.weight": torch.zeros(2, 3, 3, 3)}, wrong)
    args = cli.get_args([*base, "--mask_detector_path", str(wrong)])
    with pytest.raises(ValueError, match="neither the port's state dict nor a reference"):
        cli.build_models(args, torch.device("cpu"))
