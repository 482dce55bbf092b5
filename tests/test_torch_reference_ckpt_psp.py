"""Reference checkpoints of Stack B in the port, held against the JAX package
on the CPU: the GradualStyleEncoder, IR-SE and combined pSp converters of
the port's copy against the JAX ones leaf for leaf; the ArcFace backbone's
forward after loading the same ir_se50 file (f32, 1e-5 of the largest
entry); psp_inference's loaders against the JAX CLI's (the detector
replaced by convert_unet, the pSp merged by key and shape: every tensor
and the merged count the JAX CLI gives, then both forwards); gradio_serve
reading a reference mask detector through the same loader.

The reference files use the JAX tests' torch modules: the GSE's 50-layer
IR-SE trunk with one 512-channel style head (the converter takes the
trunk's 24 units whatever the model's depth), and the g_ema layout of the
small decoder. The models are the small test configuration (num_layers=4,
decoder_base_channels=32, output 32), into which part of the file merges.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.tools import convert_torch as jct
from face_mask_inpaint_tpu_torch import convert
from face_mask_inpaint_tpu_torch.tools import convert_torch as tct

from tests import test_converter_numeric as tcn
from tests.test_torch_reference_ckpt import (
    _merged, _np_sd, assert_rel, assert_tree_equal, g_ema_sd, unet_reference_sd)

SMALL = dict(num_layers=4, decoder_base_channels=32)
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def dense_synthesis(monkeypatch):
    monkeypatch.setenv("FMI_PACKED_SYNTH", "0")


@pytest.fixture(scope="module")
def gse_sd():
    torch.manual_seed(11)
    tm = tcn._TorchGSE(n_styles=1).eval()
    tcn._randomize_bn(tm)
    return _np_sd(tm)


@pytest.fixture(scope="module")
def irse_sd():
    torch.manual_seed(12)
    tm = tcn._TorchIRSE50().eval()
    tcn._randomize_bn(tm)
    return _np_sd(tm)


@pytest.fixture(scope="module")
def psp_sd(gse_sd):
    """A combined pSp state dict: the GSE under encoder., the small
    decoder's g_ema layout under decoder., and latent_avg."""
    from face_mask_inpaint_tpu_torch.models.stylegan2 import Generator

    sd = {f"encoder.{k}": v for k, v in gse_sd.items()}
    dec = g_ema_sd(Generator(SIZE, base_channels=SMALL["decoder_base_channels"]), 13)
    sd.update({f"decoder.{k}": v for k, v in dec.items()})
    n_styles = int(np.log2(SIZE)) * 2 - 2
    sd["latent_avg"] = np.random.RandomState(14).randn(n_styles, 512).astype(np.float32) * 0.1
    return sd


@pytest.mark.parametrize("name", ["gradual_style_encoder", "irse_backbone", "psp"])
def test_converter_copy_matches_jax(name, gse_sd, irse_sd, psp_sd):
    if name == "gradual_style_encoder":
        got, want = (tct.convert_gradual_style_encoder(gse_sd, 8),
                     jct.convert_gradual_style_encoder(gse_sd, 8))
    elif name == "irse_backbone":
        got, want = tct.convert_irse_backbone(irse_sd), jct.convert_irse_backbone(irse_sd)
    else:
        got, want = tct.convert_psp(psp_sd, SIZE), jct.convert_psp(psp_sd, SIZE)
    assert_tree_equal(got, want)


def test_irse_backbone_after_loading_matches_jax(irse_sd, tmp_path):
    """An ir_se50 file through the CLIs' loader into the identity loss's
    Backbone against the JAX Backbone on convert_irse_backbone's variables,
    at 112^2."""
    from face_mask_inpaint_tpu.models.irse import Backbone as JBackbone
    from face_mask_inpaint_tpu_torch.losses.id_loss import make_backbone

    path = tmp_path / "model_ir_se50.pth"
    torch.save({k: torch.from_numpy(v) for k, v in irse_sd.items()}, path)
    net = make_backbone()
    convert.load_checkpoint(net, convert.read_checkpoint(path, "ir_se50"),
                            tct.convert_irse_backbone, "ir_se50", path)
    x = np.random.RandomState(15).rand(1, 112, 112, 3).astype(np.float32)
    variables = jax.tree.map(jnp.asarray, jct.convert_irse_backbone(irse_sd))
    want = jax.jit(lambda v, a: JBackbone(input_size=112, num_layers=50, mode="ir_se").apply(
        v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_rel(got.numpy(), np.asarray(want))


def test_psp_cli_loaders_match_jax_cli(psp_sd, tmp_path, monkeypatch, caplog):
    """psp_inference.py's loaders (PICNet_inference.load_mask_detector_vars,
    which it imports, and load_psp_vars) against the port CLI's
    build_models on the same two files, both sides starting from the JAX
    CLI's own variable skeleton (eval_shape and its fixed fill) carried
    across; then both forwards on the merged variables."""
    import PICNet_inference as jpicnet
    import psp_inference as jcli
    from face_mask_inpaint_tpu.models.psp import PSP as JPSP
    from face_mask_inpaint_tpu.models.unet import MaskDetector as JMaskDetector
    from face_mask_inpaint_tpu_torch.cli import psp_inference as cli
    from face_mask_inpaint_tpu_torch.models import psp as psp_mod

    from tests.test_torch_reference_ckpt import _Init
    from tests.test_torch_stylegan2 import random_variables

    det_sd, _ = unet_reference_sd(3)
    det_path = tmp_path / "mask_detector.pth"
    torch.save({k: torch.from_numpy(v) for k, v in det_sd.items()}, det_path)
    psp_path = tmp_path / "run" / "psp_ffhq_encode.pt"
    psp_path.parent.mkdir()
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in psp_sd.items()},
                "opts": {"output_size": SIZE}}, psp_path)

    args = cli.get_args(["--device", "cpu", "--output_size", str(SIZE), "--use_attention", "1",
                         "--start_from_latent_avg", "--mask_detector_path", str(det_path),
                         "--pt_ckpt_path", str(psp_path)])
    jpsp = JPSP(output_size=SIZE, use_attention=True, start_from_latent_avg=True, **SMALL)
    x0 = jnp.zeros((1, 64, 64, 3))
    init_kwargs = dict(ref=x0, src_mask=jnp.zeros((1, 64, 64)), train=False)
    start = jcli._psp_variables_skeleton(jpsp, (x0,), init_kwargs)
    with caplog.at_level(logging.INFO):
        jdet = jpicnet.load_mask_detector_vars(_Init(lambda: random_variables(
            lambda: JMaskDetector().init(jax.random.PRNGKey(0), x0), 5)), str(det_path), x0)
        jvars = jcli.load_psp_vars(jpsp, args, (x0,), init_kwargs)
        j_merged = _merged(caplog.records, r"^Merged (\d+)/(\d+) tensors from torch ckpt$")
        caplog.clear()
        monkeypatch.setattr(cli, "PSP", lambda **kw: psp_mod.PSP(**kw, **SMALL))
        monkeypatch.setattr(cli, "init_weights", lambda m, g: m.load_state_dict(
            convert.state_dict_from_jax(m, start), strict=True))
        detector, psp = cli.build_models(args, torch.device("cpu"))
        t_merged = _merged(caplog.records, r"^Merged (\d+)/(\d+) converted tensors of pSp")
    assert t_merged == j_merged and j_merged[0] > 40
    for model, jv in ((detector, jdet), (psp, jvars)):
        want = convert.state_dict_from_jax(model, jv)
        got = model.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k

    rs = np.random.RandomState(16)
    src, ref = (rs.rand(2, 2, 64, 64, 3).astype(np.float32) * 2 - 1)
    mask = np.zeros((2, 64, 64), np.float32)
    mask[:, 32:58, 10:54] = 1.0
    want = jax.jit(lambda v, s, r, m: jpsp.apply(v, s, ref=r, src_mask=m, resize=False,
                                                 randomize_noise=False, train=False))(
        jvars, jnp.asarray(src), jnp.asarray(ref), jnp.asarray(mask))
    with torch.no_grad():
        got = psp(torch.from_numpy(src), torch.from_numpy(ref), torch.from_numpy(mask),
                  resize=False, randomize_noise=False)
    assert_rel(got.numpy(), np.asarray(want))


def test_gradio_reads_a_reference_mask_detector(tmp_path, monkeypatch):
    """gradio_serve builds its models through psp_inference.build_models, so
    its default --mask_detector_path loads once the file exists: the
    detector holds convert_unet's tensors."""
    from face_mask_inpaint_tpu_torch.cli import gradio_serve
    from face_mask_inpaint_tpu_torch.cli import psp_inference as cli
    from face_mask_inpaint_tpu_torch.models import psp as psp_mod

    det_sd, _ = unet_reference_sd(4)
    (tmp_path / "saved_model").mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in det_sd.items()},
               tmp_path / "saved_model" / "new_mask_detector.pth")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "PSP", lambda **kw: psp_mod.PSP(**kw, **SMALL))
    args = gradio_serve.get_args(["--device", "cpu", "--output_size", str(SIZE)])
    model = gradio_serve.ModelInterface(args, torch.device("cpu"))
    want = convert.state_dict_from_jax(model.mask_detector, tct.convert_unet(det_sd))
    for k, v in model.mask_detector.state_dict().items():
        assert torch.equal(v, want[k]), k
