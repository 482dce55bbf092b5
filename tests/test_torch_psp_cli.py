"""The port's Stack B CLIs, run in-process on the CPU: psp_inference over a
synthetic 1024^2 CelebA-HQ-like tree (the data are scaled by 0.25 and the
output pooled to 256^2, so the ground truth matches the output's size, as in
tests/test_cli.py::test_psp_inference_cli), gradio_serve's selftest, and the
checkpoint rules (a missing path warns and uses random weights, a file that
is no checkpoint raises before anything is built, the port's own .pt loads
strictly)."""

import logging
import math

import pytest
import torch

from face_mask_inpaint_tpu.data.synthetic import make_synthetic_celeba
from face_mask_inpaint_tpu_torch.cli import gradio_serve
from face_mask_inpaint_tpu_torch.cli import psp_inference as cli


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_celeba(tmp_path_factory.mktemp("torch_psp_celeba"), n_identities=2,
                                 images_per_identity=2, size=(1024, 1024))


def _flags(tree, ckpt):
    return ["--device", "cpu", "--data_root", str(tree["root"]),
            "--src_img_path", "img_align_celeba_masked1", "--ref_img_path", "img_align_celeba",
            "--mask_path", "binary_map", "--identity_file_path", "identity_CelebA.txt",
            "--mask_detector_path", "", "--pt_ckpt_path", str(ckpt),
            "--batch_size", "2", "--output_size", "64", "--use_ref", "--start_from_latent_avg"]


def test_psp_inference_cli_cpu(tree, tmp_path, monkeypatch, caplog):
    """A missing checkpoint warns and runs with random weights; one
    gen_<id>.jpg an image and metrics.csv with a finite SSIM (MS-SSIM is
    nan below 161^2 outputs, as in the JAX CLI)."""
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.WARNING):
        cli.main(_flags(tree, tmp_path / "none" / "ckpt") + ["--save_src_mask", "1"])
    assert any("not found; using random init" in r.getMessage() for r in caplog.records)
    out_dir = tmp_path / "test_results" / "none"
    assert len(list(out_dir.glob("gen_*.jpg"))) == tree["n_images"]
    assert len(list(out_dir.glob("mask_*.jpg"))) == tree["n_images"]
    csv = (out_dir / "metrics.csv").read_text().splitlines()
    assert csv[0] == "ssim,ms_ssim"
    assert math.isfinite(float(csv[1].split(",")[0]))


def test_psp_reference_pth_raises_before_building(tree, tmp_path, monkeypatch):
    """A file that is no checkpoint raises with the loader's message, naming
    the path, before any model is built (reference .pth files now load:
    tests/test_torch_reference_ckpt_psp.py)."""
    ckpt = tmp_path / "psp_ffhq_encode.pth"
    ckpt.write_bytes(b"not a port checkpoint")
    args = cli.get_args(_flags(tree, ckpt))

    def built(**kw):
        raise AssertionError("a model was built before the checkpoint was read")

    monkeypatch.setattr(cli, "PSP", built)
    with pytest.raises(ValueError, match="is not a PyTorch checkpoint") as info:
        cli.build_models(args, torch.device("cpu"))
    assert str(ckpt) in str(info.value)


def test_psp_pt_checkpoint_loads_strictly(tmp_path, monkeypatch):
    """A .pt of the port's own state_dict loads with strict=True (a small
    PSP stands in for the CLI's, whose state_dict has the same keys)."""
    from face_mask_inpaint_tpu_torch.models import psp as psp_mod

    small = dict(num_layers=4, decoder_base_channels=32)
    monkeypatch.setattr(cli, "PSP", lambda **kw: psp_mod.PSP(**kw, **small))
    args = cli.get_args(["--device", "cpu", "--mask_detector_path", "", "--output_size", "32",
                         "--pt_ckpt_path", str(tmp_path / "run" / "model.pt"), "--seed", "1"])
    _, psp = cli.build_models(args, torch.device("cpu"))
    with torch.no_grad():
        psp.latent_avg.normal_()
    (tmp_path / "run").mkdir()
    torch.save(psp.state_dict(), tmp_path / "run" / "model.pt")
    args.seed = 2
    _, loaded = cli.build_models(args, torch.device("cpu"))
    for k, v in psp.state_dict().items():
        assert torch.equal(v, loaded.state_dict()[k]), k


def test_gradio_selftest_cpu(capsys):
    gen, mask = gradio_serve.main(["--selftest", "--device", "cpu", "--output_size", "64",
                                   "--use_attention", "1"])
    assert gen.shape == (300, 260, 3) and gen.dtype.name == "uint8"
    assert mask.shape == (300, 260, 3)
    assert "selftest ok" in capsys.readouterr().out
