"""The port's inference CLI with --device cpu on the synthetic CelebA tree at
64^2 and small widths (the flags of tests/test_cli.py's PICNet case)."""

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from face_mask_inpaint_tpu.data.synthetic import make_synthetic_celeba
from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli

REPO = Path(__file__).resolve().parent.parent
WIDTHS = ["--encoder_ngf", "8", "--encoder_z_nc", "16", "--encoder_img_f", "32",
          "--encoder_layers", "3",
          "--decoder_ngf", "16", "--decoder_z_nc", "16", "--decoder_img_f", "64",
          "--decoder_layers", "3", "--use_att", "1", "--out_size", "64"]


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
    return make_synthetic_celeba(tmp_path_factory.mktemp("torch_cli_celeba"),
                                 n_identities=3, images_per_identity=3, size=(64, 64))


@pytest.mark.parametrize("checkpoint", ["missing", "pt"])
def test_picnet_inference_cli_cpu(tree, tmp_path, checkpoint):
    ckpt = tmp_path / "run" / "model.pt"
    if checkpoint == "pt":
        args = cli.get_args(["--data_root", str(tree["root"]), *WIDTHS])
        _, generator = cli.build_models(args, torch.device("cpu"))
        ckpt.parent.mkdir()
        torch.save(generator.state_dict(), ckpt)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([
        sys.executable, "-m", "face_mask_inpaint_tpu_torch.cli.picnet_inference",
        "--device", "cpu", "--data_root", str(tree["root"]),
        "--mask_detector_path", "", "--pt_ckpt_path", str(ckpt),
        "--batch_size", "4", "--save_src_mask", "1", *WIDTHS,
    ], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out_dir = tmp_path / "test_results" / "run"
    assert len(list(out_dir.glob("gen_*.jpg"))) == tree["n_images"]
    assert len(list(out_dir.glob("mask_*.jpg"))) == tree["n_images"]
    csv = (out_dir / "metrics.csv").read_text().splitlines()
    assert csv[0] == "ssim,ms_ssim"
    assert math.isfinite(float(csv[1].split(",")[0]))  # ms_ssim is nan below 161^2


def test_picnet_inference_cli_best_reference_cpu(tmp_path):
    """--use_best_reference 1 scores each identity group on --device and
    caches the map beside the image folders, as the JAX CLI does."""
    tree = make_synthetic_celeba(tmp_path / "celeba", n_identities=2,
                                 images_per_identity=3, size=(64, 64))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([
        sys.executable, "-m", "face_mask_inpaint_tpu_torch.cli.picnet_inference",
        "--device", "cpu", "--data_root", str(tree["root"]), "--use_best_reference", "1",
        "--mask_detector_path", "", "--pt_ckpt_path", str(tmp_path / "run" / "model.pt"),
        "--batch_size", "4", *WIDTHS,
    ], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (tree["root"] / "best_reference_map.pkl").is_file()
    out_dir = tmp_path / "test_results" / "run"
    assert len(list(out_dir.glob("gen_*.jpg"))) == tree["n_images"]
    csv = (out_dir / "metrics.csv").read_text().splitlines()
    assert math.isfinite(float(csv[1].split(",")[0]))


def test_cuda_device_fails_loudly_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.resolve_device("cuda")


def test_unported_options_raise(tree):
    """--old_model 1, which raised before it was ported, now builds the
    generator for 218x178 and an infer_batch that resizes the images and
    the mask to 218x178 and decodes without z (no_prior). Five encoder
    layers: 13x11 features, so the decoder's attention sees 52x44 tokens."""
    args = cli.get_args(["--data_root", str(tree["root"]), "--old_model", "1", *WIDTHS,
                         "--encoder_layers", "5"])
    detector, generator = cli.build_models(args, torch.device("cpu"))
    assert generator.out_size == (218, 178)
    data = torch.Generator().manual_seed(0)
    src, ref = (torch.rand(2, 64, 64, 3, generator=data) for _ in range(2))
    gen, mask = cli.make_infer_batch(detector, generator, old_model=True)(
        src, ref, torch.Generator().manual_seed(1))
    assert gen.shape == (2, 218, 178, 3) and mask.shape == (2, 218, 178)
    assert bool(torch.isfinite(gen).all()) and float(gen.abs().max()) <= 1.0


def test_picnet_inference_cli_packed_convt_cpu(tree, tmp_path, monkeypatch):
    """FMI_PACKED_CONVT=1 builds the generator with packed_convt=True. With
    pack_threshold 32 (put into the decoder params here; the CLI has no flag
    for it) decoders 1 and 2 of the 16^2 -> 128^2 decode take the fused tail:
    two conv3x3_stats and two convt_pair calls per batch. On the CPU nothing
    launches, so the calls are counted with monkeypatch."""
    from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc

    calls = {"conv3x3_stats": 0, "convt_pair": 0}

    def counted(name):
        fn = getattr(dc, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    process_params = cli.process_params

    def with_threshold(args):
        enc, dec = process_params(args)
        return enc, {**dec, "pack_threshold": 32}

    for name in calls:
        monkeypatch.setattr(dc, name, counted(name))
    monkeypatch.setattr(cli, "process_params", with_threshold)
    monkeypatch.setenv("FMI_PACKED_CONVT", "1")
    monkeypatch.chdir(tmp_path)
    cli.main(["--device", "cpu", "--data_root", str(tree["root"]), "--mask_detector_path", "",
              "--pt_ckpt_path", str(tmp_path / "run" / "model.pt"), "--batch_size", "4",
              *WIDTHS])
    batches = -(-tree["n_images"] // 4)
    assert calls == {"conv3x3_stats": 2 * batches, "convt_pair": 2 * batches}
    out_dir = tmp_path / "test_results" / "run"
    assert len(list(out_dir.glob("gen_*.jpg"))) == tree["n_images"]
    csv = (out_dir / "metrics.csv").read_text().splitlines()
    assert math.isfinite(float(csv[1].split(",")[0]))
