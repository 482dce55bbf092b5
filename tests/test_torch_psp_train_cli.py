"""The port's pSp trainer CLI (cli/train_psp.py) in-process with --device
cpu on a 256^2 synthetic CelebA tree at --img_scale 1, with the flags of
tests/test_cli.py's train_psp case (output 64, --use_ref,
--start_from_latent_avg, L2 only) and the W+ backbone encoder: one epoch, its checkpoint and
metrics.jsonl, and --resume from it; the CLI's own defaults (decoder
frozen, no latent average, LPIPS with the logged style and contextual
terms) at batch 1, so that the validation rounds run; the weight files and
fid, which load, and the options that still raise. The CLI's PSP is
patched to the small test configuration (num_layers=4, decoder_base_channels=32), a test seam, not a
flag. The tree holds one identity of two images (one for training, one
for validation): the IR-SE encoder's backward at 256^2 is most of a CPU
step.
"""

import json
import math

import numpy as np
import pytest
import torch

from face_mask_inpaint_tpu.data.synthetic import make_synthetic_celeba
from face_mask_inpaint_tpu_torch.cli import train_psp as cli
from face_mask_inpaint_tpu_torch.models import psp as psp_mod
from face_mask_inpaint_tpu_torch.train import checkpoint as ckpt

from tests.test_torch_train_cli import _state_equal

# The encoder is the last-layer W+ backbone (a train_psp.py flag): the
# GradualStyleEncoder's ten 512-channel heads (1.2e8 weights even in the
# small configuration) would make each checkpoint 1.4 GB; its training step
# is held in tests/test_torch_psp_train.py and on the card.
ENCODER = ["--encoder_type", "BackboneEncoderUsingLastLayerIntoWPlus"]
TEST_CLI = ["--img_scale", "1", "--output_size", "64", "--use_ref", "--start_from_latent_avg",
            "--lpips_lambda", "0", "--l2_lambda", "1", "--style_lambda", "0", "--cx_lambda", "0",
            "--id_lambda", "0", *ENCODER]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def small_psp(monkeypatch):
    monkeypatch.setattr(cli, "PSP", lambda **kw: psp_mod.PSP(
        **kw, num_layers=4, decoder_base_channels=32))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_celeba(tmp_path_factory.mktemp("torch_psp_celeba"), n_identities=1,
                                 images_per_identity=2, size=(256, 256))


def _base(tree, tmp_path, run="psp_smoke"):
    return ["--device", "cpu", "--data_root", str(tree["root"]), "--run_name", run,
            "--checkpoint_path", str(tmp_path / "saved_model")]


def test_train_psp_cli_epoch_checkpoint_and_resume(tree, tmp_path):
    """One training image at batch 8: one step an epoch, an eval step
    (n_train // (10 batch) rounds to 1); the one validation image makes no
    full batch, so the validation loss is 0, as in the JAX trainer.
    --resume 1 (with another --seed) restores the epoch-1 checkpoint whole:
    the model, Adam's state, the tracker, the step and the noise
    generator's state (nothing is left to train at --epochs 1). Ranger's
    state goes through the same state_dict
    (tests/test_torch_psp_train.py)."""
    trainer = cli.main([*_base(tree, tmp_path), "--epochs", "1", "--batch_size", "8",
                        *TEST_CLI])
    assert trainer.step == 1
    run_dir = tmp_path / "saved_model" / "psp_smoke"
    assert ckpt.latest_epoch(run_dir, "G") == 1
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "loss" in r]
    assert len(steps) == 1
    assert {"loss", "loss_l2", "skipped_nonfinite", "epoch"} <= set(steps[0])
    assert math.isfinite(steps[0]["loss"]) and steps[0]["skipped_nonfinite"] == 0.0
    vals = [r for r in recs if "validation loss" in r]
    assert len(vals) == 1 and vals[0]["lr"] == 1e-5 and vals[0]["validation loss"] == 0.0
    assert any(k.startswith("Gradients/encoder/") for k in vals[0])
    assert any(k.startswith("Weights/decoder/") for k in vals[0])
    assert not any(k.startswith(("Weights/decoder/style_", "Gradients/decoder/"))
                   for k in vals[0])  # the decoder is frozen; the style MLP is not logged
    state = ckpt.restore_state(run_dir / "G_checkpoint_epoch1")
    assert state["step"] == 1 and float(state["model"]["latent_avg"].abs().max()) > 0

    resumed = cli.main([*_base(tree, tmp_path), "--epochs", "1", "--batch_size", "8",
                        "--resume", "1", "--seed", "5", *TEST_CLI])
    _state_equal(resumed.state_dict(), state, "state")
    assert all(int(s["step"]) == 1 for s in resumed.optimizer.state.values())


def test_train_psp_cli_defaults(tree, tmp_path):
    """The CLI's defaults at batch 1: adam at 1e-5, the decoder frozen, no
    latent average, no reference (so no contextual term), LPIPS 0.8 and L2
    1 in the loss, the style term logged; a validation round with SSIM
    after the step. The decoder's weights stay as the seed drew them."""
    trainer = cli.main([*_base(tree, tmp_path, "defaults"), "--epochs", "1", "--batch_size",
                        "1", "--output_size", "64", *ENCODER])
    assert trainer.step == 1 and sorted(trainer.nets) == ["lpips", "vgg"]
    assert float(trainer.psp.latent_avg.abs().max()) == 0.0
    fresh, _ = cli.build_models(cli.get_args(["--device", "cpu", "--output_size", "64",
                                              *ENCODER]),
                                trainer.cfg, torch.device("cpu"))
    for (n, p), q in zip(trainer.psp.named_parameters(), fresh.parameters()):
        assert p.requires_grad == n.startswith("encoder."), n
        if not p.requires_grad:
            assert torch.equal(p.detach(), q.detach()), n
    assert not torch.equal(trainer.psp.encoder.linear.weight, fresh.encoder.linear.weight)
    run_dir = tmp_path / "saved_model" / "defaults"
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "loss" in r]
    assert len(steps) == 1
    assert {"loss_l2", "loss_lpips", "loss_style"} <= set(steps[0])
    assert "loss_context" not in steps[0]
    for r in steps:
        assert r["loss"] == pytest.approx(r["loss_l2"] + 0.8 * r["loss_lpips"], rel=1e-5)
    vals = [r for r in recs if "validation loss" in r]
    assert len(vals) == 1 and vals[0]["validation loss"] > 0 and 0 < vals[0]["ssim"] < 1


def test_train_psp_cli_rejects_unported_options(tree, tmp_path, monkeypatch):
    """The options that used to raise now load, through the CLIs' loader:
    --pt_ckpt_path (a reference pSp file: encoder trunk, the small decoder's
    g_ema layout, latent_avg; merged by key and shape), --stylegan_weights
    (a nested g_ema file, merged into the decoder and its noises),
    --irse50_weights (the identity loss's backbone) and --alexnet_weights
    with --lpips_lin_weights (LPIPS), each tensor as the converter gives
    it; --eval_options fid builds a random InceptionV3 and accumulates the
    two validation batches into one Fréchet distance (recorded here: a
    2048-dimensional sqrtm takes about 30 s on this CPU). A directory and
    --device's default still raise."""
    from face_mask_inpaint_tpu_torch import convert
    from face_mask_inpaint_tpu_torch.data.dataset import ReferenceDataset
    from face_mask_inpaint_tpu_torch.data.loader import DataLoader
    from face_mask_inpaint_tpu_torch.evaluations import fid
    from face_mask_inpaint_tpu_torch.models.stylegan2 import Generator
    from face_mask_inpaint_tpu_torch.tools import convert_torch as tct

    from tests import test_converter_numeric as tcn
    from tests.test_torch_reference_ckpt import _lin_sd, _np_sd, g_ema_sd

    def save(sd, name):
        path = tmp_path / name
        torch.save(sd, path)
        return str(path)

    def tensors(sd):
        return {k: torch.from_numpy(v) for k, v in sd.items()}

    def assert_loaded(module, variables):
        want = convert.state_dict_from_jax(module, variables)
        got = module.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    base = [*_base(tree, tmp_path), *TEST_CLI]
    cfg = cli.loss_config(cli.get_args(base))
    g_ema = g_ema_sd(Generator(64, base_channels=32), 1)
    torch.manual_seed(2)
    irse = _np_sd(tcn._TorchIRSE50().eval())
    torch.manual_seed(3)
    alex = _np_sd(tcn._torch_alex_features(), "features.")
    lin = _lin_sd(5, (64, 192, 384, 256, 256), 4)
    latent_avg = np.random.RandomState(5).randn(10, 512).astype(np.float32)
    psp_sd = {f"encoder.{k}": v for k, v in irse.items() if not k.startswith("output_layer")}
    psp_sd.update({f"decoder.{k}": v for k, v in g_ema.items()}, latent_avg=latent_avg)

    args = cli.get_args([*base, "--pt_ckpt_path", save(tensors(psp_sd), "psp.pth")])
    psp, _ = cli.build_models(args, cfg, torch.device("cpu"))
    conv = tct.convert_psp(psp_sd, 64)
    assert_loaded(psp.decoder, {"params": conv["params"]["decoder"],
                                "noises": conv["noises"]["decoder"]})
    assert torch.equal(psp.latent_avg, torch.from_numpy(latent_avg))

    args = cli.get_args([*base, "--id_lambda", "0.1", "--lpips_lambda", "0.8",
                         "--stylegan_weights", save({"g_ema": tensors(g_ema)}, "sg2.pt"),
                         "--irse50_weights", save(tensors(irse), "ir_se50.pth"),
                         "--alexnet_weights", save(tensors(alex), "alexnet.pth"),
                         "--lpips_lin_weights", save(tensors(lin), "alex_lin.pth")])
    cfg = cli.loss_config(args)
    psp, nets = cli.build_models(args, cfg, torch.device("cpu"))
    assert_loaded(psp.decoder, tct.convert_stylegan2_generator(g_ema, 64))
    assert_loaded(nets["facenet"], tct.convert_irse_backbone(irse))
    assert_loaded(nets["lpips"], {"params": tct.convert_lpips_alex(alex, lin)})

    seen = []

    def distance(act1, act2):
        seen.append((act1.shape, act2.shape))
        return float(np.abs(act1.mean(0) - act2.mean(0)).sum())

    monkeypatch.setattr(fid, "frechet_from_activations", distance)
    args = cli.get_args([*base, "--eval_options", "ssim", "fid"])
    trainer = cli.Trainer(args, torch.device("cpu"))
    assert isinstance(trainer.inception, fid.InceptionV3Features)
    val = DataLoader(ReferenceDataset(args.src_img_path, args.ref_img_path, args.mask_path,
                                      args.identity_file_path, apply_transform=True,
                                      use_ssim=True), 1)
    metrics = cli.evaluate(trainer, val, {"ssim", "fid"})
    assert seen == [((2, 2048), (2, 2048))] and math.isfinite(metrics["fid"])

    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 3c"):
        cli.main([*base, "--pt_ckpt_path", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(base[2:])  # --device defaults to cuda
