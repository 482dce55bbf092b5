"""The port's trainer CLI (cli/train_reference_fill.py) with --device cpu on
the synthetic CelebA tree at 64^2 and the tiny widths of tests/test_cli.py's
trainer case, in-process: metrics JSONL and per-epoch checkpoints; resume
from a checkpoint equal, bit for bit, to an uninterrupted run; the plateau
tracker against the JAX tracker; and the inference CLI's --profile_dir.
"""

import json
import math

import numpy as np
import pytest
import torch

from face_mask_inpaint_tpu.data.synthetic import make_synthetic_celeba
from face_mask_inpaint_tpu.train.optim import PlateauTracker as JPlateauTracker
from face_mask_inpaint_tpu_torch.cli import picnet_inference as infer_cli
from face_mask_inpaint_tpu_torch.cli import train_reference_fill as cli
from face_mask_inpaint_tpu_torch.train import checkpoint as ckpt
from face_mask_inpaint_tpu_torch.train.optim import PlateauTracker

WIDTHS = ["--encoder_ngf", "8", "--encoder_z_nc", "16", "--encoder_img_f", "32",
          "--encoder_layers", "3",
          "--decoder_ngf", "16", "--decoder_z_nc", "16", "--decoder_img_f", "64",
          "--decoder_layers", "3", "--use_att", "1", "--out_size", "64"]
TINY = [*WIDTHS, "--disc_ndf", "8", "--disc_layers", "3"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_celeba(tmp_path_factory.mktemp("torch_train_celeba"),
                                 n_identities=4, images_per_identity=3, size=(64, 64))


def test_train_reference_fill_cli_cpu(tree, tmp_path):
    """One epoch at batch 4 (three steps, each an eval step at this size, as
    n_train // (10 batch) rounds to 1) in the default bf16-mixed precision:
    finite losses in metrics.jsonl, validation rounds with the learning
    rates, histograms, and the epoch's G and D checkpoints."""
    trainer = cli.main(["--device", "cpu", "--epochs", "1", "--batch_size", "4",
                        "--data_root", str(tree["root"]), "--run_name", "smoke",
                        "--checkpoint_path", str(tmp_path / "saved_model"), *TINY])
    assert trainer.step == 3
    assert trainer.generator.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.generator.parameters())
    run_dir = tmp_path / "saved_model" / "smoke"
    assert ckpt.latest_epoch(run_dir, "G") == ckpt.latest_epoch(run_dir, "D") == 1
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["G loss"] for r in recs if "G loss" in r]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert all(math.isfinite(r["D loss"]) for r in recs if "D loss" in r)
    vals = [r for r in recs if "lr G" in r]
    assert len(vals) == 3 and vals[0]["lr G"] == 1e-5
    assert any(k.startswith("Gradients/G/") for k in vals[0])
    g_state = ckpt.restore_state(run_dir / "G_checkpoint_epoch1")
    assert g_state["step"] == 3 and "decoder.out2.conv1.conv.u" in g_state["model"]


def test_train_cli_rejects_unported_options(tree, tmp_path, monkeypatch, caplog):
    """--eval_options fid now runs: a random InceptionV3 from --seed with
    the JAX CLI's warning, the activations of the two validation batches
    (one image each) accumulated into one Fréchet distance. The distance is
    recorded here (a 2048-dimensional sqrtm takes about 30 s on this CPU;
    tests/test_torch_fid.py holds it against JAX's). --encoder_type drn
    still raises."""
    import logging

    from face_mask_inpaint_tpu_torch.data.loader import get_reference_dataloader
    from face_mask_inpaint_tpu_torch.evaluations import fid

    base = ["--device", "cpu", "--data_root", str(tree["root"]),
            "--checkpoint_path", str(tmp_path), "--compute_dtype", "float32", *TINY]
    args = cli.get_args([*base, "--eval_options", "ssim", "fid", "--batch_size", "1"])
    with caplog.at_level(logging.WARNING):
        trainer = cli.Trainer(args, torch.device("cpu"))
    assert any("randomly initialized InceptionV3" in r.getMessage() for r in caplog.records)
    seen = []

    def distance(act1, act2):
        seen.append((act1.shape, act2.shape))
        return float(np.abs(act1.mean(0) - act2.mean(0)).sum())

    monkeypatch.setattr(fid, "frechet_from_activations", distance)
    _, val_loader = get_reference_dataloader(
        args.src_img_path, args.ref_img_path, args.mask_path, args.identity_file_path, 1,
        val_amount=0.1)
    assert len(val_loader) == 2
    metrics, _ = cli.evaluate(trainer, val_loader, {"ssim", "fid"}, 1)
    assert seen == [((2, 2048), (2, 2048))]
    assert math.isfinite(metrics["fid"]) and metrics["fid"] > 0 and 0 < metrics["ssim"] < 1
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 6"):
        cli.main([*base, "--encoder_type", "drn"])


def _state_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _state_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _state_equal(x, y, f"{what}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b or (a != a and b != b), what


def test_resume_equals_uninterrupted_run(tree, tmp_path):
    """Two steps in one run equal one step, save, restore into a fresh
    trainer and one step, bit for bit: parameters, spectral u/v, both Adam
    states, both trackers, the step and the noise generator's state (in the
    pattern of tests/test_train_steps.py::test_gan_resume_trajectory_equivalence)."""
    args = cli.get_args(["--device", "cpu", "--data_root", str(tree["root"]),
                         "--compute_dtype", "float32", "--learning_rate", "1e-4", *TINY])
    rs = np.random.RandomState(0)
    batches = [{"src_img": torch.from_numpy(rs.rand(2, 64, 64, 3).astype(np.float32)),
                "gt_img": torch.from_numpy(rs.rand(2, 64, 64, 3).astype(np.float32)),
                "ref_img": torch.from_numpy(rs.rand(2, 64, 64, 3).astype(np.float32)),
                "mask": torch.from_numpy((rs.rand(2, 64, 64) > 0.5).astype(np.float32))}
               for _ in range(2)]

    def run(trainer, bs):
        for b in bs:
            trainer.train_step(b, noise=trainer.noise)
            trainer.step += 1
        return trainer

    cont = run(cli.Trainer(args, torch.device("cpu")), batches)
    inter = run(cli.Trainer(args, torch.device("cpu")), batches[:1])
    g, d = inter.state_dicts()
    ckpt.save_state(tmp_path, "G", 1, g)
    ckpt.save_state(tmp_path, "D", 1, d)
    assert ckpt.latest_epoch(tmp_path, "G") == 1
    resumed = cli.Trainer(args, torch.device("cpu"))
    resumed.load_state_dicts(ckpt.restore_state(tmp_path / "G_checkpoint_epoch1"),
                             ckpt.restore_state(tmp_path / "D_checkpoint_epoch1"))
    run(resumed, batches[1:])
    for a, b in zip(cont.state_dicts(), resumed.state_dicts()):
        _state_equal(a, b, "state")
    assert resumed.step == 2


def test_plateau_tracker_matches_jax():
    """The learning-rate sequence of the trainer's trackers (mode 'max',
    patience 2, factor 0.8) and a 'min' one, on one metric sequence, equals
    the JAX tracker's; the state survives a state_dict round trip."""
    metrics = [1.0, 1.2, 1.1, 1.1, 1.15, 1.3, 1.3, 1.29, 1.28, 1.2, 0.5, 2.0, 1.9]
    for kw in (dict(mode="max", patience=2, factor=0.8), dict(mode="min", patience=1)):
        ours, theirs = PlateauTracker(1e-4, **kw), JPlateauTracker(1e-4, **kw)
        got = [ours.step(m) for m in metrics]
        assert got == [theirs.step(m) for m in metrics]
        assert len(set(got)) > 1  # the sequence decays at least once
        again = PlateauTracker(1.0, **kw)
        again.load_state_dict(ours.state_dict())
        assert (again.lr, again.best, again.num_bad) == (ours.lr, ours.best, ours.num_bad)


def test_picnet_inference_cli_writes_profile(tree, tmp_path, monkeypatch):
    """--profile_dir traces batches 2 .. 2 + --profile_steps (batch 1 over
    the twelve images) and writes a Chrome trace."""
    monkeypatch.chdir(tmp_path)
    infer_cli.main(["--device", "cpu", "--data_root", str(tree["root"]),
                    "--mask_detector_path", "", "--pt_ckpt_path", "",
                    "--batch_size", "1", "--profile_dir", str(tmp_path / "prof"),
                    "--profile_steps", "1", *WIDTHS])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
