"""The trainer CLIs on two gloo ranks (tests/_torch_dp_worker.py, in-process
``main`` on each rank, torchrun's environment replaced by a ``file://``
rendezvous) against the same CLI on one rank, on synthetic trees.

- ``train_mask_detector`` at ``--batch-size 3``: the global batch rounds to
  2 (``max(b, W) // W * W``), one image a rank, so BatchNorm's moments need
  both ranks; held against the one-rank CLI at ``--batch-size 2``.
- ``train_reference_fill`` at the tiny widths of tests/test_torch_train_cli.py,
  batch 2, f32, 13 training images: a validation round after every step on
  rank 0 alone, its losses broadcast to step both ranks' learning rates.
  With ``--use_best_reference 1`` the two-rank run goes first: rank 0
  scores and writes the best-reference map while rank 1 waits, then reads
  it, and so does the one-rank run, so both runs pair every image with the
  same reference (without the map each process draws references from its
  own seeded generator, as each host of the JAX loader does).

Only rank 0 writes (the files of each run directory, each metric record
written once); the ranks end with equal parameters and running statistics;
the ranks drop the short last batch the one-rank CLI keeps. The learning
rate is 0, so every step starts from the same weights: each step's logged
losses are then the one-rank CLI's on the same global batch at the JAX
data-parallel tests' metric tolerance (rtol 2e-4, atol 1e-5), and so are
the validation metrics, over the whole epoch (tests/test_torch_dp*.py hold
the step's update; with Adam the two runs' trajectories part as sign flips
on near-zero gradients accumulate, step after step).
"""

import json
import math

import pytest
import torch

from face_mask_inpaint_tpu.data.synthetic import make_synthetic_celeba
from face_mask_inpaint_tpu_torch.cli import train_mask_detector as unet_cli
from face_mask_inpaint_tpu_torch.cli import train_reference_fill as gan_cli
from tests import _torch_dp_worker as worker

TINY = ["--encoder_ngf", "8", "--encoder_z_nc", "16", "--encoder_img_f", "32",
        "--encoder_layers", "3", "--decoder_ngf", "16", "--decoder_z_nc", "16",
        "--decoder_img_f", "64", "--decoder_layers", "3", "--use_att", "1", "--out_size", "64",
        "--disc_ndf", "8", "--disc_layers", "3"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unet_argv(root, out, batch):
    return ["--device", "cpu", "--dir_img", str(root / "img_align_celeba_masked1"),
            "--dir_mask", str(root / "binary_map"), "--dir_checkpoint", str(out),
            "--batch-size", str(batch), "--epochs", "1", "--scale", "0.5",
            "--learning-rate", "0"]


def _gan_argv(root, out):
    return ["--device", "cpu", "--epochs", "1", "--batch_size", "2", "--data_root", str(root),
            "--run_name", "dp", "--checkpoint_path", str(out), "--compute_dtype", "float32",
            "--learning_rate", "0", "--use_best_reference", "1", *TINY]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_cli")
    unet_tree = make_synthetic_celeba(base / "unet_tree", n_identities=12,
                                      images_per_identity=2, size=(64, 64))["root"]
    gan_tree = make_synthetic_celeba(base / "gan_tree", n_identities=5,
                                     images_per_identity=3, size=(64, 64))["root"]
    ranks = worker.run_ranks(base, "clis", {"argv": {
        "train_mask_detector": _unet_argv(unet_tree, base / "unet2", 3),
        "train_reference_fill": _gan_argv(gan_tree, base / "gan2")}})
    assert (gan_tree / "best_reference_map.pkl").is_file()
    one = {"unet": unet_cli.main(_unet_argv(unet_tree, base / "unet1", 2)),
           "gan": gan_cli.main(_gan_argv(gan_tree, base / "gan1"))}
    return dict(base=base, one=one, ranks=ranks)


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _records(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def _close(got, want):
    return abs(got - want) <= 1e-5 + 2e-4 * abs(want)


def test_unet_cli_on_two_ranks(runs):
    base, ranks = runs["base"], [r["train_mask_detector"] for r in runs["ranks"]]
    assert _files(base / "unet2") == _files(base / "unet1") == [
        "logs/metrics.jsonl", "unet_checkpoint_epoch1"]
    one, two = _records(base / "unet1/logs/metrics.jsonl"), _records(
        base / "unet2/logs/metrics.jsonl")
    assert sum("_config" in r for r in two) == 1 and two[0]["_config"]["batch_size"] == 2
    losses = [[r["train loss"] for r in recs if "train loss" in r] for recs in (one, two)]
    assert [r["step"] for r in two if "train loss" in r] == list(range(1, 12))
    assert len(losses[0]) == len(losses[1]) == 11 == ranks[0]["step"] == ranks[1]["step"]
    assert all(_close(g, w) for g, w in zip(losses[1], losses[0])), losses
    dice = [[r["validation Dice"] for r in recs if "validation Dice" in r] for recs in (one, two)]
    assert len(dice[1]) == 11 and all(_close(g, w) for g, w in zip(*dice[::-1])), dice
    assert ranks[0]["checksum"] == ranks[1]["checksum"]


def test_reference_fill_cli_on_two_ranks(runs):
    base, ranks = runs["base"], [r["train_reference_fill"] for r in runs["ranks"]]
    images = [f"dp/images/{k}_{i}.png" for k in ("gen", "gt") for i in range(1, 7)]
    assert _files(base / "gan2") == sorted(["dp/D_checkpoint_epoch1", "dp/G_checkpoint_epoch1",
                                            "dp/metrics.jsonl", *images])
    one, two = _records(base / "gan1/dp/metrics.jsonl"), _records(base / "gan2/dp/metrics.jsonl")
    # 13 training images: the one-rank CLI keeps the short seventh batch, the
    # ranks drop it
    assert runs["one"]["gan"].step == 7 and ranks[0]["step"] == ranks[1]["step"] == 6
    steps = [[r for r in recs if "G loss" in r] for recs in (one, two)]
    assert [r["step"] for r in steps[1]] == list(range(1, 7))
    assert sum("_config" in r for r in two) == 1
    for got, want in zip(steps[1], steps[0]):
        for k in ("G loss", "D loss", "perceptual loss", "style loss", "contextual loss"):
            assert math.isfinite(got[k]) and _close(got[k], want[k]), (k, got[k], want[k])
    vals = [[r for r in recs if "lr G" in r] for recs in (one, two)]
    assert len(vals[1]) == 6 and vals[1][0]["D validation loss"] > 0
    for got, want in zip(vals[1], vals[0]):
        for k in ("D validation loss", "G validation loss", "lr G", "lr D"):
            assert _close(got[k], want[k]), (k, got[k], want[k])
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
