"""FID in the port (evaluations/fid.py, cli/test_evaluate.py), held against
the JAX package on the CPU.

- ``InceptionV3Features`` against JAX's at 299^2, batch 1, f32, the same
  variables carried across (eval_shape and a seeded fill; batch statistics
  as running ones): the [1, 2048] activations to 1e-5 of the largest.
- ``calculate_frechet_distance`` against JAX's on the same statistics, to
  1e-9 relative (both are the same float64 numpy and scipy code), on
  64-dimensional statistics: well-conditioned, singular (the eps retry) and
  with a large imaginary part (the check raises on both sides). A
  2048-dimensional ``sqrtm`` takes about 30 s on this CPU; the card's
  smoke run computes it on the real activations.
- The port's ``test_evaluate`` against the JAX CLI run in-process on the
  same folder of 176^2 generated images and 704^2 ground truths, with a
  reference-layout InceptionV3 ``.pth`` (the JAX test's torch module, its
  convs He-normal so that the images' activations differ): the
  same ``metrics.csv`` columns in the same order, ssim and ms_ssim to 1e-5
  relative, and the statistics each CLI hands to its Fréchet distance to
  1e-4 of their largest entry. For time, both CLIs' distance is a recorder
  that returns the distance of the statistics' 32 dimensions of largest
  variance (so the fid column is compared too, to 1e-3 relative: the
  distance of two four-image sets is a difference of near terms).
"""

import csv
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.evaluations import fid as jfid
from face_mask_inpaint_tpu_torch import convert
from face_mask_inpaint_tpu_torch.evaluations import fid as tfid

from tests import test_converter_numeric as tcn
from tests.test_torch_reference_ckpt import _np_sd
from tests.test_torch_stylegan2 import random_variables

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_inception_features_match_jax():
    x = np.random.RandomState(0).rand(1, 299, 299, 3).astype(np.float32)
    jnet = jfid.InceptionV3Features()
    variables = random_variables(lambda: jnet.init(KEY, jnp.asarray(x)), 1)
    want = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(variables, jnp.asarray(x))
    net = tfid.InceptionV3Features()
    net.load_state_dict(convert.convert_inception(net, variables), strict=True)
    got = tfid.get_activations(x, 1, net, "cpu")
    want = np.asarray(want)
    assert got.shape == (1, 2048)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _stats(rs, n, d, rank=None):
    a = rs.randn(n, d)
    if rank is not None:
        a = a[:, :rank] @ rs.randn(rank, d)
    return np.mean(a, axis=0), np.cov(a, rowvar=False)


@pytest.mark.parametrize("case", ["full", "singular"])
def test_frechet_distance_matches_jax(case):
    rs = np.random.RandomState(2)
    rank = None if case == "full" else 5
    mu1, s1 = _stats(rs, 200 if rank is None else 8, 64, rank)
    mu2, s2 = _stats(rs, 200 if rank is None else 8, 64, rank)
    got = tfid.calculate_frechet_distance(mu1, s1, mu2, s2)
    want = jfid.calculate_frechet_distance(mu1, s1, mu2, s2)
    assert np.isfinite(got) and abs(got - want) <= 1e-9 * abs(want)
    act1, act2 = rs.randn(300, 16), rs.randn(300, 16) + 0.5
    assert tfid.frechet_from_activations(act1, act2) == jfid.calculate_frechet_distance(
        *jfid.statistics_from_activations(act1), *jfid.statistics_from_activations(act2))


def test_frechet_distance_imaginary_check_matches_jax():
    """A product of covariances with a large imaginary square root raises
    on both sides."""
    s1 = np.array([[1.0, 0.0], [0.0, 1.0]])
    s2 = np.array([[-1.0, 0.0], [0.0, 1.0]])
    mu = np.zeros(2)
    with pytest.raises(ValueError, match="Imaginary component"):
        jfid.calculate_frechet_distance(mu, s1, mu, s2)
    with pytest.raises(ValueError, match="Imaginary component"):
        tfid.calculate_frechet_distance(mu, s1, mu, s2)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid_eval")
    (root / "images").mkdir()
    gen = root / "test_results" / "run"
    gen.mkdir(parents=True)
    rs = np.random.RandomState(3)
    for i in range(4):
        base = rs.randint(0, 256, (176, 176, 3)).astype(np.uint8)
        big = np.asarray(Image.fromarray(base).resize((704, 704), Image.BICUBIC))
        Image.fromarray(big).save(root / "images" / f"{i:06d}.jpg")
        noisy = np.clip(base.astype(int) + rs.randint(-30, 30, base.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(gen / f"gen_{i:06d}.jpg")
    tm = tcn._TorchInception()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():  # He-normal convs keep the images' activations apart
        for m in tm.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0, (2.0 / m.weight[0].numel()) ** 0.5, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.8, 1.2, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
    torch.save({k: torch.from_numpy(v) for k, v in _np_sd(tm).items()},
               root / "inception_v3.pth")
    return root, gen


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [float(v) for v in rows[1]]


def test_test_evaluate_matches_jax_cli(folder, monkeypatch):
    import test_evaluate as jcli
    from face_mask_inpaint_tpu_torch.cli import test_evaluate as cli

    root, gen = folder
    flags = ["--data_root", str(root), "--test_folder", str(gen), "--batch_size", "2",
             "--inception_weights", str(root / "inception_v3.pth")]
    recorded = {}

    def sub(stats):
        mu1, s1, mu2, s2 = stats
        i = recorded["dims"]
        return mu1[i], s1[np.ix_(i, i)], mu2[i], s2[np.ix_(i, i)]

    def jax_distance(*stats):
        recorded["jax"] = stats
        # the 32 dimensions of largest variance (many random-net channels
        # are dead), picked once from the JAX side's statistics
        recorded["dims"] = np.argsort(-(np.diag(stats[1]) + np.diag(stats[3])))[:32]
        return jfid.calculate_frechet_distance(*sub(stats))

    def port_distance(act1, act2):
        stats = (*tfid.statistics_from_activations(act1), *tfid.statistics_from_activations(act2))
        recorded["port"] = stats
        return tfid.calculate_frechet_distance(*sub(stats))

    monkeypatch.setattr(jcli, "calculate_frechet_distance", jax_distance)
    monkeypatch.setattr(sys, "argv", ["test_evaluate.py", *flags])
    jcli.main()
    (gen / "metrics.csv").rename(gen / "metrics_jax.csv")
    monkeypatch.setattr(tfid, "frechet_from_activations", port_distance)
    cli.main([*flags, "--device", "cpu"])

    names, got = _read_csv(gen / "metrics.csv")
    jnames, want = _read_csv(gen / "metrics_jax.csv")
    assert names == jnames and sorted(names) == ["fid", "ms_ssim", "ssim"]
    for name, g, w in zip(names, got, want):
        assert np.isfinite(g) and abs(g - w) <= (1e-3 if name == "fid" else 1e-5) * abs(w), name
    for g, w in zip(recorded["port"], recorded["jax"]):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
