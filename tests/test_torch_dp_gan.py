"""The Stack A GAN step on two gloo ranks (tests/_torch_dp_worker.py)
against the port's one-process step on the global batch and against the
JAX single-device step.

The configuration of tests/test_dp_equivalence.py, ReferenceFill with its
ENC/DEC, define_d(ndf=4, img_f=16, layers=3), VGG16, Adam at 1e-3 for both
nets, global batch 8, at 32^2 (tests/test_torch_gan.py's size: at that
test's 16^2 the discriminator's last 3x3 valid conv meets a 2x2 map, which
JAX turns into an empty output and NaN losses, and torch refuses), the
weights a seeded fill of the JAX variables carried across by convert.py.
Runs:

- the latent noise the JAX step drew (its ``sample_z`` key, recorded as in
  tests/test_torch_gan.py), each rank handed its slice: the losses, the
  parameters and the spectral-norm vectors against the one-process step at
  the JAX data-parallel test's tolerances (metrics rtol 2e-4 atol 1e-5,
  parameters rtol 5e-3 atol 2.5e-4, a quarter of one Adam step; the
  spectral vectors at rtol 1e-4 atol 1e-5), and against the JAX step at the
  tolerances of tests/test_torch_gan.py;
- the noise drawn from a generator seeded alike on every rank: each rank
  draws at the global shape and keeps its slice, so the images get the
  one-process step's noise;
- a negative control: the noise drawn at the slice's shape misses the
  tolerances.

The contextual loss's feature mean ``y_mu`` is held on its own, on VGG
block-4-sized feature maps whose two halves differ in their means: the
ranks' mean loss and each rank's gradient against the one-process loss of
the whole, with the sync and (the negative control) without it. On the
random batch it is invisible in the step (a test shows the step without
that sync within the tolerances): the term enters the loss divided by
C H W = 8,192 at these sizes. On a batch whose two slices have references
of far different means the step holds with the sync and misses without
it (its parameters: with Adam's first step at +-lr, the term's changed
gradient flips the sign of small ones).

Without a group the step enters no collective and agrees with itself bit
for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.losses import vgg as jvgg
from face_mask_inpaint_tpu.models import picnet as jp
from face_mask_inpaint_tpu.models import reference_fill as jrf
from face_mask_inpaint_tpu.train.gan import make_gan_train_step as j_make_step
from face_mask_inpaint_tpu.train.optim import adam as j_adam
from face_mask_inpaint_tpu.train.state import GANTrainState, ModuleState
from face_mask_inpaint_tpu_torch.convert import (
    convert_discriminator, convert_reference_fill, convert_vgg16, state_dict_from_jax)
from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
from face_mask_inpaint_tpu_torch.models import picnet as tp
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.parallel import dist as pdist
from tests import _torch_dp_worker as worker
from tests.test_torch_gan import random_variables

KEY = jax.random.PRNGKey(0)
ENC = dict(type="pluralistic", ngf=4, z_nc=8, img_f=16, L=1, layers=3,
           norm="none", activation="LeakyReLU", init_type="normal")
DEC = dict(ngf=8, z_nc=8, img_f=32, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="normal")
DISC = dict(ndf=4, img_f=16, layers=3, init_type="normal")
LR = 1e-3
N, HW = 8, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.RandomState(0)
    return {"src_img": rng.rand(N, HW, HW, 3).astype(np.float32),
            "gt_img": rng.rand(N, HW, HW, 3).astype(np.float32),
            "ref_img": rng.rand(N, HW, HW, 3).astype(np.float32),
            "mask": (rng.rand(N, HW, HW) > 0.5).astype(np.float32)}


def _skewed():
    """``_batch()`` with the references of the first half (rank 0's slice)
    in [0, 0.1] and of the second in [0.9, 1]: each slice's VGG feature
    mean is far from the whole batch's."""
    batch = _batch()
    ref = batch["ref_img"]
    batch["ref_img"] = np.concatenate([0.1 * ref[:N // 2],
                                       0.9 + 0.1 * ref[N // 2:]]).astype(np.float32)
    return batch


def _features():
    """(x, y): [8, 32, 4, 4] feature maps, y's second half offset by 1."""
    rng = np.random.RandomState(5)
    x = rng.randn(N, 32, 4, 4).astype(np.float32)
    y = rng.randn(N, 32, 4, 4).astype(np.float32)
    y[N // 2:] += 1.0
    return x, y


@pytest.fixture(scope="module")
def gan_runs(tmp_path_factory):
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    gen = jrf.ReferenceFill(encoder_params=ENC, decoder_params=DEC, use_att=True,
                            out_size=(HW, HW))
    disc = jp.define_d(**DISC)
    g_vars = random_variables(lambda: gen.init({"params": KEY, "sample": KEY},
                                               jbatch["src_img"], jbatch["ref_img"],
                                               jbatch["mask"]), 20)
    d_vars = random_variables(lambda: disc.init(KEY, jbatch["gt_img"]), 21)
    vgg = random_variables(lambda: jvgg.VGG16Features().init(KEY, jbatch["gt_img"]), 22)
    g_tx, d_tx = j_adam(LR), j_adam(LR)
    gs, ds = ModuleState.from_variables(g_vars), ModuleState.from_variables(d_vars)
    state = GANTrainState(step=jnp.zeros([], jnp.int32), generator=gs, discriminator=ds,
                          g_opt_state=g_tx.init(gs.params), d_opt_state=d_tx.init(ds.params),
                          rng=jax.random.PRNGKey(7))
    drawn = []
    original = jrf.sample_z

    def recording_sample_z(src_dist, ref_dist, rng, return_zq=False):
        jax.debug.callback(lambda r, shape=src_dist[0].shape: drawn.append((np.asarray(r),
                                                                            shape)), rng)
        return original(src_dist, ref_dist, rng, return_zq)

    mp = pytest.MonkeyPatch()
    mp.setattr(jrf, "sample_z", recording_sample_z)
    try:
        step = jax.jit(j_make_step(gen, disc, g_tx, d_tx, vgg["params"], return_grads=True))
        new_state, metrics = step(state, jbatch)
        jax.block_until_ready(metrics)
    finally:
        mp.undo()
    (rng, shape), = drawn
    rng_q, rng_p = jax.random.split(jnp.asarray(rng))
    eps = (np.asarray(jax.random.normal(rng_q, shape)),
           np.asarray(jax.random.normal(rng_p, shape)))
    tgen = ReferenceFill(ENC, DEC, use_att=True, out_size=(HW, HW))
    tdisc = tp.define_d(input_nc=3, **DISC)
    tvgg = VGG16Features()
    job = dict(enc=ENC, dec=DEC, disc=DISC, hw=HW, lr=LR, batch=batch, noise_seed=3,
               g_state=convert_reference_fill(tgen, g_vars),
               d_state=convert_discriminator(tdisc, d_vars),
               vgg_state=convert_vgg16(tvgg, vgg["params"]),
               runs=[dict(eps=eps, keep=True), dict(), dict(off="noise"),
                     dict(eps=eps, off="y_mu"), dict(batch=_skewed()),
                     dict(batch=_skewed(), off="y_mu")],
               features=_features())

    def names(model, tree, collection="params"):
        return {k: v.numpy() for k, v in state_dict_from_jax(model, {collection: tree}).items()}

    jax_side = dict(metrics={k: float(v) for k, v in metrics.items()
                             if k not in ("g_grads", "d_grads")},
                    grads={**{f"G.{k}": v for k, v in names(tgen, metrics["g_grads"]).items()},
                           **{f"D.{k}": v for k, v in names(tdisc, metrics["d_grads"]).items()}},
                    params={**{f"G.{k}": v for k, v in names(
                                tgen, new_state.generator.params).items()},
                            **{f"D.{k}": v for k, v in names(
                                tdisc, new_state.discriminator.params).items()}},
                    spectral={**{f"G.{k}": v for k, v in names(
                                  tgen, new_state.generator.spectral, "spectral").items()},
                              **{f"D.{k}": v for k, v in names(
                                  tdisc, new_state.discriminator.spectral, "spectral").items()}})
    jax.clear_caches()
    ranks = worker.run_ranks(tmp_path_factory.mktemp("gan_dp"), "gan", job)
    return dict(jax=jax_side, ranks=ranks)


@pytest.mark.parametrize("i", [0, 1], ids=["jax_noise", "drawn_noise"])
def test_gan_dp_step_matches_one_process_step(gan_runs, i):
    rank0, rank1 = (r["runs"][i] for r in gan_runs["ranks"])
    for kind in ("metrics", "params", "stats"):
        assert rank0["used"][kind] <= 1.0, (kind, rank0["used"])
    assert rank0["metrics"] == rank1["metrics"]
    assert rank1["replica_gap"] == 0.0


def test_gan_dp_step_matches_jax(gan_runs):
    """The losses to rtol 1e-4; each parameter within 1e-2 lr of the JAX
    step's where |g| > 1e-6 and within 2 lr everywhere (Adam's first step
    is +-lr whatever the gradient's size); the spectral vectors to 1e-5."""
    rank0, want = gan_runs["ranks"][0]["runs"][0], gan_runs["jax"]
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(rank0["metrics"][k], w, rtol=1e-4, atol=1e-9, err_msg=k)
    assert set(rank0["params"]) == set(want["params"])
    for k, w in want["params"].items():
        diff = np.abs(rank0["params"][k].numpy() - w)
        settled = np.abs(want["grads"][k]) > 1e-6
        assert diff[settled].max(initial=0) <= 1e-2 * LR, k
        assert diff.max() <= 2 * LR, k
    assert want["spectral"]
    for k, w in want["spectral"].items():
        np.testing.assert_allclose(rank0["stats"][k].numpy(), w, rtol=0, atol=1e-5, err_msg=k)


def test_gan_dp_step_misses_without_the_noise_sync(gan_runs):
    """The negative control: the test sees noise drawn at the slice's
    shape."""
    rank0 = gan_runs["ranks"][0]["runs"][2]
    assert max(rank0["used"].values()) > 1.0, rank0["used"]


def test_gan_y_mu_sync_is_invisible_in_the_step(gan_runs):
    """Why ``y_mu`` is held on its own: without its sync the step still
    holds the tolerances."""
    assert max(gan_runs["ranks"][0]["runs"][3]["used"].values()) <= 1.0


def test_gan_dp_step_holds_y_mu_on_a_skewed_batch(gan_runs):
    """On a batch whose two slices have references of far different means,
    the step with the feature mean's sync holds the tolerances."""
    rank0, rank1 = (r["runs"][4] for r in gan_runs["ranks"])
    for kind in ("metrics", "params", "stats"):
        assert rank0["used"][kind] <= 1.0, (kind, rank0["used"])
    assert rank0["metrics"] == rank1["metrics"] and rank1["replica_gap"] == 0.0


def test_gan_dp_step_misses_without_the_y_mu_sync(gan_runs):
    """The negative control of ``y_mu`` in the step: on that batch the step
    without the sync misses the tolerances."""
    rank0 = gan_runs["ranks"][0]["runs"][5]
    assert max(rank0["used"].values()) > 1.0, rank0["used"]


@pytest.mark.parametrize("rank", [0, 1])
def test_contextual_feature_mean_over_the_ranks(gan_runs, rank):
    """The ranks' contextual loss and gradients are the one-process ones
    with the feature mean summed over the ranks, and miss without it."""
    held, cut = (gan_runs["ranks"][rank][k] for k in ("contextual", "contextual_unsynced"))
    assert held["loss"] > 0.1
    assert held["metrics"] <= 1.0 and held["grads"] <= 1.0, held
    assert cut["metrics"] > 1.0 and cut["grads"] > 1.0, cut


def test_gan_step_without_a_group_enters_no_collective(monkeypatch):
    """W = 1: no process group, no collective, no active group; two runs
    from one state with drawn noise agree bit for bit."""
    from face_mask_inpaint_tpu_torch.nn.layers import init_weights
    from face_mask_inpaint_tpu_torch.train.gan import make_gan_train_step
    from face_mask_inpaint_tpu_torch.train.optim import adam

    def refuse(*a, **k):
        raise AssertionError("a collective ran without a group")

    for name in ("all_reduce", "broadcast", "init_process_group"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    seen = []
    active = pdist.active
    monkeypatch.setattr(pdist, "active", lambda: seen.append(active()) or seen[-1])
    batch = {k: torch.from_numpy(v[:2]) for k, v in _batch().items()}
    results = []
    for _ in range(2):
        weights = torch.Generator().manual_seed(0)
        gen = ReferenceFill(ENC, DEC, use_att=True, out_size=(HW, HW), generator=weights)
        disc = init_weights(tp.define_d(input_nc=3, **DISC), weights)
        vgg = init_weights(VGG16Features(), weights)
        step = make_gan_train_step(gen, disc, vgg, adam(gen.parameters(), LR),
                                   adam(disc.parameters(), LR))
        metrics = step(batch, noise=torch.Generator().manual_seed(1))
        results.append((metrics, {**gen.state_dict(), **disc.state_dict()}))
    assert seen and all(g is None for g in seen)
    assert all(torch.equal(v, results[1][0][k]) for k, v in results[0][0].items())
    assert all(torch.equal(v, results[1][1][k]) for k, v in results[0][1].items())
