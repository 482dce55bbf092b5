"""Data parallel in the port (parallel/dist.py): its plumbing, and the
Stack C (UNet) step on two gloo ranks against the one-process step on the
global batch and against the JAX single-device step.

- ``local_batch_size`` raises on a batch the ranks do not divide
  (mesh.py:64-68); ``round_batch`` is the JAX CLIs' ``max(b, W) // W * W``;
  the loader's rank slices make up the one-rank loader's global batches, in
  order, epoch after epoch, a short last batch dropped (loader.py:78-84,
  :124-130).
- Without a group the UNet step enters no collective and runs as before.
- The UNet of tests/test_dp_equivalence_bc.py (MaskDetector(3, bilinear),
  32^2, global batch 8, SGD at 1e-3) on two ranks (tests/_torch_dp_worker.py)
  against the one-process step, at that test's tolerances (loss rtol 2e-4
  atol 1e-5, parameters rtol 5e-3 atol 2.5e-4, running statistics rtol
  1e-4 atol 1e-5), and against the JAX step at the one-step parity
  tolerances of tests/test_torch_unet_train.py. Negative controls: with
  BatchNorm's or the Dice's sums left on each rank's slice, the two-rank
  step misses the tolerances. On that batch the mean of two slices' Dice
  lies within the loss's tolerance of the global one, so the Dice is held
  on a second batch too, whose second half holds faces without a mask (no
  foreground on rank 1): there the two-rank step holds with the sync and
  misses without it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from face_mask_inpaint_tpu.models.unet import MaskDetector as JMaskDetector
from face_mask_inpaint_tpu.train import unet as junet
from face_mask_inpaint_tpu.train.state import ModuleState, TrainState
from face_mask_inpaint_tpu_torch import convert
from face_mask_inpaint_tpu_torch.data.loader import DataLoader
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.parallel import dist as pdist
from tests import _torch_dp_worker as worker
from tests.test_torch_stylegan2 import random_variables

KEY = jax.random.PRNGKey(0)
LR = 1e-3
N, HW = 8, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- plumbing -------------------------------------------------------------------

@pytest.mark.parametrize("batch,world,local", [(8, 2, 4), (16, 4, 4), (3, 1, 3), (6, 3, 2)])
def test_local_batch_size_divides(batch, world, local):
    assert pdist.local_batch_size(batch, world) == local


@pytest.mark.parametrize("batch,world", [(7, 2), (10, 4), (1, 2)])
def test_local_batch_size_raises_on_an_indivisible_batch(batch, world):
    with pytest.raises(ValueError, match="not divisible"):
        pdist.local_batch_size(batch, world)
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(_Items(12), batch, shuffle=True, rank=0, world_size=world)


@pytest.mark.parametrize("batch,world,want", [(8, 2, 8), (7, 2, 6), (1, 2, 2), (5, 4, 4),
                                              (3, 1, 3)])
def test_round_batch_is_the_jax_clis(batch, world, want):
    assert pdist.round_batch(batch, world) == want == max(batch, world) // world * world


def test_rank_slice_is_contiguous():
    x = torch.arange(12).reshape(6, 2)
    groups = [pdist.Group(r, 3, torch.device("cpu")) for r in range(3)]
    assert torch.equal(torch.cat([pdist.rank_slice(x, g) for g in groups]), x)
    assert torch.equal(pdist.rank_slice(x, groups[1]), x[2:4])
    assert pdist.rank_slice(x, None) is x


class _Items(torch.utils.data.Dataset):
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.array([i], np.int64)}


@pytest.mark.parametrize("world", [2, 4])
def test_loader_rank_slices_make_up_the_global_batches(world):
    """Over two epochs the ranks' batches, laid side by side, are the
    one-rank loader's full batches in its order; its short last one (23 = 2
    x 8 + 7) is dropped; every rank has as many batches."""
    one = DataLoader(_Items(23), 8, shuffle=True, seed=5)
    ranks = [DataLoader(_Items(23), 8, shuffle=True, seed=5, rank=r, world_size=world)
             for r in range(world)]
    assert [len(r) for r in ranks] == [2] * world and len(one) == 3
    for _ in range(2):
        want = [b["x"].ravel().tolist() for b in one]
        got = [[b["x"].ravel().tolist() for b in r] for r in ranks]
        assert all(len(g) == 2 and all(len(b) == 8 // world for b in g) for g in got)
        assert [sum((g[i] for g in got), []) for i in range(2)] == want[:2]
        assert len(want[2]) == 7


def test_loader_rank_slices_in_order_without_shuffle():
    ranks = [DataLoader(_Items(10), 4, rank=r, world_size=2) for r in range(2)]
    assert [[b["x"].ravel().tolist() for b in r] for r in ranks] == [
        [[0, 1], [4, 5]], [[2, 3], [6, 7]]]


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_one_rank_is_the_torch_loader(drop_last):
    """W = 1: the batches of torch's own loader with ``shuffle`` on the same
    seeded generator, over two epochs, its short last one (23 = 2 x 8 + 7)
    kept unless ``drop_last``."""
    ours = DataLoader(_Items(23), 8, shuffle=True, drop_last=drop_last, seed=5)
    theirs = torch.utils.data.DataLoader(_Items(23), 8, shuffle=True, drop_last=drop_last,
                                         generator=torch.Generator().manual_seed(5))
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for _ in range(2):
        assert ([b["x"].ravel().tolist() for b in ours]
                == [b["x"].ravel().tolist() for b in theirs])


def test_ranks_agree_or_all_raise(tmp_path):
    """``agree``, which the trainer CLIs call after a resume or a load: with
    every rank holding rank 0's values no rank raises; with rank 1's
    different (it found no checkpoint) both ranks raise."""
    got = worker.run_ranks(tmp_path, "agree", dict(runs=[[[3, 10], [3, 10]],
                                                          [[3, 10], [0, 0]]]))
    assert [r[0] for r in got] == [None, None]
    assert all(r[1] and "1 of 2 ranks disagree" in r[1] for r in got), got


# -- the UNet step --------------------------------------------------------------

def _batch(seed=1, unmasked_half=False):
    rng = np.random.RandomState(seed)
    batch = {"image": rng.rand(N, HW, HW, 3).astype(np.float32),
             "mask": (rng.rand(N, HW, HW) > 0.5).astype(np.int32)}
    if unmasked_half:
        batch["mask"][N // 2:] = 0
    return batch


@pytest.fixture(scope="module")
def unet_runs(tmp_path_factory):
    """The JAX step, the port's weights carried across, and the two-rank
    runs: the step (its parameters kept), BatchNorm's sums on each rank's
    slice, the Dice's sums on each rank's slice; on the half-unmasked batch
    the step and the Dice's sums on each rank's slice."""
    batch = _batch()
    jnet = JMaskDetector(n_channels=3, bilinear=True)
    variables = random_variables(lambda: jnet.init(KEY, jnp.asarray(batch["image"]),
                                                   mode="train", train=False), 7)
    tx = optax.sgd(LR)
    ms = ModuleState.from_variables(variables)
    state = TrainState(step=jnp.zeros([], jnp.int32), model=ms, opt_state=tx.init(ms.params),
                       rng=KEY)
    new, metrics = jax.jit(junet.make_unet_train_step(jnet, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    net = MaskDetector()
    port_state = convert.state_dict_from_jax(net, variables)
    want = convert.state_dict_from_jax(net, jax.device_get(new.model.variables()))
    jax.clear_caches()
    skewed = _batch(2, unmasked_half=True)
    runs = [dict(batch=batch, keep=True), dict(batch=batch, off="batch_norm"),
            dict(batch=batch, off="dice"), dict(batch=skewed), dict(batch=skewed, off="dice")]
    got = worker.run_ranks(tmp_path_factory.mktemp("unet_dp"), "unet",
                           dict(state=port_state, lr=LR, runs=runs))
    return dict(jax_loss=float(metrics["loss"]), jax_state=want, ranks=got,
                port_state=port_state, batch=batch)


@pytest.mark.parametrize("i", [0, 3], ids=["batch", "half_unmasked"])
def test_unet_dp_step_matches_one_process_step(unet_runs, i):
    rank0, rank1 = (r[i] for r in unet_runs["ranks"])
    assert rank0["used"]["metrics"] <= 1.0, rank0["used"]
    assert rank0["used"]["params"] <= 1.0, rank0["used"]
    assert rank0["used"]["stats"] <= 1.0, rank0["used"]
    assert rank0["metrics"] == rank1["metrics"]
    assert rank1["replica_gap"] == 0.0
    assert rank0["metrics"]["loss"] > 0.0


def test_unet_dp_step_matches_jax(unet_runs):
    """The loss to 1e-5 relative; each parameter and running statistic to
    1e-4 of the tensor's largest JAX entry + 1e-6 (SGD moves each weight by
    lr g, so the gradients' f32 sums in another order stay far below)."""
    rank0 = unet_runs["ranks"][0][0]
    want, j_loss = unet_runs["jax_state"], unet_runs["jax_loss"]
    assert abs(rank0["metrics"]["loss"] - j_loss) <= 1e-5 * abs(j_loss)
    got = {**rank0["params"], **rank0["stats"]}
    assert set(got) == {k for k, v in want.items() if v.is_floating_point()}
    for k, g in got.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max() + 1e-6, k
    moved = max(float((got[k] - unet_runs["port_state"][k]).abs().max()) for k in got)
    assert moved > 1e-6


@pytest.mark.parametrize("i,sync", [(1, "batch_norm"), (4, "dice")])
def test_unet_dp_step_misses_without_its_sync(unet_runs, i, sync):
    """The negative controls: the test sees a missing all-reduce."""
    rank0 = unet_runs["ranks"][0][i]
    assert max(rank0["used"].values()) > 1.0, (sync, rank0["used"])


def test_unet_dice_sync_is_invisible_on_the_random_batch(unet_runs):
    """Why the Dice's control needs the second batch: without the sync the
    step on the random batch still holds the tolerances."""
    assert max(unet_runs["ranks"][0][2]["used"].values()) <= 1.0


def test_unet_step_without_a_group_enters_no_collective(monkeypatch):
    """W = 1: no process group, no collective, no active group in the
    batch-coupled reductions; two runs from one state agree bit for bit."""
    from face_mask_inpaint_tpu_torch.train.optim import adam
    from face_mask_inpaint_tpu_torch.train.unet import make_unet_train_step

    def refuse(*a, **k):
        raise AssertionError("a collective ran without a group")

    for name in ("all_reduce", "broadcast", "init_process_group"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    seen = []
    active = pdist.active
    monkeypatch.setattr(pdist, "active", lambda: seen.append(active()) or seen[-1])
    rs = np.random.RandomState(3)
    batch = {"image": torch.from_numpy(rs.rand(2, 16, 16, 3).astype(np.float32)),
             "mask": torch.from_numpy((rs.rand(2, 16, 16) > 0.5).astype(np.int64))}
    states = []
    for _ in range(2):
        net = MaskDetector(generator=torch.Generator().manual_seed(0))
        loss = make_unet_train_step(net, adam(net.parameters(), 1e-4))(batch)["loss"]
        states.append((loss, net.state_dict()))
    assert seen and all(g is None for g in seen)
    assert torch.equal(states[0][0], states[1][0])
    assert all(torch.equal(v, states[1][1][k]) for k, v in states[0][1].items())


def test_dp_check_tool_on_the_cpu(tmp_path):
    """tools/dp_check.py, which chip_smoke.py phase 13 runs on the card, on
    two CPU ranks with the UNet at 32^2 (its widths are fixed): the ranks
    launch no kernel and end equal; the two-rank metrics are the
    one-process ones at the JAX data-parallel tests' tolerance; the two-rank
    parameter update and gradients lie within phase 13's three times the
    drift of the one-process ones, and the negative control (BatchNorm's
    moments kept per rank) misses that gate."""
    from face_mask_inpaint_tpu_torch.tools import dp_check

    r = dp_check.run("unet", 2, 0, str(tmp_path), 120, device="cpu", hw=32)
    assert [x["replica_gap"] for x in r["ranks"]] == [0.0, 0.0]
    assert all(not any(x["launches"].values()) for x in r["ranks"])
    assert r["backend"] == "gloo" and r["peak_gib"] is None
    assert set(r["metrics"]) == set(r["one_metrics"]) == {"loss"}
    assert abs(r["metrics"]["loss"] - r["one_metrics"]["loss"]) <= (
        1e-5 + 2e-4 * abs(r["one_metrics"]["loss"]))
    assert 0 < r["dp_distance"] <= 3 * r["drift_distance"] < r["update_norm"]
    assert 0 < r["dp_grad_distance"] <= 3 * r["drift_grad_distance"] < r["grad_norm"]
    assert r["cut"] == "batch_norm" and r["cut_grad_distance"] > 3 * r["drift_grad_distance"]
