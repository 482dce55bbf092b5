"""The pSp step on two gloo ranks (tests/_torch_dp_worker.py) against the
port's one-process step on the global batch.

The configuration of tests/test_dp_equivalence_bc.py: the encoder alone
trained, SGD at 1e-3, 32^2 with ``resize=False``, global batch 8, the L2,
LPIPS, their reference-side twins and the W-norm, with the PSP of
tests/test_torch_psp_train.py (num_layers=4, decoder_base_channels=32,
attention, the latent average). The weights are drawn from a seed on every
rank, the noise weights at 0.5 and the noise randomized, drawn from a
generator seeded alike on every rank, so the IR-SE encoder's BatchNorm
moments and StyleGAN2's noise are both on the path. The port's
one-process step is held against the JAX step in
tests/test_torch_psp_train.py, so this closes the chain to JAX.

- The step: the loss dict at rtol 2e-4 atol 1e-5, the encoder's parameters
  at rtol 5e-3 atol 2.5e-4 and its running statistics at rtol 1e-4 atol
  1e-5 (the JAX data-parallel test's tolerances), the decoder unchanged.
- A NaN in rank 1's slice: both ranks skip, as the one-process step on the
  whole batch does.
- A negative control: the noise drawn at the slice's shape misses.
- Without a group the step enters no collective.
"""

import numpy as np
import pytest
import torch

from face_mask_inpaint_tpu_torch.losses.psp_loss import PSPLossConfig
from face_mask_inpaint_tpu_torch.parallel import dist as pdist
from face_mask_inpaint_tpu_torch.train.psp import make_psp_train_step, partition_params
from tests import _torch_dp_worker as worker

SMALL = dict(output_size=32, num_layers=4, decoder_base_channels=32, use_attention=True,
             start_from_latent_avg=True)
LOSS = dict(id_lambda=0.0, l2_lambda=1.0, lpips_lambda=0.1, style_lambda=0.0, cx_lambda=0.0,
            l2_lambda_ref=1.0, lpips_lambda_ref=0.1, w_norm_lambda=0.01,
            start_from_latent_avg=True)
N, HW = 8, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(nan=False):
    rng = np.random.RandomState(0)
    batch = {k: (rng.rand(N, HW, HW, 3) * 2 - 1).astype(np.float32)
             for k in ("src_img", "ref_img", "gt_img")}
    batch["mask"] = (rng.rand(N, HW, HW) > 0.5).astype(np.float32)
    if nan:
        batch["gt_img"][N - 1, 3, 5, 1] = np.nan  # in rank 1's slice
    return batch


def _job(runs):
    return dict(small=SMALL, loss=LOSS, lr=1e-3, seed=0, noise_seed=4, runs=runs)


@pytest.fixture(scope="module")
def psp_runs(tmp_path_factory):
    runs = [dict(batch=_batch()), dict(batch=_batch(nan=True)),
            dict(batch=_batch(), off="noise")]
    return worker.run_ranks(tmp_path_factory.mktemp("psp_dp"), "psp", _job(runs))


def test_psp_dp_step_matches_one_process_step(psp_runs):
    rank0, rank1 = (r[0] for r in psp_runs)
    for kind in ("metrics", "params", "stats"):
        assert rank0["used"][kind] <= 1.0, (kind, rank0["used"])
    assert rank0["metrics"] == rank1["metrics"] and rank1["replica_gap"] == 0.0
    for k in ("loss_l2", "loss_lpips", "loss_l2_ref", "loss_lpips_ref", "loss_w_norm"):
        assert rank0["metrics"][k] > 0.0, k
    for m in (rank0["metrics"], rank0["metrics_one"]):
        assert m["skipped_nonfinite"] == 0.0 and m["decoder_frozen"] == 1.0


def test_psp_dp_step_skips_together_on_a_nan(psp_runs):
    """A NaN in rank 1's slice only: the guard decides on the ranks' mean
    loss, so both ranks skip and keep their parameters, as the one-process
    step on the whole batch does."""
    rank0, rank1 = (r[1] for r in psp_runs)
    for m in (rank0["metrics"], rank1["metrics"], rank0["metrics_one"]):
        assert m["skipped_nonfinite"] == 1.0 and not np.isfinite(m["loss"])
    assert rank0["used"]["params"] == 0.0 and rank1["replica_gap"] == 0.0


def test_psp_dp_step_misses_without_the_noise_sync(psp_runs):
    rank0 = psp_runs[0][2]
    assert max(rank0["used"].values()) > 1.0, rank0["used"]


def test_psp_step_without_a_group_enters_no_collective(monkeypatch):
    """W = 1: no process group, no collective, no active group; two runs
    from one state with randomized noise agree bit for bit."""
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
        psp, lp = worker.psp_models(_job([]))
        named = partition_params(psp, False)
        step = make_psp_train_step(psp, torch.optim.SGD([p for _, p in named], lr=1e-3),
                                   PSPLossConfig(**LOSS), {"lpips": lp}, resize=False)
        metrics = step(batch, noise=torch.Generator().manual_seed(4))
        results.append((metrics, {n: p.detach().clone() for n, p in named}))
        del psp, lp, step
    assert seen and all(g is None for g in seen)
    assert all(torch.equal(v, results[1][0][k]) for k, v in results[0][0].items())
    assert all(torch.equal(v, results[1][1][k]) for k, v in results[0][1].items())
