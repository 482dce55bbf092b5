"""The negative control of the contextual loss's feature mean ``y_mu`` in
the pSp step on two gloo ranks (tests/_torch_dp_worker.py), beside the
step with that sync.

The configuration of tests/test_torch_dp_psp.py with the contextual term
on (cx_lambda 1: computed and logged as ``loss_context``, not added, as the
reference does), on a batch whose two slices have references of far
different means: the first half's near mid-grey, the second's near white,
so each slice's VGG feature mean is far from the whole batch's. With the
sync the step holds the JAX data-parallel test's tolerances; without it
``loss_context`` misses the metrics' tolerance (rtol 2e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

from tests import _torch_dp_worker as worker
from tests.test_torch_dp_psp import N, _batch, _job


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _skewed():
    """``_batch()`` with the references of the first half (rank 0's slice)
    in [-0.025, 0.025] and of the second in [0.95, 1]."""
    batch = _batch()
    ref = (batch["ref_img"] + 1) / 2
    batch["ref_img"] = np.concatenate([0.05 * ref[:N // 2] - 0.025,
                                       0.95 + 0.05 * ref[N // 2:]]).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def context_runs(tmp_path_factory):
    context = dict(cx_lambda=1.0)
    runs = [dict(batch=_skewed(), loss=context), dict(batch=_skewed(), loss=context, off="y_mu")]
    return worker.run_ranks(tmp_path_factory.mktemp("psp_context_dp"), "psp", _job(runs))


def test_psp_dp_step_holds_y_mu_on_a_skewed_batch(context_runs):
    rank0, rank1 = (r[0] for r in context_runs)
    for kind in ("metrics", "params", "stats"):
        assert rank0["used"][kind] <= 1.0, (kind, rank0["used"])
    assert rank0["metrics"]["loss_context"] > 0.0
    assert rank0["metrics"] == rank1["metrics"] and rank1["replica_gap"] == 0.0


def test_psp_dp_step_misses_without_the_y_mu_sync(context_runs):
    rank0 = context_runs[0][1]
    got, want = rank0["metrics"]["loss_context"], rank0["metrics_one"]["loss_context"]
    assert rank0["used"]["metrics"] > 1.0 and abs(got - want) > 1e-5 + 2e-4 * abs(want)
