"""A whole run with the timed path broken underneath comes out not correct:
once for each fault an inference cell can have. The run skips the
harness's look for a card (it runs on the CPU at small widths); the step
itself is the port's, wrapped."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, run
from benchmark.tests.conftest import CELLS, small


def half_batch_left_out(step):
    """The first half of the batch is computed; the second half gets its
    results again."""
    def broken(batch):
        n = batch["src"].shape[0]
        images, masks = step({k: v[: n // 2] for k, v in batch.items()})
        return torch.cat([images, images]), torch.cat([masks, masks])
    return broken


def answers_shifted(step):
    """Each image's answers handed to the next request of the batch."""
    def broken(batch):
        images, masks = step(batch)
        return images.roll(1, dims=0), masks.roll(1, dims=0)
    return broken


def image_altered(step):
    """The upper half of each generated image overwritten where it is
    produced."""
    def broken(batch):
        images, masks = step(batch)
        images = images.clone()
        images[:, : images.shape[1] // 2] = 0.0
        return images, masks
    return broken


def mask_altered(step):
    """A quarter of each detected mask inverted where it is produced."""
    def broken(batch):
        images, masks = step(batch)
        masks = masks.clone()
        h, w = masks.shape[1:]
        masks[:, : h // 2, : w // 2] = 1.0 - masks[:, : h // 2, : w // 2]
        return images, masks
    return broken


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(cell_name):
    res = harness.run_cell(small(cell_name), 11, 0.5, False, "cpu")
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"images_per_s", "batch_p90_ms", "setup_s"}


@pytest.mark.parametrize("fault", [half_batch_left_out, answers_shifted, image_altered,
                                   mask_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", CELLS)
def test_fault_is_not_correct(cell_name, fault):
    res = harness.run_cell(small(cell_name), 11, 0.5, False, "cpu", fault=fault)
    assert not res["correct"], res["checks"]


def test_traced_run_reports_per_layer_metrics():
    res = harness.run_cell(small(CELLS[0]), 13, 0.5, True, "cpu")
    assert res["correct"]
    assert {"enqueue_ms", "cli_copy_ms", "mfu"} <= set(res["metrics"])
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_refuses_without_cuda(capsys):
    """run.py exits non-zero and prints no result where CUDA is missing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
