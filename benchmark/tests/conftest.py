"""Shared small configurations for the benchmark's CPU tests: the cells'
configurations and mix at the published structure but small widths and
images, so a run fits on a CPU in seconds."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import harness

CELLS = ("refill_flagship.offline_b128", "psp_config4.offline_b64")


def small(cell_name: str, dtype: str = "bfloat16") -> harness.Cell:
    """The cell with small widths, 64x64 images and batches of 4."""
    manifest = harness.load_manifest()
    full = harness.Cell(cell_name, manifest=manifest)
    config, mix = copy.deepcopy(full.config), copy.deepcopy(full.mix)
    config["dtype"] = dtype
    if config["pipeline"] == "refill_infer":
        config["encoder"].update(ngf=8, z_nc=16, img_f=32, L=2)
        config["decoder"].update(ngf=8, z_nc=16, img_f=64)
        config["out_size"] = 64
    else:
        config["psp"].update(output_size=64, num_layers=4, decoder_base_channels=64)
    mix.update(batch=4, height=64, width=64, check_rows=4, check_block=2, trace_batches=2,
               warmup_rounds=1)
    return harness.Cell(cell_name, manifest=manifest, config=config, mix=mix)


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
