"""A short run of each cell on the card, through run.py's entry: the result
line's keys, a correct check and the device named."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_short_run_on_the_card(cell_name, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs only on the card")
    rc = run.main(["--workload", cell_name, "--seed", "2147483659", "--seconds", "2",
                   "--trace", "0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
