"""Checks that need the card: every cell at a small size through the
kernels, its result line naming the card. Run on the card with
`python -m pytest perfbench -m cuda`; they skip without one."""

import json
import time

import pytest
import torch

from perfbench import run
from perfbench.test_perfbench_run import CELLS, SIZES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, capsys, cell, trace):
    rc = run.main(["--workload", cell, "--seed", "77", "--seconds", "1",
                   "--trace", str(trace)], sizes=SIZES[cell],
                  t_start=time.perf_counter())
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(card)
    if trace:
        assert line["device"]["busy_s"] > 0
