"""The control: the reference in float32 in the program's place must come
out not correct, on three seeds.  On the CPU at a small size; on the card
(the ``cuda`` marker) at each cell's own size, as many requests as a run."""

import pytest

from portbench import control
from small import ROOT, small_cell

CELLS = ["dense-768x1536.dual-resolve"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_small(workload):
    _, cell, config = small_cell(workload)
    for seed in (1, 2, 2**31 + 3):
        attempted, failed, worst = control.control_run(ROOT, workload, seed, 2, "cpu", cell, config)
        assert attempted > 0 and failed > 0  # the run would read correct = false
        assert any(worst[k] > cell["limits"][k] for k in worst)


REQUESTS = {"dense-768x1536.dual-resolve": 48}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (4001, 4002, 4003):
        attempted, failed, _ = control.control_run(ROOT, workload, seed, REQUESTS[workload],
                                                   "cuda")
        assert attempted > 0 and failed > 0
