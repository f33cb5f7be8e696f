"""On the card: the control at a cell's own size, on three seeds, fails
the cell's limits, and the program passes them on the same seeds."""

from __future__ import annotations

import pytest
import torch

from port_bench import calibrate, check, run, spec
from port_bench.reference.precision import FP8, no_tf32

CELL = "swin_t_w7.ddino.b32"
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    no_tf32()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_and_program_passes_at_the_cells_size(card, seed):
    cell = spec.cell(CELL)
    group = run.Group()
    ref = calibrate.reference_side(cell, seed, card, group)
    ctl = calibrate.reference_side(cell, seed, card, group, FP8)
    prog = calibrate.program_side(cell, seed, card, group)
    assert not check.judge(check.numbers(ctl, ref), cell.limits)[0]
    assert check.judge(check.numbers(prog, ref), cell.limits)[0]
