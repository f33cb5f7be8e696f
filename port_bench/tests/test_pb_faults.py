"""A run with the timed path broken underneath comes out not correct:
a step that returns its state unchanged, half the batch left out with the
mean over the rest, the exchange between processes left out (two ranks
over gloo); and the control, the reference with float8 products in the
program's place, fails the cell's own limits."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench import check, inputs, run, spec
from port_bench.reference import step as ref_step
from port_bench.reference.precision import FP8
from port_bench.tests import femto

SEED = 2 ** 31 + 3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    sound = run.run_cell(femto.cell(), SEED, 0.2, False, "cpu")
    assert sound["correct"]
    broken = run.run_cell(femto.cell(), SEED, 0.2, False, "cpu",
                          fault=fault)
    assert not broken["correct"], broken["checks"]


def _ranks(fault, world=2):
    port = str(run.free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "port_bench.tests.ranks", str(r), str(world),
         port, fault], cwd=spec.ROOT, stdout=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    return json.loads(outs[0].strip().splitlines()[-1])


def test_two_ranks_agree_with_the_global_batch_reference():
    assert _ranks("none")["correct"]


def test_leaving_out_the_exchange_is_not_correct():
    assert not _ranks("no_exchange")["correct"]


def test_the_control_fails_the_cells_limits():
    """The reference with float8 products in the program's place, at femto
    size, against the limits of the cell whose recipe it runs."""
    cell = femto.cell()
    limits = spec.cell(f"{femto.CONFIG}.{femto.TRAFFIC}").limits
    spec_ = ref_step.param_spec(cell.config, True)
    group = run.Group()
    ref = run.reference_readings(cell.config, cell.traffic, spec_, SEED,
                                 "cpu", group)
    ctl = run.reference_readings(cell.config, cell.traffic, spec_, SEED,
                                 "cpu", group, FP8)
    correct, checks = check.judge(check.numbers(ctl, ref), limits)
    assert not correct, checks
    assert inputs.stream_seed(SEED, 0) != inputs.stream_seed(SEED, 1)
