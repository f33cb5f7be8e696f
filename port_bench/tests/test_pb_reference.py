"""The frozen reference against the port's plain CPU route at femto size,
on the benchmark's own weights and crops."""

from __future__ import annotations

import pytest
import torch

from port_bench import inputs, run
from port_bench.program import Program
from port_bench.reference import step as ref_step
from port_bench.tests import femto

SEED = 2 ** 31 + 7


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("region_task", [True, False])
def test_forward_matches_the_port(region_task):
    cell = femto.cell(region_task=region_task)
    spec_ = ref_step.param_spec(cell.config, region_task)
    weights = inputs.make_weights(spec_, SEED, "cpu")
    prog = Program(cell.config, cell.traffic, "cpu")
    prog.load(weights)
    ref = ref_step.build(cell.config, region_task, "cpu")
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(weights[n])
    crops = inputs.make_crops(cell.traffic, SEED, 0, 0, "cpu")
    b = cell.traffic["batch_per_card"]
    with torch.no_grad():
        got = prog.state.student(crops, deterministic=True, batch_size=b)
        cls, region, fea = ref(crops, b)
    want_cls = torch.cat(cls)
    if not region_task:
        torch.testing.assert_close(got, want_cls, rtol=1e-5, atol=1e-5)
        return
    torch.testing.assert_close(got[0], want_cls, rtol=1e-5, atol=1e-5)
    # the port's region rows are batch-major over the views
    torch.testing.assert_close(got[1], torch.cat(region, dim=1),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], torch.cat(fea, dim=1), rtol=1e-5,
                               atol=1e-5)


def test_stochastic_depth_takes_the_same_draws_on_both_sides():
    """The student's forward with the seed's stochastic-depth draws: the
    port's blocks take them through DropPath.keep_mask, the reference's
    from its input; both drop the same branches."""
    cell = femto.cell()
    spec_ = ref_step.param_spec(cell.config, True)
    weights = inputs.make_weights(spec_, SEED, "cpu")
    prog = Program(cell.config, cell.traffic, "cpu")
    prog.load(weights)
    ref = ref_step.build(cell.config, True, "cpu")
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(weights[n])
    crops = inputs.make_crops(cell.traffic, SEED, 0, 0, "cpu")
    draws = inputs.make_drop_draws(cell.config, cell.traffic, SEED, 0, 0,
                                   "cpu")
    b = cell.traffic["batch_per_card"]
    with torch.no_grad(), prog._drop_draws(draws):
        got = prog.state.student(crops, deterministic=False, batch_size=b)
    with torch.no_grad():
        cls, region, _ = ref(crops, b, draws)
        kept, _, _ = ref(crops, b)
    torch.testing.assert_close(got[0], torch.cat(cls), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], torch.cat(region, dim=1), rtol=1e-5,
                               atol=1e-5)
    assert not torch.allclose(torch.cat(cls), torch.cat(kept), atol=1e-3)


@pytest.mark.parametrize("region_task", [True, False])
def test_three_steps_agree_in_float32(region_task, monkeypatch):
    # the reference in blocks of 3 of the 4 images: a whole and a part
    monkeypatch.setattr(run, "REFERENCE_CHUNK", 3)
    out = run.run_cell(femto.cell(region_task=region_task), SEED, 0.2,
                       False, "cpu")
    assert out["correct"], out["checks"]
    assert out["checks"]["loss_gap"]["value"] < 1e-6


def test_bfloat16_program_reads_above_float32():
    f32 = run.run_cell(femto.cell(), SEED, 0.2, False, "cpu")["checks"]
    bf16 = run.run_cell(femto.cell("bfloat16"), SEED, 0.2, False,
                        "cpu")["checks"]
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert bf16[name]["value"] > 10 * f32[name]["value"]
