"""The metric arithmetic on synthetic step times and profiler events: a
rate over the whole window, a p90 over all steps, an idle share from a
union of intervals, a span's GPU timeline, the idle gaps' names."""

from __future__ import annotations

import statistics

import pytest

from port_bench import run, spec
from port_bench import trace as trace_lib
from port_bench.tests import femto


def _x(name, cat, ts_us, dur_us, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# Two steps of 100 us. Step 1: kernels 10-40 and 30-60 (overlap), launched
# inside esvit/loss (host 5-20); step 2: a kernel 120-150 launched in
# esvit/optimizer (host 110-115) and a copy 160-170.
EVENTS = [
    _x("port_bench/step", "user_annotation", 0, 100),
    _x("port_bench/step", "user_annotation", 100, 100),
    _x("esvit/loss", "user_annotation", 5, 15),
    _x("esvit/optimizer", "user_annotation", 110, 5),
    _x("cudaLaunchKernel", "cuda_runtime", 6, 1, corr=1),
    _x("cudaLaunchKernel", "cuda_runtime", 8, 1, corr=2),
    _x("cudaLaunchKernel", "cuda_runtime", 111, 1, corr=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 150, 1, corr=4),
    _x("fused_block_fwd_tc_kernel<4, 1>", "kernel", 10, 30, tid=7, corr=1),
    _x("void gemm_kernel", "kernel", 30, 30, tid=7, corr=2),
    _x("elementwise_kernel", "kernel", 120, 30, tid=7, corr=3),
    _x("Memcpy DtoH", "gpu_memcpy", 160, 10, tid=7, corr=4),
    {"ph": "i", "name": "marker", "ts": 0},
]


@pytest.fixture
def tr():
    return trace_lib.from_chrome(EVENTS)


def test_union_and_idle_share(tr):
    assert trace_lib.union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3),
                                                                (5, 7)]
    assert tr.window == pytest.approx((0.0, 200e-6))
    assert tr.busy_s() == pytest.approx(50e-6 + 30e-6 + 10e-6)
    # 90 us busy over 2 traced steps, against an untraced 300 us a step
    r = run.Readings({}, {}, 600e-6, [300e-6, 300e-6], [0.1, 0.2], tr)
    assert spec.reader("device_idle_share")(r) == pytest.approx(85.0)
    assert spec.reader("device_busy_ms")(r) == pytest.approx(45e-3)


def test_span_timeline_and_launches(tr):
    r = run.Readings({}, {}, 1.0, [0.5, 0.5], [0.1, 0.3, 0.2], tr)
    assert spec.reader("loss_device_ms")(r) == pytest.approx(50e-3 / 2)
    assert spec.reader("optimizer_device_ms")(r) == pytest.approx(15e-3)
    assert spec.reader("launches_per_step")(r) == 1.5
    assert spec.reader("host_enqueue_ms")(r) == pytest.approx(200.0)


def test_idle_gaps_are_named_by_the_launching_range(tr):
    gaps = dict(tr.idle_gaps())
    # 0-10: the next kernel was launched inside esvit/loss; 60-120 inside
    # esvit/optimizer; 150-160 inside no esvit range (the step's);
    # 170-200: no operation follows, the step's range holds its end
    assert gaps["esvit/loss"] == pytest.approx(10e-6)
    assert gaps["esvit/optimizer"] == pytest.approx(60e-6)
    assert gaps["port_bench/step"] == pytest.approx(40e-6)
    groups = dict(tr.group_s())
    assert groups["fused block (this repo's CUDA)"] == pytest.approx(30e-6)


def test_kernel_groups_are_the_port_profiles():
    from esvit_tpu_torch.utils.profile import _kernel_group

    names = ["fused_block_fwd_tc_kernel<4, 1>", "fused_bwd_t1", "wgrad_tc",
             "window_attention_fwd<FusedBlockBias>", "dbias_reduce",
             "sliding_chunk_fwd", "cudnn::conv", "nvjet_tst_128x64",
             "cutlass_80_gemm", "reduce_kernel", "layer_norm_kernel",
             "softmax_warp", "vectorized_elementwise_kernel"]
    for n in names:
        assert trace_lib.kernel_group(n) == _kernel_group(n)


def test_rate_and_p90_over_the_whole_window():
    steps = [0.1] * 18 + [0.3, 0.5]
    out = {"step_s": steps, "window_s": sum(steps), "setup_s": 3.0,
           "peak": 2 ** 31, "attempted": 20, "failed": 0, "correct": True,
           "per_layer": {}, "checks": {}}
    cell = femto.cell()
    line = run.result_line(cell, [out], False, "card")
    m = line["metrics"]
    assert m["train_img_per_s"]["value"] == pytest.approx(
        20 * cell.traffic["batch_per_card"] / 2.6)
    assert m["step_ms_p90"]["value"] == pytest.approx(
        1e3 * statistics.quantiles(steps, n=10)[8])
    assert m["peak_mem_gib"]["value"] == 2.0
    assert list(line)[-1] == "checks"


def test_the_profiler_records_only_the_steps_after_its_warm_up():
    import torch

    calls = []

    def step():
        with torch.profiler.record_function(trace_lib.STEP_SPAN):
            calls.append(float(torch.ones(8).sum()))

    tr = trace_lib.record(step, 2, 3,
                          [torch.profiler.ProfilerActivity.CPU])
    assert len(calls) == 5
    assert len(tr.steps) == 3
    assert tr.window_s > 0


def test_a_traced_run_on_the_cpu_reads_its_window():
    out = run.run_cell(femto.cell(), 2 ** 31 + 5, 0.2, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["trace_window_s"] > 0
    assert "host_enqueue_ms" in out["per_layer"]
    assert "step_mfu" in out["per_layer"]
