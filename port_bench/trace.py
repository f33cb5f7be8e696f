"""What a torch.profiler window of whole steps says about the device.

``record`` runs steps under the profiler (CPU and CUDA activities) on a
schedule that leaves its warm-up steps out, exports the Chrome trace of
the recorded steps to a file under TMPDIR, reads it and deletes it.
``Trace`` holds the events the per-layer readers use: the device's
kernels, copies and sets with their launches, the host's ranges
(``record_function``: the program's ``esvit/*`` spans and the
benchmark's ``port_bench/*`` ones), and the window, from the first
``port_bench/step`` range's start to the last one's end. Times are in
seconds.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from dataclasses import dataclass, field

STEP_SPAN = "port_bench/step"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def kernel_group(name: str) -> str:
    """A kernel's group by its demangled name: the rules of
    esvit_tpu_torch/utils/profile.py ``_kernel_group``, copied, with NCCL's
    kernels first in a group of their own (their time includes the wait
    for the other ranks)."""
    n = name.lower()
    if "nccl" in n:
        return "collectives (NCCL)"
    if "sliding_chunk" in n or "glo_reduce" in n:
        return "sliding chunk (this repo's CUDA)"
    if any(k in n for k in ("fusedblockbias", "fused_block", "fused_bwd",
                            "wgrad_tc", "sum_rows")):
        return "fused block (this repo's CUDA)"
    if "window_attention" in n or "dbias_reduce" in n:
        return "window attention (this repo's CUDA)"
    if any(k in n for k in ("cudnn", "conv", "fprop", "dgrad", "wgrad")):
        return "convolutions (cuDNN)"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "GEMM (cuBLAS)"
    if "reduce" in n or "norm" in n or "softmax" in n:
        return "reductions / norms / softmax"
    return "elementwise / copies / other"


@dataclass
class Op:
    name: str
    start: float
    end: float
    cat: str = ""
    launch: float | None = None     # host time of its launch call
    tid: int | None = None          # host thread of its launch


@dataclass
class Trace:
    device_ops: list[Op]            # kernels, copies, sets; by start
    spans: list[Op]                 # host ranges, by start
    steps: list[Op] = field(default_factory=list)

    @property
    def window(self) -> tuple[float, float]:
        return self.steps[0].start, self.steps[-1].end

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def in_window(self) -> list[Op]:
        lo, hi = self.window
        return [o for o in self.device_ops if o.end > lo and o.start < hi]

    def kernels(self) -> list[Op]:
        return [o for o in self.in_window() if o.cat == "kernel"]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's operations, clipped to the window."""
        lo, hi = self.window
        return union((max(o.start, lo), min(o.end, hi))
                     for o in self.in_window())

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def span_device_s(self, name: str) -> float:
        """The device's busy time for every range ``name`` in the window,
        summed: the union of the device operations launched inside it on
        its own thread. (Its GPU-timeline length, first start to last end,
        would count the device's waits for the host as well, which the
        profiler's own host cost stretches.)"""
        lo, hi = self.window
        ops = [o for o in self.device_ops if o.launch is not None]
        total = 0.0
        for s in self.spans:
            if s.name != name or s.start < lo or s.end > hi:
                continue
            total += sum(b - a for a, b in union(
                (o.start, o.end) for o in ops
                if o.tid == s.tid and s.start <= o.launch <= s.end))
        return total

    def innermost_span(self, t: float) -> str:
        """The shortest host range holding time t, of any thread."""
        best = None
        for s in self.spans:
            if s.start > t:
                break
            if s.end >= t and (best is None or
                               s.end - s.start < best.end - best.start):
                best = s
        return best.name if best is not None else "(no range)"

    def idle_gaps(self) -> list[tuple[str, float]]:
        """The device's idle time in the window, summed by the host range
        that was launching the operation that ended each gap."""
        lo, hi = self.window
        busy = self.busy()
        ops = sorted(self.in_window(), key=lambda o: o.start)
        keys = [o.start for o in ops]
        out: collections.Counter = collections.Counter()
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            i = bisect.bisect_left(keys, b)
            op = ops[i] if i < len(ops) else None
            when = op.launch if op is not None and op.launch else b
            out[self.innermost_span(when)] += b - a
        return out.most_common()

    def group_s(self) -> list[tuple[str, float]]:
        out: collections.Counter = collections.Counter()
        for o in self.kernels():
            out[kernel_group(o.name)] += o.end - o.start
        return out.most_common()


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def from_chrome(events: list[dict]) -> Trace:
    """A Trace from the events of torch.profiler's Chrome trace."""
    launches = {}
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat == "cuda_runtime" or cat == "cuda_driver":
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
        elif cat in DEVICE_CATS:
            device.append((corr, Op(e.get("name", ""), ts, ts + dur, cat)))
        elif cat == "user_annotation":
            spans.append(Op(e.get("name", ""), ts, ts + dur, cat,
                            tid=e.get("tid")))
    ops = []
    for corr, op in device:
        if corr in launches:
            op.launch, op.tid = launches[corr]
        ops.append(op)
    ops.sort(key=lambda o: o.start)
    spans.sort(key=lambda o: o.start)
    steps = [s for s in spans if s.name == STEP_SPAN]
    return Trace(ops, spans, steps)


def record(step, warmup: int, steps: int, activities) -> Trace:
    """Profile ``warmup + steps`` calls of ``step()`` and read the trace of
    the last ``steps``: the profiler's own start-up and first steps fall
    in the ``warmup`` steps, which it runs and does not record."""
    import torch

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(
                activities=activities,
                schedule=torch.profiler.schedule(wait=0, warmup=warmup,
                                                 active=steps, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)
        ) as prof:
            for _ in range(warmup + steps):
                step()
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return from_chrome(events)
