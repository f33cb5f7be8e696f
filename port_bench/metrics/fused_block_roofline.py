"""The block-fused kernels' share (%) of their roofline: the bound time
of one step's fused-block calls (counts.fused_block_bound_s) over the
device time per traced step of the kernels that the profiler groups as
"fused block"."""

from port_bench import counts
from port_bench.trace import kernel_group

GROUP = "fused block (this repo's CUDA)"


def read(r):
    if r.trace is None or not r.trace.steps:
        return None
    busy = sum(o.end - o.start for o in r.trace.kernels()
               if kernel_group(o.name) == GROUP)
    if busy <= 0:
        return None
    per_step = busy / len(r.trace.steps)
    return 100.0 * counts.fused_block_bound_s(r.config, r.traffic) / per_step
