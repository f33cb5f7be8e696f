"""Device busy time (ms) per traced step: the union of the device's
operations over the traced window, over its steps. Unlike the idle share
it does not stretch with the profiler's own host cost; against the
untraced step time (``step_ms_p90``, the rate) it gives the share of a
step that the card works."""


def read(r):
    if r.trace is None or not r.trace.steps or not r.trace.kernels():
        return None
    return 1e3 * r.trace.busy_s() / len(r.trace.steps)
