"""Device idle share (%) of the program's own step: 1 minus the device's
busy time a step (the union of its operations over the traced steps)
over the untraced window's time a step. The traced window's own idle
share would read the profiler's host cost a launch, which stretches a
host-paced step; the device's busy time does not stretch with it."""


def read(r):
    if r.trace is None or not r.trace.steps or not r.trace.kernels():
        return None
    busy = r.trace.busy_s() / len(r.trace.steps)
    return 100.0 * (1.0 - busy * r.window_steps / r.window_s)
