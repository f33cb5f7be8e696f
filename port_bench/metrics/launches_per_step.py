"""Device kernels launched per traced step."""


def read(r):
    if r.trace is None or not r.trace.steps or not r.trace.kernels():
        return None
    return len(r.trace.kernels()) / len(r.trace.steps)
