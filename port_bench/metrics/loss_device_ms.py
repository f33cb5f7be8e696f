"""Device busy time (ms) per traced step of the program's
``esvit/loss``: the loss (losses.py): the union of the device operations
launched inside the range. Nothing where it launched none."""

SPAN = "esvit/loss"


def read(r):
    if r.trace is None or not r.trace.steps:
        return None
    if not any(s.name == SPAN for s in r.trace.spans):
        return None
    ms = 1e3 * r.trace.span_device_s(SPAN) / len(r.trace.steps)
    return ms if ms > 0 else None
