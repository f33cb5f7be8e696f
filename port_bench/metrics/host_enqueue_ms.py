"""Median host time (ms) from the call of train_step to its return,
before the loss is read, over the untraced window's steps."""

import statistics


def read(r):
    if not r.enqueue_s:
        return None
    return 1e3 * statistics.median(r.enqueue_s)
