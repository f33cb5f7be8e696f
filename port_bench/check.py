"""Whether the timed path's step is correct: the program's first three
steps against the reference's, on the same weights and crops.

The numbers compared, each a gap between the program's reading and the
reference's, relative:

- ``loss_gap``: the largest over the three steps of |L - L_ref| / |L_ref|.
- ``grad_gap``: the first step's gradient as AdamW takes it (after the
  clip), by the worst leaf: | ||g|| - ||g_ref|| | over the larger of
  ||g_ref|| and the median leaf's ||g_ref||.
- ``change_gap``, ``teacher_change_gap``: the same of each leaf's change
  over the three steps, of the student and of the teacher (its EMA).
  Leaves whose first reference gradient is under a thousandth of the
  median leaf's are left out: Adam moves them by round-off alone.

A limit of null means the number is reported and not compared (PERF.md
says why).
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "teacher_change_gap")
QUIET = 1e-3


def _worst(values) -> float:
    """The largest, or inf where any is not a number."""
    values = list(values)
    return (math.inf if any(math.isnan(v) for v in values)
            else max(values))


def _gap_by_leaf(prog: dict, ref: dict, leave_out=()) -> float:
    names = [n for n in ref if n not in leave_out]
    median = statistics.median(ref[n] for n in names)
    return _worst(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
                  for n in names)


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """prog, ref: {'losses': [3 floats], 'grad': {leaf: norm},
    'change': {'student': {leaf: norm}, 'teacher': {leaf: norm}}}."""
    median = statistics.median(ref["grad"].values())
    quiet = {n for n, g in ref["grad"].items() if g < QUIET * median}
    return {
        "loss_gap": _worst(abs(a - b) / abs(b)
                           for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _gap_by_leaf(prog["grad"], ref["grad"]),
        "change_gap": _gap_by_leaf(prog["change"]["student"],
                                   ref["change"]["student"], quiet),
        "teacher_change_gap": _gap_by_leaf(prog["change"]["teacher"],
                                           ref["change"]["teacher"], quiet),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {'value', 'limit'}}): correct when every number
    with a limit is finite and within it, and some number has one."""
    out, ok = {}, True
    compared = 0
    for name in NUMBERS:
        v, lim = values.get(name), limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if lim is None:
            continue
        compared += 1
        if v is None or not (v <= lim):
            ok = False
    return ok and compared > 0, out
