"""Step -> value schedules (port of esvit_tpu/utils/schedules.py).

The values are computed in float32 with the reference's operation order,
so they equal the JAX schedules bit for bit; they are returned as Python
floats (exact copies of the float32 values).
"""

from __future__ import annotations

import math

import numpy as np

_f32 = np.float32


def cosine_schedule(step, *, base_value: float, final_value: float,
                    total_steps: int, warmup_steps: int = 0,
                    start_warmup_value: float = 0.0) -> float:
    """Linear warmup then half-cosine decay (utils.py:161-173): the warmup
    is ``np.linspace(start, base, warmup_steps)``, then
    ``final + 0.5*(base-final)*(1+cos(pi*i/n))`` with n = total - warmup."""
    step = _f32(step)
    n = max(total_steps - warmup_steps, 1)
    if step < warmup_steps:
        denom = max(warmup_steps - 1, 1)
        return float(_f32(start_warmup_value)
                     + _f32(base_value - start_warmup_value) * step / _f32(denom))
    i = step - _f32(warmup_steps)
    cos = np.cos(_f32(math.pi) * i / _f32(n), dtype=_f32)
    return float(_f32(final_value)
                 + _f32(0.5 * (base_value - final_value)) * (_f32(1.0) + cos))


def teacher_temp_schedule(epoch, *, warmup_teacher_temp: float,
                          teacher_temp: float,
                          warmup_teacher_temp_epochs: int) -> float:
    """Per-epoch linear ramp of the teacher temperature
    (main_esvit.py:614-618), then constant."""
    if epoch >= warmup_teacher_temp_epochs:
        return float(_f32(teacher_temp))
    denom = max(warmup_teacher_temp_epochs - 1, 1)
    return float(_f32(warmup_teacher_temp)
                 + _f32(teacher_temp - warmup_teacher_temp) * _f32(epoch)
                 / _f32(denom))
