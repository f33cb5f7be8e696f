"""Training metrics: windowed smoothing + periodic log lines + JSONL
(port of esvit_tpu/utils/metrics.py; ref utils.py:199-375).
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import time
from typing import Any, Iterable

import torch.distributed as dist


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.window = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return sum(self.window) / max(len(self.window), 1)

    @property
    def median(self) -> float:
        s = sorted(self.window)
        return s[len(s) // 2] if s else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return f"{self.median:.4f} ({self.global_avg:.4f})"


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kw):
        for k, v in kw.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue()
        data_time = SmoothedValue()
        end = time.time()
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_s = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i}/{total}] eta: {eta_s} {self} "
                          f"time: {iter_time} data: {data_time}", flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} "
                          f"data: {data_time}", flush=True)
            i += 1
            end = time.time()
        elapsed = str(datetime.timedelta(seconds=int(time.time() - start)))
        print(f"{header} Total time: {elapsed}", flush=True)

    def global_avgs(self) -> dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


def append_log(output_dir: str, record: dict[str, Any],
               filename: str = "log.txt") -> None:
    """JSON-lines epoch log, written by rank 0 only (main_esvit.py:489-493)."""
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, filename), "a") as f:
        f.write(json.dumps(record) + "\n")
