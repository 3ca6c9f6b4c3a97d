"""Metric logging: SmoothedValue / MetricLogger with JSONL output.
Counterpart of `mspi_tpu/utils/logging.py` (reference utils/log.py:18-175),
the same plain Python. The reference syncs its meters with
dist.all_reduce; the port's train steps return metrics already averaged
over the data group (`train.engine.average_over_data`), so
`synchronize_between_processes` is a no-op here too.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional


class SmoothedValue:
    """Windowed median/avg + global average (utils/log.py:18-76)."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        if not self.deque:
            return 0.0
        s = sorted(self.deque)
        return s[len(s) // 2]

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / self.count if self.count else 0.0

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with ETA (utils/log.py:79-175)."""

    def __init__(self, delimiter: str = " "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self):
        pass  # the steps' metrics are already the data group's means

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total:
                    eta = datetime.timedelta(seconds=int(iter_time.global_avg * (total - i)))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} "
                          f"time: {iter_time} data: {data_time}", flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start_time
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}", flush=True)

    def stats(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


def append_jsonl(path: str, record: dict):
    """Per-epoch JSON-lines stats (train.py:199-200)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(record) + "\n")
