"""Training observability (port of `icka_tpu.utils.metric_logger`):
`SmoothedValue` keeps a sliding window with median and average views and a
global average; `MetricLogger` aggregates named series and formats them;
`ScalarWriter` streams each metric's last, average and median values to a
TensorBoard event file when `torch.utils.tensorboard` imports, else to
`scalars.jsonl` in the log directory."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(float(value))
        self.count += 1
        self.total += float(value)

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        mid = n // 2
        return d[mid] if n % 2 else 0.5 * (d[mid - 1] + d[mid])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def last(self) -> float:
        return self.deque[-1] if self.deque else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())


class ScalarWriter:
    """last/avg/median scalar streams per metric (TensorboardLogger
    equivalent). Falls back to JSONL when tensorboard isn't available."""

    def __init__(self, log_dir: str, window_size: int = 20):
        os.makedirs(log_dir, exist_ok=True)
        self.meters: dict[str, SmoothedValue] = defaultdict(
            lambda: SmoothedValue(window_size))
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def update(self, step: int, **kwargs):
        for k, v in kwargs.items():
            m = self.meters[k]
            m.update(float(v))
            values = {"last": m.last, "avg": m.avg, "median": m.median}
            if self._tb is not None:
                for suffix, val in values.items():
                    self._tb.add_scalar(f"{k}/{suffix}", val, step)
            else:
                self._jsonl.write(json.dumps(
                    {"step": step, "metric": k, "ts": time.time(),
                     **values}) + "\n")
                self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        elif hasattr(self, "_jsonl"):
            self._jsonl.close()
