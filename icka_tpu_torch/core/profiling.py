"""Profiling and tracing hooks (port of `icka_tpu.core.profiling`).

`annotate` marks a region in `torch.profiler` traces (and, for work on the
card, as an NVTX range for external tools); `trace` captures a trace of
the host and the card into a directory; `StepTimer` counts throughput with
the first steps excluded.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def annotate(name: str, device=None) -> Iterator[None]:
    """Decorator or context: a `torch.profiler.record_function` region
    named `name`, and an NVTX range of the same name when `device` is a
    CUDA device."""
    with torch.profiler.record_function(name):
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a trace of the host and, where there is one, the card into
    `log_dir` (a Chrome-trace JSON file per process, as
    `torch.profiler.tensorboard_trace_handler` names it). No-op when
    `log_dir` is None, so call sites can leave it wired in."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Wall-clock throughput accounting with compile-step exclusion."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._seen = 0
        self._t0 = None
        self._steps = 0
        self._items = 0

    def step(self, n_items: int = 1):
        self._seen += 1
        if self._seen <= self.skip_first:
            return
        if self._t0 is None:
            self._t0 = time.perf_counter()
            return
        self._steps += 1
        self._items += n_items

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self._steps == 0:
            return 0.0
        return self._items / (time.perf_counter() - self._t0)
