"""The traced run's device records: one `torch.profiler` session over the
whole window, read from the profiler's raw kineto events (grouping them
with `key_averages` costs tens of seconds at these counts).

Device records are the kernels, copies and sets the profiler kept
(`DeviceType.CUDA`, user annotations left out: the benchmark puts none in
the window). Busy time is the union of their intervals, not their sum,
since records of two streams can overlap.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np

SPAN = "portbench."


@contextlib.contextmanager
def session():
    """A profiler over the block: yields a dict that holds, after the
    block, "device" and "host" [(name, start_ns, end_ns)] records and
    "spans", the host-side records of the benchmark's own `span` regions
    (their device-side annotations are dropped)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        yield out
        if cuda:
            torch.cuda.synchronize()
    device, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            if e.device_type() == DeviceType.CPU \
                    and e.name().startswith(SPAN):
                spans.append((e.name()[len(SPAN):], e.start_ns(),
                              e.end_ns()))
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), e.start_ns(), e.end_ns()))
    out["device"] = device
    out["host"] = host
    out["spans"] = spans


def span(name: str, traced: bool):
    """A region of the window named on the profiler's timeline (a no-op
    when the run is not traced)."""
    if not traced:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(SPAN + name)


def busy_ns(device) -> int:
    """Length of the union of the records' intervals."""
    if not device:
        return 0
    iv = np.array([(s, e) for _, s, e in device], dtype=np.int64)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    starts = iv[:, 0]
    # a new merged interval starts where a record begins after every
    # earlier record has ended
    new = np.ones(len(iv), bool)
    new[1:] = starts[1:] > ends[:-1]
    idx = np.flatnonzero(new)
    seg_end = np.append(ends[idx[1:] - 1], ends[-1])
    return int((seg_end - starts[idx]).sum())


def gaps(device):
    """(start_ns, length_ns) of every idle interval between the merged
    device intervals."""
    if not device:
        return np.zeros((0, 2), np.int64)
    iv = np.array([(s, e) for _, s, e in device], dtype=np.int64)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    g_start, g_end = ends[:-1], iv[1:, 0]
    keep = g_end > g_start
    return np.stack([g_start[keep], (g_end - g_start)[keep]], axis=1)


def device_ops(device, top: int = 10):
    """[[name, seconds]] of the `top` device records by total time."""
    ns = collections.Counter()
    for name, s, e in device:
        ns[name] += e - s
    return [[name, t / 1e9] for name, t in ns.most_common(top)]


def idle_gaps(device, host, spans, top: int = 10, longest: int = 400):
    """[[what the host was doing, seconds]] over the `longest` idle gaps,
    the `top` by total seconds. What the host did: the benchmark's span
    around the gap (`spans`, [(name, start_ns, end_ns)] on the profiler's
    clock) and the innermost host operation open at the gap's start, or
    "no op" between operations."""
    g = gaps(device)
    if not len(g):
        return []
    g = g[np.argsort(-g[:, 1])[:longest]]
    hs = np.array([s for _, s, _ in host], np.int64)
    he = np.array([e for _, _, e in host], np.int64)
    names = [n for n, _, _ in host]
    total = collections.Counter()
    for start, length in g:
        span = next((n for n, s, e in spans if s <= start < e), "between")
        open_ = np.flatnonzero((hs <= start) & (he > start))
        op = names[open_[np.argmax(hs[open_])]] if len(open_) else "no op"
        total[f"{span}: {op}"] += int(length)
    return [[k, v / 1e9] for k, v in total.most_common(top)]


def count(device, pattern: str) -> tuple[int, float]:
    """(records, seconds) of the device records whose name holds
    `pattern`."""
    ns = [e - s for name, s, e in device if pattern in name]
    return len(ns), sum(ns) / 1e9
