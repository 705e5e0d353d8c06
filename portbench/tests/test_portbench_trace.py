"""The trace readers on hand-made records: busy time is a union of
intervals, gaps lie between the merged intervals, kernel records are
counted by name."""

from __future__ import annotations

from portbench import trace

DEVICE = [("k1", 0, 10), ("copy", 5, 12), ("k2", 20, 25), ("k1", 22, 30),
          ("set", 40, 41)]


def test_busy_is_a_union():
    assert trace.busy_ns(DEVICE) == 12 + 10 + 1
    assert trace.busy_ns([]) == 0


def test_gaps_between_merged_intervals():
    assert trace.gaps(DEVICE).tolist() == [[12, 8], [30, 10]]


def test_counts_and_ops():
    assert trace.count(DEVICE, "k1") == (2, 18e-9)
    assert trace.device_ops(DEVICE, top=1) == [["k1", 18e-9]]


def test_idle_gaps_named_by_span_and_host_op():
    host = [("aten::mm", 11, 19), ("aten::copy_", 13, 15),
            ("cudaLaunchKernel", 31, 32)]
    spans = [("text", 0, 35)]
    got = dict(trace.idle_gaps(DEVICE, host, spans))
    assert got == {"text: aten::mm": 8e-9, "text: no op": 10e-9}
