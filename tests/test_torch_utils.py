"""The port's host helpers (`icka_tpu_torch.utils`) against the JAX
package's `icka_tpu.utils` on the CPU: the smoothed series and the metric
logger equal on one series, the scalar writer's JSONL fallback, seeding,
ranks without a process group and the logger."""

import json
import logging
import random
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from icka_tpu.utils import metric_logger as jml  # noqa: E402
from icka_tpu.utils import misc as jmisc  # noqa: E402
from icka_tpu_torch.utils import metric_logger as tml  # noqa: E402
from icka_tpu_torch.utils import misc as tmisc  # noqa: E402

SERIES = [3.5, -1.0, 2.25, 8.0, 0.5, 4.0, 4.0, 7.75, -2.5, 1.0, 6.0]


@pytest.mark.parametrize("window", [1, 4, 20])
def test_smoothed_value_equals_jax(window):
    got, want = tml.SmoothedValue(window), jml.SmoothedValue(window)
    for prop in ("median", "avg", "global_avg", "last"):   # empty
        assert getattr(got, prop) == getattr(want, prop) == 0.0
    for v in SERIES:
        got.update(v)
        want.update(v)
        for prop in ("median", "avg", "global_avg", "last"):
            assert getattr(got, prop) == getattr(want, prop), prop
    assert list(got.deque) == list(want.deque)
    assert (got.count, got.total) == (want.count, want.total)


def test_metric_logger_equals_jax():
    got, want = tml.MetricLogger(" | "), jml.MetricLogger(" | ")
    for i, v in enumerate(SERIES):
        for m in (got, want):
            m.update(loss=v, lr=np.float32(1e-3 * i))
    assert str(got) == str(want)
    assert got.loss.median == want.loss.median
    with pytest.raises(AttributeError):
        got.missing


def test_scalar_writer_falls_back_to_jsonl(tmp_path, monkeypatch):
    """Without `torch.utils.tensorboard` it appends one JSON line per
    metric and step: the last, windowed mean and median values."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = tml.ScalarWriter(str(tmp_path / "logs"), window_size=2)
    for step, v in enumerate((1.0, 3.0, 8.0)):
        w.update(step, loss=v)
    w.close()
    rows = [json.loads(line) for line in
            (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()]
    assert [(r["step"], r["metric"], r["last"], r["avg"], r["median"])
            for r in rows] == [(0, "loss", 1.0, 1.0, 1.0),
                               (1, "loss", 3.0, 2.0, 2.0),
                               (2, "loss", 8.0, 5.5, 5.5)]


def test_set_seed_seeds_random_numpy_and_torch():
    draws = []
    for _ in range(2):
        tmisc.set_seed(11)
        draws.append((random.random(), np.random.rand(), torch.rand(3)))
    assert draws[0][:2] == draws[1][:2]
    assert torch.equal(draws[0][2], draws[1][2])
    jmisc.set_seed(11)
    assert (random.random(), np.random.rand()) == draws[0][:2]


def test_ranks_without_a_process_group():
    assert tmisc.get_rank() == 0 and tmisc.get_world_size() == 1
    assert tmisc.is_main_process()


def test_mkdir_and_logger(tmp_path, capsys):
    path = tmp_path / "a" / "b"
    tmisc.mkdir(str(path))
    tmisc.mkdir(str(path))                   # exists: no error
    log = tmisc.setup_logger("icka_tpu_torch.test_utils", str(path))
    log.info("hello")
    assert "hello" in (path / "log.txt").read_text()
    assert "hello" in capsys.readouterr().out
    quiet = tmisc.setup_logger("icka_tpu_torch.test_utils.rank1",
                               str(tmp_path / "r1"), distributed_rank=1)
    assert quiet.handlers == [] and not (tmp_path / "r1").exists()
    for h in log.handlers:
        h.close()
    log.handlers.clear()
    assert isinstance(quiet, logging.Logger)
