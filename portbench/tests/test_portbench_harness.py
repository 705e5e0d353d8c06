"""The harness end to end on the CPU at a tiny size, through the port's
plain path: the result line, cells added by files alone, the control and
the faults that `correct` has to catch."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.bench_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    """The tiny cells with every device batch full (16 pairs a call in
    one bucket of 4-row batches) and 16 pairs compared."""
    root = tiny.bench_root(tmp_path_factory.mktemp("full"))
    (root / "portbench/traffic/tiny.json").write_text(json.dumps(
        dict(tiny.TRAFFIC, pairs_per_call=16,
             lengths={"kind": "uniform", "min": 5, "max": 14})))
    for name in ("tiny_icka", "tiny_gate_cl"):
        path = root / "portbench/configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["check"]["pairs"] = 16
        path.write_text(json.dumps(cfg))
    return root


def _run(root, cell, traced=False, **kw):
    return run.run_cell(run.Catalog.at(root), cell, SEED, 0.3, traced, CPU,
                        **kw)


@pytest.mark.parametrize("cell", ["tiny.icka", "tiny.gate_cl"])
@pytest.mark.parametrize("traced", [False, True])
def test_cell_prints_a_valid_result(root, cell, traced):
    result, lines = _run(root, cell, traced)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= tiny.TRAFFIC["pairs_per_call"]
    names = set(line["metrics"])
    if traced:
        assert {"batch_fill", "step_mfu", "visual_ms_per_kpair",
                "text_ms_per_kpair"} <= names
        assert "pairs_per_s" not in names
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == {"pairs_per_s", "call_p95_ms", "setup_s"}
    for v in line["metrics"].values():
        assert v["value"] > 0
    assert lines[-2].startswith("check failed_pairs")
    assert all(k in line["checks"] for k in ("visual_err", "emis_err",
                                             "tag_gap"))


SERVER_MODULE = """
from icka_tpu_torch.serving.bucketed import BucketedGateCLServer


class TwoRowGateCLServer(BucketedGateCLServer):
    \"\"\"Another server class: every bucket's batch is two rows.\"\"\"

    def _batch_of(self, bucket):
        return 2
"""


def test_a_cell_added_by_files_alone(tmp_path, monkeypatch):
    """A new configuration (naming another server class and a server
    protocol of its own), a traffic mix of varied call sizes, a histogram
    of lengths and shared images, a cell and a per-layer metric are new
    files in a benchmark root; no existing file changes."""
    reader = ("def read(r):\n"
              "    return 100.0 * sum(c['n'] for c in r.calls) / r.pairs\n")
    root = tiny.bench_root(tmp_path, {"dummy_share": reader})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "portbench/traffic/stream.json").write_text(json.dumps(
        dict(tiny.TRAFFIC, pairs_per_call={"min": 2, "max": 5}, cycle=4,
             image_reuse=0.3,
             lengths={"kind": "table", "lengths": [5, 9, 17, 30],
                      "weights": [1, 4, 2, 1]})))
    (root / "extra_servers.py").write_text(SERVER_MODULE)
    monkeypatch.syspath_prepend(str(root))
    (root / "portbench/servers/bucketed_two.py").write_text(
        (root / "portbench/servers/bucketed.py").read_text())
    cfg = json.loads((root / "portbench/configs/tiny_gate_cl.json")
                     .read_text())
    cfg["server"].update({"class": "extra_servers.TwoRowGateCLServer",
                          "protocol": "bucketed_two"})
    (root / "portbench/configs/tiny_gate_cl_b2.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({"name": "tiny_gate_cl_b2", "source": "tests",
                             "file": "portbench/configs/tiny_gate_cl_b2.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny.stream", "chips": 1,
                               "config": "tiny_gate_cl_b2",
                               "traffic": "stream", "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench/limits/tiny.stream.json").write_text(
        json.dumps(tiny.LIMITS))
    result, _ = _run(root, "tiny.stream", traced=True)
    assert result["correct"]
    assert result["metrics"]["dummy_share"]["value"] == 100.0
    # two rows a batch: calls of 2-5 pairs fill most of them
    assert 50.0 < result["metrics"]["batch_fill"]["value"] <= 100.0


def test_control_fails_where_the_program_passes(root):
    """The control in the program's place reads not correct, through the
    same comparison that passes the program; its numbers lie above the
    program's on the same pairs."""
    result, _ = _run(root, "tiny.icka", readings=("control", "control_text"))
    assert result["correct"]
    numbers = result["readings"]
    for key in ("control", "control_text"):
        for k in ("visual_err", "emis_err", "tag_gap"):
            assert numbers[key][k] >= numbers["program"][k]
    judged, lines = _run(root, "tiny.icka", judge="control")
    assert judged["correct"] is False
    assert any(v["value"] > v["limit"] for k, v in judged["checks"].items()
               if k in tiny.LIMITS)
    assert lines[0] == "check judged control, in the program's place"


def _altered_tags(monkeypatch):
    from icka_tpu_torch.nn import crf

    decode = crf.CRF.decode

    def altered(self, emissions, mask, *a, **kw):
        tags = decode(self, emissions, mask, *a, **kw)
        return (tags + 7) % emissions.shape[-1]
    monkeypatch.setattr(crf.CRF, "decode", altered)


def _altered_features(monkeypatch):
    from icka_tpu_torch.models import resnet

    forward = resnet.VisualBackbone.forward

    def altered(self, images):
        fc, _, att = forward(self, images)
        return fc, fc, att.roll(1, dims=-1)
    monkeypatch.setattr(resnet.VisualBackbone, "forward", altered)


def _half_batch(monkeypatch):
    from icka_tpu_torch.serving import bucketed

    for cls in (bucketed.BucketedGateCLServer, bucketed.BucketedICKAServer):
        batches = cls.batches

        def halved(self, examples, batches=batches):
            for b, chunk, lens, batch in batches(self, examples):
                for v in batch.values():
                    v[v.shape[0] // 2:] = v[0]
                yield b, chunk, lens, batch
        monkeypatch.setattr(cls, "batches", halved)


@pytest.mark.parametrize("cell", ["tiny.icka", "tiny.gate_cl"])
@pytest.mark.parametrize("fault,number,where", [
    (_altered_tags, "tag_gap", "root"),
    (_altered_features, "visual_err", "root"),
    (_half_batch, "emis_err", "full_root")])
def test_a_fault_in_the_served_path_is_not_correct(request, monkeypatch,
                                                   cell, fault, number,
                                                   where):
    """An answer altered where it is produced (every served tag shifted,
    or the grid's channels rolled after the backbone), and half of each
    full device batch left out (its rows replaced by the batch's first)."""
    root = request.getfixturevalue(where)
    fault(monkeypatch)
    result, _ = _run(root, cell)
    assert result["correct"] is False
    assert result["checks"][number]["value"] > \
        result["checks"][number]["limit"]


def test_main_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(run.ROOT / "portbench" / "run.py"),
         "--workload", "flagship.tweets", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_a_cell_on_the_card(card, cell):
    """The control (int4 backbone, fp8 text) put in the program's place at
    the cell's own size reads not correct where the served path reads
    correct."""
    catalog = run.Catalog.at(run.ROOT)
    result, _ = run.run_cell(catalog, cell, SEED, 1.0, False, card)
    assert result["correct"]
    judged, _ = run.run_cell(catalog, cell, SEED, 1.0, False, card,
                             judge="control")
    assert judged["correct"] is False
