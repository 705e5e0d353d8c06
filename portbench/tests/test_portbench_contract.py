"""BENCHMARK.json against the benchmark contract's form: names, units and
lines in the allowed characters, every entry's keys, and every cell's
files present; and the run's check for JAX modules."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from portbench import run, traffic

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (run.ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end",
                                             "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key])


def test_cells_and_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic.load(run.ROOT / "portbench/traffic" / f"{w['traffic']}.json")
        limits = json.loads((run.ROOT / "portbench/limits"
                             / f"{w['name']}.json").read_text())
        assert set(limits) >= {"visual_err", "emis_err", "tag_gap"}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = json.loads((run.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (run.ROOT / "portbench/metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules({"icka_tpu_torch": 0,
                                  "icka_tpu_torch.models.icka": 0,
                                  "jaxtyping": 0, "flaxen": 0}) == []
    assert run.forbidden_modules({"icka_tpu.models": 0}) == ["icka_tpu"]
    assert run.forbidden_modules({"jax.numpy": 0, "flax": 0,
                                  "jaxlib.xla": 0}) == ["flax", "jax",
                                                        "jaxlib"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import run, system, check, calibrate\n"
            "from portbench.reference import text, visual\n"
            "print(run.forbidden_modules())" % str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
