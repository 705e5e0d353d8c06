"""A tiny copy of the benchmark's files in a directory of its own, for the
CPU tests: one configuration of each family at a few dozen units of
width, a three-stage-deep ResNet on 64-pixel crops, a mix of six short
pairs a call, and the repository's metric readers and server protocols."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def icka_model() -> dict:
    from icka_tpu_torch.core.config import ICKAConfig
    c = ICKAConfig.tiny(vocab_size=600)
    c = dataclasses.replace(
        c, region_dim=2048,
        embedding=dataclasses.replace(c.embedding, use_pallas=True),
        last_encoder=dataclasses.replace(c.last_encoder, use_pallas=True))
    return dataclasses.asdict(c)


def gate_cl_model() -> dict:
    from icka_tpu_torch.core.config import GateCLConfig
    c = GateCLConfig.tiny(vocab_size=600)
    c = dataclasses.replace(
        c, region_dim=2048, max_seq_length=32,
        encoder=dataclasses.replace(c.encoder, use_pallas=True,
                                    position_offset=0, pad_token_id=0))
    return dataclasses.asdict(c)


ICKA_SERVER = "icka_tpu_torch.serving.bucketed.BucketedICKAServer"
GATE_CL_SERVER = "icka_tpu_torch.serving.bucketed.BucketedGateCLServer"
VISUAL = {"layers": [1, 1, 1, 1], "quant": "int8_static",
          "fused_pallas": True, "crop": 64, "calibration_images": 4}


def configs() -> dict:
    return {
        "tiny_icka": {
            "source": "tests", "family": "icka", "dtype": "bfloat16",
            "model": icka_model(), "visual": VISUAL,
            "server": {"class": ICKA_SERVER, "protocol": "bucketed",
                       "buckets": [16, 24, 32], "max_batch": 4,
                       "offset": 14, "mask_positions": [3, 11]},
            "tokens": {"bos": 0, "eos": 2, "pad": 1, "mask": 599, "low": 3},
            "check": {"pairs": 4}, "reduced": [], "assumed": {}},
        "tiny_gate_cl": {
            "source": "tests", "family": "gate_cl", "dtype": "bfloat16",
            "model": gate_cl_model(), "visual": VISUAL,
            "server": {"class": GATE_CL_SERVER, "protocol": "bucketed",
                       "buckets": [16, 24, 32], "max_batch": 4},
            "tokens": {"bos": 101, "eos": 102, "pad": 0, "low": 103},
            "check": {"pairs": 4}, "reduced": [], "assumed": {}},
    }


TRAFFIC = {"pairs_per_call": 6, "image_size": 72,
           "lengths": {"kind": "uniform", "min": 5, "max": 30}}
LIMITS = {"visual_err": {"limit": 1e-3}, "emis_err": {"limit": 0.05},
          "tag_gap": {"limit": 0.5}}


def bench_root(tmp: Path, extra_metrics: dict | None = None) -> Path:
    """A benchmark root under `tmp` with cells tiny.icka and
    tiny.gate_cl, the repository's metric entries and readers, and
    `extra_metrics` ({name: reader source}) as per-layer metrics."""
    root = Path(tmp)
    pb = root / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "servers"):
        shutil.copytree(REPO / "portbench" / sub, pb / sub,
                        ignore=shutil.ignore_patterns("__pycache__"),
                        dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name, cfg in configs().items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "tests"})
        cell = f"tiny.{name[5:]}"
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "tests"})
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
    (pb / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    for name, source in (extra_metrics or {}).items():
        (pb / "metrics" / f"{name}.py").write_text(source)
        bench["per_layer"].append({"name": name, "unit": "%",
                                   "better": "higher",
                                   "source": "program_counter",
                                   "layer": "tests", "moves": "pairs_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
