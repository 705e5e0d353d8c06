"""Readings that the limits of a cell's comparison are set from: for each
seed, one short run of the cell (at its own load, sampled as a run
samples) with its compared numbers, and the control's numbers on the same
pairs (the reference one precision below the configuration's: an int4
backbone and fp8 products in the text model; and the text half alone in
fp8 on the int8 backbone's features, "control_text").

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--seconds 4] [--out build/portbench/calibrate_<cell>.jsonl]

Many seeds share one process, so the kernels and libraries load once.
Each seed's line: {"seed", "correct", "program": {...}, "control": {...},
"control_text": {...}, "attempted", "failed"}.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from portbench import run
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    run._environment(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    catalog = run.Catalog.at(ROOT)
    out = Path(args.out or ROOT / "build" / "portbench"
               / f"calibrate_{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            result, _ = run.run_cell(
                catalog, args.workload, seed, args.seconds, False,
                torch.device("cuda", 0),
                readings=("control", "control_text"))
            line = {"seed": seed, "correct": result["correct"],
                    "program": {k: v["value"]
                                for k, v in result["checks"].items()},
                    "control": result["readings"]["control"],
                    "control_text": result["readings"]["control_text"],
                    "attempted": result["attempted"],
                    "failed": result["failed"]}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
