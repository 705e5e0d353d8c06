"""Where `chip_smoke.py`'s seconds go: its `main` under a wall-clock stack
sampler, on one NVIDIA GPU.

    python tools/smoke_sampler.py [--interval 0.2] [--out build/smoke_sampler.txt]

A thread reads the main thread's Python stack every `--interval` seconds
(no tracing hook, so the run's own times stand) while `chip_smoke.main`
runs with no arguments. The report, written to `--out` when the run ends
or fails, gives the sampled seconds by the outermost `phase_*` function,
by the innermost line of `chip_smoke.py`, by the innermost line of the
repo (`chip_smoke.py` or `icka_tpu_torch/`) and by function, counted
once a sample however deep (inclusive). The spawned ranks of phases 12
and 13 show as the parent's wait for them. Exits with `chip_smoke`'s
code.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def sample(thread_id: int, interval: float, stop: threading.Event,
           out: list) -> None:
    """Append the stack of `thread_id`, innermost first, as (file,
    function, line) every `interval` seconds until `stop` is set."""
    while not stop.wait(interval):
        frame = sys._current_frames().get(thread_id)
        stack = []
        while frame is not None:
            code = frame.f_code
            stack.append((code.co_filename, code.co_name, frame.f_lineno))
            frame = frame.f_back
        out.append(stack)


def report(stacks: list, interval: float, rc) -> str:
    phases, smoke, repo, inclusive = (collections.Counter()
                                      for _ in range(4))
    for stack in stacks:
        for fn, name, _ in reversed(stack):
            if fn.endswith("chip_smoke.py") and name.startswith("phase_"):
                phases[name] += 1
                break
        for fn, name, line in stack:
            if fn.endswith("chip_smoke.py"):
                smoke[(name, line)] += 1
                break
        for fn, name, line in stack:
            if fn.startswith(str(ROOT)) and ("icka_tpu_torch" in fn
                                             or fn.endswith("chip_smoke.py")):
                repo[(os.path.relpath(fn, ROOT), name, line)] += 1
                break
        for key in {(os.path.basename(fn), name) for fn, name, _ in stack}:
            inclusive[key] += 1
    lines = [f"chip_smoke rc {rc}; {len(stacks)} samples of {interval} s"]
    for title, counts, n in (("outermost phase function", phases, 60),
                             ("innermost chip_smoke.py line", smoke, 120),
                             ("innermost repo line", repo, 120),
                             ("inclusive, by function", inclusive, 250)):
        lines += ["", f"# by {title}"]
        lines += [f"{c * interval:8.1f} s  {k}" for k, c in
                  counts.most_common(n)]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--interval", type=float, default=0.2)
    ap.add_argument("--out", default=str(ROOT / "build"
                                          / "smoke_sampler.txt"))
    args = ap.parse_args(argv)
    stacks: list = []
    stop = threading.Event()
    thread = threading.Thread(target=sample, daemon=True, args=(
        threading.get_ident(), args.interval, stop, stacks))
    thread.start()
    rc = None
    try:
        rc = chip_smoke.main([])
    finally:
        stop.set()
        thread.join()
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report(stacks, args.interval, rc))
    return rc


if __name__ == "__main__":
    sys.exit(main())
