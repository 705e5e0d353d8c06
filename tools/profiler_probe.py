"""Whether `torch.profiler` goes on recording device kernels through a
sequence of profiled calls and of `chip_smoke.py`'s later work, on one
NVIDIA GPU.

    python tools/profiler_probe.py [--calls 24] [--launches 60000]

Late in `chip_smoke.py`'s process the profiler has recorded no device
kernel. This script runs, in one process, a probe (one small product
profiled, read as `chip_smoke.device_busy` reads its records) after each
of:

  1. `--untraced` seconds with nothing profiled (the process's age alone),
     `--idle_calls` profiled calls of 100 small kernels spread over
     `--idle` seconds (time traced), then `--calls` profiled calls of
     `--launches` small kernels each (about a full-width train step's
     record count), each call's device records counted and the median
     time from a kernel's launch to its start as the trace stamps them;
     after each part, probes that idle 0.01-3 s on the host
     before the product or after its synchronise, inside the profiled
     call (which part of a call the trace keeps);
  2. phase 7's two parts that read no profile (`phase_wide_times`,
     `phase_conv_times`), the kernels built first;
  3. a gloo process group of one rank on the card, started and destroyed;
  4. a spawned process that computes on the card.

Prints a line per step, and a JSON object as its last line: each probe's
answer in order and, where the records stopped, after which step.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from icka_tpu_torch.kernels import build  # noqa: E402


def profiled(fn):
    """(device records, median ms from a kernel's launch to its start as
    the trace stamps them: negative when the device's stamps run behind
    the host's; None without a matched pair) of one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    kernels = {e.correlation_id(): e.start_ns() for e in events
               if e.device_type() == DeviceType.CUDA}
    gaps = sorted((kernels[e.correlation_id()] - e.start_ns()) / 1e6
                  for e in events
                  if e.device_type() != DeviceType.CUDA
                  and "LaunchKernel" in e.name()
                  and e.correlation_id() in kernels)
    return len(kernels), (gaps[len(gaps) // 2] if gaps else None)


def records(fn) -> int:
    """The device records of one profiled call of `fn`."""
    return profiled(fn)[0]


def _on_card() -> None:
    x = torch.ones(256, 256, device="cuda")
    (x @ x).sum().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=24)
    ap.add_argument("--launches", type=int, default=60000)
    ap.add_argument("--untraced", type=float, default=90.0)
    ap.add_argument("--idle", type=float, default=60.0)
    ap.add_argument("--idle_calls", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"{smi.stdout.strip()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    dev = torch.device("cuda", 0)
    x = torch.ones(256, 256, device=dev)
    small = torch.zeros(16, device=dev)
    probes = []

    def probe(after: str) -> bool:
        sees = records(lambda: x @ x) > 0
        probes.append((after, sees))
        print(f"after {after}: the profiler records device kernels: {sees}",
              flush=True)
        return sees

    def padded(before: float, after: float) -> bool:
        """A probe that idles on the host `before` the product
        and `after` its synchronise."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(before)
            x @ x
            torch.cuda.synchronize()
            time.sleep(after)
        from torch.autograd import DeviceType
        return any(e.device_type() == DeviceType.CUDA
                   for e in prof.profiler.kineto_results.events())

    def pads(when: str) -> dict:
        out = {f"{side} {pad}": padded(*((pad, 0.0) if side == "before"
                                         else (0.0, pad)))
               for side in ("before", "after")
               for pad in (0.01, 0.05, 0.2, 1.0, 3.0)}
        print(f"probes idling on the host {when} (s: records kernels): "
              f"{out}", flush=True)
        return out

    def launches(n: int, pause: float = 0.0):
        return lambda: ([small.add_(1.0) for _ in range(n)],
                        time.sleep(pause))

    probe("start")
    # the process's age alone: nothing profiled for `--untraced` seconds
    time.sleep(args.untraced)
    probe(f"{args.untraced} s untraced")
    # time traced: sparse profiled calls spread over `--idle` seconds
    t0 = time.perf_counter()
    for i in range(args.idle_calls):
        n, gap = profiled(launches(100, args.idle / args.idle_calls))
        print(f"idle call {i} at {time.perf_counter() - t0:.1f} s: {n} "
              f"device records, launch to start {gap} ms", flush=True)
    probe(f"{args.idle_calls} idle calls")
    padded_probes = {"after the idle calls": pads("after the idle calls")}
    total = 0
    for i in range(args.calls):
        n, gap = profiled(launches(args.launches))
        total += n
        print(f"call {i} at {time.perf_counter() - t0:.1f} s: {n} device "
              f"records ({total} in all), launch to start {gap} ms",
              flush=True)
        if not probe(f"call {i}"):
            break
    padded_probes["after the dense calls"] = pads("after the dense calls")
    build.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.phase_wide_times(gen)
    probe("phase_wide_times")
    cs.phase_conv_times(gen, {name: 0 for name in cs.COUNTERS},
                        {name: 0.0 for name in cs.COUNTERS})
    probe("phase_conv_times")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        dist.destroy_process_group()
    probe("a gloo group of one")
    proc = multiprocessing.get_context("spawn").Process(target=_on_card)
    proc.start()
    proc.join(300)
    print(f"spawned process exit code {proc.exitcode}")
    probe("a spawned process")
    stopped = next((after for after, sees in probes if not sees), None)
    print(json.dumps({"probes": probes, "stopped_after": stopped,
                      "device_records_before": total,
                      "padded_probes": padded_probes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
