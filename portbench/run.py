"""Run one cell of the port's benchmark once and print its result as the
last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`portbench/configs/<name>.json`, whose server names its protocol,
`portbench/servers/<name>.py`) and a traffic mix
(`portbench/traffic/<name>.json`); each metric is read by
`portbench/metrics/<name>.py`, and the limits of the comparison that
decides `correct` are in `portbench/limits/<cell>.json`. With `--trace 0`
the run measures one window and reports the cell's end-to-end metrics.
With `--trace 1` it measures an untraced window of half that length, and
then one of `--seconds` under one profiler session, and reports the
cell's per-layer metrics, each from the window its reader names
(`WINDOW = "traced"` for those read from the device records, the
untraced window otherwise).

`--judge control` (or `control_text`) puts the control's outputs in the
program's place in the comparison that decides `correct`: the check of
the comparison itself, which the benchmark's own runs never make.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "icka_tpu")


def _environment(root: Path) -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX
    or TensorFlow behind the program's back."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(root / "build" / "portbench" / sub))
    for var in ("USE_FLAX", "USE_TF", "USE_JAX"):
        os.environ[var] = "0"


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


class Catalog:
    """The benchmark's files under `root`, found by name."""

    def __init__(self, root: Path, bench: dict):
        self.root, self.bench = Path(root), bench

    @classmethod
    def at(cls, root: Path):
        path = Path(root) / "BENCHMARK.json"
        if not path.exists():
            raise SystemExit(f"no {path}")
        return cls(root, json.loads(path.read_text()))

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                return dict(cfg, name=name)
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        from portbench import traffic
        return traffic.load(self.root / "portbench" / "traffic"
                            / f"{name}.json")

    def limits(self, cell: str) -> dict:
        path = self.root / "portbench" / "limits" / f"{cell}.json"
        if not path.exists():
            raise SystemExit(f"no limits for {cell}: {path}")
        return json.loads(path.read_text())

    def metrics(self, cell: str, kind: str) -> list:
        """The metric entries of `kind` ("end_to_end" or "per_layer") that
        the cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def _module(self, kind: str, name: str, what: str):
        import importlib.util
        path = self.root / "portbench" / kind / f"{name}.py"
        if not path.exists():
            raise SystemExit(f"no {what} {name}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, name: str):
        """(read, window) of a metric: its reader and the window it reads,
        "traced" or "untraced"."""
        mod = self._module("metrics", name, "reader for metric")
        return mod.read, getattr(mod, "WINDOW", "untraced")

    def protocol(self, name: str):
        return self._module("servers", name, "server protocol")


class Record:
    """What one window saw, for the metric readers."""

    def __init__(self, cfg, traced, setup_s):
        self.cfg, self.traced, self.setup_s = cfg, traced, setup_s
        self.calls = []          # dicts: n, lengths, batches [(rows,
        #                          padded length)], latency_s, visual_s
        self.window_s = None
        self.trace = None        # trace.session's dict when traced
        self.k1_launches = 0     # the program's K1 counter over the window

    @property
    def pairs(self) -> int:
        return sum(c["n"] for c in self.calls)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Marks:
    """Points of the device's timeline (CUDA events) or, on the CPU, of
    the host's clock, read only once the window has closed."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


def _window(rec, serve, gen_traffic, sampler, all_tags, system, k, seconds,
            device) -> int:
    """Calls k, k + 1, ..., each one's inputs made before its clock
    starts, until `seconds` have passed; the last call runs to its end.
    Returns the next call's index."""
    import numpy as np
    marks, visual = _Marks(device), []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        call = gen_traffic.call(k)
        t0 = time.perf_counter()
        m0 = marks.mark()
        sentences, fc, att, tags, stats, m1 = serve(call, rec.traced,
                                                    marks.mark)
        t2 = time.perf_counter()
        visual.append((m0, m1))
        rec.calls.append({"n": len(sentences),
                          "lengths": np.minimum(call["lengths"],
                                                system.buckets[-1]),
                          "batches": system.device_batches(stats),
                          "latency_s": t2 - t0})
        sampler.take(k, call, sentences, system, fc, att, tags)
        all_tags.append((call["lengths"], tags))
        k += 1
    _sync(device)
    rec.window_s = time.perf_counter() - start
    for c, (m0, m1) in zip(rec.calls, visual):
        c["visual_s"] = marks.seconds(m0, m1)
    return k


def run_cell(catalog: Catalog, cell: str, seed: int, seconds: float,
             traced: bool, device, judge: str = "program",
             readings: tuple = ()) -> tuple[dict, list]:
    """One run of `cell`: returns (the result object, the check lines).

    `judge` names the outputs that the comparison deciding `correct`
    judges: "program" (the served path), or "control" (the reference one
    precision below the configuration's: an int4 backbone and fp8 text
    products) or "control_text" (the text half alone in fp8 on the int8
    backbone's features) put in the program's place. `readings` names
    further sides whose compared numbers the result carries under
    "readings" (`portbench/calibrate.py`)."""
    import numpy as np
    import torch

    from portbench import check, layout, trace, weights
    from portbench import traffic as traffic_mod

    w = catalog.workload(cell)
    cfg = catalog.config(w["config"])
    mix = catalog.traffic(w["traffic"])
    limits = catalog.limits(cell)
    protocol = catalog.protocol(cfg["server"]["protocol"])
    from portbench.reference import text as ref_text
    ref_text.fp32_strict()
    fam, m = cfg["family"], cfg["model"]
    tokens, srv, vis = cfg["tokens"], cfg["server"], cfg["visual"]
    vocab = (m["embedding"] if fam == "icka" else m["encoder"])["vocab_size"]
    T = m["num_labels"]

    # ---- set-up: weights, calibration, the program, warm-up ------------
    stamp = [T0]

    def phase(name):
        now = time.perf_counter()
        print(f"setup {name} {now - stamp[0]:.3f} s", file=sys.stderr)
        stamp[0] = now

    phase("imports")
    if device.type == "cuda":
        torch.zeros(1, device=device)
        _sync(device)
    phase("cuda_context")
    calib_images = weights.calibration_images(
        seed, vis["calibration_images"], mix["image_size"], device)
    from portbench.reference import visual as ref_visual
    calib_pixels = ref_visual.preprocess(calib_images, vis["crop"]) \
        .permute(0, 3, 1, 2).contiguous()
    resnet_sd = weights.resnet_weights(tuple(vis["layers"]), seed,
                                       calib_pixels, device)
    del calib_pixels
    resnet_host = {k: v.cpu() for k, v in resnet_sd.items()}
    text_sd = weights.text_weights(fam, m, seed, device)
    text_sum = weights.checksum(text_sd)
    _sync(device)
    phase("weights")
    from portbench.system import System
    system = System(cfg, text_sd, resnet_sd, calib_images, device, protocol)
    del text_sd, resnet_sd
    _sync(device)
    phase("program")
    gen_traffic = traffic_mod.Traffic(
        mix, seed, tokens, vocab, m.get("clip_dim") if fam == "icka"
        else None, device)
    head = (layout.prompt_head(seed, srv, tokens, gen_traffic.pool)
            if fam == "icka" else None)

    def serve(call, spans=False, mark=None):
        sentences = layout.sentences(call, tokens)
        with trace.span("visual", spans):
            fc, att = system.visual(call["images"])
        m1 = mark() if mark is not None else None
        examples = layout.requests(fam, call, tokens, head, fc, att)
        with trace.span("text", spans):
            tags, stats = system.predict(examples)
        return sentences, fc, att, tags, stats, m1

    # warm-up: at each call size of the mix, one call whose first lengths
    # reach every bucket the mix can reach, then one call of the mix
    lo, hi = traffic_mod.length_range(mix)
    reach = protocol.warm_lengths(system.buckets, lo, hi)
    pool = gen_traffic.lengths
    for j, n in enumerate(sorted(set(gen_traffic.sizes.tolist()))):
        warm = list(pool[(np.arange(n) * len(pool)) // n])
        for i, L in enumerate(reach[:n]):
            warm[i] = L
        serve(gen_traffic.call(-1 - j, warm))
    serve(gen_traffic.call(-1 - len(gen_traffic.sizes),
                           gen_traffic.lengths_of(0)))
    _sync(device)
    phase("warmup")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the windows ---------------------------------------------------
    from icka_tpu_torch.kernels.attention import fused_attention
    sampler = check.Sampler(seed)
    all_tags = []
    setup_s = time.perf_counter() - T0
    windows = {name: Record(cfg, name == "traced", setup_s)
               for name in (("untraced", "traced") if traced
                            else ("untraced",))}
    k = 0
    for name, rec in windows.items():
        k1_before = fused_attention.launches
        t = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if rec.traced:
                rec.trace = stack.enter_context(trace.session())
            # the traced window lasts `seconds`; beside it, the untraced
            # one lasts half as long, which keeps the whole traced run
            # inside its time limit (closing the profiler takes 2-3 times
            # the traced window)
            length = seconds / 2 if traced and not rec.traced else seconds
            k = _window(rec, serve, gen_traffic, sampler, all_tags, system,
                        k, length, device)
        rec.k1_launches = fused_attention.launches - k1_before
        print(f"window {name} {rec.window_s:.3f} s, {len(rec.calls)} calls,"
              f" {rec.pairs} pairs; closed in "
              f"{time.perf_counter() - t - rec.window_s:.3f} s",
              file=sys.stderr)

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # ---- every pair answered, each answer well formed ------------------
    failed = 0
    for lengths, tags in all_tags:
        for L, t in zip(lengths, tags):
            ok = (t is not None and len(t) == min(int(L), system.buckets[-1])
                  and (len(t) == 0 or (t.min() >= 0 and t.max() < T)))
            failed += not ok
    attempted = sum(r.pairs for r in windows.values())

    # ---- metrics -------------------------------------------------------
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for entry in catalog.metrics(cell, kind):
        read, window = catalog.reader(entry["name"])
        value = read(windows[window if traced else "untraced"])
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    breakdown = None
    if traced:
        tr = windows["traced"].trace
        breakdown = {
            "device_ops": trace.device_ops(tr["device"]),
            "idle_gaps": trace.idle_gaps(tr["device"], tr["host"],
                                         tr["spans"])}
        busy_s = trace.busy_ns(tr["device"]) / 1e9
        window_s = windows["traced"].window_s
    records = sampler.sample(cfg["check"]["pairs"])

    # ---- the comparison, after the program's state is freed ------------
    tr = None
    windows.clear()
    del system, sampler, all_tags
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    text_sd = weights.text_weights(fam, m, seed, device)
    same_weights = weights.checksum(text_sd) == text_sum
    ref = check.Reference(cfg, head, text_sd, resnet_host, calib_images,
                          device, protocol)
    ref_out = ref.outputs(records)
    crf = ref_text.crf_params({k: v.cpu() for k, v in text_sd.items()
                               if k.startswith("crf.")})
    sides = {"program": lambda: check.program_outputs(records),
             # the whole reference one precision down
             "control": lambda: check.Reference(
                 cfg, head, text_sd, resnet_host, calib_images, device,
                 protocol, qmax=check.CONTROL_QMAX,
                 precision=check.CONTROL_PRECISION).outputs(records),
             # its text half alone, on the int8 backbone's features
             "control_text": lambda: check.Reference(
                 cfg, head, text_sd, resnet_host, calib_images, device,
                 protocol, precision=check.CONTROL_PRECISION)
             .outputs(records)}
    if judge not in sides:
        raise SystemExit(f"unknown judge {judge!r}")
    numbers = {side: check.numbers(ref_out, crf, sides[side]())
               for side in dict.fromkeys((judge,) + tuple(readings))}
    got = numbers[judge]
    lines, correct = [], same_weights and failed == 0 and bool(records)
    checks = {}
    if judge != "program":
        lines.append(f"check judged {judge}, in the program's place")
    for name, value in got.items():
        limit = limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        correct = correct and value <= limit
        lines.append(f"check {name} {value!r} limit {limit!r}")
    checks["failed_pairs"] = {"value": failed, "limit": 0}
    lines.append(f"check failed_pairs {failed} limit 0")
    checks["compared_pairs"] = {"value": len(records), "limit": 1}
    lines.append(f"check compared_pairs {len(records)} limit 1 (at least)")
    if not same_weights:
        lines.append("check reference_weights differ from the served ones")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = busy_s
        dev["window_s"] = window_s
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if readings:
        result["readings"] = numbers
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--judge", default="program",
                   choices=("program", "control", "control_text"),
                   help="the outputs the comparison judges (the control's "
                   "only to check the comparison)")
    args = p.parse_args(argv)
    _environment(ROOT)
    catalog = Catalog.at(ROOT)
    chips = catalog.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    result, lines = run_cell(catalog, args.workload, args.seed % 2 ** 63,
                             args.seconds, bool(args.trace),
                             torch.device("cuda", 0), judge=args.judge)
    bad = forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
