"""Device time of the int8 conv kernels (K3-K6 of the PyTorch/CUDA port),
call by call and launch by launch, on one NVIDIA GPU.

    python tools/int8_conv_launches.py [--batch 128] [--iters 20]
                                       [--clusters] [--tiles]

For the identity bottleneck (`int8_bottleneck_v2`) and the 3x3 conv
(`int8_conv3x3`, C = F = the stage's width) at each ResNet stage shape and
the stem (`int8_stem_pool`): milliseconds per call from CUDA events over
`--iters` calls, and the device time of each launch of one call from
torch.profiler (at the serving batch, `--batch 16`, a call's host time is
longer than its kernel's: read the device time). Each output is checked
bit-equal to its plain version first. The bottleneck and the stem are
called as the model calls them, their weights laid out for the kernel once
(`kmajor_tiles`), where the tree has that entry; the 3x3 conv, which has no
model caller, through its public wrapper. Inputs are those of
`chip_smoke.py` phase 2. `--clusters` also times the bottleneck's wgmma
body at each stage with every cluster size that splits its channels (the
measurement behind `bottleneck_geometry`'s rule); `--tiles` times the 3x3
conv's body at each product size its geometry tries (64, 128, 256 rows).
The 3x3 conv's public wrapper lays its weight out at every call: its
kernel is also timed with that layout cached, in turns with the wrapper
as it is, to show what the layout copies just before each launch cost.
Imports the port from the tree this file lies in, so an unpacked second
tree (an earlier version, with this file copied into it) times its own
kernels.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from icka_tpu_torch.kernels import conv as kconv  # noqa: E402


def launch_ms(fn):
    """(kernel name, device ms) of every kernel one call of `fn` runs."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, (getattr(e, "device_time", None)
                      or getattr(e, "cuda_time", 0)) / 1e3)
            for e in prof.events()
            if str(e.device_type).endswith("CUDA") and "kernel" in e.name]


def report(what, kernel_fn, plain_fn, iters):
    cs.check_equal(what, kernel_fn(), plain_fn(), {}, what)
    ms = cs.cuda_time_ms(kernel_fn, iters=iters)
    parts = ", ".join(f"{name.split('(')[0].split(' ')[-1]} {t:.4f}"
                      for name, t in launch_ms(kernel_fn))
    print(f"{what}: {ms:.4f} ms a call; launches {parts}")


def cluster_times(a, rs, tiles, B, H, Cw, iters):
    """The wgmma body at every cluster size that splits Cw's channels."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = kconv.bottleneck_geometry(B, H, H, Cw, sms)["CL"]
    want = kconv.bottleneck_v2_reference(*a, rs)
    times = []
    for cl in (1, 2, 4, 8):
        try:
            g = dict(kconv._geometry(B, H, H, Cw, sms, cl))
        except ValueError:
            continue
        out = torch.empty_like(a[0])

        def run():
            kconv._bottleneck_launch(
                "int8_bottleneck_v2", a[0], a[1:4], a[4:], rs, 0.0, out, H,
                H, Cw, (H, H, 0, 0), False, tiles, g)
            return out
        cs.check_equal(f"CL={cl}", run(), want, {}, "cluster")
        times.append(f"CL={cl}{'*' if cl == chosen else ''} "
                     f"{cs.cuda_time_ms(run, iters=iters):.4f}")
    print(f"  clusters (* the rule's): {', '.join(times)} ms a call")


def device_ms(fn, iters, name):
    """Mean device time of the kernels named with `name` over `iters`
    calls of `fn` (the wrapper's host time does not count)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ts = [(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0))
          / 1e3 for e in prof.events() if name in e.name]
    return sum(ts) / max(len(ts), 1)


def tiles_times(c, B, H, C, iters):
    """The 3x3 conv's body at each product size of its geometry, by device
    time a launch."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a = (c["x_pad"], c["w_q"], c["scale"], c["bias"])
    chosen = kconv.conv3x3_geometry(B, H, H, C, C, sms)["BM"]
    want = kconv.conv3x3_reference(*a)
    times = []
    for rows in (64, 128, 256):
        g = kconv._conv3_geometry(B, H, H, C, C, sms, rows)
        if rows > 64 and g["BM"] <= 64:
            continue                  # the image fills 64 rows already

        def run():
            return kconv._conv3x3_launch(*a, None, True, None,
                                         torch.bfloat16, g)
        cs.check_equal(f"rows={rows}", run(), want, {}, "tiles")
        times.append(f"{g['TR']}x{g['TC']} ({g['BM']} rows"
                     f"{'*' if g['BM'] == chosen else ''}) "
                     f"{device_ms(run, iters, 'conv3x3'):.4f}")
    print(f"  tiles (* the rule's): {', '.join(times)} ms device time a "
          f"launch")


def layout_cost(a, iters):
    """The 3x3 conv kernel's device time a launch through the public
    wrapper as it is and with `kmajor_tiles` cached, in turns."""
    real, cache = kconv.kmajor_tiles, {}

    def cached(w, taps=1):
        key = (w.data_ptr(), taps)
        if key not in cache:
            cache[key] = real(w, taps)
        return cache[key]

    times = {"laid out at each call": [], "cached": []}
    try:
        for _ in range(2):
            for what, fn in zip(times, (real, cached)):
                kconv.kmajor_tiles = fn
                times[what].append(device_ms(
                    lambda: kconv.int8_conv3x3(*a), iters,
                    "int8_conv3x3_kernel"))
    finally:
        kconv.kmajor_tiles = real
    print("  the kernel with its weight " + ", ".join(
        f"{what} {' / '.join(f'{t:.4f}' for t in ts)}"
        for what, ts in times.items()) + " ms device time a launch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--clusters", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_conv_launches: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    B = args.batch
    with torch.inference_mode():
        for H, Cw in cs.CONV_STAGES:
            a = cs.bottleneck_inputs(gen, B, H, Cw)
            rs = torch.tensor([0.37], device="cuda")
            # the model's call: the weights laid out once, as each ConvBN
            # keeps them
            tiles = kconv.bottleneck_weight_tiles(*a[1:4])
            report(f"int8_bottleneck_v2 B={B} H={H} Cw={Cw}",
                   lambda: kconv._int8_bottleneck_v2_tiled(tiles, *a, rs),
                   lambda: kconv.bottleneck_v2_reference(*a, rs), args.iters)
            if args.clusters:
                cluster_times(a, rs, tiles, B, H, Cw, args.iters)
            del a, tiles
        # the stem through its private entry where the tree has it (the
        # weight laid out once), else the public one
        stem_tiled = getattr(kconv, "_int8_stem_pool_tiled", None)
        a = cs.stem_inputs(gen, B)
        t = kconv.kmajor_tiles(a[1]) if stem_tiled else None
        report(f"int8_stem_pool B={B}",
               (lambda: stem_tiled(t, *a)) if stem_tiled
               else (lambda: kconv.int8_stem_pool(*a)),
               lambda: kconv.stem_pool_reference(*a), args.iters)
        for H, C in cs.CONV_STAGES:
            c = cs.conv3x3_inputs(gen, B, H, C, C)
            a = (c["x_pad"], c["w_q"], c["scale"], c["bias"])
            report(f"int8_conv3x3 B={B} H={H} C=F={C}",
                   lambda: kconv.int8_conv3x3(*a),
                   lambda: kconv.conv3x3_reference(*a), args.iters)
            if hasattr(kconv, "_conv3x3_launch"):
                layout_cost(a, args.iters)
            if args.tiles and hasattr(kconv, "_conv3x3_launch"):
                tiles_times(c, B, H, C, args.iters)
            del c, a
    return 0


if __name__ == "__main__":
    sys.exit(main())
