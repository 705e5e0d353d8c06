"""Device time of the int8 conv kernels (K3-K6 of the PyTorch/CUDA port),
call by call and launch by launch, on one NVIDIA GPU.

    python tools/int8_conv_launches.py [--batch 128] [--iters 20]
                                       [--clusters]

For the identity bottleneck (`int8_bottleneck_v2`) at each ResNet stage
shape, the stem (`int8_stem_pool`) and the 3x3 conv (`int8_conv3x3`) at
layer3: milliseconds per call from CUDA events over `--iters` calls, and the
device time of each launch of one call from torch.profiler. Each output is
checked bit-equal to its plain version first. The bottleneck is called as
the model calls it, its weights laid out for the kernel once
(`kmajor_tiles`). Inputs are those of `chip_smoke.py` phase 2.
`--clusters` also times the bottleneck's wgmma body at each stage with
every cluster size that splits its channels (the measurement behind
`bottleneck_geometry`'s rule). Imports the port from the tree this file
lies in, so an unpacked second tree times its own kernels.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--clusters", action="store_true")
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
        a = cs.stem_inputs(gen, B)
        report(f"int8_stem_pool B={B}", lambda: kconv.int8_stem_pool(*a),
               lambda: kconv.stem_pool_reference(*a), args.iters)
        c = cs.conv3x3_inputs(gen, B, 14, 256, 256)
        a = (c["x_pad"], c["w_q"], c["scale"], c["bias"])
        report(f"int8_conv3x3 B={B} H=14 C=F=256",
               lambda: kconv.int8_conv3x3(*a),
               lambda: kconv.conv3x3_reference(*a), args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
