"""Device time of K1 (`fused_attention`, the port's short-sequence attention
kernel) at the serving shapes, on one NVIDIA GPU.

    python tools/k1_times.py [--iters 50] [--repeats 5]

B=128 in bf16 and fp32 (TF32 off): the flagship's 16 heads of 64 at S=150
with a key mask and S=172 with the packed server's block-diagonal mask, and
the gate_cl family's 12 heads of 64 at S=128 with a key mask and S=48
with a block-diagonal mask. Each output is first held to the plain version
(`chip_smoke.attention_close`); then, each the median over `--repeats`:
the milliseconds per call from CUDA events over `--iters` calls (what
`chip_smoke.py` phase 7 reports: at a shape where the kernel takes less
than the wrapper's host time, the gaps between launches count too), the
kernel's own device time per launch from `torch.profiler`, and the host
microseconds per call (the wrapper's Python and the launch, the calls
enqueued without a synchronise). Where the tree's K1 reads strided q, k
and v, the event time on the three views of one fused (B, S, 3D)
projection too, the output held bit-equal to the contiguous call's. Imports the port from the tree this file lies in, so a
second tree unpacked beside it (under a gitignored directory, this file
copied into its tools/) times its own kernel: the way to compare two
versions in one chip call, in turns.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from icka_tpu_torch.kernels.attention import (  # noqa: E402
    attention_reference, fused_attention)

SHAPES = ((16, 150, "B11Sk"), (16, 172, "packed"), (12, 128, "B11Sk"),
          (12, 48, "packed"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    tree = Path(__file__).resolve().parents[1]
    strided = hasattr(fused_attention, "strided_launches")
    print(f"{tree.name}: {smi.stdout.strip()}; strided q/k/v "
          f"{'read in place' if strided else 'not taken'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    B, hd = 128, 64

    def median_ms(fn):
        return statistics.median(cs.cuda_time_ms(fn, iters=args.iters)
                                 for _ in range(args.repeats))

    def device_ms(fn):
        """K1's device time per launch, kernel rows of the profiler."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if "attention" in e.key
                and str(getattr(e, "device_type", "")).endswith("CUDA")]
        us = sum(getattr(e, "self_device_time_total", 0) for e in rows)
        return us / 1e3 / sum(e.count for e in rows)

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / args.iters * 1e6
    for dtype in (torch.bfloat16, torch.float32):
        for N, S, kind in SHAPES:
            q, k, v, bias = cs.attention_inputs(B, S, S, dtype, kind, gen,
                                                N=N)
            if kind == "packed":
                bias = bias.contiguous()     # one mask per row, as served
            out = fused_attention(q, k, v, bias, N)
            cs.attention_close(out, attention_reference(q, k, v, bias, N),
                               f"K1 {dtype} {N}x{hd} S={S}")
            call = lambda: fused_attention(q, k, v, bias, N)  # noqa: E731
            ms = median_ms(call)
            dev = statistics.median(device_ms(call)
                                    for _ in range(args.repeats))
            host = statistics.median(host_us(call)
                                     for _ in range(args.repeats))
            line = (f"  {str(dtype)[6:]:8s} {N}x{hd} S={S:3d} {kind:6s} "
                    f"K1 {ms:.4f} ms (device {dev:.4f} ms, host "
                    f"{host:.1f} us a call)")
            if strided:
                views = torch.cat([q, k, v], dim=-1).split(N * hd, dim=-1)
                cs.check(torch.equal(fused_attention(*views, bias, N), out),
                         f"K1 on strided views differs at S={S}")
                ms = median_ms(lambda: fused_attention(*views, bias, N))
                line += f", on strided views {ms:.4f} ms"
            print(line, flush=True)
            del q, k, v, bias, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
