"""Device time of the bf16 attention body at head width 64 (the wgmma body
of K1 and K2 in the PyTorch/CUDA port) at every tiling, on one NVIDIA GPU.

    python tools/attention_bf16_times.py [--seconds 0.5]

B=128, bf16, at the shapes of PERF.md's kernel table: the flagship's 16
heads of 64 at S=150 with a key mask, S=172 with the packed server's
block-diagonal mask, S=512 and S=1024 with a key mask; the gate_cl family's
12 heads of 64 at S=128 with a key mask and S=48 with a block-diagonal
mask. Each output of K1 (`fused_attention`) and K2
(`fused_attention_blockwise`) is first held to its plain version
(`chip_smoke.attention_close`); then the kernel's device time per launch
from `torch.profiler` (`chip_smoke.kernel_device_ms`, a loop of about
`--seconds`) for K1 at `K1_WGMMA_TILES` and for the body at each tiling
(64, 64), (64, 128), (128, 64), (128, 128) through K2's wrapper, beside
SDPA in bf16 (CUDA events), the bound and the `mma.sync` body's recorded
time (`chip_smoke.MMA_SYNC_MS`). Last, the registers and spills of every
wgmma instance. Imports the port from the tree this file lies in, so a
second tree unpacked beside it times its own kernels: the way to compare
two versions of the body in one chip call, in turns.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from icka_tpu_torch.kernels import build  # noqa: E402
from icka_tpu_torch.kernels.attention import (  # noqa: E402
    K1_WGMMA_TILES, WGMMA_BLOCK_SIZES, attention_blockwise_reference,
    attention_reference, blockwise_tiles, fused_attention,
    fused_attention_blockwise)

TILINGS = tuple((bq, bk) for bq in WGMMA_BLOCK_SIZES
                for bk in WGMMA_BLOCK_SIZES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bf16_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"{Path(__file__).resolve().parents[1].name}: "
          f"{smi.stdout.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    B, dtype = 128, torch.bfloat16
    for name, N, S, kind in cs.BF16_TIMED_SHAPES:
        q, k, v, bias = cs.attention_inputs(B, S, S, dtype, kind, gen, N=N)
        if kind == "packed":
            bias = bias.contiguous()     # one mask per row, as the model's
        cs.attention_close(fused_attention(q, k, v, bias, N),
                           attention_reference(q, k, v, bias, N),
                           f"K1 {N}x64 S={S}")
        cs.attention_close(fused_attention_blockwise(q, k, v, bias, N),
                           attention_blockwise_reference(q, k, v, bias, N),
                           f"K2 {N}x64 S={S}")
        times = {f"K1 {K1_WGMMA_TILES}": cs.kernel_device_ms(
            lambda: fused_attention(q, k, v, bias, N),
            seconds=args.seconds)}
        for blocks in TILINGS:        # named "asked->run" where they differ
            tiles = blockwise_tiles(S, S, 64, dtype, *blocks)
            label = str(tiles) if tiles == blocks else f"{blocks}->{tiles}"
            times[label] = cs.kernel_device_ms(
                lambda: fused_attention_blockwise(q, k, v, bias, N, *blocks),
                seconds=args.seconds)
        library = cs.sdpa_ms(q, k, v, bias, N, 20)
        bound, bound_by, _, _ = cs.attention_bound(q, k, bias, N)
        print(f"{name} {N}x64 S={S} bias={kind}: device ms " + ", ".join(
            f"{t} {ms:.4f}" for t, ms in times.items())
            + f"; SDPA {library:.4f} (events); bound {bound:.4f} "
            f"({bound_by}); mma.sync recorded "
            f"{cs.MMA_SYNC_MS[name, N, S]:.4f}")
        del q, k, v, bias
    for kernel, regs, _, spill in cs.ptxas_rows(
            build.build_log("blockwise_attention")):
        if "wgmma" in kernel:
            print(f"  {kernel}: {regs} registers, {spill} bytes spilled")
    return 0


if __name__ == "__main__":
    sys.exit(main())
