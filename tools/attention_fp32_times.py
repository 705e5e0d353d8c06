"""Device time of the fp32 attention kernels (K1 and K2 of the PyTorch/CUDA
port, the 3xTF32 body at head width 64) at every tiling, on one NVIDIA GPU.

    python tools/attention_fp32_times.py [--iters 20] [--no-check]

At the shapes of `chip_smoke.py` phase 7 (B=128, 16 heads of 64: S=150
with a key mask, S=172 with the packed server's block-diagonal mask,
S=1024 with a key mask), each output checked against its plain version
within 2e-5 first: milliseconds per call from CUDA events over `--iters`
calls for K1 (`fused_attention`, at `K1_FP32_TILES`), the body at each of
`chip_smoke.TF32_WGMMA_TILINGS` and at (128, 128) as asked, through K2's
wrapper (named "asked->run" where the body runs another), and SDPA in
fp32 with TF32 off. Then the body's device time a launch (the
profiler's) at both tilings through K2's wrapper at the main paths'
smaller fp32 shapes (the flagship's serving batch of 8 at S=154, gate_cl's
128 and 48 at B=128, the captioner's beam, the chunker's 32, the VCR
plane's history of 50, a tensor-parallel rank's 8 heads) and at S=1024
with B=32; with `--no-check` outputs are not held to their plain
versions (for copies of the tree whose kernel omits a part of its work,
to time what that part costs); last the registers and spills of every
3xTF32 instance from the build log. Imports the port from
the tree this file lies in, so an unpacked second tree times its own
kernels: the way to compare two versions of the body in one chip call
(`--save` keeps K1's outputs, to hold the two versions bit-equal).
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
    K1_FP32_TILES, attention_blockwise_reference, attention_reference,
    blockwise_tiles, fused_attention, fused_attention_blockwise)

TILINGS = cs.TF32_WGMMA_TILINGS + ((128, 128),)
SHAPES = ((150, "B11Sk"), (172, "packed"), (1024, "B11Sk"))
# (tag, B, Sq, Sk, heads, bias) of the device-time table
SMALL_SHAPES = (("serve8_154", 8, 154, 154, 16, "B11Sk"),
                ("s1024_b32", 32, 1024, 1024, 16, "B11Sk"),
                ("bert128", 128, 128, 128, 12, "B11Sk"),
                ("bert48", 128, 48, 48, 12, "packed"),
                ("caption_beam", 24, 90, 90, 12, "BSqSk"),
                ("chunk32", 8, 32, 32, 12, "B11Sk"),
                ("vcr_history50", 16, 100, 150, 12, "B11Sk"),
                ("tp", 8, 150, 150, 8, "B11Sk"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", type=Path, default=None,
                    help="write K1's output at each shape to this .pt file, "
                         "to hold two versions of the body bit-equal")
    ap.add_argument("--no-check", action="store_true",
                    help="time without holding outputs to their plain "
                         "versions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_fp32_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"{Path(__file__).resolve().parents[1].name}: "
          f"{smi.stdout.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    B, N, hd = 128, 16, 64
    outputs = {}
    for S, kind in SHAPES:
        q, k, v, bias = cs.attention_inputs(B, S, S, torch.float32, kind, gen)
        if kind == "packed":
            bias = bias.contiguous()     # one mask per row, as the model's
        iters = args.iters if S < 1024 else max(args.iters // 4, 3)
        outputs[S] = fused_attention(q, k, v, bias, N)
        if not args.no_check:
            cs.attention_close(fused_attention_blockwise(q, k, v, bias, N),
                               attention_blockwise_reference(q, k, v, bias,
                                                             N),
                               f"K2 fp32 S={S}")
            cs.attention_close(outputs[S], attention_reference(
                q, k, v, bias, N), f"K1 fp32 S={S}")
        if args.save is None:
            del outputs[S]
        times = {"K1": cs.cuda_time_ms(
            lambda: fused_attention(q, k, v, bias, N), iters=iters)}
        for blocks in TILINGS:        # named "asked->run" where they differ
            tiles = blockwise_tiles(S, S, hd, torch.float32, *blocks)
            label = str(tiles) if tiles == blocks else f"{blocks}->{tiles}"
            times[label] = cs.cuda_time_ms(
                lambda: fused_attention_blockwise(q, k, v, bias, N, *blocks),
                iters=iters)
        times["SDPA"] = cs.sdpa_ms(q, k, v, bias, N, iters)
        print(f"S={S} bias={kind} (K1 at {K1_FP32_TILES}): " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in times.items()) + " ms")
        del q, k, v, bias
    table = []
    for tag, B, Sq, Sk, N, kind in SMALL_SHAPES:
        q, k, v, bias = cs.attention_inputs(B, Sq, Sk, torch.float32, kind,
                                            gen, N=N)
        if kind == "packed":
            bias = bias.contiguous()
        times = []
        for blocks in cs.TF32_WGMMA_TILINGS:
            if not args.no_check:
                cs.attention_close(fused_attention_blockwise(
                    q, k, v, bias, N, *blocks), attention_reference(
                        q, k, v, bias, N), f"K2 fp32 {tag} {blocks}")
            ms = cs.kernel_device_ms(lambda: fused_attention_blockwise(
                q, k, v, bias, N, *blocks), seconds=0.3)
            times.append(f"{blocks} {ms:.4f}")
        table.append(f"{tag} " + " ".join(times))
        del q, k, v, bias
    print("device ms a launch: " + "; ".join(table))
    if args.save is not None:
        torch.save({S: out.cpu() for S, out in outputs.items()}, args.save)
    for name, regs, _, spill in cs.ptxas_rows(
            build.build_log("blockwise_attention")):
        if "tf32" in name:
            print(f"  {name}: {regs} registers, {spill} bytes spilled")
    return 0


if __name__ == "__main__":
    sys.exit(main())
