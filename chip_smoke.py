#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`icka_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero:

  1. build every CUDA kernel from `icka_tpu_torch/kernels/csrc` (one nvcc
     per source, all started together), count the tensor-core instructions
     in the blockwise library (bf16 HMMA and TF32 HMMA apart) and in the
     int8 library (IMMA, and no dp4a left), check that no fp32 CUDA-core
     attention instance is left at widths up to 128, print registers and
     spills of every instance, and print the card's name and power limit as
     nvidia-smi gives them;
  2. hold every kernel against its plain PyTorch version on the card at the
     main paths' shapes: K1 `fused_attention` and K2
     `fused_attention_blockwise` (up to width 128 on the blockwise kernel's
     tensor-core bodies, bf16 and 3xTF32) in fp32 (TF32 off for the plain
     versions) and bf16 within a tolerance, at every head width they are
     built for (up to 256), at four widths they zero-pad (8, 24, 40, 144)
     and at two above 256 (272, 512: column chunks); K2 against
     its plain version and against K1 over ragged and long shapes, three
     bias forms, three tilings and a -inf key tile in both types; K3-K6, the
     int8 conv kernels, bit-equal at the four ResNet stage shapes in every
     output mode;
  3. serve requests through the flagship at full width (two 24-layer
     RoBERTa-large stacks, ResNet-152, random weights from `--seed`):
     sentences of the synthetic vocabulary -> convert_examples (the
     byte-level BPE tokenizer over that vocabulary; its `PromptSpec` gives
     the servers their prompt offset and mask positions), uint8 images ->
     preprocess_images -> VisualBackbone -> BucketedICKAServer.predict,
     once with `use_pallas=True` (the kernel) and once with the plain
     attention core on the same weights, in fp32; then the kernel path
     once in bf16;
  4. serve the same requests with the int8-static visual half: phase 3's
     float ResNet-152 is calibrated in the dynamic int8 mode on the request
     images, quantised offline, and served with `fused_pallas=True` (K5 once
     and K4 46 times per backbone call) in front of phase 3's bf16 flagship;
     the same backbone on the kernels' plain versions must give a
     bit-identical `att`, and the fused stem the unfused stem's output;
  5. serve the requests of phase 3 sequence-packed
     (`PackedICKAServer`, `masked_lstm=True`, phase 3's weights): K1 runs 48
     times per device batch on block-diagonal (B, 1, L, L) masks; tags must
     agree with the plain-core packed path and with the bucketed server;
  6. evaluate: write a synthetic test split of 67 rows (no image files: no
     PIL needed) and a checkpoint of phase 3's weights with the port's own
     msgpack writer, run `icka_tpu_torch.cli.evaluate.main` on it in bf16
     with batches of 8 (K1 48 times a batch, the loss finite, every row
     evaluated), then hold the first batch's fp32 emissions through K1 to
     the plain core's on the same checkpoint;
  7. time each kernel at its main-path shape beside its plain version, the
     PyTorch library call for the same function where there is one, its
     bound and its recorded time before its redesign (comment lines only);
     K1's tilings in bf16 and in fp32; K1 and K2 in fp32 at K1's two
     shapes; both at the first head width above 256; time the served
     requests end to end.

The line before the last is the `{"kernels": [...]}` JSON object; the last
line is `{"ok": true, "device": {...}}`. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from icka_tpu_torch.cli import evaluate as evaluate_cli
from icka_tpu_torch.convert import (backbone_variables_from_state_dict,
                                    icka_variables_from_state_dict)
from icka_tpu_torch.core.checkpoint import Checkpointer
from icka_tpu_torch.core.config import ICKAConfig, TrainConfig, to_json
from icka_tpu_torch.core.device import strict_fp32
from icka_tpu_torch.data import native, synthetic
from icka_tpu_torch.data.clip_store import ClipFeatureStore
from icka_tpu_torch.data.conll import MMExample, read_mm_conll
from icka_tpu_torch.data.features import convert_examples
from icka_tpu_torch.data.images import preprocess_images
from icka_tpu_torch.data.loader import MNERLoader
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer
from icka_tpu_torch.kernels import build
from icka_tpu_torch.kernels import conv as kconv
from icka_tpu_torch.kernels.attention import (
    HEAD_DIMS, K1_FP32_TILES, K1_TILES, attention_blockwise_reference,
    attention_reference, blockwise_tiles, column_chunk, fused_attention,
    fused_attention_blockwise, kernel_width)
from icka_tpu_torch.models.convert import (calibration_amax,
                                           static_quantize_backbone)
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.models.resnet import (Bottleneck, ConvBN, StemPoolS2D,
                                          VisualBackbone)
from icka_tpu_torch.serving.bucketed import (BucketedICKAServer,
                                             sample_tweet_lengths)
from icka_tpu_torch.serving.packing import PackedICKAServer
from icka_tpu_torch.train.trainer import ICKATrainer

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12          # bf16 tensor cores
PEAK_TF32_FLOPS = 494.7e12        # TF32 tensor cores
PEAK_INT8_OPS = 1979e12           # int8 tensor cores
# An fp32 attention product held to fp32 runs as three TF32 products
# (3xTF32: hi*hi, hi*lo, lo*hi), so the least time for its operations is
# three times its FLOPs at the TF32 peak; the CUDA cores' 67 TFLOP/s fp32
# rate, the bound of fp32 products before, is no longer the fastest route.
TF32_PRODUCTS = 3
# An attention kernel against its plain version, and K2 against K1. fp32
# differs only in summation order (tests/test_kernels.py holds the TPU
# kernel to the same 2e-5). bf16 outputs are rounded to bf16 and the
# probabilities are rounded to bf16 before P.V (K2 rounds exp(s - m_running)
# where K1's plain version rounds the normalised probability), so two right
# results differ by a few bf16 steps of each output, and the outputs shrink
# with the number of keys (randn inputs: about sqrt(e / Sk)). So the bf16
# bound is taken from the data, element by element: BF16_STEPS steps of
# bf16 at the value's own size (a step is 2^-7 of its power of two), no
# finer than at the rms of all values, where the rounded probabilities'
# noise takes over; and the rms of the difference stays below BF16_REL_RMS
# of the values' rms (two results that each round once differ by 0.003).
FP32_TOL = 2e-5
BF16_STEPS = 6
BF16_REL_RMS = 1e-2
K2_SOURCE = "icka_tpu_torch/kernels/csrc/blockwise_attention.cu"
K2_TILINGS = ((32, 32), (16, 128), (128, 128))
# K2's times before its bf16 body moved to the tensor cores, B=128, 16x64
# bf16, asked for (128, 128), by Sq=Sk (chip_smoke.py phase 6 as of the
# third slice of the port, NVIDIA H100 80GB HBM3, 700.00 W). Recorded, not
# measured here: printed on a comment line for comparison, never put in the
# `kernels` line.
K2_CUDA_CORE_MS = {150: 0.8847, 172: 1.3611, 512: 5.6154, 1024: 21.4974}
# K1's bf16 times on its CUDA-core body, B=128, 16x64, key bias at 150,
# full block-diagonal bias at 172 (chip_smoke.py phase 6 as of the fifth
# slice of the port, NVIDIA H100 80GB HBM3, 700.00 W): recorded, printed on
# comment lines for comparison only. And the tilings of its tensor-core
# bodies timed beside K1_TILES and K1_FP32_TILES.
K1_CUDA_CORE_MS = {150: 1.0643, 172: 1.2439}
K1_TILINGS = ((64, 64), (128, 64), (64, 32), (32, 64))
# K1's and K2's fp32 times on their CUDA-core bodies at the same shapes, K2
# asked for (128, 128) (chip_smoke.py phase 6 as of the sixth slice of the
# port, NVIDIA H100 80GB HBM3, 700.00 W): recorded, printed on comment
# lines for comparison only
FP32_CUDA_CORE_MS = {"K1": {150: 1.0229, 172: 1.2261},
                     "K2": {150: 0.8798, 172: 1.3701}}
PADDED_HEAD_DIMS = (8, 24, 40, 144)    # widths the wrappers zero-pad
WIDE_HEAD_DIMS = (272, 512)       # above 256: the wide body's column chunks
PACKED_TIERS = ((48, 2), (128, 2))
# full-width emissions, kernel vs plain core in fp32: summation order differs
# in every self-attention of 48 layers, each product summing 64 terms and
# each softmax up to 150; LayerNorm keeps the error from compounding
EMISSIONS_TOL = 1e-3
LAYERS_PER_BATCH = 24 + 24        # self-attention layers of both stacks
MAX_BATCH, REQUESTS = 8, 16
# the tokenizer's files and the evaluate phase's corpus and checkpoint
# (about 4 GB) go here, under the gitignored build/; the evaluate phase
# removes its own when it ends
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
# the evaluate phase: the test split's rows (not a multiple of the batch, so
# the padded tail runs) and the CLI's batch; the rehearsal on the CPU adds
# "--tiny" to the CLI's flags
EVAL_ROWS, EVAL_BATCH, EVAL_CLI_FLAGS = 67, 8, ()
# the int8 conv kernels against their plain versions: bit-equal (exact
# integer sums, the same fp32 multiplies, adds and roundings)
CONV_STAGES = ((56, 64), (28, 128), (14, 256), (7, 512))    # (H, Cw)
CONV_SOURCE = "icka_tpu_torch/kernels/csrc/int8_conv.cu"
CHECK_CONV_LAUNCHES = True        # a CPU rehearsal launches no kernel
# K3-K6 at B=128 with their main loop on dp4a (chip_smoke.py phase 6 as of
# the fifth slice of the port, NVIDIA H100 80GB HBM3, 700.00 W): recorded,
# printed on comment lines for comparison only
CONV_DP4A_MS = {"int8_stem_pool": 1.5628, "int8_bottleneck_v2 H=14": 0.7419,
                "int8_bottleneck_v2 H=56": 1.2492, "int8_bottleneck": 0.7461,
                "int8_conv3x3": 0.3133}
# att of the int8-static ResNet-152 (50 blocks, random weights, BatchNorm
# statistics calibrated on the request images), as cosines. The JAX
# package's test holds a 2-stage net to 0.995 (fused vs unfused) and 0.99
# (fused vs float); see PERF.md for what 50 blocks measure and why the
# floors below are what that measurement supports.
COS_STAGE1_FUSED_VS_UNFUSED_MIN = 0.995
COS_STAGE1_FUSED_VS_FLOAT_MIN = 0.99
COS_FUSED_VS_UNFUSED_MIN = 0.4
COS_FUSED_VS_FLOAT_MIN = 0.4


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_close(out, want, what: str):
    """Hold `out` to `want` (see FP32_TOL); returns (max_abs_err, the
    largest share of its bound that any element's error takes)."""
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    if want.dtype == torch.float32:
        check(err <= FP32_TOL, f"{what}: max_abs_err {err} > {FP32_TOL}")
        return err, err / FP32_TOL
    size = want.float().abs()
    rms = size.square().mean().sqrt()
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(size, rms))) - 7)
    share = (diff / (BF16_STEPS * step)).max().item()
    check(share <= 1.0, f"{what}: an element is {share * BF16_STEPS:.2f} bf16 "
                        f"steps off > {BF16_STEPS} (max_abs_err {err})")
    rel = (diff.square().mean().sqrt() / rms).item()
    check(rel <= BF16_REL_RMS, f"{what}: rms of the difference is {rel} of "
                               f"the values' rms > {BF16_REL_RMS}")
    return err, share


# every kernel's wrapper, by the name of its row in the `kernels` line
COUNTERS = {
    "fused_attention": fused_attention,
    "fused_attention_blockwise": fused_attention_blockwise,
    "int8_conv3x3": kconv.int8_conv3x3,
    "int8_bottleneck_v2": kconv.int8_bottleneck_v2,
    "int8_stem_pool": kconv.int8_stem_pool,
    "int8_bottleneck": kconv.int8_bottleneck,
}
# kernels that no model calls, here as in the JAX package
NO_CALLER = ("fused_attention_blockwise", "int8_conv3x3", "int8_bottleneck")


def zero_counts():
    for wrapper in COUNTERS.values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in COUNTERS.items()}


def attention_inputs(B, Sq, Sk, dtype, bias_kind, gen, N=16, hd=64,
                     masked_tail=5):
    dev = "cuda"
    q = torch.randn(B, Sq, N * hd, device=dev, generator=gen).to(dtype)
    k = torch.randn(B, Sk, N * hd, device=dev, generator=gen).to(dtype)
    v = torch.randn(B, Sk, N * hd, device=dev, generator=gen).to(dtype)
    keep = torch.ones(B, Sk, device=dev)
    keep[:, Sk - masked_tail:] = 0
    key_bias = (1.0 - keep) * -10000.0
    if bias_kind == "B11Sk":
        bias = key_bias[:, None, None, :]
    elif bias_kind == "BSk":
        bias = key_bias
    elif bias_kind == "packed":
        # block-diagonal by slot, as `forward_packed` builds it: three
        # segments of a row and a padding tail that sees only itself
        def slots(S):
            return torch.arange(S, device=dev) * 7 // (2 * S)
        pair = slots(Sq)[None, :, None] == slots(Sk)[None, None, :]
        bias = ((~pair) * -10000.0).expand(B, Sq, Sk)[:, None]
    else:
        bias = (torch.randn(B, Sq, Sk, device=dev, generator=gen)
                + key_bias[:, None, :])
    return q, k, v, bias


def ptxas_rows(log: str):
    """(kernel, registers, static shared bytes, spill bytes) of every entry
    function in nvcc's `-Xptxas -v` output. A kernel is named by its
    function, its element type where it has one and the integers of its
    template arguments."""
    rows, name, spill = [], "", 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            # the nested name's length-prefixed parts; the kernel's is last
            base, pos = mangled, 3 if mangled.startswith("_ZN") else 2
            while (m := re.match(r"\d+", mangled[pos:])):
                pos += m.end()
                base = mangled[pos:pos + int(m.group())]
                pos += len(base)
            dtype = ("bf16 " if "bfloat16" in mangled else
                     "fp32 " if re.search(r"IfL", mangled) else "")
            name = (f"{base} {dtype}<"
                    + ",".join(re.findall(r"Li(\d+)E", mangled)) + ">")
        elif "spill stores" in line:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, regs, int(smem.group(1)) if smem else 0, spill))
    return rows


def sass_counts(name: str, opcodes) -> dict:
    """How many instructions of each opcode (HMMA.16816.F32.BF16: bf16
    tensor cores, HMMA.1688.F32.TF32: TF32 tensor cores, IMMA: int8 tensor
    cores, IDP: dp4a on the CUDA cores; a prefix of the SASS word) the SASS
    of a built library holds."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
    ops = [line.split(";")[0].split() for line in sass.stdout.splitlines()
           if "*/" in line and ";" in line]
    words = [w for op in ops for w in op]
    return {code: sum(w.startswith(code) for w in words) for code in opcodes}


def phase_build():
    t0 = time.perf_counter()
    build.build()
    print(f"# phase 1: built {list(build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    bf16_op, tf32_op = "HMMA.16816.F32.BF16", "HMMA.1688.F32.TF32"
    hmma = sass_counts("blockwise_attention", ("HMMA", bf16_op, tf32_op))
    print(f"#   blockwise_attention: {hmma['HMMA']} HMMA instructions in its "
          f"SASS: {hmma[bf16_op]} {bf16_op} (bf16 body), {hmma[tf32_op]} "
          f"{tf32_op} (3xTF32 body)")
    check(hmma[bf16_op] > 0, "the blockwise library has no bf16 HMMA")
    check(hmma[tf32_op] > 0, "the blockwise library has no TF32 HMMA")
    conv = sass_counts("int8_conv", ("IMMA", "IDP"))
    print(f"#   int8_conv: {conv['IMMA']} IMMA instructions in its SASS, "
          f"{conv['IDP']} IDP (dp4a)")
    check(conv["IMMA"] > 0, "the int8 library has no tensor-core instruction")
    check(conv["IDP"] == 0, "the int8 library still multiplies with dp4a")
    for name in build.SOURCES:
        rows = ptxas_rows(build.build_log(name))
        print(f"#   {name}: {len(rows)} kernels, at most "
              f"{max(r[1] for r in rows)} registers, "
              f"{sum(r[3] for r in rows)} bytes of spills in all")
        if name == "blockwise_attention":    # DPL = ceil(width / 32)
            narrow = [r[0] for r in rows if r[0].startswith(
                "blockwise_attention_kernel fp32 <") and int(
                r[0].split("<")[1].rstrip(">")) <= 4]
            check(not narrow, f"fp32 CUDA-core instances left at widths up "
                              f"to 128: {narrow}")
        for what, regs, smem, spill in rows:
            print(f"#     {what}: {regs} registers, {smem} bytes static "
                  f"smem, {spill} bytes spilled")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


BIAS_KINDS = ("B11Sk", "BSk", "BSqSk")


def main_path_lengths(spec, cfg):
    """K1's sequence lengths on the main paths: the bare sentence at the
    longest bucket and in evaluation (max_seq_length), the prompted
    encoder's spliced layout at the longest bucket and in evaluation, and
    the packed server's layout-B rows (block-diagonal)."""
    head = spec.offset - 2 + 2 * cfg.prompt_len
    return (cfg.max_seq_length, head + cfg.max_seq_length,
            spec.max_input_length - 2 + 2 * cfg.prompt_len,
            tuple(L + S * head for L, S in PACKED_TIERS))


def phase_kernel_vs_plain(gen, spec, cfg):
    bare, prompted, evaluated, packed = main_path_lengths(spec, cfg)
    print(f"# phase 2: K1 fused_attention vs attention_reference "
          f"(B=8, 16 heads x 64) at the main paths' lengths: bare "
          f"{bare}, prompted {prompted} (bucketed) and {evaluated} "
          f"(evaluation), packed layout B {packed}")
    for dtype in (torch.float32, torch.bfloat16):
        for Sq, Sk, kinds in (
                (23, 23, BIAS_KINDS), (bare, bare, BIAS_KINDS),
                (prompted, prompted, BIAS_KINDS),
                (evaluated, evaluated, BIAS_KINDS),
                (prompted, 23, BIAS_KINDS),
                *((L, L, ("packed",)) for L in packed)):
            for kind in kinds:
                q, k, v, bias = attention_inputs(8, Sq, Sk, dtype, kind, gen)
                out = fused_attention(q, k, v, bias, 16)
                torch.cuda.synchronize()
                want = attention_reference(q, k, v, bias, 16)
                check(out.dtype == dtype and out.shape == q.shape,
                      f"K1 output {out.dtype} {tuple(out.shape)}")
                err, share = attention_close(
                    out, want, f"K1 {dtype} Sq={Sq} Sk={Sk} {kind}")
                print(f"#   {str(dtype)[6:]:8s} Sq={Sq:3d} Sk={Sk:3d} "
                      f"bias={kind:6s} max_abs_err={err:.3e} "
                      f"({share:.2f} of its bound)")


def phase_head_widths(gen):
    """K1 and K2 at every head width they have an instance for, beside the
    main path's 64 (the JAX package's tests run 16 and 32), at widths the
    wrappers zero-pad to the next instance, and at two above 256 (the wide
    body in column chunks), each call one launch of its kernel."""
    widths = ([w for w in HEAD_DIMS if w != 64] + list(PADDED_HEAD_DIMS)
              + list(WIDE_HEAD_DIMS))
    print(f"# phase 2: K1 and K2 at head widths {widths} (B=8, 16 heads; "
          f"{list(PADDED_HEAD_DIMS)} and 272 zero-padded)")
    for hd in widths:
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            for Sq, Sk in ((23, 23), (150, 150), (150, 23)):
                for kind in BIAS_KINDS:
                    q, k, v, bias = attention_inputs(8, Sq, Sk, dtype, kind,
                                                     gen, hd=hd)
                    for name, fn, plain in (
                            ("K1", fused_attention, attention_reference),
                            ("K2", fused_attention_blockwise,
                             attention_blockwise_reference)):
                        before = fn.launches
                        out = fn(q, k, v, bias, 16)
                        torch.cuda.synchronize()
                        check(fn.launches == before + 1 and
                              out.shape == q.shape and out.dtype == dtype,
                              f"{name} head_dim={hd}: {fn.launches - before} "
                              f"launches, {out.dtype} {tuple(out.shape)}")
                        want = plain(q, k, v, bias, 16)
                        err, share = attention_close(
                            out, want, f"{name} head_dim={hd} {dtype} "
                                       f"Sq={Sq} Sk={Sk} {kind}")
                        key = (name, dtype)
                        worst[key] = max(worst.get(key, (0.0, 0.0)),
                                         (share, err))
        print(f"#   head_dim {hd:3d}: 9 cases per kernel and type, the case "
              f"nearest its bound: " + ", ".join(
                  f"{name} {str(dt)[6:]} {worst[name, dt][1]:.3e} "
                  f"({worst[name, dt][0]:.2f})"
                  for name in ("K1", "K2")
                  for dt in (torch.float32, torch.bfloat16)))


def phase_blockwise_vs_plain(gen):
    """K2 against its plain version and against K1 on the same inputs."""
    print("# phase 2: K2 fused_attention_blockwise vs "
          "attention_blockwise_reference and vs K1 (B=8, 16 heads; bias "
          f"forms key 4-D, key 2-D, full block-diagonal; tilings "
          f"{K2_TILINGS})")
    shapes = ((23, 23), (150, 150), (172, 172), (512, 512), (1024, 1024),
              (48, 256), (150, 23))
    n = 0
    for hd in (64, 16, 32):
        for dtype in (torch.float32, torch.bfloat16):
            for Sq, Sk in shapes:
                worst, shares = [0.0, 0.0], [0.0, 0.0]
                for i, kind in enumerate(("B11Sk", "BSk", "packed")):
                    q, k, v, bias = attention_inputs(8, Sq, Sk, dtype, kind,
                                                     gen, hd=hd)
                    k1 = fused_attention(q, k, v, bias, 16)
                    # every tiling at the main width, one in turn elsewhere
                    tilings = (K2_TILINGS if hd == 64 else
                               (K2_TILINGS[(i + n) % len(K2_TILINGS)],))
                    for blocks in tilings:
                        out = fused_attention_blockwise(q, k, v, bias, 16,
                                                        *blocks)
                        torch.cuda.synchronize()
                        check(out.dtype == dtype and out.shape == q.shape,
                              f"K2 output {out.dtype} {tuple(out.shape)}")
                        want = attention_blockwise_reference(
                            q, k, v, bias, 16, *blocks)
                        what = (f"K2 {dtype} head_dim={hd} Sq={Sq} Sk={Sk} "
                                f"{kind} tiling {blocks}")
                        for j, (ref, name) in enumerate((
                                (want, "the plain version"), (k1, "K1"))):
                            err, share = attention_close(
                                out, ref, f"{what} against {name}")
                            worst[j] = max(worst[j], err)
                            shares[j] = max(shares[j], share)
                        n += 1
                print(f"#   {str(dtype)[6:]:8s} head_dim={hd:2d} Sq={Sq:4d} "
                      f"Sk={Sk:4d} max_abs_err vs plain {worst[0]:.3e} "
                      f"({shares[0]:.2f} of its bound) vs K1 {worst[1]:.3e} "
                      f"({shares[1]:.2f})")
    # a caller's -inf over the first whole key tile of every second row
    bias = torch.zeros(8, 150, 300, device="cuda")
    bias[:, ::2, :128] = float("-inf")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = attention_inputs(8, 150, 300, dtype, "BSk", gen)
        for blocks in K2_TILINGS:
            out = fused_attention_blockwise(q, k, v, bias, 16, *blocks)
            torch.cuda.synchronize()
            what = f"K2 {dtype} -inf key tile, tiling {blocks}"
            check(bool(torch.isfinite(out).all()),
                  f"{what}: non-finite output")
            attention_close(out, attention_blockwise_reference(
                q, k, v, bias, 16, *blocks), f"{what} against its plain "
                                             f"version")
            attention_close(out, attention_reference(q, k, v, bias, 16),
                            f"{what} against the one-shot softmax")
            n += 1
        k1 = fused_attention(q, k, v, bias, 16)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k1).all()),
              f"K1 {dtype} -inf key tiles: non-finite output")
        attention_close(k1, attention_reference(q, k, v, bias, 16),
                        f"K1 {dtype} -inf key tiles")
    print(f"#   -inf over the first 128 keys of every second row: K2 and K1, "
          f"fp32 and bf16, finite and within their bounds of their plain "
          f"versions and of the one-shot softmax; {n} K2 comparisons in all")


def _int8(gen, *shape, lo=-127):
    return torch.randint(lo, 128, shape, device="cuda", generator=gen,
                         dtype=torch.int32).to(torch.int8)


def _per_channel(gen, n, centre, spread=0.5):
    """(n,) fp32 scales within `spread` of `centre`."""
    u = torch.rand(n, device="cuda", generator=gen)
    return centre * (1.0 - spread + 2.0 * spread * u)


def _normal(gen, *shape, std=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * std


# rms of uniform int8 in [-127, 127], and of a requantised ReLU output whose
# pre-activation has a standard deviation of 40 steps
_RMS_INT8, _RMS_RELU_Q, _STEPS = 73.3, 28.0, 40.0


def conv3x3_inputs(gen, B, H, C, F):
    """K3 operands whose epilogue values spread over the int8 range."""
    scale = _per_channel(gen, F, _STEPS / ((9 * C) ** 0.5 * _RMS_INT8 ** 2))
    return dict(x_pad=_int8(gen, B, H + 2, H + 2, C), w_q=_int8(gen, 9 * C, F),
                scale=scale, bias=_normal(gen, F, std=_STEPS / 4),
                residual=_normal(gen, B, H, H, F, std=_STEPS / 2))


def bottleneck_inputs(gen, B, H, Cw):
    """K4/K6 operands: x in [0, 127] as a block of a chain sees it, scales
    that keep every requantised intermediate spread over [0, 127]."""
    Cin = 4 * Cw
    x = _int8(gen, B, H, H, Cin, lo=0)
    x_rms = 73.5
    return [x, _int8(gen, Cin, Cw), _int8(gen, 9 * Cw, Cw),
            _int8(gen, Cw, Cin),
            _per_channel(gen, Cw, _STEPS / (Cin ** 0.5 * x_rms * _RMS_INT8)),
            _normal(gen, Cw, std=_STEPS / 4),
            _per_channel(gen, Cw, _STEPS / ((9 * Cw) ** 0.5 * _RMS_RELU_Q
                                            * _RMS_INT8)),
            _normal(gen, Cw, std=_STEPS / 4),
            _per_channel(gen, Cin, _STEPS / (Cw ** 0.5 * _RMS_RELU_Q
                                             * _RMS_INT8)),
            _normal(gen, Cin, std=_STEPS / 4)]


def stem_inputs(gen, B, OB=56, K=432, F=64):
    scale = _per_channel(gen, 4 * F, 1.0 / (K ** 0.5 * _RMS_INT8 ** 2))
    return [_int8(gen, B, OB, OB, K), _int8(gen, K, 4 * F), scale,
            _normal(gen, 4 * F, std=0.5)]


def check_equal(what, got, want, errs, key):
    """Bit-equality of a kernel's output with its plain version's."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    errs[key] = max(errs.get(key, 0.0), err)
    check(torch.equal(got, want), f"{what}: not bit-equal to the plain "
                                  f"version (max_abs_err {err})")
    if want.dtype == torch.int8:       # the data must exercise the rounding
        spread = want.float().std().item()
        clipped = (want.abs() == 127).float().mean().item()
        check(spread > 5.0 and clipped < 0.5,
              f"{what}: degenerate test data (std {spread}, share at the "
              f"clip {clipped})")
    return err


def phase_conv_kernels_vs_plain(gen, B=4):
    """K3-K6 against their plain versions, bit-equal. Returns the largest
    absolute error seen per kernel (0.0 when every check passed)."""
    print(f"# phase 2: K3-K6 int8 conv kernels vs plain versions, bit-equal "
          f"(B={B}, stages (H, Cw) = {CONV_STAGES})")
    errs, n = {}, 0
    for H, Cw in CONV_STAGES:
        a = conv3x3_inputs(gen, B, H, Cw, Cw)
        for res in (None, a["residual"], a["residual"].bfloat16()):
            for relu in (True, False):
                for out_scale, out_dtype in ((None, torch.bfloat16),
                                             (0.7, None)):
                    kw = dict(residual=res, relu=relu, out_scale=out_scale,
                              out_dtype=out_dtype or torch.bfloat16)
                    args = (a["x_pad"], a["w_q"], a["scale"], a["bias"])
                    check_equal(
                        f"K3 H={H} C={Cw} residual="
                        f"{None if res is None else res.dtype} relu={relu} "
                        f"out_scale={out_scale}",
                        kconv.int8_conv3x3(*args, **kw),
                        kconv.conv3x3_reference(*args, **kw), errs,
                        "int8_conv3x3")
                    n += 1
        args = bottleneck_inputs(gen, B, H, Cw)
        rs = torch.tensor([0.37], device="cuda")
        Wp = -(-(H + 2) // 32) * 32
        xp = _int8(gen, B, H + 2, Wp, 4 * Cw)       # arbitrary borders
        xp[:, 1:H + 1, 1:H + 1] = args[0]
        for out_bf16 in (False, True):
            want = kconv.bottleneck_v2_reference(*args, rs, out_bf16)
            padded = torch.zeros_like(xp, dtype=want.dtype)
            padded[:, 1:H + 1, 1:H + 1] = want
            for g in (1, 2):
                check_equal(f"K4 H={H} Cw={Cw} out_bf16={out_bf16} g={g}",
                            kconv.int8_bottleneck_v2(*args, rs, out_bf16, g),
                            want, errs, "int8_bottleneck_v2")
                check_equal(f"K4 H={H} Cw={Cw} out_bf16={out_bf16} g={g} "
                            f"padded_io", kconv.int8_bottleneck_v2(
                                xp, *args[1:], rs, out_bf16, g, True),
                            padded, errs, "int8_bottleneck_v2")
                n += 2
            check_equal(f"K6 H={H} Cw={Cw} out_bf16={out_bf16}",
                        kconv.int8_bottleneck(*args, 0.37, out_bf16),
                        kconv.bottleneck_reference(*args, 0.37, out_bf16),
                        errs, "int8_bottleneck")
            n += 1
    for OB in (56, 20):                    # 20: ragged tiles in both axes
        args = stem_inputs(gen, B, OB)
        check_equal(f"K5 OB={OB}", kconv.int8_stem_pool(*args),
                    kconv.stem_pool_reference(*args), errs, "int8_stem_pool")
        n += 1
    print(f"#   {n} comparisons bit-equal: " + ", ".join(
        f"{k} max_abs_err={v}" for k, v in errs.items()))
    return errs


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def calibrate_batch_stats(backbone, images):
    """Give random conv weights the running statistics a trained ResNet's
    BatchNorm holds: each ConvBN's mean/var become those of its raw conv
    output on `images` (in forward order, so every layer sees calibrated
    inputs). Without it the residual sums of 50 blocks grow to ~1e7."""
    def pre_hook(mod, args):
        x = args[0].float()
        raw = F.conv2d(x, mod.conv.weight, stride=mod.stride,
                       padding=mod.kernel // 2)
        mod.mean.copy_(raw.mean(dim=(0, 2, 3)))
        mod.var.copy_(raw.var(dim=(0, 2, 3), unbiased=False))
    hooks = [m.register_forward_pre_hook(pre_hook)
             for m in backbone.modules() if isinstance(m, ConvBN)]
    try:
        with torch.no_grad():
            backbone(images)
    finally:
        for h in hooks:
            h.remove()


def prompt_tokenizer():
    """The byte-level BPE tokenizer over the synthetic vocabulary, and the
    prompt layout (`PromptSpec`) it gives the flagship's features."""
    tokenizer = tiny_tokenizer(str(WORK_DIR / "tokenizer"))
    spec = convert_examples([MMExample(["a"], ["O"])], tokenizer).spec
    return tokenizer, spec


def synthetic_sentence(n_words, rng):
    """`n_words` words of the synthetic vocabulary, each entity word
    labelled B- with its type, filler O."""
    words = [synthetic.VOCAB_WORDS[i]
             for i in rng.integers(0, len(synthetic.VOCAB_WORDS), n_words)]
    kinds = {w: kind for kind, pool in (
        ("PER", synthetic.PEOPLE), ("LOC", synthetic.PLACES),
        ("ORG", synthetic.ORGS), ("MISC", synthetic.MISCS)) for w in pool}
    return MMExample(words, [f"B-{kinds[w]}" if w in kinds else "O"
                             for w in words])


def make_requests(cfg, n, rng, tokenizer):
    """`n` (sentence, image) requests: sentences of the synthetic
    vocabulary whose lengths are drawn as `sample_tweet_lengths` draws
    subtoken counts (words = length - 2 for <s> and </s>; a word may take
    several subtokens), one long enough for the 128 bucket, turned into
    the server's inputs by `convert_examples`; random CLIP features and
    uint8 images. Returns (texts, images, PromptSpec)."""
    lens = sample_tweet_lengths(n, rng)
    if lens.max() <= 64:             # cover the long buckets too
        lens[-1] = rng.integers(65, cfg.max_seq_length + 1)
    examples = [synthetic_sentence(int(L) - 2, rng) for L in lens]
    for i, ex in enumerate(examples):
        ex.img_id = f"{i}.jpg"
    clip = {str(i): rng.standard_normal(cfg.clip_dim).astype(np.float32)
            for i in range(n)}
    feats = convert_examples(examples, tokenizer, cfg.max_seq_length, clip,
                             cfg.clip_dim)
    spec = feats.spec
    texts = []
    for i in range(n):
        L = int(feats.ori_input_mask[i].sum())
        texts.append({"ori_input_ids": feats.ori_input_ids[i, :L],
                      "input_ids": feats.input_ids[i, :spec.offset + L],
                      "clip_features": feats.clip_features[i, 0]})
    images = rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
    return texts, images, spec


def serve(server, backbone, texts, images):
    """The main path: images -> preprocess -> backbone -> predict. Also
    returns the host-clock seconds of the visual half and of the text half
    (`predict`), each ending in a synchronise."""
    t0 = time.perf_counter()
    with torch.inference_mode():
        pixels = preprocess_images(images, 224, device=server.device)
        _, fc, att = backbone(pixels)
    sync(server.device)
    t1 = time.perf_counter()
    examples = [dict(t, visual_mean=fc[i], visual_grid=att[i])
                for i, t in enumerate(texts)]
    tags, stats = server.predict(examples)
    sync(server.device)
    return tags, stats, examples, (t1 - t0, time.perf_counter() - t1)


def device_profile(fn, top=8):
    """torch.profiler over one call of `fn`: total device seconds, the
    `top` device kernels by time, and K1's own row (name, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: an operator's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = sorted(kernels, key=dev_us, reverse=True)[:top]
    rows += [e for e in kernels
             if "attention" in e.key and "kernel" in e.key and e not in rows]
    return (sum(dev_us(e) for e in kernels) / 1e6,
            [(e.key, dev_us(e) / 1e3, e.count) for e in rows])


def first_batch_emissions(server, examples, models, spec):
    """Emissions of each model on the server's first device batch."""
    with torch.inference_mode():
        _, _, _, batch = next(server.batches(examples))
        return [m.batch_emissions(batch, spec.mask_positions, spec.offset)
                for m in models]


def agreement(a, b):
    same = sum(int((x == y).sum()) for x, y in zip(a, b))
    return same / sum(len(x) for x in a)


def phase_slice(args, card, dev, base, resnet_layers, tokenizer):
    print("# phase 3: full-width flagship serving (ICKAConfig(), ResNet-152)")
    strict_fp32()
    cfgs = {p: dataclasses.replace(
        base,
        embedding=dataclasses.replace(base.embedding, use_pallas=p),
        last_encoder=dataclasses.replace(base.last_encoder, use_pallas=p))
        for p in (True, False)}
    t0 = time.perf_counter()
    model = ICKAModel(cfgs[True], device=dev, seed=args.seed).eval()
    plain = ICKAModel(cfgs[False], device=dev, seed=args.seed).eval()
    plain.load_state_dict(model.state_dict(), assign=True)
    model16 = ICKAModel(cfgs[True], dtype=torch.bfloat16, device=dev,
                        seed=args.seed).eval()
    model16.load_state_dict(model.state_dict(), assign=True)
    backbone = VisualBackbone(resnet_layers, device=dev,
                              seed=args.seed + 1).eval()
    backbone16 = VisualBackbone(resnet_layers, dtype=torch.bfloat16,
                                device=dev, seed=args.seed + 1).eval()
    rng = np.random.default_rng(args.seed)
    texts, images, spec = make_requests(base, REQUESTS, rng, tokenizer)
    calibrate_batch_stats(backbone, preprocess_images(images, 224, dev))
    backbone16.load_state_dict(backbone.state_dict(), assign=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"#   built ICKA ({n_params / 1e6:.1f} M params) + ResNet-152 in "
          f"{time.perf_counter() - t0:.1f} s; request lengths "
          f"{[len(t['ori_input_ids']) for t in texts]}; prompt offset "
          f"{spec.offset}, mask positions {spec.mask_positions}")

    servers = {name: BucketedICKAServer(m, max_batch=MAX_BATCH,
                                        offset=spec.offset,
                                        mask_positions=spec.mask_positions,
                                        device=dev)
               for name, m in (("kernel", model), ("plain", plain),
                               ("kernel_bf16", model16))}
    backbones = {"kernel": backbone, "plain": backbone,
                 "kernel_bf16": backbone16}
    runs = {}
    for name in ("kernel", "plain", "kernel_bf16"):
        zero_counts()
        tags, stats, examples, _ = serve(servers[name], backbones[name],
                                         texts, images)
        counts = read_counts()
        launches = counts["fused_attention"]
        n_batches = sum(stats.batches_per_bucket.values())
        runs[name] = dict(tags=tags, stats=stats, examples=examples,
                          launches=launches, batches=n_batches, counts=counts)
        print(f"#   {name}: pairs per bucket {stats.pairs_per_bucket}, "
              f"{n_batches} device batches, K1 launches {launches}")
        check(stats.total_pairs == len(texts), f"{name}: pairs lost")
        for t, tx in zip(tags, texts):
            check(len(t) == min(len(tx["ori_input_ids"]),
                                base.max_seq_length)
                  and t.min() >= 0 and t.max() < base.num_labels,
                  f"{name}: bad tags {t}")
    stats = runs["kernel"]["stats"]
    check(len(stats.pairs_per_bucket) >= 2
          and max(stats.pairs_per_bucket) > 64,
          f"requests cover buckets {list(stats.pairs_per_bucket)}")
    for name in ("kernel", "kernel_bf16"):
        check(runs[name]["launches"]
              == LAYERS_PER_BATCH * runs[name]["batches"],
              f"{name}: K1 launched {runs[name]['launches']} times for "
              f"{runs[name]['batches']} batches")
    check(runs["plain"]["launches"] == 0, "plain path launched K1")

    em_k, em_p = first_batch_emissions(
        servers["kernel"], runs["kernel"]["examples"], (model, plain), spec)
    check(bool(torch.isfinite(em_k).all()), "non-finite emissions")
    em_err = (em_k - em_p).abs().max().item()
    agree = agreement(runs["kernel"]["tags"], runs["plain"]["tags"])
    agree16 = agreement(runs["kernel_bf16"]["tags"], runs["kernel"]["tags"])
    print(f"#   fp32 emissions kernel vs plain: max_abs_err {em_err:.3e} "
          f"(tol {EMISSIONS_TOL:.0e}, |emissions| max "
          f"{em_k.abs().max().item():.3f})")
    print(f"#   tag agreement kernel vs plain (fp32): {agree:.6f}")
    (em_16,) = first_batch_emissions(
        servers["kernel_bf16"], runs["kernel_bf16"]["examples"], (model16,),
        spec)
    top2 = em_k.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).median().item()
    print(f"#   tag agreement bf16 kernel path vs fp32 kernel path: "
          f"{agree16:.6f} (bf16 emissions max_abs_err "
          f"{(em_16.float() - em_k).abs().max().item():.3e} vs fp32; median "
          f"top-2 emission margin {margin:.3e} with random weights)")
    check(em_err <= EMISSIONS_TOL, f"emissions differ by {em_err}")
    check(agree >= 0.99, f"tag agreement {agree} < 0.99")

    pairs_per_s = {}
    for name in ("kernel", "kernel_bf16"):
        run = lambda: serve(servers[name], backbones[name], texts, images)
        best = min((run()[3] for _ in range(3)), key=sum)
        pairs_per_s[name] = len(texts) / sum(best)
        print(f"#   {name}: {pairs_per_s[name]:.2f} pairs/s end to end "
              f"({len(texts)} requests, max_batch {MAX_BATCH}, best of 3: "
              f"visual {best[0] * 1e3:.1f} ms + predict {best[1] * 1e3:.1f} "
              f"ms) on {card}")
        try:
            busy, rows = device_profile(run)
        except Exception as e:   # the profiler is a report, not a check
            print(f"#   {name}: device profile not measured ({e!r})")
            continue
        print(f"#   {name}: device busy {busy * 1e3:.1f} ms of "
              f"{sum(best) * 1e3:.1f} ms wall ({busy / sum(best):.3f}); top "
              f"kernels by device time, then K1 (profiled run):")
        for key, ms, calls in rows:
            print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    ctx = dict(texts=texts, images=images, backbone=backbone, spec=spec,
               cfgs=cfgs, weights=model.state_dict(),
               backbone_bf16=backbone16, server_bf16=servers["kernel_bf16"],
               tags_bf16=runs["kernel_bf16"]["tags"],
               max_seq_length=base.max_seq_length,
               num_labels=base.num_labels)
    return runs["kernel"]["counts"], pairs_per_s, ctx


def phase_packed(args, card, dev, ctx):
    """Sequence-packed serving of phase 3's requests on phase 3's weights.
    Returns every kernel's launch count over the fp32 kernel-path run."""
    print(f"# phase 5: packed flagship serving at full width (PackedICKAServer"
          f", tiers {PACKED_TIERS}, max_batch {MAX_BATCH}, masked_lstm=True)")
    texts, images = ctx["texts"], ctx["images"]

    def model_for(pallas, dtype=torch.float32):
        cfg = dataclasses.replace(ctx["cfgs"][pallas], masked_lstm=True)
        m = ICKAModel(cfg, dtype=dtype, device=dev, seed=args.seed).eval()
        m.load_state_dict(ctx["weights"], assign=True)
        return m

    models = {"kernel": model_for(True), "plain": model_for(False),
              "kernel_bf16": model_for(True, torch.bfloat16)}
    backbones = {"kernel": ctx["backbone"], "plain": ctx["backbone"],
                 "kernel_bf16": ctx["backbone_bf16"]}
    spec = ctx["spec"]
    kw = dict(mask_positions=spec.mask_positions, offset=spec.offset,
              max_batch=MAX_BATCH, device=dev)
    packed = {name: PackedICKAServer(m, tiers=PACKED_TIERS, **kw)
              for name, m in models.items()}
    bucketed = BucketedICKAServer(models["kernel"], **kw)
    cfg = models["kernel"].cfg
    for L, S in PACKED_TIERS:
        print(f"#   tier ({L}, {S}): layout A {L} tokens, layout B "
              f"{L + S * (spec.offset - 2 + 2 * cfg.prompt_len)} tokens")
    packed["kernel"].warmup()

    runs = {}
    for name, server in packed.items():
        zero_counts()
        tags, stats, _, _ = serve(server, backbones[name], texts, images)
        counts = read_counts()
        runs[name] = dict(tags=tags, stats=stats, counts=counts,
                          launches=counts["fused_attention"])
        print(f"#   {name}: {stats}, K1 launches {runs[name]['launches']}")
        check(stats.pairs == len(texts) and stats.batches >= 2,
              f"{name}: {stats}")
        for t, tx in zip(tags, texts):
            check(t is not None
                  and len(t) == min(len(tx["ori_input_ids"]),
                                    PACKED_TIERS[-1][0])
                  and t.min() >= 0 and t.max() < cfg.num_labels,
                  f"packed {name}: bad tags {t}")
    for name in ("kernel", "kernel_bf16"):
        check(runs[name]["launches"]
              == LAYERS_PER_BATCH * runs[name]["stats"].batches,
              f"packed {name}: K1 launched {runs[name]['launches']} times "
              f"for {runs[name]['stats'].batches} batches")
    check(runs["plain"]["launches"] == 0, "packed plain path launched K1")
    bucket_tags, _, _, _ = serve(bucketed, ctx["backbone"], texts, images)
    agree = agreement(runs["kernel"]["tags"], runs["plain"]["tags"])
    agree_b = agreement(runs["kernel"]["tags"], bucket_tags)
    agree16 = agreement(runs["kernel_bf16"]["tags"], runs["kernel"]["tags"])
    print(f"#   tag agreement packed kernel path vs packed plain-core path "
          f"(fp32): {agree:.6f}; packed vs bucketed server, same model "
          f"(fp32): {agree_b:.6f}; packed bf16 vs packed fp32: "
          f"{agree16:.6f} (random weights)")
    check(agree >= 0.99, f"packed kernel vs plain tag agreement {agree}")
    check(agree_b >= 0.99, f"packed vs bucketed tag agreement {agree_b}")

    # smoke figures: 16 requests, not a benchmark
    for name, server, backbone in (
            ("packed fp32", packed["kernel"], ctx["backbone"]),
            ("bucketed fp32 (masked_lstm)", bucketed, ctx["backbone"]),
            ("packed bf16", packed["kernel_bf16"], ctx["backbone_bf16"])):
        run = lambda: serve(server, backbone, texts, images)
        best = min((run()[3] for _ in range(3)), key=sum)
        print(f"#   {name}: {len(texts) / sum(best):.2f} pairs/s end to end, "
              f"a smoke figure ({len(texts)} requests, best of 3: visual "
              f"{best[0] * 1e3:.1f} ms + predict {best[1] * 1e3:.1f} ms) on "
              f"{card}")
        try:
            busy, rows = device_profile(run)
        except Exception as e:   # the profiler is a report, not a check
            print(f"#   {name}: device profile not measured ({e!r})")
            continue
        print(f"#   {name}: device busy {busy * 1e3:.1f} ms of "
              f"{sum(best) * 1e3:.1f} ms wall ({busy / sum(best):.3f}); top "
              f"kernels by device time, then K1 (profiled run):")
        for key, ms, calls in rows:
            print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    return runs["kernel"]["counts"]


def write_checkpoint(out, cfg, weights, backbone):
    """The JAX package's checkpoint directory (config.json, manifest,
    state_best.msgpack) of the flagship's and the backbone's weights,
    written through the weight bridge and the port's own msgpack writer.
    Returns its seconds and bytes."""
    t0 = time.perf_counter()
    ck = Checkpointer(str(out))
    ck.save_config(to_json(cfg))
    ck.save({"step": 0,
             "params": icka_variables_from_state_dict(weights)["params"],
             "backbone_variables": backbone_variables_from_state_dict(
                 backbone.state_dict())}, step=0, metric=0.0, best_only=True)
    return (time.perf_counter() - t0,
            os.path.getsize(out / "state_best.msgpack"))


def native_status() -> str:
    """Whether the repo's native JPEG decoder loaded, and why not."""
    if native.native_available():
        return "loaded"
    try:
        ctypes.CDLL(native._LIB_PATH)
    except OSError as e:
        return f"not loaded ({e})"
    return "not loaded"


def phase_evaluate(args, card, dev, ctx):
    """The evaluation entry point, `icka_tpu_torch.cli.evaluate.main`, at
    full width: a synthetic test split of EVAL_ROWS rows (no image files,
    so the loader yields zero images and needs no PIL; they still run
    the whole ResNet-152), a checkpoint written with the port's own writer
    (phase 3's flagship weights; phase 3's ResNet-152 weights with their
    BatchNorm statistics calibrated on this split's images), bf16, batches
    of EVAL_BATCH. Then, on the first batch, the same checkpoint at fp32:
    emissions through K1 against the plain attention core. Returns every
    kernel's launch count over the CLI run."""
    cfg = ctx["cfgs"][True]
    tiny = "--tiny" in EVAL_CLI_FLAGS
    layers, decode = ((1, 1, 1, 1), 64) if tiny else ((3, 8, 36, 3), 256)
    print(f"# phase 6: evaluate: python -m icka_tpu_torch.cli.evaluate at "
          f"full width (bf16, ResNet-152, {EVAL_ROWS} test rows, "
          f"--eval_batch_size {EVAL_BATCH}, use_pallas on both encoders)")
    root = WORK_DIR / "evaluate"
    shutil.rmtree(root, ignore_errors=True)
    ds, out = root / "ds", root / "out"
    generate_dataset(str(ds), n_train=0, n_valid=0, n_test=EVAL_ROWS,
                     clip_dim=cfg.clip_dim, seed=args.seed,
                     write_images=False)
    tokenizer = tiny_tokenizer(str(ds / "tokenizer"))
    feats = convert_examples(read_mm_conll(str(ds / "test.txt")), tokenizer,
                             cfg.max_seq_length,
                             ClipFeatureStore.from_split(str(ds), "test"),
                             cfg.clip_dim)
    spec = feats.spec
    batch = next(iter(MNERLoader(feats, str(ds / "images"), EVAL_BATCH,
                                 train=False, prefetch=0,
                                 decode_size=decode)))
    # BatchNorm statistics from the images this split feeds the backbone:
    # with phase 3's (calibrated on random images) the zero images give
    # visual features near 5e3, and the txt2img fusion, the same einsum
    # core on both paths, turns the bare-sentence encoder's 8e-6 between
    # the kernel and the plain core into 0.66 (tools/evaluate_emissions.py)
    backbone = VisualBackbone(layers, device=dev).eval()
    backbone.load_state_dict(ctx["backbone"].state_dict())
    calibrate_batch_stats(backbone, preprocess_images(
        batch["images"], min(224, decode), dev))
    write_s, size = write_checkpoint(out, cfg, ctx["weights"], backbone)
    del backbone
    t0 = time.perf_counter()
    state = Checkpointer(str(out)).restore_best()
    read_s = time.perf_counter() - t0
    print(f"#   checkpoint: {size / 1e9:.3f} GB written in {write_s:.2f} s, "
          f"read in {read_s:.2f} s (port's msgpack codec); native decoder "
          f"native/libicka_native.so {native_status()}")

    zero_counts()
    report = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        result = evaluate_cli.main([
            "--synthetic", str(ds), "--output_dir", str(out), "--split",
            "test", "--eval_batch_size", str(EVAL_BATCH), "--device",
            dev.type, *EVAL_CLI_FLAGS])
    sync(dev)
    cli_s = time.perf_counter() - t0
    counts = read_counts()
    for line in report.getvalue().rstrip("\n").split("\n"):
        print(f"#     {line}")
    k1 = counts["fused_attention"]
    print(f"#   {result.rows} rows in {result.batches} batches: eval loop "
          f"{result.seconds:.3f} s wall, {result.rows / result.seconds:.2f} "
          f"pairs/s (CLI {cli_s:.2f} s in all: corpus, features, models, "
          f"checkpoint, loop) on {card}; K1 launches {k1}")
    check(result.rows == EVAL_ROWS, f"evaluated {result.rows} rows of "
                                    f"{EVAL_ROWS}")
    check(result.batches == math.ceil(EVAL_ROWS / EVAL_BATCH),
          f"{result.batches} batches")
    check(math.isfinite(result.loss), f"loss {result.loss}")
    check(0.0 <= result.f1 <= 1.0, f"f1 {result.f1}")
    if LAYERS_PER_BATCH:
        check(k1 == LAYERS_PER_BATCH * result.batches,
              f"K1 launched {k1} times for {result.batches} batches")

    # the first batch at fp32: K1 against the plain core, same checkpoint
    strict_fp32()
    trainer = ICKATrainer(cfg, TrainConfig(compute_dtype="float32"), spec,
                          resnet_layers=layers, device=dev)
    trainer.state_from_checkpoint(state)
    del state
    plain = ICKAModel(ctx["cfgs"][False], device=dev).eval()
    plain.load_state_dict(trainer.model.state_dict(), assign=True)
    trainer16 = ICKATrainer(cfg, TrainConfig(compute_dtype="bfloat16"),
                            spec, resnet_layers=layers, device=dev)
    trainer16.model.load_state_dict(trainer.model.state_dict(), assign=True)
    trainer16.backbone.load_state_dict(trainer.backbone.state_dict(),
                                       assign=True)
    with torch.inference_mode():
        inputs = trainer.model_inputs(batch)
        em_k, em_p = (m.batch_emissions(inputs, spec.mask_positions,
                                        spec.offset)
                      for m in (trainer.model, plain))
        mask = inputs["output_mask"]
        tags_k, tags_p = (trainer.model.crf.decode(e, mask)
                          for e in (em_k, em_p))
        tags16, _ = trainer16.eval_step(batch)
    sync(dev)
    valid = mask.bool()
    err = (em_k - em_p).abs().max().item()
    agree = (tags_k == tags_p)[valid].float().mean().item()
    agree16 = (tags16 == tags_k)[valid].float().mean().item()
    print(f"#   first batch at fp32, the same checkpoint: visual_mean max "
          f"|x| {inputs['visual_mean'].abs().max().item():.3e}; emissions "
          f"K1 vs plain core max_abs_err {err:.3e} (tol "
          f"{EMISSIONS_TOL:.0e}), tag agreement {agree:.6f}; bf16 tags vs "
          f"fp32 tags {agree16:.6f} (random weights: not held)")
    check(bool(torch.isfinite(em_k).all()), "non-finite emissions")
    check(err <= EMISSIONS_TOL, f"evaluate: emissions differ by {err}")

    # the bf16 loop again on the CLI's weights: its wall once more, then
    # its device time under the profiler (a report, not a check)
    loader = MNERLoader(feats, str(ds / "images"), EVAL_BATCH, train=False,
                        decode_size=decode)
    again = trainer16.evaluate(loader)
    print(f"#   the bf16 eval loop again: {again.seconds:.3f} s wall, "
          f"{again.rows / again.seconds:.2f} pairs/s, loss "
          f"{again.loss:.6f} (CLI {result.loss:.6f})")
    try:
        busy, rows = device_profile(lambda: trainer16.evaluate(loader))
        print(f"#   eval loop: device busy {busy * 1e3:.1f} ms of "
              f"{again.seconds * 1e3:.1f} ms wall ({busy / again.seconds:.3f}"
              f"); top kernels by device time, then K1 (profiled run):")
        for key, ms, calls in rows:
            print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    except Exception as e:       # the profiler is a report, not a check
        print(f"#   eval loop device profile not measured ({e!r})")
    shutil.rmtree(root)
    return counts


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def backbone_with_stage_ends(backbone, pixels, layers):
    """(pooled, fc, att) and the feature map after the last block of each
    stage."""
    ends, hooks = [], []
    for stage, n in enumerate(layers):
        block = getattr(backbone.resnet, f"layer{stage + 1}_{n - 1}")
        hooks.append(block.register_forward_hook(
            lambda mod, args, output: ends.append(output)))
    try:
        return backbone(pixels), ends
    finally:
        for h in hooks:
            h.remove()


def visual_ms(backbone, images, dev, repeats=3):
    """Best host-clock time of preprocess + backbone over `images`."""
    best = float("inf")
    for _ in range(repeats + 1):                   # the first run warms up
        t0 = time.perf_counter()
        with torch.inference_mode():
            backbone(preprocess_images(images, 224, device=dev))
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def phase_int8_visual(args, card, dev, ctx, resnet_layers):
    """The int8-static visual half in front of phase 3's bf16 flagship.
    Returns every kernel's launch count over the main-path run."""
    print("# phase 4: int8-static ResNet serving (quant=int8_static, bf16, "
          "fused_pallas=True)")
    texts, images, float_backbone = (ctx["texts"], ctx["images"],
                                     ctx["backbone"])
    t0 = time.perf_counter()
    with torch.inference_mode():
        pixels = preprocess_images(images, 224, device=dev)
        dyn = VisualBackbone(resnet_layers, dtype=torch.bfloat16,
                             quant="int8", device=dev).eval()
        dyn.load_state_dict(float_backbone.state_dict(), strict=True)
        dyn(pixels)
    calib = calibration_amax(dyn)
    del dyn
    models = {name: VisualBackbone(resnet_layers, dtype=torch.bfloat16,
                                   quant="int8_static", device=dev,
                                   **kw).eval()
              for name, kw in (
                  ("fused", dict(fused_pallas=True)),
                  ("fused_plain", dict(fused_pallas=True,
                                       plain_kernels=True)),
                  ("unfused", {}))}
    static_sd = static_quantize_backbone(
        models["fused"].state_dict().keys(), float_backbone.state_dict(),
        calib)
    for name, m in models.items():
        m.load_state_dict({k: v for k, v in static_sd.items()
                           if k in m.state_dict()}, strict=True)
    identity_blocks = sum(n - 1 for n in resnet_layers)
    print(f"#   calibrated {len(calib)} ConvBN on the request images "
          f"(act amax {min(calib.values()):.3f}..{max(calib.values()):.3f})"
          f", quantised and loaded 3 backbones in "
          f"{time.perf_counter() - t0:.1f} s")

    server = ctx["server_bf16"]
    zero_counts()
    tags, stats, _, _ = serve(server, models["fused"], texts, images)
    counts = read_counts()
    k5, k4, k1 = (counts[name] for name in (
        "int8_stem_pool", "int8_bottleneck_v2", "fused_attention"))
    n_batches = sum(stats.batches_per_bucket.values())
    print(f"#   fused: K5 launches {k5}, K4 launches {k4} (one backbone "
          f"call, {identity_blocks} identity blocks), K1 launches {k1} in "
          f"{n_batches} device batches")
    if CHECK_CONV_LAUNCHES:
        check(k5 == 1 and k4 == identity_blocks,
              f"K5 launched {k5} times and K4 {k4} times for one backbone "
              f"call with {identity_blocks} identity blocks")
        check(k1 == LAYERS_PER_BATCH * n_batches, f"K1 launched {k1} times")
    check(stats.total_pairs == len(texts), "int8 visual: pairs lost")
    for t, tx in zip(tags, texts):
        check(len(t) == min(len(tx["ori_input_ids"]),
                            ctx["max_seq_length"])
              and t.min() >= 0 and t.max() < ctx["num_labels"],
              f"int8 visual: bad tags {t}")

    with torch.inference_mode():
        out, stages = {}, {}
        for name, m in (*models.items(), ("float", float_backbone)):
            out[name], stages[name] = backbone_with_stage_ends(
                m, pixels, resnet_layers)
        att_float = out["float"][2]
        stems = [models[name].resnet.stem(pixels)
                 for name in ("fused", "unfused")]
    sync(dev)
    att = out["fused"][2]
    check(att.dtype == torch.bfloat16
          and tuple(att.shape) == (len(texts), 7, 7, 2048)
          and bool(torch.isfinite(att.float()).all()),
          f"int8 att {att.dtype} {tuple(att.shape)}")
    check(torch.equal(att, out["fused_plain"][2])
          and torch.equal(out["fused"][1], out["fused_plain"][1]),
          "att/fc of the kernel backbone differ from the plain-version "
          "backbone")
    check(torch.equal(*stems), "fused stem differs from the unfused stem")
    cos_unfused = cosine(att, out["unfused"][2])
    cos_float = cosine(att, att_float)
    cos_unfused_float = cosine(out["unfused"][2], att_float)
    print(f"#   att kernels vs plain versions: bit-identical; fused stem vs "
          f"unfused stem: bit-identical")
    print(f"#   att cosine fused vs unfused int8-static {cos_unfused:.6f} "
          f"(floor {COS_FUSED_VS_UNFUSED_MIN}), fused vs float "
          f"{cos_float:.6f} (floor {COS_FUSED_VS_FLOAT_MIN}), unfused vs "
          f"float {cos_unfused_float:.6f}")
    by_stage = [(cosine(f, u), cosine(f, x)) for f, u, x in zip(
        stages["fused"], stages["unfused"], stages["float"])]
    print("#   the same two cosines at the end of each stage (after "
          + ", ".join(str(sum(resnet_layers[:i + 1]))
                      for i in range(len(resnet_layers))) + " blocks): "
          + ", ".join(f"{a:.4f}/{b:.4f}" for a, b in by_stage))
    check(by_stage[0][0] >= COS_STAGE1_FUSED_VS_UNFUSED_MIN
          and by_stage[0][1] >= COS_STAGE1_FUSED_VS_FLOAT_MIN,
          f"cosines after the first stage {by_stage[0]}")
    check(cos_unfused >= COS_FUSED_VS_UNFUSED_MIN,
          f"att cosine fused vs unfused {cos_unfused}")
    check(cos_float >= COS_FUSED_VS_FLOAT_MIN,
          f"att cosine fused vs float {cos_float}")
    print(f"#   tag agreement with phase 3's bf16 run (float visual half): "
          f"{agreement(tags, ctx['tags_bf16']):.6f}")
    for name, m in (("int8 fused", models["fused"]),
                    ("int8 unfused", models["unfused"]),
                    ("float bf16", ctx["backbone_bf16"]),
                    ("float fp32", float_backbone)):
        print(f"#   visual half, {len(texts)} images, {name}: "
              f"{visual_ms(m, images, dev):.2f} ms (best of 3, host clock "
              f"to a synchronise) on {card}")
    run = lambda: serve(server, models["fused"], texts, images)
    best = min((run()[3] for _ in range(3)), key=sum)
    print(f"#   int8 fused + bf16 flagship: {len(texts) / sum(best):.2f} "
          f"pairs/s end to end (visual {best[0] * 1e3:.1f} ms + predict "
          f"{best[1] * 1e3:.1f} ms, best of 3) on {card}")
    try:
        busy, rows = device_profile(lambda: visual_ms(
            models["fused"], images, dev, repeats=0), top=6)
        print(f"#   int8 fused visual half: device busy {busy * 1e3:.2f} ms "
              f"in one profiled run; top kernels by device time:")
        for key, ms, calls in rows:
            print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    except Exception as e:       # the profiler is a report, not a check
        print(f"#   int8 visual device profile not measured ({e!r})")
    return counts


def attention_bound(q, k, bias, N):
    """(bound ms, "bytes" | "operations", bytes, flops): Q, K, V and the
    bias read once, O written once, over the memory rate; the two products
    over the bf16 tensor-core peak, or in fp32 as three TF32 products over
    the TF32 peak (`TF32_PRODUCTS`)."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    byts = (2 * B * Sq * D + 2 * B * Sk * D) * q.element_size() \
        + bias.numel() * 4
    flops = 4 * B * Sq * Sk * D
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else
             TF32_PRODUCTS * flops / PEAK_TF32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            byts, flops)


def sdpa_ms(q, k, v, bias, N, iters):
    B, Sq, D = q.shape
    q4, k4, v4 = (t.view(B, t.shape[1], N, D // N).transpose(1, 2)
                  for t in (q, k, v))
    mask = bias.to(q.dtype)
    return cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), iters=iters)


def phase_blockwise_times(gen, k1_row, launches):
    """K2 beside K1, its plain version, SDPA and its bound; fills K1's
    full-bias time at the packed layout-B shape. `launches` is K2's count
    over the serving runs. Returns K2's row."""
    B, N, hd, dtype = 128, 16, 64, torch.bfloat16
    print(f"# phase 7: K2 at B={B}, {N} heads of {hd}, bf16, asked for "
          f"tiling (128, 128); bound = max(bytes / 3.35e12, flops / 989e12)")
    cases = (("s150", 150, "B11Sk", 50), ("s172_full", 172, "packed", 50),
             ("s512", 512, "B11Sk", 20), ("s1024", 1024, "B11Sk", 10))
    row = {"name": "fused_attention_blockwise", "route": "cuda",
           "source": K2_SOURCE,
           "replaces": "icka_tpu/kernels/attention.py:246",
           "launches": launches, "on_main_path": launches > 0}
    for tag, S, kind, iters in cases:
        q, k, v, bias = attention_inputs(B, S, S, dtype, kind, gen)
        if kind == "packed":
            bias = bias.contiguous()     # one mask per row, as the model's
        out = fused_attention_blockwise(q, k, v, bias, N)
        want = attention_blockwise_reference(q, k, v, bias, N)
        k1 = fused_attention(q, k, v, bias, N)
        torch.cuda.synchronize()
        err, share = attention_close(out, want,
                                     f"K2 at the timed shape S={S}")
        err_k1, share_k1 = attention_close(
            out, k1, f"K2 vs K1 at the timed shape S={S}")
        top = want.float().abs().max().item()
        spread = want.float().std().item()
        del out, want, k1
        ms = cuda_time_ms(lambda: fused_attention_blockwise(q, k, v, bias, N),
                          iters=iters)
        k1_ms = cuda_time_ms(lambda: fused_attention(q, k, v, bias, N),
                             iters=iters)
        plain_ms = cuda_time_ms(lambda: attention_blockwise_reference(
            q, k, v, bias, N), iters=3, warmup=1)
        library_ms = sdpa_ms(q, k, v, bias, N, iters)
        bound_ms, bound_by, byts, flops = attention_bound(q, k, bias, N)
        tiles = blockwise_tiles(S, S, hd, dtype)
        others = {blockwise_tiles(S, S, hd, dtype, *blocks): cuda_time_ms(
            lambda: fused_attention_blockwise(q, k, v, bias, N, *blocks),
            iters=max(iters // 2, 5))
            for blocks in ((64, 64), (64, 128), (32, 128), (128, 64))}
        others.pop(tiles, None)
        print(f"#   Sq=Sk={S} bias={kind}: max_abs_err vs plain {err:.3e} "
              f"({share:.2f} of its bound), vs K1 {err_k1:.3e} "
              f"({share_k1:.2f}); plain output max |value| {top:.3f}, std "
              f"{spread:.4f}")
        print(f"#   Sq=Sk={S} bias={kind}: K2 {ms:.4f} ms at tiling {tiles} "
              f"(recorded CUDA-core time of the third slice "
              f"{K2_CUDA_CORE_MS[S]:.4f} ms, {K2_CUDA_CORE_MS[S] / ms:.2f}x), "
              f"{flops / ms / 1e9:.1f} "
              f"TFLOP/s, K1 {k1_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms ({ms / library_ms:.2f}x), bound "
              f"{bound_ms:.4f} ms ({ms / bound_ms:.1f}x; {bound_by}: "
              f"{byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); other tilings "
              + ", ".join(f"{b} {t:.4f}" for b, t in others.items()) + " ms")
        vals = {"shape": f"B={B} Sq=Sk={S} {N}x{hd} bf16 bias={kind}",
                "max_abs_err": err, "share_of_bound": share, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "k1_ms": k1_ms, "tflops": flops / ms / 1e9}
        # the row proper is the longest shape, what the kernel is for
        row.update(vals if tag == "s1024" else
                   {f"{tag}_{key}": val for key, val in vals.items()})
        if kind == "packed":
            k1_row.update(
                packed_shape=vals["shape"], packed_ms=k1_ms,
                packed_plain_ms=cuda_time_ms(lambda: attention_reference(
                    q, k, v, bias, N), iters=3, warmup=1),
                packed_bound_ms=bound_ms, packed_bound_by=bound_by,
                packed_library_ms=library_ms)
            tilings = k1_tiling_ms(q, k, v, bias, N, iters)
            print(f"#   K1 at this shape: {k1_ms:.4f} ms "
                  f"({k1_ms / library_ms:.2f}x SDPA; recorded CUDA-core "
                  f"time of the fifth slice "
                  f"{K1_CUDA_CORE_MS[S]:.4f} ms, "
                  f"{K1_CUDA_CORE_MS[S] / k1_ms:.2f}x), its plain version "
                  f"{k1_row['packed_plain_ms']:.4f} ms; tilings "
                  + ", ".join(f"{b} {t:.4f}" for b, t in tilings.items())
                  + " ms")
    return row


def k1_tiling_ms(q, k, v, bias, N, iters):
    """The tensor-core body at each of `K1_TILINGS` on K1's inputs, through
    K2's wrapper (the same kernel; K1 runs `K1_TILES` in bf16 and
    `K1_FP32_TILES` in fp32)."""
    return {blocks: cuda_time_ms(lambda: fused_attention_blockwise(
        q, k, v, bias, N, *blocks), iters=iters) for blocks in K1_TILINGS}


def phase_times(gen, launches, packed_launches, eval_launches, k2_launches):
    B, S, N, hd, dtype = 128, 150, 16, 64, torch.bfloat16
    print(f"# phase 7: K1 at B={B} Sq=Sk={S} {N}x{hd} bf16, key-mask bias "
          f"(the tensor-core body at {K1_TILES}; the prompted encoder's "
          f"longest bucket under a 14-token prompt, the shape every slice "
          f"has timed)")
    q, k, v, bias = attention_inputs(B, S, S, dtype, "B11Sk", gen)
    out = fused_attention(q, k, v, bias, N)
    want = attention_reference(q, k, v, bias, N)
    torch.cuda.synchronize()
    err, share = attention_close(out, want, "K1 at the timed shape")
    ms = cuda_time_ms(lambda: fused_attention(q, k, v, bias, N))
    plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v, bias, N))
    library_ms = sdpa_ms(q, k, v, bias, N, 50)
    bound_ms, bound_by, byts, flops = attention_bound(q, k, bias, N)
    tilings = k1_tiling_ms(q, k, v, bias, N, 50)
    row = {"name": "fused_attention", "route": "cuda", "source": K2_SOURCE,
           "replaces": "icka_tpu/kernels/attention.py:87",
           "launches": launches, "packed_launches": packed_launches,
           "eval_launches": eval_launches,
           "max_abs_err": err, "share_of_bound": share, "ms": ms,
           "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "on_main_path": launches > 0}
    print(f"#   max_abs_err {err:.3e} ({share:.2f} of its bound); kernel "
          f"{ms:.4f} ms ({ms / library_ms:.2f}x SDPA; recorded CUDA-core "
          f"time of the fifth slice {K1_CUDA_CORE_MS[S]:.4f} ms, "
          f"{K1_CUDA_CORE_MS[S] / ms:.2f}x), plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
          f"tilings " + ", ".join(f"{b} {t:.4f}" for b, t in tilings.items())
          + " ms")
    rows = [row, phase_blockwise_times(gen, row, k2_launches)]
    phase_fp32_times(gen, *rows)
    phase_wide_times(gen)
    return rows


def phase_fp32_times(gen, k1_row, k2_row):
    """K1 and K2 in fp32 (the 3xTF32 body) at K1's two serving shapes beside
    their plain versions, SDPA in fp32 (TF32 off), their recorded CUDA-core
    times and the fp32 bound (bytes / 3.35 TB/s against three TF32 products'
    FLOPs / 494.7 TFLOP/s); K1 at its four tilings. Adds `fp32_*` keys to
    both rows."""
    B, N, hd, dtype = 128, 16, 64, torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# phase 7: K1 and K2 in fp32 at B={B}, {N} heads of {hd} (K1 at "
          f"{K1_FP32_TILES}, K2 asked for (128, 128), which runs "
          f"{blockwise_tiles(150, 150, hd, dtype)}; SDPA and the plain "
          f"versions with TF32 off); bound = max(bytes / 3.35e12, "
          f"{TF32_PRODUCTS} * flops / 494.7e12): fp32 products held to fp32 "
          f"run as {TF32_PRODUCTS} TF32 products on the tensor cores")
    for tag, S, kind in (("s150", 150, "B11Sk"), ("s172_full", 172,
                                                  "packed")):
        q, k, v, bias = attention_inputs(B, S, S, dtype, kind, gen)
        if kind == "packed":
            bias = bias.contiguous()
        want = attention_reference(q, k, v, bias, N)
        bound_ms, bound_by, byts, flops = attention_bound(q, k, bias, N)
        library_ms = sdpa_ms(q, k, v, bias, N, 20)
        plain = {"K1": lambda: attention_reference(q, k, v, bias, N),
                 "K2": lambda: attention_blockwise_reference(q, k, v, bias,
                                                             N)}
        for name, fn, row in (("K1", fused_attention, k1_row),
                              ("K2", fused_attention_blockwise, k2_row)):
            out = fn(q, k, v, bias, N)
            torch.cuda.synchronize()
            err, _ = attention_close(out, want, f"{name} fp32 S={S} {kind}")
            del out
            ms = cuda_time_ms(lambda: fn(q, k, v, bias, N), iters=20)
            plain_ms = cuda_time_ms(plain[name], iters=3, warmup=1)
            cuda_core_ms = FP32_CUDA_CORE_MS[name][S]
            row.update({f"fp32_{tag}_{key}": val for key, val in (
                ("shape", f"B={B} Sq=Sk={S} {N}x{hd} fp32 bias={kind}"),
                ("max_abs_err", err), ("ms", ms), ("plain_ms", plain_ms),
                ("bound_ms", bound_ms), ("bound_by", bound_by),
                ("library_ms", library_ms))})
            print(f"#   {name} fp32 Sq=Sk={S} bias={kind}: max_abs_err "
                  f"{err:.3e}; kernel {ms:.4f} ms (recorded CUDA-core time "
                  f"of the sixth slice {cuda_core_ms:.4f} ms, "
                  f"{cuda_core_ms / ms:.2f}x), plain {plain_ms:.4f} ms, "
                  f"SDPA {library_ms:.4f} ms ({ms / library_ms:.2f}x), bound "
                  f"{bound_ms:.4f} ms ({ms / bound_ms:.1f}x; {bound_by}: "
                  f"{byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP x "
                  f"{TF32_PRODUCTS})")
        tilings = k1_tiling_ms(q, k, v, bias, N, 20)
        k1_row[f"fp32_{tag}_tilings_ms"] = {str(b): t
                                            for b, t in tilings.items()}
        print(f"#   K1 fp32 Sq=Sk={S} tilings " + ", ".join(
            f"{b} {t:.4f}" for b, t in tilings.items()) + " ms")
        del q, k, v, bias, want


def phase_wide_times(gen, hd=272):
    """K1 and K2 once at the first head width above 256 (zero-padded to
    288, two column chunks of the wide CUDA-core body), B=128, S=150, 16
    heads, a key mask, in both types: a record, not a bound."""
    B, S, N = 128, 150, 16
    print(f"# phase 7: K1 and K2 at head width {hd} (padded to "
          f"{kernel_width(hd)}: the wide CUDA-core body in column chunks of "
          f"{column_chunk(kernel_width(hd))}), B={B}, Sq=Sk={S}, {N} heads, "
          f"key mask")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = attention_inputs(B, S, S, dtype, "B11Sk", gen, hd=hd)
        times = {}
        for name, fn, plain in (
                ("K1", fused_attention, attention_reference),
                ("K2", fused_attention_blockwise,
                 attention_blockwise_reference)):
            attention_close(fn(q, k, v, bias, N), plain(q, k, v, bias, N),
                            f"{name} {dtype} head_dim={hd} at the timed shape")
            times[name] = cuda_time_ms(lambda: fn(q, k, v, bias, N),
                                       iters=3, warmup=1)
        library_ms = sdpa_ms(q, k, v, bias, N, 3)
        print(f"#   {str(dtype)[6:]}: K1 {times['K1']:.4f} ms, K2 "
              f"{times['K2']:.4f} ms, SDPA {library_ms:.4f} ms")
        del q, k, v, bias


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_row(name, replaces, shape, launches, err, ms, plain_ms, unfused_ms,
             byts, ops, dp4a_ms):
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS * 1e3
    row = {"name": name, "route": "cuda", "source": CONV_SOURCE,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "unfused_ms": unfused_ms, "shape": shape,
           "on_main_path": launches > 0}
    print(f"#   {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"unfused port path {unfused_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {byts / 1e6:.1f} MB,"
          f" {ops / 1e9:.2f} GOP); no single PyTorch call computes it; "
          f"recorded dp4a time of the fifth slice {dp4a_ms:.4f} ms "
          f"({dp4a_ms / ms:.2f}x)")
    return row


def static_module(module, gen):
    """Give an int8_static module random weights and plausible scales."""
    for m in module.modules():
        if isinstance(m, ConvBN):
            m.wq.copy_(_int8(gen, *m.wq.shape))
            m.w_scale.copy_(_per_channel(gen, m.w_scale.numel(), 2e-3))
            m.fused_bias.copy_(_normal(gen, m.fused_bias.numel(), std=0.1))
            m.act_scale.fill_(0.02)
    return module.eval()


def phase_conv_times(gen, launches, errs, B=128):
    """K3-K6 at B=128 beside their plain versions, the unfused port path
    for the same block (ConvBN modules with float64 integer products) and
    their bounds."""
    print(f"# phase 7: K3-K6 at B={B}; bound = max(bytes / 3.35e12, ops / "
          f"1979e12 int8 dense)")
    dev = torch.device("cuda", 0)
    rows = []

    def timed(kernel_fn, plain_fn, unfused_fn, what):
        got, want = kernel_fn(), plain_fn()
        err = check_equal(f"{what} at the timed shape", got, want, {}, what)
        del got, want
        with torch.inference_mode():
            return (err, cuda_time_ms(kernel_fn, iters=20),
                    cuda_time_ms(plain_fn, iters=3, warmup=1),
                    cuda_time_ms(unfused_fn, iters=3, warmup=1))

    # K5: the stem's tail at 224^2
    args = stem_inputs(gen, B)
    stem = static_module(StemPoolS2D(dtype=torch.bfloat16,
                                     quant="int8_static", device=dev), gen)
    pixels = _normal(gen, B, 224, 224, 3)
    err, ms, plain_ms, unfused_ms = timed(
        lambda: kconv.int8_stem_pool(*args),
        lambda: kconv.stem_pool_reference(*args),
        lambda: stem(pixels), "int8_stem_pool")
    K, N = args[1].shape
    out_bytes = B * 56 * 56 * (N // 4) * 2
    rows.append(conv_row(
        "int8_stem_pool", "icka_tpu/kernels/conv.py:467",
        f"B={B} patches (56,56,{K}) -> (56,56,{N // 4}) bf16",
        launches["int8_stem_pool"],
        max(err, errs["int8_stem_pool"]), ms, plain_ms, unfused_ms,
        nbytes(*args) + out_bytes, 2 * B * 56 * 56 * K * N,
        CONV_DP4A_MS["int8_stem_pool"]))
    del args, pixels

    # K4 at layer3 and layer1, K6 at layer3
    k4_rows = {}
    for H, Cw in ((14, 256), (56, 64)):
        args = bottleneck_inputs(gen, B, H, Cw)
        rs = torch.tensor([0.37], device=dev)
        block = static_module(Bottleneck(
            4 * Cw, Cw, dtype=torch.bfloat16, quant="int8_static",
            device=dev), gen)
        x16 = (args[0].float() * 0.02).bfloat16().permute(0, 3, 1, 2)
        Cin = 4 * Cw
        byts = nbytes(*args, rs) + B * H * H * Cin       # int8 out
        ops = 2 * B * H * H * 17 * Cw * Cw
        shape = f"B={B} H={H} Cw={Cw} int8 out"
        t = timed(lambda: kconv.int8_bottleneck_v2(*args, rs),
                  lambda: kconv.bottleneck_v2_reference(*args, rs),
                  lambda: block(x16), "int8_bottleneck_v2")
        k4_rows[H] = conv_row(
            "int8_bottleneck_v2", "icka_tpu/kernels/conv.py:377", shape,
            launches["int8_bottleneck_v2"],
            max(t[0], errs["int8_bottleneck_v2"]), *t[1:], byts, ops,
            CONV_DP4A_MS[f"int8_bottleneck_v2 H={H}"])
        if H == 14:
            t = timed(lambda: kconv.int8_bottleneck(*args, 0.37),
                      lambda: kconv.bottleneck_reference(*args, 0.37),
                      lambda: block(x16), "int8_bottleneck")
            k6_row = conv_row(
                "int8_bottleneck", "icka_tpu/kernels/conv.py:204", shape,
                launches["int8_bottleneck"],
                max(t[0], errs["int8_bottleneck"]), *t[1:], byts, ops,
                CONV_DP4A_MS["int8_bottleneck"])
        del args, x16
    with torch.inference_mode():           # the serving batch, per stage
        per_stage = []
        for H, Cw in CONV_STAGES:
            args = bottleneck_inputs(gen, REQUESTS, H, Cw)
            rs = torch.tensor([0.37], device=dev)
            per_stage.append(cuda_time_ms(
                lambda: kconv.int8_bottleneck_v2(*args, rs), iters=20))
    print(f"#   int8_bottleneck_v2 at the serving batch B={REQUESTS}, stages "
          f"{CONV_STAGES}: " + ", ".join(f"{t:.4f}" for t in per_stage)
          + " ms a call (three launches each)")
    k4 = k4_rows[14]
    k4.update({f"layer1_{k}": k4_rows[56][k] for k in (
        "shape", "ms", "plain_ms", "unfused_ms", "bound_ms", "bound_by")})
    rows += [k4, k6_row]

    # K3 at layer3's 3x3: bf16 out with ReLU, no residual
    H, C = 14, 256
    a = conv3x3_inputs(gen, B, H, C, C)
    args = (a["x_pad"], a["w_q"], a["scale"], a["bias"])
    conv = static_module(ConvBN(C, C, 3, dtype=torch.bfloat16,
                                quant="int8_static", device=dev), gen)
    x16 = (a["x_pad"][:, 1:-1, 1:-1].float() * 0.02).bfloat16() \
        .permute(0, 3, 1, 2)
    t = timed(lambda: kconv.int8_conv3x3(*args),
              lambda: kconv.conv3x3_reference(*args),
              lambda: torch.relu(conv(x16)), "int8_conv3x3")
    rows.append(conv_row(
        "int8_conv3x3", "icka_tpu/kernels/conv.py:107",
        f"B={B} x_pad ({H + 2},{H + 2},{C}) -> ({H},{H},{C}) bf16",
        launches["int8_conv3x3"],
        max(t[0], errs["int8_conv3x3"]), *t[1:],
        nbytes(*args) + B * H * H * C * 2, 2 * B * H * H * 9 * C * C,
        CONV_DP4A_MS["int8_conv3x3"]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t_start = time.perf_counter()
    try:
        dev, layers = torch.device("cuda", 0), (3, 8, 36, 3)
        base = ICKAConfig()
        card = phase_build()
        tokenizer, spec = prompt_tokenizer()
        phase_kernel_vs_plain(gen, spec, base)
        phase_head_widths(gen)
        phase_blockwise_vs_plain(gen)
        conv_errs = phase_conv_kernels_vs_plain(gen)
        counts, _, ctx = phase_slice(args, card, dev, base, layers, tokenizer)
        conv_counts = phase_int8_visual(args, card, dev, ctx, layers)
        packed_counts = phase_packed(args, card, dev, ctx)
        eval_counts = phase_evaluate(args, card, dev, ctx)
        del ctx
        torch.cuda.empty_cache()
        # over the four main paths, each driven from counts of 0
        runs = (counts, conv_counts, packed_counts, eval_counts)
        total = {name: sum(c[name] for c in runs) for name in COUNTERS}
        print(f"#   kernel launches over the four main paths: {total}")
        for name in NO_CALLER:
            check(total[name] == 0, f"{name} has no caller in the model, yet "
                                    f"the main paths launched it "
                                    f"{total[name]} times")
        for name in ("int8_bottleneck_v2", "int8_stem_pool"):
            check(eval_counts[name] == 0, f"evaluation runs the float "
                                          f"backbone, yet launched {name}")
        kernels = phase_times(gen, counts["fused_attention"],
                              packed_counts["fused_attention"],
                              eval_counts["fused_attention"],
                              total["fused_attention_blockwise"])
        kernels += phase_conv_times(gen, total, conv_errs)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(f"# chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
