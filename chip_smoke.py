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
     once in bf16; `warmup` before the timed runs;
  4. serve the same requests with the int8-static visual half: phase 3's
     float ResNet-152 is calibrated in the dynamic int8 mode on the request
     images, quantised offline, and served with `fused_pallas=True` (K5 once
     and K4 46 times per backbone call) in front of phase 3's bf16 flagship;
     the same backbone on the kernels' plain versions must give a
     bit-identical `att`, and the fused stem the unfused stem's output;
     the products outside the kernels (`torch._int_mm`) timed against the
     float64 product, `att` unmoved;
 4b. serve them in the JAX package's serving configuration: int8-static
     text (both RoBERTa stacks, the cross-attention stacks, the BiLSTM's
     input projection) in bf16 with K1, calibrated in the dynamic int8
     mode on the requests and quantised with `static_quantize_params_like`,
     behind phase 4's int8-static ResNet-152; `int8_matmul` bit-equal to
     the float64 product at every quantised shape of the run, an
     int8-static Dense and the BiLSTM's input projection bit-equal on the
     card and the CPU, every request tagged, K1 48 times a batch and K4/K5
     as in phase 4; tags and emissions against the plain core and against
     phase 4's float text, walls, device busy and launches printed;
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
  9. the gate_cl family (run before 8 and 7): K1 at BERT-base's 12 heads
     of 64 against its plain version (bucketed 16, 24 and 128 with key
     biases, packed 48 block-diagonal, fp32 and bf16); `GateCLConfig()`
     at full width (BERT-base, `layer_num1` 1, region_dim 2048,
     max_seq_length 128, random weights from `--seed`) behind phase 3's
     ResNet-152 on phase 3's requests (bare sentences and images):
     `BucketedGateCLServer` ("gate_cl", `masked_crs=True`, `warmup`
     first) through K1 against the plain core in fp32 (tags >= 0.99,
     first-batch emissions within 1e-3), then in bf16;
     `PackedGateCLServer` in fp32 (tags >= 0.99 against the bucketed
     server); "cl" and "ip" once each in bf16; `TokenClassifier` logits
     through K1 against the plain core (1e-3); K1 12 times a batch
     everywhere. After phase 8, `GateCLTrainer.fit` in bf16 (micro-batches
     of 32 so the reference's negative_rate 16 swap runs, 2 epochs of 3
     steps, dev evaluation and best-F1 save each epoch; losses finite and
     falling, K1 0 in the steps and 12 a dev batch), a fresh trainer
     resuming the first epoch's snapshot (next loss within 1e-4), one
     step each of "cl" and "ip", one fp32 step at depth 2 card vs CPU
     (loss 1e-5, gradient norm 1e-4, moments 1e-4); walls, device busy
     and launches, step median, train pairs/s and peak memory printed;
 10. weights from files on disk (after 9's serving, before 8): from random
     weights (`--seed`) it writes, with HF key names it maps itself (no
     `transformers`), a BERT-base HF directory (`pytorch_model.bin`,
     `bert.` prefix, legacy LayerNorm gamma/beta), a RoBERTa-large-width
     `model.safetensors` directory at depth 2 in BF16 (the format written
     here), a TF bundle at BERT-base widths and depth 2, and a torchvision
     `resnet152.pth` of phase 3's ResNet-152, under the gitignored build/
     (removed when the phase ends); runs `icka_tpu_torch.cli.convert` for
     `bert` and `resnet`, then `load_text_encoder` (the HF directory, the
     native directory `save_text_encoder` writes, by bare name under a
     cache directory; the safetensors directory, RoBERTa's position offset
     2), `load_tf_encoder` and `load_backbone`, every loaded leaf bit-equal
     to its source (BF16 to its bf16 values), sizes and seconds printed.
     Then `GateCLConfig()` ("gate_cl", `masked_crs=True`, K1) on the loaded
     encoder, unfused and fused (`fuse_qkv_params`), served in fp32 behind
     phase 3's ResNet-152: tags identical, first-batch emissions within
     1e-5, K1 12 times a batch (on strided q/k/v views when fused); then
     bench.py's gate_cl serving configuration: calibrated in the dynamic
     int8 mode on the requests, fused and quantised int8-static with a bf16
     softmax, bf16, K1, behind the int8-static ResNet-152 built from
     `load_backbone`'s weights as phase 4 builds its own (K5 once, K4 46
     times a call), through `BucketedGateCLServer` and `PackedGateCLServer`:
     every request tagged, emissions finite, K1 12 times a batch on strided
     views, packed tags against bucketed >= 0.99, the fused `qkv` Dense
     bit-equal on the card and the CPU; tags and emission cosines against
     the plain core and the fp32 model, and walls, device busy and
     launches beside phase 9's float bf16 gate_cl, printed;
  8. train (run before 7, whose K1 row carries its launches):
     `ICKATrainer.fit` at full width in bf16 over fp32 master weights on a
     synthetic corpus without image files, two epochs of three steps with
     gradient accumulation 2, train-mode crop and flip, dropout on (so
     attention trains on the plain core: K1 0 times in the train steps,
     48 times per dev batch), a dev evaluation and best-F1 save each
     epoch; every loss finite, the last epoch's mean below the first's, a
     best-F1 checkpoint and a step snapshot written; a fresh trainer
     resumes the first epoch's snapshot and its next step's loss matches
     the run's; two fp32 steps at depth two on the card against the CPU
     (loss, gradient norm, moments, updates); the parameter count,
     optimizer-state bytes, peak memory, step and update times and the
     device-busy share printed;
  7. time each kernel at its main-path shape beside its plain version, the
     PyTorch library call for the same function where there is one, its
     bound and its recorded time before its redesign (comment lines only);
     K1's tilings in bf16 and in fp32; K1 and K2 in fp32 at K1's two
     shapes; both at the first head width above 256; K1 at the gate_cl
     family's 12 heads (S=128 key bias, S=48 full bias, both types; at 128
     also on the strided q/k/v views of one fused projection); time the
     served requests end to end.

The line before the last is the `{"kernels": [...]}` JSON object; the last
line is `{"ok": true, "device": {...}}`. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from icka_tpu_torch.cli import convert as convert_cli
from icka_tpu_torch.cli import evaluate as evaluate_cli
from icka_tpu_torch.convert import (backbone_state_dict,
                                    backbone_variables_from_state_dict,
                                    icka_variables_from_state_dict,
                                    state_dict_from_flax)
from icka_tpu_torch.core.checkpoint import Checkpointer, restore_pytree
from icka_tpu_torch.core.config import (EncoderConfig, GateCLConfig,
                                        ICKAConfig, TrainConfig, to_json)
from icka_tpu_torch.core.device import strict_fp32
from icka_tpu_torch.data import native, synthetic
from icka_tpu_torch.data.clip_store import ClipFeatureStore
from icka_tpu_torch.data.conll import MMExample, read_mm_conll
from icka_tpu_torch.data.features import convert_examples
from icka_tpu_torch.data.images import preprocess_images
from icka_tpu_torch.data.labels import label_map
from icka_tpu_torch.data.loader import MNERLoader
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer
from icka_tpu_torch.kernels import build
from icka_tpu_torch.kernels import conv as kconv
from icka_tpu_torch.kernels.attention import (
    HEAD_DIMS, K1_FP32_TILES, K1_TILES, attention_blockwise_reference,
    attention_reference, blockwise_tiles, column_chunk, fused_attention,
    fused_attention_blockwise, kernel_width)
from icka_tpu_torch.models import resnet as resnet_module
from icka_tpu_torch.models.convert import (calibration_amax,
                                           fuse_qkv_params,
                                           quantize_params_like,
                                           static_quantize_backbone,
                                           static_quantize_params_like)
from icka_tpu_torch.models.gate_cl import GateCLModel
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.models.pretrained import (load_backbone,
                                              load_text_encoder,
                                              load_tf_encoder,
                                              save_text_encoder)
from icka_tpu_torch.models.resnet import (Bottleneck, ConvBN, StemPoolS2D,
                                          VisualBackbone)
from icka_tpu_torch.models.tf_convert import (encoder_params_to_tf,
                                              write_tf_checkpoint)
from icka_tpu_torch.models.token_classifier import TokenClassifier
from icka_tpu_torch.nn.quant import column_major, int8_matmul
from icka_tpu_torch.serving.bucketed import (BucketedGateCLServer,
                                             BucketedICKAServer,
                                             sample_tweet_lengths)
from icka_tpu_torch.serving.packing import (PackedGateCLServer,
                                            PackedICKAServer)
from icka_tpu_torch.train.gate_cl_trainer import GateCLTrainer
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
# phase 8, training: the synthetic corpus's rows (train: 3 optimizer steps
# of 2 x 8 an epoch; dev: 2 batches of 8) and the epochs; a learning rate
# above the recipe's 3e-5, so that a few steps move a random-weight model's
# loss clearly, and the decode size (a 224 crop at random offsets inside
# its margin of 32)
TRAIN_ROWS, DEV_ROWS, TRAIN_BATCH, TRAIN_ACCUM = 48, 16, 8, 2
TRAIN_EPOCHS, TRAIN_LR, TRAIN_DECODE = 2, 1e-4, 256
# a fresh trainer resuming the first epoch's snapshot runs the next step on
# the same weights, batch and dropout seeds: the same bf16 forward, held
# to 1e-4 of the uninterrupted run's loss
RESUME_REL_TOL = 1e-4
# one fp32 step on the card against the CPU at a depth of two layers (both
# stacks and the cross stacks), TF32 off, dropout 0, the same weights and
# batches: the loss and the gradients' global norm differ only by the
# order of sums (STEP_LOSS_RTOL, STEP_NORM_RTOL); the moments after the
# first step (lr 0 under warmup: params unmoved) within MOMENT_RTOL in
# relative L2 over all leaves, and the second step's parameter updates
# within UPDATE_RTOL. An element whose gradient is at noise level (a key
# projection's bias has a zero gradient in exact arithmetic) could take
# Adam's update of about +-lr on either side; it does not, as its noise
# (about 1e-10) lies below eps (1e-8): 4.4e-5 measured (NVIDIA H100 80GB
# HBM3, 700 W), 20x inside the bound.
TRAIN_CHECK_LAYERS = 2
STEP_LOSS_RTOL, STEP_NORM_RTOL, MOMENT_RTOL, UPDATE_RTOL = \
    1e-5, 1e-4, 1e-4, 1e-3
# phase 9, the gate_cl family (GateCLConfig(): BERT-base): K1 launches a
# batch (one per self-attention layer); training in micro-batches of 32,
# above the reference's negative_rate of 16, so the negative swap and the
# relation loss run, 3 steps of 2 x 32 an epoch, dev 2 batches of 8, the
# corpus's CLIP width (the family reads no CLIP feature)
BERT_LAYERS_PER_BATCH = 12
GC_TRAIN_BATCH, GC_TRAIN_ACCUM, GC_TRAIN_ROWS = 32, 2, 192
GC_DEV_ROWS, GC_EVAL_BATCH, GC_CLIP_DIM = 16, 8, 16
# phase 10, weights from files on disk: the files go here (about 2.1 GB
# with the converted copies) and are removed when the phase ends. The
# RoBERTa-large safetensors file and the TF bundle hold 2 layers: the TF
# bundle's pure-Python crc32c costs 0.1-0.2 s a MB each way on an H100's
# host. The fused fp32 encoder against the unfused one differs only in the
# QKV product's order of sums, 12 layers deep.
WEIGHTS_DIR = WORK_DIR / "weights"
ROBERTA_DEPTH, TF_DEPTH = 2, 2
FUSED_EMISSIONS_TOL = 1e-5


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
        if hasattr(wrapper, "strided_launches"):
            wrapper.strided_launches = 0


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
    `top` device kernels by time and K1's own row (name, ms, calls), and
    the number of device kernels launched."""
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
            [(e.key, dev_us(e) / 1e3, e.count) for e in rows],
            sum(e.count for e in kernels))


def kernel_device_ms(fn, iters=50):
    """Device time per launch of the attention kernel that `fn` launches,
    from torch.profiler's kernel rows: where the kernel is shorter than
    its wrapper's host time, CUDA events around a loop of calls count the
    gaps between launches too."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "attention" in e.key
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    return (sum(getattr(e, "self_device_time_total", 0) for e in rows)
            / 1e3 / sum(e.count for e in rows))


def first_batch_emissions(server, examples, models, spec):
    """Emissions of each model on the server's first device batch."""
    with torch.inference_mode():
        _, _, _, batch = next(server.batches(examples))
        return [m.batch_emissions(batch, spec.mask_positions, spec.offset)
                for m in models]


def agreement(a, b):
    same = sum(int((x == y).sum()) for x, y in zip(a, b))
    return same / sum(len(x) for x in a)


def report_walls(name, run, card, n):
    """Best of 3 walls of `run`, which serves `n` requests (it returns
    `serve`'s result), and a device profile of one more run. Returns the
    pairs/s of the best wall."""
    best = min((run()[3] for _ in range(3)), key=sum)
    print(f"#   {name}: {n / sum(best):.2f} pairs/s end to end, a smoke "
          f"figure ({n} requests, best of 3: visual {best[0] * 1e3:.1f} ms "
          f"+ predict {best[1] * 1e3:.1f} ms) on {card}")
    try:
        busy, rows, launches = device_profile(run)
    except Exception as e:   # the profiler is a report, not a check
        print(f"#   {name}: device profile not measured ({e!r})")
        return n / sum(best)
    print(f"#   {name}: device busy {busy * 1e3:.1f} ms of "
          f"{sum(best) * 1e3:.1f} ms wall ({busy / sum(best):.3f}) in "
          f"{launches} device kernel launches; top kernels by device time, "
          f"then K1 (profiled run):")
    for key, ms, calls in rows:
        print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    return n / sum(best)


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
        t0 = time.perf_counter()
        servers[name].warmup()
        print(f"#   {name}: warmup of buckets {servers[name].buckets} in "
              f"{time.perf_counter() - t0:.2f} s")
        pairs_per_s[name] = report_walls(
            name, lambda: serve(servers[name], backbones[name], texts,
                                images), card, len(texts))
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
        report_walls(name, lambda: serve(server, backbone, texts, images),
                     card, len(texts))
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
        busy, rows, n = device_profile(lambda: trainer16.evaluate(loader))
        print(f"#   eval loop: device busy {busy * 1e3:.1f} ms of "
              f"{again.seconds * 1e3:.1f} ms wall ({busy / again.seconds:.3f}"
              f") in {n} device kernel launches; top kernels by device "
              f"time, then K1 (profiled run):")
        for key, ms, calls in rows:
            print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    except Exception as e:       # the profiler is a report, not a check
        print(f"#   eval loop device profile not measured ({e!r})")
    shutil.rmtree(root)
    return counts


def train_corpus(args, cfg, root):
    """The synthetic corpus without image files (no PIL; the loader yields
    zero images, cropped and flipped all the same) and its train and dev
    features."""
    generate_dataset(str(root), n_train=TRAIN_ROWS, n_valid=DEV_ROWS,
                     n_test=0, clip_dim=cfg.clip_dim, seed=args.seed,
                     write_images=False)
    tokenizer = tiny_tokenizer(str(root / "tokenizer"))
    return {split: convert_examples(
        read_mm_conll(str(root / f"{split}.txt")), tokenizer,
        cfg.max_seq_length, ClipFeatureStore.from_split(str(root), split),
        cfg.clip_dim) for split in ("train", "valid")}


def rel_l2(pairs) -> float:
    """sqrt(sum |a - b|^2) / sqrt(sum |b|^2) over (a, b) tensor pairs, in
    float64 on the CPU."""
    num = den = 0.0
    for a, b in pairs:
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return math.sqrt(num / max(den, 1e-300))


def fit_and_resume(make_trainer, loader, train_batches, out, card, dev,
                   layers_per_batch):
    """Phases 8 and 9: `fit` of a fresh trainer from `make_trainer()` for
    TRAIN_EPOCHS epochs over `loader("train")` with a dev evaluation on
    `loader("valid")` and best-F1 saves into `out`, its frozen backbone's
    BatchNorm statistics calibrated on the first batch's images; every loss
    finite, the last epoch's mean below the first's, K1 0 times in the
    train steps and `layers_per_batch` times a dev batch. Then a fresh
    trainer resumes the first epoch's snapshot and runs the next step (its
    loss within RESUME_REL_TOL of the run's), and one more step is
    profiled. Returns (every kernel's launch count over `fit`, the resumed
    trainer, the first train batch)."""
    t0 = time.perf_counter()
    trainer = make_trainer()
    if dev.type == "cuda":           # the peak from here: the model on
        torch.cuda.reset_peak_memory_stats(dev)
    first = train_batches(0, 1)[0]
    calibrate_batch_stats(trainer.backbone, preprocess_images(
        first["images"].reshape(-1, *first["images"].shape[2:]), 224, dev))
    n_params = sum(p.numel() for p in trainer.model.parameters())
    build_s = time.perf_counter() - t0

    steps_k1 = []
    run_step = trainer.train_step

    def counted_step(batch, key):         # K1 launches inside each step
        before = fused_attention.launches
        record = run_step(batch, key)
        steps_k1.append(fused_attention.launches - before)
        return record
    trainer.train_step = counted_step
    train_loader, dev_loader = loader("train"), loader("valid")
    ck = Checkpointer(str(out))
    lines = []
    zero_counts()
    t0 = time.perf_counter()
    history = trainer.fit(train_loader, dev_loader, epochs=TRAIN_EPOCHS,
                          checkpointer=ck, log=lines.append)
    sync(dev)
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    records = trainer.records
    for line in lines:
        print(f"#     {line}")
    opt_bytes = sum(t.numel() * t.element_size()
                    for moments in (trainer.opt_state.mu,
                                    trainer.opt_state.nu)
                    for t in moments.values())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    step_s = float(np.median([r.seconds for r in records[1:]]))
    update_s = float(np.median([r.update_seconds for r in records[1:]]))
    tcfg = trainer.train_cfg
    pairs = tcfg.train_batch_size * tcfg.gradient_accumulation_steps
    k1 = counts["fused_attention"]
    print(f"#   {n_params / 1e6:.1f} M parameters (model and ResNet built "
          f"in {build_s:.1f} s); optimizer "
          f"state {opt_bytes / 1e9:.3f} GB (mu and nu fp32); peak allocated "
          f"{peak / 1e9:.3f} GB; fit {fit_s:.1f} s; on {card}")
    print(f"#   {len(records)} steps: losses "
          f"{[round(r.loss, 4) for r in records]}, grad norms "
          f"{[None if r.grad_norm is None else round(r.grad_norm, 3) for r in records]}; "
          f"epoch means {[round(h, 4) for h in history]}")
    print(f"#   train step median {step_s * 1e3:.1f} ms over the steps after "
          f"the first ({pairs / step_s:.2f} train pairs/s), optimizer update "
          f"median {update_s * 1e3:.1f} ms, on {card}; K1 launches "
          f"{k1} in fit, {sum(steps_k1)} of them in train steps")
    check(all(r.applied and math.isfinite(r.loss) for r in records),
          f"a train step was not finite: {records}")
    check(history[-1] < history[0], f"train loss did not fall: {history}")
    check(sum(steps_k1) == 0, f"K1 launched in train steps: {steps_k1}")
    if layers_per_batch:
        want = layers_per_batch * len(dev_loader) * TRAIN_EPOCHS
        check(k1 == want, f"K1 launched {k1} times in fit, want {want}")
    steps_per_epoch = len(train_loader)
    snap = steps_per_epoch               # the first epoch's best-F1 save
    check(ck.manifest["best_step"] is not None, "no best-F1 checkpoint")
    check(snap in ck.manifest["steps"], f"no snapshot of step {snap}: "
                                        f"{ck.manifest}")
    snap_path = out / f"state_step{snap}.msgpack"
    check(snap_path.exists() and (out / "state_best.msgpack").exists(),
          "checkpoint files missing")
    want_loss = records[snap].loss
    del trainer, run_step
    torch.cuda.empty_cache()

    # resume: a fresh trainer from the snapshot, the next step of the run
    fresh = make_trainer()
    fresh.init_state(steps_per_epoch * TRAIN_EPOCHS)
    t0 = time.perf_counter()
    fresh.state_from_checkpoint(restore_pytree(str(snap_path)))
    sync(dev)
    read_s = time.perf_counter() - t0
    nxt, after = train_batches(1, 2)
    got = fresh.train_step(nxt, (1, 0))
    rel = abs(got.loss - want_loss) / abs(want_loss)
    print(f"#   snapshot of step {snap}: {snap_path.stat().st_size / 1e9:.3f}"
          f" GB, read and loaded in {read_s:.2f} s; the resumed trainer's "
          f"next step loss {got.loss:.6f} vs the run's {want_loss:.6f} "
          f"(relative {rel:.2e}, tol {RESUME_REL_TOL:.0e}); on {card}")
    check(fresh.step == snap + 1 and rel <= RESUME_REL_TOL,
          f"resumed step {fresh.step}: loss {got.loss} vs {want_loss}")
    try:
        busy, rows, n = device_profile(
            lambda: fresh.train_step(after, (1, 1)))
        print(f"#   one train step: device busy {busy * 1e3:.1f} ms of the "
              f"median step {step_s * 1e3:.1f} ms ({busy / step_s:.3f}) in "
              f"{n} device kernel launches (profiled run) on {card}; top "
              f"kernels:")
        for key, ms, calls in rows:
            print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    except Exception as e:       # the profiler is a report, not a check
        print(f"#   train step device profile not measured ({e!r})")
    shutil.rmtree(out)
    return counts, fresh, first


def train_loaders(feats, images, batch, accum, eval_batch, seed):
    """`loader(split, prefetch)` over the train or dev features, and
    `train_batches(epoch, n)`, the train loader's first n batches of an
    epoch."""
    def loader(split, prefetch=2):
        if split == "train":
            return MNERLoader(feats["train"], images, batch, accum,
                              train=True, decode_size=TRAIN_DECODE,
                              seed=seed, prefetch=prefetch)
        return MNERLoader(feats["valid"], images, eval_batch, train=False,
                          decode_size=TRAIN_DECODE, prefetch=prefetch)

    def train_batches(epoch, n):
        data = loader("train", prefetch=0)
        data.epoch = epoch
        return [b for _, b in zip(range(n), data)]
    return loader, train_batches


def phase_train(args, card, dev, base, layers):
    """The training entry point, `ICKATrainer.fit`, at full width: bf16
    over fp32 master weights, `use_pallas` for the dev evaluation (training
    runs dropout, so attention takes the plain core), the frozen backbone,
    TRAIN_EPOCHS epochs with accumulation, a dev evaluation and a best-F1
    save each epoch, the resumed snapshot (`fit_and_resume`); bf16 against
    fp32 dev tags on the trained weights; two fp32 steps on the card
    against the CPU at depth TRAIN_CHECK_LAYERS. Returns every kernel's
    launch count over `fit`."""
    cfg = dataclasses.replace(
        base, embedding=dataclasses.replace(base.embedding, use_pallas=True),
        last_encoder=dataclasses.replace(base.last_encoder, use_pallas=True))
    print(f"# phase 8: train: ICKATrainer.fit at full width (bf16 over fp32 "
          f"master weights, {TRAIN_EPOCHS} epochs of {TRAIN_ROWS} rows in "
          f"steps of {TRAIN_ACCUM} x {TRAIN_BATCH}, dev {DEV_ROWS} rows, "
          f"lr {TRAIN_LR}, dropout on)")
    root = WORK_DIR / "train"
    shutil.rmtree(root, ignore_errors=True)
    feats = train_corpus(args, cfg, root / "ds")
    spec = feats["train"].spec
    tcfg = TrainConfig(learning_rate=TRAIN_LR, train_batch_size=TRAIN_BATCH,
                       eval_batch_size=TRAIN_BATCH,
                       gradient_accumulation_steps=TRAIN_ACCUM,
                       seed=args.seed, compute_dtype="bfloat16")
    loader, train_batches = train_loaders(
        feats, str(root / "ds" / "images"), TRAIN_BATCH, TRAIN_ACCUM,
        TRAIN_BATCH, args.seed)
    counts, fresh, _ = fit_and_resume(
        lambda: ICKATrainer(cfg, tcfg, spec, resnet_layers=layers,
                            device=dev),
        loader, train_batches, root / "out", card, dev, LAYERS_PER_BATCH)
    # bf16 against fp32 tags on the dev split, the trained weights
    model32 = ICKAModel(cfg, device=dev).eval()
    model32.load_state_dict(fresh.model.state_dict())
    same = total = entities = 0
    with torch.inference_mode():
        for batch in loader("valid", prefetch=0):
            n = int(batch.pop("row_valid").sum())
            inputs = fresh.model_inputs(batch)
            mask = inputs["output_mask"][:n].bool()
            tags = [m.crf.decode(m.batch_emissions(
                inputs, spec.mask_positions, spec.offset), inputs[
                "output_mask"])[:n][mask] for m in (fresh.model, model32)]
            same += int((tags[0] == tags[1]).sum())
            total += int(mask.sum())
            entities += int((tags[1] != label_map()["O"]).sum())
    print(f"#   bf16 vs fp32 dev tags after {fresh.step} steps from random "
          f"weights: {same / total:.6f} of {total} tokens; fp32 tags other "
          f"than O: {entities}")
    del fresh, model32
    torch.cuda.empty_cache()

    enc = {k: dataclasses.replace(
        getattr(base, k), num_hidden_layers=TRAIN_CHECK_LAYERS,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        for k in ("embedding", "last_encoder")}
    shallow = dataclasses.replace(base, layer_num1=TRAIN_CHECK_LAYERS, **enc)
    tcfg32 = dataclasses.replace(tcfg, compute_dtype="float32")

    def shallow_trainer(d):
        t = ICKATrainer(shallow, tcfg32, spec, resnet_layers=(1, 1, 1, 1),
                        device=d)
        t.model.map_alignment.dropout = t.model.map_vision.dropout = 0.0
        return t
    phase_train_step_vs_cpu(card, shallow_trainer, train_batches(0, 2), dev)
    shutil.rmtree(root)
    return counts


def phase_train_step_vs_cpu(card, make_trainer, batches, dev):
    """fp32 train steps, one per batch, on the card and on the CPU from the
    same weights and batches: `make_trainer(device)` gives a trainer at
    depth TRAIN_CHECK_LAYERS in fp32 with dropout 0. The loss and the
    gradient norm of every step, the moments after the first (lr 0 under
    warmup) and the updates of a second (see UPDATE_RTOL)."""
    strict_fp32()
    cpu = torch.device("cpu")
    trainers = {d: make_trainer(d) for d in (cpu, dev)}
    ref = trainers[cpu]
    calibrate_batch_stats(ref.backbone, preprocess_images(
        batches[0]["images"][0], 224, cpu))
    for t in trainers.values():
        t.model.load_state_dict(ref.model.state_dict())
        t.backbone.load_state_dict(ref.backbone.state_dict())
        t.init_state(4)
    p0 = {n: p.detach().clone() for n, p in ref.params().items()}
    n_params = sum(p.numel() for p in p0.values())
    what = type(ref.model).__name__
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        rec = {d: t.train_step(batch, (0, i)) for d, t in trainers.items()}
        sync(dev)
        loss_rel = abs(rec[dev].loss - rec[cpu].loss) / abs(rec[cpu].loss)
        norm_rel = abs(rec[dev].grad_norm - rec[cpu].grad_norm) / abs(
            rec[cpu].grad_norm)
        msg = (f"#   {what} fp32 step {i} at depth {TRAIN_CHECK_LAYERS} "
               f"({n_params / 1e6:.1f} M params), card vs CPU: loss "
               f"{rec[dev].loss:.6f} vs {rec[cpu].loss:.6f} (relative "
               f"{loss_rel:.2e}), grad norm {rec[dev].grad_norm:.6f} vs "
               f"{rec[cpu].grad_norm:.6f} ({norm_rel:.2e})")
        check(loss_rel <= STEP_LOSS_RTOL and norm_rel <= STEP_NORM_RTOL,
              msg.lstrip("# "))
        if i == 0:
            moments = rel_l2(
                (getattr(trainers[dev].opt_state, k)[n],
                 getattr(ref.opt_state, k)[n])
                for k in ("mu", "nu") for n in p0)
            msg += f"; mu and nu relative L2 {moments:.2e}"
            check(moments <= MOMENT_RTOL, f"moments differ: {moments}")
        else:
            cards = trainers[dev].params()
            update = rel_l2((cards[n].cpu() - p0[n], p - p0[n])
                            for n, p in ref.params().items())
            msg += f"; parameter updates relative L2 {update:.2e}"
            check(update <= UPDATE_RTOL, f"updates differ: {update}")
        print(msg + f" ({time.perf_counter() - t0:.1f} s for both, the "
                    f"card {card})")


def gate_cl_cfg(base, variant="gate_cl", pallas=True, **kw):
    """`base` as `variant`, its encoder's self-attention on K1 (`pallas`)
    or on the plain core."""
    enc = dataclasses.replace(base.encoder, use_pallas=pallas)
    return dataclasses.replace(base, encoder=enc, variant=variant, **kw)


def add_counts(total: dict, counts: dict) -> dict:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    return total


def phase_k1_bert_heads(gen):
    """K1 against its plain version at the gate_cl family's shapes: 12
    heads of 64, bucketed lengths 16 and 24 (below K1's (64, 32) tile) and
    128 with key biases, packed rows of 48 with a block-diagonal full
    bias, in fp32 and bf16, to phase 2's tolerances."""
    print("# phase 9: K1 fused_attention vs attention_reference at "
          "BERT-base's 12 heads of 64 (B=8): bucketed 16, 24, 128 (key "
          "bias), packed 48 (block-diagonal)")
    for dtype in (torch.float32, torch.bfloat16):
        for S, kinds in ((16, BIAS_KINDS), (24, ("B11Sk",)),
                         (128, BIAS_KINDS), (48, ("packed",))):
            for kind in kinds:
                q, k, v, bias = attention_inputs(8, S, S, dtype, kind, gen,
                                                 N=12)
                before = fused_attention.launches
                out = fused_attention(q, k, v, bias, 12)
                torch.cuda.synchronize()
                check(fused_attention.launches == before + 1
                      and out.shape == q.shape and out.dtype == dtype,
                      f"K1 12 heads: {out.dtype} {tuple(out.shape)}")
                err, share = attention_close(
                    out, attention_reference(q, k, v, bias, 12),
                    f"K1 12x64 {dtype} S={S} {kind}")
                print(f"#   {str(dtype)[6:]:8s} Sq=Sk={S:3d} bias={kind:6s} "
                      f"max_abs_err={err:.3e} ({share:.2f} of its bound)")


def phase_gate_cl_serving(args, card, dev, base, ctx):
    """The gate_cl family served at full width behind phase 3's ResNet-152
    on phase 3's requests (their bare sentences and images), random weights
    from `--seed`: `BucketedGateCLServer` ("gate_cl", `masked_crs=True`)
    through K1 against the plain core in fp32, then in bf16;
    `PackedGateCLServer` in fp32; the "cl" and "ip" variants once each in
    bf16; `TokenClassifier` at BERT-base width through K1 against the plain
    core. Returns every kernel's launch count over these runs, each set to
    0 just before it."""
    print(f"# phase 9: the gate_cl family at full width (GateCLConfig(): "
          f"BERT-base {base.encoder.num_hidden_layers} x "
          f"{base.encoder.hidden_size}, layer_num1 {base.layer_num1}, "
          f"region_dim {base.region_dim}, max_seq_length "
          f"{base.max_seq_length}) behind phase 3's ResNet-152, "
          f"max_batch {MAX_BATCH}")
    strict_fp32()
    texts = [{"input_ids": t["ori_input_ids"]} for t in ctx["texts"]]
    images = ctx["images"]
    cfg = gate_cl_cfg(base, masked_crs=True)
    t0 = time.perf_counter()
    model = GateCLModel(cfg, device=dev, seed=args.seed).eval()
    plain = GateCLModel(gate_cl_cfg(base, pallas=False, masked_crs=True),
                        device=dev, seed=args.seed).eval()
    plain.load_state_dict(model.state_dict(), assign=True)
    model16 = GateCLModel(cfg, dtype=torch.bfloat16, device=dev,
                          seed=args.seed).eval()
    model16.load_state_dict(model.state_dict(), assign=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"#   built GateCLModel ({n_params / 1e6:.1f} M params, "
          f"crs_classifier {tuple(model.crs_classifier.weight.shape)}) in "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    servers = {name: BucketedGateCLServer(m, max_batch=MAX_BATCH, device=dev)
               for name, m in (("kernel", model), ("plain", plain),
                               ("kernel_bf16", model16))}
    backbones = {"kernel": ctx["backbone"], "plain": ctx["backbone"],
                 "kernel_bf16": ctx["backbone_bf16"]}
    for name in ("kernel", "kernel_bf16"):
        t0 = time.perf_counter()
        servers[name].warmup()
        print(f"#   {name}: warmup of buckets {servers[name].buckets} in "
              f"{time.perf_counter() - t0:.2f} s")
    total, runs = {}, {}

    def run_counted(name, server, backbone):
        zero_counts()
        tags, stats, examples, _ = serve(server, backbone, texts, images)
        counts = read_counts()
        add_counts(total, counts)
        batches = (stats.batches if hasattr(stats, "batches")
                   else sum(stats.batches_per_bucket.values()))
        runs[name] = dict(tags=tags, stats=stats, examples=examples,
                          launches=counts["fused_attention"],
                          batches=batches)
        print(f"#   {name}: {stats}, K1 launches "
              f"{counts['fused_attention']}")
        for t, tx in zip(tags, texts):
            check(t is not None
                  and len(t) == min(len(tx["input_ids"]),
                                    base.max_seq_length)
                  and t.min() >= 0 and t.max() < base.num_labels,
                  f"gate_cl {name}: bad tags {t}")
        if name != "plain":
            check(runs[name]["launches"] == BERT_LAYERS_PER_BATCH * batches,
                  f"gate_cl {name}: K1 launched {runs[name]['launches']} "
                  f"times for {batches} batches")

    for name in ("kernel", "plain", "kernel_bf16"):
        run_counted(name, servers[name], backbones[name])
    check(runs["plain"]["launches"] == 0, "gate_cl plain path launched K1")
    with torch.inference_mode():
        _, _, _, batch = next(servers["kernel"].batches(
            runs["kernel"]["examples"]))
        em_k, em_p = (m(**batch, return_emissions=True)
                      for m in (model, plain))
    check(bool(torch.isfinite(em_k).all()), "gate_cl: non-finite emissions")
    em_err = (em_k - em_p).abs().max().item()
    agree = agreement(runs["kernel"]["tags"], runs["plain"]["tags"])
    agree16 = agreement(runs["kernel_bf16"]["tags"], runs["kernel"]["tags"])
    print(f"#   fp32 first-batch emissions kernel vs plain: max_abs_err "
          f"{em_err:.3e} (tol {EMISSIONS_TOL:.0e}); tags kernel vs plain "
          f"{agree:.6f}, bf16 vs fp32 {agree16:.6f} (random weights)")
    check(em_err <= EMISSIONS_TOL, f"gate_cl emissions differ by {em_err}")
    check(agree >= 0.99, f"gate_cl tag agreement {agree} < 0.99")

    packed = PackedGateCLServer(model, tiers=PACKED_TIERS,
                                max_batch=MAX_BATCH, device=dev)
    t0 = time.perf_counter()
    packed.warmup()
    print(f"#   packed: warmup of tiers {PACKED_TIERS} in "
          f"{time.perf_counter() - t0:.2f} s")
    run_counted("packed", packed, ctx["backbone"])
    agree_b = agreement(runs["packed"]["tags"], runs["kernel"]["tags"])
    print(f"#   packed vs bucketed tags (fp32, K1): {agree_b:.6f}")
    check(agree_b >= 0.99, f"gate_cl packed vs bucketed {agree_b} < 0.99")

    for variant in ("cl", "ip"):
        m = GateCLModel(gate_cl_cfg(base, variant), dtype=torch.bfloat16,
                        device=dev, seed=args.seed).eval()
        run_counted(f"{variant} bf16",
                    BucketedGateCLServer(m, max_batch=MAX_BATCH, device=dev),
                    ctx["backbone_bf16"])
        del m

    heads = {p: TokenClassifier(dataclasses.replace(base.encoder,
                                                    use_pallas=p),
                                base.num_labels, device=dev,
                                seed=args.seed).eval() for p in (True, False)}
    heads[False].load_state_dict(heads[True].state_dict(), assign=True)
    args_tc = (batch["input_ids"], batch["input_mask"], batch["segment_ids"])
    with torch.inference_mode():
        zero_counts()
        logits = heads[True](*args_tc)
        sync(dev)
        counts = read_counts()
        add_counts(total, counts)
        want = heads[False](*args_tc)
    tc_err = (logits - want).abs().max().item()
    print(f"#   TokenClassifier (BERT-base, "
          f"{sum(p.numel() for p in heads[True].parameters()) / 1e6:.1f} M "
          f"params) on the first batch {tuple(args_tc[0].shape)}: fp32 "
          f"logits K1 vs plain core max_abs_err {tc_err:.3e} (tol "
          f"{EMISSIONS_TOL:.0e}), K1 launches {counts['fused_attention']}")
    check(tc_err <= EMISSIONS_TOL, f"TokenClassifier logits differ by "
                                   f"{tc_err}")
    check(counts["fused_attention"] == BERT_LAYERS_PER_BATCH,
          f"TokenClassifier launched K1 {counts['fused_attention']} times")
    del heads

    ctx["gc_server_bf16"] = servers["kernel_bf16"]
    for name, server, backbone in (
            ("gate_cl bucketed fp32", servers["kernel"], ctx["backbone"]),
            ("gate_cl bucketed bf16", servers["kernel_bf16"],
             ctx["backbone_bf16"]),
            ("gate_cl packed fp32", packed, ctx["backbone"])):
        report_walls(name, lambda: serve(server, backbone, texts, images),
                     card, len(texts))
    return total


def random_encoder_tree(cfg, rng, layers=None):
    """A `TextEncoder` parameter tree (the flax layout, float32, with the
    pooler) at `cfg`'s widths and `layers` deep, drawn from `rng`: weights
    N(0, 0.02), LayerNorm scales near 1."""
    H, I = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def dense(i, o):
        return {"kernel": w(i, o), "bias": w(o)}

    def norm():
        return {"scale": 1 + w(H), "bias": w(H)}
    encoder = {f"layer_{i}": {
        "attn": {n: dense(H, H) for n in ("query", "key", "value")},
        "attn_out": {"dense": dense(H, H), "norm": norm()},
        "ffn": {"wi": dense(H, I), "wo": dense(I, H), "norm": norm()}}
        for i in range(cfg.num_hidden_layers if layers is None else layers)}
    return {"embeddings": {
        "word_embeddings": w(cfg.vocab_size, H),
        "position_embeddings": w(cfg.max_position_embeddings, H),
        "token_type_embeddings": w(cfg.type_vocab_size, H),
        "norm": norm()}, "encoder": encoder,
        "pooler": {"dense": dense(H, H)}}


def hf_state_dict(tree, prefix, legacy_norms):
    """A `TextEncoder` tree under HF BERT/RoBERTa key names, as
    `transformers` writes them (no `transformers` needed): torch (out, in)
    weights, `prefix` ("bert." / "roberta.") before every key, LayerNorm
    `gamma`/`beta` as old BERT checkpoints name them when `legacy_norms`."""
    sd = {}
    g, b = ("gamma", "beta") if legacy_norms else ("weight", "bias")

    def lin(name, t):
        sd[f"{prefix}{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(t["kernel"].T))
        sd[f"{prefix}{name}.bias"] = torch.from_numpy(t["bias"])

    def norm(name, t):
        sd[f"{prefix}{name}.LayerNorm.{g}"] = torch.from_numpy(t["scale"])
        sd[f"{prefix}{name}.LayerNorm.{b}"] = torch.from_numpy(t["bias"])
    emb = tree["embeddings"]
    for table in ("word", "position", "token_type"):
        sd[f"{prefix}embeddings.{table}_embeddings.weight"] = \
            torch.from_numpy(emb[f"{table}_embeddings"])
    norm("embeddings", emb["norm"])
    for i in range(len(tree["encoder"])):
        t, p = tree["encoder"][f"layer_{i}"], f"encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.self.{n}", t["attn"][n])
        lin(f"{p}.attention.output.dense", t["attn_out"]["dense"])
        norm(f"{p}.attention.output", t["attn_out"]["norm"])
        lin(f"{p}.intermediate.dense", t["ffn"]["wi"])
        lin(f"{p}.output.dense", t["ffn"]["wo"])
        norm(f"{p}.output", t["ffn"]["norm"])
    lin("pooler.dense", tree["pooler"]["dense"])
    return sd


def hf_config(cfg, model_type):
    """`config.json` of an HF directory for `cfg`."""
    return {"model_type": model_type, **{k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "type_vocab_size", "hidden_dropout_prob",
        "attention_probs_dropout_prob", "layer_norm_eps", "pad_token_id")}}


def write_safetensors_bf16(path, sd):
    """`sd`'s tensors rounded to BF16 in a `.safetensors` file, written
    here (no `safetensors` package): an 8-byte little-endian header length,
    the JSON header {name: {dtype, shape, data_offsets}}, the raw bytes."""
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in sd.items():
        raw = t.to(torch.bfloat16).contiguous().view(torch.int16).numpy() \
            .tobytes()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def torchvision_state_dict(backbone):
    """A float `VisualBackbone` under torchvision's ResNet key names (conv1,
    bn1, layerS.B.convI / bnI / downsample.0 / downsample.1, OIHW)."""
    v = backbone_variables_from_state_dict(backbone.state_dict())
    params, stats = v["params"]["resnet"], v["batch_stats"]["resnet"]
    sd = {}

    def convbn(p, s, conv, bn):
        sd[f"{conv}.weight"] = torch.from_numpy(np.ascontiguousarray(
            p["conv"]["kernel"].transpose(3, 2, 0, 1)))
        for key, val in (("weight", p["scale"]), ("bias", p["bias"]),
                         ("running_mean", s["mean"]),
                         ("running_var", s["var"])):
            sd[f"{bn}.{key}"] = torch.from_numpy(np.asarray(val))
    convbn(params["stem"], stats["stem"], "conv1", "bn1")
    for name in params:
        if name == "stem":
            continue
        p, s = params[name], stats[name]
        pfx = "layer" + name[len("layer"):].replace("_", ".")
        for i in (1, 2, 3):
            convbn(p[f"conv{i}"], s[f"conv{i}"], f"{pfx}.conv{i}",
                   f"{pfx}.bn{i}")
        if "downsample" in p:
            convbn(p["downsample"], s["downsample"], f"{pfx}.downsample.0",
                   f"{pfx}.downsample.1")
    return sd


def flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def check_same_tree(got, want, what):
    """Every leaf of `got` bit-equal to `want`'s, the same names, dtypes
    and shapes."""
    got, want = flat_leaves(got), flat_leaves(want)
    check(sorted(got) == sorted(want),
          f"{what}: leaves {sorted(set(got) ^ set(want))[:4]} differ")
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or got[k].shape != want[k].shape
           or not np.array_equal(got[k], want[k])]
    check(not bad, f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}")
    return len(want)


def size_mb(path) -> float:
    path = Path(path)
    files = [path] if path.is_file() else [
        p for p in path.rglob("*") if p.is_file()]
    return sum(p.stat().st_size for p in files) / 1e6


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def write_weight_files(args, base, ctx, roberta):
    """Phase 10's files from random weights (`--seed`): a BERT-base HF
    directory (legacy names, `bert.` prefix, `pytorch_model.bin`), a
    RoBERTa-large-width `model.safetensors` directory at ROBERTA_DEPTH in
    BF16, a TF bundle at BERT-base widths and TF_DEPTH, and a torchvision
    `resnet152.pth` of phase 3's ResNet-152. Returns the source trees and
    the paths."""
    rng = np.random.default_rng(args.seed)
    enc = base.encoder
    src = {"bert": random_encoder_tree(enc, rng),
           "roberta": random_encoder_tree(roberta, rng, ROBERTA_DEPTH),
           "tf": random_encoder_tree(enc, rng, TF_DEPTH)}
    paths = {"bert": WEIGHTS_DIR / "bert-base", "roberta": WEIGHTS_DIR /
             "roberta-large", "tf": WEIGHTS_DIR / "tf" / "model.ckpt",
             "resnet": WEIGHTS_DIR / "resnet" / "resnet152.pth"}
    for d in (paths["bert"], paths["roberta"], paths["resnet"].parent):
        d.mkdir(parents=True, exist_ok=True)
    secs = {}
    _, secs["bert"] = timed(lambda: torch.save(
        hf_state_dict(src["bert"], "bert.", legacy_norms=True),
        paths["bert"] / "pytorch_model.bin"))
    (paths["bert"] / "config.json").write_text(
        json.dumps(hf_config(enc, "bert")))
    _, secs["roberta"] = timed(lambda: write_safetensors_bf16(
        paths["roberta"] / "model.safetensors",
        hf_state_dict(src["roberta"], "roberta.", legacy_norms=False)))
    (paths["roberta"] / "config.json").write_text(json.dumps(hf_config(
        dataclasses.replace(roberta, num_hidden_layers=ROBERTA_DEPTH),
        "roberta")))
    _, secs["tf"] = timed(lambda: write_tf_checkpoint(
        str(paths["tf"]), encoder_params_to_tf(src["tf"])))
    _, secs["resnet"] = timed(lambda: torch.save(
        torchvision_state_dict(ctx["backbone"]), paths["resnet"]))
    return src, paths, secs


def load_weight_files(src, paths, secs, ctx, roberta):
    """Phase 10's conversions and loads, each held leaf for leaf to the
    weights its file was written from. Returns the BERT-base config and
    params and the float ResNet-152 built from `load_backbone`."""
    cache = WEIGHTS_DIR / "cache"
    bert_msgpack = WEIGHTS_DIR / "bert.msgpack"
    resnet_msgpack = WEIGHTS_DIR / "resnet" / "resnet.msgpack"
    conv, said = {}, io.StringIO()
    with contextlib.redirect_stdout(said):
        _, conv["bert"] = timed(lambda: convert_cli.main(
            ["bert", "--src", str(paths["bert"]),
             "--dst", str(bert_msgpack)]))
        _, conv["resnet"] = timed(lambda: convert_cli.main(
            ["resnet", "--src", str(paths["resnet"]),
             "--dst", str(resnet_msgpack)]))
    for line in said.getvalue().splitlines():
        print(f"#   cli.convert: {line}")
    n = check_same_tree(restore_pytree(str(bert_msgpack)), src["bert"],
                        "cli.convert bert")
    (cfg, params), read_hf = timed(
        lambda: load_text_encoder(str(paths["bert"])))
    n = check_same_tree(params, src["bert"], "HF BERT-base directory")
    _, save_native = timed(lambda: save_text_encoder(
        str(cache / "bert-base-native"), cfg, params))
    (cfg_n, params_n), read_native = timed(lambda: load_text_encoder(
        "bert-base-native", cache_dir=str(cache)))
    check(cfg_n == cfg, f"native config {cfg_n} != {cfg}")
    check_same_tree(params_n, src["bert"], "native directory by bare name")
    (cfg_r, params_r), read_st = timed(lambda: load_text_encoder(
        str(paths["roberta"])))
    bf16 = {k: torch.from_numpy(v).bfloat16().float().numpy()
            for k, v in flat_leaves(src["roberta"]).items()}
    n_r = check_same_tree(flat_leaves(params_r), bf16,
                          "RoBERTa-large safetensors (BF16)")
    check(cfg_r == dataclasses.replace(roberta,
                                       num_hidden_layers=ROBERTA_DEPTH)
          and cfg_r.position_offset == 2, f"RoBERTa config {cfg_r}")
    params_t, read_tf = timed(lambda: load_tf_encoder(str(paths["tf"])))
    n_t = check_same_tree(params_t, src["tf"], "TF bundle")
    variables, read_pth = timed(lambda: load_backbone(
        str(paths["resnet"].parent)))
    want_vars = backbone_variables_from_state_dict(
        ctx["backbone"].state_dict())
    n_b = check_same_tree(variables, want_vars, "load_backbone(.pth dir)")
    check_same_tree(load_backbone(str(resnet_msgpack)), want_vars,
                    "load_backbone(resnet.msgpack)")
    for name, path, write, read, leaves, extra in (
            ("BERT-base HF directory (pytorch_model.bin, legacy names)",
             paths["bert"], secs["bert"], read_hf, n,
             f"cli.convert bert {conv['bert']:.2f} s "
             f"({size_mb(bert_msgpack):.1f} MB msgpack)"),
            ("native directory (save_text_encoder, read by bare name)",
             cache / "bert-base-native", save_native, read_native, n, ""),
            (f"RoBERTa-large {ROBERTA_DEPTH}-layer safetensors, BF16",
             paths["roberta"], secs["roberta"], read_st, n_r,
             "position_offset 2"),
            (f"TF bundle, BERT-base widths, {TF_DEPTH} layers",
             paths["tf"].parent, secs["tf"], read_tf, n_t,
             "crc32c written and verified"),
            ("torchvision resnet152.pth", paths["resnet"], secs["resnet"],
             read_pth, n_b, f"cli.convert resnet {conv['resnet']:.2f} s")):
        print(f"#   {name}: {size_mb(path):.1f} MB, written in {write:.2f} "
              f"s, read in {read:.2f} s, {leaves} leaves bit-equal"
              + (f"; {extra}" if extra else ""))
    return cfg, params, variables


def phase_weights(args, card, dev, base, ctx, resnet_layers,
                  roberta=EncoderConfig.roberta_large()):
    """Weights from files on disk, served in bench.py's gate_cl
    configuration: phase 10's files written, converted and loaded (each
    leaf held bit-equal to its source), `GateCLConfig()` on the loaded
    BERT-base encoder fused and unfused in fp32 behind phase 3's ResNet-152,
    then calibrated, fused and quantised int8-static (bf16, bf16 softmax,
    K1) behind the int8-static ResNet-152 that `load_backbone`'s weights
    give, through both gate_cl servers. Returns every kernel's launch count
    over the served runs, each set to 0 just before it."""
    t_phase = time.perf_counter()
    print(f"# phase 10: weights from files on disk, then gate_cl in "
          f"bench.py's int8-static fused-QKV configuration (GateCLConfig(): "
          f"BERT-base {base.encoder.num_hidden_layers} x "
          f"{base.encoder.hidden_size}), files under {WEIGHTS_DIR}")
    strict_fp32()
    texts = [{"input_ids": t["ori_input_ids"]} for t in ctx["texts"]]
    images = ctx["images"]
    total, runs = {}, {}
    try:
        src, paths, secs = write_weight_files(args, base, ctx, roberta)
        cfg_enc, params, bvars = load_weight_files(src, paths, secs, ctx,
                                                   roberta)
    finally:
        shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    check(cfg_enc == base.encoder, f"loaded config {cfg_enc} is not "
                                   f"GateCLConfig()'s {base.encoder}")

    def gc_model(quant="none", fuse=False, pallas=True, dtype=torch.float32,
                 softmax="float32"):
        enc = dataclasses.replace(cfg_enc, use_pallas=pallas, quant=quant,
                                  fuse_qkv=fuse, softmax_dtype=softmax)
        return GateCLModel(dataclasses.replace(
            base, encoder=enc, variant="gate_cl", masked_crs=True),
            dtype=dtype, device=dev, seed=args.seed).eval()

    def run_counted(name, server, backbone, kernel=True, fused=True):
        zero_counts()
        tags, stats, examples, _ = serve(server, backbone, texts, images)
        counts = read_counts()
        counts_strided = fused_attention.strided_launches
        add_counts(total, counts)
        batches = (stats.batches if hasattr(stats, "batches")
                   else sum(stats.batches_per_bucket.values()))
        runs[name] = dict(tags=tags, examples=examples, counts=counts,
                          batches=batches)
        print(f"#   {name}: {batches} device batches; K1 launches "
              f"{counts['fused_attention']} ({counts_strided} on strided "
              f"q/k/v views), K5 {counts['int8_stem_pool']}, K4 "
              f"{counts['int8_bottleneck_v2']}")
        for t, tx in zip(tags, texts):
            check(t is not None
                  and len(t) == min(len(tx["input_ids"]),
                                    base.max_seq_length)
                  and t.min() >= 0 and t.max() < base.num_labels,
                  f"{name}: bad tags {t}")
        k1 = counts["fused_attention"]
        check(k1 == (BERT_LAYERS_PER_BATCH * batches if kernel else 0),
              f"{name}: K1 launched {k1} times for {batches} batches")
        check(counts_strided == (k1 if fused else 0),
              f"{name}: {counts_strided} of {k1} K1 launches strided")
        return runs[name]

    def first_batch(server, name, *models):
        with torch.inference_mode():
            _, _, _, batch = next(server.batches(runs[name]["examples"]))
            return batch, [m(**batch, return_emissions=True) for m in models]

    # fuse_qkv in fp32: the loaded encoder, unfused and fused
    unfused = gc_model()
    unfused.bert.load_state_dict(state_dict_from_flax(params), strict=True)
    fused = gc_model(fuse=True)
    fused.load_state_dict(fuse_qkv_params(fused.state_dict().keys(),
                                          unfused.state_dict()), strict=True)
    fp32_sd = unfused.state_dict()
    for name, m in (("fp32 unfused", unfused), ("fp32 fused", fused)):
        run_counted(name, BucketedGateCLServer(m, max_batch=MAX_BATCH,
                                               device=dev), ctx["backbone"],
                    fused=m is fused)
    check(all(np.array_equal(a, b) for a, b in zip(
        runs["fp32 fused"]["tags"], runs["fp32 unfused"]["tags"])),
        "fused fp32 tags differ from the unfused ones")
    server = BucketedGateCLServer(fused, max_batch=MAX_BATCH, device=dev)
    _, (em_f, em_u) = first_batch(server, "fp32 fused", fused, unfused)
    err = (em_f - em_u).abs().max().item()
    print(f"#   fp32 fused vs unfused: tags identical, first-batch emissions "
          f"max_abs_err {err:.3e} (tol {FUSED_EMISSIONS_TOL:.0e})")
    check(err <= FUSED_EMISSIONS_TOL, f"fused fp32 emissions differ by {err}")
    del unfused

    # bench.py's serving configuration behind the loaded int8-static ResNet
    t0 = time.perf_counter()
    float_backbone = VisualBackbone(resnet_layers, device=dev).eval()
    float_backbone.load_state_dict(backbone_state_dict(bvars), strict=True)
    with torch.inference_mode():
        pixels = preprocess_images(images, 224, device=dev)
    backbones, _ = int8_static_backbones(
        float_backbone, pixels, resnet_layers, dev,
        fused=dict(fused_pallas=True))
    backbone = backbones["fused"]
    del float_backbone
    dyn = gc_model("int8", dtype=torch.bfloat16)
    dyn.load_state_dict(quantize_params_like(dyn.state_dict().keys(),
                                             fp32_sd), strict=True)
    serve(BucketedGateCLServer(dyn, max_batch=MAX_BATCH, device=dev),
          backbone, texts, images)
    calib = calibration_amax(dyn)
    del dyn
    models = {}
    for name, pallas in (("kernel", True), ("plain", False)):
        m = gc_model("int8_static", fuse=True, pallas=pallas,
                     dtype=torch.bfloat16, softmax="bfloat16")
        if not models:
            keys = m.state_dict().keys()
            static_sd = static_quantize_params_like(
                keys, fuse_qkv_params(keys, fp32_sd),
                fuse_qkv_params(keys, calib))
        m.load_state_dict(static_sd, strict=True)
        models[name] = m
    n_q = sum(v.dtype == torch.int8 for v in static_sd.values())
    print(f"#   calibrated {len(calib)} quantised modules on the requests "
          f"(dynamic int8, bf16), fused and quantised {n_q} int8 weights "
          f"(BERT's self-attention fused: {len(calib) - n_q} fewer), the "
          f"int8-static ResNet-152 from load_backbone's weights, in "
          f"{time.perf_counter() - t0:.1f} s")

    servers = {"int8-static fused bucketed": BucketedGateCLServer(
                   models["kernel"], max_batch=MAX_BATCH, device=dev),
               "int8-static fused packed": PackedGateCLServer(
                   models["kernel"], tiers=PACKED_TIERS,
                   max_batch=MAX_BATCH, device=dev),
               "int8-static fused plain core": BucketedGateCLServer(
                   models["plain"], max_batch=MAX_BATCH, device=dev)}
    for name, srv in servers.items():
        run = run_counted(name, srv, backbone, kernel="plain" not in name)
        if CHECK_CONV_LAUNCHES:
            k4, k5 = (run["counts"][n] for n in ("int8_bottleneck_v2",
                                                 "int8_stem_pool"))
            check(k5 == 1 and k4 == ctx["identity_blocks"],
                  f"{name}: K5 launched {k5} times and K4 {k4}")
    name = "int8-static fused bucketed"
    batch, (em_k, em_p, em_32) = first_batch(
        servers[name], name, models["kernel"], models["plain"], fused)
    check(bool(torch.isfinite(em_k.float()).all()),
          "int8-static: non-finite emissions")
    agree_p = agreement(runs["int8-static fused packed"]["tags"],
                        runs[name]["tags"])
    print(f"#   packed vs bucketed tags (int8-static, K1): {agree_p:.6f}")
    check(agree_p >= 0.99, f"int8-static packed vs bucketed {agree_p}")

    # the fused int8-static qkv Dense on the card against the CPU
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    qkv = models["kernel"].bert.encoder.layer_0.attn.qkv
    L = max(servers[name].buckets)
    x = (torch.randn(MAX_BATCH, L, cfg_enc.hidden_size, generator=gen,
                     device=dev).to(torch.bfloat16))
    host = copy.deepcopy(qkv).to("cpu")
    with torch.inference_mode():
        got, want = qkv(x).cpu(), host(x.cpu())
    check(got.dtype == want.dtype and torch.equal(got, want),
          f"fused int8-static qkv: card and CPU differ (max "
          f"{(got.float() - want.float()).abs().max().item()})")
    print(f"#   fused int8-static qkv Dense ({cfg_enc.hidden_size} -> "
          f"{3 * cfg_enc.hidden_size}) bit-equal on the card and the CPU "
          f"at ({MAX_BATCH}, {L}, {cfg_enc.hidden_size}) bf16 inputs")

    # printed, not held: random weights (PERF.md §7)
    valid = batch["input_mask"]
    for what, other, tags in (
            ("the same model on the plain core (bench.py's configuration "
             "exactly)", em_p, runs["int8-static fused plain core"]["tags"]),
            ("the fp32 fused model of step 3 (float ResNet-152)", em_32,
             runs["fp32 fused"]["tags"])):
        cos = token_cosines(em_k, other, valid)
        print(f"#   vs {what}: tag agreement "
              f"{agreement(runs[name]['tags'], tags):.6f}; first-batch "
              f"emissions per-token cosine mean {cos.mean().item():.6f}, "
              f"min {cos.min().item():.6f}")
    for label, srv, bb in (
            ("int8-static fused gate_cl bucketed", servers[name], backbone),
            ("int8-static fused gate_cl packed",
             servers["int8-static fused packed"], backbone),
            ("phase 9's float bf16 gate_cl bucketed", ctx["gc_server_bf16"],
             ctx["backbone_bf16"])):
        report_walls(label, lambda: serve(srv, bb, texts, images), card,
                     len(texts))
    print(f"#   phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return total


def phase_gate_cl_train(args, card, dev, base, layers):
    """The gate_cl family's training entry point, `GateCLTrainer.fit`, at
    full width (`fit_and_resume`): bf16 over fp32 master weights, the
    reference's negative_rate 16 under micro-batches of GC_TRAIN_BATCH (so
    the swap and the relation loss run), dropout on (the train steps keep
    off K1), K1 in the dev evaluation, a best-F1 save each epoch, the
    resumed snapshot. Then one train step each of "cl" and "ip", and one
    fp32 step at depth TRAIN_CHECK_LAYERS on the card against the CPU (its
    loss, gradient norm and moments; the update is phase 8's to hold).
    Returns every kernel's launch count over `fit`."""
    cfg = gate_cl_cfg(base)
    print(f"# phase 9: train: GateCLTrainer.fit at full width (bf16 over "
          f"fp32 master weights, {TRAIN_EPOCHS} epochs of {GC_TRAIN_ROWS} "
          f"rows in steps of {GC_TRAIN_ACCUM} x {GC_TRAIN_BATCH}, "
          f"negative_rate {cfg.negative_rate}, dev {GC_DEV_ROWS} rows, lr "
          f"{TRAIN_LR}, dropout on)")
    root = WORK_DIR / "gate_cl_train"
    shutil.rmtree(root, ignore_errors=True)
    ds = root / "ds"
    generate_dataset(str(ds), n_train=GC_TRAIN_ROWS, n_valid=GC_DEV_ROWS,
                     n_test=0, clip_dim=GC_CLIP_DIM, seed=args.seed,
                     write_images=False)
    tokenizer = tiny_tokenizer(str(ds / "tokenizer"))
    feats = {split: convert_examples(
        read_mm_conll(str(ds / f"{split}.txt")), tokenizer,
        cfg.max_seq_length, ClipFeatureStore.from_split(str(ds), split),
        GC_CLIP_DIM) for split in ("train", "valid")}
    tcfg = TrainConfig(learning_rate=TRAIN_LR,
                       train_batch_size=GC_TRAIN_BATCH,
                       eval_batch_size=GC_EVAL_BATCH,
                       gradient_accumulation_steps=GC_TRAIN_ACCUM,
                       seed=args.seed, compute_dtype="bfloat16")
    loader, train_batches = train_loaders(
        feats, str(ds / "images"), GC_TRAIN_BATCH, GC_TRAIN_ACCUM,
        GC_EVAL_BATCH, args.seed)
    counts, fresh, first = fit_and_resume(
        lambda: GateCLTrainer(cfg, tcfg, resnet_layers=layers, device=dev),
        loader, train_batches, root / "out", card, dev,
        BERT_LAYERS_PER_BATCH)
    backbone = fresh.backbone.state_dict()
    del fresh
    torch.cuda.empty_cache()
    for variant in ("cl", "ip"):
        tr = GateCLTrainer(gate_cl_cfg(base, variant), tcfg,
                           resnet_layers=layers, device=dev)
        tr.backbone.load_state_dict(backbone)
        tr.init_state(4)
        rec = tr.train_step(first, (0, 0))
        print(f"#   {variant}: one train step, loss {rec.loss:.4f}, grad "
              f"norm {rec.grad_norm}")
        check(rec.applied and math.isfinite(rec.loss),
              f"{variant} train step not finite: {rec}")
        del tr
        torch.cuda.empty_cache()

    # the depth-2 check runs self-attention on the plain core: with
    # dropout 0 the kernel would take it, and K1 refuses a gradient
    enc = dataclasses.replace(base.encoder,
                              num_hidden_layers=TRAIN_CHECK_LAYERS,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    shallow = gate_cl_cfg(dataclasses.replace(base, encoder=enc),
                          pallas=False)
    tcfg32 = dataclasses.replace(tcfg, compute_dtype="float32")
    phase_train_step_vs_cpu(
        card, lambda d: GateCLTrainer(shallow, tcfg32,
                                      resnet_layers=(1, 1, 1, 1), device=d),
        [first], dev)
    shutil.rmtree(root)
    return counts


def phase_bert_times(gen, row):
    """K1 at BERT-base's heads (12 x 64), B=128, at the longest bucket
    (S=128, key bias) and the short packed tier (S=48, block-diagonal full
    bias), bf16 and fp32, beside its plain version, SDPA (TF32 off in
    fp32) and its bound; its device time per launch from the profiler
    (these launches are shorter than the wrapper's host time), and at 128
    on the strided views of one fused projection. Adds `bert_*` keys to
    K1's row."""
    B, N = 128, 12
    print(f"# phase 7: K1 at the gate_cl family's shapes, B={B}, {N} heads "
          f"of 64")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.bfloat16, torch.float32):
        for S, kind in ((128, "B11Sk"), (48, "packed")):
            q, k, v, bias = attention_inputs(B, S, S, dtype, kind, gen, N=N)
            if kind == "packed":
                bias = bias.contiguous()  # one mask per row, as the model's
            out = fused_attention(q, k, v, bias, N)
            torch.cuda.synchronize()
            err, _ = attention_close(out, attention_reference(
                q, k, v, bias, N), f"K1 12x64 {dtype} S={S} at B={B}")
            del out
            ms = cuda_time_ms(lambda: fused_attention(q, k, v, bias, N))
            device_ms = kernel_device_ms(
                lambda: fused_attention(q, k, v, bias, N))
            plain_ms = cuda_time_ms(lambda: attention_reference(
                q, k, v, bias, N), iters=10, warmup=2)
            library_ms = sdpa_ms(q, k, v, bias, N, 50)
            bound_ms, bound_by, byts, flops = attention_bound(q, k, bias, N)
            tag = f"bert_{str(dtype)[6:]}_s{S}"
            if kind == "B11Sk":
                # the same call on q, k and v read in place from one fused
                # (B, S, 3D) projection, as phase 10's fused encoder runs it
                qkv = torch.cat([q, k, v], dim=-1)
                views = qkv.split(q.shape[-1], dim=-1)
                check(torch.equal(fused_attention(*views, bias, N),
                                  fused_attention(q, k, v, bias, N)),
                      f"K1 12x64 {dtype} S={S}: strided views differ")
                row[f"{tag}_strided_device_ms"] = kernel_device_ms(
                    lambda: fused_attention(*views, bias, N))
                del qkv, views
            row.update({f"{tag}_{key}": val for key, val in (
                ("shape", f"B={B} Sq=Sk={S} {N}x64 {str(dtype)[6:]} "
                          f"bias={kind}"),
                ("max_abs_err", err), ("ms", ms), ("device_ms", device_ms),
                ("plain_ms", plain_ms),
                ("bound_ms", bound_ms), ("bound_by", bound_by),
                ("library_ms", library_ms))})
            strided = (f" (on the strided views of one fused projection, "
                       f"bit-equal: device time "
                       f"{row[f'{tag}_strided_device_ms']:.4f} ms)"
                       if f"{tag}_strided_device_ms" in row else "")
            print(f"#   {str(dtype)[6:]} Sq=Sk={S} bias={kind}: max_abs_err "
                  f"{err:.3e}; kernel {ms:.4f} ms (profiler device time "
                  f"{device_ms:.4f} ms a launch){strided}, plain "
                  f"{plain_ms:.4f} ms, "
                  f"SDPA {library_ms:.4f} ms ({ms / library_ms:.2f}x), bound "
                  f"{bound_ms:.4f} ms ({ms / bound_ms:.1f}x; {bound_by}: "
                  f"{byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            del q, k, v, bias


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
    models, calib = int8_static_backbones(
        float_backbone, pixels, resnet_layers, dev,
        fused=dict(fused_pallas=True),
        fused_plain=dict(fused_pallas=True, plain_kernels=True), unfused={})
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
    ctx.update(backbone_int8=models["fused"], tags_int8_visual=tags,
               identity_blocks=identity_blocks)
    # the integer products outside K4/K5 (projection blocks, and every
    # block of the unfused backbone): torch._int_mm against the float64
    # int_dot they ran on before; both exact, so att must not move
    with torch.inference_mode(), float64_unfused_products():
        att_f64 = {name: models[name](pixels)[2]
                   for name in ("fused", "unfused")}
    check(all(torch.equal(att_f64[name], out[name][2])
              for name in att_f64),
          "att moved between the int8_matmul and int_dot products")
    for name in ("fused", "unfused"):
        line = []
        for product, ctxm in (("int8_matmul", contextlib.nullcontext),
                              ("float64 int_dot", float64_unfused_products)):
            with ctxm():
                ms = visual_ms(models[name], images, dev)
                try:
                    busy, _, _ = device_profile(lambda: visual_ms(
                        models[name], images, dev, repeats=0), top=1)
                    busy = f"{busy * 1e3:.2f} ms"
                except Exception as e:   # a report, not a check
                    busy = f"not measured ({type(e).__name__})"
            line.append(f"{product}: {ms:.2f} ms host clock, device busy "
                        f"{busy}")
        print(f"#   int8 {name} visual half, unfused products on "
              + "; on ".join(line) + f" (att bit-identical) on {card}")
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
        busy, rows, n = device_profile(lambda: visual_ms(
            models["fused"], images, dev, repeats=0), top=6)
        print(f"#   int8 fused visual half: device busy {busy * 1e3:.2f} ms "
              f"in {n} device kernel launches in one profiled run; top "
              f"kernels by device time:")
        for key, ms, calls in rows:
            print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    except Exception as e:       # the profiler is a report, not a check
        print(f"#   int8 visual device profile not measured ({e!r})")
    return counts


def int8_static_backbones(float_backbone, pixels, layers, dev, **variants):
    """Phase 4's quantisation of a float ResNet: the dynamic int8 backbone
    on its weights calibrated on `pixels`, then each of `variants` ({name:
    `VisualBackbone` flags}) built int8-static in bf16 and loaded with the
    statically quantised state (`static_quantize_backbone`, strict).
    Returns ({name: backbone}, the calibration record)."""
    with torch.inference_mode():
        dyn = VisualBackbone(layers, dtype=torch.bfloat16, quant="int8",
                             device=dev).eval()
        dyn.load_state_dict(float_backbone.state_dict(), strict=True)
        dyn(pixels)
    calib = calibration_amax(dyn)
    del dyn
    models = {name: VisualBackbone(layers, dtype=torch.bfloat16,
                                   quant="int8_static", device=dev,
                                   **kw).eval()
              for name, kw in variants.items()}
    static_sd = static_quantize_backbone(
        sorted(set().union(*(m.state_dict() for m in models.values()))),
        float_backbone.state_dict(), calib)
    for m in models.values():
        m.load_state_dict({k: v for k, v in static_sd.items()
                           if k in m.state_dict()}, strict=True)
    return models, calib


@contextlib.contextmanager
def float64_unfused_products():
    """The ResNet's integer products outside its kernels on float64
    `int_dot` in place of `int8_matmul` (both exact): the product they ran
    on before `int8_matmul`, kept for a comparison in one run."""
    saved = resnet_module.int8_matmul
    resnet_module.int8_matmul = kconv.int_dot
    try:
        yield
    finally:
        resnet_module.int8_matmul = saved


def quant_cfg(cfg, mode, use_pallas=True):
    """`cfg` with `quant=mode` and `use_pallas` on both encoder stacks (the
    BiLSTM takes the prompted encoder's mode)."""
    return dataclasses.replace(cfg, **{
        name: dataclasses.replace(getattr(cfg, name), quant=mode,
                                  use_pallas=use_pallas)
        for name in ("embedding", "last_encoder")})


def quantised_shapes(model):
    """Forward pre-hooks on every quantised module of `model`; returns
    (the set of (M, K, N) int8 products they see, the hook handles)."""
    shapes, hooks = set(), []

    def hook(mod, args):
        x = args[0]
        n = (mod.kernel_q.shape[1] if hasattr(mod, "kernel_q")
             else 8 * mod.hidden)
        shapes.add((x.numel() // x.shape[-1], x.shape[-1], n))
    for m in model.modules():
        if getattr(m, "quant", "none") != "none":
            hooks.append(m.register_forward_pre_hook(hook))
    return shapes, hooks


def token_cosines(a, b, mask):
    """Cosine of two (B, L, T) emission tensors per valid token."""
    a, b = a.double(), b.double()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-30)
    return cos[mask > 0]


def phase_int8_text(args, card, dev, ctx):
    """The JAX package's serving configuration: int8-static text (both
    RoBERTa stacks, the cross-attention stacks and the BiLSTM) in bf16 with
    K1, behind phase 4's int8-static ResNet-152. Returns every kernel's
    launch count over the main-path run."""
    print("# phase 4b: int8-static flagship serving (quant=int8_static on "
          "both encoders and the BiLSTM, bf16, use_pallas, behind phase 4's "
          "int8-static ResNet-152)")
    texts, images, spec = ctx["texts"], ctx["images"], ctx["spec"]
    backbone = ctx["backbone_int8"]
    kw = dict(max_batch=MAX_BATCH, offset=spec.offset,
              mask_positions=spec.mask_positions, device=dev)
    t0 = time.perf_counter()
    dyn = ICKAModel(quant_cfg(ctx["cfgs"][True], "int8"),
                    dtype=torch.bfloat16, device=dev, seed=args.seed).eval()
    dyn.load_state_dict(quantize_params_like(dyn.state_dict().keys(),
                                             ctx["weights"]), strict=True)
    shapes, hooks = quantised_shapes(dyn)
    try:
        serve(BucketedICKAServer(dyn, **kw), backbone, texts, images)
    finally:
        for h in hooks:
            h.remove()
    calib = calibration_amax(dyn)
    del dyn
    models = {}
    for name, pallas in (("kernel", True), ("plain", False)):
        m = ICKAModel(quant_cfg(ctx["cfgs"][True], "int8_static", pallas),
                      dtype=torch.bfloat16, device=dev, seed=args.seed).eval()
        if not models:
            static_sd = static_quantize_params_like(
                m.state_dict().keys(), ctx["weights"], calib)
        m.load_state_dict(static_sd, strict=True)
        models[name] = m
    n_q = sum(v.dtype == torch.int8 for v in static_sd.values())
    print(f"#   calibrated {len(calib)} quantised modules on the requests "
          f"(dynamic int8, bf16; act amax {min(calib.values()):.3f}.."
          f"{max(calib.values()):.3f}), quantised {n_q} int8 weights and "
          f"loaded 2 int8-static flagships (strict) in "
          f"{time.perf_counter() - t0:.1f} s")

    server = BucketedICKAServer(models["kernel"], **kw)
    zero_counts()
    tags, stats, examples, _ = serve(server, backbone, texts, images)
    counts = read_counts()
    n_batches = sum(stats.batches_per_bucket.values())
    k1, k4, k5 = (counts[n] for n in (
        "fused_attention", "int8_bottleneck_v2", "int8_stem_pool"))
    print(f"#   int8-static flagship: pairs per bucket "
          f"{stats.pairs_per_bucket}, {n_batches} device batches; K1 "
          f"launches {k1}, K4 {k4}, K5 {k5}")
    check(stats.total_pairs == len(texts), "int8 text: pairs lost")
    for t, tx in zip(tags, texts):
        check(t is not None
              and len(t) == min(len(tx["ori_input_ids"]),
                                ctx["max_seq_length"])
              and t.min() >= 0 and t.max() < ctx["num_labels"],
              f"int8 text: bad tags {t}")
    if CHECK_CONV_LAUNCHES:
        check(k1 == LAYERS_PER_BATCH * n_batches,
              f"int8 text: K1 launched {k1} times for {n_batches} batches")
        check(k5 == 1 and k4 == ctx["identity_blocks"],
              f"int8 text: K5 launched {k5} times and K4 {k4}")

    # (a) the exact product at every quantised shape of this run, and one
    # with at most 16 rows, against the float64 int_dot
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def rand_int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    cases = sorted(shapes | {(5, 1024, 1024)})
    for M, K, N in cases:
        a, w = rand_int8(M, K), column_major(rand_int8(K, N))
        check(torch.equal(int8_matmul(a, w), kconv.int_dot(a, w)),
              f"int8_matmul differs from int_dot at M={M} K={K} N={N}")
    print(f"#   (a) int8_matmul bit-equal to int_dot at {len(cases)} shapes "
          f"(M, K, N): {cases}")

    # (b) one int8-static Dense and the BiLSTM's input projection on the
    # card against the same modules on the CPU, same inputs
    L = max(stats.pairs_per_bucket)
    m = models["kernel"]
    mods = (("embedding.encoder.layer_0.ffn.wi",
             m.embedding.encoder.layer_0.ffn.wi, lambda mod, v: mod(v)),
            ("lstm.input_projection", m.lstm,
             lambda mod, v: mod.input_projection(v)))
    for name, mod, fn in mods:
        width = (m.cfg.last_hidden if name.startswith("lstm")
                 else m.cfg.embedding.hidden_size)
        x = (torch.randn(MAX_BATCH, L, width, generator=gen, device=dev)
             .to(torch.bfloat16))
        host = copy.deepcopy(mod).to("cpu")
        with torch.inference_mode():
            got, want = fn(mod, x).cpu(), fn(host, x.cpu())
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"{name}: card and CPU differ (max "
              f"{(got.float() - want.float()).abs().max().item()})")
    print(f"#   (b) bit-equal on the card and the CPU at ({MAX_BATCH}, {L}, "
          f"width) bf16 inputs: " + ", ".join(n for n, _, _ in mods))

    # printed, not held: random weights (PERF.md §7)
    zero_counts()
    tags_plain, _, _, _ = serve(BucketedICKAServer(models["plain"], **kw),
                                backbone, texts, images)
    check(read_counts()["fused_attention"] == 0, "plain core launched K1")
    em_k, em_p, em_f = first_batch_emissions(
        server, examples, (models["kernel"], models["plain"],
                           ctx["server_bf16"].model), spec)
    with torch.inference_mode():
        _, _, _, batch = next(server.batches(examples))
    valid = batch["output_mask"]
    check(bool(torch.isfinite(em_k.float()).all()), "non-finite emissions")
    for what, other, tg in (
            ("the int8-static model on the plain attention core", em_p,
             tags_plain),
            ("phase 4's bf16 float-text model (same int8 visual half)", em_f,
             ctx["tags_int8_visual"])):
        cos = token_cosines(em_k, other, valid)
        print(f"#   vs {what}: tag agreement {agreement(tags, tg):.6f}; "
              f"first-batch emissions per-token cosine mean "
              f"{cos.mean().item():.6f}, min {cos.min().item():.6f}")

    # smoke figures, 16 requests: this path, and phase 4's (bf16 float
    # text behind the same int8 visual half) beside it in the same run
    for name, srv in (("int8-static text", server),
                      ("phase 4's bf16 float text", ctx["server_bf16"])):
        run = lambda: serve(srv, backbone, texts, images)
        best = min((run()[3] for _ in range(3)), key=sum)
        print(f"#   {name} + int8-static ResNet-152: "
              f"{len(texts) / sum(best):.2f} pairs/s end to end, a smoke "
              f"figure (wall {sum(best) * 1e3:.1f} ms = visual "
              f"{best[0] * 1e3:.1f} ms + predict {best[1] * 1e3:.1f} ms, "
              f"best of 3) on {card}")
        try:
            busy, rows, n = device_profile(run)
        except Exception as e:   # the profiler is a report, not a check
            print(f"#   {name}: device profile not measured ({e!r})")
            continue
        print(f"#   {name}: device busy {busy * 1e3:.1f} ms of "
              f"{sum(best) * 1e3:.1f} ms wall ({busy / sum(best):.3f}) in "
              f"{n} device kernel launches; top kernels by device time, "
              f"then K1 (profiled run):")
        for key, ms, calls in rows:
            print(f"#     {ms:9.3f} ms {calls:6d}x {key[:90]}")
    if dev.type == "cuda":
        M = MAX_BATCH * max(stats.pairs_per_bucket)
        for K, N in ((1024, 4096), (4096, 1024)):
            a, w = rand_int8(M, K), column_major(rand_int8(K, N))
            ab = torch.randn(M, K, generator=gen, device=dev,
                             dtype=torch.bfloat16)
            wb = torch.randn(N, K, generator=gen, device=dev,
                             dtype=torch.bfloat16)
            w_rows = w.contiguous()
            print(f"#   FFN product M={M} K={K} N={N}: torch._int_mm "
                  f"{cuda_time_ms(lambda: torch._int_mm(a, w)):.4f} ms "
                  f"(column-major w), row-major w "
                  f"{cuda_time_ms(lambda: torch._int_mm(a, w_rows)):.4f} ms, "
                  f"F.linear bf16 "
                  f"{cuda_time_ms(lambda: F.linear(ab, wb)):.4f} ms on {card}")
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


def phase_times(gen, launches, packed_launches, eval_launches, k2_launches,
                int8_static_launches, train_launches, gate_cl_launches,
                weights_launches):
    """K1's row: `launches` counts phase 3, phase 9 (the gate_cl family)
    and phase 10 (gate_cl on weights from disk, fused QKV), the other
    paths' counts beside it."""
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
           "launches": launches + gate_cl_launches + weights_launches,
           "flagship_launches": launches,
           "gate_cl_launches": gate_cl_launches,
           "weights_launches": weights_launches,
           "packed_launches": packed_launches,
           "eval_launches": eval_launches,
           "int8_static_launches": int8_static_launches,
           "train_launches": train_launches,
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
    phase_bert_times(gen, row)
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
    for the same block (ConvBN modules, integer products on `_int_mm`) and
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
        int8_text_counts = phase_int8_text(args, card, dev, ctx)
        packed_counts = phase_packed(args, card, dev, ctx)
        eval_counts = phase_evaluate(args, card, dev, ctx)
        phase_k1_bert_heads(gen)
        gc_base = GateCLConfig()
        gc_serve_counts = phase_gate_cl_serving(args, card, dev, gc_base,
                                                ctx)
        weights_counts = phase_weights(args, card, dev, gc_base, ctx, layers)
        del ctx
        torch.cuda.empty_cache()
        train_counts = phase_train(args, card, dev, base, layers)
        gc_train_counts = phase_gate_cl_train(args, card, dev, gc_base,
                                              layers)
        # over the nine main paths, each driven from counts of 0
        runs = (counts, conv_counts, int8_text_counts, packed_counts,
                eval_counts, train_counts, gc_serve_counts, gc_train_counts,
                weights_counts)
        total = {name: sum(c[name] for c in runs) for name in COUNTERS}
        print(f"#   kernel launches over the nine main paths: {total}")
        for name in NO_CALLER:
            check(total[name] == 0, f"{name} has no caller in the model, yet "
                                    f"the main paths launched it "
                                    f"{total[name]} times")
        for name in ("int8_bottleneck_v2", "int8_stem_pool"):
            for what, c in (("evaluation", eval_counts),
                            ("training", train_counts),
                            ("gate_cl serving", gc_serve_counts),
                            ("gate_cl training", gc_train_counts)):
                check(c[name] == 0, f"{what} runs the float backbone, yet "
                                    f"launched {name}")
        kernels = phase_times(gen, counts["fused_attention"],
                              packed_counts["fused_attention"],
                              eval_counts["fused_attention"],
                              total["fused_attention_blockwise"],
                              int8_text_counts["fused_attention"],
                              train_counts["fused_attention"],
                              gc_serve_counts["fused_attention"]
                              + gc_train_counts["fused_attention"],
                              weights_counts["fused_attention"])
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
