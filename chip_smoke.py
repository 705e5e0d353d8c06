#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`icka_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero:

  1. build every CUDA kernel from `icka_tpu_torch/kernels/csrc` (one nvcc
     per source, all started together), count the tensor-core instructions
     in the blockwise library (bf16 HMMA and TF32 HMMA apart, and the wgmma
     bodies' HGMMA, bf16 and TF32 apart, and their TMA loads, UTMALDG) and
     in the int8 library (IGMMA and UTMALDG, and no IMMA or dp4a left: all
     four of its instances are int8 wgmma bodies), check that no fp32
     CUDA-core attention instance is left at widths up to 128, that the
     six attention wgmma instances (four bf16, two TF32) neither spill nor
     have their wgmma serialised by ptxas (C7518), and that none of the
     int8 library's instances spills or has a wgmma serialised, print
     registers and spills of every instance, and print the card's name and
     power limit as nvidia-smi gives them;
  2. hold every kernel against its plain PyTorch version on the card at the
     main paths' shapes: K1 `fused_attention` and K2
     `fused_attention_blockwise` (up to width 128 on the blockwise kernel's
     tensor-core bodies: at 64 on wgmma, bf16 and 3xTF32, at the other
     widths on mma.sync, bf16 and 3xTF32) in fp32 (TF32 off for the plain
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
 16. image files (after 6): a seeded JPEG corpus written with PIL (Twitter-
     like sizes 600x400 to 2048x1536, portrait, 200x150, each chroma
     subsampling, a grayscale, a progressive, a CMYK and a truncated file,
     one missing); the decoder in use printed (`native.decoder()`: on a
     machine without libjpeg.so, PIL's libjpeg at the native library's
     DCT scale and box filter, the same pixels) and PIL's JPEG support
     required; the loader's threaded batch path equal to its per-file
     path, the CMYK row to `decode_image`'s and the missing row to the
     fallback's, images/s on 4 threads and on one; phase 6's weights in a
     checkpoint with the backbone calibrated on these images, evaluated by
     `icka_tpu_torch.cli.evaluate.main` in bf16 (every row, loss finite,
     K1 48 a batch; eval pairs/s beside phase 6's), the first batch's fp32
     tags through K1 against the plain core (>= 0.99); two steps of `fit`
     from the train split's files (losses finite, K1 0);
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
     step each of "cl" and "ip", one fp32 step at depth 1 card vs CPU
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
     `ICKATrainer.fit` at full width, 4 layers a RoBERTa stack
     (`TRAIN_LAYERS`), in bf16 over fp32 master weights on a
     synthetic corpus without image files, two epochs of three steps with
     gradient accumulation 2, train-mode crop and flip, dropout on (so
     attention trains on the plain core: K1 0 times in the train steps,
     8 times per dev batch), a dev evaluation and best-F1 save each
     epoch; every loss finite, the last epoch's mean below the first's, a
     best-F1 checkpoint and a step snapshot written; a fresh trainer
     resumes the first epoch's snapshot and its next step's loss matches
     the run's; two fp32 steps at depth one on the card against the CPU
     (loss, gradient norm, moments, updates); the parameter count,
     optimizer-state bytes, peak memory, step and update times and the
     device-busy share printed;
 11. rematerialised training (after 9's training, before 7) in bench.py's
     train configuration: `ICKAConfig()` at full width with remat on both
     stacks, batch 16 in one micro-batch, bf16 over fp32 master weights,
     K1 for the dev evaluation only; for no remat and each policy ("dots",
     "dots_nb", "alternate", "full") a fresh trainer on the same initial
     weights: one micro-batch's gradients under the first step's
     generators, three `train_step`s on the same batches and keys, one
     profiled step; each policy's loss within 1e-5 of no remat's, its
     gradients and its updates within 1e-3 in relative L2, its peak
     allocated at most no remat's and "full"'s below it; step median,
     pairs/s, peak, device busy and launches printed. Then
     `ICKATrainer.fit` for one epoch under "dots" with its dev evaluation
     (K1 48 times a dev batch, 0 in the steps), and one `GateCLTrainer`
     step of `GateCLConfig()` under "full" against none with the same
     checks. The CRF at the serving shape (8 rows of 128, phase 3's
     lengths): the log-depth Viterbi's tags equal to the sequential
     decode's and the CPU's, both timed and profiled; the marginals card
     vs CPU within 1e-5. Last, the card tests of these modules
     (`tests/test_torch_on_card.py -k CARD_TESTS`, in a child pytest);
 12. the data axis (last, after 7), two ranks on the one card: NCCL
     refuses two ranks on one GPU, so they run over gloo, which carries
     CUDA tensors through the host, started with `spawn`. `ICKAConfig()`
     with ResNet-152 in fp32 (TF32 off), 4 layers a RoBERTa stack (the
     script's time limit), on a global batch of 2 x 8 from
     phase 8's corpus with random images (crop and flip) and dropout on:
     two steps on one rank without a process group (the reference), the
     same two steps on a NCCL world of one through the same code
     (bit-equal to the reference's; the all-reduce's seconds of the first
     step, which sets up the communicator, and of the second), then in
     two spawned ranks phase 3's
     requests through `BucketedICKAServer(mesh=)` in fp32 (tags identical
     to phase 3's fp32 tags on every rank, K1 48 times a device batch on
     each rank, added into the `kernels` line), two steps replicated and
     two under ZeRO-1 (losses and gradient norms within 2e-5 and 1e-4 of
     the reference's, the ranks' parameters bit-equal to each other's,
     ZeRO-1's parameters and moment slices bit-equal to replicated's,
     per-rank peaks and each step's compute, all-reduce and ZeRO-1 gather
     printed), and rank 0 writes the ZeRO-1 run's snapshot, which a
     single-rank trainer resumes bit-equal before it is removed. A rank
     that fails fails the run. It runs last and reads no profile: a
     short profiled call in a process a minute or more old may keep no
     device record (`tools/profiler_probe.py`, PERF.md section 7), and a
     profiled call that records none fails the run (`recorded`);
 13. the model axis (in phase 12's ranks, after their phase 12 work): the
     two ranks as a mesh (1, 2), tensor-parallel: phase 12's weights,
     seed and global batch (`ICKAConfig()` at full width, phase 12's
     depth, fp32, TF32 off, dropout, crop and flip on), two steps against
     phase 12's
     one rank (losses within 2e-5 relative, gradient norms 1e-4, each
     rank's replicated leaves bit-equal to the other's after each step,
     the state gathered to the JAX layout with the one-rank tree's names,
     shapes and dtypes and each rank's slice of it bit-equal to what the
     rank holds; per rank: peak allocated, each step's compute, TP
     collectives (timed, counted) and update); then phase 3's requests on
     phase 3's fp32 weights (the seed's) and backbone through the
     trainer's evaluation step, K1 on 8 heads a rank (emissions within
     1e-3 of one rank's evaluation on the same batch, tags >= 0.99 against
     phase 3's fp32 tags, K1 48 times a batch a rank, added into the
     `kernels` line; 0 in the steps); the same with `fuse_qkv=True` on
     the same weights (`fuse_qkv_params`): K1 48 times a batch on the
     rank's heads read as strided views of the gathered (B, S, 3072)
     projection, tags >= 0.999 of the unfused TP tags, and one fused train
     step, its loss within 2e-5 of the unfused first step's. Then K1
     against its plain version at a rank's 8 heads of 64 (S=150 key bias,
     S=172 full bias, and the evaluation's 128 and 172, fp32 and bf16),
     and timed at S=150 in fp32 on contiguous q/k/v and on the fused
     layout's views;
 15. ChunkAlign and the VCR plane at full width (after 14, before 12),
     fp32 with TF32 off, random weights from `--seed`: `ChunkAlignConfig()`
     (BERT-base with K1, 2048-d regions, max_hypo 50, chunk /
     cross-chunk / cross-modal layers 0-2 / 3-8 / 9-11, 4 choices) on 4
     questions x 4 choices with 50 regions: `ChunkAlignCLS` eval and
     train-mode forwards through K1 against the plain core on the same
     weights (scores and losses within 1e-4, predictions equal, K1 12 a
     call), one backward with dropout (the plain core), every gradient
     finite; the history KV-concat on its `GlobalVLEncoder` through K1 (Sk
     = 103 and 150: a masked zero history within 1e-5 of none, a visible
     one moving it); `ChunkAlignRationale` with GPT-2 small: `generate`
     against the cached greedy engine, a ragged-prompt full recompute
     against the cached one (tokens identical), beam with a
     `rationale_bonus_mask`, constrained search whose best beams hold both
     words, ms a decode step; `GPT2Captioner` greedy and 3-beam through K1
     and on the plain core (tokens identical, step logits within 1e-4);
     one forward each of the baselines (both memory modes), the three
     Oscar heads, `EnsembleRefiner` and `AbstractSpecificGate` through K1
     against the plain core (1e-4); the task plane from files it writes
     (VCR json, a region-feature pickle and TSV read back bit-equal,
     `VCRQAProcessor`, `convert_vl_examples`, `OscarMultipleChoice`,
     `itm_eval` on the card's scores). Then K1 against its plain version
     at B=16, Sq=100 against Sk=100, 103 and 150 in fp32 and bf16, timed
     in fp32; its launches go into K1's row;
 14. the chunker and generation at full width (after 7, before 12), fp32
     with TF32 off, random weights from `--seed`: a CoNLL-2000 chunker
     checkpoint (`chunker_config()`: BERT-base, a Pfeiffer adapter of 48
     in every layer, a 23-label head) written in adapter-transformers'
     key layout and loaded by `load_chunker` with K1 (and again on the
     plain core), 32 sentences of 10-60 word pieces tagged in batches of 8
     (buckets 32 and 64; K1 12 a batch; logits within 1e-4 of the plain
     core, tags' agreement and spans printed); the Oscar captioner
     (`CaptionConfig()`: BERT-base, 2048-d regions, 40 caption tokens, 50
     regions, K1) on 8 images: greedy and 3-beam search by full recompute
     (K1 12 a step with the full (B, 1, 90, 90) seq2seq bias) and on the
     KV cache, tokens identical and scores within 1e-4, the cached step's
     logits within 1e-4 of the full re-encode's; constrained beam search
     on the cached step (two one-token words, 4 FSM states x 2 beams, 20
     steps), every best beam holding both words; GPT-2 (`GPT2Config()`,
     cross-attention over an 8 x 50 x 768 memory) greedy and 3-beam on its
     KV cache against full teacher-forced decodes, tokens identical;
     seeded sampling (top_k 50, top_p 0.9, a CUDA generator) on GPT-2's
     cached step, one seed one result, every token inside its step's
     filter; ms a token of every decode printed. Then K1 against its plain
     version at the captioner's Sq=Sk=90 (seq2seq and random full bias)
     and the chunker's 32 and 64 (key bias) in fp32 and bf16, and timed in
     fp32 at the decodes' shapes; its launches go into K1's row;
  7. time each kernel at its main-path shape beside its plain version, the
     PyTorch library call for the same function where there is one, its
     bound and its recorded time before its redesign (comment lines only);
     the wgmma body at every bf16 head-64 shape of PERF.md's kernel table
     (K1 at 150 and 172 with 16 heads and 128 and 48 with 12, K2 at 150,
     172, 512 and 1024) by the profiler's device time a launch, at each of
     its four tilings too, beside SDPA, the bound and the recorded time of
     the mma.sync body (`MMA_SYNC_MS`); K5 at B=128 and, by its device
     time a launch, at the serving batch, K3 at B=128 and the bottleneck
     at its stages, beside their bounds and the recorded times of the
     mma.sync bodies (`CONV_MMA_SYNC_MS`); K1 and K2 in fp32 at K1's two
     shapes on the TF32 wgmma body, by events and by device time, beside
     SDPA, the bound and the recorded time of the 3xTF32 mma.sync body
     (`TF32_MMA_SYNC_MS`; at every other fp32 shape of the table, in
     phases 7, 13, 14 and 15, beside its device time too), and K1 at the
     body's two tilings; both at the first head width above 256; K1 at the
     gate_cl family's 12 heads (S=128 key bias, S=48 full bias, both
     types; at 128 also on the strided q/k/v views of one fused
     projection); time the served requests end to end.

After the last phase, every launch of K1 and K2 on the fifteen main paths
(heads of 64) must have run a wgmma body, path by path: every bf16 launch
the bf16 one (`wgmma_launches` equal to `bf16_launches`) and every fp32
launch the 3xTF32 one (`tf32_wgmma_launches` equal to the rest). Each
phase prints its seconds. The line before the last is the
`{"kernels": [...]}` JSON object; the last line is `{"ok": true, "device":
{...}}`. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import dataclasses
import io
import json
import math
import multiprocessing
import os
import pickle
import re
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
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
from icka_tpu_torch.core.mesh import Mesh, MeshSpec, init_distributed, make_mesh
from icka_tpu_torch.data import native, synthetic
from icka_tpu_torch.data.clip_store import ClipFeatureStore
from icka_tpu_torch.data.chunking import bio_spans
from icka_tpu_torch.data.conll import MMExample, read_mm_conll
from icka_tpu_torch.data.features import convert_examples
from icka_tpu_torch.data.images import preprocess_images
from icka_tpu_torch.data.labels import label_map
from icka_tpu_torch.data.loader import MNERLoader
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer
from icka_tpu_torch.data.task_processors import (VCRQAProcessor, VLInstance,
                                                 convert_vl_examples)
from icka_tpu_torch.evaluation.retrieval import itm_eval
from icka_tpu_torch.generation.constrained import (
    constrained_beam_search, fsm_from_constraints,
    select_best_beam_with_constraints)
from icka_tpu_torch.generation.decoding import (beam_search, greedy_decode,
                                                sample_decode,
                                                top_k_top_p_filter)
from icka_tpu_torch.generation.gpt2_cache import (cached_gpt2_step,
                                                  precompute_gpt2_cache)
from icka_tpu_torch.generation.kv_cache import (cached_caption_step,
                                                generate_captions_cached,
                                                precompute_image_cache)
from icka_tpu_torch.kernels import build
from icka_tpu_torch.kernels import conv as kconv
from icka_tpu_torch.kernels.attention import (
    HEAD_DIMS, K1_FP32_TILES, K1_WGMMA_TILES, WGMMA_BLOCK_SIZES,
    attention_blockwise_reference, attention_reference, blockwise_tiles,
    column_chunk, fused_attention, fused_attention_blockwise, kernel_width)
from icka_tpu_torch.models import resnet as resnet_module
from icka_tpu_torch.models.captioning import (CaptionConfig, CaptionModel,
                                              generate_captions,
                                              seq2seq_mask)
from icka_tpu_torch.models.chunker import (CONLL2000_ID2LABEL,
                                           CONLL2000_LABELS, chunker_config)
from icka_tpu_torch.models.convert import (calibration_amax,
                                           fuse_qkv_params,
                                           quantize_params_like,
                                           static_quantize_backbone,
                                           static_quantize_params_like)
from icka_tpu_torch.models.gate_cl import GateCLModel
from icka_tpu_torch.models.chunkalign import (ChunkAlignConfig,
                                              ChunkAlignRationale,
                                              choose_row, generate_rationale,
                                              rationale_bonus_mask)
from icka_tpu_torch.models.chunkalign_baselines import (BaselineCLS,
                                                        BaselineRationale,
                                                        EnsembleRefiner)
from icka_tpu_torch.models.ensemble import AbstractSpecificGate
from icka_tpu_torch.models.gpt2 import (GPT2Captioner, GPT2Config,
                                        GPT2Decoder, generate_gpt2_captions)
from icka_tpu_torch.models.oscar import (ImageBertPreTraining,
                                         ImageBertSequenceClassifier,
                                         OscarMultipleChoice)
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.models.pretrained import (load_backbone, load_chunker,
                                              load_text_encoder,
                                              load_tf_encoder,
                                              save_text_encoder)
from icka_tpu_torch.models.resnet import (Bottleneck, ConvBN, StemPoolS2D,
                                          VisualBackbone)
from icka_tpu_torch.models.tf_convert import (encoder_params_to_tf,
                                              write_tf_checkpoint)
from icka_tpu_torch.models.token_classifier import TokenClassifier
from icka_tpu_torch.nn.attention import MultiHeadAttention
from icka_tpu_torch.nn.crf import CRF
from icka_tpu_torch.nn.quant import column_major, int8_matmul
from icka_tpu_torch.parallel.partitioning import moment_slices, shard_params
from icka_tpu_torch.serving.bucketed import (BucketedGateCLServer,
                                             BucketedICKAServer, pick_bucket,
                                             sample_tweet_lengths)
from icka_tpu_torch.serving.packing import (PackedGateCLServer,
                                            PackedICKAServer)
from icka_tpu_torch.train.gate_cl_trainer import GateCLTrainer
from icka_tpu_torch.train.trainer import ICKATrainer, _seed
from icka_tpu_torch.utils.tsv_file import TSVFile, tsv_writer

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
# comment lines for comparison only. And the tilings of its fp32 body (the
# TF32 wgmma body's instances) timed beside K1_FP32_TILES.
K1_CUDA_CORE_MS = {150: 1.0643, 172: 1.2439}
TF32_WGMMA_TILINGS = ((64, 64), (128, 64))
# K1's and K2's fp32 times at head width 64 on the 3xTF32 mma.sync body
# that ran them before the TF32 wgmma body (NVIDIA H100 80GB HBM3, 700.00
# W): at B=128, 16 heads (by Sq = Sk), CUDA events, K1 at (64, 32), K2
# asked for (128, 128), running (128, 64); at the other shapes of PERF.md's
# kernel table (by their tag in K1's row), the profiler's device time a
# launch (chip_smoke.py's last run on that body). Recorded, not measured
# here: printed beside the new times, never in the `kernels` line.
TF32_MMA_SYNC_MS = {("K1", 150): 0.3680, ("K1", 172): 0.4686,
                    ("K2", 150): 0.5409, ("K2", 172): 0.6308,
                    "bert_float32_s128": 0.1744, "bert_float32_s48": 0.0582,
                    "gen_caption_greedy": 0.0154, "gen_caption_beam": 0.0340,
                    "gen_chunk32": 0.0064, "gen_chunk64": 0.0081,
                    "vcr_joint": 0.0239, "vcr_history3": 0.0240,
                    "vcr_history50": 0.0282, "tp": 0.0199,
                    "tp_strided": 0.0199}
# The bf16 shapes at head width 64 of PERF.md's kernel table, B=128: (row,
# heads, Sq = Sk, bias), where the wgmma body is timed beside SDPA, its
# bound and MMA_SYNC_MS: the times of the mma.sync body that ran them
# before it (K1 at (64, 32), K2 asked for (128, 128); chip_smoke.py phase
# 7 as of the twelfth slice of the port, CUDA events, at 12 heads the
# profiler's device time; NVIDIA H100 80GB HBM3, 700.00 W). Recorded, not
# measured here: printed beside the new times, never in the `kernels` line.
BF16_TIMED_SHAPES = (("K1", 16, 150, "B11Sk"), ("K1", 16, 172, "packed"),
                     ("K1", 12, 128, "B11Sk"), ("K1", 12, 48, "packed"),
                     ("K2", 16, 150, "B11Sk"), ("K2", 16, 172, "packed"),
                     ("K2", 16, 512, "B11Sk"), ("K2", 16, 1024, "B11Sk"))
MMA_SYNC_MS = {("K1", 16, 150): 0.1209, ("K1", 16, 172): 0.1822,
               ("K1", 12, 128): 0.0630, ("K1", 12, 48): 0.0262,
               ("K2", 16, 150): 0.2295, ("K2", 16, 172): 0.3409,
               ("K2", 16, 512): 0.8683, ("K2", 16, 1024): 3.1562}
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
BNECK_SOURCE = "icka_tpu_torch/kernels/csrc/int8_bottleneck_wgmma.cuh"
STEM_CONV3_SOURCE = "icka_tpu_torch/kernels/csrc/int8_conv_wgmma.cuh"
CHECK_CONV_LAUNCHES = True        # a CPU rehearsal launches no kernel
# K3-K6 at B=128 with their main loop on dp4a (chip_smoke.py phase 6 as of
# the fifth slice of the port, NVIDIA H100 80GB HBM3, 700.00 W): recorded,
# printed on comment lines for comparison only
CONV_DP4A_MS = {"int8_stem_pool": 1.5628, "int8_bottleneck_v2 H=14": 0.7419,
                "int8_bottleneck_v2 H=56": 1.2492, "int8_bottleneck": 0.7461,
                "int8_conv3x3": 0.3133}
# K4's and K6's times on the three-launch mma.sync body that ran them before
# the wgmma body (NVIDIA H100 80GB HBM3, 700.00 W): at B=128 from PERF.md's
# kernel table (chip_smoke.py phase 7 as of the twelfth slice of the port);
# at the serving batch, by stage H, the device time of a call's three
# launches (tools/int8_conv_launches.py on that body's tree, the mean of
# two runs in one chip call with the wgmma body's, parent and change in
# turns). Recorded, printed beside the new times, never in the `kernels`
# line.
CONV_MMA_SYNC_MS = {"int8_bottleneck_v2 H=14": 0.2585,
                    "int8_bottleneck_v2 H=56": 0.5313,
                    "int8_bottleneck": 0.2584,
                    "int8_stem_pool": 0.7424, "int8_conv3x3": 0.1063}
CONV_MMA_SYNC_B16_MS = {56: 0.0721, 28: 0.0595, 14: 0.0695, 7: 0.0884}
# K5's and K3's times on the int8 mma.sync body that ran them before the
# wgmma bodies (NVIDIA H100 80GB HBM3, 700.00 W): at B=128 in the entries
# above, from PERF.md's kernel table (chip_smoke.py phase 7 as of the
# twelfth slice of the port); K5 at the serving batch of 16, the device
# time of a launch (tools/int8_conv_launches.py --batch 16 on the
# twenty-first slice's tree, in the same chip call as the wgmma body's).
# Recorded, printed beside the new times, never in the `kernels` line.
CONV_MMA_SYNC_STEM_B16_MS = 0.0941
# K3's mma.sync body at B=128, 14 x 14, C = F = 256, by device time a
# launch (the same tool and chip call), the yardstick K3's `ms` is read in;
# the entry above is by CUDA events
CONV_MMA_SYNC_K3_DEVICE_MS = 0.1012
# phase 4b's int8-static visual half for 16 images (PERF.md §5, the ninth
# slice of the port), printed beside phase 4's
INT8_VISUAL_PR9_MS = 15.7
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
# ... at full width but TRAIN_LAYERS layers a RoBERTa stack (the script's
# time limit; phase 11 trains both stacks at full depth): K1 runs
# 2 * TRAIN_LAYERS times a dev batch
TRAIN_LAYERS = 4
# a fresh trainer resuming the first epoch's snapshot runs the next step on
# the same weights, batch and dropout seeds: the same bf16 forward, held
# to 1e-4 of the uninterrupted run's loss
RESUME_REL_TOL = 1e-4
# one fp32 step on the card against the CPU at a depth of one layer (both
# stacks and the cross stacks; the CPU's steps set this check's seconds),
# TF32 off, dropout 0, the same weights and batches: the loss and the
# gradients' global norm differ only by the order of sums (STEP_LOSS_RTOL,
# STEP_NORM_RTOL); the moments after the first step (lr 0 under warmup:
# params unmoved) within MOMENT_RTOL in relative L2 over all leaves, and
# the second step's parameter updates within UPDATE_RTOL. An element
# whose gradient is at noise level (a key projection's bias has a zero
# gradient in exact arithmetic) could take Adam's update of about +-lr on
# either side; it does not, as its noise (about 1e-10) lies below eps
# (1e-8): 4.5e-5 measured at depth 1, 4.4e-5 at depth 2 (NVIDIA H100 80GB
# HBM3, 700 W), 20x inside the bound.
TRAIN_CHECK_LAYERS = 1
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
# RoBERTa-large safetensors file and the TF bundle hold 2 layers (the
# bundle's 154 MB took 1.64 s each way with the numpy crc32c, 23.9 and
# 28.2 s with the byte loop, on an H100's host). The fused fp32 encoder against the unfused one differs only in the
# QKV product's order of sums, 12 layers deep.
WEIGHTS_DIR = WORK_DIR / "weights"
ROBERTA_DEPTH, TF_DEPTH = 2, 2
FUSED_EMISSIONS_TOL = 1e-5
# phase 11, rematerialised training in bench.py's train configuration
# (bench.py:1029-1044, :1435: ICKAConfig() with remat on both stacks, batch
# 16 in one micro-batch, bf16 over fp32 master weights, mu in fp32): no
# remat, then each policy, on the same initial weights, batches and keys.
# The remat'd forward is the plain forward's code on the same draws (the
# loss is expected bit-equal, held to REMAT_LOSS_RTOL); the gradients of
# one micro-batch and the updates of REMAT_STEPS steps are held to
# REMAT_RTOL in relative L2 over all leaves: a recompute with other dropout
# masks than the forward's moves the gradient by O(1).
REMAT_POLICIES = (None, "dots", "dots_nb", "alternate", "full")
REMAT_BATCH, REMAT_STEPS, REMAT_DEV_ROWS = 16, 3, 16
REMAT_LOSS_RTOL, REMAT_RTOL = 1e-5, 1e-3
# the new card tests, run from phase 11 (the whole file: README)
CARD_TESTS = "remat or crf_parallel or float_stem"
CARD_TEST_COUNT = 6
# the CRF at the flagship's serving shape: MAX_BATCH rows of 128 positions,
# standard-normal emissions. The marginals' bound is fp32's resolution at
# this length, not the 1e-5 of the short CPU tests: over 128 steps the
# log-potentials alpha + beta reach about 350 (log 15 a step), where one
# fp32 step is 3.05e-5, and the forward-backward's final subtraction
# rounds there. On these inputs the CPU's fp32 marginals are 1.18e-5 from
# a float64 run of the same recursions and their rows sum to 1 within
# 1.53e-5 (measured on the CPU); two devices rounding apart may differ by
# twice the first. Held: card vs CPU and row sums within 1e-4.
CRF_LENGTH, CRF_MARGINALS_TOL = 128, 1e-4


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
# the bottleneck wrappers' launches by cluster size, as `read_counts` keys
BOTTLENECKS = ("int8_bottleneck_v2", "int8_bottleneck")
CLUSTER_COUNTS = {f"{name}.cl{n}": (name, n) for name in BOTTLENECKS
                  for n in (1, 2, 4, 8)}


# the attention wrappers' launches of the bf16 and the fp32 (3xTF32) wgmma
# bodies and on bf16 inputs, as `read_counts` keys: on the main paths
# (every head 64 wide) every bf16 launch is a wgmma launch and every other
# a tf32_wgmma launch
ATTENTION = ("fused_attention", "fused_attention_blockwise")
BODY_COUNTS = {f"{name}.{what}": (name, f"{what}_launches")
               for name in ATTENTION
               for what in ("wgmma", "tf32_wgmma", "bf16")}


def zero_counts():
    for wrapper in COUNTERS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "strided_launches"):
            wrapper.strided_launches = 0
    for name, attr in BODY_COUNTS.values():
        setattr(COUNTERS[name], attr, 0)
    for name in BOTTLENECKS:
        COUNTERS[name].cluster_launches.update(
            dict.fromkeys(COUNTERS[name].cluster_launches, 0))


def read_counts() -> dict:
    counts = {name: wrapper.launches for name, wrapper in COUNTERS.items()}
    counts.update({key: getattr(COUNTERS[name], attr)
                   for key, (name, attr) in BODY_COUNTS.items()})
    counts.update({key: COUNTERS[name].cluster_launches[n]
                   for key, (name, n) in CLUSTER_COUNTS.items()})
    return counts


def cluster_split(counts: dict, name: str) -> dict:
    """A bottleneck wrapper's launches by cluster size, sizes that ran."""
    return {n: counts[f"{name}.cl{n}"] for n in (1, 2, 4, 8)
            if counts[f"{name}.cl{n}"]}


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
    tensor cores, HMMA.1688.F32.TF32: TF32 tensor cores, HGMMA: wgmma,
    UTMALDG: TMA tensor loads, IMMA: int8 tensor cores, IDP: dp4a on the
    CUDA cores; a prefix of the SASS word) the SASS of a built library
    holds."""
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
    hgmma_tf32 = "HGMMA.64x64x8.F32.TF32"
    hmma = sass_counts("blockwise_attention", (
        "HMMA", bf16_op, tf32_op, "HGMMA", hgmma_tf32, "UTMALDG"))
    hgmma_bf16 = hmma["HGMMA"] - hmma[hgmma_tf32]
    print(f"#   blockwise_attention: {hmma['HMMA']} HMMA instructions in its "
          f"SASS: {hmma[bf16_op]} {bf16_op} (bf16 mma.sync body), "
          f"{hmma[tf32_op]} {tf32_op} (3xTF32 mma.sync body, head widths "
          f"other than 64)")
    check(hmma[bf16_op] > 0, "the blockwise library has no bf16 HMMA")
    check(hmma[tf32_op] > 0, "the blockwise library has no TF32 HMMA")
    print(f"#   blockwise_attention: {hmma['HGMMA']} HGMMA (wgmma) "
          f"instructions in its SASS, {hmma[hgmma_tf32]} {hgmma_tf32} (the "
          f"3xTF32 wgmma body at head width 64) and {hgmma_bf16} bf16 ones "
          f"(the bf16 body at 64); {hmma['UTMALDG']} UTMALDG (TMA loads)")
    check(hgmma_bf16 > 0 and hmma[hgmma_tf32] > 0 and hmma["UTMALDG"] > 0,
          "the blockwise library has no bf16 or no TF32 wgmma, or no TMA "
          "load")
    conv = sass_counts("int8_conv", ("IMMA", "IDP", "IGMMA", "UTMALDG",
                                     "UBLKCP"))
    print(f"#   int8_conv: {conv['IGMMA']} IGMMA (int8 wgmma: the "
          f"bottleneck, stem and 3x3 conv bodies), {conv['UTMALDG']} "
          f"UTMALDG (TMA tensor loads) and {conv['UBLKCP']} UBLKCP (TMA "
          f"bulk copies) in its SASS; {conv['IMMA']} IMMA (mma.sync), "
          f"{conv['IDP']} IDP (dp4a)")
    check(conv["IGMMA"] > 0 and conv["UTMALDG"] > 0,
          "the int8 library has no int8 wgmma or no TMA load")
    check(conv["IMMA"] == 0, "the int8 library still multiplies with "
                             "mma.sync")
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
            wgmma = list({r[0]: r for r in rows if "wgmma" in r[0]}.values())
            log = build.build_log(name)
            print(f"#   the wgmma instances: " + ", ".join(
                f"{r[0].split(' ', 1)[1]} {r[1]} registers, {r[3]} bytes "
                f"spilled" for r in wgmma) + f"; ptxas serialised wgmma "
                f"(C7518) {log.count('C7518')} times")
            # 4 bf16 instances, (64 | 128)^2, and 2 TF32 ones, block_q
            # 64 | 128 at block_k 64
            check(len(wgmma) == 6 and all(r[3] == 0 for r in wgmma)
                  and sum("tf32" in r[0] for r in wgmma) == 2
                  and "C7518" not in log,
                  f"wgmma instances {wgmma}: expected 6 (2 of them TF32), "
                  f"none spilling, none serialised")
        if name == "int8_conv":
            # every instance is a wgmma body: the bottleneck's, the stem's
            # at 4F = 128 and 256, the 3x3 conv's (common and wide widths)
            log = build.build_log(name)
            serialised = len(re.findall(r"C75\d\d|are serialized", log))
            print(f"#   the int8 wgmma bodies: " + ", ".join(
                f"{r[0]} {r[1]} registers at launch, {r[3]} bytes spilled"
                for r in rows) + f"; ptxas serialised wgmma {serialised} "
                f"times")
            want = ("int8_bottleneck_kernel <>", "int8_conv3x3_kernel <0>",
                    "int8_conv3x3_kernel <1>", "int8_stem_pool_kernel <2>",
                    "int8_stem_pool_kernel <4>")
            check(sorted(r[0] for r in rows) == sorted(want)
                  and all(r[3] == 0 for r in rows) and serialised == 0,
                  f"int8 instances {rows}: expected {want}, none spilling, "
                  f"no wgmma serialised")
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
    errs, n, clusters = {}, 0, set()
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
        clusters.add(kconv.bottleneck_geometry(B, H, H, Cw,
                                               kconv._sm_count(0))["CL"])
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
    # widths shared memory cannot hold: K5's weight streamed with the
    # patches (K = 640 at 4F = 256) or resident in a ring of fewer slots
    # than a tile's spans (K = 1024 at 4F = 128); K3's box in groups of
    # spans (C = 5248) and its scales read from a global copy (F = 24576)
    for K, F in ((640, 64), (1024, 32)):
        args = stem_inputs(gen, B, 20, K, F)
        check_equal(f"K5 OB=20 K={K} 4F={4 * F}",
                    kconv.int8_stem_pool(*args),
                    kconv.stem_pool_reference(*args), errs, "int8_stem_pool")
        n += 1
    for H, C, F in ((4, 5248, 16), (2, 16, 24576)):
        a = conv3x3_inputs(gen, 1, H, C, F)
        args = (a["x_pad"], a["w_q"], a["scale"], a["bias"],
                a["residual"].bfloat16())
        check_equal(f"K3 H={H} C={C} F={F}",
                    kconv.int8_conv3x3(*args, out_scale=0.7),
                    kconv.conv3x3_reference(*args, out_scale=0.7), errs,
                    "int8_conv3x3")
        n += 1
    print(f"#   {n} comparisons bit-equal: " + ", ".join(
        f"{k} max_abs_err={v}" for k, v in errs.items())
          + f"; K4/K6 in clusters of {sorted(clusters)} CTAs")
    check(clusters == {1, 2, 4, 8}, f"K4/K6 ran in clusters of "
                                    f"{sorted(clusters)}, not 1, 2, 4 and 8")
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


def recorded(n: int, fn) -> int:
    """`n`, the device records of a profiled call of `fn`; a failure when
    there are none (every profiled call launches a kernel), as when
    `torch.profiler` stops recording device kernels late in this process
    (PERF.md section 7)."""
    check(n > 0, f"torch.profiler recorded no device kernel in the "
                 f"profiled call of {getattr(fn, '__qualname__', fn)}")
    return n


def device_profile(fn, top=8):
    """torch.profiler over one call of `fn`: total device seconds, the
    `top` device records by time and K1's own row (name, ms, calls), and
    the number of device records (kernels, copies and sets), grouped by
    name from the profiler's raw records: `key_averages` costs tens of
    seconds on a call of thousands of launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns, calls = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns[e.name()] += e.duration_ns()
            calls[e.name()] += 1
    rows = [name for name, _ in ns.most_common(top)]
    rows += [name for name in ns
             if "attention" in name and "kernel" in name and name not in rows]
    return (sum(ns.values()) / 1e9,
            [(name, ns[name] / 1e6, calls[name]) for name in rows],
            recorded(sum(calls.values()), fn))


def device_busy(fn):
    """(device seconds, device-side records: kernels, copies and sets) of
    one call of `fn`, as `device_profile` counts them, without grouping
    them by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    records = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    return (sum(e.duration_ns() for e in records) / 1e9,
            recorded(len(records), fn))


def kernel_device_ms(fn, iters=50, seconds=1.0, kernel="attention"):
    """Device time per launch of the kernel (named with `kernel`) that `fn`
    launches, from torch.profiler's kernel records: where the kernel is shorter
    than its wrapper's host time, CUDA events around a loop of calls count
    the gaps between launches too. The profiled loop lasts about `seconds`
    (at least `iters` calls): late in a process the profiler keeps none
    of a short call's device records and all but a few of a long one's
    (PERF.md section 7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    calls = max(iters, math.ceil(seconds * iters
                                 / (time.perf_counter() - t0)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # the raw records: grouping thousands of calls' records by name
    # (`key_averages`) costs seconds
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA and kernel in e.name()]
    return sum(ns) / 1e6 / recorded(len(ns), fn)


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
               tags=runs["kernel"]["tags"],
               examples=runs["kernel"]["examples"],
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
    ctx["eval_pairs_s"] = result.rows / result.seconds
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


# phase 16, image files at full width: the corpus's images are JPEG files
# the phase writes with PIL from `--seed` (photo-like: smooth colour fields
# and grain), at Twitter-like sizes cycling through 4:4:4, 4:2:2 and 4:2:0,
# and in the test split's first batch a 200x150 one, a grayscale, a
# progressive, a CMYK (the decoder refuses it: PIL's bicubic resize, as the
# JAX loader falls back) and a truncated file and a row whose file is
# missing. FILE_TEST_ROWS rows are evaluated by the CLI, FILE_TRAIN_ROWS
# trained for FILE_TRAIN_ROWS // TRAIN_BATCH steps of `fit`.
FILE_SIZES = ((1024, 768), (600, 400), (1200, 675), (2048, 1536),
              (768, 1024))
FILE_SPECIAL = ("small", "gray", "progressive", "cmyk", "truncated",
                "missing")
FILE_TEST_ROWS, FILE_TRAIN_ROWS = 48, 16
FILE_TAGS_MIN = 0.99


def photo(rng, w, h):
    """A seeded photo-like RGB image: smooth colour fields plus grain."""
    from PIL import Image
    base = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3), np.uint8)
    smooth = np.asarray(Image.fromarray(base).resize((w, h),
                                                     Image.BILINEAR))
    grain = rng.integers(-20, 21, (h, w, 3))
    return np.clip(smooth.astype(np.int16) + grain, 0, 255).astype(np.uint8)


def write_jpeg(path, pixels, kind=None, subsampling=2):
    """`pixels` as a JPEG of quality 90: grayscale, progressive or CMYK
    by `kind`, else at `subsampling`, cut to its first 3/5 where `kind` is
    "truncated"."""
    from PIL import Image
    im = Image.fromarray(pixels)
    if kind == "gray":
        im.convert("L").save(path, quality=90)
    elif kind == "progressive":
        im.save(path, quality=90, progressive=True)
    elif kind == "cmyk":
        im.convert("CMYK").save(path, quality=90)
    else:
        im.save(path, quality=90, subsampling=subsampling)
    if kind == "truncated":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:len(data) * 3 // 5])


def write_image_files(feats, images, rng, special=()) -> dict:
    """A JPEG file at each row's path: the `special` kinds first, then
    FILE_SIZES in turn at subsampling 0, 1, 2. Returns {kind: path} of the
    special rows."""
    os.makedirs(images, exist_ok=True)
    out = {}
    for row, img_id in enumerate(feats.img_ids):
        path = os.path.join(images, img_id)
        kind = special[row] if row < len(special) else None
        if kind is not None:
            out[kind] = path
        if kind == "missing":
            continue
        w, h = ((200, 150) if kind == "small"
                else FILE_SIZES[row % len(FILE_SIZES)])
        write_jpeg(path, photo(rng, w, h), kind, row % 3)
    return out


# the reference's pixels, held across machines: the files `digest_files`
# writes (seed DIGEST_SEED), their bytes' sha256 as PIL 12.1.0 (libjpeg-
# turbo 3.1.3) encodes them, and the crc32 of each one's 256^2 decode by
# native/libicka_native.so (libjpeg-turbo 2.1.5), the JAX loader's
# decoder; recomputed by `print(digest_files(DIR))` where the library
# loads. Where a machine's PIL writes the same bytes, its decode must
# give the same crc32; where it writes others the file is not compared.
DIGEST_SEED = 19
DIGEST_KINDS = (("1024x768_420", 1024, 768, 2), ("2048x1536_444", 2048, 1536, 0),
                ("600x400_422", 600, 400, 1), ("768x1024_420", 768, 1024, 2),
                ("200x150_420", 200, 150, 2), ("gray", 1200, 675, None),
                ("progressive", 1200, 675, None),
                ("truncated", 1024, 768, 2))
REFERENCE_DIGESTS = {
    "1024x768_420": ("c6192a51d4ba51d754d2703873c2c5fb02b38244954760dea906"
                     "aaf1bcfdce53", 300094988),
    "2048x1536_444": ("03af6ada9bedf8cbd644ea5ec81c9f1ed16b78c44a007e1bb39"
                      "3b6f2bd31680a", 699865340),
    "600x400_422": ("516a6587220fe4ce486272e8c2b416276d679d2f89b5184388f126"
                    "28dd218a1e", 98767668),
    "768x1024_420": ("beef6c5bf65fa7812ccf8bab9b8e30fb7f54413846212b10eb58d"
                     "4126943386e", 736323967),
    "200x150_420": ("0faf4a3c00df4a5ecc6b6f2857981722ab6fe59b1e6687905432256"
                    "c3386540a", 3573888156),
    "gray": ("2016e1b8af1bdafb173fe830031bb1ca42d81f690613b689afd55d2eea9f69"
             "aa", 2248452145),
    "progressive": ("3541be190f4b181ff936db205ce941d1f69aa1f07a08f78ddbfb1722"
                    "3388faa1", 1596369707),
    "truncated": ("614b2326bc9a37ab1ca2addf775c9f5c89ee5c5e4bcd879f605aa7bc6"
                  "770f46a", 3868316246),
}


def digest_files(root) -> dict:
    """Write DIGEST_KINDS's files under `root`; {name: (path, sha256 of
    the file, crc32 of its 256^2 decode by `native.decode_jpeg`)}."""
    import hashlib
    import zlib
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(DIGEST_SEED)
    out = {}
    for name, w, h, sub in DIGEST_KINDS:
        path = os.path.join(root, f"{name}.jpg")
        write_jpeg(path, photo(rng, w, h), name, sub)
        with open(path, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        out[name] = (path, sha, zlib.crc32(native.decode_jpeg(path, 256)))
    return out


def phase_image_files(args, card, dev, ctx):
    """Phase 16: evaluation and training from JPEG files at full width (the
    configuration of phase 6: `ICKAConfig()`, ResNet-152, bf16, K1). The
    decoder (`native.decoder()`: the library, or PIL's libjpeg at its scale
    and box filter where libjpeg.so is missing, as on the H100's machine);
    the loader's threaded batch path against its per-file path; the CMYK
    and missing rows against `decode_image` and the fallback; images/s on
    the loader's threads. Phase 6's weights in a checkpoint written by
    phase 6's writer, the backbone's BatchNorm statistics calibrated on
    these images (phase 6's are calibrated on zero images); the CLI's
    loss finite and every row evaluated (K1 48 a batch), the first batch's
    fp32 tags through K1 against the plain core (>= FILE_TAGS_MIN); then
    `fit` for FILE_TRAIN_ROWS // TRAIN_BATCH steps from the train split's
    files, losses finite. Returns every kernel's launch count over the
    CLI's evaluation and `fit`."""
    from icka_tpu_torch.data import jpeg
    from icka_tpu_torch.data.images import decode_image
    cfg = ctx["cfgs"][True]
    tiny = "--tiny" in EVAL_CLI_FLAGS
    layers, decode = ((1, 1, 1, 1), 64) if tiny else ((3, 8, 36, 3), 256)
    print(f"# phase 16: image files: {FILE_TEST_ROWS} test and "
          f"{FILE_TRAIN_ROWS} train rows of JPEG files written with PIL "
          f"(sizes {FILE_SIZES}, 200x150, grayscale, progressive, CMYK, "
          f"truncated, one missing), evaluated by "
          f"icka_tpu_torch.cli.evaluate (bf16, ResNet-152, use_pallas) and "
          f"trained by fit")
    jpeg.pil_image()           # raises where PIL cannot decode JPEGs
    which = native.decoder()
    from PIL import features
    print(f"#   decoder {which}; native/libicka_native.so "
          f"{native_status()}; PIL's libjpeg-turbo "
          f"{features.version('libjpeg_turbo')}")
    root = WORK_DIR / "files"
    shutil.rmtree(root, ignore_errors=True)
    digests = digest_files(root / "digest")
    same_bytes = [n for n, (_, sha, _) in digests.items()
                  if sha == REFERENCE_DIGESTS[n][0]]
    same_pixels = [n for n in same_bytes
                   if digests[n][2] == REFERENCE_DIGESTS[n][1]]
    print(f"#   the reference's pixels: {len(same_bytes)} of {len(digests)} "
          f"seeded files byte-equal to the ones the native library decoded "
          f"(REFERENCE_DIGESTS); their 256^2 decodes here equal the "
          f"library's (crc32) for {len(same_pixels)} of them"
          + ("" if len(same_bytes) == len(digests) else
             f" (other bytes, not compared: "
             f"{sorted(set(digests) - set(same_bytes))})"))
    check(same_pixels == same_bytes,
          f"decoded other pixels than the native library's: "
          f"{sorted(set(same_bytes) - set(same_pixels))}")
    ds, out = root / "ds", root / "out"
    generate_dataset(str(ds), n_train=FILE_TRAIN_ROWS, n_valid=0,
                     n_test=FILE_TEST_ROWS, clip_dim=cfg.clip_dim,
                     seed=args.seed, write_images=False)
    tokenizer = tiny_tokenizer(str(ds / "tokenizer"))
    feats = {split: convert_examples(
        read_mm_conll(str(ds / f"{split}.txt")), tokenizer,
        cfg.max_seq_length, ClipFeatureStore.from_split(str(ds), split),
        cfg.clip_dim) for split in ("train", "test")}
    images = str(ds / "images")
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    kinds = write_image_files(feats["test"], images, rng, FILE_SPECIAL)
    write_image_files(feats["train"], images, rng)
    paths = sorted(str(p) for p in Path(images).iterdir())
    mb = sum(os.path.getsize(p) for p in paths) / 1e6
    print(f"#   {len(paths)} files, {mb:.1f} MB, written in "
          f"{time.perf_counter() - t0:.1f} s")

    # the loader: its threaded batch path against its per-file path, the
    # refused and missing rows, images/s
    fallback = os.path.join(images, feats["train"].img_ids[0])
    kw = dict(train=False, decode_size=decode, prefetch=0,
              cache_images=False, fallback_image=fallback)
    n = FILE_TEST_ROWS
    t0 = time.perf_counter()
    batched = np.concatenate([b["images"][:int(b["row_valid"].sum())]
                              for b in MNERLoader(feats["test"], images,
                                                  EVAL_BATCH, **kw)])
    batch_s = time.perf_counter() - t0
    single_loader = MNERLoader(feats["test"], images, EVAL_BATCH, **kw)
    t0 = time.perf_counter()
    single = np.stack([single_loader._image(r) for r in range(n)])
    single_s = time.perf_counter() - t0
    rows = {kind: feats["test"].img_ids.index(os.path.basename(p))
            for kind, p in kinds.items()}
    same = np.array_equal(batched, single)
    cmyk_ok = np.array_equal(batched[rows["cmyk"]], decode_image(
        kinds["cmyk"], decode))
    missing_ok = np.array_equal(batched[rows["missing"]],
                                decode_image(fallback, decode))
    t0 = time.perf_counter()
    decoded = [p for p in paths if native.decode_jpeg(p, decode) is not None]
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, failures = native.decode_jpeg_batch(decoded, decode, num_threads=4)
    threads_s = time.perf_counter() - t0
    print(f"#   loader: batch path (decode_jpeg_batch, 4 threads) equals the "
          f"per-file path row for row: {same}; CMYK row equals "
          f"decode_image's: {cmyk_ok}; missing row equals the fallback's: "
          f"{missing_ok}; {n} rows through the eval loader in "
          f"{batch_s:.2f} s ({n / batch_s:.1f} rows/s), one at a time "
          f"{single_s:.2f} s ({n / single_s:.1f} rows/s); "
          f"{len(decoded)} decodable files on 4 threads in "
          f"{threads_s:.3f} s: {len(decoded) / threads_s:.1f} images/s "
          f"({failures} failures), on one {len(paths) / one_s:.1f} "
          f"images/s; on {card}")
    check(same, "the loader's batch path differs from its per-file path")
    check(cmyk_ok and missing_ok, "the CMYK or the missing row is not what "
                                  "the JAX loader gives")
    check(failures == 0 and len(decoded) == len(paths) - 1,
          f"{len(paths) - len(decoded)} files refused, {failures} failed")
    check(batched[rows["truncated"]].any() and batched[rows["gray"]].any(),
          "the truncated or grayscale row decoded to zeros")

    # phase 6's weights, the backbone calibrated on these images
    first = next(iter(MNERLoader(feats["test"], images, EVAL_BATCH,
                                 train=False, prefetch=0,
                                 decode_size=decode)))
    backbone = VisualBackbone(layers, device=dev).eval()
    backbone.load_state_dict(ctx["backbone"].state_dict())
    calibrate_batch_stats(backbone, preprocess_images(
        first["images"], min(224, decode), dev))
    write_s, size = write_checkpoint(out, cfg, ctx["weights"], backbone)
    del backbone
    print(f"#   checkpoint: {size / 1e9:.3f} GB written in {write_s:.2f} s")

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
    k1 = counts["fused_attention"]
    print(f"#   CLI from files: {result.rows} rows in {result.batches} "
          f"batches, loss {result.loss:.6f}, f1 {result.f1:.4f}: eval loop "
          f"{result.seconds:.3f} s wall, {result.rows / result.seconds:.2f} "
          f"pairs/s with the decode (phase 6, no files: "
          f"{ctx['eval_pairs_s']:.2f}); CLI {cli_s:.2f} s in all; K1 "
          f"launches {k1}; on {card}")
    check(result.rows == FILE_TEST_ROWS, f"evaluated {result.rows} rows")
    check(math.isfinite(result.loss), f"loss {result.loss}")
    if LAYERS_PER_BATCH:
        check(k1 == LAYERS_PER_BATCH * result.batches,
              f"K1 launched {k1} times for {result.batches} batches")

    # the first batch at fp32: K1 against the plain core
    strict_fp32()
    state = Checkpointer(str(out)).restore_best()
    spec = feats["test"].spec
    trainer = ICKATrainer(cfg, TrainConfig(compute_dtype="float32"), spec,
                          resnet_layers=layers, device=dev)
    trainer.state_from_checkpoint(state)
    plain = ICKAModel(ctx["cfgs"][False], device=dev).eval()
    plain.load_state_dict(trainer.model.state_dict(), assign=True)
    with torch.inference_mode():
        inputs = trainer.model_inputs(first)
        em_k, em_p = (m.batch_emissions(inputs, spec.mask_positions,
                                        spec.offset)
                      for m in (trainer.model, plain))
        mask = inputs["output_mask"]
        tags_k, tags_p = (trainer.model.crf.decode(e, mask)
                          for e in (em_k, em_p))
    sync(dev)
    valid = mask.bool()
    err = (em_k - em_p).abs().max().item()
    agree = (tags_k == tags_p)[valid].float().mean().item()
    print(f"#   first batch at fp32 (the special rows): visual_mean max |x| "
          f"{inputs['visual_mean'].abs().max().item():.3e}; emissions K1 vs "
          f"plain core max_abs_err {err:.3e}; tags {agree:.6f} (floor "
          f"{FILE_TAGS_MIN})")
    check(bool(torch.isfinite(em_k).all()), "non-finite emissions")
    check(agree >= FILE_TAGS_MIN, f"files: K1 tags agree {agree}")
    del trainer, plain, inputs, em_k, em_p
    torch.cuda.empty_cache()

    # fit from the train split's files
    tcfg = TrainConfig(learning_rate=TRAIN_LR, train_batch_size=TRAIN_BATCH,
                       eval_batch_size=TRAIN_BATCH, seed=args.seed,
                       compute_dtype="bfloat16")
    tr = ICKATrainer(cfg, tcfg, spec, resnet_layers=layers, device=dev)
    tr.state_from_checkpoint(state)
    del state
    loader = MNERLoader(feats["train"], images, TRAIN_BATCH, train=True,
                        decode_size=TRAIN_DECODE if not tiny else decode,
                        seed=args.seed)
    zero_counts()
    t0 = time.perf_counter()
    history = tr.fit(loader, epochs=1, log=lambda *a: None)
    sync(dev)
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    losses = [r.loss for r in tr.records]
    print(f"#   fit from files: {len(losses)} steps of {TRAIN_BATCH} rows, "
          f"losses {[round(x, 6) for x in losses]} (epoch mean "
          f"{history[0]:.6f}) in {fit_s:.1f} s; K1 launches "
          f"{fit_counts['fused_attention']} (dropout on: the plain core)")
    check(len(losses) == FILE_TRAIN_ROWS // TRAIN_BATCH
          and all(math.isfinite(x) for x in losses), f"fit losses {losses}")
    check(fit_counts["fused_attention"] == 0, "K1 launched in train steps")
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    return add_counts(counts, fit_counts)


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
    """The training entry point, `ICKATrainer.fit`, at full width and
    TRAIN_LAYERS layers a RoBERTa stack: bf16 over fp32 master weights,
    `use_pallas` for the dev evaluation (training runs dropout, so
    attention takes the plain core), the frozen backbone,
    TRAIN_EPOCHS epochs with accumulation, a dev evaluation and a best-F1
    save each epoch, the resumed snapshot (`fit_and_resume`); bf16 against
    fp32 dev tags on the trained weights; two fp32 steps on the card
    against the CPU at depth TRAIN_CHECK_LAYERS. Returns every kernel's
    launch count over `fit`."""
    cfg = dataclasses.replace(base, **{k: dataclasses.replace(
        getattr(base, k), use_pallas=True, num_hidden_layers=TRAIN_LAYERS)
        for k in ("embedding", "last_encoder")})
    print(f"# phase 8: train: ICKATrainer.fit at full width, {TRAIN_LAYERS} "
          f"layers a RoBERTa stack (bf16 over fp32 "
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
        loader, train_batches, root / "out", card, dev,
        2 * TRAIN_LAYERS if LAYERS_PER_BATCH else 0)
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

    # the shallow check runs self-attention on the plain core: with
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


def rel_l2_on(dev, pairs) -> float:
    """`rel_l2` in float64 on `dev`, one pair at a time (the full-width
    model's 968 M elements take minutes on the host); a host tensor moves
    in its own type and widens on `dev`."""
    num = torch.zeros((), dtype=torch.float64, device=dev)
    den = torch.zeros((), dtype=torch.float64, device=dev)
    for a, b in pairs:
        a = a.detach().to(dev).double()
        b = b.detach().to(dev).double()
        num += (a - b).square().sum()
        den += b.square().sum()
    return math.sqrt(float(num) / max(float(den), 1e-300))


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    """Peak allocated bytes since `reset_peak` (0 in a CPU rehearsal)."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def remat_enc(enc, policy):
    """`enc` rematerialised under `policy`, or plain for None."""
    return dataclasses.replace(enc, remat=policy is not None,
                               remat_policy=policy or "dots")


def remat_policy_runs(what, make_trainer, policies, batches, steps, card,
                      dev):
    """For each policy in `policies` (None first: no remat) a fresh trainer
    from `make_trainer(policy)` on the first one's initial weights and
    calibrated backbone: the gradients of the first batch's micro-batch
    under the first step's generators (as `train_step` draws them), then
    `steps` train steps on `batches` with the same keys, then one profiled
    step. Each policy's loss, gradients and updates are held against no
    remat's; returns {policy: (peak bytes, step seconds, busy seconds,
    launches)}, the peak over the gradients and the steps."""
    pairs = batches[0]["input_ids"].shape[1]
    init = backbone = want = None
    out = {}
    for policy in policies:
        t0 = time.perf_counter()
        trainer = make_trainer(policy)
        if init is None:
            images = batches[0]["images"]
            calibrate_batch_stats(trainer.backbone, preprocess_images(
                images.reshape(-1, *images.shape[2:]), 224, dev))
            init = {k: v.to("cpu", copy=True)
                    for k, v in trainer.model.state_dict().items()}
            backbone = trainer.backbone.state_dict()
        else:
            trainer.model.load_state_dict(init, strict=True)
            trainer.backbone.load_state_dict(backbone, strict=True)
        trainer.init_state(4 * steps)
        params = trainer.params()
        sync(dev)
        secs = {"build": time.perf_counter() - t0}
        t0 = time.perf_counter()
        reset_peak(dev)
        seed = _seed(trainer.train_cfg.seed, 0, 0, 0)
        loss = trainer.loss({k: v[0] for k, v in batches[0].items()},
                            torch.Generator().manual_seed(seed),
                            torch.Generator(dev).manual_seed(seed))
        loss.backward()
        sync(dev)
        peak = peak_bytes(dev)
        loss = loss.item()
        secs["gradients"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        grads = {n: p.grad for n, p in params.items() if p.grad is not None}
        if want is None:
            want = {"loss": loss, "grads": {n: g.to("cpu", copy=True)
                                            for n, g in grads.items()}}
            grad_msg = f"loss {loss:.6f}"
        else:
            rel = abs(loss - want["loss"]) / abs(want["loss"])
            check(grads.keys() == want["grads"].keys(),
                  f"{what} {policy}: other leaves have gradients")
            g_rel = rel_l2_on(dev, ((g, want["grads"][n])
                                    for n, g in grads.items()))
            grad_msg = (f"loss {loss:.6f} (relative {rel:.2e} to no remat, "
                        f"bit-equal {loss == want['loss']}), gradients "
                        f"relative L2 {g_rel:.2e} over {len(grads)} leaves")
            check(rel <= REMAT_LOSS_RTOL and g_rel <= REMAT_RTOL,
                  f"{what} {policy}: {grad_msg}")
        del grads
        for p in params.values():
            p.grad = None
        secs["compare"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reset_peak(dev)
        records = [trainer.train_step(b, (0, i))
                   for i, b in enumerate(batches[:steps])]
        peak = max(peak, peak_bytes(dev))
        secs["steps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(all(r.applied and math.isfinite(r.loss) for r in records),
              f"{what} {policy}: a step was not finite: {records}")
        upd_msg = f"{len(records)} steps, losses " + ", ".join(
            f"{r.loss:.4f}" for r in records)
        updates = {n: p.detach() - init[n].to(dev) for n, p in params.items()}
        if "updates" not in want:
            want["updates"] = {n: u.cpu() for n, u in updates.items()}
        else:
            u_rel = rel_l2_on(dev, ((u, want["updates"][n])
                                    for n, u in updates.items()))
            upd_msg += f", updates relative L2 {u_rel:.2e}"
            check(u_rel <= REMAT_RTOL, f"{what} {policy}: {upd_msg}")
        del updates
        secs["compare"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        step_s = float(np.median([r.seconds for r in records]))
        try:
            busy, n = device_busy(
                lambda: trainer.train_step(batches[0], (1, 0)))
        except Exception as e:   # the profiler is a report, not a check
            print(f"#   {what} {policy}: step profile not measured ({e!r})")
            busy, n = float("nan"), 0
        secs["profile"] = time.perf_counter() - t0
        out[policy] = (peak, step_s, busy, n)
        print(f"#   {what} remat={policy or 'none'}: {grad_msg}; {upd_msg}; "
              f"peak allocated {peak / 1e9:.3f} GB; step median "
              f"{step_s * 1e3:.1f} ms ({pairs / step_s:.2f} train pairs/s); "
              f"one profiled step: device busy {busy * 1e3:.1f} ms "
              f"({busy / step_s:.3f} of the median step) in {n} device "
              f"kernel launches; seconds " + ", ".join(
                  f"{k} {v:.1f}" for k, v in secs.items()) + f"; on {card}")
        del trainer, params
        torch.cuda.empty_cache()
    base_peak = out[None][0]
    if dev.type != "cuda":          # a CPU rehearsal measures no peak
        return out
    for policy, (peak, *_) in out.items():
        check(peak <= base_peak, f"{what} {policy}: peak {peak} above no "
                                 f"remat's {base_peak}")
    if "full" in out:
        check(out["full"][0] < base_peak,
              f"{what} full: peak {out['full'][0]} not below no remat's "
              f"{base_peak}")
    return out


def phase_crf(args, card, dev, num_labels, lengths):
    """The CRF at the flagship's serving shape: MAX_BATCH rows of
    CRF_LENGTH positions, `num_labels` tags, emissions random from the
    seed, masks of `lengths` (phase 3's requests). `CRF.decode(parallel=
    True)` against the sequential decode (tags identical), each one's wall,
    device time and launches; `CRF.marginals` on the card against the CPU
    within CRF_MARGINALS_TOL, every row summing to 1 within it. Returns
    {decode: (ms a call, device busy ms, launches)}."""
    B, L, T = MAX_BATCH, CRF_LENGTH, num_labels
    gen = torch.Generator().manual_seed(args.seed)
    em = torch.randn(B, L, T, generator=gen)
    lens = torch.tensor([min(int(n), L) for n in lengths[:B]])
    mask = (torch.arange(L)[None] < lens[:, None]).int()
    crf = CRF(T, device="cpu", generator=gen)
    on_card = copy.deepcopy(crf).to(dev)
    em_d, mask_d = em.to(dev), mask.to(dev)
    print(f"# phase 11: CRF at B={B}, L={L}, {T} tags, lengths "
          f"{lens.tolist()}: the sequential Viterbi against the log-depth "
          f"one (crf_decode_parallel), marginals card vs CPU")
    times = {}
    with torch.inference_mode():
        tags = {}
        for name, parallel in (("sequential", False), ("parallel", True)):
            fn = lambda: on_card.decode(em_d, mask_d, parallel=parallel)
            tags[name] = fn()
            ms = cuda_time_ms(fn, iters=10)
            try:
                busy, _, n = device_profile(fn)
            except Exception as e:   # a report, not a check
                print(f"#   {name} decode profile not measured ({e!r})")
                busy, n = float("nan"), 0
            times[name] = (ms, busy * 1e3, n)
            print(f"#   {name} decode: {ms:.3f} ms a call (CUDA events), "
                  f"device busy {busy * 1e3:.3f} ms in {n} kernel launches "
                  f"(profiled call); on {card}")
        check(torch.equal(tags["parallel"], tags["sequential"]),
              "parallel Viterbi tags differ from the sequential decode's")
        check(torch.equal(tags["parallel"].cpu(), crf.decode(em, mask)),
              "the card's Viterbi tags differ from the CPU's")
        marg = on_card.marginals(em_d, mask_d).cpu()
        err = (marg - crf.marginals(em, mask)).abs().max().item()
        sums = (marg.sum(-1) - 1).abs().max().item()
    print(f"#   tags identical ({B * L} positions, card and CPU); marginals "
          f"card vs CPU max |diff| {err:.2e}, rows sum to 1 within "
          f"{sums:.2e} (tol {CRF_MARGINALS_TOL:.0e})")
    check(err <= CRF_MARGINALS_TOL and sums <= CRF_MARGINALS_TOL,
          f"CRF marginals: card vs CPU {err}, row sums {sums}")
    return times


class _Outcomes:
    """A pytest plugin that counts the tests passed and the reports that
    failed or skipped."""

    def __init__(self):
        self.passed, self.not_passed = 0, []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed or report.skipped:
            self.not_passed.append(f"{report.nodeid} {report.outcome}")


def run_card_tests():
    """The card tests of this phase's modules (CARD_TESTS), in this
    process (no conftest: it configures JAX, which these tests do not
    use)."""
    import pytest

    t0 = time.perf_counter()
    outcomes = _Outcomes()
    path = Path(__file__).resolve().parent / "tests" / "test_torch_on_card.py"
    rc = pytest.main([str(path), "-q", "-p", "no:cacheprovider",
                      "--noconftest", "-k", CARD_TESTS], plugins=[outcomes])
    print(f"#   card tests -k '{CARD_TESTS}': {outcomes.passed} passed, "
          f"{outcomes.not_passed or 'none failed or skipped'} (rc {int(rc)}, "
          f"{time.perf_counter() - t0:.1f} s)")
    check(rc == 0 and outcomes.passed == CARD_TEST_COUNT
          and not outcomes.not_passed, "card tests did not all pass")


def phase_remat(args, card, dev, base, gc_base, layers, lengths):
    """Rematerialised training in bench.py's train configuration (see
    REMAT_POLICIES): the flagship under every policy against no remat,
    then `ICKATrainer.fit` for one epoch under "dots" with its dev
    evaluation (K1 48 times a dev batch, 0 in the steps), then one
    `GateCLTrainer` step of `GateCLConfig()` under "full" against none;
    the CRF's two decodes and its marginals (`phase_crf`); the card tests
    of the modules this phase drives. Returns every kernel's launch count
    over the training runs."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(
        base, embedding=dataclasses.replace(base.embedding, use_pallas=True),
        last_encoder=dataclasses.replace(base.last_encoder, use_pallas=True))
    print(f"# phase 11: rematerialised training in bench.py's train "
          f"configuration (ICKAConfig() at full width, remat on both "
          f"stacks, batch {REMAT_BATCH} in one micro-batch, bf16 over fp32 "
          f"master weights, mu fp32, dropout on, ResNet-152 frozen): "
          f"policies {[p or 'none' for p in REMAT_POLICIES]}")
    root = WORK_DIR / "remat"
    shutil.rmtree(root, ignore_errors=True)
    generate_dataset(str(root / "ds"), n_train=REMAT_STEPS * REMAT_BATCH,
                     n_valid=REMAT_DEV_ROWS, n_test=0, clip_dim=cfg.clip_dim,
                     seed=args.seed, write_images=False)
    tokenizer = tiny_tokenizer(str(root / "ds" / "tokenizer"))
    feats = {split: convert_examples(
        read_mm_conll(str(root / "ds" / f"{split}.txt")), tokenizer,
        cfg.max_seq_length, ClipFeatureStore.from_split(str(root / "ds"),
                                                        split),
        cfg.clip_dim) for split in ("train", "valid")}
    spec = feats["train"].spec
    tcfg = TrainConfig(learning_rate=TRAIN_LR, train_batch_size=REMAT_BATCH,
                       eval_batch_size=MAX_BATCH,
                       gradient_accumulation_steps=1, seed=args.seed,
                       compute_dtype="bfloat16", mu_dtype="float32")
    loader, train_batches = train_loaders(
        feats, str(root / "ds" / "images"), REMAT_BATCH, 1, MAX_BATCH,
        args.seed)
    batches = train_batches(0, REMAT_STEPS)

    def icka(policy, c=cfg):
        rc = dataclasses.replace(
            c, embedding=remat_enc(c.embedding, policy),
            last_encoder=remat_enc(c.last_encoder, policy))
        return ICKATrainer(rc, tcfg, spec, resnet_layers=layers, device=dev)

    zero_counts()
    runs = remat_policy_runs("flagship", icka, REMAT_POLICIES, batches,
                             REMAT_STEPS, card, dev)
    check(fused_attention.launches == 0,
          f"K1 launched {fused_attention.launches} times in train steps")

    # fit under "dots": one epoch, its dev evaluation on K1
    trainer = icka("dots")
    images = batches[0]["images"]
    calibrate_batch_stats(trainer.backbone, preprocess_images(
        images.reshape(-1, *images.shape[2:]), 224, dev))
    lines = []
    dev_loader = loader("valid")
    t0 = time.perf_counter()
    history = trainer.fit(loader("train"), dev_loader, epochs=1,
                          log=lines.append)
    sync(dev)
    k1 = fused_attention.launches
    print(f"#   fit under remat=dots, 1 epoch of {len(trainer.records)} "
          f"steps: {'; '.join(lines)} ({time.perf_counter() - t0:.1f} s); "
          f"K1 launches {k1}")
    check(len(history) == 1 and math.isfinite(history[0]),
          f"fit under remat: {history}")
    check(k1 == LAYERS_PER_BATCH * len(dev_loader),
          f"K1 launched {k1} times in fit, want {LAYERS_PER_BATCH} a dev "
          f"batch ({len(dev_loader)} batches) and 0 in the steps")
    del trainer
    torch.cuda.empty_cache()

    gc_cfg = gate_cl_cfg(gc_base)

    def gate_cl(policy):
        rc = dataclasses.replace(gc_cfg,
                                 encoder=remat_enc(gc_cfg.encoder, policy))
        return GateCLTrainer(rc, tcfg, resnet_layers=layers, device=dev)
    gc_runs = remat_policy_runs("gate_cl", gate_cl, (None, "full"),
                                batches, 1, card, dev)
    counts = read_counts()
    shutil.rmtree(root)

    crf_times = phase_crf(args, card, dev, cfg.num_labels, lengths)
    run_card_tests()
    none = runs[None]
    print(f"#   flagship peak allocated by policy: " + ", ".join(
        f"{p or 'none'} {v[0] / 1e9:.3f} GB ({v[0] / max(none[0], 1):.3f})"
        for p, v in runs.items()) + "; step median: " + ", ".join(
        f"{p or 'none'} {v[1] * 1e3:.1f} ms" for p, v in runs.items())
        + f"; gate_cl full {gc_runs['full'][0] / 1e9:.3f} GB against "
        f"{gc_runs[None][0] / 1e9:.3f} GB")
    print(f"#   phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return counts, runs, crf_times


# phase 12, two ranks on one card (gloo: NCCL refuses two ranks on one
# GPU): a global batch of DP_ACCUM x DP_BATCH rows, DP_STEPS steps at
# data axis DP_RANKS, replicated and under ZeRO-1, against the same steps
# on one rank (fp32, TF32 off, dropout on, random images for the crop and
# flip). The two-rank losses differ from one rank's by the order of the
# sums only (DP_LOSS_RTOL, the CPU tests' bound), the gradients' global
# norm likewise (STEP_NORM_RTOL); ZeRO-1 against replicated and the NCCL
# world of one against the trainer without a process group are the same
# arithmetic, held bit for bit (exact checksums of the bits, `fingerprint`).
DP_RANKS, DP_BATCH, DP_ACCUM, DP_STEPS = 2, 8, 2, 2
# the depth of each RoBERTa stack in phases 12 and 13's training (24 in
# `ICKAConfig()`; cut to keep the script inside its time limit: gloo's
# all-reduces through the host, the ZeRO-1 snapshot and the state gather
# set these phases, and all scale with depth); serving and evaluation stay
# at full depth. Their steps are not cut: under the warmup schedule the
# first step's learning rate is 0, so one step a run would leave the
# parameters that ZeRO-1 is held bit-equal on unmoved
DP_TRAIN_LAYERS = 4
DP_LOSS_RTOL = 2e-5
DP_JOIN_S = 900


def fingerprint(tensors) -> tuple:
    """Two exact integer checksums of the tensors' bits, in order (a plain
    and a position-weighted sum of the 32- or 16-bit words, wrapping in
    int64): tensors with equal bits give equal checksums."""
    plain = weighted = None
    for t in tensors:
        t = t.detach().contiguous()
        bits = t.view(torch.int32 if t.element_size() == 4
                      else torch.int16).reshape(-1).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        s, sw = bits.sum(), (bits * w).sum()
        plain = s if plain is None else plain + s
        weighted = sw if weighted is None else weighted + sw
    return int(plain), int(weighted)


def moment_fingerprints(trainer, cuts) -> tuple:
    """Checksums of the moments as this rank's ZeRO-1 slices (`cuts`, from
    `moment_slices`): a replicated trainer's full moments are cut first."""
    mu, nu = trainer.opt_state.mu, trainer.opt_state.nu
    zero1 = trainer.zero1 is not None

    def local(name, t):
        return t if zero1 or name not in cuts else t.narrow(*cuts[name])
    return (fingerprint(local(n, t) for n, t in mu.items()),
            fingerprint(local(n, t) for n, t in nu.items()))


def dp_requests(ctx) -> dict:
    """Phase 3's fp32 requests (features on the host), the tags the
    single-device kernel path gave them, their images and phase 3's
    backbone (its state on the host)."""
    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x
    return {"examples": [{k: host(v) for k, v in ex.items()}
                         for ex in ctx["examples"]],
            "tags": ctx["tags"], "cfg": ctx["cfgs"][True],
            "spec": ctx["spec"], "images": ctx["images"],
            "backbone": {k: v.cpu() for k, v in
                         ctx["backbone"].state_dict().items()}}


def dp_steps(trainer, batches, dev):
    """DP_STEPS train steps; each step's record, the parameters'
    checksums after it and the peak allocated bytes over the steps."""
    reset_peak(dev)
    trainer.init_state(2 * DP_STEPS)
    records, prints = [], []
    for i, batch in enumerate(batches):
        records.append(trainer.train_step(batch, (0, i)))
        prints.append(fingerprint(trainer.params().values()))
    return records, prints, peak_bytes(dev)


def dp_rank(rank: int, work: str, seed: int, device: str):
    """One rank of phases 12 and 13 (a spawned process): DP serving of
    phase 3's requests, DP_STEPS replicated steps, DP_STEPS under ZeRO-1
    and their snapshot (rank 0 writes it), then phase 13's tensor-parallel
    steps and evaluation (`tp_rank`); what it saw goes to
    work/rank{rank}.pt. Any exception ends the process with a non-zero
    code."""
    work = Path(work)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // DP_RANKS))
    dev = init_distributed(device, init_method=f"file://{work / 'store'}",
                           rank=rank, world=DP_RANKS)
    strict_fp32()
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    served = inputs["served"]
    seen = {"backend": dist.get_backend(), "device": str(dev)}
    mesh = make_mesh(MeshSpec(data=DP_RANKS), device=dev)
    model = ICKAModel(served["cfg"], device=dev, seed=seed).eval()
    spec = served["spec"]
    server = BucketedICKAServer(model, max_batch=MAX_BATCH,
                                offset=spec.offset,
                                mask_positions=spec.mask_positions,
                                mesh=mesh)
    zero_counts()
    t0 = time.perf_counter()
    tags, stats = server.predict(served["examples"])
    sync(dev)
    seen["serve"] = dict(tags=tags, pairs=stats.total_pairs,
                         batches=sum(stats.batches_per_bucket.values()),
                         counts=read_counts(),
                         seconds=time.perf_counter() - t0)
    del model, server
    torch.cuda.empty_cache()
    backbone = torch.load(work / "backbone.pt", weights_only=True)
    for zero1 in (False, True):
        tcfg = dataclasses.replace(inputs["tcfg"], data_axis=DP_RANKS,
                                   zero1=zero1)
        tr = ICKATrainer(inputs["cfg"], tcfg, inputs["spec"],
                         resnet_layers=inputs["layers"], device=dev)
        tr.backbone.load_state_dict(backbone)
        records, prints, peak = dp_steps(tr, inputs["batches"], dev)
        cuts = moment_slices({n: tuple(p.shape)
                              for n, p in tr.params().items()}, tr.mesh)
        run = dict(records=records, params=prints, peak=peak,
                   moments=moment_fingerprints(tr, cuts))
        if zero1:
            t0 = time.perf_counter()
            tr.save_state(Checkpointer(str(work / "zero1")))
            run["save_seconds"] = time.perf_counter() - t0
        seen["zero1" if zero1 else "replicated"] = run
        del tr
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    seen["tp"] = tp_rank(work, inputs, dev)
    seen["tp"]["seconds"] = time.perf_counter() - t0
    torch.save(seen, work / f"rank{rank}.pt")
    dist.destroy_process_group()


# phase 13, the model axis: the same two ranks at mesh (1, 2) train
# phase 12's DP_STEPS steps on its weights, seed and global batch
# (`ICKAConfig()` at full width, DP_TRAIN_LAYERS deep, fp32, TF32 off,
# dropout, crop and flip on) against phase 12's one rank: losses within
# DP_LOSS_RTOL, gradient norms within STEP_NORM_RTOL (the order of sums
# differs: the row-parallel products are summed over the ranks); each
# rank's replicated leaves bit-equal to the other's; the state gathered to
# the JAX layout. Then phase 3's requests on phase 3's fp32 weights and
# backbone through the trainer's evaluation step, K1 on TP_HEADS heads a
# rank: emissions within EMISSIONS_TOL of one rank's on the same batch,
# tags against phase 3's at >= 0.99 (PERF.md section 2). Then the fused
# layout (`fuse_qkv=True`, the same weights through `fuse_qkv_params`):
# the evaluation with K1 on the rank's heads read out of the gathered
# (B, S, 3H) projection, tags against the unfused TP tags at >=
# FUSED_TP_TAGS_MIN, and one train step, its loss within DP_LOSS_RTOL of
# the unfused first step's.
TP_HEADS = 16 // DP_RANKS
FUSED_TP_TAGS_MIN = 0.999
SERVER_BUCKETS = (16, 24, 32, 48, 64, 128)     # BucketedICKAServer's


def tp_eval_batches(served, cfg, spec) -> list:
    """Phase 3's requests as the trainer's evaluation batches, laid out as
    phase 3's `BucketedICKAServer` laid them out (the flagship's BiLSTM
    reads the padding tail, so the padded width moves the tags): each
    request in the smallest of the server's buckets that holds it, batches
    of MAX_BATCH rows padded by repeating the chunk's first, the prompt
    head then the sentence; the images whole (eval preprocessing crops
    them), labels 0. Returns (batches, the request index of each row)."""
    examples = served["examples"]
    off, pad = spec.offset, cfg.embedding.pad_token_id
    buckets = SERVER_BUCKETS
    order = {b: [] for b in buckets}
    for i, ex in enumerate(examples):
        order[pick_bucket(min(len(ex["ori_input_ids"]), buckets[-1]),
                          buckets)].append(i)
    out, index = [], []
    for L, idxs in order.items():
        for lo in range(0, len(idxs), MAX_BATCH):
            rows = idxs[lo:lo + MAX_BATCH]
            index.append(rows)
            rows = rows + [rows[0]] * (MAX_BATCH - len(rows))
            B = len(rows)
            b = {"input_ids": np.full((B, off + L), pad, np.int64),
                 "segment_ids": np.concatenate(
                     [np.zeros((B, off), np.int64),
                      np.ones((B, L), np.int64)], 1),
                 "input_mask": np.zeros((B, off + L), np.int64),
                 "ori_input_ids": np.full((B, L), pad, np.int64),
                 "ori_input_mask": np.zeros((B, L), np.int64),
                 "ori_segment_ids": np.zeros((B, L), np.int64),
                 "img_mask": np.ones((B, cfg.num_regions), np.int64),
                 "clip_features": np.zeros((B, 1, cfg.clip_dim),
                                           np.float32),
                 "label_ids": np.zeros((B, L), np.int64),
                 "images": served["images"][rows]}
            for r, i in enumerate(rows):
                ex = examples[i]
                n = min(len(ex["ori_input_ids"]), L)
                b["ori_input_ids"][r, :n] = np.asarray(
                    ex["ori_input_ids"][:n])
                b["ori_input_mask"][r, :n] = 1
                pl = min(len(ex["input_ids"]), off + n)
                b["input_ids"][r, :pl] = np.asarray(ex["input_ids"][:pl])
                b["input_mask"][r, :pl] = 1
                b["clip_features"][r, 0] = np.asarray(ex["clip_features"])
            b["output_mask"] = b["ori_input_mask"].copy()
            out.append(b)
    return out, index


def tp_eval(trainer, batches, index):
    """The trainer's evaluation step on each batch (`eval_step`: images ->
    backbone -> the model in "dev" mode): each request's tags cut to its
    length (`index`: `tp_eval_batches`'s request of each row), the kernel
    launches of those steps (K1's on strided q/k/v views under
    "strided"), and then the first batch's emissions."""
    tags = [None] * sum(len(rows) for rows in index)
    zero_counts()
    for b, rows in zip(batches, index):
        pred, _ = trainer.eval_step(b)
        for r, i in enumerate(rows):
            tags[i] = pred[r, :int(b["ori_input_mask"][r].sum())].cpu(
                ).numpy()
    counts = read_counts()
    counts["strided"] = fused_attention.strided_launches
    with torch.inference_mode():
        inputs = trainer.model_inputs(batches[0])
        inputs.pop("label_ids")
        em = trainer.model.batch_emissions(inputs,
                                           trainer.spec.mask_positions,
                                           trainer.spec.offset)
    return tags, em.float().cpu(), counts


def tp_steps(trainer, batches, dev):
    """DP_STEPS train steps; each step's record, the checksums of the
    replicated and of the split leaves after it, and the peak allocated
    bytes over the steps."""
    reset_peak(dev)
    trainer.init_state(2 * DP_STEPS)
    split = trainer.tp.split
    records, prints = [], []
    for i, batch in enumerate(batches):
        records.append(trainer.train_step(batch, (0, i)))
        params = trainer.params()
        prints.append({
            "replicated": fingerprint(p for n, p in params.items()
                                      if n not in split),
            "split": fingerprint(p for n, p in params.items() if n in split)})
    return records, prints, peak_bytes(dev)


def tp_rank(work: Path, inputs: dict, dev) -> dict:
    """Phase 13 in one of phase 12's ranks: the mesh (1, DP_RANKS), its
    DP_STEPS steps (the layers' collectives timed), the state gathered to
    the JAX layout, and phase 3's requests through a fresh trainer's
    evaluation step on phase 3's backbone. Launch counts from 0 for the
    steps and for the evaluation."""
    mesh = make_mesh(MeshSpec(data=1, model=DP_RANKS), device=dev)
    tcfg = dataclasses.replace(inputs["tcfg"], data_axis=1,
                               model_axis=DP_RANKS)

    def trainer():
        return ICKATrainer(inputs["cfg"], tcfg, inputs["spec"],
                           resnet_layers=inputs["layers"], mesh=mesh)
    seen = {"coords": (mesh.rank, mesh.model_rank)}
    tr = trainer()
    tr.backbone.load_state_dict(torch.load(work / "backbone.pt",
                                           weights_only=True))
    zero_counts()
    tr.tp.clock.timed = True
    records, prints, peak = tp_steps(tr, inputs["batches"], dev)
    seen["train"] = dict(records=records, prints=prints, peak=peak,
                         counts=read_counts(),
                         local=sum(p.numel() for p in tr.params().values()))
    t0 = time.perf_counter()
    tree = tr.state_tree()
    seen["gather_seconds"] = time.perf_counter() - t0
    flat = flat_leaves(tree)
    seen["layout"] = {k: (v.shape, str(v.dtype)) for k, v in flat.items()}
    adam = tree["opt_state"]["1"]["0"]
    held = {"params": tr.params(), "mu": tr.opt_state.mu,
            "nu": tr.opt_state.nu}
    whole = {"params": tree["params"], "mu": adam["mu"], "nu": adam["nu"]}
    seen["slices_equal"] = all(
        torch.equal(tr.tp.local(n, sd[n]), held[key][n].cpu())
        for key in held
        for sd in [state_dict_from_flax(whole[key])] for n in held[key])
    del tr, tree, flat, whole, held, adam
    torch.cuda.empty_cache()
    seen["fused_step"] = fused_tp_step(inputs, tcfg, mesh, dev, work)
    for fused in (False, True):
        ev = (fused_tp_trainer(inputs["eval_cfg"], tcfg, inputs, mesh, dev)
              if fused else ICKATrainer(inputs["eval_cfg"], tcfg,
                                        inputs["spec"],
                                        resnet_layers=inputs["layers"],
                                        mesh=mesh))
        ev.backbone.load_state_dict(inputs["backbone3"])
        t0 = time.perf_counter()
        tags, em, counts = tp_eval(ev, *inputs["eval_batches"])
        sync(dev)
        seen["fused_eval" if fused else "eval"] = dict(
            tags=tags, emissions=em, counts=counts,
            seconds=time.perf_counter() - t0)
        del ev
        torch.cuda.empty_cache()
    return seen


def fused_tp_trainer(cfg, tcfg, inputs, mesh, dev):
    """A trainer of `cfg` with `fuse_qkv=True` on `mesh`, its weights the
    unfused model's of the seed (as every rank builds it) through
    `fuse_qkv_params`, cut to this rank's slices."""
    fcfg = dataclasses.replace(
        cfg, embedding=dataclasses.replace(cfg.embedding, fuse_qkv=True),
        last_encoder=dataclasses.replace(cfg.last_encoder, fuse_qkv=True))
    tr = ICKATrainer(fcfg, tcfg, inputs["spec"],
                     resnet_layers=inputs["layers"], mesh=mesh)
    whole = ICKAModel(cfg, device=dev, seed=tcfg.seed).state_dict()
    tr.model.load_state_dict(shard_params(fuse_qkv_params(
        tr.model.state_dict().keys(), whole), mesh))
    return tr


def fused_tp_step(inputs, tcfg, mesh, dev, work):
    """One train step of the fused layout on phase 12's first batch and
    backbone: its record."""
    tr = fused_tp_trainer(inputs["cfg"], tcfg, inputs, mesh, dev)
    tr.backbone.load_state_dict(torch.load(work / "backbone.pt",
                                           weights_only=True))
    tr.init_state(2 * DP_STEPS)
    tr.tp.clock.timed = True
    zero_counts()
    record = tr.train_step(inputs["batches"][0], (0, 0))
    counts = read_counts()
    del tr
    torch.cuda.empty_cache()
    return dict(record=record, counts=counts)


def phase_tp(seen, ref, served, card) -> dict:
    """Phase 13's checks and lines on what the ranks saw against phase
    12's one rank (`ref`: its records, peak, evaluation and state
    layout). Returns every kernel's launch count over both ranks' steps
    and evaluation."""
    print(f"# phase 13: the model axis, mesh (1, {DP_RANKS}) on phase 12's "
          f"ranks: ICKAConfig() at phase 12's depth trained in fp32 (TF32 "
          f"off) on phase 12's "
          f"global batch, seed and weights with dropout, crop and flip, "
          f"{DP_STEPS} steps against one rank; phase 3's requests through "
          f"the trainer's evaluation step, K1 on {TP_HEADS} heads a rank; "
          f"the same with a fused qkv, and one fused train step")
    counts = {name: 0 for name in COUNTERS}
    for r, s in enumerate(seen):
        t = s["tp"]
        check(t["coords"] == (0, r), f"rank {r} sits at {t['coords']}")
        train, ev = t["train"], t["eval"]
        add_counts(counts, train["counts"])
        add_counts(counts, {n: ev["counts"][n]
                            for n in (*COUNTERS, *BODY_COUNTS)})
        check(train["counts"]["fused_attention"] == 0,
              f"rank {r}: K1 launched in the TP train steps (dropout on: "
              f"the plain core)")
        for i, (got, want) in enumerate(zip(train["records"],
                                            ref["records"])):
            loss_rel = abs(got.loss - want.loss) / abs(want.loss)
            norm_rel = abs(got.grad_norm - want.grad_norm) / abs(
                want.grad_norm)
            compute = (got.seconds - got.reduce_seconds
                       - got.update_seconds - got.tp_seconds)
            print(f"#   rank {r} TP step {i}: loss {got.loss:.7f} vs one "
                  f"rank {want.loss:.7f} (relative {loss_rel:.2e}, tol "
                  f"{DP_LOSS_RTOL:.0e}), grad norm relative {norm_rel:.2e}; "
                  f"step {got.seconds * 1e3:.1f} ms = compute "
                  f"{compute * 1e3:.1f} + TP collectives "
                  f"{got.tp_seconds * 1e3:.1f} ({got.tp_calls} all-reduces)"
                  f" + agreement {got.reduce_seconds * 1e3:.1f} + update "
                  f"{got.update_seconds * 1e3:.1f} ms")
            check(got.applied and loss_rel <= DP_LOSS_RTOL
                  and norm_rel <= STEP_NORM_RTOL,
                  f"rank {r} TP step {i}: loss {got.loss} vs {want.loss}, "
                  f"grad norm {got.grad_norm} vs {want.grad_norm}")
        print(f"#   rank {r}: {train['local'] / 1e6:.1f} M parameters held "
              f"of {ref['params'] / 1e6:.1f} M; peak allocated "
              f"{train['peak'] / 1e9:.3f} GB (one rank {ref['peak'] / 1e9:.3f}"
              f" GB); state gathered to the JAX layout in "
              f"{t['gather_seconds']:.1f} s, its slices bit-equal to the "
              f"rank's leaves: {t['slices_equal']}; on {card}")
        check(t["layout"] == ref["layout"],
              f"rank {r}: the gathered state's names, shapes or dtypes "
              f"differ from one rank's")
        check(t["slices_equal"], f"rank {r}: a slice of the gathered state "
                                 f"differs from the leaf the rank holds")
        k1 = ev["counts"]["fused_attention"]
        err = (ev["emissions"] - ref["emissions"]).abs().max().item()
        agree = agreement(ev["tags"], served["tags"])
        agree_ref = agreement(ev["tags"], ref["tags"])
        n_batches = len(ref["eval_batches"][0])
        print(f"#   rank {r} evaluation: {len(ev['tags'])} requests in "
              f"{n_batches} batches (phase 3's buckets) in "
              f"{ev['seconds']:.2f} s, K1 launches {k1} (on "
              f"{TP_HEADS} heads); first-batch emissions vs one rank's "
              f"max_abs_err {err:.3e} (tol {EMISSIONS_TOL:.0e}); tags vs "
              f"phase 3's fp32 tags {agree:.6f}, vs one rank's evaluation "
              f"{agree_ref:.6f}")
        check(err <= EMISSIONS_TOL, f"rank {r}: TP emissions differ by {err}")
        check(agree >= 0.99, f"rank {r}: TP tags agree {agree} < 0.99")
        if CHECK_CONV_LAUNCHES:
            check(k1 == LAYERS_PER_BATCH * n_batches,
                  f"rank {r}: K1 launched {k1} times for {n_batches} "
                  f"evaluation batches")
        fused, step = t["fused_eval"], t["fused_step"]
        add_counts(counts, {n: fused["counts"][n]
                            for n in (*COUNTERS, *BODY_COUNTS)})
        add_counts(counts, step["counts"])
        fk1, strided = fused["counts"]["fused_attention"], \
            fused["counts"]["strided"]
        ferr = (fused["emissions"] - ev["emissions"]).abs().max().item()
        fagree = agreement(fused["tags"], ev["tags"])
        got, want = step["record"], train["records"][0]
        loss_rel = abs(got.loss - want.loss) / abs(want.loss)
        norm_rel = abs(got.grad_norm - want.grad_norm) / abs(want.grad_norm)
        print(f"#   rank {r} fused qkv (fuse_qkv_params of the same "
              f"weights): evaluation in {fused['seconds']:.2f} s, K1 "
              f"launches {fk1}, {strided} of them on strided q/k/v views "
              f"of the gathered projection ({TP_HEADS} heads); first-batch "
              f"emissions vs the unfused TP's max_abs_err {ferr:.3e}; tags "
              f"vs the unfused TP's {fagree:.6f} (floor "
              f"{FUSED_TP_TAGS_MIN}); one train step: loss "
              f"{got.loss:.7f} vs unfused {want.loss:.7f} (relative "
              f"{loss_rel:.2e}, tol {DP_LOSS_RTOL:.0e}), grad norm relative "
              f"{norm_rel:.2e}, {got.seconds * 1e3:.1f} ms ({got.tp_calls} "
              f"TP all-reduces, {got.tp_seconds * 1e3:.1f} ms)")
        check(fagree >= FUSED_TP_TAGS_MIN,
              f"rank {r}: fused TP tags agree {fagree}")
        check(got.applied and loss_rel <= DP_LOSS_RTOL,
              f"rank {r}: fused TP step loss {got.loss} vs {want.loss}")
        check(step["counts"]["fused_attention"] == 0,
              f"rank {r}: K1 launched in the fused TP train step")
        if CHECK_CONV_LAUNCHES:
            check(fk1 == strided == LAYERS_PER_BATCH * n_batches,
                  f"rank {r}: fused K1 launched {fk1} times ({strided} "
                  f"strided) for {n_batches} evaluation batches")
    check(all(s["tp"]["train"]["prints"][i]["replicated"]
              == seen[0]["tp"]["train"]["prints"][i]["replicated"]
              for s in seen for i in range(DP_STEPS)),
          "the ranks' replicated leaves differ")
    print(f"#   replicated leaves bit-equal on both ranks after each step: "
          f"True; phase 13 in the ranks "
          f"{max(s['tp']['seconds'] for s in seen):.1f} s")
    return counts


def phase_k1_local_heads(gen, row):
    """K1 against its plain version at a tensor-parallel rank's shape:
    TP_HEADS heads of 64, B=8, S=150 with a key bias and S=172 with a full
    bias, and the evaluation's lengths (128 bare, 172 prompted) with key
    biases, in fp32 and bf16, to phase 2's tolerances. Then timed in fp32
    at S=150 on contiguous q/k/v and on the fused layout's views (the
    rank's columns of a gathered (B, S, 3 x 1024) projection; bit-equal to
    the contiguous call) beside its plain version, SDPA and its bound, with
    the profiler's device time a launch. Adds `tp_*` keys to K1's row."""
    print(f"# phase 13: K1 fused_attention vs attention_reference at a TP "
          f"rank's {TP_HEADS} heads of 64 (B=8)")
    for dtype in (torch.float32, torch.bfloat16):
        for S, kind in ((150, "B11Sk"), (172, "BSqSk"), (128, "B11Sk"),
                        (172, "B11Sk")):
            q, k, v, bias = attention_inputs(8, S, S, dtype, kind, gen,
                                             N=TP_HEADS)
            out = fused_attention(q, k, v, bias, TP_HEADS)
            torch.cuda.synchronize()
            check(out.shape == q.shape and out.dtype == dtype,
                  f"K1 {TP_HEADS} heads: {out.dtype} {tuple(out.shape)}")
            err, share = attention_close(
                out, attention_reference(q, k, v, bias, TP_HEADS),
                f"K1 {TP_HEADS}x64 {dtype} S={S} {kind}")
            print(f"#   {str(dtype)[6:]:8s} Sq=Sk={S:3d} bias={kind:6s} "
                  f"max_abs_err={err:.3e} ({share:.2f} of its bound)")
    B, S, H, n = MAX_BATCH, 150, 16 * 64, TP_HEADS * 64
    q, k, v, bias = attention_inputs(B, S, S, torch.float32, "B11Sk", gen,
                                     N=TP_HEADS)
    qkv = torch.zeros(B, S, 3 * H, device=q.device)
    views = []
    for j, t in enumerate((q, k, v)):       # rank 1's columns of each
        qkv[..., j * H + n:j * H + 2 * n] = t
        views.append(qkv[..., j * H + n:j * H + 2 * n])
    out = fused_attention(q, k, v, bias, TP_HEADS)
    check(torch.equal(fused_attention(*views, bias, TP_HEADS), out),
          "K1 on the fused layout's views differs from K1 on copies")
    err, _ = attention_close(out, attention_reference(q, k, v, bias,
                                                      TP_HEADS),
                             f"K1 {TP_HEADS}x64 at the timed shape")
    times = {}
    for name, args in (("contiguous", (q, k, v)), ("strided", views)):
        times[name] = (cuda_time_ms(lambda: fused_attention(
            *args, bias, TP_HEADS)), kernel_device_ms(
                lambda: fused_attention(*args, bias, TP_HEADS)))
    plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v, bias,
                                                        TP_HEADS))
    library_ms = sdpa_ms(q, k, v, bias, TP_HEADS, 50)
    bound_ms, bound_by, byts, flops = attention_bound(q, k, bias, TP_HEADS)
    shape = f"B={B} Sq=Sk={S} {TP_HEADS}x64 float32 key bias"
    row.update({"tp_shape": shape, "tp_max_abs_err": err,
                "tp_ms": times["contiguous"][0],
                "tp_device_ms": times["contiguous"][1],
                "tp_strided_ms": times["strided"][0],
                "tp_strided_device_ms": times["strided"][1],
                "tp_plain_ms": plain_ms, "tp_bound_ms": bound_ms,
                "tp_bound_by": bound_by, "tp_library_ms": library_ms})
    print(f"#   {shape}: kernel {times['contiguous'][0]:.4f} ms (device "
          f"{times['contiguous'][1]:.4f} ms a launch, "
          f"{earlier('tp', times['contiguous'][1])}), on the fused views "
          f"{times['strided'][0]:.4f} ms (device {times['strided'][1]:.4f} "
          f"ms, {earlier('tp_strided', times['strided'][1])}), plain "
          f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {byts / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP)")


def phase_dp(args, card, dev, base, layers, served):
    """Phases 12 and 13: the data axis, then the model axis, on two ranks
    that share the one card. Returns every kernel's launch count over both
    ranks' serving and training (phase 12) and over their tensor-parallel
    steps and evaluation (phase 13)."""
    print(f"# phase 12: the data axis, {DP_RANKS} ranks on one card (gloo, "
          f"spawn): phase 3's requests through BucketedICKAServer(mesh=) in "
          f"fp32; ICKAConfig() at {DP_TRAIN_LAYERS} layers a stack with "
          f"ResNet-152 trained in fp32 (TF32 off), "
          f"global batch {DP_ACCUM} x {DP_BATCH}, dropout, crop and flip on, "
          f"{DP_STEPS} steps replicated and {DP_STEPS} under ZeRO-1, against "
          f"one rank; the same steps on a NCCL world of one")
    strict_fp32()
    work = WORK_DIR / "dp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    eval_cfg = served["cfg"]
    cfg = dataclasses.replace(eval_cfg, **{k: dataclasses.replace(
        getattr(eval_cfg, k), num_hidden_layers=DP_TRAIN_LAYERS)
        for k in ("embedding", "last_encoder")})
    feats = train_corpus(args, cfg, work / "ds")
    spec = feats["train"].spec
    tcfg = TrainConfig(learning_rate=TRAIN_LR, train_batch_size=DP_BATCH,
                       gradient_accumulation_steps=DP_ACCUM, seed=args.seed,
                       compute_dtype="float32")
    loader = MNERLoader(feats["train"], str(work / "ds" / "images"),
                        DP_BATCH, DP_ACCUM, train=True,
                        decode_size=TRAIN_DECODE, seed=args.seed, prefetch=0)
    batches = [b for _, b in zip(range(DP_STEPS), loader)]
    rng = np.random.default_rng(args.seed)
    for b in batches:             # images to crop and flip (no files here)
        b["images"] = rng.integers(0, 256, b["images"].shape,
                                   dtype=np.uint8)

    def trainer(cfg=cfg, **kw):
        return ICKATrainer(cfg, dataclasses.replace(tcfg, **kw), spec,
                           resnet_layers=layers, device=dev)

    # one rank, no process group: first phase 13's evaluation on phase 3's
    # weights (the seed's, full depth) and backbone, then the reference
    # steps
    t0 = time.perf_counter()
    ref = trainer(eval_cfg)
    check((spec.offset, spec.mask_positions)
          == (served["spec"].offset, served["spec"].mask_positions),
          f"the corpus's prompt layout {spec} is not phase 3's")
    eval_batches = tp_eval_batches(served, eval_cfg, spec)
    ref.backbone.load_state_dict(served["backbone"])
    ref_tags, ref_em, _ = tp_eval(ref, *eval_batches)
    calibrate_batch_stats(ref.backbone, preprocess_images(
        batches[0]["images"].reshape(-1, *batches[0]["images"].shape[2:]),
        224, dev))
    torch.save(ref.backbone.state_dict(), work / "backbone.pt")
    backbone = ref.backbone.state_dict()
    del ref
    torch.cuda.empty_cache()
    ref = trainer()
    ref.backbone.load_state_dict(backbone)
    ref_records, ref_prints, ref_peak = dp_steps(ref, batches, dev)
    shapes = {n: tuple(p.shape) for n, p in ref.params().items()}
    ref13 = dict(records=ref_records, peak=ref_peak, tags=ref_tags,
                 emissions=ref_em, eval_batches=eval_batches,
                 params=sum(math.prod(v) for v in shapes.values()),
                 layout={k: (v.shape, str(v.dtype)) for k, v in
                         flat_leaves(ref.state_tree()).items()})
    del ref
    torch.cuda.empty_cache()
    for r in ref_records:
        check(r.applied and math.isfinite(r.loss), f"reference step {r}")
    print(f"#   one rank: losses {[r.loss for r in ref_records]}, grad norms "
          f"{[r.grad_norm for r in ref_records]}, peak allocated "
          f"{ref_peak / 1e9:.3f} GB, step seconds "
          f"{[round(r.seconds, 3) for r in ref_records]} "
          f"({time.perf_counter() - t0:.1f} s with the build)")

    # a NCCL world of one (gloo in a CPU rehearsal): the same code path
    init_distributed(dev.type, init_method=f"file://{work / 'store1'}",
                     rank=0, world=1)
    backend1 = dist.get_backend()
    one = trainer(data_axis=-1)
    one.backbone.load_state_dict(backbone)
    one_records, one_prints, _ = dp_steps(one, batches, dev)
    del one
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    same = ([(r.loss, r.grad_norm) for r in one_records]
            == [(r.loss, r.grad_norm) for r in ref_records]
            and one_prints == ref_prints)
    print(f"#   {backend1} world of one, {DP_STEPS} steps against the "
          f"trainer without a process group: losses "
          f"{[r.loss for r in one_records]} vs "
          f"{[r.loss for r in ref_records]}, grad norms "
          f"{[r.grad_norm for r in one_records]} vs "
          f"{[r.grad_norm for r in ref_records]}, parameter checksums "
          f"{one_prints} vs {ref_prints}: bit-equal {same}; all-reduce "
          f"{one_records[0].reduce_seconds * 1e3:.1f} ms in the first step "
          f"(the communicator's set-up with it), "
          f"{one_records[-1].reduce_seconds * 1e3:.1f} ms in the last")
    check(same, f"the {backend1} world of one differs from one rank")

    # two ranks on the card
    torch.save({"served": served, "batches": batches, "cfg": cfg,
                "eval_cfg": eval_cfg, "spec": spec, "tcfg": tcfg,
                "layers": layers,
                "eval_batches": eval_batches,
                "backbone3": served["backbone"]},
               work / "inputs.pt")
    del backbone
    torch.cuda.empty_cache()
    print(f"#   the parent holds {torch.cuda.memory_allocated(dev) / 1e9:.3f}"
          f" GB allocated, {torch.cuda.memory_reserved(dev) / 1e9:.3f} GB "
          f"reserved before the ranks start" if dev.type == "cuda" else
          "#   (CPU rehearsal)")
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(r, str(work), args.seed,
                                                dev.type))
             for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_JOIN_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * DP_RANKS, f"phase 12 ranks exited with {codes}")
    ranks_s = time.perf_counter() - t0
    seen = [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(DP_RANKS)]

    counts = {name: 0 for name in COUNTERS}
    for r, s in enumerate(seen):
        serve_ = s["serve"]
        add_counts(counts, serve_["counts"])
        k1 = serve_["counts"]["fused_attention"]
        agree = all(np.array_equal(a, b)
                    for a, b in zip(serve_["tags"], served["tags"]))
        print(f"#   rank {r}: backend {s['backend']} on {s['device']}; "
              f"served {serve_['pairs']} requests in {serve_['batches']} "
              f"device batches of {MAX_BATCH // DP_RANKS} rows a rank in "
              f"{serve_['seconds']:.2f} s (first call: kernels loaded, no "
              f"warmup), K1 launches {k1}; tags identical to phase 3's fp32 "
              f"tags: {agree}")
        check(s["backend"] == ("gloo" if DP_RANKS > torch.cuda.device_count()
                               or dev.type == "cpu" else "nccl"),
              f"rank {r} chose {s['backend']}")
        check(serve_["pairs"] == len(served["tags"]) and agree,
              f"rank {r}: DP serving tags differ from phase 3's")
        if CHECK_CONV_LAUNCHES:
            check(k1 == LAYERS_PER_BATCH * serve_["batches"],
                  f"rank {r}: K1 launched {k1} times for "
                  f"{serve_['batches']} batches")
        for run in ("replicated", "zero1"):
            recs = s[run]["records"]
            for i, (got, want) in enumerate(zip(recs, ref_records)):
                loss_rel = abs(got.loss - want.loss) / abs(want.loss)
                norm_rel = abs(got.grad_norm - want.grad_norm) / abs(
                    want.grad_norm)
                compute = got.seconds - got.reduce_seconds \
                    - got.update_seconds
                print(f"#   rank {r} {run} step {i}: loss {got.loss:.7f} vs "
                      f"one rank {want.loss:.7f} (relative {loss_rel:.2e}, "
                      f"tol {DP_LOSS_RTOL:.0e}), grad norm relative "
                      f"{norm_rel:.2e}; step {got.seconds * 1e3:.1f} ms = "
                      f"compute {compute * 1e3:.1f} + all-reduce "
                      f"{got.reduce_seconds * 1e3:.1f} + update "
                      f"{got.update_seconds * 1e3:.1f} ms (ZeRO-1 gather "
                      f"{got.gather_seconds * 1e3:.1f} ms of it)")
                check(got.applied and loss_rel <= DP_LOSS_RTOL
                      and norm_rel <= STEP_NORM_RTOL,
                      f"rank {r} {run} step {i}: loss {got.loss} vs "
                      f"{want.loss}, grad norm {got.grad_norm} vs "
                      f"{want.grad_norm}")
        print(f"#   rank {r}: peak allocated replicated "
              f"{s['replicated']['peak'] / 1e9:.3f} GB, ZeRO-1 "
              f"{s['zero1']['peak'] / 1e9:.3f} GB (one rank "
              f"{ref_peak / 1e9:.3f} GB); on {card}")
        check(s["zero1"]["params"] == s["replicated"]["params"]
              and s["zero1"]["moments"] == s["replicated"]["moments"],
              f"rank {r}: ZeRO-1 is not bit-equal to replicated")
    check(all(s[run]["params"] == seen[0][run]["params"]
              for s in seen for run in ("replicated", "zero1")),
          "the ranks' parameters differ")
    print(f"#   ZeRO-1 bit-equal to replicated (parameters after each step, "
          f"every rank's moment slices) and the ranks bit-equal to each "
          f"other: True; snapshot written by rank 0 in "
          f"{seen[0]['zero1']['save_seconds']:.1f} s; ranks "
          f"{ranks_s:.1f} s with their start")

    # the ZeRO-1 snapshot resumed by a trainer without a process group
    t0 = time.perf_counter()
    single = trainer()
    single.init_state(2 * DP_STEPS)
    tree, step = Checkpointer(str(work / "zero1")).resume()
    single.state_from_checkpoint(tree)
    del tree
    params_ok = (fingerprint(single.params().values())
                 == seen[0]["zero1"]["params"][-1])
    moments_ok = all(
        moment_fingerprints(single, moment_slices(
            shapes, Mesh(DP_RANKS, 1, r, None, dev))) == s["zero1"]["moments"]
        for r, s in enumerate(seen))
    print(f"#   the ZeRO-1 snapshot (step {step}) resumed by one rank in "
          f"{time.perf_counter() - t0:.1f} s: parameters bit-equal "
          f"{params_ok}, moments bit-equal to every rank's slices "
          f"{moments_ok}")
    check(step == DP_STEPS and single.step == DP_STEPS and params_ok
          and moments_ok, "the ZeRO-1 snapshot did not resume bit-equal")
    del single
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    return counts, phase_tp(seen, ref13, served, card)


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
            if dtype == torch.bfloat16:
                row.update({f"{tag}_{key}": val for key, val in wgmma_fields(
                    "K1", N, S, kind, fused_attention, (q, k, v, bias),
                    library_ms, (bound_ms, bound_by)).items()})
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
            was = (f"; {earlier(tag, device_ms)}" if dtype == torch.float32
                   else "")
            print(f"#   {str(dtype)[6:]} Sq=Sk={S} bias={kind}: max_abs_err "
                  f"{err:.3e}; kernel {ms:.4f} ms (profiler device time "
                  f"{device_ms:.4f} ms a launch{was}){strided}, plain "
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
    split = cluster_split(counts, "int8_bottleneck_v2")
    print(f"#   fused: K5 launches {k5}, K4 launches {k4} (one backbone "
          f"call, {identity_blocks} identity blocks; by cluster size "
          f"{split}), K1 launches {k1} in {n_batches} device batches")
    if CHECK_CONV_LAUNCHES:
        check(k5 == 1 and k4 == identity_blocks,
              f"K5 launched {k5} times and K4 {k4} times for one backbone "
              f"call with {identity_blocks} identity blocks")
        check(sum(split.values()) == k4, f"K4's launches by cluster size "
                                         f"{split} do not sum to {k4}")
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
              f"to a synchronise) on {card}"
              + (f"; the ninth slice's phase 4b: {INT8_VISUAL_PR9_MS} ms"
                 if name == "int8 fused" else ""))
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


WGMMA_TILINGS = tuple((bq, bk) for bq in WGMMA_BLOCK_SIZES
                      for bk in WGMMA_BLOCK_SIZES)


def wgmma_tilings_ms(q, k, v, bias, N):
    """The wgmma body's device time per launch (profiler) at each of its
    tilings, through K2's wrapper."""
    return {str(blocks): kernel_device_ms(lambda: fused_attention_blockwise(
        q, k, v, bias, N, *blocks), seconds=0.25) for blocks in WGMMA_TILINGS}


def wgmma_fields(name, N, S, kind, fn, inputs, library_ms, bound,
                 tilings=None):
    """A bf16 head-64 shape of PERF.md's kernel table on the wgmma body:
    `fn` (K1 or K2 as the main path calls it) timed by the profiler's
    device time per launch, beside SDPA (CUDA events, this run), the bound,
    the time of the mma.sync body that ran the shape before
    (`MMA_SYNC_MS`, recorded) and the body at each tiling; printed, and
    the measured numbers returned as the row's fields."""
    q, k, v, bias = inputs
    device_ms = kernel_device_ms(lambda: fn(q, k, v, bias, N), seconds=0.5)
    tilings = tilings or wgmma_tilings_ms(q, k, v, bias, N)
    recorded = MMA_SYNC_MS[name, N, S]
    bound_ms, bound_by = bound
    print(f"#   {name} {N}x64 Sq=Sk={S} bias={kind}, the wgmma body: "
          f"{device_ms:.4f} ms device time a launch, {device_ms / recorded:.3f}"
          f" of the recorded mma.sync time {recorded:.4f} ms, "
          f"{device_ms / library_ms:.2f}x SDPA {library_ms:.4f} ms, "
          f"{device_ms / bound_ms:.1f}x its bound {bound_ms:.4f} ms "
          f"({bound_by}); by tiling " + ", ".join(
              f"{b} {t:.4f}" for b, t in tilings.items()) + " ms")
    # the recorded time is printed, never put in the `kernels` line: every
    # number there is measured in this run
    return {"body": "wgmma", "device_ms": device_ms,
            "tilings_device_ms": tilings}


def phase_blockwise_times(gen, k1_row, launches):
    """K2 beside K1, its plain version, SDPA and its bound; fills K1's
    full-bias time at the packed layout-B shape. `launches` is K2's count
    over the serving runs. At S=150 K2's row takes the wgmma tilings' times
    K1's row took at that shape. Returns K2's row."""
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
              f"{byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        inputs = (q, k, v, bias)
        tilings = (k1_row["tilings_device_ms"] if tag == "s150" else
                   wgmma_tilings_ms(q, k, v, bias, N))
        vals = {"shape": f"B={B} Sq=Sk={S} {N}x{hd} bf16 bias={kind}",
                "max_abs_err": err, "share_of_bound": share, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "k1_ms": k1_ms, "tflops": flops / ms / 1e9,
                **wgmma_fields("K2", N, S, kind, fused_attention_blockwise,
                               inputs, library_ms, (bound_ms, bound_by),
                               tilings)}
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
            print(f"#   K1 at this shape: {k1_ms:.4f} ms "
                  f"({k1_ms / library_ms:.2f}x SDPA; recorded CUDA-core "
                  f"time of the fifth slice "
                  f"{K1_CUDA_CORE_MS[S]:.4f} ms, "
                  f"{K1_CUDA_CORE_MS[S] / k1_ms:.2f}x), its plain version "
                  f"{k1_row['packed_plain_ms']:.4f} ms")
            k1_row.update({f"packed_{key}": val for key, val in wgmma_fields(
                "K1", N, S, kind, fused_attention, inputs, library_ms,
                (bound_ms, bound_by), tilings).items()})
    return row


def k1_tiling_ms(q, k, v, bias, N, iters):
    """The TF32 wgmma body at each of `TF32_WGMMA_TILINGS` on K1's fp32
    inputs, through K2's wrapper (the same kernel; K1 runs
    `K1_FP32_TILES`)."""
    return {blocks: cuda_time_ms(lambda: fused_attention_blockwise(
        q, k, v, bias, N, *blocks), iters=iters)
        for blocks in TF32_WGMMA_TILINGS}


def earlier(tag, device_ms):
    """The recorded time of the 3xTF32 mma.sync body at the shape `tag`
    (`TF32_MMA_SYNC_MS`), as a phrase beside this run's time."""
    was = TF32_MMA_SYNC_MS[tag]
    return (f"{device_ms / was:.3f} of the recorded 3xTF32 mma.sync time "
            f"{was:.4f} ms")


def phase_times(gen, launches, packed_launches, eval_launches, k2_launches,
                int8_static_launches, train_launches, gate_cl_launches,
                weights_launches, remat_launches):
    """K1's row: `launches` counts phase 3, phase 9 (the gate_cl family),
    phase 10 (gate_cl on weights from disk, fused QKV) and phase 11 (the
    dev evaluation of rematerialised training), the other paths' counts
    beside it; `main` adds phase 12's (both ranks' data-parallel
    serving) and phase 13's (both ranks' tensor-parallel evaluation, on
    TP_HEADS heads a rank), which run after this phase."""
    B, S, N, hd, dtype = 128, 150, 16, 64, torch.bfloat16
    print(f"# phase 7: K1 at B={B} Sq=Sk={S} {N}x{hd} bf16, key-mask bias "
          f"(the wgmma body at {K1_WGMMA_TILES}; the prompted encoder's "
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
    row = {"name": "fused_attention", "route": "cuda", "source": K2_SOURCE,
           "replaces": "icka_tpu/kernels/attention.py:87",
           "launches": launches + gate_cl_launches + weights_launches
           + remat_launches,
           "flagship_launches": launches,
           "gate_cl_launches": gate_cl_launches,
           "weights_launches": weights_launches,
           "remat_launches": remat_launches,
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
          f"({bound_by}: {byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    row.update(wgmma_fields("K1", N, S, "B11Sk", fused_attention,
                            (q, k, v, bias), library_ms,
                            (bound_ms, bound_by)))
    row["fp32_body"] = "wgmma_tf32"
    rows = [row, phase_blockwise_times(gen, row, k2_launches)]
    rows[1]["fp32_body"] = "wgmma_tf32"
    phase_fp32_times(gen, *rows)
    phase_bert_times(gen, row)
    phase_wide_times(gen)
    return rows


def phase_fp32_times(gen, k1_row, k2_row):
    """K1 and K2 in fp32 (the 3xTF32 wgmma body) at K1's two serving shapes
    beside their plain versions, SDPA in fp32 (TF32 off), the recorded
    times of the 3xTF32 mma.sync body (`TF32_MMA_SYNC_MS`) and of the
    CUDA-core bodies before it, and the fp32 bound (bytes / 3.35 TB/s
    against three TF32 products' FLOPs / 494.7 TFLOP/s), by CUDA events and
    by the profiler's device time a launch; K1 at the body's two tilings.
    Adds `fp32_*` keys to both rows."""
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
            device_ms = kernel_device_ms(lambda: fn(q, k, v, bias, N),
                                         seconds=0.25)
            plain_ms = cuda_time_ms(plain[name], iters=3, warmup=1)
            cuda_core_ms = FP32_CUDA_CORE_MS[name][S]
            row.update({f"fp32_{tag}_{key}": val for key, val in (
                ("shape", f"B={B} Sq=Sk={S} {N}x{hd} fp32 bias={kind}"),
                ("max_abs_err", err), ("ms", ms), ("device_ms", device_ms),
                ("plain_ms", plain_ms),
                ("bound_ms", bound_ms), ("bound_by", bound_by),
                ("library_ms", library_ms))})
            print(f"#   {name} fp32 Sq=Sk={S} bias={kind}: max_abs_err "
                  f"{err:.3e}; kernel {ms:.4f} ms (device {device_ms:.4f} "
                  f"ms a launch; {earlier((name, S), ms)}; recorded "
                  f"CUDA-core time "
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


def int8_bound(byts, ops):
    """(bound ms, what bounds it) of int8 work."""
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def conv_row(name, replaces, shape, launches, err, ms, plain_ms, unfused_ms,
             byts, ops, earlier, source):
    bound, by = int8_bound(byts, ops)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": None, "unfused_ms": unfused_ms, "shape": shape,
           "on_main_path": launches > 0}
    print(f"#   {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"unfused port path {unfused_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {byts / 1e6:.1f} MB,"
          f" {ops / 1e9:.2f} GOP); no single PyTorch call computes it; "
          f"recorded times of earlier bodies: " + ", ".join(
              f"{what} {t:.4f} ms ({t / ms:.2f}x)" for what, t in earlier))
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
    their bounds; K4 at the serving batch by stage and K5 at the serving
    batch, by device time a launch. Every kernel is called as the model
    calls K4 and K5, with its weights laid out for the kernel once
    (`kmajor_tiles`)."""
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

    # K5: the stem's tail at 224^2, its weight laid out once as
    # `StemPoolS2D` keeps it
    args = stem_inputs(gen, B)
    stem = static_module(StemPoolS2D(dtype=torch.bfloat16,
                                     quant="int8_static", device=dev), gen)
    pixels = _normal(gen, B, 224, 224, 3)
    tiles = kconv.kmajor_tiles(args[1])
    err, ms, plain_ms, unfused_ms = timed(
        lambda: kconv._int8_stem_pool_tiled(tiles, *args),
        lambda: kconv.stem_pool_reference(*args),
        lambda: stem(pixels), "int8_stem_pool")
    # beside the events, the device time a launch (the profiler's); K3's
    # row takes the latter: the wrapper's host time shows in the events of
    # so short a kernel
    with torch.inference_mode():
        device_ms = kernel_device_ms(
            lambda: kconv._int8_stem_pool_tiled(tiles, *args), iters=20,
            seconds=0.5, kernel="int8_stem_pool_kernel")
    print(f"#   int8_stem_pool at B={B}: {ms:.4f} ms a call by CUDA events, "
          f"{device_ms:.4f} ms device time a launch")
    K, N = args[1].shape
    out_bytes = B * 56 * 56 * (N // 4) * 2
    k5 = conv_row(
        "int8_stem_pool", "icka_tpu/kernels/conv.py:467",
        f"B={B} patches (56,56,{K}) -> (56,56,{N // 4}) bf16",
        launches["int8_stem_pool"],
        max(err, errs["int8_stem_pool"]), ms, plain_ms, unfused_ms,
        nbytes(*args) + out_bytes, 2 * B * 56 * 56 * K * N,
        [("mma.sync", CONV_MMA_SYNC_MS["int8_stem_pool"]),
         ("dp4a, the fifth slice", CONV_DP4A_MS["int8_stem_pool"])],
        STEM_CONV3_SOURCE)
    k5["device_ms"] = device_ms
    del args, pixels, tiles
    with torch.inference_mode():     # the serving batch: device time
        args = stem_inputs(gen, REQUESTS)
        tiles = kconv.kmajor_tiles(args[1])
        def fn():
            return kconv._int8_stem_pool_tiled(tiles, *args)
        check_equal(f"int8_stem_pool at B={REQUESTS}", fn(),
                    kconv.stem_pool_reference(*args), {}, "int8_stem_pool")
        ms = kernel_device_ms(fn, iters=20, seconds=0.5,
                              kernel="int8_stem_pool_kernel")
        bound, by = int8_bound(nbytes(*args) + out_bytes * REQUESTS // B,
                               2 * REQUESTS * 56 * 56 * K * N)
        g = kconv.stem_geometry(REQUESTS, 56, K, N, kconv._sm_count(0))
        old = CONV_MMA_SYNC_STEM_B16_MS
        # the recorded time is printed only: every number in the
        # `kernels` line is measured in this run
        k5["serving_batch"] = dict(B=REQUESTS, ms=ms, bound_ms=bound,
                                   bound_by=by)
        print(f"#   int8_stem_pool at the serving batch B={REQUESTS} "
              f"({g['ntiles']} tiles of 7x7 on {g['grid']} CTAs): {ms:.4f} "
              f"ms device time a launch, bound {bound:.4f} ms ({by}, "
              f"{ms / bound:.1f}x); recorded mma.sync body {old:.4f} ms "
              f"({old / ms:.2f}x)")
        del args, tiles
    rows.append(k5)

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
        # the model's call: the weights laid out once (`kmajor_tiles`)
        tiles = kconv.bottleneck_weight_tiles(*args[1:4])
        t = timed(lambda: kconv._int8_bottleneck_v2_tiled(tiles, *args, rs),
                  lambda: kconv.bottleneck_v2_reference(*args, rs),
                  lambda: block(x16), "int8_bottleneck_v2")
        key = f"int8_bottleneck_v2 H={H}"
        k4_rows[H] = conv_row(
            "int8_bottleneck_v2", "icka_tpu/kernels/conv.py:377", shape,
            launches["int8_bottleneck_v2"],
            max(t[0], errs["int8_bottleneck_v2"]), *t[1:], byts, ops,
            [("mma.sync, three launches", CONV_MMA_SYNC_MS[key]),
             ("dp4a, the fifth slice", CONV_DP4A_MS[key])], BNECK_SOURCE)
        if H == 14:
            t = timed(lambda: kconv._int8_bottleneck_tiled(tiles, *args,
                                                           0.37),
                      lambda: kconv.bottleneck_reference(*args, 0.37),
                      lambda: block(x16), "int8_bottleneck")
            k6_row = conv_row(
                "int8_bottleneck", "icka_tpu/kernels/conv.py:204", shape,
                launches["int8_bottleneck"],
                max(t[0], errs["int8_bottleneck"]), *t[1:], byts, ops,
                [("mma.sync, three launches",
                  CONV_MMA_SYNC_MS["int8_bottleneck"]),
                 ("dp4a, the fifth slice", CONV_DP4A_MS["int8_bottleneck"])],
                BNECK_SOURCE)
        del args, x16, tiles
    with torch.inference_mode():           # the serving batch, per stage
        per_stage = []
        for H, Cw in CONV_STAGES:
            args = bottleneck_inputs(gen, REQUESTS, H, Cw)
            rs = torch.tensor([0.37], device=dev)
            g = kconv.bottleneck_geometry(REQUESTS, H, H, Cw,
                                          kconv._sm_count(0))
            tiles = kconv.bottleneck_weight_tiles(*args[1:4])
            # device time: at this batch a call's host time is longer
            ms = kernel_device_ms(lambda: kconv._int8_bottleneck_v2_tiled(
                tiles, *args, rs), iters=20, seconds=0.5,
                kernel="int8_bottleneck_kernel")
            bound, by = int8_bound(
                nbytes(*args, rs) + REQUESTS * H * H * 4 * Cw,
                2 * REQUESTS * H * H * 17 * Cw * Cw)
            old = CONV_MMA_SYNC_B16_MS[H]
            # the recorded time is printed only: every number in the
            # `kernels` line is measured in this run
            per_stage.append(dict(H=H, Cw=Cw, CL=g["CL"], ms=ms,
                                  bound_ms=bound, bound_by=by))
            print(f"#   int8_bottleneck_v2 at the serving batch B={REQUESTS}"
                  f", H={H} Cw={Cw} (tiles {g['TR']}x{g['TC']}, clusters "
                  f"of {g['CL']}): {ms:.4f} ms device time a launch, bound "
                  f"{bound:.4f} ms ({by}, {ms / bound:.1f}x); recorded "
                  f"mma.sync body {old:.4f} ms ({old / ms:.2f}x)")
            del args, tiles
    k4 = k4_rows[14]
    k4.update({f"layer1_{k}": k4_rows[56][k] for k in (
        "shape", "ms", "plain_ms", "unfused_ms", "bound_ms", "bound_by")})
    k4["serving_batch"] = per_stage
    k4["cluster_launches"] = cluster_split(launches, "int8_bottleneck_v2")
    rows += [k4, k6_row]

    # K3 at layer3's 3x3: bf16 out with ReLU, no residual, through the
    # public wrapper (it has no model caller); its time is the device time
    # of the body's launch, which leaves out the weight's layout copy
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
    with torch.inference_mode():
        ms = kernel_device_ms(lambda: kconv.int8_conv3x3(*args),
                              iters=20, seconds=0.5,
                              kernel="int8_conv3x3_kernel")
    g = kconv.conv3x3_geometry(B, H, H, C, C, kconv._sm_count(0))
    print(f"#   int8_conv3x3 at B={B}: {ms:.4f} ms device time a launch, "
          f"{t[1]:.4f} ms a call by CUDA events; tiles {g['TR']}x{g['TC']} "
          f"({g['BM']} rows), {g['ntiles']} on {g['grid']} CTAs, passes of "
          f"{g['np']} channels")
    k3 = conv_row(
        "int8_conv3x3", "icka_tpu/kernels/conv.py:107",
        f"B={B} x_pad ({H + 2},{H + 2},{C}) -> ({H},{H},{C}) bf16",
        launches["int8_conv3x3"],
        max(t[0], errs["int8_conv3x3"]), ms, *t[2:],
        nbytes(*args) + B * H * H * C * 2, 2 * B * H * H * 9 * C * C,
        [("mma.sync by device time", CONV_MMA_SYNC_K3_DEVICE_MS),
         ("mma.sync by CUDA events", CONV_MMA_SYNC_MS["int8_conv3x3"]),
         ("dp4a by CUDA events, the fifth slice",
          CONV_DP4A_MS["int8_conv3x3"])],
        STEM_CONV3_SOURCE)
    k3["events_ms"] = t[1]
    rows.append(k3)
    return rows


# ---------------------------------------------------------------------------
# Phase 14: the chunker and generation at full width
# ---------------------------------------------------------------------------

CHUNK_SENTENCES, CHUNK_BATCH = 32, 8
CHUNK_BUCKETS = (32, 64)
GEN_BATCH, GEN_REGIONS, CAPTION_BEAMS = 8, 50, 3
CBS_WORDS, CBS_BEAMS, CBS_STEPS = (2158, 3899), 2, 20
GPT2_MAX_LEN = 20
SAMPLE_TOP_K, SAMPLE_TOP_P = 50, 0.9
# logits of one model on two paths in fp32 (TF32 off): K1 against the
# plain core, the cached step against the full re-encode. PR 11's
# TokenClassifier at BERT-base width differed by 8.9e-07 through K1.
GEN_LOGITS_TOL = 1e-4
BERT_CLS, BERT_SEP = 101, 102          # bert-base-uncased [CLS], [SEP]
GPT2_EOS = 50256                       # GPT-2's <|endoftext|>
CHUNKER_DIR = WORK_DIR / "chunker"


def chunker_checkpoint(seed, cfg):
    """A `BertModelWithHeads` state dict of random weights (`seed`) at
    `cfg`'s widths, in adapter-transformers' key layout: HF BERT with its
    pooler, each layer's Pfeiffer adapter under `conll2000`, the tagging
    head `heads.conll2000.1`."""
    rng = np.random.default_rng(seed)
    sd = hf_state_dict(random_encoder_tree(cfg, rng), "bert.",
                       legacy_norms=False)
    H, A, n = cfg.hidden_size, cfg.adapter_size, len(CONLL2000_LABELS)

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(0.02))
    for i in range(cfg.num_hidden_layers):
        base = f"bert.encoder.layer.{i}.output.adapters.conll2000"
        sd[f"{base}.adapter_down.0.weight"] = w(A, H)
        sd[f"{base}.adapter_down.0.bias"] = w(A)
        sd[f"{base}.adapter_up.weight"] = w(H, A)
        sd[f"{base}.adapter_up.bias"] = w(H)
    sd["heads.conll2000.1.weight"] = w(n, H)
    sd["heads.conll2000.1.bias"] = w(n)
    return sd


def phase_chunker(args, dev, cfg):
    """The chunker's main path: its checkpoint written to disk, loaded by
    `load_chunker` with K1, 32 sentences tagged in batches of 8 (sorted by
    length: buckets 32 and 64). Returns the checks' inputs: the two
    chunkers, the batches and their tags."""
    sd = chunker_checkpoint(args.seed + 14, cfg)
    CHUNKER_DIR.mkdir(parents=True, exist_ok=True)
    _, save_s = timed(lambda: torch.save(
        sd, CHUNKER_DIR / "pytorch_model.bin"))
    (CHUNKER_DIR / "config.json").write_text(
        json.dumps(hf_config(cfg, "bert")))
    mb = size_mb(CHUNKER_DIR)
    del sd
    chunker, load_s = timed(lambda: load_chunker(
        str(CHUNKER_DIR), device=dev, use_pallas=True))
    plain = load_chunker(str(CHUNKER_DIR), device=dev)
    shutil.rmtree(CHUNKER_DIR)
    check(chunker.cfg.adapter_size == cfg.adapter_size
          and chunker.cfg.use_pallas
          and not plain.cfg.use_pallas, f"load_chunker built {chunker.cfg}")
    print(f"#   checkpoint {mb:.1f} MB (adapter-transformers layout) "
          f"written in {save_s:.2f} s, loaded by load_chunker in "
          f"{load_s:.2f} s")
    rng = np.random.default_rng(args.seed + 14)
    lengths = np.linspace(10, 60, CHUNK_SENTENCES).round().astype(int)
    sentences = sorted(
        ([BERT_CLS] + rng.integers(BERT_SEP + 1, cfg.vocab_size, n).tolist()
         + [BERT_SEP]
         for n in rng.permutation(lengths)), key=len)
    batches = [sentences[i:i + CHUNK_BATCH]
               for i in range(0, CHUNK_SENTENCES, CHUNK_BATCH)]
    tags = [chunker.tag(b) for b in batches]
    return chunker, plain, batches, tags


def check_chunker(card, dev, chunker, plain, batches, tags, launches):
    buckets = [chunker.batch(b)[0].shape[1] for b in batches]
    print(f"#   {CHUNK_SENTENCES} sentences of 10-60 word pieces in "
          f"{len(batches)} batches of {CHUNK_BATCH}, padded to {buckets}; "
          f"K1 launches {launches}")
    check(set(buckets) == set(CHUNK_BUCKETS),
          f"the chunker ran buckets {buckets}, not {CHUNK_BUCKETS}")
    check(dev.type != "cuda"
          or launches == chunker.cfg.num_hidden_layers * len(batches),
          f"the chunker launched K1 {launches} times")
    err, same, n = 0.0, 0, 0
    with torch.no_grad():
        for batch, rows in zip(batches, tags):
            ids, mask = chunker.batch(batch)
            got = chunker.model(ids, attention_mask=mask)
            want = plain.model(ids, attention_mask=mask)
            err = max(err, (got - want).abs().max().item())
            classes = want.argmax(-1).cpu().numpy()
            for seq, row, cls in zip(batch, rows, classes):
                same += sum(CONLL2000_ID2LABEL[int(c)] == t
                            for c, t in zip(cls[1:len(seq) - 1], row))
                n += len(row)
                spans = bio_spans(row)
                covered = {t for s, e in spans for t in range(s, e)}
                check(covered == set(range(len(seq) - 2)),
                      "a sentence's chunk spans miss interior tokens")
    check(err <= GEN_LOGITS_TOL, f"chunker logits K1 vs plain core differ "
                                 f"by {err} > {GEN_LOGITS_TOL}")
    tokens = sum(len(s) - 2 for b in batches for s in b)
    _, secs = timed(lambda: [chunker.tag(b) for b in batches])
    _, plain_secs = timed(lambda: [plain.tag(b) for b in batches])
    print(f"#   logits K1 vs plain core max_abs_err {err:.3e} (tol "
          f"{GEN_LOGITS_TOL:.0e}); tags agree {same / n:.6f}; every "
          f"sentence's spans cover its interior tokens; tag {secs * 1e3:.1f}"
          f" ms for the {CHUNK_SENTENCES} sentences ({tokens / secs:.0f} "
          f"tags/s, {CHUNK_SENTENCES / secs:.1f} sentences/s; plain core "
          f"{plain_secs * 1e3:.1f} ms) on {card}")


def region_mask(dev, regions=GEN_REGIONS):
    """(GEN_BATCH, regions): row b has its last 3b regions padded."""
    valid = torch.tensor([regions - 3 * b for b in range(GEN_BATCH)])
    return (torch.arange(regions)[None] < valid[:, None]).long().to(dev)


def gpt2_full_step(decoder):
    """The full-recompute step over the GPT-2 decoder: the teacher-forced
    pass over the token buffer (positions after t masked), read at t. The
    cache carries the buffer, the memory and its mask."""
    def step(tok, cache, t):
        buf = cache["tokens"].clone()
        buf[:, t] = tok
        pos = torch.arange(buf.shape[1], device=buf.device)[None]
        logits = decoder(buf, (pos <= t).expand_as(buf).long(),
                         cache["memory"], cache["memory_mask"])
        return logits[:, t], {**cache, "tokens": buf}
    return step


def decode_runs(model, decoder, img, img_mask, memory):
    """Every decode of the phase once: the captioner's greedy and beam
    search by full recompute (K1, full seq2seq bias) and on the KV cache,
    constrained beam search on the cached step, GPT-2's cached and full
    greedy and beam search. Returns {name: (result, seconds, steps)}."""
    L = model.cfg.max_caption_len
    V = model.cfg.encoder.vocab_size
    lm = decoder.wte.T
    B = img.shape[0]
    out = {}

    def run(name, steps, fn):
        t0 = time.perf_counter()
        result = fn()
        sync(img.device)
        out[name] = (result, time.perf_counter() - t0, steps)

    for mode, kw in (("greedy", {}), ("beam", {"num_beams": CAPTION_BEAMS})):
        run(f"caption {mode}", L - 1, lambda: generate_captions(
            model, BERT_CLS, BERT_SEP, img, img_mask, L, mode, **kw))
        run(f"caption {mode} cached", L - 1,
            lambda: generate_captions_cached(
                model, BERT_CLS, BERT_SEP, img, img_mask, L, mode, **kw))
    fsm = fsm_from_constraints([[w] for w in CBS_WORDS], V)
    run("constrained cached", CBS_STEPS, lambda: constrained_beam_search(
        lambda tok, c, t: cached_caption_step(model, tok, t, c),
        torch.full((B,), BERT_CLS, device=img.device),
        precompute_image_cache(model, img, img_mask, CBS_STEPS + 1), fsm,
        CBS_STEPS + 1, BERT_SEP, beams_per_state=CBS_BEAMS))
    init = torch.full((B,), GPT2_EOS, device=img.device)
    mem_mask = img_mask
    for mode, fn, kw in (("greedy", greedy_decode, {}),
                         ("beam", beam_search,
                          {"num_beams": CAPTION_BEAMS})):
        run(f"gpt2 {mode} cached", GPT2_MAX_LEN - 1, lambda: fn(
            lambda tok, c, t: cached_gpt2_step(decoder, lm, tok, t, c),
            init, precompute_gpt2_cache(decoder, memory, mem_mask,
                                        GPT2_MAX_LEN),
            GPT2_MAX_LEN, GPT2_EOS, **kw))
        run(f"gpt2 {mode}", GPT2_MAX_LEN - 1, lambda: fn(
            gpt2_full_step(decoder), init,
            {"tokens": torch.zeros(B, GPT2_MAX_LEN, dtype=torch.long,
                                   device=img.device),
             "memory": memory, "memory_mask": mem_mask},
            GPT2_MAX_LEN, GPT2_EOS, **kw))
    return out, fsm


def first_divergence(a, b):
    diff = (a != b).nonzero()
    return None if len(diff) == 0 else tuple(diff[0].tolist())


def check_decodes(card, model, runs, fsm):
    """Cached against full recompute, token for token, in both families;
    the constrained search's best beams hold both words."""
    for family in ("caption", "gpt2"):
        for mode in ("greedy", "beam"):
            full, full_s, steps = runs[f"{family} {mode}"]
            cached, cached_s, _ = runs[f"{family} {mode} cached"]
            where = first_divergence(full.tokens, cached.tokens)
            score_err = (full.scores - cached.scores).abs().max().item()
            print(f"#   {family} {mode}: full recompute "
                  f"{full_s * 1e3 / steps:.2f} ms a token, KV cache "
                  f"{cached_s * 1e3 / steps:.2f} ms a token ({steps} steps "
                  f"of {full.tokens.shape[0]} rows); tokens identical: "
                  f"{where is None} (first divergence {where}); scores "
                  f"max_abs_err {score_err:.3e}")
            check(where is None, f"{family} {mode}: cached tokens differ "
                                 f"from the full recompute's at {where}")
            check(score_err <= GEN_LOGITS_TOL,
                  f"{family} {mode}: scores differ by {score_err}")
    res, secs, steps = runs["constrained cached"]
    toks, scores = select_best_beam_with_constraints(res, fsm, 2)
    held = [all(w in row for w in CBS_WORDS) for row in toks.tolist()]
    print(f"#   constrained beam search on the cached step ({fsm.num_states} "
          f"FSM states x {CBS_BEAMS} beams, words {list(CBS_WORDS)}, "
          f"{steps} steps): {secs * 1e3 / steps:.2f} ms a step; "
          f"{sum(held)} of {len(held)} best beams hold both words, scores "
          f"finite: {bool(np.isfinite(scores).all())}")
    check(all(held) and np.isfinite(scores).all(),
          "constrained search: a best beam lacks a constraint word")


def check_step_logits(model, img, img_mask, tokens):
    """The caption's step logits on the greedy tokens: the cached step
    against the full re-encode through K1 at every position."""
    L = tokens.shape[1]
    cache = precompute_image_cache(model, img, img_mask, L)
    err = 0.0
    with torch.no_grad():
        for t in range(L - 1):
            got, cache = cached_caption_step(model, tokens[:, t], t, cache)
            buf = torch.where(torch.arange(L, device=tokens.device)[None]
                              <= t, tokens, 0)
            want = model.decode_step(buf, img, img_mask, t)
            err = max(err, (got - want).abs().max().item())
    check(err <= GEN_LOGITS_TOL, f"caption step logits differ by {err}")
    return err


def check_sampling(decoder, memory, mem_mask, seed):
    """Seeded sampling on GPT-2's cached step (top_k 50, top_p 0.9, a
    generator on the card): one seed gives one result, and each token of a
    row not yet finished survives the filter of its step's logits."""
    lm = decoder.wte.T
    dev = memory.device

    def sampled(s):
        seen = []

        def step(tok, c, t):
            logits, c = cached_gpt2_step(decoder, lm, tok, t, c)
            seen.append(logits)
            return logits, c
        out = sample_decode(
            step, torch.full((memory.shape[0],), GPT2_EOS, device=dev),
            precompute_gpt2_cache(decoder, memory, mem_mask, GPT2_MAX_LEN),
            GPT2_MAX_LEN, GPT2_EOS,
            generator=torch.Generator(device=dev).manual_seed(s),
            top_k=SAMPLE_TOP_K, top_p=SAMPLE_TOP_P)
        return out.tokens, seen

    (a, seen), (b, _), (c, _) = sampled(seed), sampled(seed), sampled(seed + 1)
    check(torch.equal(a, b), "one seed sampled two token sequences")
    kept = 0
    rows = torch.arange(a.shape[0], device=dev)
    for t, logits in enumerate(seen):
        live = ~(a[:, 1:t + 1] == GPT2_EOS).any(dim=1)
        ok = top_k_top_p_filter(logits, SAMPLE_TOP_K,
                                    SAMPLE_TOP_P)[rows, a[:, t + 1]] > -1e8
        check(bool(ok[live].all()), f"a sampled token at step {t} lies "
                                    f"outside the filter")
        kept += int(live.sum())
    print(f"#   sampling on GPT-2's cached step (top_k {SAMPLE_TOP_K}, top_p "
          f"{SAMPLE_TOP_P}, a CUDA generator): the same seed gave the same "
          f"tokens; all {kept} live tokens inside their step's filter; "
          f"another seed changed {int((a != c).sum())} of {a.numel()} tokens")


def phase_k1_generation_shapes(gen, row):
    """K1 against its plain version at the new callers' shapes (12 heads of
    64, B=8): the captioner's full re-encode, Sq=Sk=90 under its seq2seq
    bias (B, 1, 90, 90) and under a random full bias, and the chunker's
    buckets 32 and 64 with key biases, fp32 and bf16 to phase 2's bounds;
    then in fp32 (the phase's type) at the greedy and beam shapes (B=8,
    24) and the chunker's, timed beside the plain version, SDPA (TF32 off)
    and the bound, with the profiler's device time a launch. Adds `gen_*`
    keys to K1's row."""
    L, Li = 40, GEN_REGIONS
    print("# phase 14: K1 fused_attention vs attention_reference at the "
          "captioner's (Sq=Sk=90, full bias) and the chunker's (32, 64, key "
          "bias) shapes, 12 heads of 64")

    def seq2seq_bias(B):
        # the full re-encode's bias at step 17: captions visible up to 17
        cap_mask = (torch.arange(L, device="cuda")[None] <= 17).long()
        return seq2seq_mask(L, Li, cap_mask.expand(GEN_BATCH, L),
                            region_mask("cuda")).repeat_interleave(
                                B // GEN_BATCH, 0)

    shapes = (("caption_seq2seq", 90, "seq2seq"), ("caption_full", 90,
                                                   "BSqSk"),
              ("chunk32", 32, "B11Sk"), ("chunk64", 64, "B11Sk"))
    for dtype in (torch.float32, torch.bfloat16):
        for name, S, kind in shapes:
            q, k, v, bias = attention_inputs(
                GEN_BATCH, S, S, dtype, "B11Sk" if kind == "seq2seq"
                else kind, gen, N=12)
            if kind == "seq2seq":
                bias = seq2seq_bias(GEN_BATCH)
            out = fused_attention(q, k, v, bias, 12)
            torch.cuda.synchronize()
            err, share = attention_close(
                out, attention_reference(q, k, v, bias, 12),
                f"K1 12x64 {dtype} {name}")
            print(f"#   {str(dtype)[6:]:8s} {name:16s} max_abs_err="
                  f"{err:.3e} ({share:.2f} of its bound)")
    for name, B, S, kind in (("caption_greedy", GEN_BATCH, 90, "seq2seq"),
                             ("caption_beam", GEN_BATCH * CAPTION_BEAMS, 90,
                              "seq2seq"),
                             ("chunk32", GEN_BATCH, 32, "B11Sk"),
                             ("chunk64", GEN_BATCH, 64, "B11Sk")):
        q, k, v, bias = attention_inputs(B, S, S, torch.float32, "B11Sk",
                                         gen, N=12)
        if kind == "seq2seq":
            bias = seq2seq_bias(B)
        err, _ = attention_close(fused_attention(q, k, v, bias, 12),
                                 attention_reference(q, k, v, bias, 12),
                                 f"K1 {name}")
        ms = cuda_time_ms(lambda: fused_attention(q, k, v, bias, 12))
        device_ms = kernel_device_ms(lambda: fused_attention(q, k, v, bias,
                                                             12))
        plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v, bias,
                                                            12))
        library_ms = sdpa_ms(q, k, v, bias, 12, 50)
        bound_ms, bound_by, byts, flops = attention_bound(q, k, bias, 12)
        shape = f"B={B} Sq=Sk={S} 12x64 float32 bias={kind}"
        row.update({f"gen_{name}_{key}": val for key, val in (
            ("shape", shape), ("max_abs_err", err), ("ms", ms),
            ("device_ms", device_ms), ("plain_ms", plain_ms),
            ("bound_ms", bound_ms), ("bound_by", bound_by),
            ("library_ms", library_ms))})
        print(f"#   {shape}: kernel {ms:.4f} ms (device {device_ms:.4f} ms "
              f"a launch, {earlier(f'gen_{name}', device_ms)}), plain "
              f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}: {byts / 1e6:.2f} "
              f"MB, {flops / 1e9:.3f} GFLOP)")


def phase_generation(args, card, dev, gen, row, chunk_cfg=None,
                     caption_cfg=None, gpt2_cfg=None):
    """Phase 14, the chunker and generation at full width (see the module
    docstring; the configurations default to the full ones). Returns the
    main path's launch counts."""
    strict_fp32()
    print("# phase 14: the CoNLL-2000 chunker (chunker_config(): BERT-base, "
          "12 layers, adapter 48, vocabulary 30522) and the generation stack "
          "(CaptionConfig(): BERT-base, 2048-d regions, 40 caption tokens, 50 "
          "regions; GPT2Config(): 12 layers, 768 wide, vocabulary 50257, "
          "cross-attention over 8 x 50 x 768) at full width, fp32 (TF32 "
          "off), random weights from --seed")
    ccfg = caption_cfg or CaptionConfig(encoder=dataclasses.replace(
        EncoderConfig.bert_base(), use_pallas=True))
    model = CaptionModel(ccfg, device=dev, seed=args.seed + 15).eval()
    decoder = GPT2Decoder(gpt2_cfg or GPT2Config(), with_cross=True,
                          device=dev, seed=args.seed + 16).eval()
    img = torch.randn(GEN_BATCH, ccfg.max_regions, ccfg.img_feature_dim,
                      device=dev, generator=gen)
    img_mask = region_mask(dev, ccfg.max_regions)
    memory = torch.randn(GEN_BATCH, ccfg.max_regions, decoder.cfg.n_embd,
                         device=dev, generator=gen)
    # the main path, driven from counts of 0
    zero_counts()
    chunked = phase_chunker(args, dev, chunk_cfg or chunker_config())
    chunk_counts = read_counts()
    runs, fsm = decode_runs(model, decoder, img, img_mask, memory)
    counts = read_counts()
    check_chunker(card, dev, *chunked, chunk_counts["fused_attention"])
    del chunked
    caption_launches = counts["fused_attention"] \
        - chunk_counts["fused_attention"]
    want = 2 * (ccfg.max_caption_len - 1) * ccfg.encoder.num_hidden_layers
    print(f"#   the captioner's full re-encodes launched K1 "
          f"{caption_launches} times (greedy and beam: "
          f"{ccfg.encoder.num_hidden_layers} a step); the cached steps, "
          f"the constrained search and GPT-2 run the plain core")
    check(dev.type != "cuda" or caption_launches == want,
          f"the decodes launched K1 {caption_launches} times, not {want}")
    check(all(counts[n] == 0 for n in COUNTERS if n != "fused_attention"),
          f"phase 14 launched another kernel: {counts}")
    # the timed runs: a second pass of every decode
    runs, _ = decode_runs(model, decoder, img, img_mask, memory)
    check_decodes(card, model, runs, fsm)
    err = check_step_logits(model, img, img_mask,
                            runs["caption greedy"][0].tokens)
    print(f"#   caption step logits, the cached step against the full "
          f"re-encode through K1, max_abs_err {err:.3e} over "
          f"{ccfg.max_caption_len - 1} steps (tol {GEN_LOGITS_TOL:.0e}); "
          f"on {card}")
    check_sampling(decoder, memory, img_mask, args.seed)
    del model, decoder, runs
    torch.cuda.empty_cache()
    phase_k1_generation_shapes(gen, row)
    row["generation_launches"] = counts["fused_attention"]
    row["launches"] += counts["fused_attention"]
    return counts


# ---------------------------------------------------------------------------
# Phase 15: ChunkAlign and the VCR plane at full width
# ---------------------------------------------------------------------------

VCR_QUESTIONS, VCR_REGIONS, VCR_CHUNK_WORDS = 4, 50, 5
VCR_PROMPT, VCR_GEN, VCR_BEAMS = 6, 20, 3
VCR_PROMPT_LENS = (6, 4, 5, 3)          # ragged rationale prompts
VCR_HISTORY = (3, 50)                   # history rows: Sk = 103 and 150
CAPTION_IMAGES, CAPTION_TEXT, CAPTION_LEN = 4, 50, 20
# K1 against the plain core on one model's weights in fp32 (TF32 off):
# scores, losses and logits (phase 14's bound); a zero history under mask
# 0 changes each softmax only by exp(-10000) terms and the order of sums
VCR_TOL, HISTORY_ID_TOL = 1e-4, 1e-5
VCR_DIR = WORK_DIR / "vcr"


@contextlib.contextmanager
def plain_core(model):
    """`model`'s K1 self-attention layers on the plain core inside the
    block, on the same weights."""
    flipped = [m for m in model.modules()
               if isinstance(m, MultiHeadAttention) and m.use_pallas]
    for m in flipped:
        m.use_pallas = False
    try:
        yield
    finally:
        for m in flipped:
            m.use_pallas = True


def k1_delta(fn):
    """(fn's result, K1 launches it made)."""
    before = fused_attention.launches
    out = fn()
    return out, fused_attention.launches - before


def vcr_inputs(cfg, dev, gen, rng):
    """VCR_QUESTIONS questions x num_choices answer rows: BERT ids of
    ragged length (CLS first), chunks of VCR_CHUNK_WORDS tokens (padding
    in the dead chunk), the last 3 x (row % 4) regions masked, one gold
    choice a question and three supervised align positions a row."""
    C, Lh, Li = cfg.num_choices, cfg.max_hypo, VCR_REGIONS
    rows = VCR_QUESTIONS * C
    dead = -(-Lh // VCR_CHUNK_WORDS)
    ids = np.zeros((rows, Lh), np.int64)
    mask = np.zeros((rows, Lh + Li), np.int64)
    gidx = np.full((rows, Lh), dead, np.int64)
    cm = np.zeros((rows, Lh, Lh), np.int64)
    for r, n in enumerate(rng.integers(Lh // 2, Lh + 1, rows)):
        ids[r, 0] = BERT_CLS
        ids[r, 1:n] = rng.integers(BERT_SEP + 1, cfg.encoder.vocab_size,
                                   n - 1)
        mask[r, :n] = 1
        mask[r, Lh:Lh + Li - 3 * (r % 4)] = 1
        gidx[r, :n] = np.arange(n) // VCR_CHUNK_WORDS
        cm[r, :n, :n] = gidx[r, :n, None] == gidx[r, None, :n]
    label = np.zeros(rows, np.int64)
    label[np.arange(VCR_QUESTIONS) * C + np.arange(VCR_QUESTIONS) % C] = 1
    align_pos = np.zeros((rows, Lh), np.int64)
    align_pos[:, 1:4] = 1
    total_label = rng.integers(0, Li - 9, (rows, Lh))

    def t(x):
        return torch.from_numpy(x).to(dev)
    enc = dict(input_ids=t(ids),
               img_feats=torch.randn(rows, Li, cfg.img_feature_dim,
                                     device=dev, generator=gen),
               input_mask=t(mask), chunk_mask=t(cm), gather_index=t(gidx),
               num_chunks=dead + 1)
    return enc, t(label), t(align_pos), t(total_label)


def close_all(got, want, what, tol=VCR_TOL):
    """Max abs difference of two nests of tensors, checked against tol."""
    if isinstance(got, torch.Tensor):
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
    else:
        err = max(close_all(g, w, what, tol) for g, w in zip(got, want))
    check(err <= tol, f"{what}: K1 vs the plain core differ by {err} > {tol}")
    return err


def check_chunkalign_cls(card, dev, core, enc, label, align_pos,
                         total_label):
    """ChunkAlignCLS eval and train-mode forwards through K1 against the
    plain core (scores, losses within VCR_TOL, predictions equal; K1 12 a
    call), then one backward with dropout (the plain core), every gradient
    finite."""
    sup = (label, align_pos, total_label)
    layers = core.cfg.encoder.num_hidden_layers
    with torch.no_grad():
        (pred, scores), n_eval = k1_delta(lambda: core(**enc))
        train, n_train = k1_delta(lambda: core(**enc, label=label,
                                               align_pos=align_pos,
                                               total_label=total_label))
        with plain_core(core):
            want_pred, want_scores = core(**enc)
            want_train = core(**enc, label=label, align_pos=align_pos,
                              total_label=total_label)
    check(dev.type != "cuda" or n_eval == n_train == layers,
          f"ChunkAlignCLS launched K1 {n_eval} and {n_train} times, not "
          f"{layers} a call")
    check(torch.equal(pred, want_pred), "ChunkAlignCLS predictions differ")
    err = close_all((scores, train[0], train[2]),
                    (want_scores, want_train[0], want_train[2]),
                    "ChunkAlignCLS")
    check(torch.equal(train[1], want_train[1])
          and train[3].item() == want_train[3].item(),
          "ChunkAlignCLS matched / align hits differ")
    ms = {}
    for name, ctx in (("K1", contextlib.nullcontext()),
                      ("plain", plain_core(core))):
        with ctx, torch.no_grad():
            core(**enc)
            sync(dev)
            _, secs = timed(lambda: (core(**enc), sync(dev)))
        ms[name] = secs * 1e3
    gen = torch.Generator(device=dev).manual_seed(15)
    cls_loss, _, align_loss, _, _ = core(**enc, label=label,
                                         align_pos=align_pos,
                                         total_label=total_label,
                                         dropout_gen=gen)
    _, back_s = timed(lambda: ((cls_loss + align_loss).backward(),
                               sync(dev)))
    grads = [p.grad for p in core.parameters()]
    finite = all(g is not None and bool(torch.isfinite(g).all())
                 for g in grads)
    check(finite, "ChunkAlignCLS: a gradient is missing or not finite")
    core.zero_grad(set_to_none=True)
    print(f"#   ChunkAlignCLS ({sum(p.numel() for p in core.parameters())}"
          f" parameters) on {enc['input_ids'].shape[0]} rows: scores and "
          f"losses K1 vs plain core max_abs_err {err:.3e} (tol "
          f"{VCR_TOL:.0e}), predictions equal {pred.tolist()}, cls_loss "
          f"{train[0].item():.6f}, align_loss {train[2].item():.6f}; K1 "
          f"{n_eval} launches a call; eval forward {ms['K1']:.2f} ms "
          f"(plain core {ms['plain']:.2f} ms); one backward with dropout "
          f"(plain core) {back_s * 1e3:.1f} ms, all {len(grads)} gradients "
          f"finite; on {card}")


def check_history(card, dev, enc_model, enc, gen):
    """The history KV-concat on GlobalVLEncoder through K1: a zero history
    under mask 0 is the identity, a visible one moves the output."""
    ids, img, mask = enc["input_ids"], enc["img_feats"], enc["input_mask"]
    B, H = ids.shape[0], enc_model.cfg.encoder.hidden_size
    n = enc_model.cfg.encoder.num_hidden_layers
    with torch.no_grad():
        base, _ = enc_model(ids, img, mask)
        counts, errs, moved = [], [], []
        for Sh in VCR_HISTORY:
            zeros = [torch.zeros(B, Sh, H, device=dev)] * n
            (seq0, _), c = k1_delta(lambda: enc_model(
                ids, img, mask, history_states=zeros,
                history_mask=torch.zeros(B, Sh, dtype=torch.long,
                                         device=dev)))
            seen = [torch.randn(B, Sh, H, device=dev, generator=gen)] * n
            seq1, _ = enc_model(ids, img, mask, history_states=seen,
                                history_mask=torch.ones(
                                    B, Sh, dtype=torch.long, device=dev))
            counts.append(c)
            errs.append((seq0 - base).abs().max().item())
            moved.append((seq1 - base).abs().max().item())
    check(max(errs) <= HISTORY_ID_TOL, f"a masked zero history moved the "
                                       f"encoder by {max(errs)}")
    check(min(moved) > 1e-3, f"a visible history moved it only {moved}")
    check(dev.type != "cuda" or all(c == n for c in counts),
          f"the history forwards launched K1 {counts} times")
    print(f"#   history KV-concat on GlobalVLEncoder through K1 (Sq = "
          f"{ids.shape[1] + img.shape[1]}, Sk = Sq + {list(VCR_HISTORY)}): "
          f"masked zero history max_abs_err {max(errs):.3e} against none "
          f"(tol {HISTORY_ID_TOL:.0e}); a visible history moves it by "
          f"{min(moved):.3f} or more; K1 {counts} launches")


def rationale_full_step(model, memory, mem_mask):
    """The rationale's full-recompute step: the decoder over the token
    buffer (positions after t masked), `lm_head` at t."""
    def step(tok, cache, t):
        buf = cache["tokens"].clone()
        buf[:, t] = tok
        pos = torch.arange(buf.shape[1], device=buf.device)[None]
        hidden = model.dec(buf, (pos <= t).expand_as(buf).long(),
                           cache["memory"], cache["memory_mask"])
        return model.lm_head(hidden[:, t].float()), {**cache, "tokens": buf}
    return step, {"tokens": torch.zeros(memory.shape[0], VCR_PROMPT + VCR_GEN,
                                        dtype=torch.long,
                                        device=memory.device),
                  "memory": memory, "memory_mask": mem_mask}


def check_rationale(card, dev, model, enc, rng):
    """ChunkAlignRationale's decodes: the full-recompute `generate` and the
    cached greedy engine at one prompt length, the full recompute and the
    cache with ragged prompts (identical tokens); beam with the bonus mask
    of the predicted rows' CLS attention; constrained search over two
    one-token words, every best beam holding both."""
    V, Bq = model.gpt2_cfg.vocab_size, VCR_QUESTIONS
    prompt = torch.from_numpy(rng.integers(
        0, min(V, GPT2_EOS) - 1, (Bq, VCR_PROMPT))).to(dev)
    plen = torch.tensor(VCR_PROMPT_LENS, device=dev)
    kw = dict(max_gen_len=VCR_GEN, eos_id=GPT2_EOS)
    steps = VCR_PROMPT + VCR_GEN - 1
    secs = {}

    def run(name, fn):
        out, secs[name] = timed(lambda: (fn(), sync(dev))[0])
        return out
    full, pred = run("full recompute", lambda: model.generate(
        **enc, prompt_ids=prompt, **kw))
    cached, pred_c = run("greedy cached", lambda: generate_rationale(
        model, enc, prompt, VCR_PROMPT, mode="greedy", **kw))
    check(torch.equal(full, cached) and torch.equal(pred, pred_c),
          f"rationale: the cached greedy tokens differ from generate's at "
          f"{first_divergence(full, cached)}")
    _, memory, mem_mask, cls_attn = model.encode_for_generation(**enc)
    step, cache = rationale_full_step(model, memory, mem_mask)
    ragged_full = run("ragged full recompute", lambda: greedy_decode(
        step, prompt[:, 0], cache, VCR_PROMPT + VCR_GEN, GPT2_EOS,
        forced=prompt, forced_len=plen).tokens)
    ragged = run("ragged greedy cached", lambda: generate_rationale(
        model, enc, prompt, plen, mode="greedy", **kw)[0])
    check(torch.equal(ragged_full, ragged),
          f"rationale: ragged cached tokens differ from the full "
          f"recompute's at {first_divergence(ragged_full, ragged)}")
    for b, n in enumerate(VCR_PROMPT_LENS):
        check(torch.equal(ragged[b, :n], prompt[b, :n]),
              "rationale: a ragged prompt was not kept")
    hypo = choose_row(enc["input_ids"], pred, model.cfg.num_choices)
    enc_to_dec = rng.integers(0, V, model.cfg.encoder.vocab_size)
    bonus = rationale_bonus_mask(cls_attn.cpu().numpy(), hypo.cpu().numpy(),
                                 V, enc_to_dec, stop_ids=(BERT_CLS, BERT_SEP))
    beam = run("beam cached", lambda: generate_rationale(
        model, enc, prompt, plen, mode="beam", num_beams=VCR_BEAMS,
        bonus_mask=bonus, bonus_factor=0.5, **kw)[0])
    check(all(torch.equal(beam[b, :n], prompt[b, :n])
              for b, n in enumerate(VCR_PROMPT_LENS)),
          "rationale beam: a prompt was not kept")
    fsm = fsm_from_constraints([[w] for w in CBS_WORDS], V)
    cons = run("constrained cached", lambda: generate_rationale(
        model, enc, prompt, plen, mode="constrained", fsm=fsm,
        beams_per_state=CBS_BEAMS, **kw)[0])
    held = [all(w in row[n:] for w in CBS_WORDS)
            for row, n in zip(cons.tolist(), VCR_PROMPT_LENS)]
    check(all(held), f"constrained rationale: best beams hold both words "
                     f"{held}")
    per_step = ", ".join(f"{k} {v * 1e3 / steps:.2f}"
                         for k, v in secs.items())
    print(f"#   ChunkAlignRationale (GPT2Config(), memory "
          f"{tuple(memory.shape)}), {Bq} questions, prompts "
          f"{list(VCR_PROMPT_LENS)}, {VCR_GEN} new tokens: generate == "
          f"cached greedy, ragged full recompute == ragged cached greedy "
          f"(tokens identical); beam x{VCR_BEAMS} with a bonus mask of "
          f"{int(bonus.sum())} words; constrained ({fsm.num_states} states x "
          f"{CBS_BEAMS} beams, words {list(CBS_WORDS)}): {sum(held)} of "
          f"{len(held)} best beams hold both; ms a decode step: {per_step}; "
          f"on {card}")


def check_captioner(card, dev, model, gen):
    """GPT2Captioner: greedy and 3-beam captions with the encoder through
    K1 and on the plain core, tokens identical; the step logits of the
    greedy tokens within VCR_TOL."""
    enc_cfg = model.cfg.encoder
    L, Li = CAPTION_TEXT, VCR_REGIONS
    ids = torch.randint(BERT_SEP + 1, enc_cfg.vocab_size,
                        (CAPTION_IMAGES, L), device=dev, generator=gen)
    ids[:, 0] = BERT_CLS
    img = torch.randn(CAPTION_IMAGES, Li, model.cfg.img_feature_dim,
                      device=dev, generator=gen)
    mask = torch.cat([torch.ones(CAPTION_IMAGES, L, dtype=torch.long,
                                 device=dev),
                      region_mask(dev, Li)[:CAPTION_IMAGES]], dim=1)
    out, secs, launches = {}, {}, 0
    for mode, kw in (("greedy", {}), ("beam", {"num_beams": VCR_BEAMS})):
        for core in ("K1", "plain"):
            ctx = contextlib.nullcontext() if core == "K1" \
                else plain_core(model)
            with ctx:
                (res, secs[mode, core]), n = k1_delta(lambda: timed(
                    lambda: (generate_gpt2_captions(
                        model, ids, img, mask, BERT_CLS, GPT2_EOS,
                        CAPTION_LEN, mode, **kw), sync(dev))[0]))
            out[mode, core] = res
            launches += n
        where = first_divergence(out[mode, "K1"].tokens,
                                 out[mode, "plain"].tokens)
        check(where is None, f"captioner {mode}: tokens through K1 and the "
                             f"plain core differ at {where}")
    tokens = out["greedy", "K1"].tokens
    with torch.no_grad():
        memory, _ = model.encode(ids, img, mask)
        with plain_core(model):
            plain_memory, _ = model.encode(ids, img, mask)
        err = max((model.decode_step(tokens, memory, mask, t)
                   - model.decode_step(tokens, plain_memory, mask, t))
                  .abs().max().item() for t in range(CAPTION_LEN - 1))
    check(err <= VCR_TOL, f"captioner step logits differ by {err}")
    check(dev.type != "cuda" or launches == 2 * enc_cfg.num_hidden_layers,
          f"the captions launched K1 {launches} times")
    steps = CAPTION_LEN - 1
    print(f"#   GPT2Captioner (BERT-base encoder through K1, GPT-2 small), "
          f"{CAPTION_IMAGES} images of {L} tokens + {Li} regions, "
          f"{CAPTION_LEN} tokens: greedy and {VCR_BEAMS}-beam tokens "
          f"identical K1 vs plain core, step logits max_abs_err {err:.3e} "
          f"(tol {VCR_TOL:.0e}); ms a decode step (full recompute) "
          + ", ".join(f"{m} {c} {v * 1e3 / steps:.2f}"
                      for (m, c), v in secs.items())
          + f"; K1 {launches} launches (one encode a decode); on {card}")


def write_vcr_files(cfg, rng):
    """A small VCR-format json (one question per image, four choices, a
    gold label, objects) in synthetic words, a pickle of each image's
    region features, and the features again as TSV rows (key, shape, hex
    of float32 bytes)."""
    VCR_DIR.mkdir(parents=True, exist_ok=True)
    words = synthetic.VOCAB_WORDS
    feats, rows = {}, []
    for q in range(VCR_QUESTIONS):
        def sentence(n):
            return " ".join(rng.choice(words, n))
        rows.append({"q": sentence(8), "label": int(q % cfg.num_choices),
                     "choices": [sentence(int(rng.integers(4, 9)))
                                 for _ in range(cfg.num_choices)],
                     "img_id": f"vcr{q}", "annot_id": f"train-{q}",
                     "objects": ["person", "dog"]})
        feats[f"vcr{q}"] = rng.standard_normal(
            (VCR_REGIONS - 2 * q, cfg.img_feature_dim)).astype(np.float32)
    (VCR_DIR / VCRQAProcessor.train_file).write_text(json.dumps(rows))
    with open(VCR_DIR / "features.pkl", "wb") as f:
        pickle.dump(feats, f)
    tsv_writer(([k, ",".join(map(str, v.shape)), v.tobytes().hex()]
                for k, v in feats.items()), str(VCR_DIR / "features.tsv"))


def vcr_task_plane(cfg, dev):
    """The files through `VCRQAProcessor`, the pickle, `TSVFile` (read
    back bit-equal) and `convert_vl_examples` into (B, C, ...) tensors on
    `dev`, a row per (question, choice)."""
    examples = VCRQAProcessor().get_train_examples(str(VCR_DIR))
    with open(VCR_DIR / "features.pkl", "rb") as f:
        feats = pickle.load(f)
    tsv = TSVFile(str(VCR_DIR / "features.tsv"))
    for i in range(len(tsv)):
        key, shape, data = tsv[i]
        back = np.frombuffer(bytes.fromhex(data), np.float32).reshape(
            tuple(int(x) for x in shape.split(",")))
        check(back.tobytes() == feats[key].tobytes(),
              f"TSV features of {key} read back differently")
    tsv.close()
    pairs = [VLInstance(guid=f"{ex.guid}-{c}", text_a=ex.text_a,
                        text_b=choice, label=int(c == ex.label),
                        img_key=ex.img_key, q_id=ex.q_id)
             for ex in examples for c, choice in enumerate(ex.text_b)]
    tok = tiny_tokenizer(str(VCR_DIR / "tokenizer"))
    f = convert_vl_examples(pairs, feats, [0, 1], VCR_REGIONS,
                            cfg.max_hypo, tok)
    C = cfg.num_choices

    def t(x):
        x = torch.from_numpy(x).to(dev)
        return x.reshape((-1, C) + tuple(x.shape[1:]))
    return (t(f.input_ids).long(), t(f.img_feats), t(f.input_mask).long(),
            t(f.segment_ids).long(), t(f.label).long()), len(tsv)


def check_heads(card, dev, cfg, gpt2_cfg, enc, label, align_pos,
                total_label, rng, seed):
    """One forward each through K1 against the plain core (VCR_TOL): the
    baselines (both memory modes), the Oscar heads (the multiple-choice
    head on the task plane's files), the ensemble refiner and the
    abstract/specific gate; then `itm_eval` on a score matrix made on the
    card. Returns the K1 launches of the K1 forwards."""
    write_vcr_files(cfg, rng)
    (mc_ids, mc_img, mc_mask, mc_types, mc_label), n_tsv = \
        vcr_task_plane(cfg, dev)
    shutil.rmtree(VCR_DIR)
    ids, img, mask = enc["input_ids"], enc["img_feats"], enc["input_mask"]
    expl = torch.from_numpy(rng.integers(
        0, min(gpt2_cfg.vocab_size, GPT2_EOS), (ids.shape[0], 24))).to(dev)
    attn = torch.ones_like(expl)
    mlm = torch.full(ids.shape, -1, dtype=torch.long, device=dev)
    mlm[:, 2:5] = ids[:, 2:5]
    nsp = label.clone()
    errs, launches = {}, 0

    def both(name, model, fn):
        nonlocal launches
        with torch.no_grad():
            got, n = k1_delta(lambda: fn(model))
            with plain_core(model):
                want = fn(model)
        launches += n
        check(dev.type != "cuda" or n == cfg.encoder.num_hidden_layers,
              f"{name} launched K1 {n} times")
        errs[name] = close_all(got, want, name)
        return got
    base_cls = BaselineCLS(cfg, device=dev, seed=seed).eval()
    pred, scores = both("BaselineCLS", base_cls,
                        lambda m: m(ids, img, mask))
    both("BaselineCLS train", base_cls, lambda m: m(ids, img, mask, label))
    with torch.no_grad():
        pooled = base_cls.oscar(ids, img, mask)[1]
    del base_cls
    rat = BaselineRationale(cfg, gpt2_cfg=gpt2_cfg, device=dev,
                            seed=seed + 1).eval()
    for hypo_only in (False, True):
        rat.hypo_only_memory = rat.freeze_encoder = hypo_only
        both(f"BaselineRationale hypo_only={hypo_only}", rat,
             lambda m: m(ids, img, mask, expl, attn, label)[:2])
    del rat
    seq_cls = ImageBertSequenceClassifier(cfg, num_labels=3,
                                          classifier="mlp", device=dev,
                                          seed=seed + 2).eval()
    both("ImageBertSequenceClassifier", seq_cls,
         lambda m: m(ids, img, mask, labels=label))
    del seq_cls
    mc = OscarMultipleChoice(cfg, device=dev, seed=seed + 3).eval()
    mc_loss, mc_scores = both(
        "OscarMultipleChoice (task plane)", mc,
        lambda m: m(mc_ids, mc_img, mc_mask, mc_types, labels=mc_label))
    del mc
    pre = ImageBertPreTraining(cfg, device=dev, seed=seed + 4).eval()
    both("ImageBertPreTraining", pre,
         lambda m: m(ids, img, mask, masked_lm_labels=mlm,
                     next_sentence_label=nsp)[:3])
    del pre
    refiner = EnsembleRefiner(cfg, device=dev, seed=seed + 5).eval()
    gate = AbstractSpecificGate(cfg.encoder.hidden_size, device=dev,
                                seed=seed + 6)
    C = cfg.num_choices

    def refine(m):
        # each question's first row: the refined CLS as the abstract
        # scorer's feature, the baseline's pooled CLS as the specific one
        cls, align = m(**enc, align_pos=align_pos, total_label=total_label)
        return cls, align, gate(cls[::C], pooled[::C], scores,
                                scores.flip(-1))
    both("EnsembleRefiner + AbstractSpecificGate", refiner, refine)
    del refiner
    probs = torch.softmax(mc_scores.float(), dim=-1)[..., 1]
    sim = probs.cpu().numpy()
    gold = mc_label.argmax(-1).cpu().numpy()
    metrics = itm_eval(sim, txt2img_gold=gold)
    check(all(0.0 <= metrics[k] <= 1.0 for k in ("txt_r1", "img_r1",
                                                 "r_mean"))
          and torch.isfinite(mc_loss).item(),
          f"itm_eval on the card's scores gave {metrics}")
    print(f"#   heads through K1 vs the plain core, max_abs_err: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {VCR_TOL:.0e}); K1 {cfg.encoder.num_hidden_layers} a "
          f"forward")
    print(f"#   task plane: {VCR_QUESTIONS} VCR questions from json and "
          f"{n_tsv} region-feature rows from pickle and TSV (bit-equal) "
          f"through VCRQAProcessor and convert_vl_examples into "
          f"OscarMultipleChoice {tuple(mc_ids.shape)}: loss "
          f"{mc_loss.item():.6f}; itm_eval on its (question x choice) "
          f"scores: txt_r1 {metrics['txt_r1']:.3f}, r_mean "
          f"{metrics['r_mean']:.3f}; on {card}")
    return launches


def phase_k1_vcr_shapes(gen, row):
    """K1 against its plain version at the VCR plane's shapes (12 heads of
    64, B=16): Sq=Sk=100 with the joint key bias, and Sq=100 against
    Sk=103 and 150 (the history KV-concat), fp32 and bf16 to phase 2's
    bounds; timed in fp32 beside its plain version, SDPA (TF32 off) and
    its bound, with the profiler's device time a launch. Adds `vcr_*` keys
    to K1's row."""
    B = VCR_QUESTIONS * 4
    print("# phase 15: K1 fused_attention vs attention_reference at the VCR "
          "plane's shapes, 12 heads of 64, B=16")
    shapes = (("joint", 100, 100), ("history3", 100, 103),
              ("history50", 100, 150))
    for dtype in (torch.float32, torch.bfloat16):
        for name, Sq, Sk in shapes:
            q, k, v, bias = attention_inputs(B, Sq, Sk, dtype, "B11Sk", gen,
                                             N=12)
            err, share = attention_close(
                fused_attention(q, k, v, bias, 12),
                attention_reference(q, k, v, bias, 12),
                f"K1 12x64 {dtype} {name}")
            print(f"#   {str(dtype)[6:]:8s} {name:10s} Sq={Sq} Sk={Sk} "
                  f"max_abs_err={err:.3e} ({share:.2f} of its bound)")
    for name, Sq, Sk in shapes:
        q, k, v, bias = attention_inputs(B, Sq, Sk, torch.float32, "B11Sk",
                                         gen, N=12)
        err, _ = attention_close(fused_attention(q, k, v, bias, 12),
                                 attention_reference(q, k, v, bias, 12),
                                 f"K1 {name}")
        ms = cuda_time_ms(lambda: fused_attention(q, k, v, bias, 12))
        device_ms = kernel_device_ms(lambda: fused_attention(q, k, v, bias,
                                                             12))
        plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v, bias,
                                                            12))
        library_ms = sdpa_ms(q, k, v, bias, 12, 50)
        bound_ms, bound_by, byts, flops = attention_bound(q, k, bias, 12)
        shape = f"B={B} Sq={Sq} Sk={Sk} 12x64 float32 key bias"
        row.update({f"vcr_{name}_{key}": val for key, val in (
            ("shape", shape), ("max_abs_err", err), ("ms", ms),
            ("device_ms", device_ms), ("plain_ms", plain_ms),
            ("bound_ms", bound_ms), ("bound_by", bound_by),
            ("library_ms", library_ms))})
        print(f"#   {shape}: kernel {ms:.4f} ms (device {device_ms:.4f} ms "
              f"a launch, {earlier(f'vcr_{name}', device_ms)}), plain "
              f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}: {byts / 1e6:.2f} "
              f"MB, {flops / 1e9:.3f} GFLOP)")


def phase_vcr(args, card, dev, gen, row, ca_cfg=None, gpt2_cfg=None):
    """Phase 15, ChunkAlign and the VCR plane at full width (see the module
    docstring; the configurations default to the full ones). Returns the
    main path's launch counts."""
    strict_fp32()
    cfg = ca_cfg or ChunkAlignConfig(encoder=dataclasses.replace(
        EncoderConfig.bert_base(), use_pallas=True))
    gcfg = gpt2_cfg or GPT2Config()
    print(f"# phase 15: ChunkAlign and the VCR plane (ChunkAlignConfig(): "
          f"BERT-base with K1, {cfg.img_feature_dim}-d regions, max_hypo "
          f"{cfg.max_hypo}, chunk / cross-chunk / cross-modal layers "
          f"{cfg.chunk_layers} / {cfg.cross_chunk_layers} / "
          f"{cfg.cross_modal_layers}, {cfg.num_choices} choices; "
          f"GPT2Config(): {gcfg.n_layer} layers, {gcfg.n_embd} wide) at "
          f"full width, fp32 (TF32 off), random weights from --seed; "
          f"{VCR_QUESTIONS} questions x {cfg.num_choices} choices, "
          f"{VCR_REGIONS} regions")
    rng = np.random.default_rng(args.seed + 17)
    model = ChunkAlignRationale(cfg, gpt2_cfg=gcfg, device=dev,
                                seed=args.seed + 17).eval()
    enc, label, align_pos, total_label = vcr_inputs(cfg, dev, gen, rng)
    # the main path, driven from counts of 0
    zero_counts()
    check_chunkalign_cls(card, dev, model.core, enc, label, align_pos,
                         total_label)
    check_history(card, dev, model.core.global_enc, enc, gen)
    check_rationale(card, dev, model, enc, rng)
    del model
    captioner = GPT2Captioner(dataclasses.replace(
        gcfg, encoder=cfg.encoder, img_feature_dim=cfg.img_feature_dim),
        device=dev, seed=args.seed + 18).eval()
    check_captioner(card, dev, captioner, gen)
    del captioner
    check_heads(card, dev, cfg, gcfg, enc, label, align_pos, total_label,
                rng, args.seed + 19)
    counts = read_counts()
    print(f"#   phase 15's main path launched K1 "
          f"{counts['fused_attention']} times (12 a VL-encoder forward "
          f"through it); staged layers, CLS layers and the GPT-2 decoders "
          f"run the plain core, as in the JAX package")
    check(dev.type != "cuda" or counts["fused_attention"] > 0,
          "phase 15 launched K1 no time")
    check(all(counts[n] == 0 for n in COUNTERS if n != "fused_attention"),
          f"phase 15 launched another kernel: {counts}")
    torch.cuda.empty_cache()
    phase_k1_vcr_shapes(gen, row)
    row["vcr_launches"] = counts["fused_attention"]
    row["launches"] += counts["fused_attention"]
    return counts


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
    t_lap = [t_start]

    def lap(what):                   # each phase's seconds, for its budget
        now = time.perf_counter()
        print(f"#   ({what}: {now - t_lap[0]:.1f} s)")
        t_lap[0] = now
    try:
        dev, layers = torch.device("cuda", 0), (3, 8, 36, 3)
        base = ICKAConfig()
        card = phase_build()
        tokenizer, spec = prompt_tokenizer()
        lap("phase 1")
        phase_kernel_vs_plain(gen, spec, base)
        phase_head_widths(gen)
        phase_blockwise_vs_plain(gen)
        conv_errs = phase_conv_kernels_vs_plain(gen)
        lap("phase 2")
        counts, _, ctx = phase_slice(args, card, dev, base, layers, tokenizer)
        lap("phase 3")
        conv_counts = phase_int8_visual(args, card, dev, ctx, layers)
        lap("phase 4")
        int8_text_counts = phase_int8_text(args, card, dev, ctx)
        lap("phase 4b")
        packed_counts = phase_packed(args, card, dev, ctx)
        lap("phase 5")
        eval_counts = phase_evaluate(args, card, dev, ctx)
        lap("phase 6")
        file_counts = phase_image_files(args, card, dev, ctx)
        lap("phase 16")
        phase_k1_bert_heads(gen)
        gc_base = GateCLConfig()
        gc_serve_counts = phase_gate_cl_serving(args, card, dev, gc_base,
                                                ctx)
        lap("phase 9, serving")
        weights_counts = phase_weights(args, card, dev, gc_base, ctx, layers)
        lengths = [len(t["ori_input_ids"]) for t in ctx["texts"]]
        served = dp_requests(ctx)
        del ctx
        torch.cuda.empty_cache()
        lap("phase 10")
        train_counts = phase_train(args, card, dev, base, layers)
        lap("phase 8")
        gc_train_counts = phase_gate_cl_train(args, card, dev, gc_base,
                                              layers)
        lap("phase 9, training")
        remat_counts, _, _ = phase_remat(args, card, dev, base, gc_base,
                                         layers, lengths)
        lap("phase 11")
        # over the eleven main paths before phase 12, each driven from
        # counts of 0
        runs = [counts, conv_counts, int8_text_counts, packed_counts,
                eval_counts, file_counts, train_counts, gc_serve_counts,
                gc_train_counts, weights_counts, remat_counts]
        total = {name: sum(c.get(name, 0) for c in runs)
                 for name in (*COUNTERS, *CLUSTER_COUNTS)}
        kernels = phase_times(gen, counts["fused_attention"],
                              packed_counts["fused_attention"],
                              eval_counts["fused_attention"],
                              total["fused_attention_blockwise"],
                              int8_text_counts["fused_attention"],
                              train_counts["fused_attention"],
                              gc_serve_counts["fused_attention"]
                              + gc_train_counts["fused_attention"],
                              weights_counts["fused_attention"],
                              remat_counts["fused_attention"])
        kernels += phase_conv_times(gen, total, conv_errs)
        lap("phase 7")
        # K1's row (kernels[0]) takes this phase's launches and times
        gen_counts = phase_generation(args, card, dev, gen, kernels[0])
        lap("phase 14")
        vcr_counts = phase_vcr(args, card, dev, gen, kernels[0])
        lap("phase 15")
        # last: the older the process, the more of a short profiled
        # call's device records torch.profiler drops (none kept late in
        # it: tools/profiler_probe.py), so the phases that read the
        # profiler come first
        dp_counts, tp_counts = phase_dp(args, card, dev, base, layers,
                                        served)
        phase_k1_local_heads(gen, kernels[0])
        lap("phases 12 and 13")
        runs += [gen_counts, vcr_counts, dp_counts, tp_counts]
        total = {name: sum(c[name] for c in runs) for name in COUNTERS}
        print(f"#   kernel launches over the fifteen main paths: {total}")
        # K1's row counts phase 12's, 13's and 16's launches too; they
        # launched no other kernel (checked below), so the other rows'
        # counts stand
        k1 = kernels[0]
        k1["dp_launches"] = dp_counts["fused_attention"]
        k1["tp_launches"] = tp_counts["fused_attention"]
        k1["files_launches"] = file_counts["fused_attention"]
        k1["launches"] += (k1["dp_launches"] + k1["tp_launches"]
                           + k1["files_launches"])
        for name in NO_CALLER:
            check(total[name] == 0, f"{name} has no caller in the model, yet "
                                    f"the main paths launched it "
                                    f"{total[name]} times")
        # every launch of K1 and K2 on the main paths (heads of 64) ran a
        # wgmma body, path by path: the bf16 body in bf16, the 3xTF32 one
        # in fp32
        body = {key: sum(c.get(key, 0) for c in runs) for key in BODY_COUNTS}
        print(f"#   K1 and K2 launches of the wgmma bodies over the fifteen "
              f"main paths: {body}")
        for name in ATTENTION:
            for i, c in enumerate(runs):
                bf16 = c.get(f"{name}.bf16", 0)
                check(c.get(f"{name}.wgmma", 0) == bf16
                      and c.get(f"{name}.tf32_wgmma", 0) == c[name] - bf16,
                      f"main path {i}: {name} launched {bf16} times in bf16, "
                      f"{c.get(name + '.wgmma')} of them on the wgmma body, "
                      f"and {c[name] - bf16} times in fp32, "
                      f"{c.get(name + '.tf32_wgmma')} of them on the TF32 "
                      f"wgmma body")
        check(body["fused_attention.wgmma"] > 0
              and body["fused_attention.tf32_wgmma"] > 0,
              "no main path launched K1 on the bf16 or on the TF32 wgmma "
              "body")
        for k in kernels[:2]:
            k["wgmma_launches"] = body[f"{k['name']}.wgmma"]
            k["tf32_wgmma_launches"] = body[f"{k['name']}.tf32_wgmma"]
        for name in ("int8_bottleneck_v2", "int8_stem_pool"):
            for what, c in (("evaluation", eval_counts),
                            ("evaluation and training from files",
                             file_counts),
                            ("training", train_counts),
                            ("gate_cl serving", gc_serve_counts),
                            ("gate_cl training", gc_train_counts),
                            ("rematerialised training", remat_counts),
                            ("data-parallel serving", dp_counts),
                            ("tensor-parallel training and evaluation",
                             tp_counts)):
                check(c[name] == 0, f"{what} runs the float backbone, yet "
                                    f"launched {name}")
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
