#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`icka_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero:

  1. build every CUDA kernel from `icka_tpu_torch/kernels/csrc` (one nvcc
     per source, all started together) and print the card's name and power
     limit as nvidia-smi gives them;
  2. hold every kernel against its plain PyTorch version on the card at the
     main paths' shapes: K1 `fused_attention` in fp32 (TF32 off) and bf16
     within a tolerance; K3-K6, the int8 conv kernels, bit-equal at the four
     ResNet stage shapes in every output mode;
  3. serve requests through the flagship at full width (two 24-layer
     RoBERTa-large stacks, ResNet-152, random weights from `--seed`):
     uint8 images -> preprocess_images -> VisualBackbone ->
     BucketedICKAServer.predict, once with `use_pallas=True` (the kernel)
     and once with the plain attention core on the same weights, in fp32;
     then the kernel path once in bf16;
  4. serve the same requests with the int8-static visual half: phase 3's
     float ResNet-152 is calibrated in the dynamic int8 mode on the request
     images, quantised offline, and served with `fused_pallas=True` (K5 once
     and K4 46 times per backbone call) in front of phase 3's bf16 flagship;
     the same backbone on the kernels' plain versions must give a
     bit-identical `att`, and the fused stem the unfused stem's output;
  5. time each kernel at its main-path shape beside its plain version, the
     PyTorch library call for the same function where there is one, and its
     bound; time the served requests end to end.

The line before the last is the `{"kernels": [...]}` JSON object; the last
line is `{"ok": true, "device": {...}}`. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from icka_tpu_torch.core.config import ICKAConfig
from icka_tpu_torch.core.device import strict_fp32
from icka_tpu_torch.data.images import preprocess_images
from icka_tpu_torch.kernels import build
from icka_tpu_torch.kernels import conv as kconv
from icka_tpu_torch.kernels.attention import attention_reference, fused_attention
from icka_tpu_torch.models.convert import (calibration_amax,
                                           static_quantize_backbone)
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.models.resnet import (Bottleneck, ConvBN, StemPoolS2D,
                                          VisualBackbone)
from icka_tpu_torch.serving.bucketed import (BucketedICKAServer,
                                             sample_tweet_lengths)

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12           # int8 tensor cores, dense
# K1 against its plain version: fp32 differs only in summation order
# (tests/test_kernels.py holds the TPU kernel to the same 2e-5); bf16
# outputs are rounded to bf16 (an ulp is 1.6e-2 at 2-4) and probabilities
# are rounded to bf16 before P.V (tests/test_kernels.py: 6e-2)
K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 6e-2}
# full-width emissions, kernel vs plain core in fp32: summation order differs
# in every self-attention of 48 layers, each product summing 64 terms and
# each softmax up to 150; LayerNorm keeps the error from compounding
EMISSIONS_TOL = 1e-3
LAYERS_PER_BATCH = 24 + 24        # self-attention layers of both stacks
OFFSET, MASK_POSITIONS, MAX_BATCH, REQUESTS = 14, (3, 11), 8, 16
# the int8 conv kernels against their plain versions: bit-equal (exact
# integer sums, the same fp32 multiplies, adds and roundings)
CONV_STAGES = ((56, 64), (28, 128), (14, 256), (7, 512))    # (H, Cw)
CONV_SOURCE = "icka_tpu_torch/kernels/csrc/int8_conv.cu"
CHECK_CONV_LAUNCHES = True        # a CPU rehearsal launches no kernel
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
    else:
        bias = (torch.randn(B, Sq, Sk, device=dev, generator=gen)
                + key_bias[:, None, :])
    return q, k, v, bias


def phase_build():
    t0 = time.perf_counter()
    build.build()
    print(f"# phase 1: built {list(build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def phase_kernel_vs_plain(gen):
    print("# phase 2: K1 fused_attention vs attention_reference "
          "(B=8, 16 heads x 64)")
    for dtype in (torch.float32, torch.bfloat16):
        for Sq, Sk in ((23, 23), (150, 150), (150, 23)):
            for kind in ("B11Sk", "BSk", "BSqSk"):
                q, k, v, bias = attention_inputs(8, Sq, Sk, dtype, kind, gen)
                out = fused_attention(q, k, v, bias, 16)
                torch.cuda.synchronize()
                want = attention_reference(q, k, v, bias, 16)
                check(out.dtype == dtype and out.shape == q.shape,
                      f"K1 output {out.dtype} {tuple(out.shape)}")
                err = (out.float() - want.float()).abs().max().item()
                tol = K1_TOL[dtype]
                print(f"#   {str(dtype)[6:]:8s} Sq={Sq:3d} Sk={Sk:3d} "
                      f"bias={kind:6s} max_abs_err={err:.3e} tol={tol:.0e}")
                check(err <= tol, f"K1 {dtype} Sq={Sq} Sk={Sk} {kind}: "
                                  f"{err} > {tol}")


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


def make_requests(cfg, n, rng):
    lens = sample_tweet_lengths(n, rng)
    if lens.max() <= 64:             # cover the long buckets too
        lens[-1] = rng.integers(65, cfg.max_seq_length + 1)
    vocab = cfg.embedding.vocab_size
    texts = [{
        "ori_input_ids": rng.integers(3, vocab, int(L)),
        "input_ids": rng.integers(3, vocab, OFFSET + int(L)),
        "clip_features": rng.standard_normal(cfg.clip_dim).astype(np.float32),
    } for L in lens]
    images = rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
    return texts, images


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
             if "fused_attention_kernel" in e.key and e not in rows]
    return (sum(dev_us(e) for e in kernels) / 1e6,
            [(e.key, dev_us(e) / 1e3, e.count) for e in rows])


def first_batch_emissions(server, examples, models):
    """Emissions of each model on the server's first device batch."""
    with torch.inference_mode():
        _, _, _, batch = next(server.batches(examples))
        kw = {k: v for k, v in batch.items() if k != "output_mask"}
        return [m.emissions(mask_positions=MASK_POSITIONS, offset=OFFSET,
                            **kw)[0] for m in models]


def agreement(a, b):
    same = sum(int((x == y).sum()) for x, y in zip(a, b))
    return same / sum(len(x) for x in a)


def phase_slice(args, card, dev, base, resnet_layers):
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
    texts, images = make_requests(base, REQUESTS, rng)
    calibrate_batch_stats(backbone, preprocess_images(images, 224, dev))
    backbone16.load_state_dict(backbone.state_dict(), assign=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"#   built ICKA ({n_params / 1e6:.1f} M params) + ResNet-152 in "
          f"{time.perf_counter() - t0:.1f} s; request lengths "
          f"{[len(t['ori_input_ids']) for t in texts]}")

    servers = {name: BucketedICKAServer(m, max_batch=MAX_BATCH,
                                        offset=OFFSET,
                                        mask_positions=MASK_POSITIONS,
                                        device=dev)
               for name, m in (("kernel", model), ("plain", plain),
                               ("kernel_bf16", model16))}
    backbones = {"kernel": backbone, "plain": backbone,
                 "kernel_bf16": backbone16}
    runs = {}
    for name in ("kernel", "plain", "kernel_bf16"):
        fused_attention.launches = 0
        tags, stats, examples, _ = serve(servers[name], backbones[name],
                                         texts, images)
        launches = fused_attention.launches
        n_batches = sum(stats.batches_per_bucket.values())
        runs[name] = dict(tags=tags, stats=stats, examples=examples,
                          launches=launches, batches=n_batches)
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
        servers["kernel"], runs["kernel"]["examples"], (model, plain))
    check(bool(torch.isfinite(em_k).all()), "non-finite emissions")
    em_err = (em_k - em_p).abs().max().item()
    agree = agreement(runs["kernel"]["tags"], runs["plain"]["tags"])
    agree16 = agreement(runs["kernel_bf16"]["tags"], runs["kernel"]["tags"])
    print(f"#   fp32 emissions kernel vs plain: max_abs_err {em_err:.3e} "
          f"(tol {EMISSIONS_TOL:.0e}, |emissions| max "
          f"{em_k.abs().max().item():.3f})")
    print(f"#   tag agreement kernel vs plain (fp32): {agree:.6f}")
    (em_16,) = first_batch_emissions(
        servers["kernel_bf16"], runs["kernel_bf16"]["examples"], (model16,))
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
    ctx = dict(texts=texts, images=images, backbone=backbone,
               backbone_bf16=backbone16, server_bf16=servers["kernel_bf16"],
               tags_bf16=runs["kernel_bf16"]["tags"],
               max_seq_length=base.max_seq_length,
               num_labels=base.num_labels)
    return runs["kernel"]["launches"], pairs_per_s, ctx


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
    Returns the launch counts of K5 and K4 over the main-path run."""
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
    counters = (kconv.int8_stem_pool, kconv.int8_bottleneck_v2,
                fused_attention)
    for c in counters:
        c.launches = 0
    tags, stats, _, _ = serve(server, models["fused"], texts, images)
    k5, k4, k1 = (c.launches for c in counters)
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
    return {"int8_stem_pool": k5, "int8_bottleneck_v2": k4}


def phase_times(gen, launches):
    B, S, N, hd, dtype = 128, 150, 16, 64, torch.bfloat16
    print(f"# phase 5: K1 at the main-path shape B={B} Sq=Sk={S} {N}x{hd} "
          f"bf16, key-mask bias")
    q, k, v, bias = attention_inputs(B, S, S, dtype, "B11Sk", gen)
    out = fused_attention(q, k, v, bias, N)
    want = attention_reference(q, k, v, bias, N)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    check(err <= K1_TOL[dtype], f"K1 at the timed shape: {err}")
    ms = cuda_time_ms(lambda: fused_attention(q, k, v, bias, N))
    plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v, bias, N))
    q4, k4, v4 = (t.view(B, S, N, hd).transpose(1, 2) for t in (q, k, v))
    mask = bias.to(dtype)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask))
    elt = q.element_size()
    nbytes = 4 * B * S * N * hd * elt + bias.numel() * 4
    flops = 4 * B * N * S * S * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    row = {"name": "fused_attention", "route": "cuda",
           "source": "icka_tpu_torch/kernels/csrc/fused_attention.cu",
           "replaces": "icka_tpu/kernels/attention.py:87",
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "on_main_path": True}
    print(f"#   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP)")
    return [row]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_row(name, replaces, shape, launches, err, ms, plain_ms, unfused_ms,
             byts, ops):
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS * 1e3
    row = {"name": name, "route": "cuda", "source": CONV_SOURCE,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "unfused_ms": unfused_ms, "shape": shape,
           # K3 and K6 have no caller in the model, here as in the JAX package
           "on_main_path": launches > 0}
    print(f"#   {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"unfused port path {unfused_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {byts / 1e6:.1f} MB,"
          f" {ops / 1e9:.2f} GOP); no single PyTorch call computes it")
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
    print(f"# phase 5: K3-K6 at B={B}; bound = max(bytes / 3.35e12, ops / "
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
        nbytes(*args) + out_bytes, 2 * B * 56 * 56 * K * N))
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
            max(t[0], errs["int8_bottleneck_v2"]), *t[1:], byts, ops)
        if H == 14:
            t = timed(lambda: kconv.int8_bottleneck(*args, 0.37),
                      lambda: kconv.bottleneck_reference(*args, 0.37),
                      lambda: block(x16), "int8_bottleneck")
            k6_row = conv_row(
                "int8_bottleneck", "icka_tpu/kernels/conv.py:204", shape, 0,
                max(t[0], errs["int8_bottleneck"]), *t[1:], byts, ops)
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
        f"B={B} x_pad ({H + 2},{H + 2},{C}) -> ({H},{H},{C}) bf16", 0,
        max(t[0], errs["int8_conv3x3"]), *t[1:],
        nbytes(*args) + B * H * H * C * 2, 2 * B * H * H * 9 * C * C))
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
    try:
        dev, layers = torch.device("cuda", 0), (3, 8, 36, 3)
        card = phase_build()
        phase_kernel_vs_plain(gen)
        conv_errs = phase_conv_kernels_vs_plain(gen)
        launches, _, ctx = phase_slice(args, card, dev, ICKAConfig(), layers)
        conv_launches = phase_int8_visual(args, card, dev, ctx, layers)
        del ctx
        torch.cuda.empty_cache()
        kernels = phase_times(gen, launches)
        kernels += phase_conv_times(gen, conv_launches, conv_errs)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
