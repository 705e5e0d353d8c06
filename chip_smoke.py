#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`icka_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero:

  1. build every CUDA kernel from `icka_tpu_torch/kernels/csrc` (one nvcc
     per source, all started together) and print the card's name and power
     limit as nvidia-smi gives them;
  2. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes, in fp32 (TF32 off) and bf16;
  3. serve requests through the flagship at full width (two 24-layer
     RoBERTa-large stacks, ResNet-152, random weights from `--seed`):
     uint8 images -> preprocess_images -> VisualBackbone ->
     BucketedICKAServer.predict, once with `use_pallas=True` (the kernel)
     and once with the plain attention core on the same weights, in fp32;
     then the kernel path once in bf16;
  4. time each kernel at the main-path shape beside its plain version, the
     PyTorch library call for the same function, and its bound; time the
     served requests end to end.

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
from icka_tpu_torch.kernels.attention import attention_reference, fused_attention
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.models.resnet import ConvBN, VisualBackbone
from icka_tpu_torch.serving.bucketed import (BucketedICKAServer,
                                             sample_tweet_lengths)

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
    return runs["kernel"]["launches"], pairs_per_s


def phase_times(gen, launches):
    B, S, N, hd, dtype = 128, 150, 16, 64, torch.bfloat16
    print(f"# phase 4: K1 at the main-path shape B={B} Sq=Sk={S} {N}x{hd} "
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
           "library_ms": library_ms}
    print(f"#   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP)")
    return [row]


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
        card = phase_build()
        phase_kernel_vs_plain(gen)
        launches, _ = phase_slice(args, card, torch.device("cuda", 0),
                                  ICKAConfig(), (3, 8, 36, 3))
        kernels = phase_times(gen, launches)
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
