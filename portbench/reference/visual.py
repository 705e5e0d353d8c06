"""Plain reference of the served visual half: ImageNet preprocessing and
ResNet (torchvision layout, Bottleneck blocks, NCHW float weights with
frozen BatchNorm) served statically quantised, on the float state dict
the benchmark makes, keyed as the served backbone's is (`resnet.stem.*`,
`resnet.layer<s>_<b>.conv<i>.*`, `...downsample.*`).

It works out again everything the program's set-up derives:
  - the activation scales, from a dynamic quantised forward over the
    calibration images (each convolution quantises its input by the
    batch's abs-max, and that abs-max is the calibration record);
  - the static state: BatchNorm folded into the weights, the folded
    (k*k*Cin, Cout) matrix quantised per output column, the folded bias,
    act_scale = max(amax, 1e-8) / qmax;
  - the served forward: the stem quantised, its integer products summed
    exactly, scaled, rounded to bf16, biased, ReLU, 3x3/s2 max-pool; each
    stage's first block in bf16 between quantised convolutions; every
    other block integer-resident (its input in its first convolution's
    domain, the two inner activations requantised to [0, qmax], the
    output requantised into the next block's domain, or bf16 for a
    stage's last block), as the served identity blocks compute.

Integer products are float64 matrix products (exact: every partial sum is
an integer far below 2**53). `qmax` is 127 for int8 and 7 for the int4
control. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(images, crop: int):
    """uint8 (B, S, S, 3) -> centre crop, /255, ImageNet mean/std, fp32
    NHWC."""
    x = torch.as_tensor(images)
    o = (x.shape[1] - crop) // 2
    x = x[:, o:o + crop, o:o + crop, :].float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def block_names(layers):
    """[(name, stage, index)] in forward order."""
    return [(f"layer{s + 1}_{b}", s, b)
            for s, n in enumerate(layers) for b in range(n)]


def conv_paths(layers):
    """(path, kernel, stride) of every convolution in forward order."""
    out = [("resnet.stem", 7, 2)]
    for name, s, b in block_names(layers):
        stride = 2 if (b == 0 and s > 0) else 1
        p = f"resnet.{name}"
        out += [(f"{p}.conv1", 1, 1), (f"{p}.conv2", 3, stride),
                (f"{p}.conv3", 1, 1)]
        if b == 0:
            out.append((f"{p}.downsample", 1, stride))
    return out


# ---- float forward (the weights maker's BatchNorm calibration) ----------


def float_forward(sd, x, layers, calibrate: bool = False):
    """fp32 NCHW forward of the float network; with `calibrate`, each
    convolution's BatchNorm statistics are first set to the mean and
    variance of its raw output on this batch (in forward order, so every
    layer sees calibrated inputs) and `sd` is written in place."""

    def convbn(path, x, k, s):
        w = sd[f"{path}.conv.weight"]
        if calibrate:
            raw = F.conv2d(x, w, stride=s, padding=k // 2)
            sd[f"{path}.mean"].copy_(raw.mean(dim=(0, 2, 3)))
            sd[f"{path}.var"].copy_(raw.var(dim=(0, 2, 3), unbiased=False))
        inv = sd[f"{path}.scale"] * torch.rsqrt(sd[f"{path}.var"] + 1e-5)
        y = F.conv2d(x, w * inv[:, None, None, None], stride=s,
                     padding=k // 2)
        return y + (sd[f"{path}.bias"] - sd[f"{path}.mean"] * inv)[:, None,
                                                                  None]

    x = F.max_pool2d(F.relu(convbn("resnet.stem", x, 7, 2)), 3, 2, 1)
    for name, s, b in block_names(layers):
        p = f"resnet.{name}"
        stride = 2 if (b == 0 and s > 0) else 1
        out = F.relu(convbn(f"{p}.conv1", x, 1, 1))
        out = F.relu(convbn(f"{p}.conv2", out, 3, stride))
        out = convbn(f"{p}.conv3", out, 1, 1)
        if b == 0:
            x = convbn(f"{p}.downsample", x, 1, stride)
        x = F.relu(out + x)
    return x


# ---- quantised arithmetic ------------------------------------------------


def int_dot(a, w):
    """Exact integer sums of a (..., K) x (K, F) product of small
    integers."""
    return (a.double() @ w.double()).to(torch.int32)


def quantize(x, scale, qmax: int):
    return (x.float() / scale).round().clamp(-qmax, qmax).to(torch.int8)


def im2col(x, k: int, s: int):
    """NHWC patches of a k x k convolution of stride s, padding k // 2,
    tap major then channel."""
    if k == 1:
        return x[:, ::s, ::s, :]
    pad = k // 2
    H, W = x.shape[1:3]
    Ho, Wo = (H + 2 * pad - k) // s + 1, (W + 2 * pad - k) // s + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    return torch.cat([xp[:, i:i + (Ho - 1) * s + 1:s,
                         j:j + (Wo - 1) * s + 1:s, :]
                      for i in range(k) for j in range(k)], dim=-1)


def folded_matrix(sd, path):
    """Torch form of the fold, as the dynamic mode folds at each call:
    ((k*k*Cin, Cout) weight, bias)."""
    inv = sd[f"{path}.scale"] * torch.rsqrt(sd[f"{path}.var"] + 1e-5)
    w = sd[f"{path}.conv.weight"] * inv[:, None, None, None]
    return (w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]),
            sd[f"{path}.bias"] - sd[f"{path}.mean"] * inv)


def max_scale(amax, qmax: int):
    return amax.clamp_min(1e-8) / amax.new_tensor(float(qmax))


def pool_stem(y):
    """ReLU'd (B, H, W, C) -> 3x3/s2 max-pool, padding 1."""
    y = y.permute(0, 3, 1, 2)
    return F.max_pool2d(y.float(), 3, 2, 1).to(y.dtype).permute(0, 2, 3, 1)


def adaptive_grid(feat, size: int):
    """(B, H, W, C) -> (B, size, size, C) by adaptive average pooling (the
    identity at H = W = size)."""
    H, W = feat.shape[1:3]
    if (H, W) == (size, size):
        return feat.contiguous()

    def matrix(n_in):
        m = np.zeros((size, n_in), np.float32)
        for i in range(size):
            lo, hi = (i * n_in) // size, -(-((i + 1) * n_in) // size)
            m[i, lo:hi] = 1.0 / (hi - lo)
        return torch.from_numpy(m).to(feat.device)

    return torch.einsum("oh,pw,bhwc->bopc", matrix(H), matrix(W),
                        feat.float()).to(feat.dtype)


def dynamic_calibration(sd, pixels, layers, qmax: int = 127):
    """{conv path: abs-max of its input} over one dynamic forward of the
    calibration batch `pixels` (NHWC fp32): weights quantised per column
    from the torch fold, each input by its own abs-max, bf16 between
    convolutions."""
    amax = {}

    def conv(path, x, k, s):
        w, bias = folded_matrix(sd, path)
        w_s = max_scale(w.float().abs().amax(dim=0), qmax)
        wq = quantize(w, w_s[None, :], qmax)
        a = x.float().abs().amax()
        amax[path] = a
        a_s = max_scale(a, qmax)
        acc = int_dot(im2col(quantize(x, a_s, qmax), k, s), wq)
        return (acc.float() * (a_s * w_s)).to(torch.bfloat16) \
            + bias.to(torch.bfloat16)

    x = pool_stem(F.relu(conv("resnet.stem", pixels, 7, 2)))
    for name, s, b in block_names(layers):
        p = f"resnet.{name}"
        stride = 2 if (b == 0 and s > 0) else 1
        out = F.relu(conv(f"{p}.conv1", x, 1, 1))
        out = F.relu(conv(f"{p}.conv2", out, 3, stride))
        out = conv(f"{p}.conv3", out, 1, 1)
        if b == 0:
            x = conv(f"{p}.downsample", x, 1, stride)
        x = F.relu(out + x)
    return {k: np.float32(v.item()) for k, v in amax.items()}


def static_state(sd, calib, layers, qmax: int = 127):
    """The static serving state of every convolution, in numpy fp32 as a
    deployment's offline quantiser computes it: {path: (wq, w_scale,
    fused_bias, act_scale)}."""
    out = {}
    for path, _, _ in conv_paths(layers):
        kernel = sd[f"{path}.conv.weight"].detach().cpu().numpy() \
            .astype(np.float32).transpose(2, 3, 1, 0)
        get = (lambda k: sd[f"{path}.{k}"].detach().cpu().numpy()
               .astype(np.float32))
        inv = get("scale") / np.sqrt(get("var") + 1e-5)
        w = (kernel * inv[None, None, None, :]).reshape(-1, kernel.shape[-1])
        w_scale = np.maximum(np.abs(w).max(axis=0), 1e-8) / float(qmax)
        wq = np.clip(np.round(w / w_scale[None, :]), -qmax, qmax) \
            .astype(np.int8)
        act = np.float32(max(float(calib[path]), 1e-8) / float(qmax))
        out[path] = (wq, w_scale.astype(np.float32),
                     get("bias") - get("mean") * inv, act)
    return out


def static_forward(state, pixels, layers, att_size: int = 7,
                   qmax: int = 127):
    """(pooled (B, C), grid (B, att, att, C)) in bf16 of the served
    network on NHWC fp32 `pixels`."""
    dev = pixels.device
    t = {p: tuple(torch.from_numpy(np.asarray(v)).to(dev) for v in vals)
         for p, vals in state.items()}

    def conv(path, x, k, s):
        wq, w_s, bias, a_s = t[path]
        acc = int_dot(im2col(quantize(x, a_s, qmax), k, s), wq)
        return (acc.float() * (a_s * w_s)).to(torch.bfloat16) \
            + bias.to(torch.bfloat16)

    def resident(p, xq, a0, aN, last):
        """One integer-resident block on its input in its conv1 domain."""
        (w1, ws1, b1, _), (w2, ws2, b2, q2), (w3, ws3, b3, q3) = (
            t[f"{p}.conv{i}"] for i in (1, 2, 3))
        s1, c1 = (a0 * ws1 / q2).float(), b1 / q2
        s2, c2 = (q2 * ws2 / q3).float(), b2 / q3
        s3, c3 = (q3 * ws3 / aN).float(), b3 / aN
        a1 = torch.relu(int_dot(xq, w1).float() * s1 + c1)
        a1q = a1.round().clamp(0, qmax).to(torch.int8)
        a2 = torch.relu(int_dot(im2col(a1q, 3, 1), w2).float() * s2 + c2)
        a2q = a2.round().clamp(0, qmax).to(torch.int8)
        y = int_dot(a2q, w3).float() * s3 + c3 \
            + xq.float() * (a0 / aN).float().reshape(())
        y = torch.relu(y)
        if last:
            return y.to(torch.bfloat16)
        return y.round().clamp(0, qmax).to(torch.int8)

    x = pool_stem(F.relu(conv("resnet.stem", pixels, 7, 2)))
    names = block_names(layers)
    for i, (name, s, b) in enumerate(names):
        p = f"resnet.{name}"
        stride = 2 if (b == 0 and s > 0) else 1
        if b == 0:
            out = F.relu(conv(f"{p}.conv1", x, 1, 1))
            out = F.relu(conv(f"{p}.conv2", out, 3, stride))
            out = conv(f"{p}.conv3", out, 1, 1)
            x = F.relu(out + conv(f"{p}.downsample", x, 1, stride))
            continue
        last = b == layers[s] - 1
        a0 = t[f"{p}.conv1"][3]
        aN = (torch.ones_like(a0) if last
              else t[f"resnet.{names[i + 1][0]}.conv1"][3])
        xq = x if x.dtype == torch.int8 else quantize(x, a0, qmax)
        x = resident(p, xq, a0, aN, last)
    grid = adaptive_grid(x, att_size)
    return x.mean(dim=(1, 2)), grid
