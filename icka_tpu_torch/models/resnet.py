"""ResNet visual backbone, float path (port of `icka_tpu.models.resnet`,
`quant="none"`).

torchvision-style ResNet-152 (Bottleneck [3, 8, 36, 3]) with the
`myResnet` triple output:

    pooled (B, 2048)        global average pool
    fc     (B, 2048)        spatial mean (the same value, kept for parity)
    att    (B, 7, 7, 2048)  the 7x7 region grid consumed by the fusion

Public tensors are NHWC, as in the JAX package. Inside, the convolutions
are `torch.nn.functional.conv2d` over NCHW-shaped tensors in channels-last
memory. BatchNorm runs in inference mode with its running statistics,
folded into the conv weights at each call: BN(conv(x, W)) = conv(x, W*inv)
+ (beta - mean*inv), inv = scale * rsqrt(var + 1e-5). The stem is the plain
7x7/s2 conv + ReLU + 3x3/s2 max-pool, which the JAX package's
space-to-depth stem equals up to summation order. The int8 paths and their
fused kernels are not ported.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device


class _ConvKernel(nn.Module):
    """Bare OIHW conv weight, under the flax `conv/kernel` path."""

    def __init__(self, out_ch, in_ch, k, device, generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k,
                                               device=device))
        # flax variance_scaling(2.0, "fan_out", "truncated_normal")
        std = math.sqrt(2.0 / (out_ch * k * k)) / .87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


class ConvBN(nn.Module):
    """conv (no bias) + frozen-statistics batchnorm folded into the conv."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 stride: int = 1, dtype=torch.float32, device="cuda",
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.conv = _ConvKernel(features, in_ch, kernel, dev,
                                generator_for(dev, None, generator))
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x):
        inv = self.scale * torch.rsqrt(self.var + 1e-5)
        w = (self.conv.weight * inv[:, None, None, None]).to(self.dtype)
        fused_bias = (self.bias - self.mean * inv).to(self.dtype)
        y = F.conv2d(x.to(self.dtype), w, stride=self.stride,
                     padding=self.kernel // 2)
        return y + fused_bias[:, None, None]


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand (x4) with projection shortcut."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 project: bool = False, dtype=torch.float32, device="cuda",
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev,
                  generator=generator_for(dev, None, generator))
        self.conv1 = ConvBN(in_ch, width, 1, **kw)
        self.conv2 = ConvBN(width, width, 3, stride, **kw)
        self.conv3 = ConvBN(width, width * 4, 1, **kw)
        self.downsample = (ConvBN(in_ch, width * 4, 1, stride, **kw)
                           if project else None)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet(nn.Module):
    """torchvision-layout ResNet over NCHW-shaped tensors;
    `layers=(3, 8, 36, 3)` is ResNet-152."""

    def __init__(self, layers: Sequence[int] = (3, 8, 36, 3),
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev,
                  generator=generator_for(dev, None, generator))
        self.stem = ConvBN(3, 64, 7, 2, **kw)
        self.blocks = []
        in_ch = 64
        for stage, n in enumerate(layers):
            width = 64 * (2 ** stage)
            for b in range(n):
                name = f"layer{stage + 1}_{b}"
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(name, Bottleneck(in_ch, width, stride,
                                                 project=(b == 0), **kw))
                self.blocks.append(name)
                in_ch = width * 4

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.stem(x)), 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) averaging matrix with torch `adaptive_avg_pool2d`'s
    region arithmetic along one axis."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        lo = (i * n_in) // n_out
        hi = -(-((i + 1) * n_in) // n_out)   # ceil
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


class VisualBackbone(nn.Module):
    """`myResnet`-equivalent triple output over NHWC images:
    (pooled (B, C), fc (B, C), att (B, att_size, att_size, C))."""

    def __init__(self, layers: Sequence[int] = (3, 8, 36, 3),
                 att_size: int = 7, dtype=torch.float32, device="cuda",
                 seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.att_size = att_size
        self.resnet = ResNet(layers, dtype=dtype, device=dev,
                             generator=generator_for(dev, seed, generator))

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feat = self.resnet(x).permute(0, 2, 3, 1)            # NHWC view
        B, H, W, C = feat.shape
        fc = feat.mean(dim=(1, 2))
        if (H, W) != (self.att_size, self.att_size):
            # true adaptive_avg_pool2d: two small matrix contractions
            ph = torch.from_numpy(_adaptive_pool_matrix(H, self.att_size))
            pw = torch.from_numpy(_adaptive_pool_matrix(W, self.att_size))
            att = torch.einsum("oh,pw,bhwc->bopc", ph.to(feat.device),
                               pw.to(feat.device), feat.float()) \
                .to(feat.dtype)
        else:
            att = feat.contiguous()
        return fc, fc, att
