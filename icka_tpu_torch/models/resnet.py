"""ResNet visual backbone (port of `icka_tpu.models.resnet`): the float
path and the int8 serving paths.

torchvision-style ResNet-152 (Bottleneck [3, 8, 36, 3]) with the
`myResnet` triple output:

    pooled (B, 2048)        global average pool
    fc     (B, 2048)        spatial mean (the same value, kept for parity)
    att    (B, 7, 7, 2048)  the 7x7 region grid consumed by the fusion

Public tensors are NHWC, as in the JAX package. Inside, activations travel
between modules as NCHW-shaped tensors in channels-last memory, so the NHWC
view every int8 module works on costs nothing.

`quant="none"`: the convolutions are `torch.nn.functional.conv2d`.
BatchNorm runs in inference mode with its running statistics, folded into
the conv weights at each call: BN(conv(x, W)) = conv(x, W*inv) +
(beta - mean*inv), inv = scale * rsqrt(var + 1e-5). The stem is the plain
7x7/s2 conv + ReLU + 3x3/s2 max-pool, which the JAX package's
space-to-depth stem equals up to summation order.

`quant="int8"` (dynamic, the calibration mode): every `ConvBN` quantises its
folded weights per output channel and its input per tensor at each call,
contracts im2col patches in exact integers, and records the largest |x| it
has seen (`calib_amax`, max-merged over calls).

`quant="int8_static"` (serving): weights are quantised offline
(`icka_tpu_torch.models.convert.static_quantize_backbone`) and each `ConvBN`
holds `wq`, `w_scale`, `fused_bias` and one calibrated `act_scale` as
buffers. With `dtype=torch.bfloat16`, `fused_stem` sends the stem's tail
through the `int8_stem_pool` kernel and `fused_pallas` also sends every
identity bottleneck through `int8_bottleneck_v2`, int8-resident between the
blocks of a stage (the flags keep the JAX package's names). The integer
products outside those kernels are `int8_matmul` (`torch._int_mm`), exact on
the CPU and on the card. `wq` stays row-major (K, F), the layout of the state
dict, of the JAX package and of every public kernel wrapper, and on the
card the unfused path's product copies it column-major at each call. The
kernels read their weights K-major instead:
each `ConvBN` keeps that copy (`kmajor_tiles()`), derived from `wq` and out
of the state dict; `Bottleneck._fused` passes the three copies to the
bottleneck kernel and `StemPoolS2D` its own (of its space-to-depth weight)
to the stem kernel.

`plain_kernels=True` selects the kernels' plain PyTorch versions instead of
the wrappers. It exists for tests and `chip_smoke.py`; nothing in the
package sets it.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.kernels.conv import (_int8_bottleneck_v2_tiled,
                                         _int8_stem_pool_tiled,
                                         bottleneck_v2_reference,
                                         kmajor_tiles, stem_pool_reference)
from icka_tpu_torch.nn.layers import QUANT_MODES
from icka_tpu_torch.nn.quant import (abs_max_scale, int8_matmul,
                                     quantize_activation,
                                     quantize_weight_cols)


def _im2col(x, k: int, s: int):
    """NHWC (B, H, W, C) -> (B, Ho, Wo, k*k*C) patches, tap major, for a
    k x k conv of stride s and padding k // 2."""
    if k == 1:
        return x[:, ::s, ::s, :]
    pad = k // 2
    H, W = x.shape[1:3]
    Ho, Wo = (H + 2 * pad - k) // s + 1, (W + 2 * pad - k) // s + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    return torch.cat([xp[:, i:i + (Ho - 1) * s + 1:s,
                         j:j + (Wo - 1) * s + 1:s, :]
                      for i in range(k) for j in range(k)], dim=-1)


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
    """conv (no bias) + frozen-statistics batchnorm folded into the conv,
    over NCHW-shaped tensors. `quant="int8_static"` declares the serving
    layout instead of the float parameters: `wq` (k*k*Cin, F) int8 tap
    major, `w_scale` (F,), `fused_bias` (F,), `act_scale` ()."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 stride: int = 1, dtype=torch.float32, quant: str = "none",
                 device="cuda", generator=None):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got "
                             f"{quant!r}")
        dev = resolve_device(device)
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.quant = quant
        if quant == "int8_static":
            self.register_buffer("wq", torch.zeros(
                kernel * kernel * in_ch, features, dtype=torch.int8,
                device=dev))
            self.register_buffer("w_scale", torch.full(
                (features,), 1.0 / 127.0, device=dev))
            self.register_buffer("fused_bias",
                                 torch.zeros(features, device=dev))
            self.register_buffer("act_scale",
                                 torch.full((), 1.0 / 127.0, device=dev))
            return
        self.conv = _ConvKernel(features, in_ch, kernel, dev,
                                generator_for(dev, None, generator))
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))
        if quant == "int8":
            # the calibration record: max |x| over every call so far
            self.register_buffer("calib_amax", torch.zeros((), device=dev),
                                 persistent=False)

    def folded(self):
        """The float weights with BatchNorm folded in: (OIHW weight,
        fused bias)."""
        inv = self.scale * torch.rsqrt(self.var + 1e-5)
        return (self.conv.weight * inv[:, None, None, None],
                self.bias - self.mean * inv)

    def int8_operands(self, x):
        """(wq, w_scale, fused_bias, act_scale) for input `x`: the stored
        ones in static mode; in dynamic mode quantised here from the folded
        float weights and from max |x|, which is recorded."""
        if self.quant == "int8_static":
            return self.wq, self.w_scale, self.fused_bias, self.act_scale
        folded, fused_bias = self.folded()
        wq, w_s = quantize_weight_cols(
            folded.permute(2, 3, 1, 0).reshape(-1, folded.shape[0]))
        amax = x.float().abs().amax()
        self.calib_amax.copy_(torch.maximum(self.calib_amax, amax))
        return wq, w_s, fused_bias, abs_max_scale(amax)

    def kmajor_tiles(self):
        """`wq` as the int8 kernels read it (`kernels.conv.kmajor_tiles`;
        `_kmajor_layout` says of which weight): a derived copy, not in the
        state dict, made at the first call after `wq` is set, loaded,
        written in place or moved, and kept until then."""
        key = (self.wq.device, self.wq.data_ptr(), self.wq._version)
        if getattr(self, "_tiles_key", None) != key:
            self._tiles = self._kmajor_layout()
            self._tiles_key = key
        return self._tiles

    def _kmajor_layout(self):
        return kmajor_tiles(self.wq, self.kernel ** 2)

    def forward(self, x):
        if self.quant == "none":
            w, fused_bias = self.folded()
            y = F.conv2d(x.to(self.dtype), w.to(self.dtype),
                         stride=self.stride, padding=self.kernel // 2)
            return y + fused_bias.to(self.dtype)[:, None, None]
        xh = x.permute(0, 2, 3, 1)                                 # NHWC
        wq, w_s, fused_bias, a_s = self.int8_operands(xh)
        acc = int8_matmul(_im2col(quantize_activation(xh, a_s),
                                  self.kernel, self.stride), wq)
        y = (acc.float() * (a_s * w_s)).to(self.dtype) \
            + fused_bias.to(self.dtype)
        return y.permute(0, 3, 1, 2)


def _stem_s2d_scatter_indices():
    """Index map turning the 7x7/s2 stem kernel (147, 64) into its
    space-to-depth-4 equivalent (432, 4, 64).

    Pad the 224^2 input by (3, 5) -> 232^2 and space-to-depth by 4 ->
    (58, 58, 48) blocks (channel = rho*12 + sigma*3 + c). Output row
    i = 2I + p (I block, p in {0,1} sub-pixel) reads padded rows 2i+u,
    u in 0..6, that is blocks I..I+2 only: the stem is an exact 3x3/s1 conv
    in block space with 9*48 = 432 input columns and 4*64 = 256 output
    columns (sub-pixel major), followed by depth-to-space(2). Tap
    (bu, rho, p) holds kernel row u = 4bu + rho - 2p when 0 <= u <= 6 (zero
    otherwise); columns likewise."""
    dst_r, dst_pq, src = [], [], []
    for bu in range(3):
        for bv in range(3):
            for rho in range(4):
                for sig in range(4):
                    for c in range(3):
                        for p in range(2):
                            u = 4 * bu + rho - 2 * p
                            if not 0 <= u <= 6:
                                continue
                            for q in range(2):
                                v = 4 * bv + sig - 2 * q
                                if not 0 <= v <= 6:
                                    continue
                                dst_r.append((bu * 3 + bv) * 48
                                             + rho * 12 + sig * 3 + c)
                                dst_pq.append(p * 2 + q)
                                src.append(u * 21 + v * 3 + c)
    return (np.asarray(dst_r), np.asarray(dst_pq), np.asarray(src))


class StemPoolS2D(ConvBN):
    """7x7/s2 stem conv + ReLU + 3x3/s2 max-pool computed in space-to-depth
    layout: NHWC (B, H, H, 3) -> NHWC (B, H/4, H/4, 64).

    Space-to-depth-4 turns the stem into one (B*ob^2, 432) x (432, 256)
    product; the max-pool then runs on the sub-pixel planes directly
    (output row 2I+d, d in {-1,0,1}, lives in planes (I,p0), (I,p1),
    (I-1,p1)). The parameters are those of `ConvBN(3, 64, 7, 2)`. In the
    int8 modes the integer products are those of the im2col stem, so the
    result is bit-identical to it, and `fused_kernel` sends everything
    after the patches through `int8_stem_pool` (on the card with the
    K-major copy of the space-to-depth weight that `kmajor_tiles()` keeps,
    in "int8_static" mode). With `quant="none"` the
    BatchNorm is folded into the float weights and the product runs in
    `dtype` (the JAX module's float path): it equals `ConvBN` + max-pool up
    to summation order, and `ResNet` keeps the float stem on `ConvBN`.
    `plain_conv` is the im2col stem on the same parameters, for input sizes
    this layout does not take."""

    plain_conv = ConvBN.forward

    def __init__(self, dtype=torch.float32, quant: str = "int8",
                 fused_kernel: bool = False, plain_kernels: bool = False,
                 device="cuda", generator=None):
        dev = resolve_device(device)
        super().__init__(3, 64, 7, 2, dtype=dtype, quant=quant, device=dev,
                         generator=generator)
        self.fused_kernel, self.plain_kernels = fused_kernel, plain_kernels
        for name, idx in zip(("_dst_r", "_dst_pq", "_src"),
                             _stem_s2d_scatter_indices()):
            self.register_buffer(name, torch.from_numpy(idx).to(dev),
                                 persistent=False)

    @staticmethod
    def takes(height: int, width: int) -> bool:
        return height % 4 == 0 and height >= 8 and height == width

    def _s2d_weight(self, wmat):
        """The (147, F) kernel scattered into its s2d-4 (432, 4F)
        equivalent."""
        n_out = wmat.shape[1]
        w2 = torch.zeros((432, 4, n_out), dtype=wmat.dtype,
                         device=wmat.device)
        w2[self._dst_r, self._dst_pq] = wmat[self._src]
        return w2.reshape(432, 4 * n_out)

    def _kmajor_layout(self):
        return kmajor_tiles(self._s2d_weight(self.wq))

    def forward(self, x):
        B, H = x.shape[0], x.shape[1]
        n_out = 64
        if self.quant == "none":
            folded, fused_bias = self.folded()
            wmat = folded.permute(2, 3, 1, 0).reshape(-1, n_out) \
                .to(self.dtype)
            xd = x.to(self.dtype)
        else:
            wmat, w_s, fused_bias, a_s = self.int8_operands(x)
            xd = quantize_activation(x, a_s)
        w2 = self._s2d_weight(wmat)
        # pad (3, 5) and space-to-depth by 4: 224^2 -> (B, 58, 58, 48)
        nb, ob = H // 4 + 2, H // 4
        xp = F.pad(xd, (0, 0, 3, 5, 3, 5))
        xs = (xp.reshape(B, nb, 4, nb, 4, 3).permute(0, 1, 3, 2, 4, 5)
              .reshape(B, nb, nb, 48))
        patches = torch.cat([xs[:, i:i + ob, j:j + ob, :]
                             for i in range(3) for j in range(3)], dim=-1)
        if self.quant == "none":
            y = torch.matmul(patches, w2)
        else:
            scale = (a_s * w_s.repeat(4)).float()
            if self.fused_kernel:
                tail = stem_pool_reference
                if not self.plain_kernels:
                    tiles = self.kmajor_tiles() if x.is_cuda \
                        and self.quant == "int8_static" else None
                    tail = functools.partial(_int8_stem_pool_tiled, tiles)
                return tail(patches, w2, scale, fused_bias.repeat(4).float(),
                            out_dtype=self.dtype)
            y = (int8_matmul(patches, w2).float() * scale).to(self.dtype)
        y = y + fused_bias.to(self.dtype).repeat(4)
        # ReLU + 3x3/s2 max-pool in s2d space (the pad contributes 0 <=
        # ReLU'd values, as the -inf-padded pool does on the 112^2 layout)
        y = F.relu(y.reshape(B, ob, ob, 2, 2, n_out))
        p0, p1 = y[:, :, :, 0], y[:, :, :, 1]             # (B,ob,ob,2,F)
        p1s = F.pad(p1, (0, 0, 0, 0, 0, 0, 1, 0))[:, :ob]
        r = torch.maximum(torch.maximum(p0, p1), p1s)
        q0, q1 = r[:, :, :, 0], r[:, :, :, 1]             # (B,ob,ob,F)
        q1s = F.pad(q1, (0, 0, 1, 0))[:, :, :ob]
        return torch.maximum(torch.maximum(q0, q1), q1s)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand (x4) with projection shortcut.

    `fused` (with `quant="int8_static"`, stride 1 and no projection) takes
    the int8-resident kernel path: the block consumes int8 in its conv1
    activation domain when the block before it was fused too (that block
    requantised into it through its `out_scale`), or quantises a float
    input here; it emits int8 in the next block's domain, or bf16 when
    `last`. Every requant scale is folded at each call from the parameters
    the unfused path serves."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 project: bool = False, dtype=torch.float32,
                 quant: str = "none", fused: bool = False,
                 last: bool = True, g: int = 1, plain_kernels: bool = False,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, quant=quant, device=dev,
                  generator=generator_for(dev, None, generator))
        self.fused = (fused and quant == "int8_static" and stride == 1
                      and not project)
        self.last, self.g, self.plain_kernels = last, g, plain_kernels
        self.conv1 = ConvBN(in_ch, width, 1, **kw)
        self.conv2 = ConvBN(width, width, 3, stride, **kw)
        self.conv3 = ConvBN(width, width * 4, 1, **kw)
        self.downsample = (ConvBN(in_ch, width * 4, 1, stride, **kw)
                           if project else None)
        if self.fused and not last:
            # the next block's conv1 act_scale, set by
            # `static_quantize_backbone`
            self.register_buffer("out_scale",
                                 torch.full((), 1.0 / 127.0, device=dev))

    def forward(self, x):
        if self.fused:
            return self._fused(x)
        if x.dtype == torch.int8:
            raise ValueError("int8-resident input reached a non-fused block")
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)

    def _fused(self, x):
        c1, c2, c3 = self.conv1, self.conv2, self.conv3
        a0, q2, q3 = c1.act_scale, c2.act_scale, c3.act_scale
        aN = torch.ones_like(a0) if self.last else self.out_scale
        xh = x.permute(0, 2, 3, 1)                                 # NHWC
        if xh.dtype != torch.int8:
            xh = quantize_activation(xh, a0)
        kw = {}
        block = bottleneck_v2_reference
        if not self.plain_kernels:
            tiles = None
            if xh.is_cuda:
                tiles = (c1.kmajor_tiles(), c2.kmajor_tiles(),
                         c3.kmajor_tiles())
            block = functools.partial(_int8_bottleneck_v2_tiled, tiles)
            kw["g"] = self.g if xh.shape[0] % self.g == 0 else 1
        out = block(
            xh.contiguous(), c1.wq, c2.wq, c3.wq,
            (a0 * c1.w_scale / q2).float(), c1.fused_bias / q2,
            (q2 * c2.w_scale / q3).float(), c2.fused_bias / q3,
            (q3 * c3.w_scale / aN).float(), c3.fused_bias / aN,
            a0 / aN, out_bf16=self.last, **kw)
        return out.permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """torchvision-layout ResNet over NCHW-shaped tensors;
    `layers=(3, 8, 36, 3)` is ResNet-152.

    `stem_s2d` gives the int8 modes the space-to-depth stem (the float stem
    stays the plain conv). `fused_stem` and `fused_pallas` act with
    `quant="int8_static"` and `dtype=torch.bfloat16` only: the first sends
    the stem's tail through its kernel, the second the stem's tail and
    every identity bottleneck."""

    # images per step of the TPU kernel's grid, by stage; the CUDA kernel
    # accepts the argument and tiles on its own (`g` falls back to 1 when
    # B % g != 0)
    _FUSED_G = (1, 2, 4, 8)

    def __init__(self, layers: Sequence[int] = (3, 8, 36, 3),
                 dtype=torch.float32, quant: str = "none",
                 stem_s2d: bool = True, fused_stem: bool = False,
                 fused_pallas: bool = False, plain_kernels: bool = False,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, quant=quant, device=dev,
                  generator=generator_for(dev, None, generator))
        int8s = quant == "int8_static" and dtype == torch.bfloat16
        fused = fused_pallas and int8s
        if stem_s2d and quant != "none":
            self.stem = StemPoolS2D(
                fused_kernel=fused or (fused_stem and int8s),
                plain_kernels=plain_kernels, **kw)
        else:
            self.stem = ConvBN(3, 64, 7, 2, **kw)
        self.blocks = []
        in_ch = 64
        for stage, n in enumerate(layers):
            width = 64 * (2 ** stage)
            for b in range(n):
                name = f"layer{stage + 1}_{b}"
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(name, Bottleneck(
                    in_ch, width, stride, project=(b == 0), fused=fused,
                    last=(b == n - 1), g=self._FUSED_G[min(stage, 3)],
                    plain_kernels=plain_kernels, **kw))
                self.blocks.append(name)
                in_ch = width * 4

    def forward(self, x):
        if isinstance(self.stem, StemPoolS2D) \
                and self.stem.takes(x.shape[2], x.shape[3]):
            x = self.stem(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        else:
            conv = self.stem.plain_conv if isinstance(self.stem, StemPoolS2D) \
                else self.stem
            x = F.max_pool2d(F.relu(conv(x)), 3, stride=2, padding=1)
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
                 att_size: int = 7, dtype=torch.float32,
                 quant: str = "none", fused_stem: bool = False,
                 fused_pallas: bool = False, plain_kernels: bool = False,
                 device="cuda", seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.att_size = att_size
        self.resnet = ResNet(layers, dtype=dtype, quant=quant,
                             fused_stem=fused_stem,
                             fused_pallas=fused_pallas,
                             plain_kernels=plain_kernels, device=dev,
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


def resnet152(dtype=torch.float32, device="cuda", seed=None) -> VisualBackbone:
    """The reference's ResNet-152 backbone, stages (3, 8, 36, 3)."""
    return VisualBackbone(layers=(3, 8, 36, 3), dtype=dtype, device=device,
                          seed=seed)


def resnet_params_from_torch(sd: dict, layers=None) -> dict:
    """torchvision `resnet152.pth` state dict -> the JAX package's
    `VisualBackbone` variables {"params": ..., "batch_stats": ...} (float32
    numpy, conv kernels OIHW -> HWIO), as `icka_tpu`'s converter returns
    them; `icka_tpu_torch.convert.backbone_state_dict` makes them this
    package's state_dict. `layers` is inferred from the key layout when
    omitted."""
    if layers is None:
        layers = tuple(
            1 + max((int(k.split(".")[1]) for k in sd
                     if k.startswith(f"layer{i}.")), default=-1)
            for i in range(1, 5))
        layers = tuple(b for b in layers if b > 0)

    def np32(x):
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=np.float32)

    def convbn(conv_key, bn_key):
        p = {"conv": {"kernel": np32(sd[f"{conv_key}.weight"])
                      .transpose(2, 3, 1, 0)},
             "scale": np32(sd[f"{bn_key}.weight"]),
             "bias": np32(sd[f"{bn_key}.bias"])}
        s = {"mean": np32(sd[f"{bn_key}.running_mean"]),
             "var": np32(sd[f"{bn_key}.running_var"])}
        return p, s

    params, stats = {}, {}
    params["stem"], stats["stem"] = convbn("conv1", "bn1")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            name = f"layer{stage + 1}_{b}"
            pfx = f"layer{stage + 1}.{b}"
            bp, bs = {}, {}
            for i in (1, 2, 3):
                bp[f"conv{i}"], bs[f"conv{i}"] = convbn(
                    f"{pfx}.conv{i}", f"{pfx}.bn{i}")
            if f"{pfx}.downsample.0.weight" in sd:
                bp["downsample"], bs["downsample"] = convbn(
                    f"{pfx}.downsample.0", f"{pfx}.downsample.1")
            params[name] = bp
            stats[name] = bs
    return {"params": {"resnet": params}, "batch_stats": {"resnet": stats}}
