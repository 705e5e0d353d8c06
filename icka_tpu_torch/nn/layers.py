"""Primitive blocks shared across encoders (port of `icka_tpu.nn.layers`).

Numerics follow the reference's legacy BERT stack at fp32:

  - additive attention masks `(1 - m) * -10000`
  - erf-based gelu
  - TF-style LayerNorm (epsilon inside the square root), fp32 statistics

Parameters are stored in fp32 and cast to the module's compute `dtype` at
each call, as the JAX package does. Parameter names are the flax names
(`Dense.weight` is the flax `kernel` transposed to torch's (out, in)), so
`icka_tpu_torch.convert` maps a flax tree onto a `state_dict` by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device

NEG_INF_MASK = -10000.0


def gelu(x):
    """erf-gelu, matching the reference exactly (not the tanh approximation)."""
    return F.gelu(x)


ACT2FN = {
    "gelu": gelu,
    "relu": F.relu,
    "swish": F.silu,
    "tanh": torch.tanh,
}


def additive_mask(mask, dtype=torch.float32):
    """{0,1} key mask (B, S) -> additive (B, 1, 1, S): 0 -> -10000, 1 -> 0."""
    m = torch.as_tensor(mask).to(dtype)
    while m.ndim < 4:
        m = m[:, None]
    return (1.0 - m) * NEG_INF_MASK


class LayerNorm(nn.Module):
    """TF-style LayerNorm (eps inside sqrt), fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-12, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=dev))
        self.bias = nn.Parameter(torch.zeros(dim, device=dev))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(self.dtype)


class Dense(nn.Module):
    """Linear layer with bias, the JAX layer's `quant="none"` (the int8
    serving modes are not ported yet). Computes in `dtype`: inputs and
    weights are cast, the product is rounded to `dtype`, then the bias is
    added in `dtype`."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=dev))
        nn.init.normal_(self.weight, 0.0, 0.02, generator=gen)
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)
