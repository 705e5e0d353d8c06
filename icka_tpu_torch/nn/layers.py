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
from icka_tpu_torch.core.mesh import MODEL_AXIS, draw
from icka_tpu_torch.nn.quant import (abs_max_scale, column_major,
                                     int8_matmul, quantize_activation)
from icka_tpu_torch.parallel.tensor import (copy_to_model,
                                            gather_from_model,
                                            reduce_from_model)

NEG_INF_MASK = -10000.0
QUANT_MODES = ("none", "int8", "int8_static")


def gelu(x):
    """erf-gelu, matching the reference exactly (not the tanh approximation)."""
    return F.gelu(x)


ACT2FN = {
    "gelu": gelu,
    "relu": F.relu,
    "swish": F.silu,
    "tanh": torch.tanh,
}


def dropout(x, rate: float, dropout_gen=None, cut=None):
    """flax `nn.Dropout`: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), the mask drawn from `dropout_gen` (a
    `torch.Generator` on x's device, or `core.mesh.RowDraws` of one for a
    rank's rows of a batch; no module touches the global RNG), at the
    whole shape where `cut` says which dimension of `x` is a model-axis
    slice (`core.mesh.draw`). The identity when `dropout_gen` is None
    (deterministic) or rate is 0."""
    if dropout_gen is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = draw(lambda shape, gen: torch.rand(shape, generator=gen,
                                              device=x.device),
                x.shape, dropout_gen, cut) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def additive_mask(mask, dtype=torch.float32):
    """{0,1} key mask (B, S) -> additive (B, 1, 1, S): 0 -> -10000, 1 -> 0."""
    m = torch.as_tensor(mask).to(dtype)
    while m.ndim < 4:
        m = m[:, None]
    return (1.0 - m) * NEG_INF_MASK


def sparsemax(logits, dim: int = -1):
    """Sparsemax (Martins & Astudillo 2016): the Euclidean projection of
    `logits` onto the simplex along `dim`, in fp32, by sorting, as the JAX
    package computes it."""
    logits = torch.as_tensor(logits).float()
    sorted_logits = torch.sort(logits, dim=dim, descending=True).values
    shape = [1] * logits.ndim
    shape[dim] = -1
    k = torch.arange(1, logits.shape[dim] + 1, dtype=torch.float32,
                     device=logits.device).reshape(shape)
    cssv = torch.cumsum(sorted_logits, dim=dim)
    support = (1.0 + k * sorted_logits) > cssv
    k_support = support.float().sum(dim=dim, keepdim=True)
    cssv_support = cssv.gather(dim, (k_support - 1).long())
    tau = (cssv_support - 1.0) / k_support
    return torch.clamp_min(logits - tau, 0.0)


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
    """Linear layer with bias. Computes in `dtype`: the product is rounded
    to `dtype`, then the bias is added in `dtype`.

    `quant="none"`: inputs and the fp32 `weight` (torch's (out, in)) are
    cast to `dtype`. The int8 modes are the JAX layer's W8A8 serving
    layouts, op for op: `kernel_q` (in, out) int8 and `kernel_scale` (out,)
    fp32 are buffers in the flax layout (`kernel_q` held column-major, see
    `column_major`); the input is quantised in fp32, contracted in exact
    int32 (`int8_matmul`) and scaled as `(acc * a_scale) * kernel_scale`.
    `"int8"` takes the per-row scale max(amax_row, 1e-8) / 127 and records
    the largest |x| it has seen in `calib_amax` (max-merged over calls, not
    in the state_dict): the calibration mode. `"int8_static"` takes one
    calibrated per-tensor `act_scale` ().

    On a model axis (`icka_tpu_torch.parallel.tensor`, float only: the
    int8 weights are serving buffers, never trained) `mode` is "column"
    (its output columns, from its slice of the bias), "gather" (the same,
    its input's gradient summed over the model group and the whole output
    gathered) or "row" (the partial product over its input slice summed
    over the model group, then the bias); None off the axis.

    `use_bias=False` holds no bias (the JAX layer's option; the ChunkAlign
    decoders' `lm_head`), float and off the model axis only."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 quant: str = "none", device="cuda", generator=None,
                 use_bias: bool = True):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got "
                             f"{quant!r}")
        dev = resolve_device(device)
        self.dtype = dtype
        self.quant = quant
        if quant == "none":
            self.weight = nn.Parameter(
                torch.empty(features, in_features, device=dev))
            nn.init.normal_(self.weight, 0.0, 0.02,
                            generator=generator_for(dev, None, generator))
        else:
            self.register_buffer("kernel_q", column_major(torch.zeros(
                in_features, features, dtype=torch.int8, device=dev)))
            self.register_buffer("kernel_scale", torch.full(
                (features,), 0.02 / 127.0, device=dev))
            if quant == "int8_static":
                self.register_buffer("act_scale",
                                     torch.full((), 1.0 / 127.0, device=dev))
            else:
                self.register_buffer("calib_amax",
                                     torch.zeros((), device=dev),
                                     persistent=False)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features, device=dev))
        elif quant != "none":
            raise ValueError("an int8 Dense holds a bias")
        else:
            self.register_parameter("bias", None)
        self.mode = None
        self.shard = None

    def shard_model_axis(self, shard, specs) -> tuple:
        """`parallel.tensor.tensor_parallel`'s hook: "gather" where the
        weight's output dimension is split (a layer that consumes its
        columns makes it "column"), "row" where its input dimension is.
        Returns the leaves used in part: the bias of a column split.

        Refused, and neither is a gap: a Dense without bias (only
        ChunkAlign's `lm_head`, which no entry point puts on a mesh), and
        an int8 Dense (serving buffers, never trained)."""
        if self.bias is None:
            raise NotImplementedError("a Dense without bias on a model axis")
        if self.quant != "none":
            raise NotImplementedError(
                f"a Dense in {self.quant!r} mode on a model axis: the int8 "
                f"weights are serving buffers and are never trained")
        out_split, in_split = (a == MODEL_AXIS for a in specs["weight"])
        if out_split:
            self.mode, self.shard = "gather", shard
            return ("bias",)
        if in_split:
            self.mode, self.shard = "row", shard
        return ()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if self.quant != "none":
            self.kernel_q = column_major(self.kernel_q)

    def forward(self, x):
        if self.quant == "none" and self.mode is None:
            y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
            return y if self.bias is None else y + self.bias.to(self.dtype)
        if self.mode == "row":
            y = reduce_from_model(
                F.linear(x.to(self.dtype), self.weight.to(self.dtype)),
                self.shard)
            return y + self.bias.to(self.dtype)
        if self.mode is not None:
            n = self.weight.shape[0]
            bias = self.bias.narrow(0, self.shard.index * n, n)
            if self.mode == "gather":
                x = copy_to_model(x, self.shard)
            y = (F.linear(x.to(self.dtype), self.weight.to(self.dtype))
                 + bias.to(self.dtype))
            return (y if self.mode == "column"
                    else gather_from_model(y, self.shard))
        if self.quant == "int8_static":
            a_scale = self.act_scale
        else:
            amax = x.float().abs().amax(dim=-1, keepdim=True)
            self.calib_amax.copy_(torch.maximum(self.calib_amax, amax.max()))
            a_scale = abs_max_scale(amax)
        acc = int8_matmul(quantize_activation(x, a_scale), self.kernel_q)
        y = (acc.float() * a_scale * self.kernel_scale).to(self.dtype)
        return y + self.bias.to(self.dtype)


class MLP(nn.Module):
    """Feed-forward block Dense -> act -> Dense, the residual and LayerNorm
    left to the caller; `wi` and `wo` under the flax names."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 act: str = "gelu", dtype=torch.float32, device="cuda",
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.act = ACT2FN[act]
        self.wi = Dense(in_features, hidden, dtype=dtype, device=dev,
                        generator=gen)
        self.wo = Dense(hidden, out, dtype=dtype, device=dev, generator=gen)

    def forward(self, x):
        return self.wo(self.act(self.wi(x)))
