"""Transformer blocks: self-attention and cross-modal co-attention (port of
`icka_tpu.nn.attention`).

  - `SelfAttentionLayer`  ≙ BertLayer: self-attention + FFN, post-LN
  - `CrossAttentionLayer` ≙ BertCrossAttentionLayer: queries from stream 1,
    keys/values from stream 2
  - `Encoder` / `CrossEncoder` ≙ BertEncoder / BertCrossEncoder
  - `Pooler` ≙ BertPooler

Dropout follows the JAX package's sites (attention probabilities of the
plain core, the attention output and the FFN output, before each residual):
every `forward` takes `dropout_gen`, a `torch.Generator` on the device that
draws the masks, and None (the default) runs deterministically. Heads are
laid out (B, S, N, H).
Submodule names are the flax names (`layer_0`, `attn`, `query`, ...), so a
flax parameter path is a `state_dict` key. `EncoderConfig.quant` reaches
every projection of a layer (query, key, value, the attention output and
both FFN layers), in self- and cross-attention alike; the pooler stays
float, as in the JAX package. `EncoderConfig.fuse_qkv` gives every
self-attention one `qkv` projection (H, 3H) in place of query, key and
value (cross-attention keeps the three).
"""

from __future__ import annotations

import torch
from torch import nn

from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.kernels.attention import fused_attention
from icka_tpu_torch.nn.layers import ACT2FN, Dense, LayerNorm, dropout


def _split_heads(x, num_heads):
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads)


def _merge_heads(x):
    B, S, N, H = x.shape
    return x.reshape(B, S, N * H)


def dot_product_attention(q, k, v, bias=None, dtype=torch.float32,
                          softmax_dtype=torch.float32, dropout_rate=0.0,
                          dropout_gen=None):
    """Plain attention core. q, k, v: (B, S, N, H); bias broadcastable to
    (B, N, Sq, Sk). Scores are summed in `softmax_dtype` (fp32 by default
    whatever the compute dtype), probabilities cast to `dtype` for P.V.
    With `dropout_gen`, each probability is kept with probability
    1 - dropout_rate and scaled by its inverse, as the JAX core does. (The
    JAX core's tau, neg_type and prior are not ported.)"""
    scores = torch.einsum("bqnh,bknh->bnqk", q.to(softmax_dtype),
                          k.to(softmax_dtype)) * q.shape[-1] ** -0.5
    if bias is not None:
        scores = scores + bias.to(softmax_dtype)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and dropout_gen is not None:
        keep = torch.rand(probs.shape, generator=dropout_gen,
                          device=probs.device) < 1.0 - dropout_rate
        probs = probs * keep / (1.0 - dropout_rate)
    probs = probs.to(dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v.to(dtype))


def _check_ported(cfg: EncoderConfig):
    if cfg.adapter_size > 0:
        raise NotImplementedError(
            f"EncoderConfig.adapter_size={cfg.adapter_size!r} is not ported")


class MultiHeadAttention(nn.Module):
    """Q/K/V projections around the attention core (self-attention when
    `kv` is None). `use_pallas=True` routes the core through the fused
    attention kernel, which always takes an fp32 softmax (`softmax_dtype`
    applies to the plain core only); a missing bias becomes a zero
    (B, 1, 1, Sk) key bias. The kernel has no dropout and no backward, so,
    as in the JAX package, it runs only when the call is deterministic or
    `dropout_rate` is 0: training with attention dropout takes the plain
    core. `quant` is the projections' `Dense` mode. `fuse_qkv=True` (self-
    attention only) holds one `qkv` Dense (H, 3H) whose output splits into
    q, k and v; the kernel reads the three as views of it, in place."""

    def __init__(self, hidden: int, num_heads: int, dtype=torch.float32,
                 use_pallas: bool = False, softmax_dtype=torch.float32,
                 quant: str = "none", dropout_rate: float = 0.1,
                 fuse_qkv: bool = False, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.dropout_rate = dropout_rate
        self.softmax_dtype = softmax_dtype
        self.fuse_qkv = fuse_qkv
        if fuse_qkv:
            self.qkv = Dense(hidden, 3 * hidden, dtype=dtype, quant=quant,
                             device=dev, generator=gen)
        else:
            for name in ("query", "key", "value"):
                self.add_module(name, Dense(hidden, hidden, dtype=dtype,
                                            quant=quant, device=dev,
                                            generator=gen))

    def forward(self, x, kv=None, bias=None, dropout_gen=None):
        if self.fuse_qkv:
            if kv is not None:
                raise ValueError("a fused qkv projection is self-attention "
                                 "only")
            q, k, v = self.qkv(x).split(x.shape[-1], dim=-1)
        else:
            kv = x if kv is None else kv
            q, k, v = self.query(x), self.key(kv), self.value(kv)
        if self.use_pallas and (dropout_gen is None
                                or self.dropout_rate == 0.0):
            if bias is None:
                bias = torch.zeros(q.shape[0], 1, 1, k.shape[1],
                                   device=q.device)
            return fused_attention(q, k, v, bias, num_heads=self.num_heads)
        q, k, v = (_split_heads(t, self.num_heads) for t in (q, k, v))
        ctx = dot_product_attention(q, k, v, bias=bias, dtype=self.dtype,
                                    softmax_dtype=self.softmax_dtype,
                                    dropout_rate=self.dropout_rate,
                                    dropout_gen=dropout_gen)
        return _merge_heads(ctx)


class AttentionOutput(nn.Module):
    """Projection + dropout + residual + LayerNorm (BertSelfOutput)."""

    def __init__(self, hidden: int, eps: float, dtype=torch.float32,
                 quant: str = "none", dropout_rate: float = 0.1,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.dropout_rate = dropout_rate
        self.dense = Dense(hidden, hidden, dtype=dtype, quant=quant,
                           device=dev,
                           generator=generator_for(dev, None, generator))
        self.norm = LayerNorm(hidden, eps=eps, dtype=dtype, device=dev)

    def forward(self, x, residual, dropout_gen=None):
        x = dropout(self.dense(x), self.dropout_rate, dropout_gen)
        return self.norm(x + residual)


class FeedForward(nn.Module):
    """Intermediate + output FFN with dropout and post-LN residual
    (BertIntermediate / BertOutput). The Pfeiffer adapter of the JAX module
    is not ported."""

    def __init__(self, hidden: int, intermediate: int, eps: float,
                 act: str = "gelu", dtype=torch.float32, quant: str = "none",
                 dropout_rate: float = 0.1, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.act = ACT2FN[act]
        self.dropout_rate = dropout_rate
        self.wi = Dense(hidden, intermediate, dtype=dtype, quant=quant,
                        device=dev, generator=gen)
        self.wo = Dense(intermediate, hidden, dtype=dtype, quant=quant,
                        device=dev, generator=gen)
        self.norm = LayerNorm(hidden, eps=eps, dtype=dtype, device=dev)

    def forward(self, x, dropout_gen=None):
        h = dropout(self.wo(self.act(self.wi(x))), self.dropout_rate,
                    dropout_gen)
        return self.norm(h + x)


class _AttentionLayer(nn.Module):
    """attn -> attn_out -> ffn; shared by the self- and cross-attention
    layers, which differ in where keys come from, in `use_pallas` and in
    `fuse_qkv` (`self_attention`)."""

    def __init__(self, cfg: EncoderConfig, self_attention: bool,
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        H = cfg.hidden_size
        self.attn = MultiHeadAttention(
            H, cfg.num_attention_heads, dtype=dtype,
            use_pallas=self_attention and cfg.use_pallas,
            softmax_dtype=getattr(torch, cfg.softmax_dtype), quant=cfg.quant,
            dropout_rate=cfg.attention_probs_dropout_prob,
            fuse_qkv=self_attention and cfg.fuse_qkv, device=dev,
            generator=gen)
        self.attn_out = AttentionOutput(
            H, cfg.layer_norm_eps, dtype=dtype, quant=cfg.quant,
            dropout_rate=cfg.hidden_dropout_prob, device=dev, generator=gen)
        self.ffn = FeedForward(
            H, cfg.intermediate_size, cfg.layer_norm_eps, dtype=dtype,
            quant=cfg.quant, dropout_rate=cfg.hidden_dropout_prob,
            device=dev, generator=gen)


class SelfAttentionLayer(_AttentionLayer):
    """Self-attention + FFN; `cfg.use_pallas` routes attention through the
    fused kernel. (The JAX layer's history KV-concat is not ported.)"""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__(cfg, True, dtype, device, generator)

    def forward(self, x, bias=None, dropout_gen=None):
        a = self.attn(x, bias=bias, dropout_gen=dropout_gen)
        return self.ffn(self.attn_out(a, x, dropout_gen), dropout_gen)


class CrossAttentionLayer(_AttentionLayer):
    """Queries from `x`, keys/values from `kv`; `bias` masks the kv stream.
    Always the plain core, and always three projections: the JAX package
    routes only the self-attention stacks through its kernel and fuses
    only their projections."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__(cfg, False, dtype, device, generator)

    def forward(self, x, kv, bias=None, dropout_gen=None):
        a = self.attn(x, kv=kv, bias=bias, dropout_gen=dropout_gen)
        return self.ffn(self.attn_out(a, x, dropout_gen), dropout_gen)


class _Stack(nn.Module):
    """Layers registered as `layer_0`, `layer_1`, ... (the flax names)."""

    def __init__(self, layer_cls, cfg, num_layers, dtype, device, generator):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", layer_cls(
                cfg, dtype=dtype, device=dev, generator=gen))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]


class Encoder(_Stack):
    """Self-attention stack of `cfg.num_hidden_layers` layers."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__(SelfAttentionLayer, cfg, cfg.num_hidden_layers,
                         dtype, device, generator)

    def forward(self, x, bias=None, dropout_gen=None):
        for layer in self.layers():
            x = layer(x, bias, dropout_gen)
        return x


class CrossEncoder(_Stack):
    """Stack of cross-attention layers (the txt2img fusion)."""

    def __init__(self, cfg: EncoderConfig, num_layers: int = 1,
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__(CrossAttentionLayer, cfg, num_layers, dtype, device,
                         generator)

    def forward(self, x, kv, bias=None, dropout_gen=None):
        for layer in self.layers():
            x = layer(x, kv, bias, dropout_gen)
        return x


class Pooler(nn.Module):
    def __init__(self, hidden: int, dtype=torch.float32, device="cuda",
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.dense = Dense(hidden, hidden, dtype=dtype, device=dev,
                           generator=generator_for(dev, None, generator))

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))
