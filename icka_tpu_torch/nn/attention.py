"""Transformer blocks: self-attention and cross-modal co-attention (port of
`icka_tpu.nn.attention`).

  - `SelfAttentionLayer`  ≙ BertLayer: self-attention + FFN, post-LN
  - `CrossAttentionLayer` ≙ BertCrossAttentionLayer: queries from stream 1,
    keys/values from stream 2
  - `Encoder` / `CrossEncoder` ≙ BertEncoder / BertCrossEncoder (only
    `Encoder` takes `EncoderConfig.remat`, as in the JAX package)
  - `Pooler` ≙ BertPooler
  - `GatedCrossAttention` ≙ cross_attention_Y: Bart-style MHA with
    pre-scaled queries, temperature `tau`, `neg_type` (1 - softmax) and an
    additive `prior`, the knowledge-alignment CLS layers' attention

Dropout follows the JAX package's sites (attention probabilities of the
plain core, the attention output and the FFN output, before each residual):
every `forward` takes `dropout_gen`, a `torch.Generator` on the device that
draws the masks (or `core.mesh.RowDraws` of one, for a rank's rows of a
batch), and None (the default) runs deterministically. Heads are
laid out (B, S, N, H).
Submodule names are the flax names (`layer_0`, `attn`, `query`, ...), so a
flax parameter path is a `state_dict` key. `EncoderConfig.quant` reaches
every projection of a layer (query, key, value, the attention output and
both FFN layers), in self- and cross-attention alike; the pooler stays
float, as in the JAX package. `EncoderConfig.fuse_qkv` gives every
self-attention one `qkv` projection (H, 3H) in place of query, key and
value (cross-attention keeps the three).

On a model axis (`icka_tpu_torch.parallel.tensor`) a layer's heads and
FFN columns are split: q/k/v and `wi` are column-parallel, the attention
output and `wo` row-parallel, in self- and cross-attention alike. A fused
`qkv` (which the specs split by the generic rule, or not at all) is read
at the rank's heads' columns; where the axis does not divide the heads,
every rank runs every head and keeps its columns of the context. The
adapter runs whole after `wo`'s sum.
"""

from __future__ import annotations

import torch
from torch import nn

from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.core.mesh import draw
from icka_tpu_torch.kernels.attention import fused_attention
from icka_tpu_torch.nn.layers import (ACT2FN, Dense, LayerNorm, additive_mask,
                                      dropout)
from icka_tpu_torch.nn.remat import rematerialised, remat_call
from icka_tpu_torch.parallel.tensor import column_row_pair, copy_to_model


def _split_heads(x, num_heads):
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads)


def _merge_heads(x):
    B, S, N, H = x.shape
    return x.reshape(B, S, N * H)


def dot_product_attention(q, k, v, bias=None, dtype=torch.float32,
                          softmax_dtype=torch.float32, dropout_rate=0.0,
                          dropout_gen=None, head_cut=None, scale=None,
                          tau=1.0, neg_type=False, prior=None):
    """Plain attention core. q, k, v: (B, S, N, H); bias broadcastable to
    (B, N, Sq, Sk). Scores are summed in `softmax_dtype` (fp32 by default
    whatever the compute dtype), probabilities cast to `dtype` for P.V.
    In the JAX core's order: scores times `scale` (H^-0.5 when None) plus
    bias; softmax(scores / tau); 1 - p where `neg_type`; plus `prior`
    (broadcastable to the probabilities); dropout; the cast.
    With `dropout_gen`, each probability is kept with probability
    1 - dropout_rate and scaled by its inverse, as the JAX core does; the
    mask is drawn at every head and cut to these N where `head_cut`
    (dim 1, first head, all heads; `core.mesh.draw`) says they are a
    model-axis slice."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.einsum("bqnh,bknh->bnqk", q.to(softmax_dtype),
                          k.to(softmax_dtype)) * scale
    if bias is not None:
        scores = scores + bias.to(softmax_dtype)
    probs = torch.softmax(scores / tau if tau != 1.0 else scores, dim=-1)
    if neg_type:
        probs = 1.0 - probs
    if prior is not None:
        probs = probs + prior.to(probs.dtype)
    if dropout_rate > 0.0 and dropout_gen is not None:
        keep = draw(lambda shape, gen: torch.rand(shape, generator=gen,
                                                  device=probs.device),
                    probs.shape, dropout_gen, head_cut) < 1.0 - dropout_rate
        probs = probs * keep / (1.0 - dropout_rate)
    probs = probs.to(dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v.to(dtype))


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
    q, k and v; the kernel reads the three as views of it, in place.

    On a model axis whose attention output is row-parallel (`shard_heads`,
    from the layer that holds both), the layer emits this rank's columns
    of the context, the output's input rows:
      - where the axis divides the heads, it runs its `num_heads / model`
        heads (`local_heads`, the kernel's too): unfused, q, k and v
        column-parallel, its inputs' gradients summed over the model group
        once each (x, and kv in cross-attention); fused, the heads'
        columns of q, k and v read as views of the whole (B, S, 3H)
        projection (gathered where the specs split `qkv`, replicated
        where they do not), whose gradient is summed over the group;
      - otherwise every rank runs every head on whole q, k and v (each
        projection gathered, or fused and whole) and cuts its columns out
        of the context, whose gradient is summed over the group.
    Elsewhere the layer computes as on one rank (a `qkv` the specs split
    gathered whole)."""

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
        self.shard = None
        self.local_heads = num_heads

    def shard_heads(self, shard) -> None:
        """Lay the heads out on the model axis `shard` for a row-parallel
        attention output: this rank's heads where the axis divides them,
        else every head (the class docstring)."""
        self.shard = shard
        if self.num_heads % shard.size == 0:
            self.local_heads = self.num_heads // shard.size
            if not self.fuse_qkv:
                for p in (self.query, self.key, self.value):
                    p.mode = "column"

    def forward(self, x, kv=None, bias=None, dropout_gen=None):
        heads = self.local_heads
        per_rank = heads < self.num_heads        # this rank's heads only
        if self.fuse_qkv:
            if kv is not None:
                raise ValueError("a fused qkv projection is self-attention "
                                 "only")
            H = x.shape[-1]
            y = self.qkv(x)
            if per_rank:
                # the rank's heads' columns, read in place; the ranks'
                # gradients of their columns summed into the whole one
                y = copy_to_model(y, self.shard)
                n = H // self.shard.size
                q, k, v = (y.narrow(-1, j * H + self.shard.index * n, n)
                           for j in range(3))
            else:
                q, k, v = y.split(H, dim=-1)
        else:
            shard = self.shard if per_rank else None
            x = copy_to_model(x, shard)
            kv = x if kv is None else copy_to_model(kv, shard)
            q, k, v = self.query(x), self.key(kv), self.value(kv)
        if self.use_pallas and (dropout_gen is None
                                or self.dropout_rate == 0.0):
            if bias is None:
                bias = torch.zeros(q.shape[0], 1, 1, k.shape[1],
                                   device=q.device)
            ctx = fused_attention(q, k, v, bias, num_heads=heads)
        else:
            q, k, v = (_split_heads(t, heads) for t in (q, k, v))
            ctx = _merge_heads(dot_product_attention(
                q, k, v, bias=bias, dtype=self.dtype,
                softmax_dtype=self.softmax_dtype,
                dropout_rate=self.dropout_rate, dropout_gen=dropout_gen,
                head_cut=self.shard.cut(1, heads) if per_rank else None))
        if self.shard is None or per_rank:
            return ctx
        # every head ran on every rank: the rank's columns are the
        # row-parallel output's input rows
        ctx = copy_to_model(ctx, self.shard)
        n = ctx.shape[-1] // self.shard.size
        return ctx.narrow(-1, self.shard.index * n, n)


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
    (BertIntermediate / BertOutput).

    `adapter_size > 0` inserts the Pfeiffer bottleneck adapter of the
    CoNLL-2000 chunker in the output sublayer (adapter-transformers'
    Pfeiffer config; `adapter_down` and `adapter_up` are float Dense
    layers whatever `quant` is, as in the JAX module):

        pre = wo(act(wi(x))) + x
        out = LN(up(relu(down(LN(pre)))) + pre)      # one LN, shared

    On a model axis `wi` and `wo` are the column/row pair; `pre` is whole
    after `wo`'s sum, so the adapter runs as on one rank: `adapter_down`
    replicated, `adapter_up` gathered where the specs split it (output
    width >= 1024; its bias is then a partial leaf) and replicated
    elsewhere."""

    def __init__(self, hidden: int, intermediate: int, eps: float,
                 act: str = "gelu", dtype=torch.float32, quant: str = "none",
                 dropout_rate: float = 0.1, adapter_size: int = 0,
                 device="cuda", generator=None):
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
        self.adapter = adapter_size > 0
        if self.adapter:
            self.adapter_down = Dense(hidden, adapter_size, dtype=dtype,
                                      device=dev, generator=gen)
            self.adapter_up = Dense(adapter_size, hidden, dtype=dtype,
                                    device=dev, generator=gen)
        self.shard = None

    def shard_model_axis(self, shard, specs) -> tuple:
        self.shard = column_row_pair(self.wi, self.wo)
        return ()

    def forward(self, x, dropout_gen=None):
        h = self.wi(copy_to_model(x, self.shard))
        h = dropout(self.wo(self.act(h)), self.dropout_rate, dropout_gen)
        if not self.adapter:
            return self.norm(h + x)
        pre = h + x
        a = self.adapter_up(torch.relu(self.adapter_down(self.norm(pre))))
        return self.norm(a + pre)


class _AttentionLayer(nn.Module):
    """attn -> attn_out -> ffn; shared by the self- and cross-attention
    layers, which differ in where keys come from, in `use_pallas` and in
    `fuse_qkv` (`self_attention`)."""

    def __init__(self, cfg: EncoderConfig, self_attention: bool,
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
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
            adapter_size=cfg.adapter_size if self_attention else 0,
            device=dev, generator=gen)

    def shard_model_axis(self, shard, specs) -> tuple:
        """`parallel.tensor.tensor_parallel`'s hook, after its children's:
        the heads laid out for a row-parallel attention output."""
        if self.attn_out.dense.mode == "row":
            self.attn.shard_heads(shard)
        return ()


def history_kv(x, bias, history, history_bias):
    """The history KV-concat's keys/values and bias: [history; x] and the
    history's additive bias broadcast and put in front of the layer's own
    (a missing one of either is zeros)."""
    B, S, Sh = x.shape[0], x.shape[1], history.shape[1]
    kv = torch.cat([history.to(x.dtype), x], dim=1)
    if bias is None:
        bias = torch.zeros(B, 1, 1, S, device=x.device)
    if history_bias is None:
        history_bias = torch.zeros(B, 1, 1, Sh, device=x.device)
    history_bias = history_bias.to(bias.dtype).expand(*bias.shape[:-1], Sh)
    return kv, torch.cat([history_bias, bias], dim=-1)


class SelfAttentionLayer(_AttentionLayer):
    """Self-attention + FFN; `cfg.use_pallas` routes attention through the
    fused kernel.

    `history` (B, Sh, H) and `history_bias` (additive, broadcastable to
    (B, 1, 1, Sh)) are the reference's `history_state` KV-concat (the
    ChunkAlign decoder variants): queries come from `x`, keys and values
    from [history; x] (`history_kv`), so with `use_pallas` the kernel runs
    at Sq < Sk. A fused `qkv` projection cannot take it: its one matrix
    projects x alone."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__(cfg, True, dtype, device, generator)

    def forward(self, x, bias=None, dropout_gen=None, history=None,
                history_bias=None):
        kv = None
        if history is not None:
            if self.attn.fuse_qkv:
                raise ValueError(
                    "history KV-concat needs separate query/key/value "
                    "projections; this layer has a fused qkv (fuse_qkv)")
            kv, bias = history_kv(x, bias, history, history_bias)
        a = self.attn(x, kv=kv, bias=bias, dropout_gen=dropout_gen)
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
    """Self-attention stack of `cfg.num_hidden_layers` layers. With
    `cfg.remat`, a forward under grad rematerialises its layers under
    `cfg.remat_policy` (`icka_tpu_torch.nn.remat`); without grad
    (inference, K1) the layers run plain.

    `history_states` (one (B, Sh, H) entry per layer, an entry may be None)
    injects each layer's history KV-concat (`encoder_history_states` of the
    reference's ChunkAlign decoders); `history_mask` (B, Sh) masks the
    history keys (default: all visible)."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__(SelfAttentionLayer, cfg, cfg.num_hidden_layers,
                         dtype, device, generator)
        self.remat_policy = cfg.remat_policy if cfg.remat else None

    def forward(self, x, bias=None, dropout_gen=None, history_states=None,
                history_mask=None):
        policy = self.remat_policy
        hbias = (None if history_mask is None
                 else additive_mask(history_mask).to(x.device))
        for i, layer in enumerate(self.layers()):
            hist = None if history_states is None else history_states[i]
            if policy is not None and rematerialised(policy, i):
                x = remat_call(layer, policy, x, bias, dropout_gen, hist,
                               hbias)
            else:
                x = layer(x, bias, dropout_gen, hist, hbias)
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


class GatedCrossAttention(nn.Module):
    """Bart-style MHA with pre-scaled queries, temperature and optional
    negated attention (`cross_attention_Y`): projections `q_proj`, `k_proj`,
    `v_proj` and `out_proj`, head_dim^-0.5 and `tau` folded into the plain
    core, as in the JAX module. The reference masks with `masked_fill`
    before dividing by tau, which the additive -10000 bias reproduces."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=torch.float32,
                 dropout_rate: float = 0.0, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(embed_dim, embed_dim, dtype=dtype,
                                        device=dev, generator=gen))

    def forward(self, x, kv=None, bias=None, tau=1.0, neg_type=False,
                prior=None, dropout_gen=None):
        kv = x if kv is None else kv
        N = self.num_heads
        q = _split_heads(self.q_proj(x), N)
        k = _split_heads(self.k_proj(kv), N)
        v = _split_heads(self.v_proj(kv), N)
        ctx = dot_product_attention(
            q, k, v, bias=bias, dtype=self.dtype,
            dropout_rate=self.dropout_rate, dropout_gen=dropout_gen,
            scale=q.shape[-1] ** -0.5, tau=tau, neg_type=neg_type,
            prior=prior)
        return self.out_proj(_merge_heads(ctx))
