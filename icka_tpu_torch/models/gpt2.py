"""GPT-2 decoder and the encoder-decoder captioner (port of
`icka_tpu.models.gpt2`).

The reference's vestigial GPT-2 caption/cls hybrid
(`modeling/modeling_transfomres.py`, component #23): a pre-LN GPT-2 stack
(`Attention/MLP/Block` :266-470, `GPT2Model` :752) that may cross-attend
over an encoder's memory. The JAX package's per-head einsums, static
causal mask and fp32 softmax, on the port's plain attention core (the JAX
decoder does not route through the kernel either). `generation.gpt2_cache`
decodes the same weights incrementally.

`GPT2Captioner` (`BertForImageCaptioningAndCls`, :729) puts the decoder
over ChunkAlign's `GlobalVLEncoder`, whose self-attention runs through K1
with `cfg.encoder.use_pallas`, and a CLS head on its pooled output;
`generate_gpt2_captions` decodes it by full recompute (each step re-runs
the decoder over the token buffer) through `generation`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.generation.decoding import beam_search, greedy_decode
from icka_tpu_torch.nn.attention import (_merge_heads, _split_heads,
                                         dot_product_attention)
from icka_tpu_torch.nn.layers import Dense, LayerNorm, additive_mask


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_eps: float = 1e-5
    # encoder (for the captioning hybrid)
    encoder: EncoderConfig = field(default_factory=EncoderConfig.bert_base)
    img_feature_dim: int = 2048

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "GPT2Config":
        enc = EncoderConfig(
            vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, position_offset=0, pad_token_id=0)
        return cls(vocab_size=vocab_size, n_positions=32, n_embd=32,
                   n_layer=2, n_head=4, encoder=enc, img_feature_dim=16)


class GPT2Block(nn.Module):
    """Pre-LN transformer block: causal self-attention (one `c_attn`
    projection to q, k, v), optional cross-attention over `memory`, and a
    tanh-gelu MLP."""

    def __init__(self, cfg: GPT2Config, with_cross: bool = False,
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        D, eps = cfg.n_embd, cfg.layer_norm_eps
        self.cfg = cfg
        self.dtype = dtype
        self.with_cross = with_cross

        def dense(i, o):
            return Dense(i, o, dtype=dtype, device=dev, generator=gen)

        def norm():
            return LayerNorm(D, eps=eps, dtype=dtype, device=dev)

        self.ln_1 = norm()
        self.c_attn = dense(D, 3 * D)
        self.c_proj = dense(D, D)
        if with_cross:
            self.ln_cross = norm()
            self.q_cross = dense(D, D)
            self.k_cross = dense(D, D)
            self.v_cross = dense(D, D)
            self.cross_proj = dense(D, D)
        self.ln_2 = norm()
        self.c_fc = dense(D, 4 * D)
        self.mlp_proj = dense(4 * D, D)

    def forward(self, x, causal_bias, memory=None, memory_bias=None):
        N = self.cfg.n_head
        q, k, v = self.c_attn(self.ln_1(x)).split(x.shape[-1], dim=-1)
        q, k, v = (_split_heads(t, N) for t in (q, k, v))
        ctx = dot_product_attention(q, k, v, bias=causal_bias,
                                    dtype=self.dtype)
        x = x + self.c_proj(_merge_heads(ctx))

        if self.with_cross and memory is not None:
            h = self.ln_cross(x)
            q = _split_heads(self.q_cross(h), N)
            k = _split_heads(self.k_cross(memory), N)
            v = _split_heads(self.v_cross(memory), N)
            ctx = dot_product_attention(q, k, v, bias=memory_bias,
                                        dtype=self.dtype)
            x = x + self.cross_proj(_merge_heads(ctx))

        h = F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh")
        return x + self.mlp_proj(h)


class GPT2Decoder(nn.Module):
    """GPT-2 LM stack, optionally cross-attending over encoder memory;
    logits from the tied `wte`.

    `return_hidden=True` yields the final pre-logits hidden states instead,
    for heads with a separate untied `lm_head` (the ChunkAlign dec5_4
    family, `modeling_vcr_chunkalign_v10.py:1338`)."""

    def __init__(self, cfg: GPT2Config, with_cross: bool = True,
                 dtype=torch.float32, return_hidden: bool = False,
                 device="cuda", seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.dtype = dtype
        self.return_hidden = return_hidden
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd,
                                            device=dev))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd,
                                            device=dev))
        nn.init.normal_(self.wte, 0.0, 0.02, generator=gen)
        nn.init.normal_(self.wpe, 0.0, 0.01, generator=gen)
        self.n_layer = cfg.n_layer
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", GPT2Block(
                cfg, with_cross=with_cross, dtype=dtype, device=dev,
                generator=gen))
        self.ln_f = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps,
                              dtype=dtype, device=dev)

    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.n_layer)]

    def forward(self, input_ids, attention_mask=None, memory=None,
                memory_mask=None):
        L = input_ids.shape[1]
        x = (F.embedding(input_ids, self.wte)
             + self.wpe[None, :L]).to(self.dtype)
        causal = torch.tril(torch.ones(L, L, device=x.device))[None, None]
        bias = (1.0 - causal) * -10000.0
        if attention_mask is not None:
            bias = bias + additive_mask(attention_mask)
        mem_bias = (additive_mask(memory_mask)
                    if memory_mask is not None else None)
        for block in self.blocks():
            x = block(x, bias, memory, mem_bias)
        x = self.ln_f(x)
        if self.return_hidden:
            return x
        return torch.einsum("bld,vd->blv", x.float(), self.wte.float())


class GPT2Captioner(nn.Module):
    """VL encoder (`encoder`, ChunkAlign's `GlobalVLEncoder` on
    `cfg.encoder` and `cfg.img_feature_dim`) -> GPT-2 decoder (`decoder`,
    cross-attending over the encoder's sequence) with a `cls_head` on the
    pooled output when `num_cls_labels` > 0."""

    def __init__(self, cfg: GPT2Config, num_cls_labels: int = 0,
                 dtype=torch.float32, device="cuda", seed: int | None = None,
                 generator=None):
        super().__init__()
        from icka_tpu_torch.models.chunkalign import (ChunkAlignConfig,
                                                      GlobalVLEncoder)

        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.num_cls_labels = num_cls_labels
        ca = ChunkAlignConfig(encoder=cfg.encoder,
                              img_feature_dim=cfg.img_feature_dim)
        self.encoder = GlobalVLEncoder(ca, dtype=dtype, device=dev,
                                       generator=gen)
        self.decoder = GPT2Decoder(cfg, with_cross=True, dtype=dtype,
                                   device=dev, generator=gen)
        if num_cls_labels:
            self.cls_head = Dense(cfg.encoder.hidden_size, num_cls_labels,
                                  dtype=dtype, device=dev, generator=gen)

    def encode(self, input_ids, img_feats, input_mask, dropout_gen=None):
        """(memory (B, Le + Li, H), pooled (B, H))."""
        return self.encoder(input_ids, img_feats, input_mask,
                            dropout_gen=dropout_gen)

    def forward(self, enc_ids, img_feats, enc_mask, caption_ids, cap_mask,
                labels=None, cls_labels=None, dropout_gen=None):
        """{"logits"} (B, Lc, V), "cls_logits" with the CLS head, and with
        `labels` the "loss": next-token cross-entropy over the valid caption
        positions, plus the CLS cross-entropy where `cls_labels` are
        given."""
        memory, pooled = self.encode(enc_ids, img_feats, enc_mask,
                                     dropout_gen)
        logits = self.decoder(caption_ids, cap_mask, memory, enc_mask)
        out = {"logits": logits}
        if self.num_cls_labels:
            out["cls_logits"] = self.cls_head(pooled)
        if labels is not None:
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            ll = logp.gather(-1, labels[:, 1:].long()[..., None])[..., 0]
            m = cap_mask[:, 1:].float()
            out["loss"] = -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)
            if cls_labels is not None and self.num_cls_labels:
                clogp = torch.log_softmax(out["cls_logits"], dim=-1)
                out["loss"] = out["loss"] - clogp.gather(
                    1, cls_labels.long()[:, None]).mean()
        return out

    def decode_step(self, tokens_buf, memory, enc_mask, t: int):
        """Logits (B, V) at position t of the buffered prefix, positions
        after t masked: the decoder over the whole buffer."""
        B, L = tokens_buf.shape
        pos = torch.arange(L, device=tokens_buf.device)[None, :]
        logits = self.decoder(tokens_buf, (pos <= t).expand(B, L).long(),
                              memory, enc_mask)
        return logits[:, t]


@torch.no_grad()
def generate_gpt2_captions(model: GPT2Captioner, enc_ids, img_feats,
                           enc_mask, bos_id: int, eos_id: int, max_len: int,
                           mode: str = "greedy", num_beams: int = 3, **kw):
    """Greedy (a `DecodeState`) or beam (a `BeamResult`) decoding from
    `bos_id`, the encoder run once; the cache carries the token buffer,
    the memory and its mask (re-gathered with the beams)."""
    memory, _ = model.encode(enc_ids, img_feats, enc_mask)
    B = memory.shape[0]
    dev = memory.device
    cache = {"tokens": torch.zeros(B, max_len, dtype=torch.long, device=dev),
             "memory": memory,
             "enc_mask": torch.as_tensor(enc_mask, device=dev)}

    def step(tokens_t, cache, t):
        buf = cache["tokens"].clone()
        buf[:, t] = tokens_t
        logits = model.decode_step(buf, cache["memory"], cache["enc_mask"],
                                   t)
        return logits, {**cache, "tokens": buf}

    init = torch.full((B,), bos_id, dtype=torch.long, device=dev)
    if mode == "greedy":
        return greedy_decode(step, init, cache, max_len, eos_id, **kw)
    if mode == "beam":
        return beam_search(step, init, cache, max_len, eos_id,
                           num_beams=num_beams, **kw)
    raise ValueError(f"unknown mode {mode!r}")
