"""Image captioning: the seq2seq-masked VL BERT with an LM head, and
decoding through `generation` (port of `icka_tpu.models.captioning`).

The reference's vestigial captioning stack (components #21/#22):
`BertForImageCaptioning` (`modeling/modeling_bert.py:744`) trains a joint
text + image encoder with a causal (seq2seq) mask over the caption region
and a masked-LM head, and generates through
`CaptionPreTrainedModel.generate`; here through `generation` (greedy,
sample, beam; the constrained search plugs into the same step function).

`decode_step` re-encodes the whole prefix each step (the cache carries the
token buffer). The encoder is the port's `Encoder`, so with
`cfg.encoder.use_pallas` every self-attention runs through K1 with the full
(B, 1, L, L) seq2seq bias. `generation.kv_cache` decodes the same weights
incrementally.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.generation.decoding import (beam_search, greedy_decode,
                                                sample_decode)
from icka_tpu_torch.nn.attention import Encoder
from icka_tpu_torch.nn.bert import TextEmbeddings
from icka_tpu_torch.nn.layers import Dense, LayerNorm, gelu


@dataclass(frozen=True)
class CaptionConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig.bert_base)
    img_feature_dim: int = 2048
    max_caption_len: int = 40
    max_regions: int = 50
    tie_word_embeddings: bool = True

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "CaptionConfig":
        enc = EncoderConfig(
            vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=128, layer_norm_eps=1e-12,
            position_offset=0, pad_token_id=0)
        return cls(encoder=enc, img_feature_dim=16, max_caption_len=8,
                   max_regions=5)


def seq2seq_mask(cap_len: int, img_len: int, cap_mask, img_mask):
    """(B, 1, L, L) additive bias: caption rows attend causally over the
    caption and fully over valid image regions; image rows attend over
    valid image regions and not the caption (the Oscar captioning mask)."""
    B = cap_mask.shape[0]
    L = cap_len + img_len
    dev = cap_mask.device
    causal = torch.tril(torch.ones(cap_len, cap_len, device=dev))
    capm = cap_mask.float()
    imgm = img_mask.float()
    rows = torch.zeros(B, L, L, device=dev)
    rows[:, :cap_len, :cap_len] = causal[None] * capm[:, None, :]
    rows[:, :cap_len, cap_len:] = imgm[:, None, :]
    rows[:, cap_len:, cap_len:] = imgm[:, None, :]
    return ((1.0 - rows) * -10000.0)[:, None]


class CaptionModel(nn.Module):
    """Caption embeddings + projected region features -> `Encoder` under
    the seq2seq mask -> LM head (transform, gelu, LayerNorm, then the word
    embeddings when tied, else `lm_decoder`; plus `lm_bias`). Submodules
    carry the flax names."""

    def __init__(self, cfg: CaptionConfig, dtype=torch.float32,
                 device="cuda", seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        enc = cfg.encoder
        H = enc.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = TextEmbeddings(enc, dtype=dtype, device=dev,
                                         generator=gen)
        self.img_embedding = Dense(cfg.img_feature_dim, H, dtype=dtype,
                                   device=dev, generator=gen)
        self.encoder = Encoder(enc, dtype=dtype, device=dev, generator=gen)
        self.lm_transform = Dense(H, H, dtype=dtype, device=dev,
                                  generator=gen)
        self.lm_norm = LayerNorm(H, eps=enc.layer_norm_eps, dtype=dtype,
                                 device=dev)
        if not cfg.tie_word_embeddings:
            self.lm_decoder = Dense(H, enc.vocab_size, dtype=dtype,
                                    device=dev, generator=gen)
        self.lm_bias = nn.Parameter(torch.zeros(enc.vocab_size, device=dev))

    def _lm_logits(self, hidden):
        h = self.lm_norm(gelu(self.lm_transform(hidden)))
        if self.cfg.tie_word_embeddings:
            logits = torch.einsum("bld,vd->blv", h.float(),
                                  self.embeddings.word_embeddings.float())
        else:
            logits = self.lm_decoder(h).float()
        return logits + self.lm_bias

    def encode(self, caption_ids, cap_mask, img_feats, img_mask,
               dropout_gen=None):
        cap_len = caption_ids.shape[1]
        img_len = img_feats.shape[1]
        txt = self.embeddings(caption_ids, dropout_gen=dropout_gen)
        img = self.img_embedding(img_feats.to(self.dtype))
        x = torch.cat([txt, img], dim=1)
        bias = seq2seq_mask(cap_len, img_len, cap_mask, img_mask)
        return self.encoder(x, bias, dropout_gen)

    def forward(self, caption_ids, cap_mask, img_feats, img_mask,
                labels=None, dropout_gen=None):
        """Logits (B, Lc, V); with `labels`, (loss, logits): next-token
        cross-entropy over valid caption positions."""
        cap_len = caption_ids.shape[1]
        hidden = self.encode(caption_ids, cap_mask, img_feats, img_mask,
                             dropout_gen)
        logits = self._lm_logits(hidden[:, :cap_len])
        if labels is None:
            return logits
        # predict token t+1 from position t
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        tok_ll = logp.gather(-1, labels[:, 1:, None].long())[..., 0]
        mask = cap_mask[:, 1:].float()
        loss = -(tok_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, logits

    def decode_step(self, tokens_buf, img_feats, img_mask, t: int):
        """Logits (B, V) for position t given the buffered prefix (the whole
        prefix re-encoded; positions after t masked). The LM head runs on
        position t only: the same function as the JAX package's head over
        every position, indexed at t."""
        B, cap_len = tokens_buf.shape
        pos = torch.arange(cap_len, device=tokens_buf.device)[None, :]
        cap_mask = (pos <= t).expand(B, cap_len).long()
        hidden = self.encode(tokens_buf, cap_mask, img_feats, img_mask)
        return self._lm_logits(hidden[:, t:t + 1])[:, 0]


def make_caption_step_fn(model: CaptionModel):
    """StepFn for the generation engine. The cache carries the token buffer
    (B, max_len) and the image features and mask, so beam search and the
    constrained search re-gather them with the hypotheses."""

    def step(tokens_t, cache, t):
        buf = cache["tokens"].clone()
        buf[:, t] = tokens_t
        logits = model.decode_step(buf, cache["img_feats"],
                                   cache["img_mask"], t)
        return logits, {**cache, "tokens": buf}

    return step


@torch.no_grad()
def generate_captions(model: CaptionModel, bos_id: int, eos_id: int,
                      img_feats, img_mask, max_len: int, mode="greedy",
                      num_beams: int = 3, generator=None, **kw):
    """The `CaptionPreTrainedModel.generate` surface: greedy, sample or
    beam over image features. "sample" draws from `generator` (a
    `torch.Generator` on the model's device; a fresh one seeded 0 when
    None), where the JAX package takes a key."""
    dev = model.lm_bias.device
    img_feats = torch.as_tensor(img_feats, device=dev).float()
    B = img_feats.shape[0]
    cache = {"tokens": torch.zeros(B, max_len, dtype=torch.long, device=dev),
             "img_feats": img_feats,
             "img_mask": torch.as_tensor(img_mask, device=dev).long()}
    init = torch.full((B,), bos_id, dtype=torch.long, device=dev)
    step = make_caption_step_fn(model)
    if mode == "greedy":
        return greedy_decode(step, init, cache, max_len, eos_id, **kw)
    if mode == "sample":
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return sample_decode(step, init, cache, max_len, eos_id,
                             generator=generator, **kw)
    if mode == "beam":
        return beam_search(step, init, cache, max_len, eos_id,
                           num_beams=num_beams, **kw)
    raise ValueError(f"unknown mode {mode!r}")
