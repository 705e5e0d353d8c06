"""Text encoders: legacy-BERT and RoBERTa semantics on one stack (port of
`icka_tpu.nn.bert`). `EncoderConfig.position_offset` selects the dialect:
0 gives BERT-style 0-based positions, >0 RoBERTa-style pad-aware cumsum.
Every `forward` takes `dropout_gen` (see `icka_tpu_torch.nn.attention`):
None runs deterministically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.core.mesh import MODEL_AXIS
from icka_tpu_torch.nn.attention import Encoder, Pooler
from icka_tpu_torch.nn.layers import LayerNorm, additive_mask, dropout
from icka_tpu_torch.parallel.tensor import vocab_parallel_embedding


def roberta_position_ids(input_ids, pad_token_id: int):
    """HF RoBERTa position ids: consecutive positions for non-pad tokens,
    starting at pad_token_id+1; pad positions get pad_token_id."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def mask_position_ids(attention_mask, pad_token_id: int):
    """RoBERTa-style position ids from an attention mask (spliced sequences
    have no token ids)."""
    m = attention_mask.long()
    return torch.cumsum(m, dim=1) * m + pad_token_id


class TextEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LayerNorm -> dropout.

    `embed_tokens` / `finalize` split the pipeline so callers can transform
    token embeddings (prompt splicing) before positions are assigned. On a
    model axis that splits `word_embeddings` the lookup is
    vocabulary-parallel (`parallel.tensor.vocab_parallel_embedding`)."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.hidden_size
        for name, rows in (("word_embeddings", cfg.vocab_size),
                           ("position_embeddings",
                            cfg.max_position_embeddings),
                           ("token_type_embeddings", cfg.type_vocab_size)):
            p = nn.Parameter(torch.empty(rows, H, device=dev))
            nn.init.normal_(p, 0.0, 0.02, generator=gen)
            self.register_parameter(name, p)
        self.norm = LayerNorm(H, eps=cfg.layer_norm_eps, dtype=dtype,
                              device=dev)
        self.vocab_shard = None

    def shard_model_axis(self, shard, specs) -> tuple:
        """`parallel.tensor.tensor_parallel`'s hook: the lookup is
        vocabulary-parallel where the specs split `word_embeddings`."""
        if MODEL_AXIS in specs["word_embeddings"]:
            self.vocab_shard = shard
        return ()

    def embed_tokens(self, input_ids):
        if self.vocab_shard is not None:
            return vocab_parallel_embedding(input_ids, self.word_embeddings,
                                            self.vocab_shard)
        return F.embedding(input_ids, self.word_embeddings)

    def finalize(self, inputs_embeds, position_ids, token_type_ids,
                 dropout_gen=None):
        x = (inputs_embeds
             + F.embedding(position_ids, self.position_embeddings)
             + F.embedding(token_type_ids, self.token_type_embeddings))
        return dropout(self.norm(x.to(self.dtype)),
                       self.cfg.hidden_dropout_prob, dropout_gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                dropout_gen=None, inputs_embeds=None):
        """`inputs_embeds` (B, S, H), when given, replaces the word
        embeddings of `input_ids` (which may then be None). As in the JAX
        module, RoBERTa's pad-aware positions need `input_ids`: from
        `inputs_embeds` alone the positions are 0..S-1 in both dialects."""
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        B, S = inputs_embeds.shape[:2]
        dev = inputs_embeds.device
        if position_ids is not None:
            pass                       # the caller's (packed segments)
        elif cfg.position_offset > 0 and input_ids is not None:
            position_ids = roberta_position_ids(input_ids, cfg.pad_token_id)
        else:
            position_ids = torch.arange(S, device=dev).expand(B, S)
        if token_type_ids is None:
            token_type_ids = torch.zeros(B, S, dtype=torch.long, device=dev)
        return self.finalize(inputs_embeds, position_ids, token_type_ids,
                             dropout_gen)


class TextEncoder(nn.Module):
    """Embeddings + transformer stack (+ optional pooler); returns
    (sequence_output, pooled_output or None). `attention_mask` is a (B, S)
    key mask or a (B, 1, S, S) mask (packed rows: block-diagonal by
    segment); `position_ids` override the dialect's own; `inputs_embeds`
    (B, S, H) replaces the word embeddings (see `TextEmbeddings.forward`),
    and without `attention_mask` every one of its S positions is a key."""

    def __init__(self, cfg: EncoderConfig, with_pooler: bool = True,
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.embeddings = TextEmbeddings(cfg, dtype=dtype, device=dev,
                                         generator=gen)
        self.encoder = Encoder(cfg, dtype=dtype, device=dev, generator=gen)
        self.pooler = (Pooler(cfg.hidden_size, dtype=dtype, device=dev,
                              generator=gen) if with_pooler else None)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_gen=None, inputs_embeds=None):
        if attention_mask is None:
            ref = input_ids if input_ids is not None else inputs_embeds[..., 0]
            attention_mask = torch.ones(ref.shape[:2], dtype=torch.long,
                                        device=ref.device)
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            dropout_gen, inputs_embeds)
        x = self.encoder(x, additive_mask(attention_mask), dropout_gen)
        pooled = self.pooler(x) if self.pooler is not None else None
        return x, pooled


def splice_prompt(seq, prompt, m1: int, m2: int):
    """Replace positions m1 and m2 of `seq` (dim 1) with the two halves of
    `prompt` (dim 1, even length). Works for (B, L) masks and (B, L, D)
    embeddings."""
    P = prompt.shape[1] // 2
    return torch.cat([seq[:, :m1], prompt[:, :P], seq[:, m1 + 1:m2],
                      prompt[:, P:], seq[:, m2 + 1:]], dim=1)


class PromptSpliceEncoder(nn.Module):
    """RoBERTa encoder that splices learned prompt embeddings in place of
    the two `<mask>` placeholder tokens at the static `mask_positions`,
    giving output length L - 2 + 2*prompt_len. Position ids are assigned
    RoBERTa-style over the spliced layout; prompt slots take the token type
    of the placeholder they replace. Returns (sequence_output,
    spliced_attention_mask).

    With `prompt_gather` (sequence-packed rows) the host has already laid
    the row out in spliced form: `input_ids` carries pad placeholders at the
    prompt-vector positions, `prompt_embeddings` is a flat (B, K, H) table
    (K = slots x 2 x prompt_len), `prompt_gather` (B, L) int64 indexes it per
    position (K = not a prompt slot), `attention_mask` is the (B, 1, L, L)
    block-diagonal mask, and `position_ids` / `token_type_ids` come from the
    host per segment; `prompt_mask` and `mask_positions` are unused."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg, dtype=dtype, device=dev,
                                         generator=gen)
        self.encoder = Encoder(cfg, dtype=dtype, device=dev, generator=gen)

    def forward(self, input_ids, attention_mask, token_type_ids,
                prompt_embeddings, prompt_mask, mask_positions,
                position_ids=None, prompt_gather=None, dropout_gen=None):
        emb = self.embeddings
        tok = emb.embed_tokens(input_ids)
        if prompt_gather is not None:
            B, K, H = prompt_embeddings.shape
            table = torch.cat([prompt_embeddings.to(tok.dtype),
                               tok.new_zeros(B, 1, H)], dim=1)
            pv = table.gather(1, prompt_gather[:, :, None].expand(-1, -1, H))
            spliced = torch.where((prompt_gather < K)[:, :, None], pv, tok)
            x = emb.finalize(spliced, position_ids, token_type_ids,
                             dropout_gen)
            return (self.encoder(x, additive_mask(attention_mask),
                                 dropout_gen), attention_mask)
        m1, m2 = mask_positions
        P = prompt_embeddings.shape[1] // 2
        spliced = splice_prompt(tok, prompt_embeddings.to(tok.dtype), m1, m2)
        spliced_mask = splice_prompt(attention_mask.long(),
                                     prompt_mask.long(), m1, m2)
        type1 = token_type_ids[:, m1:m1 + 1].expand(-1, P)
        type2 = token_type_ids[:, m2:m2 + 1].expand(-1, P)
        spliced_types = torch.cat(
            [token_type_ids[:, :m1], type1, token_type_ids[:, m1 + 1:m2],
             type2, token_type_ids[:, m2 + 1:]], dim=1)
        position_ids = mask_position_ids(spliced_mask, self.cfg.pad_token_id)
        x = emb.finalize(spliced, position_ids, spliced_types, dropout_gen)
        x = self.encoder(x, additive_mask(spliced_mask), dropout_gen)
        return x, spliced_mask
