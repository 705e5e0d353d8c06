"""ChunkAlign VCR models: staged chunk/cross-modal attention and the aligned
CLS (port of `icka_tpu.models.chunkalign`).

The reference's VCR model core (`modeling/modeling_vcr_chunkalign_v10.py`,
component #20):

  - `StagedVLEncoder` ≙ `SeqBertImgModel` (:235) over `CaptionBertEncoder`
    (:153): a joint text + image-region transformer whose attention bias
    changes by stage: the chunk layers see chunk-internal text and the
    image keys, the cross-chunk layers everything, the cross-modal layers
    take chunk-mean queries and leave each image row its own key only
    (:166-206). Its attention is the plain core, as in the JAX package,
    which calls `dot_product_attention` directly: each layer also returns
    its fp32 probabilities for the align loss;
  - `chunk_mean_queries` ≙ the reference's per-sample `index_add` loop
    (:66-78) as a one-hot segment mean over a chunk-id map;
  - `GlobalVLEncoder` ≙ the `BertImgModel`-style global encoder
    (`modeling/modeling_bert.py:158`): the port's `Encoder`, so with
    `cfg.encoder.use_pallas` every self-attention runs through K1, with
    the history KV-concat where one is given;
  - `ChunkAlignCLS` ≙ `ChunkAlign_CLS_enc4_align` (:1019) and its
    `_wo_chual` / `_wo_reasoning` variants (config flags);
  - `ChunkAlignRationale` ≙ `ChunkAlign_CLS_dec5_4` (:1322-1499) with a
    GPT-2 rationale decoder; `generate_rationale` decodes it on the KV
    cache in greedy, beam and constrained modes (the `_beam` family).

Submodules carry the flax names, so `icka_tpu_torch.convert` carries the
JAX package's weights. Every `forward` takes `dropout_gen` (see
`icka_tpu_torch.nn.attention`): None runs deterministically.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.nn.attention import (AttentionOutput, Encoder,
                                         FeedForward, MultiHeadAttention,
                                         Pooler, _merge_heads, _split_heads)
from icka_tpu_torch.nn.bert import TextEmbeddings
from icka_tpu_torch.nn.layers import Dense, additive_mask


@dataclass(frozen=True)
class ChunkAlignConfig:
    encoder: EncoderConfig = field(
        default_factory=EncoderConfig.bert_base)
    img_feature_dim: int = 2048
    max_hypo: int = 50
    chunk_layers: tuple = (0, 1, 2)
    cross_chunk_layers: tuple = (3, 4, 5, 6, 7, 8)
    cross_modal_layers: tuple = (9, 10, 11)
    add_residual: bool = True
    add_local_residual: bool = False
    num_choices: int = 4
    # family variant flags (reference classes -> flags):
    #   use_chunk_align=False -> `_wo_chual` (:1255, dec :1654): no staged
    #     chunk encoder; CLS and memory come from the global encoder only
    #   use_reasoning=False -> `_wo_reasoning` (:1171, dec :1500): no CLS
    #     cross-attention reasoning layers before the classifier
    use_chunk_align: bool = True
    use_reasoning: bool = True

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "ChunkAlignConfig":
        enc = EncoderConfig(
            vocab_size=vocab_size, hidden_size=32, num_hidden_layers=6,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=128, layer_norm_eps=1e-12,
            position_offset=0, pad_token_id=0)
        return cls(encoder=enc, img_feature_dim=16, max_hypo=10,
                   chunk_layers=(0,), cross_chunk_layers=(1, 2, 3),
                   cross_modal_layers=(4, 5), num_choices=4)


def chunk_mean_queries(q, gather_index, token_mask, num_chunks: int):
    """Each hypothesis token's query replaced by the mean query of its
    chunk. `gather_index` (B, Lh) holds chunk ids in [0, num_chunks);
    padding tokens map to an unused (dead) chunk id, and an id outside the
    range selects no chunk, as `jax.nn.one_hot` gives. Tokens masked off
    keep their own query."""
    ids = torch.arange(num_chunks, device=q.device)
    onehot = (gather_index[..., None].long() == ids).to(q.dtype)
    onehot = onehot * token_mask[..., None].to(q.dtype)     # (B, Lh, C)
    sums = torch.einsum("blc,bld->bcd", onehot, q)
    counts = torch.clamp(onehot.sum(dim=1), min=1.0)
    means = sums / counts[..., None]
    spread = torch.einsum("blc,bcd->bld", onehot, means)
    return torch.where(token_mask[..., None] > 0, spread, q)


class StagedAttention(nn.Module):
    """Self-attention whose queries can be chunk-averaged; returns the
    context and the fp32 attention probabilities (B, N, L, L). The plain
    core without attention dropout, as the JAX module calls it."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        H = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.dtype = dtype
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(H, H, dtype=dtype, device=dev,
                                        generator=gen))

    def forward(self, x, bias, gather_index=None, token_mask=None,
                num_chunks: int = 0, chunk_query: bool = False,
                hypo_len: int = 0):
        q, k, v = self.query(x), self.key(x), self.value(x)
        if chunk_query:
            # only the hypothesis positions get chunk-mean queries
            q_h = chunk_mean_queries(q[:, :hypo_len], gather_index,
                                     token_mask, num_chunks)
            q = torch.cat([q_h, q[:, hypo_len:]], dim=1)
        N = self.num_heads
        qh, kh, vh = (_split_heads(t, N) for t in (q, k, v))
        scores = torch.einsum("bqnh,bknh->bnqk", qh.float(), kh.float())
        scores = scores * qh.shape[-1] ** -0.5 + bias.float()
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bnqk,bknh->bqnh", probs.to(self.dtype),
                           vh.to(self.dtype))
        return _merge_heads(ctx), probs


class StagedLayer(nn.Module):
    """`attn` (StagedAttention) -> `attn_out` -> `ffn`, both sublayers at
    the JAX module's default dropout of 0.1."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attn = StagedAttention(cfg, dtype=dtype, device=dev,
                                    generator=gen)
        self.attn_out = AttentionOutput(H, eps, dtype=dtype, device=dev,
                                        generator=gen)
        self.ffn = FeedForward(H, cfg.intermediate_size, eps, dtype=dtype,
                               device=dev, generator=gen)

    def forward(self, x, bias, dropout_gen=None, **chunk_kw):
        a, probs = self.attn(x, bias, **chunk_kw)
        x = self.attn_out(a, x, dropout_gen)
        return self.ffn(x, dropout_gen), probs


class _VLEmbeddings(nn.Module):
    """`embeddings` (text) and `img_embedding` (regions), concatenated."""

    def _build_embeddings(self, cfg, dtype, dev, gen):
        enc = cfg.encoder
        self.embeddings = TextEmbeddings(enc, dtype=dtype, device=dev,
                                         generator=gen)
        self.img_embedding = Dense(cfg.img_feature_dim, enc.hidden_size,
                                   dtype=dtype, device=dev, generator=gen)

    def embed(self, input_ids, img_feats, token_type_ids, dropout_gen):
        txt = self.embeddings(input_ids, token_type_ids,
                              dropout_gen=dropout_gen)
        img = self.img_embedding(img_feats.to(self.dtype))
        return torch.cat([txt, img], dim=1)


def stage_biases(input_mask, chunk_mask, Lh: int, Li: int):
    """(full, stage A, stage C) additive biases. Stage A: text rows see
    chunk-internal text and the visible image, image rows none of the text
    (reference :178-183); stage C: text rows as stage A, each image row
    its own key only (:190-200)."""
    B = input_mask.shape[0]
    L = Lh + Li
    dev = input_mask.device
    full = additive_mask(input_mask).to(dev)                 # (B,1,1,L)
    chunk_bias = (1.0 - chunk_mask.float()) * -10000.0
    stage_a = full.expand(B, 1, L, L).clone()
    stage_a[:, :, :Lh, :Lh] = chunk_bias[:, None]
    stage_a[:, :, Lh:, :Lh] = -10000.0
    img_rows = torch.cat([torch.zeros(Li, Lh, device=dev),
                          torch.eye(Li, device=dev)], dim=1)
    stage_c = full.expand(B, 1, L, L).clone()
    stage_c[:, :, :Lh, :Lh] = chunk_bias[:, None]
    stage_c[:, :, Lh:, :] = (1.0 - img_rows) * -10000.0
    return full, stage_a, stage_c


class StagedVLEncoder(_VLEmbeddings):
    """SeqBertImgModel. Inputs: `input_ids` (B, Lh) hypothesis tokens (CLS
    first), `img_feats` (B, Li, img_dim), `input_mask` (B, Lh + Li),
    `chunk_mask` (B, Lh, Lh) 0/1 chunk-internal visibility, `gather_index`
    (B, Lh) chunk id per hypothesis token, `num_chunks` the static chunk
    count. Returns (sequence, pooled CLS, the cross-modal layers' fp32
    attention probabilities (B, n, N, L, L), chunk_hidden)."""

    def __init__(self, cfg: ChunkAlignConfig, dtype=torch.float32,
                 device="cuda", seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.dtype = dtype
        self._build_embeddings(cfg, dtype, dev, gen)
        self.num_layers = cfg.encoder.num_hidden_layers
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", StagedLayer(
                cfg.encoder, dtype=dtype, device=dev, generator=gen))
        self.pooler = Pooler(cfg.encoder.hidden_size, dtype=dtype,
                             device=dev, generator=gen)

    def forward(self, input_ids, img_feats, input_mask, chunk_mask,
                gather_index, num_chunks: int, token_type_ids=None,
                dropout_gen=None):
        cfg = self.cfg
        B, Lh = input_ids.shape
        Li = img_feats.shape[1]
        L = Lh + Li
        x = self.embed(input_ids, img_feats, token_type_ids, dropout_gen)
        full, stage_a, stage_c = stage_biases(input_mask, chunk_mask, Lh,
                                              Li)
        token_mask = input_mask[:, :Lh]
        chunk_hidden = None
        cross_probs = []
        for i in range(self.num_layers):
            cross = i in cfg.cross_modal_layers
            if i in cfg.chunk_layers:
                bias = stage_a
            elif cross:
                bias = stage_c
                if chunk_hidden is None:
                    chunk_hidden = x
            else:
                bias = full
            y, probs = getattr(self, f"layer_{i}")(
                x, bias, dropout_gen, gather_index=gather_index,
                token_mask=token_mask, num_chunks=num_chunks,
                chunk_query=cross, hypo_len=Lh)
            x = y + x if cfg.add_local_residual and cross else y
            if cross:
                cross_probs.append(probs)
        if cfg.add_residual and chunk_hidden is not None:
            x = x + chunk_hidden
        pooled = self.pooler(x)
        if cross_probs:
            probs = torch.stack(cross_probs, dim=1)
        else:               # no cross-modal stage configured (ablation)
            probs = torch.zeros(B, 1, cfg.encoder.num_attention_heads, L, L,
                                device=x.device)
        if chunk_hidden is None:
            chunk_hidden = x
        return x, pooled, probs, chunk_hidden


class GlobalVLEncoder(_VLEmbeddings):
    """Plain joint text + image encoder and pooler (the BertImgModel role):
    `embeddings`, `img_embedding`, `encoder` (the port's `Encoder`: K1 with
    `use_pallas`, remat under grad with `remat`) and `pooler`. Returns
    (sequence, pooled). `history_states` / `history_mask` reach the
    `Encoder`'s history KV-concat."""

    def __init__(self, cfg: ChunkAlignConfig, dtype=torch.float32,
                 device="cuda", seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.dtype = dtype
        self._build_embeddings(cfg, dtype, dev, gen)
        self.encoder = Encoder(cfg.encoder, dtype=dtype, device=dev,
                               generator=gen)
        self.pooler = Pooler(cfg.encoder.hidden_size, dtype=dtype,
                             device=dev, generator=gen)

    def forward(self, input_ids, img_feats, input_mask, token_type_ids=None,
                dropout_gen=None, history_states=None, history_mask=None):
        x = self.embed(input_ids, img_feats, token_type_ids, dropout_gen)
        x = self.encoder(x, additive_mask(input_mask).to(x.device),
                         dropout_gen, history_states=history_states,
                         history_mask=history_mask)
        return x, self.pooler(x)


class ClsAttentionLayer(nn.Module):
    """The CLS token cross-attends over an alignment memory (`ClsLayer2`):
    `attn` (plain core, attention dropout 0.1), `attn_out`, `ffn`.

    `return_probs=True` also returns the head-averaged fp32 attention of
    the one query over the memory (B, Lm), re-derived from the layer's own
    `query`/`key` weights on the plain core: the signal the `_beam`
    decoders rank to pick constraint words (:2114-2118)."""

    def __init__(self, cfg: EncoderConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_heads = cfg.num_attention_heads
        self.attn = MultiHeadAttention(H, self.num_heads, dtype=dtype,
                                       device=dev, generator=gen)
        self.attn_out = AttentionOutput(H, eps, dtype=dtype, device=dev,
                                        generator=gen)
        self.ffn = FeedForward(H, cfg.intermediate_size, eps, dtype=dtype,
                               device=dev, generator=gen)

    def forward(self, memory, cls, mem_bias, dropout_gen=None,
                return_probs: bool = False):
        q_in = cls[:, None, :]
        a = self.attn(q_in, kv=memory, bias=mem_bias,
                      dropout_gen=dropout_gen)
        x = self.ffn(self.attn_out(a, q_in, dropout_gen), dropout_gen)
        if not return_probs:
            return x[:, 0]
        N = self.num_heads
        d = memory.shape[-1]
        qw, kw = self.attn.query, self.attn.key
        q = F.linear(cls.float(), qw.weight.float(), qw.bias.float()) \
            .reshape(-1, N, d // N)
        k = F.linear(memory.float(), kw.weight.float(), kw.bias.float()) \
            .reshape(memory.shape[0], -1, N, d // N)
        scores = torch.einsum("bnh,bknh->bnk", q, k) * (d // N) ** -0.5 \
            + mem_bias.float()[:, 0, 0][:, None, :]
        return x[:, 0], torch.softmax(scores, dim=-1).mean(dim=1)


def binary_to_mp(logits, num_choices: int):
    """Per-choice binary logits (B*C, 2) -> multiple-choice scores (B, C):
    the positive class's probability."""
    return torch.softmax(logits, dim=-1)[:, 1].reshape(-1, num_choices)


def _binary_ce(logits, label):
    """Mean cross-entropy of (N, 2) logits against (N,) class ids."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, label.long()[:, None]).mean()


def choose_row(x, row_idx, C: int):
    """(B*C, ...) -> (B, ...): row `row_idx[b]` of each group of C."""
    grouped = x.reshape((-1, C) + tuple(x.shape[1:]))
    return grouped[torch.arange(grouped.shape[0], device=x.device),
                   row_idx.long()]


class ChunkAlignCLS(nn.Module):
    """ChunkAlign_CLS_enc4_align: answer classification and the align
    loss. `global_enc`, (`seq_enc` and `cls_ensemble` with
    `use_chunk_align`), (`cls_layer_0..2` with `use_reasoning`),
    `classifier`."""

    def __init__(self, cfg: ChunkAlignConfig, dtype=torch.float32,
                 device="cuda", seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        enc = cfg.encoder
        H = enc.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.global_enc = GlobalVLEncoder(cfg, dtype=dtype, device=dev,
                                          generator=gen)
        if cfg.use_chunk_align:
            self.seq_enc = StagedVLEncoder(cfg, dtype=dtype, device=dev,
                                           generator=gen)
            self.cls_ensemble = Dense(2 * H, H, dtype=dtype, device=dev,
                                      generator=gen)
        if cfg.use_reasoning:
            for i in range(3):
                self.add_module(f"cls_layer_{i}", ClsAttentionLayer(
                    enc, dtype=dtype, device=dev, generator=gen))
        self.classifier = Dense(H, 2, dtype=dtype, device=dev,
                                generator=gen)

    def headless(self, input_ids, img_feats, input_mask, chunk_mask,
                 gather_index, num_chunks, dropout_gen=None,
                 history_states=None, history_mask=None):
        """(logits (B*C, 2), cross-modal probabilities, intermediates:
        g_seq, s_seq, chunk_hidden, word_mask, cls_attn)."""
        cfg = self.cfg
        B, Lh = input_ids.shape
        L = Lh + img_feats.shape[1]
        g_seq, g_cls = self.global_enc(
            input_ids, img_feats, input_mask, dropout_gen=dropout_gen,
            history_states=history_states, history_mask=history_mask)
        word_mask = input_mask[:, 1:Lh]
        if cfg.use_chunk_align:
            s_seq, s_cls, cross_probs, chunk_hidden = self.seq_enc(
                input_ids, img_feats, input_mask, chunk_mask, gather_index,
                num_chunks, dropout_gen=dropout_gen)
            cls = self.cls_ensemble(torch.cat([g_cls, s_cls], dim=-1))
            memory = torch.cat([g_seq[:, 1:Lh], s_seq[:, 1:Lh],
                                chunk_hidden[:, 1:Lh]], dim=1)
            mem_bias = additive_mask(torch.cat([word_mask] * 3, dim=1))
        else:
            # `_wo_chual` (:1266-1293): CLS and memory from the global
            # encoder alone; no staged encoder, no align supervision
            s_seq = chunk_hidden = g_seq
            cross_probs = torch.zeros(B, 1, cfg.encoder.num_attention_heads,
                                      L, L, device=g_seq.device)
            cls = g_cls
            memory = g_seq[:, 1:Lh]
            mem_bias = additive_mask(word_mask)
        cls_attn = None
        if cfg.use_reasoning:
            for i in range(3):
                cls, probs = getattr(self, f"cls_layer_{i}")(
                    memory, cls, mem_bias, dropout_gen, return_probs=True)
                cls_attn = probs if cls_attn is None else cls_attn + probs
        inter = {"g_seq": g_seq, "s_seq": s_seq,
                 "chunk_hidden": chunk_hidden, "word_mask": word_mask,
                 "cls_attn": cls_attn}
        return self.classifier(cls), cross_probs, inter

    def forward(self, input_ids, img_feats, input_mask, chunk_mask,
                gather_index, num_chunks: int, label=None, align_pos=None,
                total_label=None, dropout_gen=None):
        """Without `label`: (pred (B,), scores (B, C)). With it: (cls_loss,
        matched, align_loss, n_correct, n_supervised) like the reference
        forward (:1070-1083); `label` is (B*C,) binary, `align_pos` and
        `total_label` (B*C, Lh) mark the supervised positions and their
        gold region."""
        Lh = input_ids.shape[1]
        C = self.cfg.num_choices
        logits, cross_probs, _ = self.headless(
            input_ids, img_feats, input_mask, chunk_mask, gather_index,
            num_chunks, dropout_gen)
        scores = binary_to_mp(logits, C)
        pred = scores.argmax(dim=-1)
        if label is None:
            return pred, scores
        cls_loss = _binary_ce(logits, label)
        matched = pred == label.reshape(-1, C).argmax(dim=-1)
        if not self.cfg.use_chunk_align:
            zero = torch.zeros((), device=logits.device)
            return cls_loss, matched, zero, zero, zero
        align_loss, correct, n_sup = align_terms(cross_probs, Lh, align_pos,
                                                 total_label)
        return cls_loss, matched, align_loss, correct, n_sup


def align_terms(cross_probs, Lh: int, align_pos, total_label):
    """The align loss over the cross-modal layers' attention (summed over
    layers and heads, text rows against image keys, zeros made -1e5
    before the log-softmax, supervised positions only; :1074-1080), and
    the count of supervised positions whose argmax region is the gold one,
    and of supervised positions."""
    attn = cross_probs.sum(dim=(1, 2))[:, :Lh, Lh:]
    attn = torch.where(attn == 0, -1e5, attn)
    attn = torch.log_softmax(attn, dim=-1)
    sup = (align_pos > 0).float()
    gold = total_label.long()
    picked = attn.gather(-1, gold[..., None])[..., 0]
    n_sup = sup.sum()
    loss = -(picked * sup).sum() / torch.clamp(n_sup, min=1.0)
    correct = ((attn.argmax(dim=-1) == gold).float() * sup).sum()
    return loss, correct, n_sup


def lm_loss(lm_logits, labels, pad_token_id: int):
    """Next-token cross-entropy of (B, L, V) logits on `labels` (B, L),
    pad positions ignored."""
    shift_labels = labels[:, 1:].long()
    valid = (shift_labels != pad_token_id).float()
    logp = torch.log_softmax(lm_logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, shift_labels[..., None])[..., 0]
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


class ChunkAlignRationale(nn.Module):
    """`ChunkAlign_CLS_dec5_4` (:1322-1499): the ChunkAlign answer
    classifier (`core`) plus a GPT-2 rationale decoder (`dec`, hidden
    states out, an untied bias-free fp32 `lm_head`) that cross-attends over
    the memory [s_seq; g_seq; chunk_hidden] of one answer row.

    `forward` (train): (gen_loss, cls_loss, matched); the decoder reads the
    gold answer's row, detached (:1386-1399), and the question's first
    explanation candidate; the LM loss ignores pad positions. `generate`
    is the full-recompute greedy decode (each step re-runs the decoder
    over the buffer), the exactness oracle of `generate_rationale`."""

    def __init__(self, cfg: ChunkAlignConfig, gpt2_cfg=None,
                 pad_token_id: int = 0, dtype=torch.float32, device="cuda",
                 seed: int | None = None, generator=None):
        super().__init__()
        from icka_tpu_torch.models.gpt2 import GPT2Config, GPT2Decoder

        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.gpt2_cfg = gpt2_cfg = gpt2_cfg or GPT2Config()
        self.pad_token_id = pad_token_id
        self.core = ChunkAlignCLS(cfg, dtype=dtype, device=dev,
                                  generator=gen)
        self.dec = GPT2Decoder(gpt2_cfg, with_cross=True, return_hidden=True,
                               dtype=dtype, device=dev, generator=gen)
        self.lm_head = Dense(gpt2_cfg.n_embd, gpt2_cfg.vocab_size,
                             use_bias=False, device=dev, generator=gen)

    def _encode(self, input_ids, img_feats, input_mask, chunk_mask,
                gather_index, num_chunks, dropout_gen=None):
        Lh = input_ids.shape[1]
        logits, _, inter = self.core.headless(
            input_ids, img_feats, input_mask, chunk_mask, gather_index,
            num_chunks, dropout_gen)
        if self.cfg.use_chunk_align:
            # the decoder's memory order differs from the CLS memory's
            memory = torch.cat([inter["s_seq"][:, 1:Lh],
                                inter["g_seq"][:, 1:Lh],
                                inter["chunk_hidden"][:, 1:Lh]], dim=1)
            mem_mask = torch.cat([inter["word_mask"]] * 3, dim=1)
        else:
            # `dec5_4_wo_chual` feeds the global hypothesis rows (:1724)
            memory = inter["g_seq"][:, 1:Lh]
            mem_mask = inter["word_mask"]
        return logits, memory, mem_mask, inter

    @torch.no_grad()
    def encode_for_generation(self, input_ids, img_feats, input_mask,
                              chunk_mask, gather_index, num_chunks: int):
        """The classifier pass and the decoder memory of each question's
        PREDICTED answer row (`test_beam`'s pre-generation block,
        :2078-2196): (pred (Bq,), memory, memory_mask, cls_attn), cls_attn
        the summed reasoning-layer attention over the memory (the
        constraint-word ranking signal; zeros without reasoning)."""
        C = self.cfg.num_choices
        logits, memory, mem_mask, inter = self._encode(
            input_ids, img_feats, input_mask, chunk_mask, gather_index,
            num_chunks)
        pred = binary_to_mp(logits, C).argmax(dim=-1)
        cls_attn = inter["cls_attn"]
        if cls_attn is None:
            cls_attn = torch.zeros(mem_mask.shape, device=memory.device)
        return (pred, choose_row(memory, pred, C),
                choose_row(mem_mask, pred, C), choose_row(cls_attn, pred, C))

    def forward(self, input_ids, img_feats, input_mask, chunk_mask,
                gather_index, num_chunks: int, expl_ids, attn_mask, label,
                gpt_labels, dropout_gen=None):
        C = self.cfg.num_choices
        logits, memory, mem_mask, _ = self._encode(
            input_ids, img_feats, input_mask, chunk_mask, gather_index,
            num_chunks, dropout_gen)
        cls_loss = _binary_ce(logits, label)
        gold = label.reshape(-1, C).argmax(dim=-1)
        matched = binary_to_mp(logits, C).argmax(dim=-1) == gold
        Bq = gold.shape[0]
        hidden = self.dec(expl_ids.reshape(Bq, C, -1)[:, 0],
                          attention_mask=attn_mask.reshape(Bq, C, -1)[:, 0],
                          memory=choose_row(memory.detach(), gold, C),
                          memory_mask=choose_row(mem_mask, gold, C))
        gen_loss = lm_loss(self.lm_head(hidden.float()),
                           gpt_labels.reshape(Bq, C, -1)[:, 0],
                           self.pad_token_id)
        return gen_loss, cls_loss, matched

    @torch.no_grad()
    def generate(self, input_ids, img_feats, input_mask, chunk_mask,
                 gather_index, num_chunks: int, prompt_ids,
                 max_gen_len: int = 30, eos_id: int = 1):
        """Greedy rationale generation by full recompute from the prompt
        `prompt_ids` (B, Lp): JAX's `lax.scan` over t as a loop. Returns
        (tokens (B, Lp + max_gen_len), pred_answer)."""
        pred, memory, mem_mask, _ = self.encode_for_generation(
            input_ids, img_feats, input_mask, chunk_mask, gather_index,
            num_chunks)
        B, Lp = prompt_ids.shape
        total = Lp + max_gen_len
        dev = memory.device
        buf = torch.full((B, total), self.pad_token_id, dtype=torch.long,
                         device=dev)
        buf[:, :Lp] = torch.as_tensor(prompt_ids, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        pos = torch.arange(total, device=dev)[None, :]
        for t in range(Lp - 1, total - 1):
            hidden = self.dec(buf, attention_mask=(pos <= t).long(),
                              memory=memory, memory_mask=mem_mask)
            nxt = self.lm_head(hidden[:, t].float()).argmax(dim=-1)
            nxt = torch.where(finished, self.pad_token_id, nxt)
            buf[:, t + 1] = nxt
            finished = finished | (nxt == eos_id)
        return buf, pred


def rationale_bonus_mask(cls_attn, input_ids, dec_vocab_size: int,
                         enc_to_dec_ids, stop_ids=(),
                         top_frac: float = 0.5):
    """Constraint-word extraction for the `_beam` rationale decoders
    (`test_beam`, :2114-2146): hypothesis tokens ranked by the summed
    reasoning-layer CLS attention, the top `top_frac` kept (minus stop
    words), their DECODER-vocabulary ids marked in a dense (Bq, dec_vocab)
    mask for `beam_search(bonus_mask=..., bonus_factor=...)`.

    Host numpy. `enc_to_dec_ids` maps encoder token id -> decoder token id
    (-1: unmappable). `cls_attn` is (Bq, k*(Lh-1)) over k stacked copies of
    the hypothesis words (folded by word before ranking); `input_ids` the
    (Bq, Lh) hypothesis ids of the predicted answer rows."""
    cls_attn = np.asarray(cls_attn, np.float64)
    ids = np.asarray(input_ids)
    Bq = cls_attn.shape[0]
    Lw = ids.shape[1] - 1                          # hypothesis words
    k = cls_attn.shape[1] // Lw
    word_attn = cls_attn[:, :k * Lw].reshape(Bq, k, Lw).sum(1)
    mapping = np.asarray(enc_to_dec_ids)
    stop = set(int(s) for s in stop_ids)
    mask = np.zeros((Bq, dec_vocab_size), bool)
    keep = max(1, int(Lw * top_frac))
    for b in range(Bq):
        order = np.argsort(-word_attn[b])[:keep]
        for w in order:
            enc_id = int(ids[b, 1 + w])
            if enc_id in stop:
                continue
            dec_id = int(mapping[enc_id]) if enc_id < len(mapping) else -1
            if 0 <= dec_id < dec_vocab_size:
                mask[b, dec_id] = True
    return mask


@torch.no_grad()
def generate_rationale(model: ChunkAlignRationale, enc_inputs: dict,
                       prompt_ids, prompt_len, max_gen_len: int = 50,
                       mode: str = "greedy", num_beams: int = 5,
                       eos_id: int = 1, length_penalty: float = 1.0,
                       repetition_penalty: float = 1.0,
                       bonus_mask=None, bonus_factor: float = 1.0,
                       fsm=None, beams_per_state: int = 2,
                       min_constraints: int = 2):
    """KV-cached rationale generation, the `ChunkAlign_CLS_dec5_4_beam`
    family (:2042-2827) as one engine with modes "greedy" (equal to the
    full-recompute `generate`), "beam" (the reference's repetition and
    length penalties and the `BeamSearchScorer_constrained` bonus:
    `bonus_mask` from `rationale_bonus_mask`) and "constrained"
    (FSM-constrained beam search over `fsm`). Also serves the baselines:
    any model with `encode_for_generation`, `dec`, `lm_head`, `gpt2_cfg`
    and `pad_token_id`.

    `enc_inputs` holds the classifier inputs by name; `prompt_ids` (Bq, Lp)
    is teacher-forced through the decoder (`prompt_len` an int or (Bq,) for
    ragged prompts). Returns (tokens, pred_answer): tokens (Bq, Lp +
    max_gen_len), for "constrained" the constraint-selected best beam (a
    numpy array)."""
    from icka_tpu_torch.generation.constrained import (
        constrained_beam_search, select_best_beam_with_constraints)
    from icka_tpu_torch.generation.decoding import beam_search, greedy_decode
    from icka_tpu_torch.generation.gpt2_cache import (cached_gpt2_step,
                                                      precompute_gpt2_cache)

    pred, memory, mem_mask = model.encode_for_generation(**enc_inputs)[:3]
    dec = model.dec
    lm_kernel = model.lm_head.weight.T
    dev = memory.device
    forced = torch.as_tensor(prompt_ids, device=dev).long()
    B, Lp = forced.shape
    total = Lp + max_gen_len
    cache = precompute_gpt2_cache(dec, memory, mem_mask, total)

    def step(tok, cache, t):
        return cached_gpt2_step(dec, lm_kernel, tok, t, cache)

    init = forced[:, 0]
    pad = model.pad_token_id
    if mode == "greedy":
        st = greedy_decode(step, init, cache, total, eos_id, pad_id=pad,
                           repetition_penalty=repetition_penalty,
                           forced=forced, forced_len=prompt_len)
        return st.tokens, pred
    if mode == "beam":
        res = beam_search(step, init, cache, total, eos_id,
                          num_beams=num_beams, pad_id=pad,
                          length_penalty=length_penalty,
                          repetition_penalty=repetition_penalty,
                          forced=forced, forced_len=prompt_len,
                          bonus_mask=bonus_mask, bonus_factor=bonus_factor)
        return res.tokens[:, 0], pred
    if mode == "constrained":
        res = constrained_beam_search(step, init, cache, fsm, total, eos_id,
                                      beams_per_state=beams_per_state,
                                      pad_id=pad, forced=forced,
                                      forced_len=prompt_len)
        toks, _ = select_best_beam_with_constraints(
            res, fsm, min_constraints=min_constraints)
        return toks, pred
    raise ValueError(f"unknown mode {mode!r}")
