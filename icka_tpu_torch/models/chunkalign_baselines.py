"""ChunkAlign baseline and ensemble classes, the VCR family's tail (port of
`icka_tpu.models.chunkalign_baselines`).

Thin compositions over the encoders of `models.chunkalign`
(`modeling/modeling_vcr_chunkalign_v10.py`):

  - `BaselineCLS` ≙ `BaseLine_cls_xe` (:376): global VL encoder, pooled
    CLS, binary-per-choice classifier;
  - `BaselineRationale` ≙ `BaseLine` (:423) and `Base_freeze` (:535): the
    baseline classifier plus a GPT-2 rationale decoder over the gold
    answer's encoder states, the full joint sequence (`BaseLine`, :457) or
    the hypothesis words only with the encoder frozen (`Base_freeze`,
    :571, :612): `hypo_only_memory` / `freeze_encoder`;
  - `LyxClsLayer` ≙ `ClsLayer_lyx` (:840): the CLS refined by an 8-head
    `GatedCrossAttention`, LayerNorm and FFN;
  - `EnsembleRefiner` ≙ `ChunkAlign_CLS_enc4_align_ensemble` (:874): both
    encoders run without gradient, the ensembled CLS refined by two
    `LyxClsLayer`s, and the align loss.

Every `forward` takes `dropout_gen` (None: deterministic).
"""

from __future__ import annotations

import torch
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.models.chunkalign import (ChunkAlignConfig,
                                              GlobalVLEncoder,
                                              StagedVLEncoder, _binary_ce,
                                              align_terms, binary_to_mp,
                                              choose_row, lm_loss)
from icka_tpu_torch.nn.attention import FeedForward, GatedCrossAttention
from icka_tpu_torch.nn.layers import Dense, LayerNorm, additive_mask, dropout


class BaselineCLS(nn.Module):
    """`BaseLine_cls_xe` (:376-421): `oscar` (the joint encoder) and
    `classifier`. Train (`label` given): (cls_loss, matched); eval:
    (pred, scores)."""

    def __init__(self, cfg: ChunkAlignConfig, dtype=torch.float32,
                 device="cuda", seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.oscar = GlobalVLEncoder(cfg, dtype=dtype, device=dev,
                                     generator=gen)
        self.classifier = Dense(cfg.encoder.hidden_size, 2, dtype=dtype,
                                device=dev, generator=gen)

    def forward(self, input_ids, img_feats, input_mask, label=None,
                dropout_gen=None):
        C = self.cfg.num_choices
        _, pooled = self.oscar(input_ids, img_feats, input_mask,
                               dropout_gen=dropout_gen)
        pooled = dropout(pooled, self.cfg.encoder.hidden_dropout_prob,
                         dropout_gen)
        logits = self.classifier(pooled)
        scores = binary_to_mp(logits, C)
        pred = scores.argmax(dim=-1)
        if label is None:
            return pred, scores
        return (_binary_ce(logits, label),
                pred == label.reshape(-1, C).argmax(dim=-1))


class BaselineRationale(nn.Module):
    """`BaseLine` (:423-533) / `Base_freeze` (:535-659): `oscar`,
    `classifier`, the GPT-2 decoder `dec` (hidden states out) and its
    bias-free `lm_head`. The decoder reads the gold answer's encoder states
    detached (the reference's `.detach()`). Train `forward`: (gen_loss,
    cls_loss, matched)."""

    def __init__(self, cfg: ChunkAlignConfig, gpt2_cfg=None,
                 pad_token_id: int = 0, hypo_only_memory: bool = False,
                 freeze_encoder: bool = False, dtype=torch.float32,
                 device="cuda", seed: int | None = None, generator=None):
        super().__init__()
        from icka_tpu_torch.models.gpt2 import GPT2Config, GPT2Decoder

        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.gpt2_cfg = gpt2_cfg = gpt2_cfg or GPT2Config()
        self.pad_token_id = pad_token_id
        self.hypo_only_memory = hypo_only_memory
        self.freeze_encoder = freeze_encoder
        self.oscar = GlobalVLEncoder(cfg, dtype=dtype, device=dev,
                                     generator=gen)
        self.classifier = Dense(cfg.encoder.hidden_size, 2, dtype=dtype,
                                device=dev, generator=gen)
        self.dec = GPT2Decoder(gpt2_cfg, with_cross=True, return_hidden=True,
                               dtype=dtype, device=dev, generator=gen)
        self.lm_head = Dense(gpt2_cfg.n_embd, gpt2_cfg.vocab_size,
                             use_bias=False, device=dev, generator=gen)

    def _memory(self, seq, input_mask, hypo_len: int):
        if self.hypo_only_memory:
            return seq[:, 1:hypo_len], input_mask[:, 1:hypo_len]
        return seq, input_mask

    def forward(self, input_ids, img_feats, input_mask, expl_ids, attn_mask,
                label, dropout_gen=None):
        C = self.cfg.num_choices
        seq, pooled = self.oscar(input_ids, img_feats, input_mask,
                                 dropout_gen=dropout_gen)
        if self.freeze_encoder:
            seq, pooled = seq.detach(), pooled.detach()
        logits = self.classifier(pooled)
        cls_loss = _binary_ce(logits, label)
        gold = label.reshape(-1, C).argmax(dim=-1)
        matched = binary_to_mp(logits, C).argmax(dim=-1) == gold
        memory, mem_mask = self._memory(seq.detach(), input_mask,
                                        input_ids.shape[1])
        Bq = gold.shape[0]
        expl = expl_ids.reshape(Bq, C, -1)[:, 0]
        hidden = self.dec(expl, attention_mask=attn_mask.reshape(Bq, C, -1)
                          [:, 0], memory=choose_row(memory, gold, C),
                          memory_mask=choose_row(mem_mask, gold, C))
        gen_loss = lm_loss(self.lm_head(hidden.float()), expl,
                           self.pad_token_id)
        return gen_loss, cls_loss, matched

    @torch.no_grad()
    def encode_for_generation(self, input_ids, img_feats, input_mask):
        """(pred, memory, memory_mask) of the PREDICTED answer row, for the
        KV-cached engines (`models.chunkalign.generate_rationale`)."""
        C = self.cfg.num_choices
        seq, pooled = self.oscar(input_ids, img_feats, input_mask)
        pred = binary_to_mp(self.classifier(pooled), C).argmax(dim=-1)
        memory, mem_mask = self._memory(seq, input_mask, input_ids.shape[1])
        return (pred, choose_row(memory, pred, C),
                choose_row(mem_mask, pred, C))


class LyxClsLayer(nn.Module):
    """`ClsLayer_lyx` (:840-873): `cross` (an 8-head `GatedCrossAttention`,
    dropout 0.1), dropout, `norm` over the residual, `ffn`."""

    def __init__(self, cfg: ChunkAlignConfig, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        enc = cfg.encoder
        H = enc.hidden_size
        self.dropout_rate = enc.hidden_dropout_prob
        self.cross = GatedCrossAttention(H, 8, dtype=dtype, dropout_rate=0.1,
                                         device=dev, generator=gen)
        self.norm = LayerNorm(H, eps=enc.layer_norm_eps, dtype=dtype,
                              device=dev)
        self.ffn = FeedForward(H, enc.intermediate_size, enc.layer_norm_eps,
                               dtype=dtype, device=dev, generator=gen)

    def forward(self, memory, cls, mem_bias, prior=None, dropout_gen=None):
        a = self.cross(cls[:, None, :], kv=memory, bias=mem_bias, prior=prior,
                       dropout_gen=dropout_gen)
        a = dropout(a[:, 0], self.dropout_rate, dropout_gen)
        x = self.norm(a + cls)
        return self.ffn(x[:, None, :], dropout_gen)[:, 0]


class EnsembleRefiner(nn.Module):
    """`ChunkAlign_CLS_enc4_align_ensemble` (:874-1000): `global_enc` and
    `seq_enc` run without gradient (the reference's `no_grad`, :898-913;
    the align loss comes from that attention too), `cls_ensemble_1` over
    both CLS, then `cls_layer_lyx_0..` over the 3-copy word memory.
    Returns (refined_cls, align_loss): the abstract/specific ensembles
    (`models.ensemble`) consume the refined CLS."""

    def __init__(self, cfg: ChunkAlignConfig, num_layers: int = 2,
                 dtype=torch.float32, device="cuda", seed: int | None = None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        H = cfg.encoder.hidden_size
        self.cfg = cfg
        self.num_layers = num_layers
        self.global_enc = GlobalVLEncoder(cfg, dtype=dtype, device=dev,
                                          generator=gen)
        self.seq_enc = StagedVLEncoder(cfg, dtype=dtype, device=dev,
                                       generator=gen)
        self.cls_ensemble_1 = Dense(2 * H, H, dtype=dtype, device=dev,
                                    generator=gen)
        for i in range(num_layers):
            self.add_module(f"cls_layer_lyx_{i}", LyxClsLayer(
                cfg, dtype=dtype, device=dev, generator=gen))

    def forward(self, input_ids, img_feats, input_mask, chunk_mask,
                gather_index, num_chunks: int, align_pos=None,
                total_label=None, dropout_gen=None):
        Lh = input_ids.shape[1]
        with torch.no_grad():
            g_seq, g_cls = self.global_enc(input_ids, img_feats, input_mask,
                                           dropout_gen=dropout_gen)
            s_seq, s_cls, cross_probs, chunk_hidden = self.seq_enc(
                input_ids, img_feats, input_mask, chunk_mask, gather_index,
                num_chunks, dropout_gen=dropout_gen)
        cls = self.cls_ensemble_1(torch.cat([g_cls, s_cls], dim=-1))
        memory = torch.cat([g_seq[:, 1:Lh], s_seq[:, 1:Lh],
                            chunk_hidden[:, 1:Lh]], dim=1)
        mem_bias = additive_mask(torch.cat([input_mask[:, 1:Lh]] * 3, dim=1))
        for i in range(self.num_layers):
            cls = getattr(self, f"cls_layer_lyx_{i}")(
                memory, cls, mem_bias, dropout_gen=dropout_gen)
        align_loss = torch.zeros((), device=cls.device)
        if total_label is not None:
            align_loss = align_terms(cross_probs, Lh, align_pos,
                                     total_label)[0]
        return cls, align_loss
