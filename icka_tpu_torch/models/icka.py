"""The flagship ICKA model (port of `icka_tpu.models.icka`).

Pipeline: RoBERTa text encoding -> 7x7 visual grid mapped to H -> txt2img
cross-attention fusion -> CLIP knowledge alignment over the fused text ->
two prompt prefixes from mapping networks spliced into the prompted
RoBERTa -> relevance gate -> BiLSTM -> classifier -> CRF Viterbi.
Visual features arrive NHWC (B, 7, 7, C). `forward` has the JAX model's
three modes: "test" (tags), "dev" (tags and the loss) and "train" (the
loss, with dropout drawn from the caller's generator).
`forward_packed` is the sequence-packed inference path of
`icka_tpu_torch.serving.packing`.

On a model axis (`icka_tpu_torch.parallel.tensor`) the encoders and
cross-attention stacks split their heads and FFN columns, the mapping
networks their `wi`/`wo` pair, and `vismap2text`, `vismapping` and
`gate.proj` (the generic rule: output width >= 1024) compute their columns
and gather the rest; the BiLSTM, the classifier and the CRF stay
replicated.
"""

from __future__ import annotations

import torch
from torch import nn

from icka_tpu_torch.core.config import ICKAConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.nn.attention import CrossEncoder
from icka_tpu_torch.nn.bert import PromptSpliceEncoder, TextEncoder
from icka_tpu_torch.nn.crf import CRF
from icka_tpu_torch.nn.layers import Dense, additive_mask, dropout
from icka_tpu_torch.nn.lstm import BiLSTM
from icka_tpu_torch.parallel.tensor import column_row_pair, copy_to_model


class MappingNetwork(nn.Module):
    """Prompt mapping network: Dropout -> Linear(in, W*P) -> Tanh ->
    Dropout -> Linear(W*P, H*P), reshaped to (B, P, H)."""

    def __init__(self, in_dim: int, prompt_len: int, width: int, hidden: int,
                 dropout: float = 0.3, dtype=torch.float32, device="cuda",
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.dropout = dropout
        self.prompt_len = prompt_len
        self.hidden = hidden
        self.wi = Dense(in_dim, width * prompt_len, dtype=dtype, device=dev,
                        generator=gen)
        self.wo = Dense(width * prompt_len, hidden * prompt_len, dtype=dtype,
                        device=dev, generator=gen)
        self.shard = None

    def shard_model_axis(self, shard, specs) -> tuple:
        """`wi`/`wo` a column/row pair where the specs split them; the
        dropout between them then draws every column and keeps its own."""
        self.shard = column_row_pair(self.wi, self.wo)
        return ()

    def forward(self, x, dropout_gen=None):
        x = dropout(x, self.dropout, dropout_gen)
        x = torch.tanh(self.wi(copy_to_model(x, self.shard)))
        cut = None if self.shard is None else self.shard.cut(-1, x.shape[-1])
        x = self.wo(dropout(x, self.dropout, dropout_gen, cut))
        return x.reshape(x.shape[0], self.prompt_len, self.hidden)


class GlobalFusionGate(nn.Module):
    """LayerNorm(sum of the two global features) -> Linear -> Linear(H, 1)
    -> sigmoid. The norm is flax's `nn.LayerNorm`, not the TF-style one:
    variance as max(0, E[x^2] - E[x]^2), then (x - mean) * (rsqrt(var + eps)
    * scale) + bias, in fp32."""

    def __init__(self, hidden: int, eps: float, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.eps = eps
        self.norm = nn.Module()
        self.norm.scale = nn.Parameter(torch.ones(hidden, device=dev))
        self.norm.bias = nn.Parameter(torch.zeros(hidden, device=dev))
        self.proj = Dense(hidden, hidden, dtype=dtype, device=dev,
                          generator=gen)
        self.aux_head = Dense(hidden, 1, dtype=dtype, device=dev,
                              generator=gen)

    def _layer_norm(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.norm.scale
        return (x - mean) * mul + self.norm.bias

    def forward(self, lang_feat, img_feat):
        x = self.proj(self._layer_norm(lang_feat + img_feat))
        return torch.sigmoid(self.aux_head(x))


class ICKAModel(nn.Module):
    """The flagship model. Parameters are fp32 and made on `device` from
    `generator` (or a new one seeded with `seed`); `dtype` is the compute
    dtype. Submodule names are the flax names, so
    `icka_tpu_torch.convert.icka_state_dict` maps JAX weights onto it."""

    def __init__(self, cfg: ICKAConfig, dtype=torch.float32, device="cuda",
                 seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        kw = dict(dtype=dtype, device=dev, generator=gen)
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.embedding.hidden_size
        # a branch that an ablation flag switches off holds no parameters,
        # as in the JAX model (flax creates them at first call)
        self.embedding = TextEncoder(cfg.embedding, with_pooler=False, **kw)
        self.vismapping = (Dense(cfg.clip_dim, H, **kw)
                           if cfg.use_alignment else None)
        self.vismap2text = (Dense(cfg.region_dim, H, **kw)
                            if cfg.use_txt2img else None)
        self.txt2img = (CrossEncoder(cfg.embedding, cfg.layer_num1, **kw)
                        if cfg.use_txt2img else None)
        self.align_0 = CrossEncoder(cfg.embedding, cfg.layer_num1, **kw)
        self.align_1 = CrossEncoder(cfg.embedding, cfg.layer_num1, **kw)
        self.map_alignment = MappingNetwork(H, cfg.prompt_len,
                                            cfg.prompt_hidden, H, **kw)
        self.map_vision = MappingNetwork(cfg.region_dim, cfg.prompt_len,
                                         cfg.prompt_hidden, H, **kw)
        self.lastproj = (Dense(H, cfg.last_hidden, **kw)
                         if H != cfg.last_hidden else None)
        self.last_encoder = PromptSpliceEncoder(cfg.last_encoder, **kw)
        self.gate = (GlobalFusionGate(H, cfg.embedding.layer_norm_eps, **kw)
                     if cfg.use_gate else None)
        # the BiLSTM takes the prompted encoder's quant mode, as in JAX; the
        # mapping networks, projections, gate and classifier stay float
        self.lstm = BiLSTM(cfg.last_hidden, cfg.last_hidden,
                           quant=cfg.last_encoder.quant, **kw)
        self.classifier = Dense(2 * cfg.last_hidden, cfg.num_labels, **kw)
        self.crf = CRF(cfg.num_labels, device=dev, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def emissions(self, *, input_ids, segment_ids, input_mask,
                  ori_input_ids, ori_input_mask, ori_segment_ids,
                  img_mask, clip_features, visual_mean, visual_grid,
                  mask_positions, offset: int, dropout_gen=None):
        """Everything up to the CRF: returns (emissions, aux dict). Dropout
        masks come from `dropout_gen`; None runs deterministically."""
        cfg = self.cfg
        B = ori_input_ids.shape[0]

        # 1. text encoding (+ dropout)
        seq, _ = self.embedding(ori_input_ids, ori_input_mask,
                                ori_segment_ids, dropout_gen=dropout_gen)
        seq = dropout(seq, cfg.embedding.hidden_dropout_prob, dropout_gen)

        # 2-3. visual grid -> txt2img fusion
        if cfg.use_txt2img:
            grid = visual_grid.reshape(B, -1, visual_grid.shape[-1])
            grid = self.vismap2text(grid)                      # (B, 49, H)
            cross = self.txt2img(seq, grid, additive_mask(img_mask),
                                 dropout_gen)
        else:
            cross = seq

        # 4. knowledge alignment: CLIP token attends over the fused text
        text_bias = additive_mask(ori_input_mask)
        if cfg.use_alignment:
            clip_tok = self.vismapping(
                clip_features.reshape(B, -1))[:, None, :]      # (B, 1, H)
        else:
            clip_tok = cross[:, 0:1, :]
        for layer in (self.align_0, self.align_1):
            clip_tok = layer(clip_tok, cross, text_bias, dropout_gen)

        # 5. instruction construction
        align_prompt = self.map_alignment(clip_tok.reshape(B, -1),
                                          dropout_gen)
        vision_prompt = self.map_vision(visual_mean, dropout_gen)
        if not cfg.use_vision_prompt:
            vision_prompt = align_prompt
        if not cfg.use_alignment_prompt:
            align_prompt = vision_prompt
        prefix = torch.cat([vision_prompt, align_prompt], dim=1)
        if self.lastproj is not None:
            prefix = self.lastproj(prefix)
        prompt_mask = input_mask[:, :1].expand(-1, 2 * cfg.prompt_len)
        out, _ = self.last_encoder(input_ids, input_mask, segment_ids,
                                   prefix, prompt_mask, mask_positions,
                                   dropout_gen=dropout_gen)
        # the sentence starts at offset - 2 + 2P of the spliced layout; its
        # width is the bare-sentence width (shorter under bucketed serving)
        tok_start = offset - 2 + 2 * cfg.prompt_len
        sent_len = ori_input_ids.shape[1]
        token_embedding = out[:, tok_start:tok_start + sent_len, :]

        # 6. relevance gate
        if cfg.use_gate:
            g = self.gate(cross[:, 0, :], token_embedding[:, 0, :])
            g = g.reshape(B, 1, 1)
        else:
            g = torch.full((B, 1, 1), cfg.gate_fixed, dtype=self.dtype,
                           device=cross.device)
        fused = g * token_embedding + (1.0 - g) * cross

        # 7. BiLSTM -> emissions
        x = self.lstm(fused, mask=ori_input_mask if cfg.masked_lstm else None)
        emissions = self.classifier(x)
        return emissions, {"gate": g, "cross": cross,
                           "token_embedding": token_embedding}

    def batch_emissions(self, batch, mask_positions, offset: int,
                        dropout_gen=None):
        """`emissions` over a batch dict; returns the emissions only."""
        emissions, _ = self.emissions(
            input_ids=batch["input_ids"],
            segment_ids=batch["segment_ids"],
            input_mask=batch["input_mask"],
            ori_input_ids=batch["ori_input_ids"],
            ori_input_mask=batch["ori_input_mask"],
            ori_segment_ids=batch["ori_segment_ids"],
            img_mask=batch["img_mask"],
            clip_features=batch["clip_features"],
            visual_mean=batch["visual_mean"],
            visual_grid=batch["visual_grid"],
            mask_positions=mask_positions,
            offset=offset,
            dropout_gen=dropout_gen,
        )
        return emissions

    def forward(self, batch, mask_positions, offset: int, mode: str = "test",
                labels=None, deterministic=None,
                loss_reduction: str = "token_mean", dropout_gen=None):
        """`batch` is a dict of tensors on the model's device (the keys of
        `icka_tpu_torch.data.features`). As the JAX model's `__call__`:
        "test" returns (B, L) int32 Viterbi tags; "dev" returns (tags, the
        negative log-likelihood of `labels` under `loss_reduction`, where
        "none" gives each row's NLL (B,)); "train" returns the token-mean
        NLL. `deterministic` defaults to `mode != "train"`; a call that is
        not deterministic draws its dropout masks from `dropout_gen`, a
        `torch.Generator` on the model's device, and raises without one.
        With `EncoderConfig.remat` on `embedding` or `last_encoder`, that
        stack rematerialises its layers whenever grad is enabled
        (`icka_tpu_torch.nn.remat`)."""
        if mode not in ("train", "dev", "test"):
            raise ValueError(f"unknown mode {mode!r}")
        if deterministic is None:
            deterministic = mode != "train"
        if not deterministic and dropout_gen is None:
            raise ValueError("deterministic=False draws dropout masks: pass "
                             "dropout_gen, a torch.Generator on the model's "
                             "device")
        emissions = self.batch_emissions(
            batch, mask_positions, offset,
            dropout_gen=None if deterministic else dropout_gen)
        output_mask = batch["output_mask"]
        if mode == "train":
            return -self.crf(emissions, labels, output_mask,
                             reduction="token_mean")
        pred = self.crf.decode(emissions, output_mask)
        if mode == "test":
            return pred
        return pred, -self.crf(emissions, labels, output_mask,
                               reduction=loss_reduction)

    def forward_packed(self, batch):
        """Sequence-packed inference (`PackedICKAServer`): each row carries
        up to S (sentence, image) pairs, isolated exactly from each other.

        A row has two packed token layouts, because the prompted encoder's
        input is longer than the bare sentence by the spliced prompt head:

          layout A, the concatenated bare sentences (L1 = row_len), feeds
            the embedding encoder, the txt2img fusion, the gate, the BiLSTM
            and the CRF;
          layout B, the concatenated spliced prompted sequences (L2 =
            row_len + S * (offset - 2 + 2 * prompt_len)), feeds the prompted
            encoder; prompt-vector positions hold placeholders that
            `prompt_gather` resolves into the per-slot prefix table.

        `batch` holds tensors on the model's device, integers as int64
        (B rows, S slots; the sentinel is S for slot ids and the array
        length for gather indices):
          ids_a / pos_a / types_a / slot_a / valid_a / seg_start / seg_end
            (B, L1); ids_b / pos_b / types_b / slot_b / prompt_gather
            (B, L2); sent_gather (B, L1), the layout-B index of each bare
            token's counterpart after the splice; seg_first (B, S), the
            layout-A index of each segment's first token;
          img_mask (B, S, 49), visual_grid (B, S, 7, 7, R), visual_mean
            (B, S, R), clip_features (B, S, C).

        Self-attention is block-diagonal by slot in both layouts (a
        (B, 1, L, L) mask; with `use_pallas` the fused attention kernel
        takes it as a full bias), visual and alignment keys are per slot,
        position ids come per segment from the host, the BiLSTM's carries
        are reset at segment starts and ends (the `masked_lstm=True`
        semantics: a packed row has no padding tail), and the Viterbi
        lattice is cut at `seg_start`. It uses the parameters of
        `emissions` and no others.

        Returns (B, L1) int32 tags in packed order; the server slices each
        segment's span out."""
        cfg = self.cfg
        ids_a, slot_a = batch["ids_a"], batch["slot_a"]
        B, L1 = ids_a.shape
        S = batch["img_mask"].shape[1]
        P = cfg.prompt_len
        dev = ids_a.device
        slots = torch.arange(S, device=dev)

        def with_zero_row(x):
            """x (B, L, H) plus one zero row, the sentinel's target."""
            return torch.cat([x, x.new_zeros(B, 1, x.shape[-1])], dim=1)

        def take_rows(x, index):
            """x[b, index[b, i]] for index (B, I) -> (B, I, H)."""
            return x.gather(1, index[:, :, None].expand(-1, -1, x.shape[-1]))

        # 1. bare sentences, block-diagonal by slot (the padding's sentinel
        # slot sees only padding)
        pair_a = slot_a[:, :, None] == slot_a[:, None, :]
        seq, _ = self.embedding(ids_a, pair_a[:, None].int(),
                                batch["types_a"], position_ids=batch["pos_a"])

        # 2-3. txt2img with per-slot visual keys: token i may read region
        # (s, r) iff slot_a[i] == s and img_mask[s, r]
        if cfg.use_txt2img:
            grid = batch["visual_grid"].reshape(
                B, S * cfg.num_regions, batch["visual_grid"].shape[-1])
            grid = self.vismap2text(grid)
            slot_onehot = slot_a[:, :, None] == slots[None, None, :]
            kv_ok = (slot_onehot[:, :, :, None]
                     & (batch["img_mask"][:, None, :, :] > 0)
                     ).reshape(B, L1, S * cfg.num_regions)
            cross = self.txt2img(seq, grid,
                                 additive_mask(kv_ok[:, None].int()))
        else:
            cross = seq
        crossw = with_zero_row(cross)

        # 4. knowledge alignment: one CLIP query per slot attends over its
        # own segment's fused text (an empty slot sees a uniform softmax
        # over masked keys; its prompt vectors are never consumed)
        q_ok = slots[None, :, None] == slot_a[:, None, :]      # (B, S, L1)
        align_bias = additive_mask(q_ok[:, None].int())
        if cfg.use_alignment:
            clip_tok = self.vismapping(
                batch["clip_features"].reshape(B, S, -1))      # (B, S, H)
        else:
            clip_tok = take_rows(crossw, batch["seg_first"])
        for layer in (self.align_0, self.align_1):
            clip_tok = layer(clip_tok, cross, align_bias)

        # 5. instruction construction per slot -> flat prefix table
        align_prompt = self.map_alignment(
            clip_tok.reshape(B * S, clip_tok.shape[-1]))       # (B*S, P, H)
        vision_prompt = self.map_vision(
            batch["visual_mean"].reshape(B * S, -1))
        if not cfg.use_vision_prompt:
            vision_prompt = align_prompt
        if not cfg.use_alignment_prompt:
            align_prompt = vision_prompt
        prefix = torch.cat([vision_prompt, align_prompt], dim=1)
        if self.lastproj is not None:
            prefix = self.lastproj(prefix)
        prefix = prefix.reshape(B, S * 2 * P, prefix.shape[-1])

        slot_b = batch["slot_b"]
        pair_b = slot_b[:, :, None] == slot_b[:, None, :]
        out, _ = self.last_encoder(
            batch["ids_b"], pair_b[:, None].int(), batch["types_b"], prefix,
            None, (0, 0), position_ids=batch["pos_b"],
            prompt_gather=batch["prompt_gather"])
        token_embedding = take_rows(with_zero_row(out),
                                    batch["sent_gather"])     # (B, L1, Hl)

        # 6. relevance gate per slot, handed to tokens by owning slot
        if cfg.use_gate:
            cross0 = take_rows(crossw, batch["seg_first"])
            te0 = take_rows(with_zero_row(token_embedding),
                            batch["seg_first"])
            g = self.gate(cross0.reshape(B * S, -1),
                          te0.reshape(B * S, -1)).reshape(B, S)
        else:
            g = torch.full((B, S), cfg.gate_fixed, dtype=self.dtype,
                           device=dev)
        g_tok = torch.cat([g, g.new_zeros(B, 1)], dim=1).gather(
            1, slot_a.clamp(max=S))                            # (B, L1)
        fused = (g_tok[:, :, None] * token_embedding
                 + (1.0 - g_tok)[:, :, None] * cross)

        # 7. BiLSTM with carry resets at segment boundaries -> CRF with the
        # lattice cut at segment starts
        x = self.lstm(fused, mask=batch["valid_a"],
                      reset_fwd=batch["seg_start"],
                      reset_bwd=batch["seg_end"])
        return self.crf.decode(self.classifier(x), batch["valid_a"],
                               reset=batch["seg_start"])
