"""The my_bert model family (port of `icka_tpu.models.gate_cl`): gated
bichannel fusion and contrastive knowledge alignment over one legacy-BERT
encoder, in its three variants ("ip", "cl", "gate_cl", one model with a
variant switch).

Pipeline: BERT text encoding (with pooler) -> dropout -> the 7x7 visual
grid mapped to H -> txt2img cross-attention fusion -> for "gate_cl" a
relation classifier over the flattened (max_seq_length, 2H) concat of text
and fused features, whose P scales the fused features; for "gate_cl" and
"cl" a sigmoid gate -> classifier -> CRF. Training adds the contrastive
InfoNCE between the pooled text and the image's mean feature, and for
"gate_cl" the relation classifier's loss on negative pairs made by swapping
the fused features of the batch's last `negative_rate` rows.

Visual features arrive NHWC (B, 7, 7, R). Dropout draws from the caller's
`dropout_gen`; None runs deterministically. `forward_packed` is the
sequence-packed inference path of
`icka_tpu_torch.serving.packing.PackedGateCLServer`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from icka_tpu_torch.core.config import GateCLConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.nn.attention import CrossEncoder
from icka_tpu_torch.nn.bert import TextEncoder
from icka_tpu_torch.nn.crf import CRF
from icka_tpu_torch.nn.layers import Dense, additive_mask, dropout

def negative_swap_permutation(batch: int, negative_rate: int) -> np.ndarray:
    """The reference's negative-sample swap as a batch permutation: within
    the last `negative_rate` rows, the first half exchanges its cross-modal
    features with the second half. The identity when `batch <=
    negative_rate` (or the rate is 0)."""
    idx = np.arange(batch)
    if negative_rate and batch > negative_rate:
        half = negative_rate // 2
        lo = batch - negative_rate
        mid = lo + half
        front = idx[lo:mid].copy()
        idx[lo:mid] = idx[mid:lo + 2 * half]
        idx[mid:lo + 2 * half] = front
    return idx


def info_nce(text_h, image_h, temp: float, temp_lamb: float):
    """Bidirectional InfoNCE over cosine similarities, vectorised: one
    (B, B) similarity matrix, text-to-image and image-to-text terms mixed
    by `temp_lamb`, summed and divided by B. Computes in the inputs' dtype,
    as the JAX function does."""
    t = text_h / torch.linalg.vector_norm(text_h, dim=-1, keepdim=True)
    v = image_h / torch.linalg.vector_norm(image_h, dim=-1, keepdim=True)
    sim = (t @ v.T) / temp                                     # (B, B)
    t2i = -(sim.diagonal() - torch.log(torch.exp(sim).sum(dim=1)))
    i2t = -(sim.diagonal() - torch.log(torch.exp(sim.T).sum(dim=1)))
    return (temp_lamb * t2i.sum() + (1 - temp_lamb) * i2t.sum()) / sim.shape[0]


class GateCLModel(nn.Module):
    """The gate_cl family. Parameters are fp32 and made on `device` from
    `generator` (or a new one seeded with `seed`); `dtype` is the compute
    dtype. A variant holds the parameters its JAX counterpart holds, under
    the flax names, so `icka_tpu_torch.convert.gate_cl_state_dict` maps JAX
    weights onto it (`strict=True`)."""

    def __init__(self, cfg: GateCLConfig, dtype=torch.float32, device="cuda",
                 seed: int | None = None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        kw = dict(dtype=dtype, device=dev, generator=gen)
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.encoder.hidden_size
        self.bert = TextEncoder(cfg.encoder, with_pooler=True, **kw)
        self.vismap2text = Dense(cfg.region_dim, H, **kw)
        self.txt2img = CrossEncoder(cfg.encoder, cfg.layer_num1, **kw)
        self.classifier = Dense(2 * H, cfg.num_labels, **kw)
        self.crf = CRF(cfg.num_labels, device=dev, generator=gen)
        if cfg.variant == "gate_cl":
            # the relation classifier flattens (max_seq_length, 2H)
            self.crs_classifier = Dense(cfg.max_seq_length * 2 * H, 2, **kw)
        if cfg.variant in ("gate_cl", "cl"):
            self.gate_text = Dense(H, H, **kw)
            self.gate_image = Dense(H, H, **kw)
            self.text_dense_cl = Dense(H, H, **kw)
            self.text_output_cl = Dense(H, H, **kw)
            self.image_dense_cl = Dense(cfg.region_dim, H, **kw)
            self.image_output_cl = Dense(H, H, **kw)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def _gated(self, seq, cross):
        """The "cl" gate (and "gate_cl"'s, on P-scaled cross features)."""
        gate = torch.sigmoid(self.gate_text(seq) + self.gate_image(cross))
        return gate * cross

    def forward(self, input_ids, segment_ids, input_mask, img_mask,
                visual_mean, visual_grid, labels=None, dropout_gen=None,
                return_emissions=False, rows=None):
        """Inference (`labels` None): (B, L) int32 Viterbi tags under
        `input_mask`. Training (`labels` given): the scalar loss, the CRF's
        batch-mean NLL for "ip", else alpha * NLL + (1 - alpha) * (relation
        loss + InfoNCE) (`cl_alpha` and no relation loss for "cl").
        `return_emissions=True` returns the pre-CRF emissions. Dropout masks
        come from `dropout_gen`; None runs deterministically. With
        `EncoderConfig.remat`, the BERT encoder rematerialises its layers
        whenever grad is enabled (`icka_tpu_torch.nn.remat`).

        `rows` (`core.mesh.RowSplit`, training only): the inputs are one
        rank's rows of a microbatch that the data axis splits. The
        negative swap and InfoNCE then run over the whole microbatch, on
        features gathered from every rank; the CRF and relation terms are
        means over this rank's rows."""
        cfg = self.cfg
        B = input_ids.shape[0]
        seq, pooled = self.bert(input_ids, input_mask, segment_ids,
                                dropout_gen=dropout_gen)
        seq = dropout(seq, cfg.encoder.hidden_dropout_prob, dropout_gen)

        grid = self.vismap2text(visual_grid.reshape(B, -1,
                                                    visual_grid.shape[-1]))
        cross = self.txt2img(seq, grid, additive_mask(img_mask), dropout_gen)

        training = labels is not None
        aux_loss = 0.0
        if cfg.variant == "gate_cl":
            if training:
                total = B if rows is None else rows.total
                perm = negative_swap_permutation(total, cfg.negative_rate)
                swapped = cfg.negative_rate and total > cfg.negative_rate
                positive = ((np.arange(total) < total - cfg.negative_rate)
                            .astype(np.int64) if swapped
                            else np.ones(total, np.int64))
                source = cross
                if rows is not None:
                    # a swapped pair may span two ranks
                    perm = perm[rows.start:rows.stop]
                    positive = positive[rows.start:rows.stop]
                    source = rows.gather(cross)
                cross_used = source[torch.from_numpy(perm).to(cross.device)]
                labels_crs = torch.from_numpy(positive).to(cross.device)
            else:
                cross_used = cross
            # the relation classifier flattens (L, 2H) positions padded to
            # max_seq_length, so its weight is independent of the padded
            # batch length; missing positions contribute exactly 0
            crs_in = torch.cat([seq, cross_used], dim=-1)
            if cfg.masked_crs:
                crs_in = crs_in * input_mask[:, :, None].to(crs_in.dtype)
            L = crs_in.shape[1]
            if L < cfg.max_seq_length:
                crs_in = torch.nn.functional.pad(
                    crs_in, (0, 0, 0, cfg.max_seq_length - L))
            crs_logits = self.crs_classifier(crs_in.reshape(B, -1))
            P = torch.softmax(crs_logits, dim=-1)[:, -1]
            gated = self._gated(seq, P[:, None, None] * cross_used)
            if training:
                logp = torch.log_softmax(crs_logits, dim=-1)
                aux_loss = aux_loss - logp.gather(
                    1, labels_crs[:, None]).mean()
        elif cfg.variant == "cl":
            gated = self._gated(seq, cross)
        else:                                                  # "ip"
            gated = cross

        emissions = self.classifier(torch.cat([seq, gated], dim=-1))
        if return_emissions:
            return emissions
        # the contrastive heads run in every mode, as in the JAX model
        if cfg.variant in ("gate_cl", "cl"):
            text_cl = self.text_output_cl(
                torch.relu(self.text_dense_cl(pooled)))
            image_cl = self.image_output_cl(
                torch.relu(self.image_dense_cl(visual_mean)))
        if not training:
            return self.crf.decode(emissions, input_mask)
        if cfg.variant in ("gate_cl", "cl"):
            if rows is not None:
                text_cl, image_cl = rows.gather(text_cl), rows.gather(image_cl)
            aux_loss = aux_loss + info_nce(text_cl, image_cl, cfg.temp,
                                           cfg.temp_lamb)
        main_loss = -self.crf(emissions, labels, input_mask, reduction="mean")
        if cfg.variant == "ip":
            return main_loss
        alpha = cfg.alpha if cfg.variant == "gate_cl" else cfg.cl_alpha
        return alpha * main_loss + (1 - alpha) * aux_loss

    def forward_packed(self, batch):
        """Sequence-packed inference: each row carries up to S short
        sentences, isolated exactly from each other. `batch` holds tensors
        on the model's device, integers as int64 (B rows of L tokens, S
        slots; the sentinel is S for slot ids and L for gather indices):

          ids / pos / types (B, L): concatenated segments, position ids per
            segment in the encoder's dialect (computed by the host);
          slot (B, L): each token's slot, S for padding; valid (B, L)
            {0,1}; seg_start (B, L) {0,1}, segments' first tokens;
          img_mask (B, S, num_regions), visual_grid (B, S, 7, 7, R): one
            image per slot;
          seg_gather (B, S, max_seq_length): the row position of each
            (slot, offset in its segment), L where there is none (it reads
            an appended zero row).

        Self-attention is block-diagonal by slot (a (B, 1, L, L) mask; with
        `use_pallas` the fused attention kernel takes it as a full bias),
        visual keys are per slot, and the Viterbi lattice is cut at
        `seg_start`. The relation gate flattens each segment into the
        (max_seq_length, 2H) layout it was trained on with missing positions
        exactly 0: the `masked_crs=True` semantics, whatever the flag (a
        packed row has no padding tail to flatten). Returns (B, L) int32
        tags in packed order."""
        cfg = self.cfg
        ids, slot = batch["ids"], batch["slot"]
        B, L = ids.shape
        S = batch["img_mask"].shape[1]
        H = cfg.encoder.hidden_size
        R = cfg.num_regions

        # block-diagonal self-attention: key j visible to query i iff the
        # same slot owns both (the padding's sentinel slot sees padding)
        pair = slot[:, :, None] == slot[:, None, :]
        seq, _ = self.bert(ids, pair[:, None].int(), batch["types"],
                           position_ids=batch["pos"])

        # per-slot visual keys: token i may read region (s, r) iff
        # slot[i] == s and img_mask[s, r]
        grid = batch["visual_grid"]
        grid = self.vismap2text(grid.reshape(B, S * R, grid.shape[-1]))
        slot_onehot = slot[:, :, None] == torch.arange(S, device=ids.device)
        kv_ok = (slot_onehot[:, :, :, None]
                 & (batch["img_mask"][:, None, :, :] > 0)).reshape(B, L, S * R)
        cross = self.txt2img(seq, grid, additive_mask(kv_ok[:, None].int()))

        if cfg.variant == "gate_cl":
            validf = batch["valid"][:, :, None].to(cross.dtype)
            crs_in = torch.cat([seq, cross], dim=-1) * validf
            # each slot's tokens gathered into the canonical
            # (max_seq_length, 2H) layout, one batched Dense call
            work = torch.cat([crs_in, crs_in.new_zeros(B, 1, 2 * H)], dim=1)
            idx = batch["seg_gather"].reshape(B, S * cfg.max_seq_length)
            g = work.gather(1, idx[:, :, None].expand(-1, -1, 2 * H))
            crs_logits = self.crs_classifier(
                g.reshape(B * S, cfg.max_seq_length * 2 * H))
            P = torch.softmax(crs_logits, dim=-1)[:, -1].reshape(B, S)
            # P per token via its owning slot (the sentinel slot reads 0)
            P_tok = torch.cat([P, P.new_zeros(B, 1)], dim=1).gather(
                1, slot.clamp(max=S))
            gated = self._gated(seq, P_tok[:, :, None].to(cross.dtype) * cross)
        elif cfg.variant == "cl":
            gated = self._gated(seq, cross)
        else:                                                  # "ip"
            gated = cross

        emissions = self.classifier(torch.cat([seq, gated], dim=-1))
        return self.crf.decode(emissions, batch["valid"],
                               reset=batch["seg_start"])
