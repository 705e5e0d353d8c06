"""Oscar image-BERT task heads over the joint text + image encoder (port of
`icka_tpu.models.oscar`).

Thin layers over ChunkAlign's `GlobalVLEncoder` (the `BertImgModel` role,
`modeling/modeling_bert.py:158`), whose self-attention runs through K1
with `cfg.encoder.use_pallas`:

  - `ImageBertSequenceClassifier` ≙ `ImageBertForSequenceClassification`
    (:424): pooled CLS, dropout, a linear or 2x-hidden MLP classifier, with
    the reference's ce / bce / kl (soft-target) losses (:471-490);
  - `OscarMultipleChoice` ≙ `OscarForMultipleChoice` (:574): the choices
    flattened into the batch, per-choice logits, ce or bce;
  - `ImageBertPreTraining` ≙ `BertImgForPreTraining` (:2045): a masked-LM
    head whose decoder is the encoder's `word_embeddings` Parameter itself
    (`tie_weights` :2106: one table, one gradient) plus its own
    `decoder_bias`, and the relation head; losses ignore label -1 like
    `CrossEntropyLoss(ignore_index=-1)`.

Every `forward` takes `dropout_gen` (None: deterministic).
"""

from __future__ import annotations

import torch
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.models.chunkalign import ChunkAlignConfig, GlobalVLEncoder
from icka_tpu_torch.nn.layers import Dense, LayerNorm, dropout, gelu


def _masked_ce(logits, labels, ignore_index: int = -1):
    """Mean cross-entropy over the positions whose label is not
    `ignore_index`."""
    valid = (labels != ignore_index).float()
    safe = torch.where(labels == ignore_index, 0, labels).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def optax_sigmoid_bce(logits, labels):
    """Elementwise sigmoid binary cross-entropy (optax's formula)."""
    logits = logits.float()
    labels = labels.float()
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))


class _Classifier(nn.Module):
    """"linear" (`wo`) or "mlp" (`wi` to hidden x `hidden_scale`, ReLU,
    then `wo`)."""

    def __init__(self, in_features: int, num_labels: int,
                 kind: str = "linear", hidden_scale: int = 2,
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.kind = kind
        width = in_features
        if kind == "mlp":
            width = in_features * hidden_scale
            self.wi = Dense(in_features, width, dtype=dtype, device=dev,
                            generator=gen)
        self.wo = Dense(width, num_labels, dtype=dtype, device=dev,
                        generator=gen)

    def forward(self, x):
        if self.kind == "mlp":
            x = torch.relu(self.wi(x))
        return self.wo(x)


def _loss(loss_type: str, logits, labels):
    if loss_type == "kl":
        # soft-target cross entropy (the reference's VQA KLDivLoss)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -(labels * logp).sum(dim=-1).mean()
    if loss_type == "bce":
        return optax_sigmoid_bce(logits, labels).mean()
    return _masked_ce(logits, labels.long())


class ImageBertSequenceClassifier(nn.Module):
    """`encoder` and `classifier`: logits (B, num_labels), and with
    `labels` (loss, logits)."""

    def __init__(self, cfg: ChunkAlignConfig, num_labels: int = 2,
                 classifier: str = "linear", loss_type: str = "ce",
                 dtype=torch.float32, device="cuda", seed: int | None = None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.loss_type = loss_type
        self.encoder = GlobalVLEncoder(cfg, dtype=dtype, device=dev,
                                       generator=gen)
        self.classifier = _Classifier(cfg.encoder.hidden_size, num_labels,
                                      classifier, dtype=dtype, device=dev,
                                      generator=gen)

    def forward(self, input_ids, img_feats, input_mask, token_type_ids=None,
                labels=None, dropout_gen=None):
        _, pooled = self.encoder(input_ids, img_feats, input_mask,
                                 token_type_ids, dropout_gen)
        pooled = dropout(pooled, self.cfg.encoder.hidden_dropout_prob,
                         dropout_gen)
        logits = self.classifier(pooled)
        if labels is None:
            return logits
        return _loss(self.loss_type, logits, labels), logits


class OscarMultipleChoice(ImageBertSequenceClassifier):
    """Inputs with a choices axis: (B, C, L) ids, types and mask and
    (B, C, R, D) region features; scores (B, C, num_labels), and with
    `labels` (B, C) (loss, scores): bce on the flattened logits, else ce."""

    def forward(self, input_ids, img_feats, input_mask, token_type_ids=None,
                labels=None, dropout_gen=None):
        B, C = input_ids.shape[:2]

        def flat(x):
            return None if x is None else x.reshape((B * C,)
                                                    + tuple(x.shape[2:]))
        logits = super().forward(flat(input_ids), flat(img_feats),
                                 flat(input_mask), flat(token_type_ids),
                                 dropout_gen=dropout_gen)
        scores = logits.reshape(B, C, -1)
        if labels is None:
            return scores
        if self.loss_type == "bce":
            loss = optax_sigmoid_bce(logits, labels.reshape(B * C, -1)).mean()
        else:
            loss = _masked_ce(logits, labels.reshape(-1).long())
        return loss, scores


class ImageBertPreTraining(nn.Module):
    """Masked-LM and image-text relation pretraining (`BertImgForPreTraining`,
    :2045-2140): `encoder`, `transform`, `transform_norm`, `decoder_bias`,
    `seq_relationship`. The MLM logits read the encoder's word-embedding
    Parameter (the tie), so the table is held and trained once."""

    def __init__(self, cfg: ChunkAlignConfig, num_seq_relations: int = 2,
                 dtype=torch.float32, device="cuda", seed: int | None = None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        enc = cfg.encoder
        H = enc.hidden_size
        self.encoder = GlobalVLEncoder(cfg, dtype=dtype, device=dev,
                                       generator=gen)
        self.transform = Dense(H, H, dtype=dtype, device=dev, generator=gen)
        self.transform_norm = LayerNorm(H, eps=enc.layer_norm_eps,
                                        dtype=dtype, device=dev)
        self.decoder_bias = nn.Parameter(torch.zeros(enc.vocab_size,
                                                     device=dev))
        self.seq_relationship = Dense(H, num_seq_relations, dtype=dtype,
                                      device=dev, generator=gen)

    def forward(self, input_ids, img_feats, input_mask, token_type_ids=None,
                masked_lm_labels=None, next_sentence_label=None,
                dropout_gen=None):
        """(lm_logits, rel_logits), and with the labels (total loss,
        lm_logits, rel_logits, mlm_loss)."""
        seq, pooled = self.encoder(input_ids, img_feats, input_mask,
                                   token_type_ids, dropout_gen)
        Lt = input_ids.shape[1]
        h = self.transform_norm(gelu(self.transform(seq[:, :Lt])))
        table = self.encoder.embeddings.word_embeddings     # tied decoder
        lm_logits = torch.einsum("bld,vd->blv", h.float(), table.float()) \
            + self.decoder_bias
        rel_logits = self.seq_relationship(pooled)
        if masked_lm_labels is None:
            return lm_logits, rel_logits
        mlm_loss = _masked_ce(lm_logits, masked_lm_labels.long())
        rel_loss = _masked_ce(rel_logits, next_sentence_label.long())
        return mlm_loss + rel_loss, lm_logits, rel_logits, mlm_loss
