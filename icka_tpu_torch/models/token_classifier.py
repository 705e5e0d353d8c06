"""Text-only classification heads over one BERT encoder (port of
`icka_tpu.models.token_classifier`): `TokenClassifier`, the text-only NER
baseline (a per-token linear classifier trained with masked
cross-entropy), and `SequenceClassifier` on the pooled output.

Both take `dropout_gen` as the encoders do (see
`icka_tpu_torch.nn.attention`): None runs deterministically. Parameters
are fp32 and made on `device` from `generator` (or a new one seeded with
`seed`); `dtype` is the compute dtype. The losses are computed in fp32
whatever the compute dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.nn.bert import TextEncoder
from icka_tpu_torch.nn.layers import Dense, dropout


class _Classifier(nn.Module):
    """`bert` (a TextEncoder) and `classifier` (a Dense), the flax names."""

    def __init__(self, cfg: EncoderConfig, num_labels: int, with_pooler: bool,
                 dtype=torch.float32, device="cuda", seed: int | None = None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, seed, generator)
        self.cfg = cfg
        self.bert = TextEncoder(cfg, with_pooler=with_pooler, dtype=dtype,
                                device=dev, generator=gen)
        self.classifier = Dense(cfg.hidden_size, num_labels, dtype=dtype,
                                device=dev, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device


class TokenClassifier(_Classifier):
    """BERT -> dropout -> per-token Dense. Returns (B, L, num_labels) logits,
    or with `labels` the cross-entropy averaged over the tokens that
    `attention_mask` keeps (all when it is None)."""

    def __init__(self, cfg: EncoderConfig, num_labels: int, **kw):
        super().__init__(cfg, num_labels, with_pooler=False, **kw)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                labels=None, dropout_gen=None):
        seq, _ = self.bert(input_ids, attention_mask, token_type_ids,
                           dropout_gen=dropout_gen)
        seq = dropout(seq, self.cfg.hidden_dropout_prob, dropout_gen)
        logits = self.classifier(seq)
        if labels is None:
            return logits
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels.long()[..., None])[..., 0]
        m = (attention_mask if attention_mask is not None
             else torch.ones_like(labels)).float()
        return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


class SequenceClassifier(_Classifier):
    """BERT pooled output -> dropout -> Dense. Returns (B, num_labels)
    logits, or with `labels` (B,) the mean cross-entropy."""

    def __init__(self, cfg: EncoderConfig, num_labels: int, **kw):
        super().__init__(cfg, num_labels, with_pooler=True, **kw)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                labels=None, dropout_gen=None):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              dropout_gen=dropout_gen)
        pooled = dropout(pooled, self.cfg.hidden_dropout_prob, dropout_gen)
        logits = self.classifier(pooled)
        if labels is None:
            return logits
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels.long()[:, None]).mean()
