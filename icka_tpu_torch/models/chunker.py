"""CoNLL-2000 chunk tagger, the trained chunker behind ChunkAlign data prep
(port of `icka_tpu.models.chunker`).

The reference prepares VCR chunk masks with `BertModelWithHeads` and the
AdapterHub `bert-base-uncased-pf-conll2000` Pfeiffer adapter with a
23-label tagging head (`utils/GetChunk_v4_vcr.py:20-37`), then groups BIO
tags into chunk spans and masks (`data.chunking.chunk_mask_v4`).

`ChunkTagger` is the shared `TextEncoder` stack in its legacy-BERT dialect
with a Pfeiffer bottleneck adapter in every layer
(`EncoderConfig.adapter_size`, see `nn.attention.FeedForward`) and a
linear tagging head. With `use_pallas` its self-attention runs through K1
with a key bias. Weights convert from a local torch `BertModelWithHeads`
state dict with `chunker_params_from_torch` (no download).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from icka_tpu_torch.convert import chunk_tagger_state_dict
from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.data.chunking import bio_spans
from icka_tpu_torch.models.convert import _np32, encoder_params_from_torch
from icka_tpu_torch.nn.bert import TextEncoder
from icka_tpu_torch.nn.layers import Dense, dropout

# `utils/GetChunk_v4_vcr.py:40-43`: model.config.id2label of the
# CoNLL-2000 tagging head.
CONLL2000_LABELS = ("O",) + tuple(
    f"{bi}-{tag}" for tag in
    ("ADJP", "ADVP", "CONJP", "INTJ", "LST", "NP", "PP", "PRT", "SBAR",
     "UCP", "VP")
    for bi in ("B", "I"))
CONLL2000_ID2LABEL = dict(enumerate(CONLL2000_LABELS))


def chunker_config(vocab_size: int = 30522) -> EncoderConfig:
    """bert-base-uncased + Pfeiffer adapter (reduction_factor 16, so 768 /
    16 = 48). The reference resizes embeddings for 45 `<|det%d|>` special
    tokens (`GetChunk_v4_vcr.py:33-35`); pass the resized vocabulary if the
    checkpoint has them."""
    return EncoderConfig(
        vocab_size=vocab_size, hidden_size=768, num_hidden_layers=12,
        num_attention_heads=12, intermediate_size=3072,
        max_position_embeddings=512, type_vocab_size=2,
        layer_norm_eps=1e-12, position_offset=0, pad_token_id=0,
        adapter_size=48)


class ChunkTagger(nn.Module):
    """BERT + adapters + token tagging head -> (B, S, 23) logits, the
    surface of `model(input_ids, attention_mask).logits`
    (`utils/GetChunk_v4_vcr.py:95`). Submodules carry the flax names
    (`bert`, `head`)."""

    def __init__(self, cfg: EncoderConfig,
                 num_labels: int = len(CONLL2000_LABELS),
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.cfg = cfg
        self.bert = TextEncoder(cfg, with_pooler=False, dtype=dtype,
                                device=dev, generator=gen)
        self.head = Dense(cfg.hidden_size, num_labels, dtype=dtype,
                          device=dev, generator=gen)

    def forward(self, input_ids, attention_mask=None, dropout_gen=None):
        x, _ = self.bert(input_ids, attention_mask=attention_mask,
                         dropout_gen=dropout_gen)
        x = dropout(x, self.cfg.hidden_dropout_prob, dropout_gen)
        return self.head(x)


def chunker_params_from_torch(sd: dict, num_layers: int = 12) -> dict:
    """A torch `BertModelWithHeads` state dict (base BERT + Pfeiffer output
    adapters + one tagging head) -> `ChunkTagger` params (the flax tree;
    `convert.chunk_tagger_state_dict` makes it the module's state_dict).

    Key layout handled (adapter-transformers; `adapter_down` with or
    without its `.0`, any adapter name, the last head weight found):
      bert.encoder.layer.{i}.output.adapters.{name}.adapter_down.0.{weight,bias}
      bert.encoder.layer.{i}.output.adapters.{name}.adapter_up.{weight,bias}
      heads.{name}.{k}.{weight,bias}           (Sequential: dropout, linear)
    """
    sd = {k: _np32(v) for k, v in sd.items()}
    params = encoder_params_from_torch(sd, num_layers, prefix="bert.")
    for i in range(num_layers):
        found = {}
        pat = re.compile(
            rf"(?:bert\.)?encoder\.layer\.{i}\.output\.adapters\.[^.]+\."
            r"(adapter_down(?:\.0)?|adapter_up)\.(weight|bias)$")
        for k, v in sd.items():
            m = pat.search(k)
            if m:
                which = ("down" if m.group(1).startswith("adapter_down")
                         else "up")
                found[which, m.group(2)] = v
        if ("down", "weight") not in found or ("up", "weight") not in found:
            raise KeyError(f"no adapter weights found for layer {i}")
        ffn = params["encoder"][f"layer_{i}"]["ffn"]
        for which in ("down", "up"):
            ffn[f"adapter_{which}"] = {
                "kernel": found[which, "weight"].T,
                "bias": found.get((which, "bias"))}
    head = None
    for k, v in sd.items():
        if k.startswith("heads.") and k.endswith(".weight") and v.ndim == 2:
            head = {"kernel": v.T, "bias": sd[k[:-len("weight")] + "bias"]}
    if head is None:
        raise KeyError("no tagging head found under heads.*")
    return {"bert": params, "head": head}


class ModelChunker:
    """Pluggable trained chunker: token ids -> BIO labels -> chunk spans.

    Drop-in counterpart to `data.chunking.heuristic_chunks` for callers
    that have a converted checkpoint. `params` is the flax tree of
    `chunker_params_from_torch` (or of the JAX package's `ChunkTagger`).
    Sequences are padded to multiples of `bucket`, the JAX class's shapes;
    the model runs eagerly on `device` (`model` is the `ChunkTagger`)."""

    def __init__(self, params, cfg: EncoderConfig | None = None,
                 bucket: int = 32, device="cuda"):
        self.cfg = cfg or chunker_config()
        self.bucket = bucket
        self.device = resolve_device(device)
        self.model = ChunkTagger(self.cfg, device=self.device).eval()
        # a `BertModelWithHeads` checkpoint carries BERT's pooler, which
        # the tagger does not use (flax ignores it in the JAX class)
        sd = {k: v for k, v in
              chunk_tagger_state_dict({"params": params}).items()
              if not k.startswith("bert.pooler.")}
        self.model.load_state_dict(sd, strict=True)

    def batch(self, input_ids_batch):
        """Id sequences -> (ids, mask) (B, S) on the device, S the smallest
        multiple of `bucket` (at least `bucket`) that holds the longest."""
        lens = [len(ids) for ids in input_ids_batch]
        S = max(self.bucket, -(-max(lens) // self.bucket) * self.bucket)
        ids = np.zeros((len(lens), S), np.int64)
        mask = np.zeros((len(lens), S), np.int64)
        for r, seq in enumerate(input_ids_batch):
            ids[r, :len(seq)] = seq
            mask[r, :len(seq)] = 1
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    @torch.no_grad()
    def tag(self, input_ids_batch) -> list:
        """List of id sequences (with CLS/SEP) -> list of BIO label lists
        for the interior positions (1..len-2), as in
        `utils/GetChunk_v4_vcr.py:104-118`."""
        ids, mask = self.batch(input_ids_batch)
        classes = self.model(ids, attention_mask=mask).argmax(-1).cpu()
        return [[CONLL2000_ID2LABEL[int(c)] for c in row[1:len(seq) - 1]]
                for row, seq in zip(classes.numpy(), input_ids_batch)]

    def __call__(self, input_ids) -> list:
        """One sequence -> chunk spans ([start, end) over interior tokens),
        the contract of `heuristic_chunks`."""
        return bio_spans(self.tag([input_ids])[0])
