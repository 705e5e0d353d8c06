"""Prompted feature construction: sentences + labels + image/CLIP features →
fixed-shape arrays (a copy of `icka_tpu.data.features`).

Specification port of `convert_mm_examples_to_features`
(`My_cross_attention.py:250-472`), preserving its exact (sometimes quirky)
behavior because token/label alignment defines the reported F1:

  - prompt template `"<s> Image is <mask> Bridge between Image and the Text
    is <mask> </s> Text is"` tokenized word-by-word (:293-320), so subwords
    never get the leading-space mark;
  - the sentence is wrapped `bos + text + eos` and tokenized word-by-word;
    the first wordpiece of a word carries its BIO label, continuations get
    `X` (:330-351);
  - truncation to max_seq_length − 2 when overlong (:353-356);
  - `ori_input_ids` padded with 0 (:375-379) — id 0, not the RoBERTa pad id;
  - `input_ids = prompt_ids + padded_ori_ids`, its mask is 1 across the
    *padded* sentence region (:398,415 — the prompt encoder attends over
    sentence padding; kept for parity), then padded to
    `max_input_length = max_seq_length + 12 + 30` (:305);
  - `segment_ids`: 0 over the prompt, 1 afterwards (:416-422);
  - `added_input_mask` carries 49 leading image-region slots (:373).

The image itself is NOT materialized here (the reference decodes the whole
dataset into host RAM, :685-699); features carry the image path/id and the
loader streams pixels (`icka_tpu_torch.data.images`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from icka_tpu_torch.data.conll import MMExample
from icka_tpu_torch.data.labels import MNER_AUX_LABELS, MNER_LABELS

PROMPT_TEXT = "Image is <mask> Bridge between Image and the Text is <mask> "
NUM_REGIONS = 49


@dataclass(frozen=True)
class PromptSpec:
    """Static geometry of the prompted input, shared by a whole dataset
    (the reference script asserts equal offsets per batch, :802)."""

    offset: int                 # index where the sentence starts
    mask_positions: tuple       # indices of the two <mask> tokens
    max_input_length: int
    max_seq_length: int


@dataclass
class MMFeatures:
    """Columnar features for a whole split (structure-of-arrays — feeds
    device batches directly, unlike the reference's list-of-objects)."""

    input_ids: np.ndarray        # (N, max_input_length) int32
    input_mask: np.ndarray
    segment_ids: np.ndarray
    ori_input_ids: np.ndarray    # (N, max_seq_length) int32
    ori_input_mask: np.ndarray
    ori_segment_ids: np.ndarray
    label_ids: np.ndarray
    aux_label_ids: np.ndarray
    output_mask: np.ndarray
    added_input_mask: np.ndarray  # (N, max_seq_length + 49)
    clip_features: np.ndarray    # (N, 1, clip_dim) float32
    img_ids: List[str] = field(default_factory=list)
    spec: Optional[PromptSpec] = None

    def __len__(self):
        return self.input_ids.shape[0]

    def batch_dict(self, idx) -> Dict[str, np.ndarray]:
        """Model-facing arrays for a set of row indices (images are merged
        in by the loader)."""
        return {
            "input_ids": self.input_ids[idx],
            "input_mask": self.input_mask[idx],
            "segment_ids": self.segment_ids[idx],
            "ori_input_ids": self.ori_input_ids[idx],
            "ori_input_mask": self.ori_input_mask[idx],
            "ori_segment_ids": self.ori_segment_ids[idx],
            "img_mask": self.added_input_mask[idx][:, :NUM_REGIONS],
            "clip_features": self.clip_features[idx],
            "output_mask": self.output_mask[idx],
        }


def build_prompt(tokenizer) -> tuple[list[int], tuple[int, int]]:
    """Tokenize the prompt template word-by-word; returns (prompt ids,
    positions of the two mask tokens)."""
    all_input = (tokenizer.bos_token + " " + PROMPT_TEXT
                 + tokenizer.eos_token + " Text is ")
    tokens: list[str] = []
    for word in all_input.split(" "):
        if word:
            tokens.extend(tokenizer.tokenize(word)
                          if word not in (tokenizer.bos_token,
                                          tokenizer.eos_token,
                                          tokenizer.mask_token)
                          else [word])
    mask_pos = tuple(i for i, t in enumerate(tokens)
                     if t == tokenizer.mask_token)
    if len(mask_pos) != 2:
        raise ValueError(f"prompt must contain exactly two mask tokens, "
                         f"found {len(mask_pos)}: {tokens}")
    return tokenizer.convert_tokens_to_ids(tokens), mask_pos


def convert_examples(examples: Sequence[MMExample], tokenizer,
                     max_seq_length: int = 128,
                     clip_store=None, clip_dim: int = 512,
                     label_list=None, aux_label_list=None) -> MMFeatures:
    label_list = label_list or MNER_LABELS
    aux_label_list = aux_label_list or MNER_AUX_LABELS
    label_map = {l: i for i, l in enumerate(label_list, 1)}
    aux_map = {l: i for i, l in enumerate(aux_label_list, 1)}
    bos, eos = tokenizer.bos_token, tokenizer.eos_token

    prompt_ids, mask_positions = build_prompt(tokenizer)
    offset = len(prompt_ids)
    # reference formula (:305) assumes ~1 token per prompt word; widen when
    # a small-vocab tokenizer splits the prompt into more pieces
    max_input_length = max(
        max_seq_length + len(PROMPT_TEXT.split(" ")) + 30,
        offset + max_seq_length)
    spec = PromptSpec(offset, mask_positions, max_input_length,
                      max_seq_length)

    n = len(examples)
    f = MMFeatures(
        input_ids=np.zeros((n, max_input_length), np.int32),
        input_mask=np.zeros((n, max_input_length), np.int32),
        segment_ids=np.zeros((n, max_input_length), np.int32),
        ori_input_ids=np.zeros((n, max_seq_length), np.int32),
        ori_input_mask=np.zeros((n, max_seq_length), np.int32),
        ori_segment_ids=np.zeros((n, max_seq_length), np.int32),
        label_ids=np.zeros((n, max_seq_length), np.int32),
        aux_label_ids=np.zeros((n, max_seq_length), np.int32),
        output_mask=np.zeros((n, max_seq_length), np.int32),
        added_input_mask=np.zeros((n, max_seq_length + NUM_REGIONS),
                                  np.int32),
        clip_features=np.zeros((n, 1, clip_dim), np.float32),
        img_ids=[],
        spec=spec,
    )

    for row, ex in enumerate(examples):
        tokens: list[int] = []
        labels: list[str] = []
        aux: list[str] = []
        words = ([bos] + ex.text.split(" ") + [eos])
        word_labels = [None] + list(ex.labels) + [None]
        word_aux = [None] + list(ex.aux_labels or ["O"] * len(ex.labels)) \
            + [None]
        for i, word in enumerate(words):
            if word in (bos, eos):
                tokens.append(word)
                labels.append(word)
                aux.append(word)
                continue
            pieces = tokenizer.tokenize(word)
            tokens.extend(pieces)
            for m in range(len(pieces)):
                labels.append(word_labels[i] if m == 0 else "X")
                aux.append(word_aux[i] if m == 0 else "X")

        if len(tokens) >= max_seq_length - 1:
            tokens = tokens[: max_seq_length - 2]
            labels = labels[: max_seq_length - 2]
            aux = aux[: max_seq_length - 2]

        ids = tokenizer.convert_tokens_to_ids(tokens)
        L = len(ids)
        f.ori_input_ids[row, :L] = ids
        f.ori_input_mask[row, :L] = 1
        f.label_ids[row, :L] = [label_map[l] for l in labels]
        f.aux_label_ids[row, :L] = [aux_map[a] for a in aux]
        f.output_mask[row, :L] = 1
        f.added_input_mask[row, : L + NUM_REGIONS] = 1

        full = prompt_ids + list(f.ori_input_ids[row])
        f.input_ids[row, : len(full)] = full
        f.input_mask[row, : len(full)] = 1
        f.segment_ids[row, offset:] = 1

        if clip_store is not None:
            key = ex.img_id.split(".")[0]
            f.clip_features[row, 0] = clip_store[key]
        f.img_ids.append(ex.img_id)

    return f
