"""MNER label inventory and id mappings (a copy of `icka_tpu.data.labels`).

Mirrors `MNERProcessor.get_labels/get_auxlabels`
(`My_cross_attention.py:214-228`): ids start at 1 (0 is PAD), special
labels `X` (wordpiece continuation), `[CLS]`/`[SEP]` (BERT dialect) and
`<s>`/`</s>` (RoBERTa dialect) are part of the tag space the CRF sees; the
evaluator filters them out (:882-903).
"""

from __future__ import annotations

MNER_LABELS = ["O", "B-MISC", "I-MISC", "B-PER", "I-PER", "B-ORG", "I-ORG",
               "B-LOC", "I-LOC", "X", "[CLS]", "[SEP]", "<s>", "</s>"]
MNER_AUX_LABELS = ["O", "B", "I", "X", "[CLS]", "[SEP]", "<s>", "</s>"]

#: labels never reported to the evaluator (the reference script's filtering, :891-893)
FILTERED_LABELS = {"X", "<s>", "</s>", "[CLS]", "[SEP]", "PAD"}


def label_map(labels=None) -> dict[str, int]:
    """label → id, 1-based (0 reserved for padding, reference script :269)."""
    labels = labels if labels is not None else MNER_LABELS
    return {lab: i for i, lab in enumerate(labels, 1)}


def aux_label_map() -> dict[str, int]:
    return {lab: i for i, lab in enumerate(MNER_AUX_LABELS, 1)}


def id_to_label(labels=None) -> dict[int, str]:
    labels = labels if labels is not None else MNER_LABELS
    m = {i: lab for i, lab in enumerate(labels, 1)}
    m[0] = "PAD"
    return m


def num_labels(labels=None) -> int:
    """len(label_list) + 1 — reference script :641."""
    labels = labels if labels is not None else MNER_LABELS
    return len(labels) + 1
