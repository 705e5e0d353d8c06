"""Chunk-exact micro P/R/F1 for BIO sequence labelling (a copy of
`icka_tpu.evaluation.chunk_f1`).

Specification port of the reference evaluator (`ner_evaluate.py:4-148`),
which defines the reported Twitter-2015/2017 numbers — including its exact
edge-case behavior:

  - a chunk starts at any non-O tag and extends until the tag type changes,
    a `B-` prefix restarts it, or an O tag closes it (`get_chunks` :23-48);
    `I-X` after `O` *opens* a chunk (reference behavior, kept);
  - the prefix is `tag.split('-')[0]`, the type `split('-')[-1]`, so bare
    tags like `<s>` become their own chunk type — callers filter those out
    upstream exactly like the reference script does (`My_cross_attention.py:882-903`);
  - precision/recall guard: all three metrics are 0 when there are no
    correct predictions (:104-106);
  - accuracy is the token-level mean over all compared positions (:93,107).

The reference writes a `test_results.txt` token/gold/pred dump as a side
effect (:79,100-102); here that is an optional explicit argument.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np


def _tag_parts(tag: str) -> tuple[str, str]:
    return tag.split("-")[0], tag.split("-")[-1]


def extract_chunks(seq: Sequence[int], tag_to_id: dict[str, int]):
    """BIO id sequence → set-comparable list of (type, start, end) with the
    reference's exact transition rules."""
    default = tag_to_id["O"]
    id_to_tag = {i: t for t, i in tag_to_id.items()}
    chunks = []
    chunk_type, chunk_start = None, None
    for i, tok in enumerate(seq):
        if tok == default:
            if chunk_type is not None:
                chunks.append((chunk_type, chunk_start, i))
                chunk_type, chunk_start = None, None
        else:
            prefix, ctype = _tag_parts(id_to_tag[int(tok)])
            if chunk_type is None:
                chunk_type, chunk_start = ctype, i
            elif ctype != chunk_type or prefix == "B":
                chunks.append((chunk_type, chunk_start, i))
                chunk_type, chunk_start = ctype, i
    if chunk_type is not None:
        chunks.append((chunk_type, chunk_start, len(seq)))
    return chunks


@dataclass
class ChunkMetrics:
    acc: float
    f1: float
    precision: float
    recall: float

    def __iter__(self):
        # reference call sites unpack `acc, f1, p, r`
        return iter((self.acc, self.f1, self.precision, self.recall))


def evaluate_chunk_f1(pred_ids: Iterable[Sequence[int]],
                      gold_ids: Iterable[Sequence[int]],
                      tag_to_id: dict[str, int],
                      dump_path: Optional[str] = None,
                      pred_tags: Optional[Iterable[Sequence[str]]] = None,
                      gold_tags: Optional[Iterable[Sequence[str]]] = None,
                      words: Optional[Iterable[Sequence[str]]] = None,
                      ) -> ChunkMetrics:
    """Micro chunk-F1 + token accuracy (`ner_evaluate.evaluate` :64-110)."""
    accs = []
    correct, total_pred, total_gold = 0.0, 0.0, 0.0
    for gold, pred in zip(gold_ids, pred_ids):
        accs.extend(int(a == b) for a, b in zip(gold, pred))
        gold_chunks = set(extract_chunks(gold, tag_to_id))
        pred_chunks = set(extract_chunks(pred, tag_to_id))
        correct += len(gold_chunks & pred_chunks)
        total_pred += len(pred_chunks)
        total_gold += len(gold_chunks)

    if dump_path and words is not None and pred_tags is not None:
        with open(dump_path, "w") as f:
            for ws, gts, pts in zip(words, gold_tags, pred_tags):
                for w, g, p in zip(ws, gts, pts):
                    f.write(f"{w}\t{g}\t{p}\n")
                f.write("\n")

    p = correct / total_pred if correct > 0 else 0.0
    r = correct / total_gold if correct > 0 else 0.0
    f1 = 2 * p * r / (p + r) if correct > 0 else 0.0
    acc = float(np.mean(accs)) if accs else 0.0
    return ChunkMetrics(acc=acc, f1=f1, precision=p, recall=r)


def evaluate_class_f1(pred_ids, gold_ids, tag_to_id, class_type: str):
    """Per-class chunk F1 (`ner_evaluate.evaluate_each_class` :112-148),
    including the reference's asymmetry: predicted chunks of the class are
    matched against ALL gold chunks."""
    correct, total_pred, total_gold = 0.0, 0.0, 0.0
    for gold, pred in zip(gold_ids, pred_ids):
        gold_chunks = extract_chunks(gold, tag_to_id)
        pred_chunks = extract_chunks(pred, tag_to_id)
        pred_cls = {c for c in pred_chunks if c[0] == class_type}
        gold_cls = {c for c in gold_chunks if c[0] == class_type}
        correct += len(pred_cls & set(gold_chunks))
        total_pred += len(pred_cls)
        total_gold += len(gold_cls)
    p = correct / total_pred if correct > 0 else 0.0
    r = correct / total_gold if correct > 0 else 0.0
    f1 = 2 * p * r / (p + r) if correct > 0 else 0.0
    return f1, p, r
