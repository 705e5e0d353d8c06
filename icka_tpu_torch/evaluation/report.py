"""seqeval-style classification report (a copy of
`icka_tpu.evaluation.report`).

The reference prints `seqeval.metrics.classification_report(y_true, y_pred,
digits=4)` each dev epoch (`My_cross_attention.py:905`). seqeval is not a
baked-in dependency, so this is a native implementation of its default
(scheme-agnostic BIOES-tolerant) entity extraction and report layout:
per-type precision/recall/F1/support plus micro/macro/weighted averages.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence, Tuple


def _end_of_chunk(prev_tag, tag, prev_type, type_):
    return (
        prev_tag in ("E", "S")
        or (prev_tag == "B" and tag in ("B", "S", "O"))
        or (prev_tag == "I" and tag in ("B", "S", "O"))
        or (prev_tag not in ("O", ".") and prev_type != type_)
    )


def _start_of_chunk(prev_tag, tag, prev_type, type_):
    return (
        tag in ("B", "S")
        or (prev_tag in ("E", "S", "O") and tag in ("E", "I"))
        or (tag not in ("O", ".") and prev_type != type_)
    )


def get_entities(seq) -> List[Tuple[str, int, int]]:
    """Extract (type, start, end_inclusive) entities from BIO/BIOES tags.
    Accepts a flat tag list or a list of per-sentence lists (flattened with
    'O' separators, matching seqeval)."""
    if seq and isinstance(seq[0], (list, tuple)):
        flat: list = []
        for s in seq:
            flat.extend(list(s) + ["O"])
        seq = flat
    prev_tag, prev_type = "O", ""
    begin = 0
    chunks = []
    for i, chunk in enumerate(list(seq) + ["O"]):
        tag = chunk[0]
        type_ = chunk.split("-")[-1] if "-" in chunk else chunk
        if _end_of_chunk(prev_tag, tag, prev_type, type_):
            chunks.append((prev_type, begin, i - 1))
        if _start_of_chunk(prev_tag, tag, prev_type, type_):
            begin = i
        prev_tag, prev_type = tag, type_
    return chunks


def precision_recall_f1(y_true, y_pred):
    """Micro entity-level P/R/F1 over (possibly nested) tag sequences."""
    true_entities = set(get_entities(y_true))
    pred_entities = set(get_entities(y_pred))
    correct = len(true_entities & pred_entities)
    p = correct / len(pred_entities) if pred_entities else 0.0
    r = correct / len(true_entities) if true_entities else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1


def classification_report(y_true, y_pred, digits: int = 4) -> str:
    true_entities = get_entities(y_true)
    pred_entities = get_entities(y_pred)
    true_by_type = defaultdict(set)
    pred_by_type = defaultdict(set)
    for e in true_entities:
        true_by_type[e[0]].add(e)
    for e in pred_entities:
        pred_by_type[e[0]].add(e)

    rows = []
    for name in sorted(set(true_by_type) | set(pred_by_type)):
        t, p = true_by_type[name], pred_by_type[name]
        correct = len(t & p)
        prec = correct / len(p) if p else 0.0
        rec = correct / len(t) if t else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        rows.append((name, prec, rec, f1, len(t)))

    total_true = sum(r[4] for r in rows)
    micro_p, micro_r, micro_f1 = precision_recall_f1(y_true, y_pred)
    macro = [sum(r[i] for r in rows) / len(rows) if rows else 0.0
             for i in (1, 2, 3)]
    weighted = [
        (sum(r[i] * r[4] for r in rows) / total_true) if total_true else 0.0
        for i in (1, 2, 3)]

    width = max([len(r[0]) for r in rows] + [len("weighted avg")])
    head_fmt = "{:>{width}s}  {:>9} {:>9} {:>9} {:>9}\n"
    row_fmt = "{:>{width}s}  {:>9.{digits}f} {:>9.{digits}f} " \
              "{:>9.{digits}f} {:>9}\n"
    out = head_fmt.format("", "precision", "recall", "f1-score", "support",
                          width=width)
    out += "\n"
    for name, prec, rec, f1, support in rows:
        out += row_fmt.format(name, prec, rec, f1, support,
                              width=width, digits=digits)
    out += "\n"
    out += row_fmt.format("micro avg", micro_p, micro_r, micro_f1,
                          total_true, width=width, digits=digits)
    out += row_fmt.format("macro avg", *macro, total_true,
                          width=width, digits=digits)
    out += row_fmt.format("weighted avg", *weighted, total_true,
                          width=width, digits=digits)
    return out
