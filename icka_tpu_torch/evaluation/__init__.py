"""Chunk F1, the seqeval-style report and image-text retrieval metrics (a
copy of `icka_tpu.evaluation`)."""

from icka_tpu_torch.evaluation.chunk_f1 import (
    extract_chunks,
    evaluate_chunk_f1,
    evaluate_class_f1,
)
from icka_tpu_torch.evaluation.report import classification_report
from icka_tpu_torch.evaluation.retrieval import itm_eval, recall_at_k

__all__ = [
    "extract_chunks",
    "evaluate_chunk_f1",
    "evaluate_class_f1",
    "classification_report",
    "itm_eval",
    "recall_at_k",
]
