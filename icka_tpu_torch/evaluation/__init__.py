"""Chunk F1 and the seqeval-style report (a copy of `icka_tpu.evaluation`,
without retrieval)."""

from icka_tpu_torch.evaluation.chunk_f1 import (
    extract_chunks,
    evaluate_chunk_f1,
    evaluate_class_f1,
)
from icka_tpu_torch.evaluation.report import classification_report

__all__ = [
    "extract_chunks",
    "evaluate_chunk_f1",
    "evaluate_class_f1",
    "classification_report",
]
