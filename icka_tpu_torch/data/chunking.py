"""Chunk preparation for the ChunkAlign models (port of
`icka_tpu.data.chunking`, numpy only, the same functions line for line).

The reference runs an adapter-based CoNLL-2000 chunker offline over VCR
sentences to produce per-sentence chunk spans (`utils/GetChunk_v4_vcr.py`);
the models consume the spans as `offsets`/`gather_index` plus a
chunk-internal attention mask.

`chunk_arrays` turns spans into tensors (static shapes, dead-chunk
padding); the chunker is pluggable: `heuristic_chunks` approximates chunks
from punctuation and stopword boundaries without a model, and
`models.chunker.ModelChunker` supplies spans of the trained tagger in the
same format (through `bio_spans`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Span = Tuple[int, int]          # [start, end) token indices

_BOUNDARY_WORDS = {
    "a", "an", "the", "is", "are", "was", "were", "be", "been", "being",
    "and", "or", "but", "of", "in", "on", "at", "to", "with", "for",
    "that", "this", "these", "those", "he", "she", "it", "they", "we",
}
_PUNCT = set(".,!?;:()[]\"'")


def heuristic_chunks(tokens: Sequence[str]) -> List[Span]:
    """Greedy NP-ish chunking: function words and punctuation are chunk
    boundaries (each its own chunk); consecutive content words group."""
    spans: List[Span] = []
    start = None
    for i, tok in enumerate(tokens):
        low = tok.lower()
        if low in _BOUNDARY_WORDS or low in _PUNCT or all(
                c in _PUNCT for c in low):
            if start is not None:
                spans.append((start, i))
                start = None
            spans.append((i, i + 1))
        elif start is None:
            start = i
    if start is not None:
        spans.append((start, len(tokens)))
    return spans


def chunk_arrays(spans: Sequence[Span], hypo_len: int,
                 max_chunks: int, cls_offset: int = 1):
    """Spans over sentence tokens → model inputs:

      gather_index (hypo_len,) int32 — chunk id per hypothesis position
        (CLS and positions past the sentence map to a dead chunk);
      chunk_mask   (hypo_len, hypo_len) 0/1 — block-diagonal chunk-internal
        visibility (CLS sees everything; everything sees CLS);
      num_chunks used (incl. dead chunk) — pad the static `max_chunks` to
        at least this.
    """
    dead = max_chunks - 1
    gather = np.full((hypo_len,), dead, np.int32)
    for cid, (s, e) in enumerate(spans):
        if cid >= dead:
            break
        for t in range(s, e):
            pos = t + cls_offset
            if pos < hypo_len:
                gather[pos] = cid

    mask = np.zeros((hypo_len, hypo_len), np.int32)
    same = gather[:, None] == gather[None, :]
    mask[same] = 1
    # CLS row/col fully visible
    mask[0, :] = 1
    mask[:, 0] = 1
    return gather, mask


def chunk_mask_v4(token_labels: Sequence[str], mask_len: int):
    """Faithful port of the reference's BIO→chunk grouping
    (`utils/GetChunk_v4_vcr.py:104-146`): given BIO chunk tags for the
    interior positions 1..mask_len-2 of a [CLS] ... [SEP] sequence,
    build the chunk-internal visibility matrix and the position-sorted
    chunk offset lists.

    Semantics preserved exactly, including the quirk at :129-133 — an O
    token *between* an open chunk and a following I is absorbed into the
    chunk; otherwise O is its own singleton chunk. Row 0 (CLS) and row
    mask_len-1 (SEP) see everything; chunk members see each other.

    Returns (total_mask (mask_len, mask_len) float32, offsets — list of
    ascending member-index lists covering every interior position once).
    """
    assert len(token_labels) == mask_len - 2
    total = np.eye(mask_len, dtype=np.float32)
    total[0, :mask_len] = 1
    tmp: List[int] = []
    for i in range(1, mask_len - 1):
        lab = token_labels[i - 1]
        if lab[0] == "B":
            tmp = [i]
        elif lab[0] == "I":
            for idx in tmp:
                total[idx][i] = 1
                total[i][idx] = 1
            tmp.append(i)
        else:
            # O inside an open B..I run is absorbed (ref :129-133).
            # NOTE the reference does NOT close the open chunk on a
            # singleton O — a later "O I" can still absorb into it across
            # the gap, producing a non-contiguous group. Preserved.
            if (i != mask_len - 2 and tmp
                    and token_labels[i][0] == "I"):
                for idx in tmp:
                    total[idx][i] = 1
                    total[i][idx] = 1
                tmp.append(i)
    total[mask_len - 1, :mask_len] = 1
    offsets: List[List[int]] = []
    seen: set = set()
    for i in range(1, mask_len - 1):
        row = np.nonzero(total[i])[0]
        members = [int(j) for j in row if 0 < j < mask_len - 1]
        if members[0] not in seen:
            offsets.append(members)
            seen.update(members)
    assert len(seen) == mask_len - 2
    return total, offsets


def bio_spans(token_labels: Sequence[str]) -> List[Span]:
    """BIO chunk tags for a sentence's tokens → [start, end) spans over
    those tokens, via the reference grouping (`chunk_mask_v4`). Singleton
    O tokens come out as length-1 spans — same contract as
    `heuristic_chunks`, so `chunk_arrays` composes with either chunker."""
    if not token_labels:
        return []
    _, offsets = chunk_mask_v4(token_labels, len(token_labels) + 2)
    return [(c[0] - 1, c[-1]) for c in offsets]


def batch_chunk_arrays(token_lists: Sequence[Sequence[str]],
                       hypo_len: int, max_chunks: int,
                       chunker=heuristic_chunks):
    """Batched convenience: tokens → (B, hypo_len) gather ids and
    (B, hypo_len, hypo_len) chunk masks."""
    B = len(token_lists)
    gathers = np.zeros((B, hypo_len), np.int32)
    masks = np.zeros((B, hypo_len, hypo_len), np.int32)
    for b, toks in enumerate(token_lists):
        spans = chunker(toks)
        gathers[b], masks[b] = chunk_arrays(spans, hypo_len, max_chunks)
    return gathers, masks
