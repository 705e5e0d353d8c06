"""Image-text retrieval evaluation (R@1/5/10, reference `utils/itm_eval.py`
component #28; a copy of `icka_tpu.evaluation.retrieval`).

The reference scores every (caption, image) pair with a matching head,
Horovod-allgathers score shards and computes recall@K in both directions
(:19-67). Here scoring is a caller-supplied similarity matrix (or callback
evaluated in batches) and the metrics are pure numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np


def recall_at_k(score_matrix: np.ndarray, gold_index: np.ndarray,
                ks: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """score_matrix (Q, C): per-query candidate scores; gold_index (Q,)."""
    order = np.argsort(-score_matrix, axis=1)
    ranks = np.empty(len(gold_index), np.int64)
    for i, gold in enumerate(gold_index):
        ranks[i] = int(np.where(order[i] == gold)[0][0])
    out = {}
    for k in ks:
        out[f"r{k}"] = float((ranks < k).mean())
    out["medr"] = float(np.median(ranks) + 1)
    out["meanr"] = float(ranks.mean() + 1)
    return out


def itm_eval(sim: np.ndarray,
             txt2img_gold: Optional[np.ndarray] = None,
             img2txt_gold: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Bidirectional retrieval metrics from a (num_texts, num_images)
    similarity matrix. Defaults assume aligned diagonals (text i ↔ image i).
    Returns the reference's metric dict layout: txt_r1/5/10, img_r1/5/10,
    r_mean, plus median/mean ranks."""
    T, I = sim.shape
    if txt2img_gold is None:
        txt2img_gold = np.arange(T) % I
    if img2txt_gold is None:
        img2txt_gold = np.arange(I) % T
    t2i = recall_at_k(sim, txt2img_gold)
    i2t = recall_at_k(sim.T, img2txt_gold)
    out = {f"txt_r{k}": t2i[f"r{k}"] for k in (1, 5, 10)}
    out.update({f"img_r{k}": i2t[f"r{k}"] for k in (1, 5, 10)})
    out["txt_medr"] = t2i["medr"]
    out["img_medr"] = i2t["medr"]
    out["r_mean"] = float(np.mean(
        [out[f"txt_r{k}"] for k in (1, 5, 10)]
        + [out[f"img_r{k}"] for k in (1, 5, 10)]))
    return out


def score_all_pairs(score_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                    text_ids: np.ndarray, image_feats: np.ndarray,
                    batch_size: int = 64) -> np.ndarray:
    """Materialize the full similarity matrix by scoring text batches
    against every image (the `inference` loop of the reference, :70-113)."""
    T = len(text_ids)
    I = len(image_feats)
    sim = np.zeros((T, I), np.float32)
    for t0 in range(0, T, batch_size):
        texts = text_ids[t0:t0 + batch_size]
        for i0 in range(0, I, batch_size):
            imgs = image_feats[i0:i0 + batch_size]
            sim[t0:t0 + len(texts), i0:i0 + len(imgs)] = np.asarray(
                score_fn(texts, imgs))
    return sim
