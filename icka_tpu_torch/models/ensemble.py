"""Score-level model ensembling (port of `icka_tpu.models.ensemble`).

`modeling/modeling_ensemble.py` (component #24): `dual_ensemble_model*`
(:45-352) average or stack two ChunkAlign variants' per-choice scores,
`Abstract_Specific` (:424) mixes an abstract (caption-level) and a
specific (region-level) scorer through a learned gate, and `model_vote`
(:1006) majority-votes hard predictions. The combiners are pure functions
of (B, C) score matrices.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.nn.layers import Dense

# a member: (batch) -> (B, C) per-choice scores
ScoreFn = Callable[..., torch.Tensor]


def mean_ensemble(scores: Sequence, weights: Sequence[float] | None = None):
    """Weighted average of per-choice score matrices (dual_ensemble)."""
    if weights is None:
        weights = [1.0] * len(scores)
    total = sum(w * torch.as_tensor(s) for w, s in zip(weights, scores))
    return total / sum(weights)


def logprob_ensemble(scores: Sequence):
    """Average in log-probability space (each member normalised first)."""
    logps = [torch.log_softmax(torch.as_tensor(s), dim=-1) for s in scores]
    return sum(logps) / len(logps)


def model_vote(predictions: Sequence[np.ndarray]) -> np.ndarray:
    """Majority vote over hard predictions; ties go to the first member's
    choice (`model_vote` :1006)."""
    preds = np.stack([np.asarray(p) for p in predictions])   # (M, B)
    M, B = preds.shape
    out = np.empty(B, preds.dtype)
    for b in range(B):
        vals, counts = np.unique(preds[:, b], return_counts=True)
        winners = set(vals[counts == counts.max()])
        for m in range(M):
            if preds[m, b] in winners:
                out[b] = preds[m, b]
                break
    return out


class AbstractSpecificGate(nn.Module):
    """`Abstract_Specific` (:424): `gate` (a Dense to one logit) over both
    scorers' pooled features gives the mixing coefficient g;
    g * abstract + (1 - g) * specific."""

    def __init__(self, hidden: int, device="cuda", seed: int | None = None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.gate = Dense(2 * hidden, 1, device=dev,
                          generator=generator_for(dev, seed, generator))

    def forward(self, abstract_feat, specific_feat, abstract_scores,
                specific_scores):
        g = torch.sigmoid(self.gate(torch.cat([abstract_feat, specific_feat],
                                              dim=-1)))
        return g * abstract_scores + (1.0 - g) * specific_scores
