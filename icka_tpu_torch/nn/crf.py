"""Linear-chain CRF decoding (port of `icka_tpu.nn.crf`, torchcrf
semantics). Only the Viterbi decode is ported; the log-likelihood,
marginals, the log-depth parallel decode and the packed `reset` lattice cut
wait for a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device


def crf_decode(emissions, mask, start, end, trans):
    """Batched masked Viterbi, fp32. Returns (B, L) int32 best-path tags.

    Masked steps carry scores unchanged and record identity backpointers,
    so the backward trace passes through padding; positions past a
    sequence's end hold the tag at its last valid step. Ties go to the
    first maximum, as `jnp.argmax` does."""
    em = emissions.float()
    B, L, T = em.shape
    maskb = mask.bool()
    score = start[None, :] + em[:, 0]                          # (B, T)
    ident = torch.arange(T, device=em.device).expand(B, T)
    history = []
    for t in range(1, L):
        cand = score[:, :, None] + trans[None] + em[:, t, None, :]
        best_score, best_prev = cand.max(dim=1)                # (B, next)
        m_t = maskb[:, t, None]
        score = torch.where(m_t, best_score, score)
        history.append(torch.where(m_t, best_prev, ident))
    tag = torch.argmax(score + end[None, :], dim=1)
    tags = [tag]
    for bp in reversed(history):
        tag = bp.gather(1, tag[:, None])[:, 0]
        tags.append(tag)
    return torch.stack(tags[::-1], dim=1).int()


class CRF(nn.Module):
    """Holds the transition parameters (torchcrf init: uniform(-0.1, 0.1))."""

    def __init__(self, num_tags: int, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        for name, shape in (("start_transitions", (num_tags,)),
                            ("end_transitions", (num_tags,)),
                            ("transitions", (num_tags, num_tags))):
            p = nn.Parameter(torch.empty(shape, device=dev))
            nn.init.uniform_(p, -0.1, 0.1, generator=gen)
            self.register_parameter(name, p)

    def decode(self, emissions, mask):
        return crf_decode(emissions, mask, self.start_transitions,
                          self.end_transitions, self.transitions)
