"""Linear-chain CRF decoding (port of `icka_tpu.nn.crf`, torchcrf
semantics). Only the Viterbi decode is ported, with the `reset` lattice cut
of packed serving; the log-likelihood, marginals and the log-depth parallel
decode wait for a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device


def crf_decode(emissions, mask, start, end, trans, reset=None):
    """Batched masked Viterbi, fp32. Returns (B, L) int32 best-path tags.

    Masked steps carry scores unchanged and record identity backpointers,
    so the backward trace passes through padding; positions past a
    sequence's end hold the tag at its last valid step. Ties go to the
    first maximum, as `jnp.argmax` does.

    `reset` (B, L) {0,1}, optional, for sequence packing: a set bit at
    position t > 0 marks the first token of a new packed segment. The
    lattice is cut there: the score restarts as `start + emissions[t]`, and
    the backpointer at t re-seeds the backward trace with the previous
    segment's best final tag, argmax(score + end). One (B, L) decode then
    gives every segment the path it would get alone. `reset[:, 0]` is
    ignored (position 0 always starts a segment)."""
    em = emissions.float()
    B, L, T = em.shape
    maskb = mask.bool()
    resetb = None if reset is None else reset.bool()
    score = start[None, :] + em[:, 0]                          # (B, T)
    ident = torch.arange(T, device=em.device).expand(B, T)
    history = []
    for t in range(1, L):
        cand = score[:, :, None] + trans[None] + em[:, t, None, :]
        best_score, best_prev = cand.max(dim=1)                # (B, next)
        m_t = maskb[:, t, None]
        new_score = torch.where(m_t, best_score, score)
        bp = torch.where(m_t, best_prev, ident)
        if resetb is not None:
            r_t = resetb[:, t, None]
            seg_last = torch.argmax(score + end[None, :], dim=1)
            new_score = torch.where(r_t, start[None, :] + em[:, t], new_score)
            bp = torch.where(r_t, seg_last[:, None].expand(B, T), bp)
        score = new_score
        history.append(bp)
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

    def decode(self, emissions, mask, reset=None):
        return crf_decode(emissions, mask, self.start_transitions,
                          self.end_transitions, self.transitions, reset=reset)
