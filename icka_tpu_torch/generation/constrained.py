"""Constrained beam search: FSM-guided decoding (port of
`icka_tpu.generation.constrained`).

Rebuild of `utils/cbs.py` (reference component #25): `ConstrainedBeamSearch`
(:30-365) tracks a separate beam population per finite-state-machine state;
emitting a constraint word moves probability mass between FSM states, and
`select_best_beam_with_constraints` (:366-430) prefers completed hypotheses
that satisfied at least `min_constraints`. `FiniteStateMachineBuilder`
(:631-857) compiles constraint words (multi-token phrases included) into
the state machine.

The JAX package's shapes: the FSM is a dense `(S, V) -> S` next-state
table (numpy), the beam tensor is (B, S, K) and every step is one batched
top-k per target state (`decoding.top_k`, `jax.lax.top_k`'s tie order: the
per-state -1e9 masks tie by the thousand), in a Python loop over `t`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from icka_tpu_torch.generation.decoding import (StepFn, _as_tokens,
                                                _forced_active,
                                                _forced_tokens, top_k,
                                                tree_map)


@dataclass
class ConstraintFSM:
    next_state: np.ndarray       # (S, V) int32
    num_bits: int                # number of constraints
    state_bits: np.ndarray       # (S,) satisfied-constraint count per state

    @property
    def num_states(self) -> int:
        return self.next_state.shape[0]


def fsm_from_constraints(constraints: Sequence[Sequence[int]],
                         vocab_size: int) -> ConstraintFSM:
    """Build the FSM for up to a few constraint token-sequences.

    Base states are bitmasks over satisfied constraints; a multi-token
    constraint adds chain sub-states that advance only on its next token
    (reference FiniteStateMachineBuilder semantics: partial matches reset
    to the base state on mismatch).
    """
    n = len(constraints)
    base = 2 ** n
    # sub-states: for each (bitmask, constraint, position>0)
    chain_index: dict[tuple[int, int, int], int] = {}
    S = base
    for mask in range(base):
        for c, toks in enumerate(constraints):
            if mask & (1 << c):
                continue
            for pos in range(1, len(toks)):
                chain_index[(mask, c, pos)] = S
                S += 1

    nxt = np.zeros((S, vocab_size), np.int32)
    for mask in range(base):
        nxt[mask, :] = mask
        for c, toks in enumerate(constraints):
            if mask & (1 << c):
                continue
            first = toks[0]
            if len(toks) == 1:
                nxt[mask, first] = mask | (1 << c)
            else:
                nxt[mask, first] = chain_index[(mask, c, 1)]
    for (mask, c, pos), s in chain_index.items():
        toks = constraints[c]
        nxt[s, :] = mask                      # mismatch resets
        # a mismatch that begins another constraint still starts its chain
        for c2, toks2 in enumerate(constraints):
            if mask & (1 << c2) or c2 == c:
                continue
            nxt[s, toks2[0]] = (mask | (1 << c2)) if len(toks2) == 1 \
                else chain_index[(mask, c2, 1)]
        tok = toks[pos]
        if pos == len(toks) - 1:
            nxt[s, tok] = mask | (1 << c)
        else:
            nxt[s, tok] = chain_index[(mask, c, pos + 1)]

    bits = np.zeros(S, np.int32)
    for mask in range(base):
        bits[mask] = bin(mask).count("1")
    for (mask, c, pos), s in chain_index.items():
        bits[s] = bin(mask).count("1")
    return ConstraintFSM(next_state=nxt, num_bits=n, state_bits=bits)


class CBSResult(NamedTuple):
    tokens: torch.Tensor     # (B, S, K, L)
    logprobs: torch.Tensor   # (B, S, K) total log-prob per beam


@torch.no_grad()
def constrained_beam_search(step_fn: StepFn, init_tokens, cache,
                            fsm: ConstraintFSM, max_len: int,
                            eos_id: int, beams_per_state: int = 2,
                            pad_id: int = 0,
                            forced=None, forced_len=0) -> CBSResult:
    """Per-FSM-state beam search (`ConstrainedBeamSearch.search`).

    The cache's leaves lead with the batch B; they are tiled to B*S*K beam
    slots (each row repeated in place) and re-gathered every step.
    `forced`/`forced_len` teacher-force a (possibly ragged) decoding
    prefix; FSM transitions still fire on forced tokens."""
    init_tokens = _as_tokens(init_tokens, None)
    dev = init_tokens.device
    B = init_tokens.shape[0]
    S = fsm.num_states
    K = beams_per_state
    BSK = B * S * K
    nxt_table = torch.as_tensor(fsm.next_state, device=dev).long()  # (S, V)
    states = torch.arange(S, device=dev)

    tokens = torch.full((BSK, max_len), pad_id, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = init_tokens.repeat_interleave(S * K)
    # only state 0, beam 0 is live at t=0
    live0 = torch.arange(S * K, device=dev) == 0
    scores = torch.where(live0, 0.0, -1e9).float().repeat(B).reshape(B, S, K)
    finished = torch.zeros((B, S, K), dtype=torch.bool, device=dev)
    cache = tree_map(lambda x: x.repeat_interleave(S * K, dim=0), cache)
    if forced is not None:
        forced = _as_tokens(forced, dev)

    for t in range(max_len - 1):
        logits, cache = step_fn(tokens[:, t], cache, t)      # (BSK, V)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1)
        # finished beams may only emit pad, at score 0
        pad_only = torch.full((V,), -1e9, device=dev)
        pad_only[pad_id] = 0.0
        logp = torch.where(finished.reshape(BSK, 1), pad_only[None], logp)
        cand = (scores.reshape(BSK, 1) + logp).reshape(B, S, K, V)
        if forced is not None:
            f_now = _forced_active(forced_len, t, dev)       # (B,)
            only = torch.nn.functional.one_hot(
                _forced_tokens(forced, t), V).bool()
            cand = torch.where(
                f_now[:, None, None, None],
                torch.where(only[:, None, None, :], cand, -1e9), cand)

        # each candidate's next state; finished beams stay in their state
        cand_next = torch.where(finished[..., None],
                                states[None, :, None, None],
                                nxt_table[None, :, None, :])
        flat = cand.reshape(B, S * K * V)
        flat_next = cand_next.expand(B, S, K, V).reshape(B, S * K * V)
        new_scores, src, tok = [], [], []
        for s in range(S):
            top_s, top_i = top_k(torch.where(flat_next == s, flat, -1e9), K)
            new_scores.append(top_s)
            src.append(top_i // V)                   # source beam in S*K
            tok.append(top_i % V)
        new_scores = torch.stack(new_scores, 1)                # (B, S, K)
        src = torch.stack(src, 1)
        tok = torch.stack(tok, 1)

        flat_src = (torch.arange(B, device=dev)[:, None, None] * S * K
                    + src).reshape(-1)
        tokens = tokens[flat_src]
        was_finished = finished.reshape(B * S * K)[flat_src]
        emit = torch.where(was_finished, pad_id, tok.reshape(-1))
        tokens[:, t + 1] = emit
        cache = tree_map(lambda x: x[flat_src], cache)
        finished = (was_finished | (emit == eos_id)).reshape(B, S, K)
        scores = new_scores
    return CBSResult(tokens=tokens.reshape(B, S, K, max_len),
                     logprobs=scores)


def select_best_beam_with_constraints(result: CBSResult,
                                      fsm: ConstraintFSM,
                                      min_constraints: int = 2):
    """Pick, per batch element, the best beam among states satisfying at
    least `min_constraints` (falling back to fewer when none exist), as
    the reference's `select_best_beam_with_constraints` (:366-430).
    Returns numpy (tokens (B, L), scores (B,))."""
    B = result.tokens.shape[0]
    best_tokens = []
    best_scores = []
    scores = result.logprobs.cpu().numpy()
    tokens = result.tokens.cpu().numpy()
    nbits = np.asarray(fsm.state_bits)
    for b in range(B):
        chosen = None
        for need in range(min(min_constraints, fsm.num_bits), -1, -1):
            ok_states = np.where(nbits >= need)[0]
            sub = scores[b, ok_states]               # (|ok|, K)
            if np.isfinite(sub).any() and sub.max() > -1e8:
                si, ki = np.unravel_index(np.argmax(sub), sub.shape)
                chosen = (ok_states[si], ki)
                break
        s, k = chosen if chosen else (0, 0)
        best_tokens.append(tokens[b, s, k])
        best_scores.append(scores[b, s, k])
    return np.stack(best_tokens), np.asarray(best_scores)


# ---------------------------------------------------------------------------
# Constraint-word extraction from detection boxes (input side of the FSM)
# ---------------------------------------------------------------------------

# Open Images classes never used as constraints (`utils/cbs.py:506-517`)
CONSTRAINT_BLACKLIST = frozenset([
    "auto part", "bathroom accessory", "bicycle wheel", "boy", "building",
    "clothing", "door handle", "fashion accessory", "footwear", "girl",
    "hiking equipment", "human arm", "human beard", "human body",
    "human ear", "human eye", "human face", "human foot", "human hair",
    "human hand", "human head", "human leg", "human mouth", "human nose",
    "land vehicle", "mammal", "man", "person", "personal care", "plant",
    "plumbing fixture", "seat belt", "skull", "sports equipment", "tire",
    "tree", "vehicle registration plate", "wheel", "woman",
    "__background__",
])

# multi-word class-name normalizations (`utils/cbs.py:519-526`)
CONSTRAINT_REPLACEMENTS = {
    "band-aid": "bandaid",
    "wood-burning stove": "wood burning stove",
    "kitchen & dining room table": "table",
    "salt and pepper shakers": "salt and pepper",
    "power plugs and sockets": "power plugs",
    "luggage and bags": "luggage",
}


class _HierarchyNode:
    __slots__ = ("label", "children", "height")

    def __init__(self, label, children):
        self.label = label
        self.children = children
        self.height = (1 + max(c.height for c in children)) if children \
            else 0


def _read_hierarchy(node: dict) -> _HierarchyNode:
    children = [_read_hierarchy(c) for c in node.get("Subcategory", [])]
    return _HierarchyNode(str(node.get("LabelName", "")).lower(), children)


class ConstraintFilter:
    """Detection boxes → sensible constraint words for CBS decoding.

    Port of `utils/cbs.py::ConstraintFilter` (:477-630): drop zero-score
    padding boxes and blacklisted classes, hierarchy-aware NMS (for two
    boxes with IoU ≥ `nms_threshold`, the finer-grained class suppresses
    the coarser one — "dog" beats "mammal"; equal granularity keeps both),
    keep the top-`max_given_constraints` by detection score, apply the
    multi-word replacements, drop duplicates.

    `hierarchy` is the Open Images class-hierarchy JSON (already loaded as
    a dict: {"LabelName": ..., "Subcategory": [...]}) — node HEIGHT in this
    tree measures granularity (leaf = finest = 0).

    NOTE: the reference's keep-condition compares heights with `>=`
    (`cbs.py:622-625`), which — given the ascending height ordering — keeps
    every box and disables the suppression its own docstring describes.
    This port implements the documented behavior (suppress strictly
    coarser classes on high IoU, matching the upstream updown-baseline
    code the reference copied from); see PARITY.md.
    """

    def __init__(self, hierarchy: dict, nms_threshold: float = 0.85,
                 max_given_constraints: int = 3):
        self._root = _read_hierarchy(hierarchy)
        self._nms_threshold = nms_threshold
        self._max = max_given_constraints

    def _height(self, class_name: str) -> int:
        """Height of the first hierarchy node whose label occurs in the
        class name (the reference's substring `findall`, :589-594)."""
        stack = [self._root]
        while stack:
            node = stack.pop(0)
            if node.label and node.label in class_name:
                return node.height
            stack.extend(node.children)
        return self._root.height

    def __call__(self, boxes, class_names, scores):
        boxes = np.asarray(boxes, np.float64)
        scores = np.asarray(scores, np.float64)
        keep = [i for i, c in enumerate(class_names)
                if scores[i] > 0 and c not in CONSTRAINT_BLACKLIST]
        boxes, scores = boxes[keep], scores[keep]
        class_names = [class_names[i] for i in keep]

        keep = self._nms(boxes, class_names)
        boxes, scores = boxes[keep], scores[keep]
        class_names = [class_names[i] for i in keep]

        ranked = sorted(zip(class_names, scores),
                        key=lambda t: -t[1])[: self._max]
        out = [CONSTRAINT_REPLACEMENTS.get(c, c) for c, _ in ranked]
        return list(set(out))

    def _nms(self, boxes, class_names):
        if len(class_names) == 0:
            return []
        heights = np.array([self._height(c) for c in class_names])
        order = heights.argsort(kind="stable")
        x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        areas = (x2 - x1 + 1) * (y2 - y1 + 1)
        keep = []
        while order.size > 0:
            cur = order[0]
            keep.append(int(cur))
            xx1 = np.maximum(x1[cur], x1[order[1:]])
            yy1 = np.maximum(y1[cur], y1[order[1:]])
            xx2 = np.minimum(x2[cur], x2[order[1:]])
            yy2 = np.minimum(y2[cur], y2[order[1:]])
            inter = np.maximum(0.0, xx2 - xx1 + 1) \
                * np.maximum(0.0, yy2 - yy1 + 1)
            union = areas[cur] + areas[order[1:]] - inter
            keep_cond = np.logical_or(
                heights[order[1:]] <= heights[cur],
                inter / union <= self._nms_threshold)
            order = order[1:][np.where(keep_cond)[0]]
        return keep
