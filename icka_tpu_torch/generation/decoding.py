"""Autoregressive decoding engine: greedy, sampling and beam search (port
of `icka_tpu.generation.decoding`).

The reference's caption-generation engine (`modeling/modeling_utils.py`:
`generate` :44, `_generate_no_beam_search` :263-589,
`_generate_beam_search` :590-1045, `top_k_top_p_filtering` :1046,
`BeamHypotheses` :1081) with the JAX package's fixed shapes: every
strategy runs `max_len - 1` steps over a preallocated token buffer
(finished sequences keep emitting `pad_id`), top-k/top-p filtering is a
sort-based mask, and beam search keeps (B, num_beams) alive scores beside
(B, num_beams) finished-hypothesis slots, with the length penalty
`score / len**alpha`. The JAX package's `lax.scan` bodies are plain Python
loops over `t` here, on the device of the inputs.

The model plugs in as `step_fn(tokens_t, cache, t) -> (logits, cache)`:
`t` is a Python int and `cache` any nest of dicts, lists and tuples of
tensors whose leaves all lead with the batch (beam search tiles and
re-gathers them along it, `tree_map`). Token tensors are int64.

Top-k selections go through `top_k`, which breaks ties as `jax.lax.top_k`
does (the lower index first): dead beams' -1e9 scores, the constrained
search's per-state masks and the finished slots' -inf tie by the
thousand, and the rows they carry are part of the result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

StepFn = Callable[[torch.Tensor, Any, int], tuple[torch.Tensor, Any]]


class DecodeState(NamedTuple):
    tokens: torch.Tensor     # (B, L) emitted tokens (pad-filled)
    finished: torch.Tensor   # (B,) bool
    cache: Any
    generator: Optional[torch.Generator]
    scores: torch.Tensor     # (B,) cumulative log-prob of emitted tokens


def tree_map(fn, tree):
    """`fn` on every tensor of a nest of dicts, lists and tuples (None
    stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def top_k(x, k: int):
    """(values, indices) of the k largest entries along the last dim, in
    descending order, the lower index first among equal values: the order
    of `jax.lax.top_k` (`torch.topk` promises none among ties)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def apply_repetition_penalty(logits, tokens, penalty: float):
    """HF semantics: for already-emitted tokens, divide logits > 0 by the
    penalty and multiply logits < 0 by it."""
    if penalty == 1.0:
        return logits
    seen = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    seen.scatter_(1, tokens.long(), True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def top_k_top_p_filter(logits, top_k: int = 0, top_p: float = 1.0,
                       min_tokens_to_keep: int = 1,
                       filter_value: float = -1e9):
    """Static-shape `top_k_top_p_filtering` (:1046-1080): logits outside
    the top k, then outside the nucleus of mass `top_p`, become
    `filter_value`."""
    V = logits.shape[-1]
    if top_k > 0:
        k = max(min(top_k, V), min_tokens_to_keep)
        kth = torch.sort(logits, dim=-1).values[..., V - k, None]
        logits = torch.where(logits < kth, filter_value, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative mass exceeds top_p (always the
        # first min_tokens_to_keep); the threshold is the smallest kept
        cutoff = cum - probs > top_p
        cutoff[..., :min_tokens_to_keep] = False
        kept = torch.where(cutoff, torch.inf, sorted_logits)
        threshold = kept.min(dim=-1, keepdim=True).values
        logits = torch.where(logits < threshold, filter_value, logits)
    return logits


def _forced_active(forced_len, t: int, device):
    """(B,)- or (1,)-shaped bool: whether position t+1 is still inside the
    forced prefix. `forced_len` is an int or a (B,) array (ragged
    prefixes)."""
    return torch.atleast_1d(torch.as_tensor(forced_len, device=device)
                            > t + 1)


def _forced_tokens(forced, t: int):
    return forced[:, min(t + 1, forced.shape[1] - 1)]


def _as_tokens(x, device):
    return torch.as_tensor(x, device=device).long()


@torch.no_grad()
def _decode_loop(step_fn: StepFn, init_tokens, cache, max_len: int,
                 eos_id: int, pad_id: int, generator, select_fn: Callable,
                 forced=None, forced_len=0) -> DecodeState:
    """The shared loop: `select_fn(logits, emitted) -> (token, logprob)`.

    `forced` (B, >= max forced_len) and `forced_len` (int or (B,))
    teacher-force a decoding prefix: while t+1 < forced_len the emitted
    token is forced[:, t+1] whatever the model chose (the cache still
    fills from the model pass), ragged per-row prefixes included."""
    init_tokens = _as_tokens(init_tokens, None)
    dev = init_tokens.device
    B = init_tokens.shape[0]
    tokens = torch.full((B, max_len), pad_id, dtype=torch.long, device=dev)
    tokens[:, 0] = init_tokens
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    scores = torch.zeros(B, dtype=torch.float32, device=dev)
    if forced is not None:
        forced = _as_tokens(forced, dev)
    for t in range(max_len - 1):
        logits, cache = step_fn(tokens[:, t], cache, t)
        nxt, logp = select_fn(logits, tokens)
        if forced is not None:
            f_now = _forced_active(forced_len, t, dev)
            ftok = _forced_tokens(forced, t)
            logp_all = torch.log_softmax(logits.float(), dim=-1)
            logp_f = logp_all.gather(1, ftok[:, None])[:, 0]
            nxt = torch.where(f_now, ftok, nxt)
            logp = torch.where(f_now, logp_f, logp)
        nxt = torch.where(finished, pad_id, nxt)
        logp = torch.where(finished, 0.0, logp)
        tokens[:, t + 1] = nxt
        finished = finished | (nxt == eos_id)
        if forced is not None:
            finished = finished & ~_forced_active(forced_len, t, dev)
        scores = scores + logp
    return DecodeState(tokens, finished, cache, generator, scores)


def greedy_decode(step_fn: StepFn, init_tokens, cache, max_len: int,
                  eos_id: int, pad_id: int = 0,
                  repetition_penalty: float = 1.0,
                  forced=None, forced_len=0) -> DecodeState:
    def select(logits, emitted):
        logits = apply_repetition_penalty(logits, emitted,
                                          repetition_penalty)
        logp = torch.log_softmax(logits, dim=-1)
        tok = logits.argmax(dim=-1)
        return tok, logp.gather(1, tok[:, None])[:, 0]

    return _decode_loop(step_fn, init_tokens, cache, max_len, eos_id,
                        pad_id, None, select, forced=forced,
                        forced_len=forced_len)


def sample_decode(step_fn: StepFn, init_tokens, cache, max_len: int,
                  eos_id: int, generator: torch.Generator, pad_id: int = 0,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, repetition_penalty: float = 1.0,
                  forced=None, forced_len=0) -> DecodeState:
    """Ancestral sampling from the filtered distribution, one draw a row
    and step from `generator` (a `torch.Generator` on the logits' device;
    the JAX package takes a key). The same generator state gives the same
    tokens; JAX's threefry stream is not reproduced."""
    def select(logits, emitted):
        logits = apply_repetition_penalty(logits, emitted,
                                          repetition_penalty)
        if temperature != 1.0:
            logits = logits / temperature
        filtered = top_k_top_p_filter(logits, top_k, top_p)
        tok = torch.multinomial(torch.softmax(filtered.float(), dim=-1), 1,
                                generator=generator)[:, 0]
        logp = torch.log_softmax(logits, dim=-1)
        return tok, logp.gather(1, tok[:, None])[:, 0]

    return _decode_loop(step_fn, init_tokens, cache, max_len, eos_id,
                        pad_id, generator, select, forced=forced,
                        forced_len=forced_len)


@dataclass
class BeamResult:
    tokens: torch.Tensor         # (B, num_beams, L) best-first
    scores: torch.Tensor         # (B, num_beams) length-penalized


def _length_norm(length: int, alpha: float, device):
    """length**alpha in float32, as a tensor on the device: the card
    divides by a tensor exactly, by a Python float through its
    reciprocal."""
    return torch.full((), float(np.float32(length) ** np.float32(alpha)),
                      device=device)


def _rows(index, n: int):
    """Per-batch beam indices (B, m) -> flat row indices (B*m,) of a
    (B*n, ...) tensor."""
    B = index.shape[0]
    base = torch.arange(B, device=index.device)[:, None] * n
    return (base + index).reshape(-1)


def _gather_rows(x, index):
    """x (B, m, L) rows picked by index (B, k) along dim 1."""
    return x.gather(1, index[:, :, None].expand(-1, -1, x.shape[2]))


@torch.no_grad()
def beam_search(step_fn: StepFn, init_tokens, cache, max_len: int,
                eos_id: int, num_beams: int, pad_id: int = 0,
                length_penalty: float = 1.0,
                early_stopping: bool = False,
                forced=None, forced_len=0,
                bonus_mask=None, bonus_factor: float = 1.0,
                repetition_penalty: float = 1.0) -> BeamResult:
    """Fixed-shape beam search (reference `_generate_beam_search` +
    `BeamHypotheses`). The cache's leaves lead with the batch B; they are
    tiled to B*num_beams (each row repeated num_beams times in place) and
    re-gathered every step.

    `forced`/`forced_len` teacher-force a (possibly ragged) decoding
    prefix through every beam. `bonus_mask` (B, V) and `bonus_factor`
    implement the reference's `BeamSearchScorer_constrained`
    (`modeling_vcr_chunkalign_v10.py:1948-1950`): a candidate emitting a
    constraint token has its running score multiplied by the factor
    (log-probs are negative, so a factor < 1 favours constraint words).
    `early_stopping` is accepted and unused, as in the JAX package."""
    init_tokens = _as_tokens(init_tokens, None)
    dev = init_tokens.device
    B = init_tokens.shape[0]
    K = num_beams
    BK = B * K

    cache = tree_map(lambda x: x.repeat_interleave(K, dim=0), cache)
    tokens = torch.full((BK, max_len), pad_id, dtype=torch.long, device=dev)
    tokens[:, 0] = init_tokens.repeat_interleave(K)
    # only beam 0 alive at first, so the beams do not repeat each other
    beam_scores = torch.where(torch.arange(K, device=dev) == 0, 0.0,
                              -1e9).expand(B, K).float()
    fin_tokens = torch.full((B, K, max_len), pad_id, dtype=torch.long,
                            device=dev)
    fin_scores = torch.full((B, K), -torch.inf, device=dev)
    if forced is not None:
        forced = _as_tokens(forced, dev)
    if bonus_mask is not None:
        bonus_mask = torch.as_tensor(bonus_mask, device=dev).bool()

    for t in range(max_len - 1):
        logits, cache = step_fn(tokens[:, t], cache, t)      # (BK, V)
        V = logits.shape[-1]
        if repetition_penalty != 1.0:
            logits = apply_repetition_penalty(logits, tokens,
                                              repetition_penalty)
        logp = torch.log_softmax(logits.float(), dim=-1)
        cand = beam_scores.reshape(BK, 1) + logp              # (BK, V)
        if bonus_mask is not None and bonus_factor != 1.0:
            cand = cand.reshape(B, K, V)
            cand = torch.where(bonus_mask[:, None, :], cand * bonus_factor,
                               cand).reshape(BK, V)
        if forced is not None:
            f_now = _forced_active(forced_len, t, dev)        # (B,)
            only = torch.nn.functional.one_hot(
                _forced_tokens(forced, t), V).bool()           # (B, V)
            cand = cand.reshape(B, K, V)
            cand = torch.where(
                f_now[:, None, None],
                torch.where(only[:, None, :], cand, -1e9), cand)
            cand = cand.reshape(BK, V)
        cand = cand.reshape(B, K * V)
        # the 2K best guarantee K continuations that are not eos
        top_scores, top_idx = top_k(cand, 2 * K)              # (B, 2K)
        src_beam = top_idx // V
        tok = top_idx % V
        is_eos = tok == eos_id

        # eos candidates enter the K finished slots; a hypothesis is t + 2
        # tokens long after this step (score / len**alpha)
        lp = _length_norm(t + 2, length_penalty, dev)
        fin_cand_scores = torch.where(is_eos, top_scores / lp, -torch.inf)
        cand_tokens = tokens[_rows(src_beam, K)].reshape(B, 2 * K, max_len)
        cand_tokens[:, :, t + 1] = torch.where(is_eos, eos_id, tok)
        all_scores = torch.cat([fin_scores, fin_cand_scores], dim=1)
        all_tokens = torch.cat([fin_tokens, cand_tokens], dim=1)
        fin_scores, keep_idx = top_k(all_scores, K)
        fin_tokens = _gather_rows(all_tokens, keep_idx)

        # alive beams: the K best candidates that are not eos
        alive_scores = torch.where(is_eos, -torch.inf, top_scores)
        new_scores, alive_idx = top_k(alive_scores, K)        # (B, K)
        new_tok = tok.gather(1, alive_idx)
        flat_new_src = _rows(src_beam.gather(1, alive_idx), K)
        tokens = tokens[flat_new_src]
        tokens[:, t + 1] = new_tok.reshape(-1)
        cache = tree_map(lambda x: x[flat_new_src], cache)
        beam_scores = new_scores

    # still-alive beams are flushed as hypotheses of length max_len
    alive_final = beam_scores / _length_norm(max_len, length_penalty, dev)
    all_scores = torch.cat([fin_scores, alive_final], dim=1)
    all_tokens = torch.cat([fin_tokens, tokens.reshape(B, K, max_len)],
                           dim=1)
    best_scores, best_idx = top_k(all_scores, K)
    return BeamResult(tokens=_gather_rows(all_tokens, best_idx),
                      scores=best_scores)
