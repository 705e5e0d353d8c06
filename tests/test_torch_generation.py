"""The decoding engine and constrained beam search of the PyTorch/CUDA port
against the JAX package on the CPU, on Markov "language models" (logits
from the current token, or from the last two with the previous one in a
nested cache that beam search must re-gather): greedy, beam (forced and ragged
prefixes, `bonus_mask`, `length_penalty`, repetition penalty) and
constrained beam tokens equal to JAX's, scores within 1e-5; the filters
and the penalty within 1e-5; the top-k helper's tie order against
`jax.lax.top_k`; sampling held to greedy at top_k=1, to the filter, to
its generator's seed and to JAX's own scores of the sampled tokens; the
FSM tables and `ConstraintFilter` equal to JAX's. (That the new modules
import no JAX is `tests/test_torch_convert.py::test_no_jax_in_the_port`.)"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.generation import constrained as jcons  # noqa: E402
from icka_tpu.generation import decoding as jdec  # noqa: E402
from icka_tpu_torch.generation import constrained as cons  # noqa: E402
from icka_tpu_torch.generation import decoding as dec  # noqa: E402

V, EOS, PAD = 7, 6, 0


def jax_step(table):
    """A Markov step on a (V, V) table; on a (V, V, V) table a
    second-order one, whose previous token rides in the cache (a nest of a
    dict, a list and a tuple), so a cache re-gathered wrongly changes the
    tokens."""
    table = jnp.asarray(table)

    def step(tok, cache, t):
        if table.ndim == 2:
            return table[tok], cache
        return (table[cache["prev"][0], tok],
                {"prev": [tok], "n": (cache["n"][0] + 1,)})

    return step


def port_step(table):
    table = torch.from_numpy(np.asarray(table))

    def step(tok, cache, t):
        if table.ndim == 2:
            return table[tok], cache
        assert (cache["n"][0] == t).all()
        return (table[cache["prev"][0], tok],
                {"prev": [tok.clone()], "n": (cache["n"][0] + 1,)})

    return step


def caches(init):
    return ({"prev": [jnp.asarray(init)],
             "n": (jnp.zeros(len(init), jnp.int32),)},
            {"prev": [torch.from_numpy(init).long()],
             "n": (torch.zeros(len(init), dtype=torch.long),)})


def _table3(seed):
    return np.random.default_rng(seed).standard_normal(
        (V, V, V)).astype(np.float32)


def _table(seed, eos_logit=None, scale=1.0):
    t = np.random.default_rng(seed).standard_normal((V, V)) * scale
    if eos_logit is not None:
        t[:, EOS] = eos_logit
    return t.astype(np.float32)


def _np(x):
    return np.asarray(x)


def test_top_k_breaks_ties_as_jax():
    """Integer values from a small range, -1e9 + small offsets (which
    round to the same float32), -inf and a row of one value: values and
    indices equal to `jax.lax.top_k`'s."""
    rng = np.random.default_rng(0)
    rows = [rng.integers(-3, 3, 40).astype(np.float32),
            (np.float32(-1e9) + rng.standard_normal(40).astype(np.float32)),
            np.where(rng.random(40) < 0.5, -np.inf,
                     rng.integers(0, 2, 40)).astype(np.float32),
            np.full(40, 2.5, np.float32)]
    x = np.stack(rows)
    for k in (1, 5, 17, 40):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = dec.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_v.numpy(), _np(want_v))
        np.testing.assert_array_equal(got_i.numpy(), _np(want_i))


def test_tree_map_keeps_the_nest():
    tree = {"a": [torch.ones(2), (torch.zeros(3), None)], "b": torch.ones(1)}
    out = dec.tree_map(lambda x: x + 1, tree)
    assert isinstance(out["a"], list) and isinstance(out["a"][1], tuple)
    assert out["a"][1][1] is None and out["b"].item() == 2.0


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7),
                                         (4, 0.5), (50, 0.9), (1, 1.0)])
def test_filter_equals_jax(top_k, top_p):
    logits = np.random.default_rng(top_k).standard_normal(
        (5, 60)).astype(np.float32) * 3
    want = jdec.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p)
    got = dec.top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_filters_keep_what_the_reference_keeps():
    out = dec.top_k_top_p_filter(torch.tensor([[1.0, 3.0, 2.0, -1.0]]),
                                 top_k=2).numpy()
    assert out[0, 1] == 3.0 and out[0, 2] == 2.0
    assert out[0, 0] < -1e8 and out[0, 3] < -1e8
    probs = torch.tensor([[0.5, 0.3, 0.15, 0.05]])
    out = dec.top_k_top_p_filter(probs.log(), top_p=0.7).numpy()
    assert out[0, 0] > -1e8 and out[0, 1] > -1e8
    assert out[0, 2] < -1e8 and out[0, 3] < -1e8


def test_repetition_penalty_equals_jax():
    out = dec.apply_repetition_penalty(torch.tensor([[2.0, -2.0, 1.0]]),
                                       torch.tensor([[0, 1]]), 2.0)
    np.testing.assert_allclose(out.numpy()[0], [1.0, -4.0, 1.0])
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 20)).astype(np.float32)
    toks = rng.integers(0, 20, (3, 6)).astype(np.int32)
    for penalty in (1.0, 1.3, 0.8):
        want = jdec.apply_repetition_penalty(jnp.asarray(logits),
                                             jnp.asarray(toks), penalty)
        got = dec.apply_repetition_penalty(torch.from_numpy(logits),
                                           torch.from_numpy(toks), penalty)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


GREEDY_CASES = {
    "plain": dict(),
    "penalty": dict(repetition_penalty=1.5),
    "forced": dict(forced=np.array([[1, 4, 5, 2, 0, 0], [2, 5, 3, 3, 1, 0]]),
                   forced_len=4),
    "ragged": dict(forced=np.array([[1, 4, 5, 2, 0, 0], [2, 5, 3, 3, 1, 0]]),
                   forced_len=np.array([3, 5])),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_equals_jax(case):
    kw = GREEDY_CASES[case]
    table = _table3(3)
    init = np.array([1, 2], np.int32)
    jcache, cache = caches(init)
    want = jdec.greedy_decode(jax_step(table), jnp.asarray(init), jcache,
                              max_len=6, eos_id=EOS, pad_id=PAD, **kw)
    got = dec.greedy_decode(port_step(table), torch.from_numpy(init), cache,
                            max_len=6, eos_id=EOS, pad_id=PAD, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), _np(want.tokens))
    np.testing.assert_array_equal(got.finished.numpy(), _np(want.finished))
    np.testing.assert_allclose(got.scores.numpy(), _np(want.scores),
                               atol=1e-5)
    if "forced" in kw:
        n = np.broadcast_to(kw["forced_len"], (2,))
        for b in range(2):
            np.testing.assert_array_equal(got.tokens.numpy()[b, :n[b]],
                                          kw["forced"][b, :n[b]])


def test_greedy_follows_the_argmax_chain_and_stops_at_eos():
    table = _table(0)
    toks = dec.greedy_decode(port_step(table), torch.tensor([1, 2]), None,
                             max_len=5, eos_id=EOS, pad_id=PAD).tokens
    for b, cur in enumerate((1, 2)):
        for t in range(1, 5):
            if cur == EOS:
                assert toks[b, t] == PAD
                continue
            cur = int(np.argmax(table[cur]))
            assert toks[b, t] == cur
    table = np.full((V, V), -5.0, np.float32)
    table[:, EOS] = 5.0
    out = dec.greedy_decode(port_step(table), torch.tensor([1]), None,
                            max_len=6, eos_id=EOS, pad_id=PAD)
    assert out.tokens[0, 1] == EOS and (out.tokens[0, 2:] == PAD).all()
    assert bool(out.finished[0])


def test_sampling_top1_is_greedy_and_seeded():
    table = _table(2)
    init = torch.tensor([1, 3])
    greedy = dec.greedy_decode(port_step(table), init, None, max_len=8,
                               eos_id=EOS)
    gen = torch.Generator().manual_seed(0)
    out = dec.sample_decode(port_step(table), init, None, max_len=8,
                            eos_id=EOS, generator=gen, top_k=1)
    np.testing.assert_array_equal(out.tokens.numpy(), greedy.tokens.numpy())
    np.testing.assert_allclose(out.scores.numpy(), greedy.scores.numpy(),
                               atol=1e-6)
    runs = [dec.sample_decode(port_step(table), init, None, max_len=12,
                              eos_id=EOS, top_k=4, top_p=0.9,
                              generator=torch.Generator().manual_seed(s))
            .tokens for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("top_k,top_p,temperature", [(3, 1.0, 1.0),
                                                     (0, 0.8, 1.0),
                                                     (4, 0.9, 1.0),
                                                     (0, 1.0, 0.7)])
def test_sampled_tokens_lie_in_the_filter_and_rescore_in_jax(
        top_k, top_p, temperature):
    """Every sampled token survives the filter of its step; JAX's loop,
    forced to the port's tokens over the whole length, gives the port's
    scores (no eos: its logit is far below the rest)."""
    table = _table(4, eos_logit=-60.0, scale=2.0)
    init = np.array([1, 2, 3, 4], np.int32)
    L = 10
    out = dec.sample_decode(port_step(table), torch.from_numpy(init), None,
                            max_len=L, eos_id=EOS, top_k=top_k,
                            top_p=top_p, temperature=temperature,
                            generator=torch.Generator().manual_seed(9))
    toks = out.tokens.numpy()
    for t in range(L - 1):
        logits = torch.from_numpy(table[toks[:, t]]) / temperature
        kept = dec.top_k_top_p_filter(logits, top_k, top_p).numpy() > -1e8
        assert kept[np.arange(len(init)), toks[:, t + 1]].all()
    if temperature == 1.0:
        want = jdec.greedy_decode(jax_step(table), jnp.asarray(init), None,
                                  max_len=L, eos_id=EOS,
                                  forced=jnp.asarray(toks), forced_len=L)
        np.testing.assert_array_equal(_np(want.tokens), toks)
        np.testing.assert_allclose(out.scores.numpy(), _np(want.scores),
                                   atol=1e-5)


BEAM_CASES = {
    "plain": dict(num_beams=3),
    "wide": dict(num_beams=V),
    "length_penalty": dict(num_beams=3, length_penalty=0.6),
    "penalty": dict(num_beams=2, repetition_penalty=1.4),
    "forced": dict(num_beams=3, forced=np.array(
        [[1, 4, 4, 0, 0, 0], [2, 5, 3, 1, 0, 0], [3, 3, 3, 3, 0, 0]]),
        forced_len=3),
    "ragged": dict(num_beams=3, forced=np.array(
        [[1, 4, 4, 0, 0, 0], [2, 5, 3, 1, 0, 0], [3, 3, 3, 3, 0, 0]]),
        forced_len=np.array([2, 4, 1])),
    "bonus": dict(num_beams=3, bonus_mask=np.eye(V, dtype=bool)[[4, 5, 1]],
                  bonus_factor=0.5),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_beam_search_equals_jax(case, seed):
    kw = BEAM_CASES[case]
    table = _table3(seed)
    init = np.array([1, 2, 3], np.int32)
    jcache, cache = caches(init)
    want = jdec.beam_search(jax_step(table), jnp.asarray(init), jcache,
                            max_len=6, eos_id=EOS, pad_id=PAD, **kw)
    got = dec.beam_search(port_step(table), torch.from_numpy(init), cache,
                          max_len=6, eos_id=EOS, pad_id=PAD, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), _np(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), _np(want.scores),
                               atol=1e-5)
    assert got.tokens.shape == (3, kw["num_beams"], 6)
    assert (np.diff(got.scores.numpy(), axis=1) <= 1e-6).all()


def test_beam_search_finds_the_best_path():
    """num_beams=V exhaustive beam finds the best length-normalised path
    among all length-L paths (brute force over the tiny vocabulary)."""
    table = _table(5)
    logp = torch.log_softmax(torch.from_numpy(table), -1).numpy()
    L, start = 4, 2
    res = dec.beam_search(port_step(table), torch.tensor([start]), None,
                          max_len=L, eos_id=EOS, num_beams=V)
    best = -np.inf
    for path in itertools.product(range(V), repeat=L - 1):
        score, cur, length, hit = 0.0, start, 0, False
        for tok in path:
            score += logp[cur, tok]
            cur = tok
            length += 1
            if tok == EOS:
                hit = True
                break
        best = max(best, score / ((length + 1) if hit else L))
    np.testing.assert_allclose(float(res.scores[0, 0]), best, rtol=1e-5)


CONSTRAINTS = [[[3], [5]], [[2, 4]], [[2, 4], [5]], [[1, 2, 3], [4, 1]]]


@pytest.mark.parametrize("constraints", CONSTRAINTS,
                         ids=[str(c) for c in CONSTRAINTS])
def test_fsm_tables_equal_jax(constraints):
    got = cons.fsm_from_constraints(constraints, 8)
    want = jcons.fsm_from_constraints(constraints, 8)
    assert got.num_bits == want.num_bits
    for a, b in ((got.next_state, want.next_state),
                 (got.state_bits, want.state_bits)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_fsm_reference_semantics():
    fsm = cons.fsm_from_constraints([[3], [5]], 8)
    nxt = fsm.next_state
    assert fsm.num_states == 4 and nxt[0, 3] == 1 and nxt[0, 5] == 2
    assert nxt[1, 5] == 3 and nxt[3, 3] == 3
    assert fsm.state_bits.tolist() == [0, 1, 1, 2]
    fsm = cons.fsm_from_constraints([[2, 4]], 8)
    chain = fsm.next_state[0, 2]
    assert fsm.num_states == 3 and chain == 2
    assert fsm.next_state[chain, 4] == 1 and fsm.next_state[chain, 3] == 0


CBS_V, CBS_EOS = 8, 7


def _cbs_table(seed):
    t = np.random.default_rng(seed).standard_normal((CBS_V,) * 3)
    return t.astype(np.float32)


CBS_CASES = {
    "one": dict(constraints=[[3]], table=lambda: _cbs_table(1)),
    "two": dict(constraints=[[3], [5]], table=lambda: _cbs_table(2)),
    "chain": dict(constraints=[[2, 4], [5]], table=lambda: _cbs_table(3)),
    "forced": dict(constraints=[[3]], table=lambda: _cbs_table(4),
                   forced=np.array([[1, 5, 5, 0], [2, 3, 0, 0]]),
                   forced_len=np.array([3, 2])),
}


@pytest.mark.parametrize("case", list(CBS_CASES))
def test_constrained_beam_search_equals_jax(case):
    kw = dict(CBS_CASES[case])
    fsm_kw = kw.pop("constraints")
    table = kw.pop("table")()
    init = np.array([1, 2], np.int32)
    jfsm = jcons.fsm_from_constraints(fsm_kw, CBS_V)
    fsm = cons.fsm_from_constraints(fsm_kw, CBS_V)
    jcache, cache = caches(init)
    want = jcons.constrained_beam_search(
        jax_step(table), jnp.asarray(init), jcache, jfsm, max_len=6,
        eos_id=CBS_EOS, beams_per_state=2, **kw)
    got = cons.constrained_beam_search(
        port_step(table), torch.from_numpy(init), cache, fsm, max_len=6,
        eos_id=CBS_EOS, beams_per_state=2, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), _np(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), _np(want.logprobs),
                               atol=1e-5)
    for need in (0, 1, 2):
        g_toks, g_scores = cons.select_best_beam_with_constraints(got, fsm,
                                                                  need)
        w_toks, w_scores = jcons.select_best_beam_with_constraints(
            want, jfsm, need)
        np.testing.assert_array_equal(g_toks, w_toks)
        np.testing.assert_allclose(g_scores, w_scores, atol=1e-5)


def test_cbs_prefers_constrained_words():
    table = np.full((CBS_V, CBS_V), -4.0, np.float32)
    table[:, 1] = 4.0
    table[:, 3] = 1.0
    fsm = cons.fsm_from_constraints([[3]], CBS_V)
    res = cons.constrained_beam_search(port_step(table), torch.tensor([2]),
                                       None, fsm, max_len=5,
                                       eos_id=CBS_EOS, beams_per_state=2)
    toks, _ = cons.select_best_beam_with_constraints(res, fsm,
                                                     min_constraints=1)
    assert 3 in toks[0].tolist()
    assert 3 not in res.tokens[0, 0, 0].tolist()


def test_constraint_filter_equals_jax():
    hierarchy = {
        "LabelName": "entity",
        "Subcategory": [
            {"LabelName": "animal",
             "Subcategory": [{"LabelName": "dog"}, {"LabelName": "cat"}]},
            {"LabelName": "furniture",
             "Subcategory": [
                 {"LabelName": "kitchen & dining room table"}]},
        ],
    }
    f = cons.ConstraintFilter(hierarchy, nms_threshold=0.85,
                              max_given_constraints=3)
    jf = jcons.ConstraintFilter(hierarchy, nms_threshold=0.85,
                                max_given_constraints=3)
    cases = [
        (np.array([[0, 0, 10, 10], [0, 0, 10, 10], [50, 50, 60, 60],
                   [0, 0, 5, 5], [20, 20, 30, 30]], np.float32),
         ["dog", "animal", "kitchen & dining room table", "person", "cat"],
         np.array([0.9, 0.8, 0.7, 0.99, 0.0]), ["dog", "table"]),
        (np.array([[0, 0, 10, 10], [100, 100, 120, 120]], np.float32),
         ["dog", "animal"], np.array([0.9, 0.8]), ["animal", "dog"]),
        (np.array([[0, 0, 1, 1], [10, 10, 12, 12], [20, 20, 22, 22],
                   [30, 30, 32, 32]], np.float32),
         ["dog", "cat", "furniture", "animal"],
         np.array([0.9, 0.8, 0.7, 0.6]), ["cat", "dog", "furniture"]),
        (np.zeros((0, 4), np.float32), [], np.zeros(0), []),
    ]
    for boxes, names, scores, want in cases:
        got = f(boxes, names, scores)
        assert sorted(got) == sorted(jf(boxes, names, scores)) == want
    assert cons.CONSTRAINT_BLACKLIST == jcons.CONSTRAINT_BLACKLIST
    assert cons.CONSTRAINT_REPLACEMENTS == jcons.CONSTRAINT_REPLACEMENTS
