"""The CRF's log-depth Viterbi (`crf_decode_parallel`) and posterior
marginals (`crf_marginals`) of the port against the JAX package on the CPU,
on the same numpy inputs: tags identical, marginals within 1e-5. Emissions
are random floats, so no two paths tie and the parallel decode (another
summation order) gives the sequential decode's tags. Lengths: 1, 2, a
power of two and others, with padded rows."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.nn import crf as jcrf  # noqa: E402
from icka_tpu_torch.nn.crf import (CRF, crf_decode,  # noqa: E402
                                   crf_decode_parallel, crf_marginals)

T = 9


def _case(L, seed, B=5):
    """emissions (B, L, T), a mask whose first row is full and the others
    of random lengths, and the three transition tensors, as numpy."""
    rng = np.random.default_rng(seed)
    em = (rng.standard_normal((B, L, T)) * 2).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    start, end = (rng.uniform(-0.5, 0.5, T).astype(np.float32)
                  for _ in range(2))
    trans = rng.uniform(-0.5, 0.5, (T, T)).astype(np.float32)
    return em, mask, start, end, trans


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


LENGTHS = [1, 2, 3, 8, 13, 33]


@pytest.mark.parametrize("L", LENGTHS)
def test_parallel_decode_matches_jax_and_the_sequential_decode(L):
    case = _case(L, seed=L)
    got = crf_decode_parallel(*_t(*case)).numpy()
    assert got.dtype == np.int32 and got.shape == (5, L)
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(jcrf.crf_decode_parallel)(*case)))
    np.testing.assert_array_equal(got, crf_decode(*_t(*case)).numpy())


@pytest.mark.parametrize("L", LENGTHS)
def test_marginals_match_jax(L):
    case = _case(L, seed=100 + L)
    got = crf_marginals(*_t(*case)).numpy()
    want = np.asarray(jax.jit(jcrf.crf_marginals)(*case))
    assert got.shape == want.shape == (5, L, T)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_crf_module_decode_and_marginals():
    """`CRF.decode(parallel=True)` equals the sequential decode; with
    `reset` it takes the sequential path whatever `parallel` says;
    `CRF.marginals` is `crf_marginals` on the module's transitions."""
    em, mask, *_ = _case(21, seed=7)
    crf = CRF(T, device="cpu", generator=torch.Generator().manual_seed(0))
    em, mask = _t(em, mask)
    with torch.no_grad():
        seq = crf.decode(em, mask)
        assert torch.equal(crf.decode(em, mask, parallel=True), seq)
        params = (crf.start_transitions, crf.end_transitions,
                  crf.transitions)
        reset = torch.zeros_like(mask)
        reset[:, 9] = 1
        assert torch.equal(crf.decode(em, mask, parallel=True, reset=reset),
                           crf_decode(em, mask, *params, reset=reset))
        assert torch.equal(crf.marginals(em, mask),
                           crf_marginals(em, mask, *params))
