"""BiLSTM and Viterbi decoding of the PyTorch/CUDA port against the JAX
package, on the CPU, same numpy inputs and weights."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.nn.crf import crf_decode as jax_crf_decode  # noqa: E402
from icka_tpu.nn.lstm import BiLSTM as JaxBiLSTM  # noqa: E402
from icka_tpu_torch.convert import state_dict_from_flax  # noqa: E402
from icka_tpu_torch.nn.crf import CRF, crf_decode  # noqa: E402
from icka_tpu_torch.nn.lstm import BiLSTM  # noqa: E402


@pytest.fixture(scope="module")
def lstm_pair():
    rng = np.random.default_rng(0)
    B, L, D, H = 3, 11, 12, 8
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    jm = JaxBiLSTM(hidden=H)
    v = jm.init(jax.random.PRNGKey(0), x)
    tm = BiLSTM(D, H, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.device_get(v)["params"]),
                       strict=True)
    return jm, v, tm, x, mask


@pytest.mark.parametrize("masked", [False, True])
def test_bilstm_matches_jax(lstm_pair, masked):
    """Unmasked = torch nn.LSTM over the padding; masked = padding holds
    the recurrent state (`ICKAConfig.masked_lstm`). fp32, 1e-5."""
    jm, v, tm, x, mask = lstm_pair
    m = mask if masked else None
    want = np.asarray(jm.apply(v, x, m))
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 None if m is None else torch.from_numpy(m)).numpy()
    assert got.shape == want.shape == (3, 11, 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bilstm_masked_holds_state(lstm_pair):
    """Masked BiLSTM at valid positions equals the unmasked run on the
    exact-length slice (the serving-exactness contract)."""
    _, _, tm, x, mask = lstm_pair
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        padded = tm(xt, mt)
        exact = tm(xt[2:3, :4])
    torch.testing.assert_close(padded[2:3, :4], exact, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_decode_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, L, T = 4, 13, 15
    em = rng.standard_normal((B, L, T)).astype(np.float32)
    lens = np.array([13, 9, 1, 5])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    start, end = (rng.uniform(-0.1, 0.1, T).astype(np.float32)
                  for _ in range(2))
    trans = rng.uniform(-0.1, 0.1, (T, T)).astype(np.float32)
    want = np.asarray(jax_crf_decode(em, mask, start, end, trans))
    got = crf_decode(*(torch.from_numpy(a) for a in
                       (em, mask, start, end, trans)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_crf_decode_ties_take_first_maximum():
    """All-equal scores: every argmax is the first index, as jnp.argmax."""
    em = np.zeros((1, 4, 3), np.float32)
    z = np.zeros(3, np.float32)
    args = (em, np.ones((1, 4), np.int32), z, z, np.zeros((3, 3), np.float32))
    np.testing.assert_array_equal(
        crf_decode(*(torch.from_numpy(a) for a in args)).numpy(),
        np.asarray(jax_crf_decode(*args)))


def test_crf_module_holds_torchcrf_init():
    crf = CRF(7, device="cpu", generator=torch.Generator().manual_seed(0))
    for p in (crf.start_transitions, crf.end_transitions, crf.transitions):
        assert float(p.detach().abs().max()) <= 0.1
    assert tuple(crf.transitions.shape) == (7, 7)


# -- sequence packing: BiLSTM carry resets and the Viterbi lattice cut ------

SEG_LENS = ((7, 5, 4), (9, 1, 8))     # two packed rows of L = 20, some padding


def _packed_marks(L=20):
    """(mask, segment starts, segment ends, [(row, start, length)])."""
    mask, start, end = (np.zeros((len(SEG_LENS), L), np.int32)
                        for _ in range(3))
    spans = []
    for r, lens in enumerate(SEG_LENS):
        a = 0
        for ln in lens:
            mask[r, a:a + ln] = 1
            start[r, a] = 1
            end[r, a + ln - 1] = 1
            spans.append((r, a, ln))
            a += ln
    return mask, start, end, spans


@pytest.fixture(scope="module")
def packed_lstm():
    rng = np.random.default_rng(3)
    D, H = 12, 8
    x = rng.standard_normal((len(SEG_LENS), 20, D)).astype(np.float32)
    jm = JaxBiLSTM(hidden=H)
    v = jm.init(jax.random.PRNGKey(1), x)
    tm = BiLSTM(D, H, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.device_get(v)["params"]),
                       strict=True)
    return jm, v, tm, x


@pytest.mark.parametrize("which", ["both", "fwd", "bwd"])
def test_bilstm_resets_match_jax(packed_lstm, which):
    """mask + reset_fwd / reset_bwd against the flax module. fp32, 1e-5."""
    jm, v, tm, x = packed_lstm
    mask, start, end, _ = _packed_marks()
    rf = start if which in ("both", "fwd") else None
    rb = end if which in ("both", "bwd") else None
    want = np.asarray(jm.apply(v, x, mask, reset_fwd=rf, reset_bwd=rb))
    t = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        got = tm(t(x), t(mask), reset_fwd=t(rf), reset_bwd=t(rb)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bilstm_resets_equal_solo_runs(packed_lstm):
    """Each packed segment runs the recurrence it would run alone."""
    _, _, tm, x = packed_lstm
    mask, start, end, spans = _packed_marks()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        packed = tm(xt, torch.from_numpy(mask),
                    reset_fwd=torch.from_numpy(start),
                    reset_bwd=torch.from_numpy(end))
        for r, a, ln in spans:
            solo = tm(xt[r:r + 1, a:a + ln])
            torch.testing.assert_close(packed[r:r + 1, a:a + ln], solo,
                                       rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def packed_crf():
    rng = np.random.default_rng(1)
    T = 5
    em = rng.standard_normal((len(SEG_LENS), 20, T)).astype(np.float32)
    start, end = (rng.standard_normal(T).astype(np.float32)
                  for _ in range(2))
    trans = rng.standard_normal((T, T)).astype(np.float32)
    return em, start, end, trans


def test_crf_decode_reset_matches_jax(packed_crf):
    em, start, end, trans = packed_crf
    mask, reset, _, _ = _packed_marks()
    reset[:, 0] = 0                      # reset[:, 0] is ignored
    want = np.asarray(jax_crf_decode(em, mask, start, end, trans,
                                     reset=reset))
    got = crf_decode(*(torch.from_numpy(a) for a in
                       (em, mask, start, end, trans)),
                     reset=torch.from_numpy(reset))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_crf_decode_reset_matches_solo_decode(packed_crf):
    """The reset-cut lattice gives each segment its standalone path."""
    em, start, end, trans = packed_crf
    mask, reset, _, spans = _packed_marks()
    t = torch.from_numpy
    crf = CRF(5, device="cpu")
    with torch.no_grad():
        for p, a in ((crf.start_transitions, start),
                     (crf.end_transitions, end), (crf.transitions, trans)):
            p.copy_(t(a))
        packed = crf.decode(t(em), t(mask), reset=t(reset)).numpy()
    for r, a, ln in spans:
        solo = crf_decode(t(em[r:r + 1, a:a + ln]),
                          torch.ones(1, ln, dtype=torch.int32), t(start),
                          t(end), t(trans)).numpy()
        np.testing.assert_array_equal(packed[r, a:a + ln], solo[0])
