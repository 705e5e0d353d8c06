"""The CRF log-likelihood of the PyTorch/CUDA port and the flagship's dev
and train modes against the JAX package: the gold-path score, log Z and
the log-likelihood in all four reductions within 1e-5 on ragged masks;
the tiny `ICKAModel`'s dev-mode tags identical and each row's NLL within
1e-5. A value above 10 is held to 1e-6 of itself instead (RTOL): at 220,
one fp32 step is 1.5e-5, and XLA's exp and log round differently from
torch's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.models.icka import ICKAModel as JaxICKAModel  # noqa: E402
from icka_tpu.nn import crf as jcrf  # noqa: E402
from icka_tpu_torch.convert import icka_state_dict  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.nn import crf as tcrf  # noqa: E402
from tests.test_torch_icka import (MASKS, OFFSET, _batch, _cfg,  # noqa: E402
                                   _port_cfg)

TOL, RTOL = 1e-5, 1e-6
REDUCTIONS = ("none", "sum", "mean", "token_mean")


def _crf_inputs(seed, B=5, L=11, T=15):
    rng = np.random.default_rng(seed)
    em = (3 * rng.standard_normal((B, L, T))).astype(np.float32)
    tags = rng.integers(0, T, (B, L)).astype(np.int32)
    lens = np.array([L, 1, 4, L - 1, 7])[:B]
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    start, end = (rng.uniform(-1, 1, T).astype(np.float32) for _ in "se")
    trans = rng.uniform(-1, 1, (T, T)).astype(np.float32)
    return em, tags, mask, start, end, trans


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("seed", [0, 1])
def test_numerator_and_log_partition(seed):
    em, tags, mask, start, end, trans = _crf_inputs(seed)
    got = tcrf.crf_numerator(*_t(em, tags, mask, start, end, trans))
    want = jcrf.crf_numerator(em, tags, mask, start, end, trans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=RTOL)
    got = tcrf.crf_log_partition(*_t(em, mask, start, end, trans))
    want = jcrf.crf_log_partition(em, mask, start, end, trans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=RTOL)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_log_likelihood_reductions(reduction):
    em, tags, mask, start, end, trans = _crf_inputs(2)
    want = np.asarray(jcrf.crf_log_likelihood(em, tags, mask, start, end,
                                              trans, reduction))
    args = _t(em, tags, mask, start, end, trans)
    got = tcrf.crf_log_likelihood(*args, reduction=reduction)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=RTOL)
    # bf16 emissions are widened to fp32 first, as in the JAX package
    em16 = args[0].bfloat16()
    got16 = tcrf.crf_log_likelihood(em16, *args[1:], reduction=reduction)
    want16 = jcrf.crf_log_likelihood(
        jax.numpy.asarray(em, jax.numpy.bfloat16), tags, mask, start, end,
        trans, reduction)
    np.testing.assert_allclose(got16.numpy(), np.asarray(want16), atol=TOL,
                               rtol=RTOL)


def test_crf_module_forward_and_bad_reduction():
    em, tags, mask, start, end, trans = _crf_inputs(3)
    m = tcrf.CRF(15, device="cpu")
    with torch.no_grad():
        for p, v in zip((m.start_transitions, m.end_transitions,
                         m.transitions), (start, end, trans)):
            p.copy_(torch.from_numpy(v))
    got = m(*_t(em, tags, mask))
    want = jcrf.crf_log_likelihood(em, tags, mask, start, end, trans)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=RTOL)
    with pytest.raises(ValueError):
        m(*_t(em, tags, mask), reduction="max")


@pytest.fixture(scope="module")
def flagship():
    cfg = _cfg()
    rng = np.random.default_rng(7)
    batch = _batch(cfg, rng)
    labels = rng.integers(0, cfg.num_labels,
                          batch["ori_input_ids"].shape).astype(np.int32)
    jm = JaxICKAModel(cfg)
    params = jax.jit(lambda k: jm.init(k, batch, MASKS, OFFSET, mode="test"))(
        jax.random.PRNGKey(7))
    tm = ICKAModel(_port_cfg(cfg), device="cpu").eval()
    tm.load_state_dict(icka_state_dict(jax.device_get(params)), strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def outputs(p):       # one program for every JAX output compared
        out = {r: jm.apply(p, batch, MASKS, OFFSET, mode="dev",
                           labels=labels, loss_reduction=r)
               for r in ("none", "token_mean")}
        out["train"] = jm.apply(p, batch, MASKS, OFFSET, mode="train",
                                labels=labels, deterministic=True)
        return out
    return tm, tbatch, labels, jax.device_get(jax.jit(outputs)(params))


@pytest.mark.parametrize("reduction", ["none", "token_mean"])
def test_dev_mode_tags_and_loss(flagship, reduction):
    tm, tbatch, labels, want = flagship
    jpred, jloss = want[reduction]
    with torch.no_grad():
        pred, loss = tm(tbatch, MASKS, OFFSET, mode="dev",
                        labels=torch.from_numpy(labels),
                        loss_reduction=reduction)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    assert tuple(loss.shape) == np.asarray(jloss).shape
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=TOL,
                               rtol=RTOL)
    if reduction == "none":
        assert loss.shape == (len(labels),) and bool((loss > 0).all())
        with torch.no_grad():
            test_tags = tm(tbatch, MASKS, OFFSET, mode="test")
        np.testing.assert_array_equal(test_tags.numpy(), pred.numpy())


def test_train_mode_is_the_deterministic_token_mean_loss(flagship):
    tm, tbatch, labels, want = flagship
    with torch.no_grad():
        got = tm(tbatch, MASKS, OFFSET, mode="train",
                 labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want["train"], atol=TOL,
                               rtol=RTOL)
    with pytest.raises(NotImplementedError):
        tm(tbatch, MASKS, OFFSET, mode="train",
           labels=torch.from_numpy(labels), deterministic=False)
