"""Layers, attention and the encoders of the PyTorch/CUDA port against the
JAX package, on the CPU at `EncoderConfig.tiny()` size.

Each JAX module is initialised once (module-scoped fixtures), its weights
are carried across by `icka_tpu_torch.convert`, and both sides run the
same numpy inputs at fp32. Components agree within 1e-5 (fp32 summation
order only). With `use_pallas=True` the JAX side runs its Pallas attention
kernel in interpret mode and the port its kernel's plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core.config import EncoderConfig  # noqa: E402
from icka_tpu.nn import attention as jattn  # noqa: E402
from icka_tpu.nn import bert as jbert  # noqa: E402
from icka_tpu.nn import layers as jlayers  # noqa: E402
from icka_tpu_torch.convert import state_dict_from_flax  # noqa: E402
from icka_tpu_torch.core.config import EncoderConfig as TEncoderConfig  # noqa: E402
from icka_tpu_torch.nn import attention as tattn  # noqa: E402
from icka_tpu_torch.nn import bert as tbert  # noqa: E402
from icka_tpu_torch.nn import layers as tlayers  # noqa: E402

ATOL = 1e-5
CPU = "cpu"


def _port(module, variables):
    module.load_state_dict(
        state_dict_from_flax(jax.device_get(variables)["params"]),
        strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _cfgs(use_pallas):
    j = dataclasses.replace(EncoderConfig.tiny(), use_pallas=use_pallas)
    t = dataclasses.replace(TEncoderConfig.tiny(), use_pallas=use_pallas)
    return j, t


def test_additive_mask():
    m = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    _close(tlayers.additive_mask(_t(m)), jlayers.additive_mask(m), atol=0)
    assert tuple(tlayers.additive_mask(_t(m)).shape) == (2, 1, 1, 3)


def test_gelu_is_erf_gelu():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(tlayers.gelu(_t(x)), jlayers.gelu(x), atol=1e-6)
    assert set(tlayers.ACT2FN) == set(jlayers.ACT2FN)


def test_layer_norm():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 32)) * 4 + 2).astype(np.float32)
    jm = jlayers.LayerNorm(eps=1e-5)
    v = jm.init(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(
        lambda a: a + rng.standard_normal(a.shape).astype(np.float32), v)
    tm = _port(tlayers.LayerNorm(32, eps=1e-5, device=CPU), v)
    _close(tm(_t(x)), jm.apply(v, x))


def test_dense():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 7, 24)).astype(np.float32)
    jm = jlayers.Dense(40)
    v = jm.init(jax.random.PRNGKey(1), x)
    v = jax.tree_util.tree_map(
        lambda a: a + rng.standard_normal(a.shape).astype(np.float32), v)
    tm = _port(tlayers.Dense(24, 40, device=CPU), v)
    _close(tm(_t(x)), jm.apply(v, x), atol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention(use_pallas, cross):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 7, 32)).astype(np.float32) if cross else None
    sk = 7 if cross else 11
    keep = np.ones((2, sk), np.int32)
    keep[1, -3:] = 0
    bias = np.asarray(jlayers.additive_mask(keep))
    jm = jattn.MultiHeadAttention(num_heads=4, use_pallas=use_pallas)
    v = jm.init(jax.random.PRNGKey(2), x, kv, bias)
    tm = _port(tattn.MultiHeadAttention(32, 4, use_pallas=use_pallas,
                                        device=CPU), v)
    got = tm(_t(x), None if kv is None else _t(kv), _t(bias))
    _close(got, jm.apply(v, x, kv, bias))


@pytest.fixture(scope="module")
def text_encoder():
    jc, tc = _cfgs(use_pallas=True)
    rng = np.random.default_rng(3)
    ids = rng.integers(2, jc.vocab_size, (2, 13)).astype(np.int32)
    mask = np.ones((2, 13), np.int32)
    mask[1, 9:] = 0
    ids[1, 9:] = jc.pad_token_id
    types = np.zeros((2, 13), np.int32)
    jm = jbert.TextEncoder(jc)
    v = jm.init(jax.random.PRNGKey(3), ids, mask, types)
    seq, pooled = jm.apply(v, ids, mask, types)
    tm = _port(tbert.TextEncoder(tc, device=CPU), v)
    return tm, (ids, mask, types), (seq, pooled)


def test_text_encoder(text_encoder):
    tm, (ids, mask, types), (seq, pooled) = text_encoder
    with torch.no_grad():
        tseq, tpooled = tm(_t(ids), _t(mask), _t(types))
    _close(tseq, seq)
    _close(tpooled, pooled)


def test_roberta_position_ids(text_encoder):
    ids = text_encoder[1][0]
    for fn_t, fn_j, arg in (
            (tbert.roberta_position_ids, jbert.roberta_position_ids, ids),
            (tbert.mask_position_ids, jbert.mask_position_ids,
             text_encoder[1][1])):
        np.testing.assert_array_equal(fn_t(_t(arg), 1).numpy(),
                                      np.asarray(fn_j(arg, 1)))


def test_cross_encoder():
    jc, tc = _cfgs(use_pallas=True)     # cross-attention ignores it
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 49, 32)).astype(np.float32)
    keep = np.ones((2, 49), np.int32)
    keep[0, 40:] = 0
    bias = np.asarray(jlayers.additive_mask(keep))
    jm = jattn.CrossEncoder(jc, num_layers=2)
    v = jm.init(jax.random.PRNGKey(4), x, kv, bias)
    tm = _port(tattn.CrossEncoder(tc, num_layers=2, device=CPU), v)
    with torch.no_grad():
        got = tm(_t(x), _t(kv), _t(bias))
    _close(got, jm.apply(v, x, kv, bias))


def test_prompt_splice_encoder():
    jc, tc = _cfgs(use_pallas=True)
    rng = np.random.default_rng(5)
    B, L, P = 2, 20, 3
    ids = rng.integers(2, jc.vocab_size, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 15:] = 0
    types = np.concatenate([np.zeros((B, 12), np.int32),
                            np.ones((B, L - 12), np.int32)], 1)
    prompt = rng.standard_normal((B, 2 * P, 32)).astype(np.float32)
    pmask = np.ones((B, 2 * P), np.int32)
    jm = jbert.PromptSpliceEncoder(jc)
    v = jm.init(jax.random.PRNGKey(5), ids, mask, types, prompt, pmask,
                (3, 9))
    out, smask = jm.apply(v, ids, mask, types, prompt, pmask, (3, 9))
    tm = _port(tbert.PromptSpliceEncoder(tc, device=CPU), v)
    with torch.no_grad():
        tout, tsmask = tm(_t(ids), _t(mask), _t(types), _t(prompt),
                          _t(pmask), (3, 9))
    assert tuple(tout.shape) == (B, L - 2 + 2 * P, 32)
    _close(tout, out)
    np.testing.assert_array_equal(tsmask.numpy(), np.asarray(smask))


def test_unported_options_raise():
    tc = dataclasses.replace(TEncoderConfig.tiny(), adapter_size=8)
    with pytest.raises(NotImplementedError):
        tattn.SelfAttentionLayer(tc, device=CPU)
    with pytest.raises(ValueError):
        tattn.SelfAttentionLayer(
            dataclasses.replace(TEncoderConfig.tiny(), quant="int4"),
            device=CPU)
