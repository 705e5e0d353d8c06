"""The fused-QKV serving layout in the PyTorch/CUDA port
(`EncoderConfig.fuse_qkv`, `models.convert.fuse_qkv_params`) on the CPU:
the port's side of tests/test_quant_static.py's `test_fused_qkv_fp32_exact`,
`test_fused_qkv_int8_static_serving_stack` and
`test_bf16_softmax_close_to_fp32`, and the port against the JAX package:
the fused float state_dict, the fused calibration and the fused
int8-static state (`kernel_q`, `kernel_scale`, `act_scale`) bit-equal to
JAX's `static_quantize_params_like(fuse_qkv_params(...))` from JAX's
calibration (`calib_from_flax`), the fused fp32 encoder within 1e-5 of
JAX's, the fused int8-static one within 1e-4. With `use_pallas=True` the
port's CPU path reads q, k and v as strided views of the (B, S, 3H)
projection, as the kernel does on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.models import convert as jconvert  # noqa: E402
from icka_tpu.nn.bert import TextEncoder as JaxTextEncoder  # noqa: E402
from icka_tpu_torch.convert import (calib_from_flax,  # noqa: E402
                                    state_dict_from_flax)
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.models import convert as tconvert  # noqa: E402
from icka_tpu_torch.nn import attention as tattn  # noqa: E402
from icka_tpu_torch.nn.bert import TextEncoder  # noqa: E402

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=192, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
CFG = tconfig.EncoderConfig(**TINY)


def _cos_min(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-9)
    return cos.min()


def _ids(seed, B=4, S=12):
    rng = np.random.default_rng(seed)
    return rng.integers(2, CFG.vocab_size, (B, S)).astype(np.int32)


def _encoder(cfg=CFG, sd=None, **kw):
    m = TextEncoder(dataclasses.replace(cfg, **kw), with_pooler=False,
                    device="cpu", generator=torch.Generator().manual_seed(3))
    if sd is not None:
        m.load_state_dict(sd, strict=True)
    return m.eval()


def _run(m, ids):
    with torch.no_grad():
        seq, _ = m(torch.from_numpy(ids).long(), torch.ones(ids.shape))
    return seq.numpy()


def _calibrated(float_model, ids, **kw):
    """The port's dynamic int8 model on `float_model`'s weights, run over
    `ids`, and its calibration record."""
    dyn = _encoder(quant="int8", **kw)
    dyn.load_state_dict(tconvert.quantize_params_like(
        dyn.state_dict().keys(), float_model.state_dict()), strict=True)
    _run(dyn, ids)
    return tconvert.calibration_amax(dyn)


def _fused_static(float_model, calib, **kw):
    stat = _encoder(quant="int8_static", fuse_qkv=True, **kw)
    keys = stat.state_dict().keys()
    fused_sd = tconvert.fuse_qkv_params(keys, float_model.state_dict())
    fused_calib = tconvert.fuse_qkv_params(keys, calib)
    sd = tconvert.static_quantize_params_like(keys, fused_sd, fused_calib)
    stat.load_state_dict(sd, strict=True)
    return stat, sd


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_qkv_fp32_exact(use_pallas):
    """fuse_qkv=True is a re-layout: the unfused weights through
    `fuse_qkv_params` give the unfused outputs within 1e-5."""
    ids = _ids(0)
    fp = _encoder(use_pallas=use_pallas)
    want = _run(fp, ids)
    fused = _encoder(fuse_qkv=True, use_pallas=use_pallas)
    sd = tconvert.fuse_qkv_params(fused.state_dict().keys(), fp.state_dict())
    fused.load_state_dict(sd, strict=True)
    assert tuple(fused.encoder.layer_0.attn.qkv.weight.shape) == (96, 32)
    assert not hasattr(fused.encoder.layer_0.attn, "query")
    np.testing.assert_allclose(_run(fused, ids), want, atol=1e-5)


def test_fused_qkv_int8_static_serving_stack():
    """fp32 -> calibrate (dynamic int8, unfused) -> fuse (params and
    calibration) -> static quantise: close to fp32, and one projection a
    layer (4 act scales: qkv, attention output, FFN wi and wo)."""
    ids = _ids(1)
    fp = _encoder()
    want = _run(fp, ids)
    calib = _calibrated(fp, ids)
    stat, sd = _fused_static(fp, calib)
    got = _run(stat, ids)
    assert _cos_min(want, got) > 0.99, _cos_min(want, got)
    scales = [k for k in sd if k.endswith("act_scale")]
    assert len(scales) == CFG.num_hidden_layers * 4
    assert sd["encoder.layer_0.attn.qkv.kernel_q"].shape == (32, 96)
    amax = [calib[f"encoder.layer_1.attn.{n}"]
            for n in ("query", "key", "value")]
    assert float(sd["encoder.layer_1.attn.qkv.act_scale"]) == \
        np.float32(max(max(amax), 1e-8) / 127.0)


def test_bf16_softmax_close_to_fp32():
    ids = _ids(2)
    fp = _encoder()
    soft = _encoder(sd=fp.state_dict(), softmax_dtype="bfloat16")
    want, got = _run(fp, ids), _run(soft, ids)
    assert _cos_min(want, got) > 0.999, _cos_min(want, got)
    assert not np.array_equal(want, got)      # the knob reaches the core


@pytest.fixture(scope="module")
def jax_stack():
    """The JAX package's serving conversion of test_quant_static.py:
    fp32 params, the dynamic model's calibration, the fused fp32 and
    calibration trees, the fused int8-static params, and outputs."""
    ids = _ids(3)
    mask = np.ones_like(ids)
    jcfg = jconfig.EncoderConfig(**TINY)
    fp = JaxTextEncoder(jcfg, with_pooler=False)
    params = jax.device_get(fp.init(jax.random.PRNGKey(3), ids, mask))
    dyn = JaxTextEncoder(dataclasses.replace(jcfg, quant="int8"),
                         with_pooler=False)
    dyn_init = dyn.init(jax.random.PRNGKey(3), ids, mask)
    dyn_params = jconvert.quantize_params_like(dyn_init["params"],
                                               params["params"])
    _, st = dyn.apply({"params": dyn_params}, ids, mask, mutable=["calib"])
    calib = jax.device_get(st["calib"])
    fused_fp = JaxTextEncoder(dataclasses.replace(jcfg, fuse_qkv=True),
                              with_pooler=False)
    stat = JaxTextEncoder(dataclasses.replace(jcfg, quant="int8_static",
                                              fuse_qkv=True),
                          with_pooler=False)
    st_init = jax.device_get(stat.init(jax.random.PRNGKey(3), ids, mask))
    fused_params = jconvert.fuse_qkv_params(st_init["params"],
                                            params["params"])
    fused_calib = jconvert.fuse_qkv_params(st_init["params"], calib)
    st_params = jconvert.static_quantize_params_like(
        st_init["params"], fused_params, fused_calib)
    want_fp, _ = fused_fp.apply({"params": fused_params}, ids, mask)
    want_st, _ = stat.apply({"params": st_params}, ids, mask)
    return dict(ids=ids, params=params["params"], calib=calib,
                fused_params=fused_params, fused_calib=fused_calib,
                st_params=st_params, want_fp=np.asarray(want_fp),
                want_st=np.asarray(want_st))


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def test_fused_static_state_equals_jax(jax_stack):
    """From JAX's fp32 params and calibration, the port's fused float
    state_dict, fused calibration and fused int8-static state equal JAX's,
    leaf for leaf and bit for bit."""
    j = jax_stack
    sd = state_dict_from_flax(j["params"])
    fused = _encoder(fuse_qkv=True)
    fused_sd = tconvert.fuse_qkv_params(fused.state_dict().keys(), sd)
    _assert_state_equal(fused_sd, state_dict_from_flax(j["fused_params"]))
    stat = _encoder(quant="int8_static", fuse_qkv=True)
    keys = stat.state_dict().keys()
    fused_calib = tconvert.fuse_qkv_params(keys, calib_from_flax(j["calib"]))
    assert fused_calib == calib_from_flax(j["fused_calib"])
    got = tconvert.static_quantize_params_like(
        keys, tconvert.fuse_qkv_params(keys, sd), fused_calib)
    _assert_state_equal(got, state_dict_from_flax(j["st_params"]))
    stat.load_state_dict(got, strict=True)
    np.testing.assert_allclose(_run(stat, j["ids"]), j["want_st"],
                               atol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_fp32_matches_jax(jax_stack, use_pallas):
    j = jax_stack
    port = _encoder(sd=state_dict_from_flax(j["fused_params"]),
                    fuse_qkv=True, use_pallas=use_pallas)
    np.testing.assert_allclose(_run(port, j["ids"]), j["want_fp"],
                               atol=1e-5)


def test_cross_attention_stays_unfused():
    """`fuse_qkv` fuses self-attention only: a cross-attention layer keeps
    query, key and value, and a fused projection refuses a kv stream."""
    cfg = dataclasses.replace(CFG, fuse_qkv=True)
    cross = tattn.CrossAttentionLayer(cfg, device="cpu")
    assert {"query", "key", "value"} <= set(dict(
        cross.attn.named_children()))
    attn = tattn.SelfAttentionLayer(cfg, device="cpu").attn
    with pytest.raises(ValueError, match="self-attention"):
        attn(torch.zeros(1, 3, 32), kv=torch.zeros(1, 4, 32))
