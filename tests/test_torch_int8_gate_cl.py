"""The gate_cl family in int8 in the PyTorch/CUDA port on the CPU: the
port's side of tests/test_quant_static.py's
`test_int8_gate_cl_close_to_fp32`, then the port against the JAX package
at "int8" and "int8_static", unfused and fused (`fuse_qkv`, the serving
layout of bench.py's gate_cl configuration), and the two gate_cl servers
over the fused int8-static model.

Given JAX's weights and JAX's calibration (`calib_from_flax`), every
quantised leaf is bit-equal to JAX's; the port's own calibration record is
within rtol 1e-6 of JAX's; emissions agree within 1e-4 and Viterbi tags
exactly. The batch is ragged and `masked_crs=True`. The port's encoder
runs `use_pallas=True` (on the CPU the kernel's plain version, which reads
the fused projection's q, k and v as strided views); the JAX side runs its
einsum core.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.models import convert as jconvert  # noqa: E402
from icka_tpu.models import gate_cl as jgate_cl  # noqa: E402
from icka_tpu_torch.convert import (calib_from_flax,  # noqa: E402
                                    gate_cl_state_dict)
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.models import convert as tconvert  # noqa: E402
from icka_tpu_torch.models.gate_cl import GateCLModel  # noqa: E402
from icka_tpu_torch.serving.bucketed import BucketedGateCLServer  # noqa: E402
from icka_tpu_torch.serving.packing import PackedGateCLServer  # noqa: E402

B, L, REGION_DIM, NUM_LABELS = 6, 16, 24, 7
ARGS = ("input_ids", "segment_ids", "input_mask", "img_mask", "visual_mean",
        "visual_grid")
MODES = (("int8", False), ("int8_static", False), ("int8_static", True))


def _cfg(quant="none", fuse_qkv=False, use_pallas=False):
    enc = dataclasses.replace(
        jconfig.EncoderConfig.tiny(99), position_offset=0, pad_token_id=0,
        layer_norm_eps=1e-12, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, quant=quant, fuse_qkv=fuse_qkv,
        use_pallas=use_pallas)
    return jconfig.GateCLConfig(
        encoder=enc, num_labels=NUM_LABELS, layer_num1=1,
        region_dim=REGION_DIM, max_seq_length=L, variant="gate_cl",
        negative_rate=2, masked_crs=True)


def _port(quant="none", fuse_qkv=False, sd=None):
    cfg = tconfig.from_json(tconfig.GateCLConfig, jconfig.to_json(
        _cfg(quant, fuse_qkv, use_pallas=True)))
    m = GateCLModel(cfg, device="cpu", seed=0).eval()
    if sd is not None:
        m.load_state_dict(sd, strict=True)
    return m


def _inputs(seed):
    rng = np.random.default_rng(seed)
    lens = np.linspace(L, 4, B).astype(np.int64)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    img_mask = (rng.random((B, 49)) > 0.2).astype(np.int32)
    img_mask[:, 0] = 1
    return {
        "input_ids": np.where(mask > 0, rng.integers(2, 99, (B, L)),
                              0).astype(np.int32),
        "segment_ids": np.zeros((B, L), np.int32),
        "input_mask": mask,
        "img_mask": img_mask,
        "visual_mean": rng.standard_normal((B, REGION_DIM))
        .astype(np.float32),
        "visual_grid": rng.standard_normal((B, 7, 7, REGION_DIM))
        .astype(np.float32),
    }


def _run(m, d, **kw):
    with torch.no_grad():
        return m(*[torch.from_numpy(d[k]) for k in ARGS], **kw).numpy()


def _cos_min(a, b, mask):
    a, b = a.astype(np.float64), b.astype(np.float64)
    cos = (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-9)
    return cos[mask > 0].min()


def _port_static(fp_sd, calib, fuse_qkv):
    m = _port("int8_static", fuse_qkv)
    keys = m.state_dict().keys()
    if fuse_qkv:
        fp_sd = tconvert.fuse_qkv_params(keys, fp_sd)
        calib = tconvert.fuse_qkv_params(keys, calib)
    m.load_state_dict(tconvert.static_quantize_params_like(keys, fp_sd,
                                                           calib),
                      strict=True)
    return m


def test_int8_gate_cl_close_to_fp32():
    """The port on its own: the dynamic and the calibrated static int8
    models, unfused and fused, track the fp32 emissions at cosine > 0.995
    per token, and the tags agree > 0.9."""
    d = _inputs(0)
    fp = _port()
    fp_sd = fp.state_dict()
    want = _run(fp, d, return_emissions=True)
    dyn = _port("int8")
    dyn.load_state_dict(tconvert.quantize_params_like(
        dyn.state_dict().keys(), fp_sd), strict=True)
    got = _run(dyn, d, return_emissions=True)
    assert _cos_min(want, got, d["input_mask"]) > 0.995
    calib = tconvert.calibration_amax(dyn)
    assert len(calib) == 18           # 6 projections x (2 + 1) layers
    tags_fp = _run(fp, d)
    valid = d["input_mask"] > 0
    for fuse in (False, True):
        st = _port_static(fp_sd, calib, fuse)
        got = _run(st, d, return_emissions=True)
        assert _cos_min(want, got, d["input_mask"]) > 0.995, fuse
        assert (_run(st, d)[valid] == tags_fp[valid]).mean() > 0.9


@pytest.fixture(scope="module")
def jax_models():
    """JAX's fp32 weights, its dynamic model's calibration on `_inputs(1)`,
    and for each mode of MODES its params, emissions and tags."""
    d = _inputs(1)
    args = [d[k] for k in ARGS]
    fp = jgate_cl.GateCLModel(_cfg())
    params = jax.device_get(fp.init(jax.random.PRNGKey(0), *args))
    out = {"inputs": d, "fp": params}
    for quant, fuse in MODES:
        m = jgate_cl.GateCLModel(_cfg(quant, fuse))
        init = jax.device_get(m.init(jax.random.PRNGKey(0), *args))["params"]
        if quant == "int8":
            p = {"params": jconvert.quantize_params_like(init,
                                                         params["params"])}
            em, st = m.apply(p, *args, return_emissions=True,
                             mutable=["calib"])
            out["calib"] = jax.device_get(st["calib"])
        else:
            fp_tree, calib = params["params"], out["calib"]
            if fuse:
                fp_tree = jconvert.fuse_qkv_params(init, fp_tree)
                calib = jconvert.fuse_qkv_params(init, calib)
            p = {"params": jconvert.static_quantize_params_like(
                init, fp_tree, calib)}
            em = m.apply(p, *args, return_emissions=True)
        out[(quant, fuse)] = dict(params=p, emissions=np.asarray(em),
                                  tags=np.asarray(m.apply(p, *args)))
    return out


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("quant,fuse", MODES)
def test_quantised_gate_cl_matches_jax(jax_models, quant, fuse):
    """From JAX's weights and calibration the port's quantised state is
    JAX's bit for bit; emissions within 1e-4, tags identical."""
    j = jax_models
    fp_sd = gate_cl_state_dict(j["fp"])
    if quant == "int8":
        m = _port("int8")
        sd = tconvert.quantize_params_like(m.state_dict().keys(), fp_sd)
        m.load_state_dict(sd, strict=True)
    else:
        m = _port_static(fp_sd, calib_from_flax(j["calib"]), fuse)
        sd = m.state_dict()
    want = j[(quant, fuse)]
    _assert_state_equal(sd, gate_cl_state_dict(want["params"]))
    # 2 BERT layers of 6 projections (4 fused) and the txt2img cross
    # layer's 6, which stays unfused
    n_int8 = sum(v.dtype == torch.int8 for v in sd.values())
    assert n_int8 == (2 * 4 + 6 if fuse else 3 * 6)
    em = _run(m, j["inputs"], return_emissions=True)
    np.testing.assert_allclose(em, want["emissions"], atol=1e-4)
    np.testing.assert_array_equal(_run(m, j["inputs"]), want["tags"])


def test_calibration_record_matches_jax(jax_models):
    """`calibration_amax` of the port's dynamic gate_cl against the JAX
    package's "calib" collection: the same 18 module paths (the BERT
    self-attention and the txt2img cross layer), each within 1e-6
    relative."""
    j = jax_models
    m = _port("int8")
    m.load_state_dict(tconvert.quantize_params_like(
        m.state_dict().keys(), gate_cl_state_dict(j["fp"])), strict=True)
    _run(m, j["inputs"], return_emissions=True)
    got, want = tconvert.calibration_amax(m), calib_from_flax(j["calib"])
    assert sorted(got) == sorted(want) and len(want) == 18
    assert "txt2img.layer_0.attn.query" in want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def _examples(n, rng):
    exs = []
    for i in range(n):
        n_tok = int(rng.integers(3, L + 4))
        ex = {"input_ids": rng.integers(2, 99, n_tok).astype(np.int32),
              "visual_mean": rng.standard_normal(REGION_DIM)
              .astype(np.float32),
              "visual_grid": rng.standard_normal((7, 7, REGION_DIM))
              .astype(np.float32)}
        if i % 3 == 1:
            ex["img_mask"] = (rng.random(49) > 0.3).astype(np.int32)
        exs.append(ex)
    return exs


def test_servers_over_the_fused_int8_static_model(jax_models):
    """`BucketedGateCLServer` and `PackedGateCLServer` over the fused
    int8-static gate_cl (`masked_crs=True`): every request tagged, and the
    packed tags equal the bucketed ones."""
    j = jax_models
    m = _port_static(gate_cl_state_dict(j["fp"]),
                     calib_from_flax(j["calib"]), True)
    exs = _examples(11, np.random.default_rng(5))
    tags, stats = BucketedGateCLServer(m, buckets=(8, L), max_batch=4,
                                       device="cpu").predict(exs)
    packed, pstats = PackedGateCLServer(m, row_len=L, max_slots=3,
                                        max_batch=4,
                                        device="cpu").predict(exs)
    assert stats.total_pairs == pstats.pairs == len(exs)
    for ex, t, p in zip(exs, tags, packed):
        assert len(t) == min(len(ex["input_ids"]), L)
        np.testing.assert_array_equal(p, t)
