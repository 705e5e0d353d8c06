"""The gate_cl family of the PyTorch/CUDA port (`GateCLModel` in its ip, cl
and gate_cl variants) against the JAX package on the CPU, at a tiny size
in the BERT dialect (0-based positions, pad id 0, LayerNorm eps 1e-12)
with `use_pallas=True` on both sides (the JAX kernel in interpret mode).

Weights are the JAX model's, carried across by
`icka_tpu_torch.convert.gate_cl_state_dict`. Emissions agree within 1e-4
and Viterbi tags exactly, the train loss within rtol 2e-5: the thresholds
of tests/test_gate_cl_full_graph_parity.py. The batch is ragged, so
`masked_crs` changes the relation gate's input.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.models import gate_cl as jgate_cl  # noqa: E402
from icka_tpu.serving.packing import PackedGateCLServer as JaxPacked  # noqa: E402
from icka_tpu.serving.packing import pack_first_fit  # noqa: E402
from icka_tpu_torch.convert import (gate_cl_state_dict,  # noqa: E402
                                    gate_cl_variables_from_state_dict)
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.models.gate_cl import (GateCLModel,  # noqa: E402
                                           info_nce,
                                           negative_swap_permutation)

B, L, NEG, REGION_DIM, NUM_LABELS = 8, 16, 4, 24, 7
VARIANTS = ("ip", "cl", "gate_cl")


def _cfg(variant, **kw):
    enc = dataclasses.replace(
        jconfig.EncoderConfig.tiny(99), position_offset=0, pad_token_id=0,
        layer_norm_eps=1e-12, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, use_pallas=True)
    return jconfig.GateCLConfig(
        encoder=enc, num_labels=NUM_LABELS, layer_num1=2,
        region_dim=REGION_DIM, max_seq_length=L, variant=variant,
        negative_rate=NEG, **kw)


def _port_cfg(cfg):
    return tconfig.from_json(tconfig.GateCLConfig, jconfig.to_json(cfg))


def _inputs(seed):
    """(B, L) ragged sentences (lengths L down to 5) and their images."""
    rng = np.random.default_rng(seed)
    lens = np.linspace(L, 5, B).astype(np.int64)
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
        "labels": rng.integers(0, NUM_LABELS, (B, L)).astype(np.int32),
    }


ARGS = ("input_ids", "segment_ids", "input_mask", "img_mask", "visual_mean",
        "visual_grid")


def _jax_args(d):
    return [d[k] for k in ARGS]


def _torch_args(d):
    return [torch.from_numpy(d[k]) for k in ARGS]


@pytest.fixture(scope="module")
def models():
    """{variant: (JAX module, its params, the port model on its weights)}.
    `masked_crs` holds no parameter, so one init serves both settings."""
    out = {}
    d = _inputs(0)
    for i, variant in enumerate(VARIANTS):
        cfg = _cfg(variant)
        jm = jgate_cl.GateCLModel(cfg)
        params = jax.device_get(jm.init(jax.random.PRNGKey(i),
                                        *_jax_args(d), labels=d["labels"]))
        tm = GateCLModel(_port_cfg(cfg), device="cpu").eval()
        tm.load_state_dict(gate_cl_state_dict(params), strict=True)
        out[variant] = (jm, params, tm)
    return out


def _with(jm, tm, **kw):
    """Both models on another config of the same parameters."""
    cfg = dataclasses.replace(jm.cfg, **kw)
    port = GateCLModel(_port_cfg(cfg), device="cpu").eval()
    port.load_state_dict(tm.state_dict(), strict=True)
    return jgate_cl.GateCLModel(cfg), port


def test_config_round_trip():
    for cfg in (jconfig.GateCLConfig(), jconfig.GateCLConfig.tiny(),
                *(jconfig.GateCLConfig.tiny(variant=v) for v in VARIANTS),
                _cfg("cl", masked_crs=True)):
        port = _port_cfg(cfg)
        assert isinstance(port.encoder, tconfig.EncoderConfig)
        assert tconfig.to_json(port) == jconfig.to_json(cfg)
    for cfg in (tconfig.GateCLConfig(), tconfig.GateCLConfig.tiny(),
                tconfig.DataConfig()):
        jcls = getattr(jconfig, type(cfg).__name__)
        assert jconfig.to_json(jconfig.from_json(
            jcls, tconfig.to_json(cfg))) == tconfig.to_json(cfg)


@pytest.mark.parametrize("rate", [0, 1, 2, 3, 4, 5, 16])
def test_negative_swap_permutation_equals_jax(rate):
    for batch in range(0, 40):
        np.testing.assert_array_equal(
            negative_swap_permutation(batch, rate),
            jgate_cl.negative_swap_permutation(batch, rate))


def test_info_nce_equals_jax():
    rng = np.random.default_rng(5)
    for b, h in ((1, 4), (8, 32), (32, 16)):
        t = rng.standard_normal((b, h)).astype(np.float32)
        v = rng.standard_normal((b, h)).astype(np.float32)
        want = float(jgate_cl.info_nce(jnp.asarray(t), jnp.asarray(v),
                                       0.179, 0.7))
        got = float(info_nce(torch.from_numpy(t), torch.from_numpy(v),
                             0.179, 0.7))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (b, got, want)


@pytest.mark.parametrize("masked_crs", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_emissions_and_tags_match_jax(models, variant, masked_crs):
    jm, params, tm = models[variant]
    if masked_crs:
        jm, tm = _with(jm, tm, masked_crs=True)
    d = _inputs(11)
    want = np.asarray(jm.apply(params, *_jax_args(d), return_emissions=True))
    want_tags = np.asarray(jm.apply(params, *_jax_args(d)))
    with torch.no_grad():
        got = tm(*_torch_args(d), return_emissions=True)
        got_tags = tm(*_torch_args(d))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_tags.numpy(), want_tags)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_loss_matches_jax(models, variant):
    """B=8 > negative rate 4: the swap and the relation loss engage."""
    jm, params, tm = models[variant]
    d = _inputs(12)
    want = float(jm.apply(params, *_jax_args(d), labels=d["labels"],
                          deterministic=True))
    with torch.no_grad():
        got = float(tm(*_torch_args(d), labels=torch.from_numpy(d["labels"])))
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_weights_round_trip_through_the_bridge(models):
    _, params, tm = models["gate_cl"]
    back = gate_cl_variables_from_state_dict(tm.state_dict())["params"]
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def _packed_examples(seed, n=7):
    rng = np.random.default_rng(seed)
    exs = []
    for i in range(n):
        ln = int(rng.integers(3, L + 3))          # some exceed the row
        ex = {"input_ids": rng.integers(2, 99, ln).astype(np.int32),
              "visual_grid": rng.standard_normal((7, 7, REGION_DIM))
              .astype(np.float32)}
        if i % 2:
            ex["img_mask"] = (rng.random(49) > 0.3).astype(np.int32)
        exs.append(ex)
    return exs


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_packed_tags_match_jax(models, variant):
    """One packed batch built by the JAX server's host code (rows of three
    slots, padding rows and a sentinel slot), through both models'
    `forward_packed`."""
    jm, params, tm = models[variant]
    exs = _packed_examples(13)
    srv = JaxPacked(jm, params, row_len=L, max_slots=3, max_batch=4)
    lengths = [min(len(ex["input_ids"]), L) for ex in exs]
    rows = pack_first_fit(lengths, L, 3)
    b, _, _ = srv.build_batch(exs, lengths, rows[:4], L, 3)
    keys = ("ids", "pos", "types", "slot", "valid", "seg_start", "img_mask",
            "visual_grid", "seg_gather")
    want = np.asarray(jm.apply(params, *(b[k] for k in keys),
                               method=jm.forward_packed))
    tb = {k: torch.from_numpy(b[k]) for k in keys}
    tb = {k: v if v.is_floating_point() else v.long() for k, v in tb.items()}
    with torch.no_grad():
        got = tm.forward_packed(tb)
    np.testing.assert_array_equal(got.numpy(), want)
