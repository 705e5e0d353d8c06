"""The composed slice: `ICKAModel` and `BucketedICKAServer` of the
PyTorch/CUDA port against the JAX package on the CPU, at
`ICKAConfig.tiny()` size with `use_pallas=True` on both encoders.

Weights are the JAX model's, carried across by `icka_tpu_torch.convert`.
Emissions agree within 1e-4 and Viterbi tags exactly: the thresholds of
tests/test_full_graph_parity.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core.config import ICKAConfig  # noqa: E402
from icka_tpu.models.icka import ICKAModel as JaxICKAModel  # noqa: E402
from icka_tpu.serving.bucketed import BucketedICKAServer as JaxServer  # noqa: E402
from icka_tpu_torch.convert import icka_state_dict  # noqa: E402
from icka_tpu_torch.core.config import ICKAConfig as TICKAConfig  # noqa: E402
from icka_tpu_torch.core.config import from_json, to_json  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.serving.bucketed import BucketedICKAServer  # noqa: E402

OFFSET, MASKS = 14, (3, 11)
ABLATED = dict(use_txt2img=False, use_alignment=False,
               use_vision_prompt=False, use_alignment_prompt=False,
               use_gate=False)


def _cfg(**kw):
    cfg = ICKAConfig.tiny()
    enc = dataclasses.replace(cfg.embedding, use_pallas=True)
    return dataclasses.replace(cfg, embedding=enc, last_encoder=enc, **kw)


def _port_cfg(cfg):
    return from_json(TICKAConfig, to_json(cfg))


def _batch(cfg, rng, B=3, L=32):
    """Ragged sentences padded to L, prompted layout of OFFSET + L."""
    vocab, pad = cfg.embedding.vocab_size, cfg.embedding.pad_token_id
    lens = np.array([L, L - 9, 6])[:B]
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    pmask = np.concatenate([np.ones((B, OFFSET), np.int32), mask], 1)
    return {
        "input_ids": np.where(pmask > 0, rng.integers(2, vocab, pmask.shape),
                              pad).astype(np.int32),
        "segment_ids": np.concatenate([np.zeros((B, OFFSET), np.int32),
                                       np.ones((B, L), np.int32)], 1),
        "input_mask": pmask,
        "ori_input_ids": np.where(mask > 0, rng.integers(2, vocab, (B, L)),
                                  pad).astype(np.int32),
        "ori_input_mask": mask,
        "ori_segment_ids": np.zeros((B, L), np.int32),
        "img_mask": np.ones((B, cfg.num_regions), np.int32),
        "clip_features": rng.standard_normal((B, 1, cfg.clip_dim))
        .astype(np.float32),
        "visual_mean": rng.standard_normal((B, cfg.region_dim))
        .astype(np.float32),
        "visual_grid": rng.standard_normal((B, 7, 7, cfg.region_dim))
        .astype(np.float32),
        "output_mask": mask,
    }


def _pair(cfg, seed):
    """(JAX model, its params, the port model with the same weights)."""
    rng = np.random.default_rng(seed)
    jm = JaxICKAModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed), _batch(cfg, rng), MASKS,
                     OFFSET, mode="test")
    tm = ICKAModel(_port_cfg(cfg), device="cpu").eval()
    tm.load_state_dict(icka_state_dict(jax.device_get(params)), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def flagship():
    return _pair(_cfg(), seed=0)


def _compare(jm, params, tm, batch):
    keys = {k: v for k, v in batch.items() if k != "output_mask"}
    want, _ = jm.apply(params, method=lambda m, **kw: m.emissions(**kw),
                       mask_positions=MASKS, offset=OFFSET, **keys)
    want_tags = np.asarray(jm.apply(params, batch, MASKS, OFFSET,
                                    mode="test"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got, _ = tm.emissions(
            mask_positions=MASKS, offset=OFFSET,
            **{k: v for k, v in tb.items() if k != "output_mask"})
        got_tags = tm(tb, MASKS, OFFSET, mode="test")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(got_tags.numpy(), want_tags)


@pytest.mark.parametrize("masked_lstm", [False, True])
def test_icka_emissions_and_tags_match_jax(flagship, masked_lstm):
    """`masked_lstm` changes no parameter, so one JAX init serves both."""
    jm, params, tm = flagship
    if masked_lstm:
        cfg = dataclasses.replace(jm.cfg, masked_lstm=True)
        jm = JaxICKAModel(cfg)
        port = ICKAModel(_port_cfg(cfg), device="cpu").eval()
        port.load_state_dict(tm.state_dict(), strict=True)
        tm = port
    _compare(jm, params, tm, _batch(jm.cfg, np.random.default_rng(11)))


def test_icka_all_ablation_flags_match_jax():
    """All five ablation flags off: the switched-off branches hold no
    parameters on either side (strict load), and outputs still agree."""
    jm, params, tm = _pair(_cfg(**ABLATED), seed=1)
    assert tm.txt2img is None and tm.gate is None and tm.vismapping is None
    _compare(jm, params, tm, _batch(jm.cfg, np.random.default_rng(12)))


def _examples(cfg, n, rng):
    vocab = cfg.embedding.vocab_size
    exs = []
    for _ in range(n):
        L = int(rng.integers(3, cfg.max_seq_length + 5))   # some truncate
        exs.append({
            "ori_input_ids": rng.integers(2, vocab, L).astype(np.int32),
            "input_ids": rng.integers(2, vocab, OFFSET + L).astype(np.int32),
            "clip_features": rng.standard_normal(cfg.clip_dim)
            .astype(np.float32),
            "visual_mean": rng.standard_normal(cfg.region_dim)
            .astype(np.float32),
            "visual_grid": rng.standard_normal((7, 7, cfg.region_dim))
            .astype(np.float32),
        })
    return exs


def test_server_tags_match_jax_server(flagship):
    jm, params, tm = flagship
    exs = _examples(jm.cfg, 9, np.random.default_rng(13))
    kw = dict(buckets=(16, 32), max_batch=4, offset=OFFSET,
              mask_positions=MASKS)
    want, want_stats = JaxServer(jm, params, **kw).predict(exs)
    got, got_stats = BucketedICKAServer(tm, device="cpu", **kw).predict(exs)
    assert got_stats.pairs_per_bucket == want_stats.pairs_per_bucket
    assert got_stats.batches_per_bucket == want_stats.batches_per_bucket
    for g, w, ex in zip(got, want, exs):
        assert g.dtype == np.int32
        assert len(g) == min(len(ex["ori_input_ids"]), 32)
        np.testing.assert_array_equal(g, w)


def test_server_validates_buckets_and_device(flagship):
    tm = flagship[2]
    with pytest.raises(ValueError):
        BucketedICKAServer(tm, buckets=(16,), device="cpu")
    # dropout is not ported: training mode runs only deterministically
    with pytest.raises(NotImplementedError):
        tm({}, MASKS, OFFSET, mode="train", deterministic=False)
    with pytest.raises(ValueError):
        tm({}, MASKS, OFFSET, mode="predict")
