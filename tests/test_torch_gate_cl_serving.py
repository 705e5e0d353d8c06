"""The gate_cl family's servers in the PyTorch/CUDA port on the CPU: the
port's side of the single-device contracts of tests/test_serving.py
(`BucketedGateCLServer`) and tests/test_packing.py (`PackedGateCLServer`),
each server's tags against the JAX server's on the same weights, and
`warmup` on every bucketed and packed server leaving `predict`'s tags as
they were.

Models are tiny (`EncoderConfig.tiny()`, the RoBERTa dialect the JAX
serving tests use, one cross layer, width-32 regions, max_seq_length 16)
with `use_pallas=True`; the JAX side runs its kernel in interpret mode.
Tags are compared exactly: against the example decoded alone and padded to
max_seq_length ("full pad"), bucketed "ip"/"cl" and "gate_cl" with
`masked_crs=True`, and packed in every variant (the packed gate has the
`masked_crs` semantics); the reference-quirk gate_cl default agrees >= 0.9.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.models.gate_cl import GateCLModel as JaxGateCL  # noqa: E402
from icka_tpu.serving.bucketed import BucketedGateCLServer as JaxBucketed  # noqa: E402
from icka_tpu.serving.packing import PackedGateCLServer as JaxPacked  # noqa: E402
from icka_tpu_torch.convert import gate_cl_state_dict  # noqa: E402
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.models.gate_cl import GateCLModel  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.serving.bucketed import (BucketedGateCLServer,  # noqa: E402
                                             BucketedICKAServer)
from icka_tpu_torch.serving.packing import PackedGateCLServer  # noqa: E402

MAXL, REGION_DIM = 16, 32
VARIANTS = ("ip", "cl", "gate_cl")


def _cfg(variant, masked_crs=False):
    enc = dataclasses.replace(jconfig.EncoderConfig.tiny(), use_pallas=True)
    return jconfig.GateCLConfig(encoder=enc, num_labels=5, layer_num1=1,
                                region_dim=REGION_DIM, max_seq_length=MAXL,
                                variant=variant, negative_rate=2,
                                masked_crs=masked_crs)


def _port(cfg, sd):
    tm = GateCLModel(tconfig.from_json(tconfig.GateCLConfig,
                                       jconfig.to_json(cfg)),
                     device="cpu").eval()
    tm.load_state_dict(sd, strict=True)
    return tm


@pytest.fixture(scope="module")
def models():
    """{variant: (JAX module, params, port model)}, and "gate_cl_masked":
    the gate_cl weights under `masked_crs=True`."""
    out = {}
    B = 2
    for variant in VARIANTS:
        cfg = _cfg(variant)
        jm = JaxGateCL(cfg)
        params = jax.device_get(jm.init(
            jax.random.PRNGKey(0), np.ones((B, MAXL), np.int32),
            np.zeros((B, MAXL), np.int32), np.ones((B, MAXL), np.int32),
            np.ones((B, 49), np.int32), np.zeros((B, REGION_DIM), np.float32),
            np.zeros((B, 7, 7, REGION_DIM), np.float32)))
        out[variant] = (jm, params, _port(cfg, gate_cl_state_dict(params)))
    jm, params, tm = out["gate_cl"]
    masked = _cfg("gate_cl", masked_crs=True)
    out["gate_cl_masked"] = (JaxGateCL(masked), params,
                             _port(masked, tm.state_dict()))
    return out


def _examples(n, rng, max_len=MAXL, lo=3):
    exs = []
    for i in range(n):
        L = int(rng.integers(lo, max_len + 5))    # some exceed the top
        ex = {"input_ids": rng.integers(2, 120, L).astype(np.int32),
              "visual_mean": rng.standard_normal(REGION_DIM)
              .astype(np.float32),
              "visual_grid": rng.standard_normal((7, 7, REGION_DIM))
              .astype(np.float32)}
        if i % 3 == 1:
            ex["img_mask"] = (rng.random(49) > 0.3).astype(np.int32)
        exs.append(ex)
    return exs


def _full_pad_tags(tm, ex):
    """The reference layout: the example alone, padded to max_seq_length."""
    L = min(len(ex["input_ids"]), MAXL)
    ids = torch.full((1, MAXL), tm.cfg.encoder.pad_token_id,
                     dtype=torch.long)
    ids[0, :L] = torch.from_numpy(ex["input_ids"][:L])
    mask = (torch.arange(MAXL) < L).long()[None]
    img = torch.from_numpy(ex.get("img_mask", np.ones(49, np.int32)))[None]
    with torch.no_grad():
        tags = tm(ids, torch.zeros_like(ids), mask, img,
                  torch.from_numpy(ex["visual_mean"])[None],
                  torch.from_numpy(ex["visual_grid"])[None])
    return tags[0, :L].numpy()


def _bucketed(tm, **kw):
    return BucketedGateCLServer(tm, **dict(dict(buckets=(8, MAXL),
                                                max_batch=4), **kw),
                                device="cpu")


@pytest.mark.parametrize("variant", ["ip", "cl", "gate_cl_masked"])
def test_bucketed_exact_vs_full_pad(models, variant):
    tm = models[variant][2]
    exs = _examples(12, np.random.default_rng(1))
    tags, stats = _bucketed(tm).predict(exs)
    assert stats.total_pairs == len(exs)
    for ex, t in zip(exs, tags):
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, _full_pad_tags(tm, ex))


def test_bucketed_gate_cl_quirk_default_agreement(models):
    tm = models["gate_cl"][2]
    exs = _examples(16, np.random.default_rng(2))
    tags, _ = _bucketed(tm).predict(exs)
    refs = [_full_pad_tags(tm, ex) for ex in exs]
    agree = sum(int((t == r).sum()) for t, r in zip(tags, refs))
    total = sum(len(r) for r in refs)
    assert agree / total >= 0.9, f"tag agreement {agree}/{total}"


def test_truncation_and_lengths(models):
    tm = models["ip"][2]
    rng = np.random.default_rng(3)
    exs = _examples(6, rng)
    exs[0]["input_ids"] = rng.integers(2, 100, MAXL + 9).astype(np.int32)
    tags, _ = _bucketed(tm).predict(exs)
    assert len(tags[0]) == MAXL
    for ex, t in zip(exs[1:], tags[1:]):
        assert len(t) == min(len(ex["input_ids"]), MAXL)


def test_stats_accounting(models):
    exs = _examples(10, np.random.default_rng(4))
    _, stats = _bucketed(models["ip"][2]).predict(exs)
    assert stats.total_pairs == 10
    for b, n in stats.pairs_per_bucket.items():
        assert stats.batches_per_bucket[b] == -(-n // 4)


def test_per_bucket_batch_sizes(models):
    tm = models["ip"][2]
    exs = _examples(9, np.random.default_rng(6))
    tags, stats = _bucketed(tm, max_batch={8: 2, MAXL: 4}).predict(exs)
    assert stats.total_pairs == 9
    for b, n in stats.pairs_per_bucket.items():
        assert stats.batches_per_bucket[b] == -(-n // {8: 2, MAXL: 4}[b])
    for ex, t in zip(exs, tags):
        assert len(t) == min(len(ex["input_ids"]), MAXL)
    default = _bucketed(tm, max_batch=None)
    assert default._batch_of(16) == 512      # RECOMMENDED_BATCH
    assert default._batch_of(48) == 128      # fallback
    assert BucketedGateCLServer.RECOMMENDED_BATCH == \
        JaxBucketed.RECOMMENDED_BATCH


def test_largest_bucket_must_match_config(models):
    with pytest.raises(ValueError):
        _bucketed(models["ip"][2], buckets=(8,))


def test_bucketed_tags_equal_the_jax_server(models):
    """The reference-quirk gate_cl: padding activations reach the relation
    gate, so the bucket layout must match the JAX server's row for row."""
    jm, params, tm = models["gate_cl"]
    exs = _examples(9, np.random.default_rng(7))
    kw = dict(buckets=(8, MAXL), max_batch=4)
    want, want_stats = JaxBucketed(jm, params, **kw).predict(exs)
    got, stats = _bucketed(tm).predict(exs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(want_stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _packed(tm, **kw):
    return PackedGateCLServer(tm, **dict(dict(row_len=MAXL, max_slots=3,
                                              max_batch=4), **kw),
                              device="cpu")


@pytest.mark.parametrize("variant", ["ip", "cl", "gate_cl_masked"])
def test_packed_exact_vs_full_pad(models, variant):
    tm = models[variant][2]
    exs = _examples(13, np.random.default_rng(2))
    tags, stats = _packed(tm).predict(exs)
    assert stats.pairs == len(exs) and stats.rows >= len(exs) / 3
    for ex, t in zip(exs, tags):
        np.testing.assert_array_equal(t, _full_pad_tags(tm, ex))


def test_packed_gate_cl_quirk_default_agreement(models):
    tm = models["gate_cl"][2]
    exs = _examples(12, np.random.default_rng(3))
    tags, _ = _packed(tm).predict(exs)
    refs = [_full_pad_tags(tm, ex) for ex in exs]
    agree = sum(int((t == r).sum()) for t, r in zip(tags, refs))
    assert agree / sum(len(r) for r in refs) >= 0.9


def test_packed_fill_beats_solo_rows(models):
    exs = _examples(24, np.random.default_rng(4), max_len=2, lo=3)
    for ex in exs:
        ex["input_ids"] = ex["input_ids"][:5]
    tags, stats = _packed(models["ip"][2]).predict(exs)
    assert stats.rows <= len(exs) // 2
    assert stats.token_fill > 0.5
    assert all(t is not None for t in tags)


def test_packed_tiers_route_and_stay_exact(models):
    tm = models["ip"][2]
    exs = _examples(14, np.random.default_rng(6))
    tags, stats = _packed(tm, row_len=None,
                          tiers=((8, 2), (MAXL, 3))).predict(exs)
    assert stats.pairs == len(exs) and stats.batches >= 2
    for ex, t in zip(exs, tags):
        np.testing.assert_array_equal(t, _full_pad_tags(tm, ex))


def test_packed_tags_equal_the_jax_server(models):
    jm, params, tm = models["gate_cl"]
    exs = _examples(11, np.random.default_rng(8))
    kw = dict(tiers=((8, 2), (MAXL, 3)), max_batch=4)
    want, want_stats = JaxPacked(jm, params, **kw).predict(exs)
    got, stats = _packed(tm, row_len=None, **kw).predict(exs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(want_stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_warmup_leaves_tags_unchanged(models):
    """`warmup` on the gate_cl servers and on the flagship's bucketed server
    runs every bucket or tier, and `predict` gives the same tags after."""
    tm = models["gate_cl"][2]
    exs = _examples(7, np.random.default_rng(9))
    for server in (_bucketed(tm), _packed(tm, row_len=None,
                                          tiers=((8, 2), (MAXL, 3)))):
        before, _ = server.predict(exs)
        server.warmup()
        after, _ = server.predict(exs)
        for a, b in zip(after, before):
            np.testing.assert_array_equal(a, b)

    cfg = tconfig.ICKAConfig.tiny()
    flagship = ICKAModel(dataclasses.replace(cfg, max_seq_length=MAXL),
                         device="cpu", seed=1).eval()
    rng = np.random.default_rng(10)
    icka_exs = [{"ori_input_ids": rng.integers(2, 120, L).astype(np.int32),
                 "input_ids": rng.integers(2, 120, 14 + L).astype(np.int32),
                 "clip_features": rng.standard_normal(cfg.clip_dim)
                 .astype(np.float32),
                 "visual_mean": rng.standard_normal(cfg.region_dim)
                 .astype(np.float32),
                 "visual_grid": rng.standard_normal((7, 7, cfg.region_dim))
                 .astype(np.float32)} for L in (3, 9, 16, 20)]
    server = BucketedICKAServer(flagship, buckets=(8, MAXL), max_batch=2,
                                device="cpu")
    before, _ = server.predict(icka_exs)
    server.warmup()
    after, _ = server.predict(icka_exs)
    for a, b in zip(after, before):
        np.testing.assert_array_equal(a, b)
