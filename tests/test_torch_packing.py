"""Sequence-packed flagship serving of the PyTorch/CUDA port against the JAX
package on the CPU: `pack_first_fit`, `PackedICKAServer.build_batch`,
`ICKAModel.forward_packed`, the `prompt_gather` encoder and the server's
tags, at `ICKAConfig.tiny()` size with `use_pallas=True` on both encoders
(the JAX side then runs its Pallas kernel in interpret mode, the port its
plain version). Weights are the JAX model's, carried across by
`icka_tpu_torch.convert`: the packed path needs no leaf beyond those of
`emissions`, which the strict load proves.

Tolerances: integer results (packings, batch arrays, tags) are equal;
encoder outputs agree within 1e-5 in fp32 (summation order only).
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")

from icka_tpu.core.config import ICKAConfig  # noqa: E402
from icka_tpu.models.icka import ICKAModel as JaxICKAModel  # noqa: E402
from icka_tpu.nn.bert import PromptSpliceEncoder as JaxPromptEncoder  # noqa: E402
from icka_tpu.serving.packing import PackedICKAServer as JaxPackedServer  # noqa: E402
from icka_tpu.serving.packing import pack_first_fit as jax_pack_first_fit  # noqa: E402
from icka_tpu_torch.convert import icka_state_dict, state_dict_from_flax  # noqa: E402
from icka_tpu_torch.core.config import EncoderConfig as TEncoderConfig  # noqa: E402
from icka_tpu_torch.core.config import ICKAConfig as TICKAConfig  # noqa: E402
from icka_tpu_torch.core.config import from_json, to_json  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.nn.bert import PromptSpliceEncoder  # noqa: E402
from icka_tpu_torch.serving.packing import (PackedICKAServer,  # noqa: E402
                                            PackedStats, pack_first_fit)

MAXL, OFFSET, MASKS = 16, 8, (2, 5)
FLAGS = ("use_txt2img", "use_alignment", "use_vision_prompt",
         "use_alignment_prompt", "use_gate")


def _cfg(**kw):
    cfg = ICKAConfig.tiny()
    enc = dataclasses.replace(cfg.embedding, use_pallas=True)
    return dataclasses.replace(cfg, embedding=enc, last_encoder=enc,
                               max_seq_length=MAXL, **kw)


def _init_batch(cfg, rng, B=2):
    vocab = cfg.embedding.vocab_size
    return {
        "input_ids": rng.integers(2, vocab, (B, OFFSET + MAXL))
        .astype(np.int32),
        "segment_ids": np.concatenate([np.zeros((B, OFFSET), np.int32),
                                       np.ones((B, MAXL), np.int32)], 1),
        "input_mask": np.ones((B, OFFSET + MAXL), np.int32),
        "ori_input_ids": rng.integers(2, vocab, (B, MAXL)).astype(np.int32),
        "ori_input_mask": np.ones((B, MAXL), np.int32),
        "ori_segment_ids": np.zeros((B, MAXL), np.int32),
        "img_mask": np.ones((B, cfg.num_regions), np.int32),
        "clip_features": np.zeros((B, 1, cfg.clip_dim), np.float32),
        "visual_mean": np.zeros((B, cfg.region_dim), np.float32),
        "visual_grid": np.zeros((B, 7, 7, cfg.region_dim), np.float32),
        "output_mask": np.ones((B, MAXL), np.int32),
    }


def _pair(cfg, seed=0):
    """(JAX model, its params, the port model with the same weights)."""
    jm = JaxICKAModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed),
                     _init_batch(cfg, np.random.default_rng(seed)), MASKS,
                     OFFSET, mode="test")
    tm = ICKAModel(from_json(TICKAConfig, to_json(cfg)), device="cpu").eval()
    tm.load_state_dict(icka_state_dict(jax.device_get(params)), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def flagship():
    return _pair(_cfg(masked_lstm=True))


def _examples(n, rng, cfg, lo=3, hi=MAXL + 5, zeros=False):
    """Requests at their true lengths; some exceed the row and truncate."""
    vocab = cfg.embedding.vocab_size
    feat = ((lambda *s: np.zeros(s, np.float32)) if zeros else
            (lambda *s: rng.standard_normal(s).astype(np.float32)))
    exs = []
    for _ in range(n):
        L = int(rng.integers(lo, hi))
        exs.append({
            "ori_input_ids": rng.integers(2, vocab, L).astype(np.int32),
            "input_ids": rng.integers(2, vocab, OFFSET + L).astype(np.int32),
            "visual_mean": feat(cfg.region_dim),
            "visual_grid": feat(7, 7, cfg.region_dim),
            "clip_features": feat(cfg.clip_dim),
        })
    return exs


def _servers(jm, params, tm, **kw):
    return (JaxPackedServer(jm, params, MASKS, OFFSET, max_batch=4, **kw),
            PackedICKAServer(tm, MASKS, OFFSET, max_batch=4, device="cpu",
                             **kw))


def _full_pad_tags(tm, ex):
    """One example padded to max_seq_length through the port's solo path."""
    cfg = tm.cfg
    pad = cfg.embedding.pad_token_id
    L = min(len(ex["ori_input_ids"]), MAXL)
    batch = {
        "input_ids": np.full((1, OFFSET + MAXL), pad, np.int64),
        "segment_ids": np.concatenate([np.zeros((1, OFFSET), np.int64),
                                       np.ones((1, MAXL), np.int64)], 1),
        "input_mask": np.zeros((1, OFFSET + MAXL), np.int64),
        "ori_input_ids": np.full((1, MAXL), pad, np.int64),
        "ori_input_mask": np.zeros((1, MAXL), np.int64),
        "ori_segment_ids": np.zeros((1, MAXL), np.int64),
        "img_mask": np.ones((1, cfg.num_regions), np.int64),
        "clip_features": ex["clip_features"].reshape(1, 1, -1),
        "visual_mean": ex["visual_mean"][None],
        "visual_grid": ex["visual_grid"][None],
        "output_mask": np.zeros((1, MAXL), np.int64),
    }
    batch["ori_input_ids"][0, :L] = ex["ori_input_ids"][:L]
    batch["ori_input_mask"][0, :L] = 1
    batch["output_mask"][0, :L] = 1
    batch["input_ids"][0, :OFFSET + L] = ex["input_ids"][:OFFSET + L]
    batch["input_mask"][0, :OFFSET + L] = 1
    with torch.no_grad():
        tags = tm({k: torch.from_numpy(v) for k, v in batch.items()}, MASKS,
                  OFFSET, mode="test")
    return tags.numpy()[0, :L]


# -- the host side ----------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(st.integers(1, 48), min_size=0, max_size=40),
       max_slots=st.integers(1, 6))
def test_pack_first_fit_equals_jax(lengths, max_slots):
    rows = pack_first_fit(lengths, 48, max_slots)
    assert rows == jax_pack_first_fit(lengths, 48, max_slots)
    assert sorted(i for row in rows for i in row) == list(range(len(lengths)))
    for row in rows:
        assert len(row) <= max_slots
        assert sum(lengths[i] for i in row) <= 48


@pytest.mark.parametrize("tier", [(MAXL, 3), (8, 2)])
def test_build_batch_arrays_equal_jax(flagship, tier):
    """Key by key; the port drops `valid_b`, which no model reads."""
    jm, params, tm = flagship
    js, ts = _servers(jm, params, tm, tiers=((8, 2), (MAXL, 3)))
    rng = np.random.default_rng(3)
    exs = _examples(9, rng, jm.cfg, hi=tier[0] + 1)
    exs[0]["img_mask"] = (rng.random(jm.cfg.num_regions) > 0.3).astype(np.int32)
    exs[1]["ori_segment_ids"] = np.ones(len(exs[1]["ori_input_ids"]), np.int32)
    lengths = [len(ex["ori_input_ids"]) for ex in exs]
    rows = jax_pack_first_fit(lengths, *tier)[:4]
    want, want_spans, want_toks = js.build_batch(exs, lengths, rows, *tier)
    got, spans, toks = ts.build_batch(exs, lengths, rows, *tier)
    assert spans == want_spans and toks == want_toks
    assert set(got) == set(want) - {"valid_b"}
    for key, w in want.items():
        if key == "valid_b":
            continue
        g = got[key]
        assert g.dtype == (torch.float32 if w.dtype == np.float32
                           else torch.int64), key
        np.testing.assert_array_equal(g.numpy(), w, err_msg=key)


def test_short_prompted_ids_raise_before_any_device_work(flagship):
    _, _, tm = flagship
    srv = PackedICKAServer(tm, MASKS, OFFSET, row_len=MAXL, max_slots=3,
                           max_batch=4, device="cpu")
    exs = _examples(3, np.random.default_rng(4), tm.cfg, hi=MAXL)
    exs[2]["input_ids"] = exs[2]["input_ids"][:-1]
    with pytest.raises(ValueError, match="example 2"):
        srv.predict(exs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PackedICKAServer(tm, MASKS, OFFSET)      # the default is the card


# -- the prompt_gather encoder ---------------------------------------------

def test_prompt_gather_encoder_matches_jax():
    """Packed `PromptSpliceEncoder` path: a (B, 1, L, L) block-diagonal
    mask, host position ids, prompt vectors gathered from a flat table.
    fp32, 1e-5."""
    rng = np.random.default_rng(5)
    cfg = ICKAConfig.tiny().last_encoder
    B, L, K, H = 2, 14, 4, cfg.hidden_size
    ids = rng.integers(2, cfg.vocab_size, (B, L)).astype(np.int32)
    slot = np.array([[0] * 6 + [1] * 5 + [2] * 3, [0] * 9 + [2] * 5], np.int32)
    pair = (slot[:, :, None] == slot[:, None, :]).astype(np.int32)[:, None]
    pos = rng.integers(2, 12, (B, L)).astype(np.int32)
    types = rng.integers(0, cfg.type_vocab_size, (B, L)).astype(np.int32)
    prefix = rng.standard_normal((B, K, H)).astype(np.float32)
    gather = np.full((B, L), K, np.int32)
    gather[0, 1:3], gather[0, 7:9], gather[1, 4] = (0, 1), (2, 3), 1
    jm = JaxPromptEncoder(cfg)
    v = jm.init(jax.random.PRNGKey(0), ids, pair, types, prefix, None, (0, 0),
                position_ids=pos, prompt_gather=gather)
    want, _ = jm.apply(v, ids, pair, types, prefix, None, (0, 0),
                       position_ids=pos, prompt_gather=gather)
    tm = PromptSpliceEncoder(from_json(TEncoderConfig, to_json(cfg)),
                             device="cpu").eval()
    tm.load_state_dict(state_dict_from_flax(jax.device_get(v)["params"]),
                       strict=True)
    with torch.no_grad():
        got, mask = tm(*(torch.from_numpy(a.astype(np.int64))
                         for a in (ids, pair, types)),
                       torch.from_numpy(prefix), None, (0, 0),
                       position_ids=torch.from_numpy(pos.astype(np.int64)),
                       prompt_gather=torch.from_numpy(gather.astype(np.int64)))
    assert tuple(mask.shape) == (B, 1, L, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# -- forward_packed ----------------------------------------------------------

def _forward_packed_both(jm, params, tm, seed):
    js, ts = _servers(jm, params, tm, row_len=MAXL, max_slots=3)
    exs = _examples(7, np.random.default_rng(seed), jm.cfg, hi=MAXL + 1)
    lengths = [len(ex["ori_input_ids"]) for ex in exs]
    rows = jax_pack_first_fit(lengths, MAXL, 3)[:4]
    assert any(len(r) > 1 for r in rows)
    want = np.asarray(js.apply_packed(
        params, js.build_batch(exs, lengths, rows)[0]))
    batch, spans, _ = ts.build_batch(exs, lengths, rows)
    got = ts.apply_packed(batch)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    for r, _, a, ln in spans:          # tags at padding are not defined
        np.testing.assert_array_equal(got.numpy()[r, a:a + ln],
                                      want[r, a:a + ln])


def test_forward_packed_tags_equal_jax(flagship):
    _forward_packed_both(*flagship, seed=6)


@pytest.mark.parametrize("flag", FLAGS)
def test_forward_packed_ablation_flag_equals_jax(flag):
    """Each ablation flag switched off alone; the branch it removes holds no
    parameters on either side (strict load)."""
    _forward_packed_both(*_pair(_cfg(masked_lstm=True, **{flag: False}),
                                seed=1), seed=7)


# -- the server ---------------------------------------------------------------

def _check_server(flagship, exs, **kw):
    jm, params, tm = flagship
    js, ts = _servers(jm, params, tm, **kw)
    want, want_stats = js.predict(exs)
    got, stats = ts.predict(exs)
    assert isinstance(stats, PackedStats)
    assert dataclasses.asdict(stats) == dataclasses.asdict(want_stats)
    for g, w, ex in zip(got, want, exs):
        assert g.dtype == np.int32
        assert len(g) == min(len(ex["ori_input_ids"]), MAXL)
        np.testing.assert_array_equal(g, w)
    return got, stats


def test_icka_packed_exact_vs_full_pad(flagship):
    """Packed tags == the JAX packed server's == the port's own decode of
    each example alone, padded to max_seq_length (masked_lstm=True)."""
    exs = _examples(11, np.random.default_rng(7), flagship[0].cfg)
    got, stats = _check_server(flagship, exs, row_len=MAXL, max_slots=3)
    assert stats.pairs == len(exs)
    for ex, g in zip(exs, got):
        np.testing.assert_array_equal(g, _full_pad_tags(flagship[2], ex))


def test_icka_packed_tiers_route_and_stay_exact(flagship):
    exs = _examples(12, np.random.default_rng(9), flagship[0].cfg)
    got, stats = _check_server(flagship, exs, tiers=((8, 2), (MAXL, 3)))
    assert stats.pairs == len(exs) and stats.batches >= 2
    for ex, g in zip(exs, got):
        np.testing.assert_array_equal(g, _full_pad_tags(flagship[2], ex))


def test_icka_packed_fill_beats_solo_rows(flagship):
    exs = _examples(24, np.random.default_rng(10), flagship[0].cfg, lo=3,
                    hi=6, zeros=True)
    got, stats = _check_server(flagship, exs, row_len=MAXL, max_slots=3)
    assert stats.rows <= len(exs) // 2
    assert stats.token_fill > 0.5
    assert all(t is not None for t in got)


def test_warmup_runs_every_tier(flagship):
    srv = PackedICKAServer(flagship[2], MASKS, OFFSET,
                           tiers=((8, 2), (MAXL, 3)), max_batch=2,
                           device="cpu")
    srv.warmup()
