"""The VCR heads of the PyTorch/CUDA port against the JAX package on the
CPU, at `ChunkAlignConfig.tiny()` and `GPT2Config.tiny()`: `BaselineCLS`,
`BaselineRationale` in both memory modes (its frozen encoder, its
generation memory, its cached decode), `EnsembleRefiner` (no gradient
reaches its encoders), the three Oscar heads in every loss type (the tied
MLM decoder's gradient reaching the one table, equal to JAX's),
the score ensembles, `model_vote` and `AbstractSpecificGate`, and
`GPT2Captioner` (loss and gradients, the CLS head, greedy and beam
captions). Composed outputs within 1e-4 with identical predictions and
tokens, gradients within 1e-4, the host code bit-equal.

As in `tests/test_torch_chunkalign.py`, the weights are the port's
(perturbed), carried into JAX trees that must equal `jax.eval_shape` of
the JAX model's init."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.generation import decoding as jdec  # noqa: E402
from icka_tpu.generation import gpt2_cache as jgc  # noqa: E402
from icka_tpu.models import chunkalign_baselines as jbase  # noqa: E402
from icka_tpu.models import ensemble as jens  # noqa: E402
from icka_tpu.models import gpt2 as jgpt2  # noqa: E402
from icka_tpu.models import oscar as joscar  # noqa: E402
from icka_tpu_torch.convert import (chunkalign_baseline_state_dict,  # noqa
                                    ensemble_gate_state_dict,
                                    gpt2_captioner_state_dict,
                                    oscar_state_dict, state_dict_from_flax)
from icka_tpu_torch.generation import decoding as dec  # noqa: E402
from icka_tpu_torch.generation import gpt2_cache as gc  # noqa: E402
from icka_tpu_torch.models import chunkalign_baselines as base  # noqa: E402
from icka_tpu_torch.models import ensemble as ens  # noqa: E402
from icka_tpu_torch.models import gpt2  # noqa: E402
from icka_tpu_torch.models import oscar  # noqa: E402
from tests.test_torch_chunkalign import (B, C, NUM_CHUNKS, _np,  # noqa: E402
                                         _t, jax_params, perturb, port_cfgs,
                                         same_tree, vl_inputs)


@pytest.fixture(scope="module")
def setup():
    tcfg, jcfg, tg, jg = port_cfgs()
    rng = np.random.default_rng(11)
    args = vl_inputs(rng, tcfg, B * C)
    label = np.zeros((B * C,), np.int32)
    label[1::C] = 1                             # the second choice is gold
    expl = rng.integers(2, tg.vocab_size, (B * C, 10)).astype(np.int32)
    expl[:, -2:] = 0                            # pad: out of the LM loss
    attn = (expl > 0).astype(np.int32)
    return dict(tcfg=tcfg, jcfg=jcfg, tg=tg, jg=jg, args=args, label=label,
                expl=expl, attn=attn, rng=rng)


def _close(got, want, atol=1e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=atol)


# ---------------------------------------------------------------------------
# the baselines and the ensemble refiner
# ---------------------------------------------------------------------------

def test_baseline_cls_equals_jax(setup):
    s = setup
    ids, img, mask = s["args"][:3]
    tm = perturb(base.BaselineCLS(s["tcfg"], device="cpu", seed=1))
    jm = jbase.BaselineCLS(s["jcfg"])
    params = jax_params(tm)
    same_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ids, img,
                                             mask, s["label"])), params)
    want_train, want_eval = jax.jit(lambda p: (
        jm.apply(p, ids, img, mask, s["label"]),
        jm.apply(p, ids, img, mask)))(params)
    with torch.no_grad():
        got_train = tm(_t(ids), _t(img), _t(mask), _t(s["label"]))
        got_eval = tm(_t(ids), _t(img), _t(mask))
    _close(got_train, want_train)
    _close(got_eval, want_eval)
    assert chunkalign_baseline_state_dict(
        jax.device_get(params)).keys() == tm.state_dict().keys()


@pytest.fixture(scope="module")
def rationale_base(setup):
    s = setup
    tm = perturb(base.BaselineRationale(s["tcfg"], gpt2_cfg=s["tg"],
                                        device="cpu", seed=2))
    return tm, jax_params(tm)


@pytest.mark.parametrize("freeze", [False, True])
def test_baseline_rationale_equals_jax(setup, rationale_base, freeze):
    """`BaseLine` (full memory) and `Base_freeze` (words only, encoder
    frozen): losses, the generation memory of the predicted rows, and the
    frozen encoder's gradients (none)."""
    s = setup
    ids, img, mask = s["args"][:3]
    full, params = rationale_base
    tm = base.BaselineRationale(s["tcfg"], gpt2_cfg=s["tg"],
                                hypo_only_memory=freeze,
                                freeze_encoder=freeze, device="cpu").eval()
    tm.load_state_dict(full.state_dict(), strict=True)
    jm = jbase.BaselineRationale(s["jcfg"], gpt2_cfg=s["jg"],
                                 hypo_only_memory=freeze,
                                 freeze_encoder=freeze)
    tail = (s["expl"], s["attn"], s["label"])
    if not freeze:
        same_tree(jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), ids, img, mask, *tail)), params)
    want, want_gen = jax.jit(lambda p: (
        jm.apply(p, ids, img, mask, *tail),
        jm.apply(p, ids, img, mask,
                 method=jbase.BaselineRationale.encode_for_generation)))(
        params)
    got = tm(_t(ids), _t(img), _t(mask), *map(_t, tail))
    _close(got, want)
    got_gen = tm.encode_for_generation(_t(ids), _t(img), _t(mask))
    _close(got_gen, want_gen)
    Lh = ids.shape[1]
    assert got_gen[1].shape[1] == (Lh - 1 if freeze else Lh + img.shape[1])
    (got[0] + got[1]).backward()
    reached = [p.grad is not None and bool(p.grad.abs().max() > 0)
               for p in tm.oscar.parameters()]
    assert not any(reached) if freeze else any(reached)
    assert tm.dec.wte.grad.abs().max() > 0


def test_baseline_rationale_cached_generation(setup, rationale_base):
    """The baseline plugs into the same KV-cached engines: prompts forced
    through, tokens equal to JAX's."""
    from icka_tpu_torch.models.chunkalign import generate_rationale

    s = setup
    ids, img, mask = s["args"][:3]
    tm, params = rationale_base
    jm = jbase.BaselineRationale(s["jcfg"], gpt2_cfg=s["jg"])
    prompt = s["rng"].integers(2, s["tg"].vocab_size, (B, 3)).astype(np.int32)
    pred, mem, mem_mask = jax.jit(lambda p: jm.apply(
        p, ids, img, mask,
        method=jbase.BaselineRationale.encode_for_generation))(params)
    dec_p = params["params"]["dec"]
    cache = jgc.precompute_gpt2_cache(dec_p, s["jg"], mem, mem_mask, 7)
    want = jdec.greedy_decode(
        lambda tok, c, t: jgc.cached_gpt2_step(
            dec_p, s["jg"], params["params"]["lm_head"]["kernel"], tok, t,
            c), jnp.asarray(prompt[:, 0]), cache, 7, eos_id=1,
        forced=jnp.asarray(prompt), forced_len=3)
    enc = dict(input_ids=_t(ids), img_feats=_t(img), input_mask=_t(mask))
    got, got_pred = generate_rationale(tm, enc, prompt, prompt_len=3,
                                       max_gen_len=4, eos_id=1)
    np.testing.assert_array_equal(_np(got), np.asarray(want.tokens))
    np.testing.assert_array_equal(_np(got_pred), np.asarray(pred))
    np.testing.assert_array_equal(_np(got)[:, :3], prompt)


def test_ensemble_refiner_equals_jax(setup):
    s = setup
    args = s["args"]
    Lh = args[0].shape[1]
    align_pos = np.zeros((B * C, Lh), np.int32)
    align_pos[:, [1, 4]] = 1
    total_label = np.ones((B * C, Lh), np.int32)
    tm = perturb(base.EnsembleRefiner(s["tcfg"], device="cpu", seed=3))
    jm = jbase.EnsembleRefiner(s["jcfg"])
    params = jax_params(tm)
    same_tree(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *args, NUM_CHUNKS, align_pos, total_label)),
        params)
    want = jax.jit(lambda p: jm.apply(p, *args, NUM_CHUNKS, align_pos,
                                      total_label))(params)
    cls, align = tm(*map(_t, args), NUM_CHUNKS, _t(align_pos),
                    _t(total_label))
    _close((cls, align), want)
    assert cls.shape == (B * C, s["tcfg"].encoder.hidden_size)
    ((cls ** 2).sum() + align).backward()
    for name in ("global_enc", "seq_enc"):
        assert all(p.grad is None
                   for p in getattr(tm, name).parameters())
    assert tm.cls_layer_lyx_0.cross.q_proj.weight.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# the Oscar heads
# ---------------------------------------------------------------------------

L, R = 8, 4


def _oscar_inputs(s, lead):
    rng = np.random.default_rng(12)
    ids = rng.integers(2, s["tcfg"].encoder.vocab_size, lead + (L,)) \
        .astype(np.int32)
    img = rng.standard_normal(lead + (R, s["tcfg"].img_feature_dim)) \
        .astype(np.float32)
    mask = np.ones(lead + (L + R,), np.int32)
    mask[..., L - 2:L] = 0
    types = np.zeros(lead + (L,), np.int32)
    types[..., L // 2:] = 1
    return ids, img, mask, types


def test_sequence_classifier_losses_equal_jax(setup):
    """ce (an ignored -1 label in it), bce and kl on one mlp classifier."""
    s = setup
    ids, img, mask, types = _oscar_inputs(s, (3,))
    tm = perturb(oscar.ImageBertSequenceClassifier(
        s["tcfg"], num_labels=5, classifier="mlp", device="cpu", seed=4))
    params = jax_params(tm)
    rng = np.random.default_rng(13)
    labels = {"ce": np.array([1, -1, 4], np.int32),
              "bce": (rng.random((3, 5)) < 0.4).astype(np.float32),
              "kl": np.asarray(jax.nn.softmax(rng.standard_normal((3, 5)),
                                              -1), np.float32)}
    jms = {k: joscar.ImageBertSequenceClassifier(
        s["jcfg"], num_labels=5, classifier="mlp", loss_type=k)
        for k in labels}
    same_tree(jax.eval_shape(lambda: jms["ce"].init(
        jax.random.PRNGKey(0), ids, img, mask, types)), params)
    want = jax.jit(lambda p: {k: m.apply(p, ids, img, mask, types,
                                         labels=labels[k])
                              for k, m in jms.items()})(params)
    for kind, lab in labels.items():
        tm.loss_type = kind
        with torch.no_grad():
            got = tm(_t(ids), _t(img), _t(mask), _t(types), labels=_t(lab))
        _close(got, want[kind])
    with torch.no_grad():
        logits = tm(_t(ids), _t(img), _t(mask), _t(types))
    np.testing.assert_allclose(_np(logits), np.asarray(want["ce"][1]),
                               atol=1e-4)
    assert oscar_state_dict(jax.device_get(params)).keys() \
        == tm.state_dict().keys()


def test_multiple_choice_equals_jax(setup):
    s = setup
    ids, img, mask, types = _oscar_inputs(s, (2, C))
    tm = perturb(oscar.OscarMultipleChoice(s["tcfg"], device="cpu", seed=5))
    params = jax_params(tm)
    ce = np.zeros((2, C), np.int32)
    ce[:, 1] = 1
    bce = np.eye(2, dtype=np.float32)[ce]                  # (2, C, 2)
    jce = joscar.OscarMultipleChoice(s["jcfg"])
    jbce = joscar.OscarMultipleChoice(s["jcfg"], loss_type="bce")
    same_tree(jax.eval_shape(lambda: jce.init(jax.random.PRNGKey(0), ids,
                                              img, mask)), params)
    want = jax.jit(lambda p: (jce.apply(p, ids, img, mask, types),
                              jce.apply(p, ids, img, mask, types, labels=ce),
                              jbce.apply(p, ids, img, mask, types,
                                         labels=bce)))(params)
    with torch.no_grad():
        scores = tm(_t(ids), _t(img), _t(mask), _t(types))
        got_ce = tm(_t(ids), _t(img), _t(mask), _t(types), labels=_t(ce))
        tm.loss_type = "bce"
        got_bce = tm(_t(ids), _t(img), _t(mask), _t(types), labels=_t(bce))
    assert scores.shape == (2, C, 2)
    np.testing.assert_allclose(_np(scores), np.asarray(want[0]), atol=1e-4)
    _close(got_ce, want[1])
    _close(got_bce, want[2])


def test_pretraining_tied_decoder_equals_jax(setup):
    """One table: the state_dict holds `encoder.embeddings.word_embeddings`
    once and no decoder weight; its gradient (lookup and MLM decoder
    together) equals JAX's, as do the logits and losses."""
    s = setup
    ids, img, mask, types = _oscar_inputs(s, (3,))
    tm = perturb(oscar.ImageBertPreTraining(s["tcfg"], device="cpu",
                                            seed=6))
    jm = joscar.ImageBertPreTraining(s["jcfg"])
    params = jax_params(tm)
    same_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ids, img,
                                             mask)), params)
    keys = tm.state_dict().keys()
    assert "decoder_bias" in keys
    assert [k for k in keys if "word_embeddings" in k] \
        == ["encoder.embeddings.word_embeddings"]
    mlm = np.full((3, L), -1, np.int32)
    mlm[:, 2], mlm[0, 5] = 5, 9
    nsp = np.array([0, 1, -1], np.int32)

    def loss(p):
        out = jm.apply(p, ids, img, mask, types, masked_lm_labels=mlm,
                       next_sentence_label=nsp)
        return out[0], out
    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    got = tm(_t(ids), _t(img), _t(mask), _t(types),
             masked_lm_labels=_t(mlm), next_sentence_label=_t(nsp))
    _close(got, want)
    got[0].backward()
    g = state_dict_from_flax(jax.device_get(grads)["params"])
    table = tm.encoder.embeddings.word_embeddings
    np.testing.assert_allclose(_np(table.grad),
                               g["encoder.embeddings.word_embeddings"]
                               .numpy(), atol=1e-4)
    np.testing.assert_allclose(_np(tm.decoder_bias.grad),
                               g["decoder_bias"].numpy(), atol=1e-4)
    with torch.no_grad():
        table.add_(1.0)                      # the tie is live
        moved, _ = tm(_t(ids), _t(img), _t(mask), _t(types))
    assert not np.allclose(_np(moved), np.asarray(want[1]), atol=1e-3)


# ---------------------------------------------------------------------------
# ensembles and the gate
# ---------------------------------------------------------------------------

def test_ensembles_equal_jax():
    rng = np.random.default_rng(14)
    a, b, c = (rng.standard_normal((3, 4)).astype(np.float32)
               for _ in range(3))
    for w in (None, [0.2, 0.5, 0.3]):
        np.testing.assert_allclose(
            _np(ens.mean_ensemble([a, b, c], w)),
            np.asarray(jens.mean_ensemble([a, b, c], w)), atol=1e-6)
    np.testing.assert_allclose(_np(ens.logprob_ensemble([a, b])),
                               np.asarray(jens.logprob_ensemble([a, b])),
                               atol=1e-6)
    np.testing.assert_allclose(
        _np(ens.mean_ensemble([[[1.0, 0.0], [0.0, 1.0]],
                               [[3.0, 0.0], [1.0, 0.0]]])),
        [[2.0, 0.0], [0.5, 0.5]])
    votes = [rng.integers(0, 4, 50) for _ in range(4)]
    np.testing.assert_array_equal(ens.model_vote(votes),
                                  jens.model_vote(votes))
    # ties go to the first member's choice
    np.testing.assert_array_equal(
        ens.model_vote([np.array([0, 1, 2]), np.array([0, 1, 1]),
                        np.array([1, 1, 2]), np.array([1, 3, 1])]),
        [0, 1, 2])


def test_abstract_specific_gate_equals_jax():
    rng = np.random.default_rng(15)
    af, sf = (rng.standard_normal((2, 8)).astype(np.float32)
              for _ in range(2))
    a, sp = (rng.standard_normal((2, 4)).astype(np.float32)
             for _ in range(2))
    jm = jens.AbstractSpecificGate(hidden=8)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), af, sf, a, sp))
    tm = ens.AbstractSpecificGate(8, device="cpu")
    tm.load_state_dict(ensemble_gate_state_dict(params), strict=True)
    perturb(tm, 7, scale=0.5)
    want = jm.apply(jax_params(tm), af, sf, a, sp)
    with torch.no_grad():
        got = tm(_t(af), _t(sf), _t(a), _t(sp))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# GPT2Captioner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def captioner():
    _, _, tg, jg = port_cfgs()
    rng = np.random.default_rng(16)
    Le, Li, Lc = 6, 4, 8
    enc_ids = rng.integers(1, tg.encoder.vocab_size, (B, Le)).astype(np.int32)
    img = rng.standard_normal((B, Li, tg.img_feature_dim)).astype(np.float32)
    enc_mask = np.ones((B, Le + Li), np.int32)
    enc_mask[1, Le - 2:Le] = 0
    caps = rng.integers(1, tg.vocab_size, (B, Lc)).astype(np.int32)
    cap_mask = np.ones((B, Lc), np.int32)
    cap_mask[0, -3:] = 0
    tm = perturb(gpt2.GPT2Captioner(tg, num_cls_labels=4, device="cpu",
                                    seed=8))
    jm = jgpt2.GPT2Captioner(jg, num_cls_labels=4)
    params = jax_params(tm)
    same_tree(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), enc_ids, img, enc_mask, caps, cap_mask)),
        params)
    return tm, jm, params, (enc_ids, img, enc_mask, caps, cap_mask)


def test_captioner_loss_and_gradients_equal_jax(captioner):
    tm, jm, params, args = captioner
    cls_labels = np.array([1, 3], np.int32)

    def loss(p):
        out = jm.apply(p, *args, labels=args[3], cls_labels=cls_labels)
        return out["loss"], out
    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    got = tm(*map(_t, args), labels=_t(args[3]), cls_labels=_t(cls_labels))
    assert got.keys() == want.keys() == {"logits", "cls_logits", "loss"}
    for k in got:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    got["loss"].backward()
    g = state_dict_from_flax(jax.device_get(grads)["params"])
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), g[name].numpy(), atol=1e-4,
                                   err_msg=name)
    assert gpt2_captioner_state_dict(jax.device_get(params)).keys() \
        == tm.state_dict().keys()


@pytest.mark.parametrize("mode,kw", [("greedy", {}),
                                     ("beam", {"num_beams": 3})])
def test_captions_equal_jax(captioner, mode, kw):
    tm, jm, params, args = captioner
    want = jgpt2.generate_gpt2_captions(jm, params, *args[:3], bos_id=1,
                                        eos_id=2, max_len=6, mode=mode, **kw)
    got = gpt2.generate_gpt2_captions(tm, *map(_t, args[:3]), bos_id=1,
                                      eos_id=2, max_len=6, mode=mode, **kw)
    np.testing.assert_array_equal(_np(got.tokens), np.asarray(want.tokens))
    np.testing.assert_allclose(_np(got.scores), np.asarray(want.scores),
                               atol=1e-4)
    assert got.tokens.shape == ((B, 6) if mode == "greedy" else (B, 3, 6))
    # the step is the decoder over the whole buffer, read at t
    memory, _ = tm.encode(*map(_t, args[:3]))
    with torch.no_grad():
        full = tm.decoder(_t(args[3]), None, memory, _t(args[2]))
        step = tm.decode_step(_t(args[3]), memory, _t(args[2]),
                              args[3].shape[1] - 1)
    np.testing.assert_allclose(_np(step), _np(full[:, -1]), atol=1e-5)


def test_captioner_config_width_guard():
    """The captioner's encoder is a `GlobalVLEncoder` of the GPT-2 config's
    encoder and region width, as in the JAX module."""
    tg = port_cfgs()[2]
    tm = gpt2.GPT2Captioner(tg, device="cpu")
    assert tm.encoder.cfg.encoder == tg.encoder
    assert tm.encoder.img_embedding.weight.shape == (
        tg.encoder.hidden_size, tg.img_feature_dim)
    assert not hasattr(tm, "cls_head")
    assert dataclasses.asdict(tm.encoder.cfg)["img_feature_dim"] \
        == tg.img_feature_dim
