"""The Oscar captioner and its KV cache in the PyTorch/CUDA port against the
JAX package on the CPU, at `CaptionConfig.tiny`: the seq2seq mask
bit-equal; logits (tied and untied head, plain core and K1's plain
version) within 1e-4 and the loss within 1e-5; `decode_step` and the
cached step within 1e-4 of JAX's and of each other; greedy, beam and
constrained tokens (full recompute and cached) equal to JAX's; sampled
captions seeded and inside their filter. Weights are the JAX model's,
carried across by `icka_tpu_torch.convert.caption_state_dict`."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.generation import constrained as jcons  # noqa: E402
from icka_tpu.generation import kv_cache as jkv  # noqa: E402
from icka_tpu.models import captioning as jcap  # noqa: E402
from icka_tpu_torch.convert import caption_state_dict  # noqa: E402
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.generation import constrained as cons  # noqa: E402
from icka_tpu_torch.generation import decoding as dec  # noqa: E402
from icka_tpu_torch.generation import kv_cache as kv  # noqa: E402
from icka_tpu_torch.models import captioning as cap  # noqa: E402

BOS, EOS = 1, 2


def _port_cfg(jcfg):
    enc = tconfig.from_json(tconfig.EncoderConfig,
                            jconfig.to_json(jcfg.encoder))
    return cap.CaptionConfig(**{**dataclasses.asdict(jcfg), "encoder": enc})


def _setup(tie=True, use_pallas=False, B=2, seed=0):
    """JAX model and params, the port's model on the same weights, and
    inputs (the last image region of the last row padded)."""
    jcfg = jcap.CaptionConfig.tiny()
    jcfg = dataclasses.replace(
        jcfg, tie_word_embeddings=tie,
        encoder=dataclasses.replace(jcfg.encoder, use_pallas=use_pallas))
    rng = np.random.default_rng(seed)
    Lc, Li = jcfg.max_caption_len, jcfg.max_regions
    caps = rng.integers(1, jcfg.encoder.vocab_size, (B, Lc)).astype(np.int32)
    cap_mask = np.ones((B, Lc), np.int32)
    cap_mask[-1, Lc - 2:] = 0
    img = rng.standard_normal((B, Li, jcfg.img_feature_dim)) \
        .astype(np.float32)
    img_mask = np.ones((B, Li), np.int32)
    img_mask[-1, -1] = 0
    jm = jcap.CaptionModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), caps, cap_mask,
                              img, img_mask)
    # a non-zero LM bias, so that a dropped bias shows
    params["params"]["lm_bias"] = jnp.asarray(rng.standard_normal(
        params["params"]["lm_bias"].shape).astype(np.float32))
    tm = cap.CaptionModel(_port_cfg(jcfg), device="cpu").eval()
    tm.load_state_dict(caption_state_dict(jax.device_get(params)),
                       strict=True)
    d = dict(caps=caps, cap_mask=cap_mask, img=img, img_mask=img_mask)
    return jcfg, jm, params, tm, d


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def _t(x):
    return torch.from_numpy(np.asarray(x)).long() if np.asarray(x).dtype \
        .kind == "i" else torch.from_numpy(np.asarray(x))


def test_seq2seq_mask_bit_equal_jax():
    rng = np.random.default_rng(0)
    cap_mask = (rng.random((3, 5)) < 0.8).astype(np.int32)
    img_mask = (rng.random((3, 4)) < 0.7).astype(np.int32)
    want = np.asarray(jcap.seq2seq_mask(5, 4, jnp.asarray(cap_mask),
                                        jnp.asarray(img_mask)))
    got = cap.seq2seq_mask(5, 4, _t(cap_mask), _t(img_mask)).numpy()
    assert got.shape == (3, 1, 9, 9) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    b = got[:, 0]
    assert b[0, 1, 2] < -1e3 and (b[:, 5:, :5] < -1e3).all()


@pytest.mark.parametrize("tie,use_pallas", [(True, False), (False, False),
                                            (True, True)])
def test_logits_and_loss_equal_jax(tie, use_pallas):
    """Train-mode surface: logits within 1e-4, the next-token loss within
    1e-5, through the plain core and through K1 (its plain version here;
    JAX's kernel in interpret mode) with the full seq2seq bias."""
    _, jm, params, tm, d = _setup(tie=tie, use_pallas=use_pallas)
    args = (d["caps"], d["cap_mask"], d["img"], d["img_mask"])
    want_loss, want = jax.jit(lambda p, labels: jm.apply(
        p, *args, labels=labels))(params, d["caps"])
    with torch.no_grad():
        loss, got = tm(*(_t(a) for a in args), labels=_t(d["caps"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)


def test_port_training_step_lowers_the_loss(tiny):
    _, _, _, tm, d = tiny
    tm = cap.CaptionModel(tm.cfg, device="cpu")
    tm.load_state_dict(tiny[3].state_dict())
    args = [_t(d[k]) for k in ("caps", "cap_mask", "img", "img_mask")]
    loss, _ = tm(*args, labels=args[0])
    loss.backward()
    with torch.no_grad():
        for p in tm.parameters():
            p -= 0.5 * p.grad
        loss2, _ = tm(*args, labels=args[0])
    assert loss2.item() < loss.item()


def test_future_tokens_dont_leak(tiny):
    jcfg, _, _, tm, d = tiny
    caps2 = d["caps"].copy()
    caps2[0, -1] = (caps2[0, -1] + 1) % jcfg.encoder.vocab_size or 1
    with torch.no_grad():
        l1 = tm(_t(d["caps"]), _t(d["cap_mask"]), _t(d["img"]),
                _t(d["img_mask"]))
        l2 = tm(_t(caps2), _t(d["cap_mask"]), _t(d["img"]),
                _t(d["img_mask"]))
    np.testing.assert_allclose(l1[0, :-1].numpy(), l2[0, :-1].numpy(),
                               atol=1e-5)


def test_decode_and_cached_steps_equal_jax(tiny):
    """For a forced token sequence: the port's `decode_step` and cached
    step against JAX's `decode_step` and cached step, and against each
    other, at every position, 1e-4."""
    jcfg, jm, params, tm, d = tiny
    L = jcfg.max_caption_len
    forced = np.random.default_rng(3).integers(
        1, jcfg.encoder.vocab_size, (2, L)).astype(np.int32)
    jcache = jkv.precompute_image_cache(params, jcfg, jnp.asarray(d["img"]),
                                        jnp.asarray(d["img_mask"]), L)
    cache = kv.precompute_image_cache(tm, d["img"], d["img_mask"], L)
    for a, b in zip(jax.tree.leaves(jcache),
                    jax.tree.leaves(dec.tree_map(lambda x: x.numpy(),
                                                 cache))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)
    # jitted once each, t traced (eager flax costs seconds a call)
    jstep = jax.jit(lambda tok, t, c: jkv.cached_caption_step(
        params, jcfg, tok, t, c))
    jdecode = jax.jit(lambda buf, t: jm.apply(
        params, buf, d["img"], d["img_mask"], t,
        method=jcap.CaptionModel.decode_step))
    for t in range(L - 1):
        want_c, jcache = jstep(jnp.asarray(forced[:, t]), t, jcache)
        got_c, cache = kv.cached_caption_step(tm, _t(forced[:, t]), t, cache)
        buf = np.where(np.arange(L)[None] <= t, forced, 0)
        want = jdecode(buf, t)
        with torch.no_grad():
            got = tm.decode_step(_t(buf), _t(d["img"]), _t(d["img_mask"]),
                                 t)
        for x, y in ((got, want), (got_c, want_c), (got_c, want)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       atol=1e-4)


@pytest.mark.parametrize("mode,kw", [
    ("greedy", {}), ("greedy", {"repetition_penalty": 1.3}),
    ("beam", {"num_beams": 2}), ("beam", {"num_beams": 3,
                                          "length_penalty": 0.7})])
def test_full_and_cached_decodes_equal_jax(tiny, mode, kw):
    jcfg, jm, params, tm, d = tiny
    L = 6 if mode == "beam" else jcfg.max_caption_len
    args = dict(bos_id=BOS, eos_id=EOS, img_feats=d["img"],
                img_mask=d["img_mask"], max_len=L, mode=mode)
    want = jcap.generate_captions(jm, params, **args, **kw)
    got = cap.generate_captions(tm, **args, **kw)
    got_c = kv.generate_captions_cached(tm, **args, **kw)
    want_c = jkv.generate_captions_cached(jm, params, **args, **kw)
    for g in (got, got_c):
        np.testing.assert_array_equal(g.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_array_equal(g.tokens.numpy(),
                                      np.asarray(want_c.tokens))
        np.testing.assert_allclose(g.scores.numpy(), np.asarray(want.scores),
                                   atol=1e-4)
    assert (got.tokens.numpy()[..., 0] == BOS).all()
    if mode == "beam":
        assert got.tokens.shape == (2, kw["num_beams"], L)
        assert (np.diff(got.scores.numpy(), axis=1) <= 1e-6).all()


def test_forced_prefix_through_the_cached_beam(tiny):
    """A ragged prompt teacher-forced through every beam of the cached
    step: tokens equal to JAX's, the prompt kept."""
    jcfg, jm, params, tm, d = tiny
    prompt = np.array([[BOS, 5, 9, 0], [BOS, 7, 0, 0]], np.int32)
    kw = dict(bos_id=BOS, eos_id=EOS, img_feats=d["img"],
              img_mask=d["img_mask"], max_len=7, mode="beam", num_beams=2,
              forced=prompt, forced_len=np.array([3, 2]))
    want = jkv.generate_captions_cached(jm, params, **kw)
    got = kv.generate_captions_cached(tm, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens.numpy()[0, :, :3],
                                  np.broadcast_to(prompt[0, :3], (2, 3)))


def test_constrained_search_on_the_cached_step_equals_jax(tiny):
    jcfg, jm, params, tm, d = tiny
    V = jcfg.encoder.vocab_size
    L = 6
    constraints = [[7], [11]]
    jfsm = jcons.fsm_from_constraints(constraints, V)
    fsm = cons.fsm_from_constraints(constraints, V)
    jcache = jkv.precompute_image_cache(params, jcfg, jnp.asarray(d["img"]),
                                        jnp.asarray(d["img_mask"]), L)
    cache = kv.precompute_image_cache(tm, d["img"], d["img_mask"], L)
    want = jcons.constrained_beam_search(
        lambda tok, c, t: jkv.cached_caption_step(params, jcfg, tok, t, c),
        jnp.full((2,), BOS, jnp.int32), jcache, jfsm, max_len=L,
        eos_id=EOS, beams_per_state=2)
    got = cons.constrained_beam_search(
        lambda tok, c, t: kv.cached_caption_step(tm, tok, t, c),
        torch.full((2,), BOS), cache, fsm, max_len=L, eos_id=EOS,
        beams_per_state=2)
    assert got.tokens.shape == (2, 4, 2, L)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), atol=1e-4)
    g_toks, _ = cons.select_best_beam_with_constraints(got, fsm, 2)
    w_toks, _ = jcons.select_best_beam_with_constraints(want, jfsm, 2)
    np.testing.assert_array_equal(g_toks, w_toks)


def test_sampled_captions_seeded_and_filtered(tiny):
    """`generate_captions(mode="sample")`: one seed gives one caption, each
    token inside the filter of its step (the full step's logits), and
    JAX's loop forced to the port's tokens gives the port's scores."""
    jcfg, jm, params, tm, d = tiny
    L = jcfg.max_caption_len
    no_eos = jcfg.encoder.vocab_size     # an id no step emits
    kw = dict(bos_id=BOS, eos_id=no_eos, img_feats=d["img"],
              img_mask=d["img_mask"], max_len=L, mode="sample", top_k=5,
              top_p=0.9)
    outs = [cap.generate_captions(
        tm, generator=torch.Generator().manual_seed(s), **kw)
        for s in (3, 3)]
    assert torch.equal(outs[0].tokens, outs[1].tokens)
    toks = outs[0].tokens
    for t in range(L - 1):
        buf = torch.where(torch.arange(L)[None] <= t, toks, 0)
        with torch.no_grad():
            logits = tm.decode_step(buf, _t(d["img"]), _t(d["img_mask"]), t)
        kept = dec.top_k_top_p_filter(logits, 5, 0.9) > -1e8
        assert kept[torch.arange(2), toks[:, t + 1]].all()
    want = jcap.generate_captions(
        jm, params, bos_id=BOS, eos_id=no_eos, img_feats=d["img"],
        img_mask=d["img_mask"], max_len=L, mode="greedy",
        forced=jnp.asarray(toks.numpy()), forced_len=L)
    np.testing.assert_allclose(outs[0].scores.numpy(),
                               np.asarray(want.scores), atol=1e-5)
