"""The GPT-2 decoder and its KV cache in the PyTorch/CUDA port against the
JAX package on the CPU, at `GPT2Config.tiny`: decoder logits and hidden
states (with and without cross-attention, caption and memory masks) within
1e-4; the cached step within 1e-4 of JAX's cached step and of the port's
full teacher-forced pass, tied and untied heads; cached greedy and beam
tokens equal to JAX's and to the port's full-recompute decodes; a forced
prompt kept. Weights are the JAX decoder's, carried across by
`icka_tpu_torch.convert.gpt2_decoder_state_dict`."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.generation import decoding as jdec  # noqa: E402
from icka_tpu.generation import gpt2_cache as jgc  # noqa: E402
from icka_tpu.models import gpt2 as jgpt2  # noqa: E402
from icka_tpu_torch.convert import gpt2_decoder_state_dict  # noqa: E402
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.generation import decoding as dec  # noqa: E402
from icka_tpu_torch.generation import gpt2_cache as gc  # noqa: E402
from icka_tpu_torch.models import gpt2  # noqa: E402

B, LM, MAX_LEN = 2, 5, 8
BOS, EOS = 1, 2


def _port_cfg(jcfg):
    enc = tconfig.from_json(tconfig.EncoderConfig,
                            jconfig.to_json(jcfg.encoder))
    return gpt2.GPT2Config(**{**dataclasses.asdict(jcfg), "encoder": enc})


def _setup(with_cross=True, seed=0):
    jcfg = jgpt2.GPT2Config.tiny()
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, jcfg.vocab_size, (B, MAX_LEN)).astype(np.int32)
    mem = rng.standard_normal((B, LM, jcfg.n_embd)).astype(np.float32)
    mem_mask = np.ones((B, LM), np.int32)
    mem_mask[-1, -2:] = 0
    jm = jgpt2.GPT2Decoder(jcfg, with_cross=with_cross)
    params = jm.init(jax.random.PRNGKey(seed), ids,
                     memory=mem if with_cross else None,
                     memory_mask=mem_mask if with_cross else None)
    tm = gpt2.GPT2Decoder(_port_cfg(jcfg), with_cross=with_cross,
                          device="cpu").eval()
    tm.load_state_dict(gpt2_decoder_state_dict(jax.device_get(params)),
                       strict=True)
    return jcfg, jm, params, tm, dict(ids=ids, mem=mem, mem_mask=mem_mask)


@pytest.fixture(scope="module")
def cross():
    return _setup(True)


def _t(x):
    x = np.array(x)
    return torch.from_numpy(x).long() if x.dtype.kind == "i" \
        else torch.from_numpy(x)


@pytest.mark.parametrize("with_cross,masks,hidden", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True)])
def test_decoder_equals_jax(with_cross, masks, hidden):
    jcfg, jm, params, tm, d = _setup(with_cross)
    att = np.ones_like(d["ids"])
    att[0, -3:] = 0
    kw = {}
    if with_cross:
        kw = dict(memory=d["mem"], memory_mask=d["mem_mask"] if masks
                  else None)
    if hidden:
        jm = jgpt2.GPT2Decoder(jcfg, with_cross=with_cross,
                               return_hidden=True)
        tm.return_hidden = True
    want = jm.apply(params, d["ids"], att if masks else None, **kw)
    with torch.no_grad():
        got = tm(_t(d["ids"]), _t(att) if masks else None,
                 **{k: None if v is None else _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert got.shape == ((B, MAX_LEN, jcfg.n_embd) if hidden
                         else (B, MAX_LEN, jcfg.vocab_size))


def test_decoder_causality():
    jcfg, _, _, tm, d = _setup(False)
    ids2 = d["ids"].copy()
    ids2[0, -1] = (ids2[0, -1] + 1) % jcfg.vocab_size or 1
    with torch.no_grad():
        l1, l2 = tm(_t(d["ids"])), tm(_t(ids2))
    np.testing.assert_allclose(l1[0, :-1].numpy(), l2[0, :-1].numpy(),
                               atol=1e-5)
    assert not np.allclose(l1[0, -1].numpy(), l2[0, -1].numpy())


def _lm(params, untied, V, D):
    if not untied:
        return params["params"]["wte"].T
    return jnp.asarray(np.random.default_rng(5).standard_normal(
        (D, V)).astype(np.float32) * 0.1)


@pytest.mark.parametrize("untied", [False, True])
def test_cached_step_equals_jax_and_the_full_pass(cross, untied):
    jcfg, jm, params, tm, d = cross
    lm = _lm(params, untied, jcfg.vocab_size, jcfg.n_embd)
    lm_t = _t(jax.device_get(lm))
    jcache = jgc.precompute_gpt2_cache(params["params"], jcfg,
                                       jnp.asarray(d["mem"]),
                                       jnp.asarray(d["mem_mask"]), MAX_LEN)
    cache = gc.precompute_gpt2_cache(tm, d["mem"], d["mem_mask"], MAX_LEN)
    for a, b in zip(jax.tree.leaves(jcache),
                    jax.tree.leaves(dec.tree_map(lambda x: x.numpy(),
                                                 cache))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)
    tm.return_hidden = True
    with torch.no_grad():
        full = tm(_t(d["ids"]), memory=_t(d["mem"]),
                  memory_mask=_t(d["mem_mask"])) @ lm_t
    tm.return_hidden = False
    # jitted once, t traced (eager flax costs seconds a call)
    jstep = jax.jit(lambda tok, t, c: jgc.cached_gpt2_step(
        params["params"], jcfg, lm, tok, t, c))
    for t in range(MAX_LEN):
        want, jcache = jstep(jnp.asarray(d["ids"][:, t]), t, jcache)
        got, cache = gc.cached_gpt2_step(tm, lm_t, _t(d["ids"][:, t]), t,
                                         cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   atol=1e-4)


def full_step(tm, mem, mem_mask):
    """The full-recompute step: the teacher-forced decoder over the token
    buffer (positions after t masked), read at t."""
    def step(tok, cache, t):
        buf = cache["tokens"].clone()
        buf[:, t] = tok
        L = buf.shape[1]
        mask = (torch.arange(L)[None] <= t).expand_as(buf).long()
        logits = tm(buf, mask, cache["mem"], cache["mem_mask"])
        return logits[:, t], {**cache, "tokens": buf}

    return step, {"tokens": torch.zeros(B, MAX_LEN, dtype=torch.long),
                  "mem": _t(mem), "mem_mask": _t(mem_mask)}


@pytest.mark.parametrize("mode,kw", [("greedy", {}),
                                     ("beam", {"num_beams": 3}),
                                     ("beam", {"num_beams": 2,
                                               "length_penalty": 0.8})])
def test_cached_decodes_equal_jax_and_full_recompute(cross, mode, kw):
    jcfg, jm, params, tm, d = cross
    lm = params["params"]["wte"].T
    jcache = jgc.precompute_gpt2_cache(params["params"], jcfg,
                                       jnp.asarray(d["mem"]),
                                       jnp.asarray(d["mem_mask"]), MAX_LEN)
    cache = gc.precompute_gpt2_cache(tm, d["mem"], d["mem_mask"], MAX_LEN)
    init = np.full((B,), BOS, np.int32)
    fn = {"greedy": (jdec.greedy_decode, dec.greedy_decode),
          "beam": (jdec.beam_search, dec.beam_search)}[mode]
    want = fn[0](lambda tok, c, t: jgc.cached_gpt2_step(
        params["params"], jcfg, lm, tok, t, c), jnp.asarray(init), jcache,
        MAX_LEN, EOS, **kw)
    lm_t = tm.wte.T
    got = fn[1](lambda tok, c, t: gc.cached_gpt2_step(tm, lm_t, tok, t, c),
                _t(init), cache, MAX_LEN, EOS, **kw)
    step, fcache = full_step(tm, d["mem"], d["mem_mask"])
    with torch.no_grad():
        full = fn[1](step, _t(init), fcache, MAX_LEN, EOS, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), full.tokens.numpy())
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), full.scores.numpy(),
                               atol=1e-4)


def test_forced_prompt_through_the_cached_step(cross):
    """A prompt teacher-forced through the cached step (the ChunkAlign
    rationale decoders' use): kept, and tokens equal to JAX's."""
    jcfg, jm, params, tm, d = cross
    prompt = np.random.default_rng(2).integers(
        2, jcfg.vocab_size, (B, 3)).astype(np.int32)
    lm = params["params"]["wte"].T
    jcache = jgc.precompute_gpt2_cache(params["params"], jcfg,
                                       jnp.asarray(d["mem"]),
                                       jnp.asarray(d["mem_mask"]), 7)
    cache = gc.precompute_gpt2_cache(tm, d["mem"], d["mem_mask"], 7)
    want = jdec.greedy_decode(
        lambda tok, c, t: jgc.cached_gpt2_step(params["params"], jcfg, lm,
                                               tok, t, c),
        jnp.asarray(prompt[:, 0]), jcache, 7, eos_id=1,
        forced=jnp.asarray(prompt), forced_len=3)
    lm_t = tm.wte.T
    got = dec.greedy_decode(
        lambda tok, c, t: gc.cached_gpt2_step(tm, lm_t, tok, t, c),
        _t(prompt[:, 0]), cache, 7, eos_id=1, forced=prompt, forced_len=3)
    np.testing.assert_array_equal(got.tokens.numpy()[:, :3], prompt)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
