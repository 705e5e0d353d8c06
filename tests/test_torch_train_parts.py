"""The parts of the port's training path against the JAX package, on the
CPU: the optimizer against optax (AdamW with clipping, warmup and the
decay mask, fp32 and bf16 first moments; `bert_adam`; every schedule),
the decay mask leaf for leaf through the bridge, the train loader's batches
bit-equal to the JAX loader's, train-mode augmentation on JAX's draws,
dropout's statistics, and K1's refusal of a gradient with the attention
routing rule that keeps training off it."""

import os
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from icka_tpu.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from icka_tpu.data.clip_store import ClipFeatureStore as JaxClipStore  # noqa: E402
from icka_tpu.data.conll import read_mm_conll as jax_read  # noqa: E402
from icka_tpu.data.features import convert_examples as jax_convert  # noqa: E402
from icka_tpu.data.images import preprocess_images as jax_preprocess  # noqa: E402
from icka_tpu.data.loader import MNERLoader as JaxLoader  # noqa: E402
from icka_tpu.data.synthetic import tiny_tokenizer as jax_tokenizer  # noqa: E402
from icka_tpu.train import optimizer as jopt  # noqa: E402
from icka_tpu_torch.convert import (flax_tree_from_state_dict,  # noqa: E402
                                    icka_variables_from_state_dict)
from icka_tpu_torch.core.config import ICKAConfig, TrainConfig  # noqa: E402
from icka_tpu_torch.data.clip_store import ClipFeatureStore  # noqa: E402
from icka_tpu_torch.data.conll import read_mm_conll  # noqa: E402
from icka_tpu_torch.data.features import convert_examples  # noqa: E402
from icka_tpu_torch.data.images import augment_images, preprocess_images  # noqa: E402
from icka_tpu_torch.data.loader import MNERLoader  # noqa: E402
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.nn import attention as tattn  # noqa: E402
from icka_tpu_torch.nn.layers import dropout  # noqa: E402
from icka_tpu_torch.train import optimizer as topt  # noqa: E402

# port names (torch layout) of a small parameter set that meets every rule
# of the decay mask
SHAPES = {"enc.layer_0.attn.query.weight": (4, 3),
          "enc.layer_0.attn.query.bias": (4,),
          "enc.layer_0.attn_out.norm.scale": (3,),
          "enc.layer_0.attn_out.norm.bias": (3,),
          "embeddings.word_embeddings": (6, 3),
          "lstm.w_ih_fwd": (8, 3),
          "crf.transitions": (5, 5)}
TOTAL = 10
# gradient scales of the five steps: warmup (lr 0 at the first), a clipped
# step (global norm above 1), a non-finite step, then two more
STEP_SCALES = (0.05, 3.0, float("nan"), 0.1, 2.0)


def _flax_name(name: str) -> str:
    """A port parameter name -> its flax path ("/"-joined)."""
    return re.sub(r"(^|\.)weight$", r"\1kernel", name).replace(".", "/")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax(tensors):
    """A flax tree of JAX arrays that own their memory (a JAX array made
    from numpy may alias it, and the port updates its tensors in place)."""
    return jax.tree.map(lambda x: jnp.array(np.array(x)),
                        flax_tree_from_state_dict(tensors))


def _close_to_leaf_max(got, want, what):
    """Every element within 1e-6 of the leaf's largest |value|."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.abs(np.asarray(got[k], np.float32) - w).max())
        assert err <= 1e-6 * float(np.abs(w).max()), (what, k, err)


def _grads(rng, scale):
    grads = {n: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * np.float32(scale))
        for n, s in SHAPES.items()}
    if not np.isfinite(scale):
        for g in grads.values():
            g[0] = float("inf")     # inf and nan leaves
    return grads


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax_step_by_step(mu_dtype):
    """Five steps from the same params: the port skips the non-finite step
    as its trainer does; the JAX side zeroes its gradients and keeps the
    old state as its trainer does."""
    rng = np.random.default_rng(0)
    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in SHAPES.items()}
    cfg = dict(learning_rate=0.01, warmup_proportion=0.3, mu_dtype=mu_dtype)
    opt = topt.make_optimizer(TrainConfig(**cfg), TOTAL, params)
    state = opt.init(params)
    jparams = _jax(params)
    tx = jopt.make_optimizer(JaxTrainConfig(**cfg), TOTAL, params=jparams)
    jstate = tx.init(jparams)
    clipped = 0
    for scale in STEP_SCALES:
        grads = _grads(rng, scale)
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        jgrads = _jax(grads)
        if finite:
            norm = opt.update(grads, state, params)
            clipped += int(norm >= 1.0)
            upd, jstate = tx.update(jgrads, jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
        _close_to_leaf_max(_flat(flax_tree_from_state_dict(params)),
                           _flat(jparams), "params")
        adam = jstate[1][0]
        assert int(state.count) == int(adam.count)
        for key in ("mu", "nu"):
            got = flax_tree_from_state_dict(getattr(state, key))
            _close_to_leaf_max(_flat(got), _flat(getattr(adam, key)), key)
        assert all(state.mu[n].dtype == topt.MU_DTYPES[mu_dtype]
                   for n in params)
    assert clipped == 2 and int(state.count) == 4


@pytest.mark.parametrize("name", ["linear_warmup_schedule", "warmup_cosine",
                                  "warmup_constant", "warmup_linear"])
def test_schedules_match_at_every_step(name):
    args = (3e-5, 2, TOTAL) if name == "linear_warmup_schedule" \
        else (3e-5, 0.2, TOTAL)
    got = getattr(topt, name)(*args)
    want = getattr(jopt, name)(*args)
    for step in range(TOTAL + 1):
        assert abs(float(got(step)) - float(want(step))) <= 1e-7, step
    assert float(got(0)) == 0.0


def test_bert_adam_matches_the_jax_transform():
    rng = np.random.default_rng(1)
    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in SHAPES.items()}
    mask = topt.decay_mask(params)
    opt = topt.BertAdam(topt.warmup_linear(1e-3, 0.2, TOTAL), mask=mask)
    state = opt.init(params)
    jparams = _jax(params)
    tx = jopt.bert_adam(jopt.warmup_linear(1e-3, 0.2, TOTAL),
                        mask=jopt._decay_mask(jparams))
    jstate = tx.init(jparams)
    for scale in (0.05, 3.0, 0.1, 2.0, 0.5):
        grads = _grads(rng, scale)
        opt.update(grads, state, params)
        upd, jstate = tx.update(_jax(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        _close_to_leaf_max(_flat(flax_tree_from_state_dict(params)),
                           _flat(jparams), "params")
        for key in ("mu", "nu"):
            _close_to_leaf_max(
                _flat(flax_tree_from_state_dict(getattr(state, key))),
                _flat(getattr(jstate, key)), key)


def test_decay_mask_equals_jax_leaf_for_leaf():
    """On every parameter of the tiny flagship: the port's mask by name
    equals JAX's `_decay_mask` at the flax path the bridge maps it to."""
    model = ICKAModel(ICKAConfig.tiny(), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    got = topt.decay_mask(names)
    tree = icka_variables_from_state_dict(model.state_dict())["params"]
    want = _flat(jax.tree.map(np.asarray, jopt._decay_mask(tree)))
    assert sorted(_flax_name(n) for n in names) == sorted(want)
    for n in names:
        assert got[n] == bool(want[_flax_name(n)]), n
    assert 0 < sum(got.values()) < len(got)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """29 train rows with 32x32 JPEGs, as each package's features."""
    root = str(tmp_path_factory.mktemp("ds"))
    generate_dataset(root, n_train=29, n_valid=0, n_test=0, clip_dim=8,
                     image_size=32, seed=3)
    tok, jtok = (tiny_tokenizer(os.path.join(root, "tok")),
                 jax_tokenizer(os.path.join(root, "jtok")))
    path = os.path.join(root, "train.txt")
    feats = convert_examples(read_mm_conll(path), tok, 24,
                             ClipFeatureStore.from_split(root, "train"), 8)
    jfeats = jax_convert(jax_read(path), jtok, 24,
                         JaxClipStore.from_split(root, "train"), 8)
    return feats, jfeats, os.path.join(root, "images")


@pytest.mark.parametrize("process_index", [0, 1])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_batches_equal_the_jax_loaders(corpus, process_index,
                                             prefetch):
    """Two epochs, accumulation 3 of 2, two processes (15 and 14 rows:
    two steps each and a ragged tail of 3 and 2 dropped)."""
    feats, jfeats, images = corpus
    kw = dict(train=True, decode_size=32, seed=7, prefetch=prefetch,
              process_index=process_index, process_count=2)
    got_loader = MNERLoader(feats, images, 2, 3, **kw)
    want_loader = JaxLoader(jfeats, images, 2, 3, **kw)
    assert len(got_loader) == len(want_loader) == 2
    epochs = []
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].shape[:2] == (3, 2), key
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        epochs.append(np.concatenate([b["input_ids"].reshape(6, -1)
                                      for b in got]))
    # each epoch has its own shuffle
    assert not np.array_equal(epochs[0], epochs[1])


def test_augmentation_on_jax_draws_matches_jax():
    images = np.random.default_rng(4).integers(0, 256, (8, 40, 40, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_preprocess(jnp.asarray(images), key, crop_size=32,
                                     train=True))
    k1, _, k3 = jax.random.split(key, 3)      # the draws JAX makes
    offsets = np.array(jax.random.randint(k1, (8, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(k3, 0.5, (8,)))
    assert flips.any() and not flips.all() and offsets.max() > 0
    got = augment_images(torch.from_numpy(images), torch.from_numpy(offsets),
                         torch.from_numpy(flips), 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_train_preprocessing_draws_from_the_callers_generator():
    images = np.random.default_rng(5).integers(0, 256, (16, 40, 40, 3),
                                               dtype=np.uint8)
    runs = [preprocess_images(images, 32, device="cpu", train=True,
                              generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert runs[0].shape == (16, 32, 32, 3)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    center = preprocess_images(images, 32, device="cpu")
    assert not torch.equal(runs[0], center)
    # no margin: training takes the center crop and no flip, as JAX does
    whole = images[:, 4:36, 4:36]
    assert torch.equal(
        preprocess_images(whole, 32, device="cpu", train=True,
                          generator=torch.Generator().manual_seed(1)),
        preprocess_images(whole, 32, device="cpu"))


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_statistics(rate):
    """JAX's dropout streams (threefry keys) cannot be matched by a torch
    generator, so the port's dropout is held to its statistics: the keep
    share within 1% of 1 - rate, kept values scaled by 1 / (1 - rate), the
    same seed the same mask, and no generator the identity."""
    x = torch.ones(1000, 1000)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) <= 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    assert torch.equal(y, dropout(x, rate, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, dropout(x, rate,
                                      torch.Generator().manual_seed(1)))
    assert dropout(x, rate, None) is x and dropout(x, 0.0, y) is x


def test_k1_refuses_a_gradient_and_training_routes_around_it(monkeypatch):
    x = torch.randn(2, 11, 32, generator=torch.Generator().manual_seed(0))
    mha = tattn.MultiHeadAttention(32, 4, use_pallas=True, device="cpu")
    out = mha(x)
    assert out.requires_grad
    with pytest.raises(RuntimeError, match="no backward"):
        out.sum().backward()
    with torch.no_grad():
        torch.testing.assert_close(mha(x), out.detach(), rtol=0, atol=0)
    calls = []
    kernel = tattn.fused_attention
    monkeypatch.setattr(tattn, "fused_attention",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    gen = torch.Generator().manual_seed(0)
    mha(x, dropout_gen=gen).sum().backward()      # plain core: trains
    assert calls == []
    mha.dropout_rate = 0.0                        # no dropout: the kernel
    with torch.no_grad():
        mha(x, dropout_gen=gen)
        mha(x)
    assert len(calls) == 2
