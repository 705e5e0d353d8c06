"""The port's training step against the JAX package's `ICKATrainer` at a
tiny size on the CPU, on the same weights (the port's random weights,
carried to JAX through the bridge) and the same loader batches:

  - one microbatch's loss within 1e-5 of JAX's `value_and_grad` of
    `_loss`, each gradient leaf within 1e-4 of that leaf's max |g|;
  - three accumulated optimizer steps end to end, each step's loss within
    1e-4 relative of JAX's `make_train_step`. The bound is loose because
    Adam's eps amplifies noise-level gradients, so params are not compared
    after the end-to-end steps;
  - snapshots exchanged both ways: one the port writes restores through
    JAX's `Checkpointer.resume` into an `ICKATrainState` (fp32 and bf16
    first moments), one JAX writes resumes in the port, step, params and
    moments bit-equal;
  - a step with a non-finite loss leaves every tensor and the step as
    they were.

Dropout is 0 on both sides: the encoders' rates are 0 in the config, the
mapping networks' fixed 0.3 is set to 0 on the port's instances, and the
JAX side's `_loss` runs deterministically (its dropout streams cannot be
matched). The images are smaller than the crop, so both sides take them
whole and draw no crop or flip."""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.core import checkpoint as jckpt  # noqa: E402
from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.data.features import PromptSpec as JaxPromptSpec  # noqa: E402
from icka_tpu.train.optimizer import make_optimizer as jax_optimizer  # noqa: E402
from icka_tpu.train.trainer import ICKATrainer as JaxTrainer  # noqa: E402
from icka_tpu.train.trainer import ICKATrainState  # noqa: E402
from icka_tpu_torch.convert import (backbone_variables_from_state_dict,  # noqa: E402
                                    flax_tree_from_state_dict,
                                    icka_variables_from_state_dict)
from icka_tpu_torch.core import checkpoint as tckpt  # noqa: E402
from icka_tpu_torch.core.config import ICKAConfig, TrainConfig, from_json  # noqa: E402
from icka_tpu_torch.data.clip_store import ClipFeatureStore  # noqa: E402
from icka_tpu_torch.data.conll import read_mm_conll  # noqa: E402
from icka_tpu_torch.data.features import convert_examples  # noqa: E402
from icka_tpu_torch.data.loader import MNERLoader  # noqa: E402
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer  # noqa: E402
from icka_tpu_torch.train.trainer import ICKATrainer  # noqa: E402

LAYERS = (1, 1, 1, 1)
BATCH, ACCUM, STEPS = 2, 2, 3
TRAIN = dict(learning_rate=5e-3, train_batch_size=BATCH,
             eval_batch_size=BATCH, gradient_accumulation_steps=ACCUM,
             compute_dtype="float32", data_axis=1)


def _cfg(vocab):
    enc = dataclasses.replace(jconfig.EncoderConfig.tiny(vocab),
                              num_hidden_layers=1, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    return dataclasses.replace(
        jconfig.ICKAConfig.tiny(vocab), embedding=enc, last_encoder=enc,
        layer_num1=1, clip_dim=8, max_seq_length=24, region_dim=2048)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, the port's trainer factory on one set of initial
    weights, the loader's three train batches, and the JAX trainer and
    initial state on the same weights."""
    root = tmp_path_factory.mktemp("train")
    ds = str(root / "ds")
    generate_dataset(ds, n_train=BATCH * ACCUM * STEPS, n_valid=0,
                     n_test=0, image_size=32, clip_dim=8)
    tok = tiny_tokenizer(os.path.join(ds, "tok"))
    jcfg = _cfg(len(tok.vocab) + 8)
    cfg = from_json(ICKAConfig, jconfig.to_json(jcfg))
    feats = convert_examples(read_mm_conll(os.path.join(ds, "train.txt")),
                             tok, 24, ClipFeatureStore.from_split(ds, "train"),
                             8)
    batches = list(MNERLoader(feats, os.path.join(ds, "images"), BATCH,
                              ACCUM, train=True, decode_size=32, prefetch=0))
    assert len(batches) == STEPS

    def port_trainer(**train):
        tr = ICKATrainer(cfg, TrainConfig(**dict(TRAIN, **train)),
                         feats.spec, resnet_layers=LAYERS, device="cpu")
        tr.model.map_alignment.dropout = tr.model.map_vision.dropout = 0.0
        return tr

    first = port_trainer()
    params = icka_variables_from_state_dict(first.model.state_dict())[
        "params"]
    backbone = backbone_variables_from_state_dict(
        first.backbone.state_dict())
    jtr = JaxTrainer(jcfg, jconfig.TrainConfig(**TRAIN),
                     JaxPromptSpec(**dataclasses.asdict(feats.spec)),
                     resnet_layers=LAYERS)
    # dropout 0 on the JAX side: every loss deterministic (see above)
    jtr._loss = lambda p, b, mb, rng, train: JaxTrainer._loss(
        jtr, p, b, mb, rng, False)

    def jax_state(mu_dtype="float32"):
        tcfg = jconfig.TrainConfig(**dict(TRAIN, mu_dtype=mu_dtype))
        p = jax.tree.map(jnp.asarray, params)
        return ICKATrainState.create(
            apply_fn=jtr.model.apply, params=p,
            tx=jax_optimizer(tcfg, STEPS, params=p),
            backbone_variables=jax.tree.map(jnp.asarray, backbone))

    return dict(port_trainer=port_trainer, batches=batches, jtr=jtr,
                jax_state=jax_state, params=params, backbone=backbone)


@pytest.fixture(scope="module")
def trajectories(setup):
    """Three optimizer steps on both sides from the same state: the JAX
    losses and final state (numpy), the port's trainer after its steps."""
    step = setup["jtr"].make_train_step()
    state = setup["jax_state"]()
    jax_losses = []
    for i, batch in enumerate(setup["batches"]):
        state, loss = step(state, batch, jax.random.PRNGKey(i))
        jax_losses.append(float(loss))
    tr = setup["port_trainer"]()
    tr.init_state(STEPS)
    for i, batch in enumerate(setup["batches"]):
        tr.train_step(batch, (0, i))
    return jax_losses, jax.device_get(state), tr


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _moments(tr):
    return {key: _flat(flax_tree_from_state_dict(getattr(tr.opt_state, key)))
            for key in ("mu", "nu")}


def test_loss_and_gradients_match_jax_value_and_grad(setup):
    batch = {k: v[0] for k, v in setup["batches"][0].items()}
    jtr = setup["jtr"]
    params = jax.tree.map(jnp.asarray, setup["params"])
    backbone = setup["backbone"]
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jtr._loss(p, backbone, batch, jax.random.PRNGKey(0),
                            True)))(params)
    tr = setup["port_trainer"]()
    loss = tr.loss(batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    got = _flat(flax_tree_from_state_dict(
        {n: p.grad for n, p in tr.model.named_parameters()}))
    want = _flat(jax.device_get(want_grads))
    assert got.keys() == want.keys()
    # a key projection's bias has a zero gradient in exact arithmetic (the
    # softmax ignores a shift along its keys): both sides hold rounding
    # noise there, held to 1e-10 of the largest gradient instead
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(got[name] - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_three_accumulated_steps_match_jax_losses(trajectories):
    jax_losses, jax_final, tr = trajectories
    got = [r.loss for r in tr.records]
    assert [r.applied for r in tr.records] == [True] * STEPS
    assert tr.step == int(jax_final.step) == STEPS
    np.testing.assert_allclose(got, jax_losses, rtol=1e-4, atol=0)
    # the first update ran at lr 0 (warmup), the later ones moved the loss
    assert got[0] != got[-1]


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_port_snapshot_resumes_in_jax(setup, tmp_path, mu_dtype):
    tr = setup["port_trainer"](mu_dtype=mu_dtype)
    tr.init_state(STEPS)
    for i, batch in enumerate(setup["batches"][:2]):
        tr.train_step(batch, (0, i))
    ck = tckpt.Checkpointer(str(tmp_path))
    ck.save(tr.state_tree(), step=tr.step)
    restored, step = jckpt.Checkpointer(str(tmp_path)).resume(
        setup["jax_state"](mu_dtype))
    assert step == tr.step == int(restored.step) == 2
    got_params = _flat(jax.device_get(restored.params))
    want_params = _flat(icka_variables_from_state_dict(
        tr.model.state_dict())["params"])
    assert got_params.keys() == want_params.keys()
    for k, w in want_params.items():
        np.testing.assert_array_equal(got_params[k], w, err_msg=k)
    adam = restored.opt_state[1][0]
    assert int(adam.count) == int(restored.opt_state[1][2].count) == 2
    want = _moments(tr)
    for key in ("mu", "nu"):
        got = _flat(jax.device_get(getattr(adam, key)))
        assert got.keys() == want[key].keys()
        for k, w in want[key].items():
            g = got[k]
            want_dtype = jnp.bfloat16 if key == "mu" and \
                mu_dtype == "bfloat16" else jnp.float32
            assert g.dtype == np.dtype(want_dtype), (key, k)
            np.testing.assert_array_equal(g.astype(np.float32), w,
                                          err_msg=f"{key} {k}")
    assert any(np.abs(w).max() > 0 for w in want["mu"].values())


def test_jax_snapshot_resumes_in_the_port(setup, trajectories, tmp_path):
    _, jax_final, _ = trajectories
    jckpt.Checkpointer(str(tmp_path)).save(jax_final, step=STEPS)
    tr = setup["port_trainer"]()
    tr.init_state(STEPS)
    tree, step = tckpt.Checkpointer(str(tmp_path)).resume()
    tr.state_from_checkpoint(tree)
    assert step == tr.step == STEPS and int(tr.opt_state.count) == STEPS
    got = _flat(icka_variables_from_state_dict(tr.model.state_dict())[
        "params"])
    want = _flat(jax_final.params)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    adam = jax_final.opt_state[1][0]
    moments = _moments(tr)
    for key in ("mu", "nu"):
        for k, w in _flat(getattr(adam, key)).items():
            np.testing.assert_array_equal(moments[key][k], w,
                                          err_msg=f"{key} {k}")


def test_non_finite_step_is_skipped_bit_for_bit(setup):
    tr = setup["port_trainer"]()
    tr.init_state(STEPS)
    tr.train_step(setup["batches"][0], (0, 0))
    tr.train_step(setup["batches"][1], (0, 1))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    moments = {key: {n: t.clone() for n, t in getattr(tr.opt_state,
                                                      key).items()}
               for key in ("mu", "nu")}
    count, step = int(tr.opt_state.count), tr.step
    bad = dict(setup["batches"][2])
    bad["clip_features"] = np.full_like(bad["clip_features"], np.nan)
    record = tr.train_step(bad, (0, 2))
    assert not record.applied and not np.isfinite(record.loss)
    assert (tr.step, int(tr.opt_state.count)) == (step, count) == (2, 2)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for key in ("mu", "nu"):
        for n, t in getattr(tr.opt_state, key).items():
            assert torch.equal(t, moments[key][n]), (key, n)
    # the next finite step is applied and takes the schedule's next value
    assert tr.train_step(setup["batches"][2], (0, 2)).applied
    assert tr.step == 3
