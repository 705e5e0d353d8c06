"""The port's `GateCLTrainer` against the JAX package's at a tiny size on
the CPU, on the same weights (the port's random weights, carried to JAX
through the bridge) and the same loader batches:

  - one microbatch's loss within 1e-5 of JAX's `value_and_grad` of
    `_loss`, each gradient leaf within 1e-4 of that leaf's max |g|;
  - three accumulated optimizer steps, each step's loss within 1e-4
    relative of JAX's `make_train_step`;
  - snapshots exchanged both ways, step, params and moments bit-equal;
  - `fit` on tests/test_gate_cl_trainer.py's setup lowers the loss;
  - the training CLI trains each variant.

Microbatches of 4 with a negative rate of 2: the relation loss's swap
engages. Dropout is 0 on both sides (the config's rates, and the JAX
side's `_loss` runs deterministically: its dropout streams cannot be
matched). The images are smaller than the crop, so both sides take them
whole and draw no crop or flip."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.core import checkpoint as jckpt  # noqa: E402
from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.train.gate_cl_trainer import GateCLTrainer as JaxTrainer  # noqa: E402
from icka_tpu.train.optimizer import make_optimizer as jax_optimizer  # noqa: E402
from icka_tpu.train.trainer import ICKATrainState  # noqa: E402
from icka_tpu_torch.convert import (backbone_variables_from_state_dict,  # noqa: E402
                                    flax_tree_from_state_dict,
                                    gate_cl_variables_from_state_dict)
from icka_tpu_torch.core import checkpoint as tckpt  # noqa: E402
from icka_tpu_torch.core.config import GateCLConfig, TrainConfig, from_json  # noqa: E402
from icka_tpu_torch.data.clip_store import ClipFeatureStore  # noqa: E402
from icka_tpu_torch.data.conll import read_mm_conll  # noqa: E402
from icka_tpu_torch.data.features import convert_examples  # noqa: E402
from icka_tpu_torch.data.loader import MNERLoader  # noqa: E402
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer  # noqa: E402
from icka_tpu_torch.train.gate_cl_trainer import GateCLTrainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (1, 1, 1, 1)
BATCH, ACCUM, STEPS, MSL = 4, 2, 3, 24
TRAIN = dict(learning_rate=5e-3, train_batch_size=BATCH,
             eval_batch_size=BATCH, gradient_accumulation_steps=ACCUM,
             compute_dtype="float32", data_axis=1)


def _cfg(vocab):
    enc = dataclasses.replace(jconfig.EncoderConfig.tiny(vocab),
                              num_hidden_layers=1, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    return dataclasses.replace(jconfig.GateCLConfig.tiny(vocab),
                               encoder=enc, region_dim=2048,
                               max_seq_length=MSL, negative_rate=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, the port's trainer factory on one set of initial
    weights, the loader's three train batches, and the JAX trainer and
    initial state on the same weights."""
    root = tmp_path_factory.mktemp("gate_cl_train")
    ds = str(root / "ds")
    generate_dataset(ds, n_train=BATCH * ACCUM * STEPS, n_valid=0,
                     n_test=0, image_size=32, clip_dim=8)
    tok = tiny_tokenizer(os.path.join(ds, "tok"))
    jcfg = _cfg(len(tok.vocab) + 8)
    cfg = from_json(GateCLConfig, jconfig.to_json(jcfg))
    feats = convert_examples(read_mm_conll(os.path.join(ds, "train.txt")),
                             tok, MSL,
                             ClipFeatureStore.from_split(ds, "train"), 8)
    batches = list(MNERLoader(feats, os.path.join(ds, "images"), BATCH,
                              ACCUM, train=True, decode_size=32, prefetch=0))
    assert len(batches) == STEPS

    def port_trainer(**train):
        return GateCLTrainer(cfg, TrainConfig(**dict(TRAIN, **train)),
                             resnet_layers=LAYERS, device="cpu")

    first = port_trainer()
    params = gate_cl_variables_from_state_dict(first.model.state_dict())[
        "params"]
    backbone = backbone_variables_from_state_dict(
        first.backbone.state_dict())
    jtr = JaxTrainer(jcfg, jconfig.TrainConfig(**TRAIN),
                     resnet_layers=LAYERS)
    # dropout 0 on the JAX side: every loss deterministic (see above)
    jtr._loss = lambda p, b, mb, rng, train: JaxTrainer._loss(
        jtr, p, b, mb, rng, False)

    def jax_state():
        p = jax.tree.map(jnp.asarray, params)
        return ICKATrainState.create(
            apply_fn=jtr.model.apply, params=p,
            tx=jax_optimizer(jconfig.TrainConfig(**TRAIN), STEPS, params=p),
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
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jtr._loss(p, setup["backbone"], batch,
                            jax.random.PRNGKey(0), True)))(params)
    tr = setup["port_trainer"]()
    loss = tr.loss(batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * max(
        1.0, abs(float(want_loss)))
    got = _flat(flax_tree_from_state_dict(
        {n: p.grad for n, p in tr.model.named_parameters()}))
    want = _flat(jax.device_get(want_grads))
    assert got.keys() == want.keys()
    assert "crs_classifier/kernel" in want and "image_dense_cl/kernel" in want
    # a key projection's bias has a zero gradient in exact arithmetic: both
    # sides hold rounding noise there, held to 1e-10 of the largest
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
    assert got[0] != got[-1]


def test_port_snapshot_resumes_in_jax(setup, tmp_path):
    tr = setup["port_trainer"]()
    tr.init_state(STEPS)
    for i, batch in enumerate(setup["batches"][:2]):
        tr.train_step(batch, (0, i))
    tckpt.Checkpointer(str(tmp_path)).save(tr.state_tree(), step=tr.step)
    restored, step = jckpt.Checkpointer(str(tmp_path)).resume(
        setup["jax_state"]())
    assert step == tr.step == int(restored.step) == 2
    want_params = _flat(gate_cl_variables_from_state_dict(
        tr.model.state_dict())["params"])
    got_params = _flat(jax.device_get(restored.params))
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
            np.testing.assert_array_equal(got[k], w, err_msg=f"{key} {k}")


def test_jax_snapshot_resumes_in_the_port(setup, trajectories, tmp_path):
    _, jax_final, _ = trajectories
    jckpt.Checkpointer(str(tmp_path)).save(jax_final, step=STEPS)
    tr = setup["port_trainer"]()
    tr.init_state(STEPS)
    tree, step = tckpt.Checkpointer(str(tmp_path)).resume()
    tr.state_from_checkpoint(tree)
    assert step == tr.step == STEPS and int(tr.opt_state.count) == STEPS
    got = _flat(gate_cl_variables_from_state_dict(tr.model.state_dict())[
        "params"])
    for k, w in _flat(jax_final.params).items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    adam = jax_final.opt_state[1][0]
    moments = _moments(tr)
    for key in ("mu", "nu"):
        for k, w in _flat(getattr(adam, key)).items():
            np.testing.assert_array_equal(moments[key][k], w,
                                          err_msg=f"{key} {k}")


@pytest.mark.parametrize("variant", ["gate_cl", "ip"])
def test_fit_loss_decreases(tmp_path, variant):
    """tests/test_gate_cl_trainer.py's setup, on the port: 3 epochs of 16
    rows in steps of 2 x 4, lr 5e-3, fp32."""
    root = generate_dataset(str(tmp_path / "ds"), n_train=16, n_valid=8,
                            n_test=4, image_size=40, clip_dim=16)
    tok = tiny_tokenizer(str(tmp_path / "tok"))
    cfg = dataclasses.replace(
        GateCLConfig.tiny(vocab_size=len(tok.vocab) + 8, variant=variant),
        region_dim=2048, max_seq_length=24, negative_rate=2)
    tcfg = TrainConfig(train_batch_size=4, eval_batch_size=4,
                       gradient_accumulation_steps=2,
                       compute_dtype="float32", learning_rate=5e-3,
                       data_axis=1, model_axis=1)
    feats = convert_examples(read_mm_conll(os.path.join(root, "train.txt")),
                             tok, 24, ClipFeatureStore.from_split(root,
                                                                  "train"), 16)
    trainer = GateCLTrainer(cfg, tcfg, resnet_layers=LAYERS, device="cpu")
    loader = MNERLoader(feats, os.path.join(root, "images"), 4, 2,
                        train=True, decode_size=40, prefetch=0)
    dev = MNERLoader(feats, os.path.join(root, "images"), 4, train=False,
                     decode_size=40, prefetch=0)
    lines = []
    history = trainer.fit(loader, dev_loader=dev, epochs=3, log=lines.append)
    assert history[-1] < history[0], history
    assert all(re.fullmatch(r"epoch \d: train_loss=\d+\.\d{4} \(\d+\.\ds\) "
                            r"dev f1=\d\.\d{4}", line) for line in lines)
    res = trainer.evaluate(dev)
    assert 0.0 <= res.f1 <= 1.0 and res.loss == 0.0 and res.rows == 16


@pytest.mark.parametrize("model", ["gate_cl", "cl", "ip"])
def test_cli_trains_the_family(tmp_path, model):
    proc = subprocess.run(
        [sys.executable, "-m", "icka_tpu_torch.cli.train", "--synthetic",
         str(tmp_path / "ds"), "--tiny", "--device", "cpu", "--model", model,
         "--epochs_override", "1", "--output_dir", str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.rstrip("\n").split("\n")
    assert len(lines) == 2, lines
    assert lines[0].startswith("epoch 0: train_loss=")
    assert re.fullmatch(r"done; best dev F1 = \d+\.\d+(e-?\d+)?", lines[1])
    assert tckpt.Checkpointer(str(tmp_path / "out")).manifest["steps"]
