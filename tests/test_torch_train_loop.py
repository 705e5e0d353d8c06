"""The port's training loop on the CPU, without the JAX package: a run
preempted by a real signal and resumed from its snapshot ends bit-equal to
the uninterrupted run (dropout on, so the seeded draws must line up); the
training CLI prints the JAX CLI's line shapes and writes its checkpoint
directory; the model axis in `TrainConfig` is taken, and a mesh of more
ranks than there are refused; and training with rematerialisation equals
training without it, the flagship's and the gate_cl family's."""

import dataclasses
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from icka_tpu_torch.cli import train as train_cli
from icka_tpu_torch.core.checkpoint import Checkpointer, PreemptionGuard
from icka_tpu_torch.core.config import GateCLConfig, ICKAConfig, TrainConfig
from icka_tpu_torch.core.mesh import MeshSpec, make_mesh
from icka_tpu_torch.data.clip_store import ClipFeatureStore
from icka_tpu_torch.data.conll import read_mm_conll
from icka_tpu_torch.data.features import convert_examples
from icka_tpu_torch.data.loader import MNERLoader
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer
from icka_tpu_torch.models.gate_cl import GateCLModel
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.train.trainer import ICKATrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 2
# the JAX CLI's lines (`icka_tpu/cli/train.py`, `ICKATrainer.fit`)
EPOCH_LINE = re.compile(
    r"epoch \d+: train_loss=\d+\.\d{4} \(\d+\.\ds\) dev_loss=\d+\.\d{4} "
    r"f1=\d\.\d{4} p=\d\.\d{4} r=\d\.\d{4}")
DONE_LINE = re.compile(r"done; best dev F1 = (None|\d+\.\d+(e-?\d+)?)")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 train rows (two steps of 2 x 2 an epoch) and 4 dev rows."""
    root = str(tmp_path_factory.mktemp("ds"))
    generate_dataset(root, n_train=8, n_valid=4, n_test=0, clip_dim=8,
                     image_size=32, seed=2)
    tok = tiny_tokenizer(os.path.join(root, "tok"))
    cfg = dataclasses.replace(ICKAConfig.tiny(vocab_size=len(tok.vocab) + 8),
                              clip_dim=8, max_seq_length=24,
                              region_dim=2048, layer_num1=1)
    feats = {split: convert_examples(
        read_mm_conll(os.path.join(root, f"{split}.txt")), tok, 24,
        ClipFeatureStore.from_split(root, split), 8)
        for split in ("train", "valid")}
    return cfg, feats, os.path.join(root, "images")


def _run(corpus, out, preempt_after=None):
    """A fresh trainer fitting EPOCHS epochs through a checkpointer in
    `out`; with `preempt_after`, the process sends itself SIGTERM during
    that many-th train step."""
    cfg, feats, images = corpus
    tr = ICKATrainer(cfg, TrainConfig(learning_rate=1e-3, train_batch_size=2,
                                      eval_batch_size=2,
                                      gradient_accumulation_steps=2,
                                      compute_dtype="float32"),
                     feats["train"].spec, resnet_layers=(1, 1, 1, 1),
                     device="cpu")
    if preempt_after is not None:
        step = tr.train_step

        def train_step(batch, key):
            record = step(batch, key)
            if len(tr.records) == preempt_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return record
        tr.train_step = train_step
    train = MNERLoader(feats["train"], images, 2, 2, train=True,
                       decode_size=32, seed=5, prefetch=0)
    dev = MNERLoader(feats["valid"], images, 2, train=False, decode_size=32,
                     prefetch=0)
    lines = []
    with PreemptionGuard() as guard:
        tr.fit(train, dev, epochs=EPOCHS, checkpointer=Checkpointer(str(out)),
               log=lines.append, preemption_guard=guard)
    return tr, lines


def test_preempted_and_resumed_run_equals_the_uninterrupted_one(corpus,
                                                                tmp_path):
    whole, lines = _run(corpus, tmp_path / "whole")
    assert whole.step == 2 * EPOCHS and len(lines) == EPOCHS
    # preempted in the second epoch, after its first step: the snapshot of
    # step 3 is written and fit returns early
    cut, cut_lines = _run(corpus, tmp_path / "cut", preempt_after=3)
    assert cut.step == 3
    assert cut_lines[-1] == "preempted: saved step 3, exiting fit"
    assert Checkpointer(str(tmp_path / "cut")).manifest["steps"][-1] == 3
    resumed, resumed_lines = _run(corpus, tmp_path / "cut")
    assert resumed_lines[0] == "resumed from step 3 (epoch 1, batch 1)"
    assert resumed.step == whole.step
    assert [r.loss for r in resumed.records] == [whole.records[-1].loss]
    want = whole.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for key in ("mu", "nu"):
        for n, t in getattr(resumed.opt_state, key).items():
            assert torch.equal(t, getattr(whole.opt_state, key)[n]), (key, n)
    # dropout drew different masks in different steps: the losses of one
    # batch order are not all equal
    assert len({r.loss for r in whole.records}) == len(whole.records)


def test_cli_prints_the_jax_clis_lines(tmp_path):
    ds, out = tmp_path / "ds", tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "icka_tpu_torch.cli.train", "--synthetic",
         str(ds), "--tiny", "--device", "cpu", "--epochs_override", "2",
         "--output_dir", str(out)], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.rstrip("\n").split("\n")
    assert len(lines) == 3, lines
    for i, line in enumerate(lines[:2]):
        assert EPOCH_LINE.fullmatch(line) and line.startswith(f"epoch {i}:")
    assert DONE_LINE.fullmatch(lines[2]), lines[2]
    # 32 rows in steps of 1 x 5: 6 a epoch; the first epoch's F1 beats -1
    manifest = Checkpointer(str(out)).manifest
    assert manifest["best_step"] == 6 and 6 in manifest["steps"]
    assert os.path.exists(out / "config.json")
    assert os.path.samefile(out / "state_best.msgpack",
                            out / "state_step6.msgpack")


@pytest.mark.parametrize("field,value", [("model_axis", 2)])
def test_the_mesh_is_not_ported(field, value):
    """The model axis is ported: the config takes it, and without a
    process group the mesh of more ranks than there are is refused, as the
    JAX package does (`tests/test_torch_tp_train.py` runs it)."""
    cfg = TrainConfig(**{field: value})
    assert getattr(cfg, field) == value
    with pytest.raises(ValueError, match=f"needs {value} devices"):
        make_mesh(MeshSpec(data=-1, model=cfg.model_axis), device="cpu")
    TrainConfig(data_axis=-1)              # all devices: the one device


def test_remat_trains_as_the_plain_model_in_both_families(corpus):
    """With dropout from one seed: the flagship's train loss (through
    `ICKATrainer.loss`, remat on both stacks, "full") and the gate_cl
    family's (remat on its encoder, "dots_nb") equal the plain model's, and
    so do their gradients within 1e-6. Train mode without a generator
    raises."""
    cfg, feats, images = corpus
    batch = next(iter(MNERLoader(feats["train"], images, 2, 1, train=True,
                                 decode_size=32, prefetch=0)))
    micro = {k: v[0] for k, v in batch.items()}

    def remat(enc, policy):
        return dataclasses.replace(enc, remat=True, remat_policy=policy)

    def icka(c):
        tr = ICKATrainer(c, TrainConfig(compute_dtype="float32"),
                         feats["train"].spec, resnet_layers=(1, 1, 1, 1),
                         device="cpu")
        return tr.model, lambda gen: tr.loss(
            micro, torch.Generator().manual_seed(4), gen)
    rc = dataclasses.replace(cfg, embedding=remat(cfg.embedding, "full"),
                             last_encoder=remat(cfg.last_encoder, "full"))
    gc = dataclasses.replace(GateCLConfig.tiny(), region_dim=64)
    ids = torch.ones(2, 4, dtype=torch.long)

    def gate_cl(c):
        model = GateCLModel(c, device="cpu")
        return model, lambda gen: model(
            ids, ids * 0, ids, torch.ones(2, 49), torch.ones(2, 64),
            torch.ones(2, 7, 7, 64), labels=ids * 0, dropout_gen=gen)
    for build, plain, rematerialised in (
            (icka, cfg, rc),
            (gate_cl, gc, dataclasses.replace(
                gc, encoder=remat(gc.encoder, "dots_nb")))):
        runs = []
        for c in (plain, rematerialised):
            model, loss_of = build(c)
            loss = loss_of(torch.Generator().manual_seed(9))
            loss.backward()
            runs.append((loss.detach(), {n: p.grad for n, p in
                                         model.named_parameters()}))
        (want, want_grads), (got, grads) = runs
        assert torch.equal(got, want) and torch.isfinite(got)
        for n, g in grads.items():
            torch.testing.assert_close(g, want_grads[n], atol=1e-6, rtol=0,
                                       msg=n)
    with pytest.raises(ValueError, match="dropout_gen"):
        ICKAModel(ICKAConfig.tiny(), device="cpu")({}, (3, 14), 18,
                                                   mode="train")


def test_step_seeds_differ_by_epoch_batch_and_microbatch(corpus):
    """Each microbatch of each step draws from its own stream: the same key
    repeats a step's loss exactly, another key moves it."""
    cfg, feats, images = corpus
    batch = next(iter(MNERLoader(feats["train"], images, 2, 2, train=True,
                                 decode_size=32, prefetch=0)))

    def loss(key):
        tr = ICKATrainer(cfg, TrainConfig(compute_dtype="float32",
                                          gradient_accumulation_steps=2),
                         feats["train"].spec, resnet_layers=(1, 1, 1, 1),
                         device="cpu")
        tr.init_state(4)
        return tr.train_step(batch, key).loss
    a, b, c = loss((0, 0)), loss((0, 0)), loss((1, 0))
    assert a == b and a != c and np.isfinite(a)
