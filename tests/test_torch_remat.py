"""Rematerialised self-attention stacks of the port (`EncoderConfig.remat`,
`icka_tpu_torch.nn.remat`) on the CPU:

  - each policy's loss and gradients against JAX's `value_and_grad` of the
    same remat'd `Encoder` (2 layers of `EncoderConfig.tiny()`, dropout 0),
    within 1e-5 and 1e-4;
  - with dropout 0.1 drawn from one generator seed, each policy's
    gradients within 1e-6 of the port's own plain stack, and the generator
    left in the plain stack's state (the recompute must draw the forward's
    masks from an explicit generator, which `checkpoint` does not save);
  - which products each policy recomputes, read with a `TorchDispatchMode`
    over a forward and backward: "dots" none, "dots_nb" only the batched
    `bmm`s, "full" (and an unknown string) every `mm` and `bmm`,
    "alternate" those of the even layers; without grad nothing changes;
  - a tiny `ICKATrainer.train_step`, a `GateCLTrainer` step and the
    training CLI with remat, equal to the plain runs.
"""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.core.config import EncoderConfig as JEncoderConfig  # noqa: E402
from icka_tpu.nn import attention as jattn  # noqa: E402
from icka_tpu_torch.cli import train as train_cli  # noqa: E402
from icka_tpu_torch.convert import state_dict_from_flax  # noqa: E402
from icka_tpu_torch.core.config import (EncoderConfig, GateCLConfig,  # noqa: E402
                                        ICKAConfig, TrainConfig, to_json)
from icka_tpu_torch.data.clip_store import ClipFeatureStore  # noqa: E402
from icka_tpu_torch.data.conll import read_mm_conll  # noqa: E402
from icka_tpu_torch.data.features import convert_examples  # noqa: E402
from icka_tpu_torch.data.loader import MNERLoader  # noqa: E402
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer  # noqa: E402
from icka_tpu_torch.nn.attention import Encoder  # noqa: E402
from icka_tpu_torch.train.gate_cl_trainer import GateCLTrainer  # noqa: E402
from icka_tpu_torch.train.trainer import ICKATrainer  # noqa: E402

POLICIES = ("dots", "dots_nb", "alternate", "full")
B, S = 2, 9


def _inputs(hidden, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, hidden)).astype(np.float32)
    w = rng.standard_normal((B, S, hidden)).astype(np.float32)
    keep = np.ones((B, S), np.float32)
    keep[1, 6:] = 0
    bias = ((1.0 - keep) * -10000.0)[:, None, None, :]
    return x, w, bias


def _remat(cfg, policy):
    return dataclasses.replace(cfg, remat=policy is not None,
                               remat_policy=policy or "dots")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_encoder_matches_jax(policy):
    """The loss sum(encoder(x) * w) and its gradients (every parameter and
    x) of JAX's remat'd `Encoder` and the port's, on the same weights."""
    jcfg = _remat(dataclasses.replace(JEncoderConfig.tiny(),
                                      hidden_dropout_prob=0.0,
                                      attention_probs_dropout_prob=0.0),
                  policy)
    x, w, bias = _inputs(jcfg.hidden_size)
    jm = jattn.Encoder(jcfg)
    params = jm.init(jax.random.PRNGKey(0), x, bias)["params"]

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x, bias, True) * w)
    jloss, (jgp, jgx) = jax.device_get(jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1)))(params, x))

    tcfg = _remat(dataclasses.replace(EncoderConfig.tiny(),
                                      hidden_dropout_prob=0.0,
                                      attention_probs_dropout_prob=0.0),
                  policy)
    tm = Encoder(tcfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.device_get(params)),
                       strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    tloss = (tm(tx, torch.from_numpy(bias)) * torch.from_numpy(w)).sum()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, atol=1e-4, rtol=0)
    want = state_dict_from_flax(jgp)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)


class _Ops(TorchDispatchMode):
    """Counts every aten op dispatched while it is on, by name (all
    overloads together)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.name().split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def _run(policy, dropout=0.1, grad=True):
    """A forward and backward of a 2-layer stack at `dropout` with the
    generator seeded 5: (output, [x.grad, parameter grads], the
    generator's state after, the aten op counts)."""
    cfg = _remat(dataclasses.replace(
        EncoderConfig.tiny(), hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout), policy)
    enc = Encoder(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(1))
    x, w, bias = (torch.from_numpy(a) for a in _inputs(cfg.hidden_size))
    x.requires_grad_(grad)
    gen = torch.Generator().manual_seed(5)
    with _Ops() as ops, torch.set_grad_enabled(grad):
        y = enc(x, bias, gen)
        if grad:
            (y * w).sum().backward()
    grads = [x.grad] + [p.grad for p in enc.parameters()] if grad else []
    return y.detach(), grads, gen.get_state(), ops.counts


@pytest.fixture(scope="module")
def plain():
    return _run(None)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_with_dropout_equals_the_plain_stack(plain, policy):
    y, grads, state, _ = _run(policy)
    torch.testing.assert_close(y, plain[0], atol=0, rtol=0)
    for got, want in zip(grads, plain[1]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.equal(state, plain[2])
    # the masks were drawn: without dropout the output moves
    assert not torch.equal(y, _run(None, dropout=0.0)[0])


# per rematerialised layer, the products a whole-layer recompute runs:
# q, k, v, the attention output and the two FFN projections, and the score
# and context products of the core
FULL = {"mm": 6, "bmm": 2}


@pytest.mark.parametrize("policy,layers,want", [
    ("dots", 2, {"mm": 0, "bmm": 0}),
    ("dots_nb", 2, {"mm": 0, "bmm": 2}),
    ("alternate", 1, FULL),
    ("full", 2, FULL),
    ("any other string", 2, FULL),
])
def test_which_products_each_policy_recomputes(plain, policy, layers, want):
    """The recompute is what the remat'd run dispatches beyond the plain
    run's forward and backward."""
    extra = _run(policy)[3] - plain[3]
    got = {op: extra[f"aten::{op}"] for op in ("mm", "bmm")}
    assert got == {op: layers * n for op, n in want.items()}, extra
    # elementwise work, the masks included, is recomputed in every policy
    assert extra["aten::rand"] == layers * 3


@pytest.mark.parametrize("policy", POLICIES)
def test_no_remat_without_grad(policy):
    y, _, state, ops = _run(policy, grad=False)
    y0, _, state0, ops0 = _run(None, grad=False)
    assert torch.equal(y, y0) and torch.equal(state, state0)
    assert ops == ops0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 train rows (one step of 2 x 2 micro-batches per loader batch) and
    the tokenizer's vocabulary size."""
    root = str(tmp_path_factory.mktemp("remat_ds"))
    generate_dataset(root, n_train=8, n_valid=4, n_test=0, clip_dim=8,
                     image_size=32, seed=3)
    tok = tiny_tokenizer(os.path.join(root, "tok"))
    feats = convert_examples(read_mm_conll(os.path.join(root, "train.txt")),
                             tok, 24, ClipFeatureStore.from_split(root,
                                                                  "train"),
                             8)
    batch = next(iter(MNERLoader(feats, os.path.join(root, "images"), 2, 2,
                                 train=True, decode_size=32, prefetch=0)))
    return len(tok.vocab) + 8, feats.spec, batch


def _step(make, policy, batch):
    """One train step (dropout on) of a trainer from `make(policy)`: (loss,
    gradient norm, {name: (first moment, parameter)} after the update). The
    first step's learning rate is 0 under warmup, so the first moment,
    0.1 * g, carries the gradients."""
    tr = make(policy)
    tr.init_state(4)
    rec = tr.train_step(batch, (0, 0))
    return rec.loss, rec.grad_norm, {
        n: (tr.opt_state.mu[n].clone(), p.detach().clone())
        for n, p in tr.params().items()}


def _same_step(got, want):
    assert got[0] == pytest.approx(want[0], rel=1e-6, abs=0)
    assert got[1] == pytest.approx(want[1], rel=1e-6, abs=0)
    assert got[2].keys() == want[2].keys()
    for n, (mu, p) in got[2].items():
        torch.testing.assert_close(mu, want[2][n][0], atol=1e-7, rtol=0,
                                   msg=n)
        torch.testing.assert_close(p, want[2][n][1], atol=1e-6, rtol=0,
                                   msg=n)


def _icka_trainer(vocab, spec, policy):
    enc = _remat(EncoderConfig.tiny(vocab), policy)
    cfg = dataclasses.replace(ICKAConfig.tiny(vocab), embedding=enc,
                              last_encoder=enc, clip_dim=8, max_seq_length=24,
                              region_dim=2048, layer_num1=1)
    return ICKATrainer(cfg, TrainConfig(learning_rate=1e-3,
                                        compute_dtype="float32",
                                        gradient_accumulation_steps=2),
                       spec, resnet_layers=(1, 1, 1, 1), device="cpu")


def _gate_cl_trainer(vocab, spec, policy):
    cfg = dataclasses.replace(
        GateCLConfig.tiny(vocab), encoder=_remat(EncoderConfig.tiny(vocab),
                                                 policy),
        region_dim=2048, max_seq_length=24)
    return GateCLTrainer(cfg, TrainConfig(learning_rate=1e-3,
                                          compute_dtype="float32",
                                          gradient_accumulation_steps=2),
                         resnet_layers=(1, 1, 1, 1), device="cpu")


TRAINERS = {"icka": _icka_trainer, "gate_cl": _gate_cl_trainer}


@pytest.fixture(scope="module")
def plain_steps(corpus):
    vocab, spec, batch = corpus
    return {k: _step(lambda p, f=f: f(vocab, spec, p), None, batch)
            for k, f in TRAINERS.items()}


@pytest.mark.parametrize("family,policy", [
    *(("icka", p) for p in POLICIES), ("gate_cl", "dots"),
    ("gate_cl", "full")])
def test_train_step_with_remat_equals_the_plain_step(corpus, plain_steps,
                                                     family, policy):
    vocab, spec, batch = corpus
    got = _step(lambda p: TRAINERS[family](vocab, spec, p), policy, batch)
    _same_step(got, plain_steps[family])


def test_training_cli_trains_with_remat(tmp_path):
    """`cli.train --model_config` with remat on both stacks: the run's
    losses and weights equal those of the same config without it."""
    ds = tmp_path / "ds"
    generate_dataset(str(ds), n_train=32, n_valid=8, n_test=8,
                     image_size=64, clip_dim=16)
    vocab = len(tiny_tokenizer(str(ds / "tokenizer")).vocab) + 8
    runs = {}
    for policy in (None, "dots_nb"):
        enc = _remat(EncoderConfig.tiny(vocab), policy)
        cfg = dataclasses.replace(ICKAConfig.tiny(vocab), embedding=enc,
                                  last_encoder=enc, max_seq_length=32,
                                  region_dim=2048, clip_dim=16)
        path = tmp_path / f"{policy}.json"
        path.write_text(to_json(cfg))
        out = tmp_path / f"out_{policy}"
        tr = train_cli.main([
            "--synthetic", str(ds), "--tiny", "--model_config", str(path),
            "--device", "cpu", "--epochs_override", "1",
            "--train_batch_size", "4", "--gradient_accumulation_steps", "2",
            "--output_dir", str(out)])
        assert json.loads((out / "config.json").read_text())[
            "embedding"]["remat"] == (policy is not None)
        runs[policy] = ([r.loss for r in tr.records], tr.model.state_dict())
    (want_losses, want), (got_losses, got) = runs.values()
    assert len(got_losses) == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-6)
    for k, v in got.items():
        torch.testing.assert_close(v, want[k], atol=1e-6, rtol=0, msg=k)
