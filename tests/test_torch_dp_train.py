"""Data-parallel training on the CPU: two gloo ranks against one, ZeRO-1
against replicated, the port's two-rank step against the JAX package's
step on a `MeshSpec(data=2)` mesh, a ZeRO-1 snapshot resumed by JAX, a
preemption requested on one rank only, and the training CLI run by two
ranks.

Two ranks are started once for the module (`spawn`, a `FileStore` in the
test's directory) and run every scenario in that one start, on the tiny
configuration of `tests/test_multichip_grid.py` (global batch 8, two
accumulated microbatches, sequence 16) with each row's true length drawn,
so the ranks hold different token counts. With dropout and the train crop
and flip on (images of 232 for a crop of 224):

  - the two ranks' losses over two steps are within 2e-5 relative of one
    rank's on the same global batch and seed, and the all-reduced
    gradients within 1e-5 of each leaf's max |g| (a leaf whose max is
    rounding noise, a key projection's bias, is held to 1e-5 of 1e-6 of
    the largest gradient, as in `tests/test_torch_train.py`). Parameters
    are not compared across rank counts after Adam, which amplifies the
    reduction order's noise in near-zero gradients;
  - after each step every rank's parameters are bit-equal to the other's;
  - ZeRO-1's parameters and gathered moments are bit-equal to the
    replicated run's after each step (the same elementwise arithmetic);
    each ZeRO-1 rank holds only its slice of every divisible moment leaf,
    the replicated run none.

The same holds for `GateCLTrainer` in each variant ("ip", "cl",
"gate_cl") at a negative rate of 6, whose swap exchanges rows 2-4 with
5-7: on two ranks of four rows a swapped pair spans the ranks, and
InfoNCE's negatives are the whole microbatch's.

With dropout 0 and images smaller than the crop (no draws), one two-rank
step's loss is within 1e-4 relative of the JAX `ICKATrainer` step on a
`MeshSpec(data=2)` mesh of conftest's virtual devices, the bound of
`tests/test_torch_train.py`. The JAX package is imported by the tests
only, never by a rank.
"""

import contextlib
import dataclasses
import io
import json
import multiprocessing as mp
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from icka_tpu_torch.cli import train as train_cli
from icka_tpu_torch.convert import (backbone_variables_from_state_dict,
                                    icka_variables_from_state_dict)
from icka_tpu_torch.core.checkpoint import Checkpointer
from icka_tpu_torch.core.config import (EncoderConfig, GateCLConfig,
                                        ICKAConfig, TrainConfig)
from icka_tpu_torch.core.mesh import Mesh, init_distributed
from icka_tpu_torch.data.features import PromptSpec
from icka_tpu_torch.models.gate_cl import negative_swap_permutation
from icka_tpu_torch.parallel.partitioning import moment_slices
from icka_tpu_torch.train.gate_cl_trainer import GateCLTrainer
from icka_tpu_torch.train.trainer import ICKATrainer

WORLD = 2
GLOBAL_BATCH, ACCUM, SEQ, OFFSET, MASKS = 8, 2, 16, 10, (3, 7)
STEPS = 2
LAYERS = (1, 1, 1, 1)
SPEC = PromptSpec(OFFSET, MASKS, OFFSET + SEQ, SEQ)
VARIANTS = ("ip", "cl", "gate_cl")
NEGATIVE_RATE = 6
TRAIN = dict(learning_rate=5e-3, train_batch_size=GLOBAL_BATCH,
             gradient_accumulation_steps=ACCUM, compute_dtype="float32")


def _cfg(dropout=True):
    """`tests/test_multichip_grid.py`'s configuration; dropout at the
    encoders' default 0.1 (and the mapping networks' 0.3), or off and one
    layer per stack (the JAX comparison: its compile dominates)."""
    rate = 0.1 if dropout else 0.0
    enc = EncoderConfig(vocab_size=256, hidden_size=32,
                        num_hidden_layers=2 if dropout else 1,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=128,
                        hidden_dropout_prob=rate,
                        attention_probs_dropout_prob=rate)
    return ICKAConfig(embedding=enc, last_encoder=enc, layer_num1=1,
                      region_dim=2048, clip_dim=16, prompt_hidden=16,
                      last_hidden=32, max_seq_length=SEQ)


def _trainer(dropout=True, **train):
    tr = ICKATrainer(_cfg(dropout), TrainConfig(**dict(TRAIN, **train)),
                     SPEC, resnet_layers=LAYERS, device="cpu")
    if not dropout:
        tr.model.map_alignment.dropout = tr.model.map_vision.dropout = 0.0
    return tr


def _gate_cl(variant, **train):
    """A `GateCLTrainer` of `variant` on `_cfg()`'s encoder (dropout on)
    whose negative swap spans the two ranks' rows."""
    cfg = GateCLConfig(encoder=_cfg().embedding, layer_num1=1,
                       region_dim=2048, max_seq_length=SEQ, variant=variant,
                       negative_rate=NEGATIVE_RATE)
    return GateCLTrainer(cfg, TrainConfig(**dict(TRAIN, **train)),
                         resnet_layers=LAYERS, device="cpu")


def _batch(rng, accum, image_size):
    """A loader batch (accum, GLOBAL_BATCH, ...) whose rows have drawn
    true lengths."""
    B, L = GLOBAL_BATCH * accum, SEQ
    lens = rng.integers(4, L + 1, B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    pmask = np.concatenate([np.ones((B, OFFSET), np.int32), mask], 1)
    batch = {
        "input_ids": rng.integers(2, 256, (B, OFFSET + L)).astype(np.int32)
        * pmask + (1 - pmask),
        "segment_ids": np.concatenate([np.zeros((B, OFFSET), np.int32),
                                       np.ones((B, L), np.int32)], 1),
        "input_mask": pmask,
        "ori_input_ids": rng.integers(2, 256, (B, L)).astype(np.int32)
        * mask + (1 - mask),
        "ori_input_mask": mask,
        "ori_segment_ids": np.zeros((B, L), np.int32),
        "img_mask": np.ones((B, 49), np.int32),
        "clip_features": rng.standard_normal((B, 1, 16)).astype(np.float32),
        "output_mask": mask,
        "label_ids": rng.integers(0, 15, (B, L)).astype(np.int32) * mask,
        "images": rng.integers(0, 255, (B, image_size, image_size, 3))
        .astype(np.uint8)}
    return {k: v.reshape(accum, GLOBAL_BATCH, *v.shape[1:])
            for k, v in batch.items()}


def _batches():
    rng = np.random.default_rng(0)
    return {"train": [_batch(rng, ACCUM, 232) for _ in range(STEPS)],
            "jax": _batch(rng, 1, 24)}


def _numpy(tensors):
    return {n: t.detach().to("cpu", copy=True).numpy()
            for n, t in tensors.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _run(tr, batches, checkpoint=None):
    """`STEPS` steps of `tr`: each step's loss, the gradients `update`
    received and the parameters after it; then this rank's second moments
    as it holds them, the gathered moments (`state_tree`), and a snapshot
    written to `checkpoint` (every rank calls `save_state`)."""
    tr.init_state(total_steps=2 * STEPS)
    grads = []
    update = tr.optimizer.update

    def capture(g, state, params):
        grads.append(_numpy(g))
        return update(g, state, params)

    tr.optimizer.update = capture
    losses, params = [], []
    for i, batch in enumerate(batches):
        record = tr.train_step(batch, (0, i))
        assert record.applied
        losses.append(record.loss)
        params.append(_numpy(dict(tr.model.named_parameters())))
    tree = tr.state_tree()["opt_state"]["1"]["0"]
    if checkpoint is not None:
        tr.save_state(Checkpointer(str(checkpoint)))
    return {"losses": losses, "grads": grads, "params": params,
            "local_nu": _numpy(tr.opt_state.nu),
            "mu": _flat(tree["mu"]), "nu": _flat(tree["nu"])}


class _Loader(list):
    """Loader batches for `fit` (which sets `epoch`)."""

    epoch = 0


def _rank_main(rank: int, out: str):
    """Every two-rank scenario; what this rank saw goes to
    `out/rank{rank}.pt`, rank 0's CLI lines to `out/cli{rank}.txt`."""
    out = Path(out)
    init_distributed("cpu", init_method=f"file://{out / 'store'}",
                     rank=rank, world=WORLD)
    batches = torch.load(out / "batches.pt", weights_only=False)
    seen = {"replicated": _run(_trainer(data_axis=2), batches["train"]),
            "zero1": _run(_trainer(data_axis=2, zero1=True),
                          batches["train"], out / "zero1"),
            "gate_cl": {v: _run(_gate_cl(v, data_axis=2), batches["train"])
                        for v in VARIANTS}}
    # a ZeRO-1 trainer resuming the snapshot keeps its own slices
    again = _trainer(data_axis=2, zero1=True)
    again.init_state(total_steps=2 * STEPS)
    tree, _ = Checkpointer(str(out / "zero1")).resume()
    again.state_from_checkpoint(tree)
    seen["resumed_nu"] = _numpy(again.opt_state.nu)
    tr = _trainer(dropout=False, data_axis=2, gradient_accumulation_steps=1)
    tr.init_state(total_steps=1)
    seen["jax_step_loss"] = tr.train_step(batches["jax"], (0, 0)).loss
    # a preemption requested on rank 1 only stops both before the first step
    lines = []
    history = _trainer(data_axis=2).fit(
        _Loader(batches["train"]), epochs=1,
        checkpointer=Checkpointer(str(out / "preempted")), log=lines.append,
        preemption_guard=SimpleNamespace(requested=rank == 1))
    seen["preempted"] = (history, lines)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        train_cli.main(["--synthetic", str(out / "corpus"), "--tiny",
                        "--device", "cpu", "--epochs_override", "1",
                        "--train_batch_size", "2", "--data_axis", "-1",
                        "--output_dir", str(out / "cli")])
    (out / f"cli{rank}.txt").write_text(text.getvalue())
    torch.save(seen, out / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    torch.save(_batches(), out / "batches.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_rank():
    return _run(_trainer(), _batches()["train"])


def _assert_one_rank_step(got, want):
    """`got`'s losses within 2e-5 relative of `want`'s and each
    all-reduced gradient leaf within 1e-5 of its max |g|."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5,
                               atol=0)
    for step, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert g.keys() == w.keys()
        floor = 1e-6 * max(float(np.abs(v).max()) for v in w.values())
        for name, leaf in w.items():
            scale = max(float(np.abs(leaf).max()), floor)
            err = float(np.abs(g[name] - leaf).max())
            assert err <= 1e-5 * scale, (step, name, err, scale)


def test_two_ranks_compute_the_one_rank_step(ranks, one_rank):
    _, seen = ranks
    for s in seen:
        _assert_one_rank_step(s["replicated"], one_rank)
    # the draws were not all the same: the second step's loss moved
    assert one_rank["losses"][0] != one_rank["losses"][1]


@pytest.mark.parametrize("variant", VARIANTS)
def test_gate_cl_two_ranks_compute_the_one_rank_step(ranks, variant):
    """Every variant, the in-batch terms included: rank 0's rows swap
    cross-modal features with rank 1's, and InfoNCE's negatives are the
    whole microbatch's. The ranks' parameters stay bit-equal."""
    perm = negative_swap_permutation(GLOBAL_BATCH, NEGATIVE_RATE)
    assert (perm[:GLOBAL_BATCH // WORLD] >= GLOBAL_BATCH // WORLD).any()
    _, (r0, r1) = ranks
    want = _run(_gate_cl(variant), _batches()["train"])
    for s in (r0, r1):
        _assert_one_rank_step(s["gate_cl"][variant], want)
    for p0, p1 in zip(r0["gate_cl"][variant]["params"],
                      r1["gate_cl"][variant]["params"]):
        for name in p0:
            np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)


@pytest.mark.parametrize("run", ["replicated", "zero1"])
def test_ranks_hold_bit_equal_parameters(ranks, run):
    _, (r0, r1) = ranks
    for p0, p1 in zip(r0[run]["params"], r1[run]["params"]):
        assert p0.keys() == p1.keys()
        for name in p0:
            np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)


def test_zero1_is_the_replicated_update_bit_for_bit(ranks):
    """Parameters after each step and the gathered moments are bit-equal;
    each ZeRO-1 rank holds its slice of every leaf the data axis divides
    (the replicated run holds every leaf whole), and a ZeRO-1 trainer that
    resumes the snapshot holds the same slices."""
    _, seen = ranks
    for rank, s in enumerate(seen):
        rep, z = s["replicated"], s["zero1"]
        for pr, pz in zip(rep["params"], z["params"]):
            for name in pr:
                np.testing.assert_array_equal(pz[name], pr[name],
                                              err_msg=name)
        for key in ("mu", "nu"):
            assert z[key].keys() == rep[key].keys()
            for name in rep[key]:
                np.testing.assert_array_equal(z[key][name], rep[key][name],
                                              err_msg=f"{key} {name}")
        shapes = {n: p.shape for n, p in rep["params"][0].items()}
        cuts = moment_slices(shapes, Mesh(WORLD, 1, rank, None,
                                          torch.device("cpu")))
        assert 0 < len(cuts) < len(shapes)
        for name, shape in shapes.items():
            assert rep["local_nu"][name].shape == shape
            dim, start, length = cuts.get(name, (0, 0, shape[0] if shape
                                                 else 0))
            want = rep["local_nu"][name]
            if name in cuts:
                want = np.take(want, range(start, start + length), axis=dim)
            np.testing.assert_array_equal(z["local_nu"][name], want,
                                          err_msg=name)
            np.testing.assert_array_equal(s["resumed_nu"][name], want,
                                          err_msg=name)


def test_two_rank_step_matches_jax_on_a_data_axis_of_two(ranks):
    """Dropout 0, no crop or flip: the port's two-rank step and the JAX
    `ICKATrainer` step on a `MeshSpec(data=2)` mesh, from the same
    weights, on the same global batch."""
    import jax
    import jax.numpy as jnp

    from icka_tpu.core import config as jconfig
    from icka_tpu.core.mesh import MeshSpec, make_mesh, shard_accum_batch
    from icka_tpu.data.features import PromptSpec as JaxPromptSpec
    from icka_tpu.parallel import shard_train_state
    from icka_tpu.train.optimizer import make_optimizer
    from icka_tpu.train.trainer import ICKATrainer as JaxTrainer
    from icka_tpu.train.trainer import ICKATrainState

    _, seen = ranks
    port = _trainer(dropout=False)
    params = jax.tree.map(jnp.asarray, icka_variables_from_state_dict(
        port.model.state_dict())["params"])
    train = dict(TRAIN, gradient_accumulation_steps=1, data_axis=2)
    jcfg = jconfig.from_json(jconfig.ICKAConfig, json.dumps(
        dataclasses.asdict(_cfg(dropout=False))))
    mesh = make_mesh(MeshSpec(data=2))
    jtr = JaxTrainer(jcfg, jconfig.TrainConfig(**train),
                     JaxPromptSpec(**dataclasses.asdict(SPEC)), mesh=mesh,
                     resnet_layers=LAYERS)
    # deterministic on the JAX side: its dropout streams cannot be matched
    jtr._loss = lambda p, b, mb, rng, t: JaxTrainer._loss(jtr, p, b, mb,
                                                          rng, False)
    state = shard_train_state(ICKATrainState.create(
        apply_fn=jtr.model.apply, params=params,
        tx=make_optimizer(jconfig.TrainConfig(**train), 1, params=params),
        backbone_variables=jax.tree.map(
            jnp.asarray, backbone_variables_from_state_dict(
                port.backbone.state_dict()))), mesh)
    _, loss = jtr.make_train_step()(
        state, shard_accum_batch(mesh, _batches()["jax"]),
        jax.random.PRNGKey(0))
    for s in seen:
        np.testing.assert_allclose(s["jax_step_loss"], float(loss),
                                   rtol=1e-4, atol=0)


def test_zero1_snapshot_resumes_in_jax(ranks):
    """The snapshot rank 0 wrote from the ZeRO-1 run restores through
    JAX's `Checkpointer.resume` into an `ICKATrainState`: step, params and
    moments bit-equal to what the run held (moments gathered)."""
    import jax
    import jax.numpy as jnp

    from icka_tpu.core import checkpoint as jckpt
    from icka_tpu.core import config as jconfig
    from icka_tpu.train.optimizer import make_optimizer
    from icka_tpu.train.trainer import ICKATrainState

    from icka_tpu.models.icka import ICKAModel as JaxICKAModel

    out, seen = ranks
    port = _trainer()
    params = jax.tree.map(jnp.asarray, icka_variables_from_state_dict(
        port.model.state_dict())["params"])
    jcfg = jconfig.from_json(jconfig.ICKAConfig, json.dumps(
        dataclasses.asdict(_cfg())))
    target = ICKATrainState.create(
        apply_fn=JaxICKAModel(jcfg).apply, params=params,
        tx=make_optimizer(jconfig.TrainConfig(**TRAIN), 2 * STEPS,
                          params=params),
        backbone_variables=jax.tree.map(
            jnp.asarray, backbone_variables_from_state_dict(
                port.backbone.state_dict())))
    restored, step = jckpt.Checkpointer(str(out / "zero1")).resume(target)
    assert step == int(restored.step) == STEPS
    z = seen[0]["zero1"]
    got = _flat(jax.device_get(restored.params))
    want = _flat(icka_variables_from_state_dict(
        {n: torch.from_numpy(v) for n, v in z["params"][-1].items()})[
            "params"])
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    adam = restored.opt_state[1][0]
    assert int(adam.count) == STEPS
    for key in ("mu", "nu"):
        moments = _flat(jax.device_get(getattr(adam, key)))
        assert moments.keys() == z[key].keys()
        for name, w in z[key].items():
            np.testing.assert_array_equal(moments[name], w,
                                          err_msg=f"{key} {name}")


def test_preemption_on_one_rank_stops_every_rank(ranks):
    """The guard's flag is agreed before the step that acts on it: both
    ranks leave `fit` before step 0, and rank 0 alone logs and writes the
    snapshot of step 0."""
    out, (r0, r1) = ranks
    assert r0["preempted"] == ([], ["preempted: saved step 0, exiting fit"])
    assert r1["preempted"] == ([], [])
    manifest = Checkpointer(str(out / "preempted")).manifest
    assert manifest["steps"] == [0] and manifest["best_step"] is None


def test_cli_trains_on_two_ranks(ranks):
    """`cli.train` in a process group of two: rank 0 alone prints the JAX
    CLI's lines and writes the checkpoint directory; 32 rows in steps of
    2 x 5 are 3 steps an epoch."""
    out, _ = ranks
    lines = (out / "cli0.txt").read_text().splitlines()
    assert len(lines) == 2, lines
    assert lines[0].startswith("epoch 0: train_loss=")
    assert lines[1].startswith("done; best dev F1 = ")
    assert (out / "cli1.txt").read_text() == ""
    manifest = Checkpointer(str(out / "cli")).manifest
    assert manifest["steps"] == [3] and manifest["best_step"] == 3
    assert (out / "cli" / "config.json").exists()
