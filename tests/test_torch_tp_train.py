"""Tensor-parallel training and evaluation on the CPU: gloo ranks on the
(data, model) meshes (1, 2), (2, 2) and (1, 4) against one rank, ZeRO-1 on the
2-D mesh against replicated, a tensor-parallel step against the JAX
package's step on one device, snapshots across mesh shapes both ways, the
training CLI with `--model_axis 2`, and the layers' tensor-parallel modes
against their whole versions.

Two process groups are started once for the module, together (`spawn`, a
`FileStore` each in the test's directory): two ranks at mesh (1, 2) and
four at (2, 2), which then train as (1, 4); each runs its scenarios and
writes what it saw to files,
while this process computes the one-rank references. The configuration is
`tests/test_multichip_grid.py`'s, as in `tests/test_torch_dp_train.py`
(global batch 8, two accumulated microbatches, drawn row lengths, dropout,
crop and flip on). Its vocabulary of 256 is split at model = 2, so the
vocabulary-parallel lookup is on the path, as are the heads, the FFN and
mapping-network columns and the cross-attention stacks; no generic kernel
is 1024 wide at this size, so the gathered Dense is held on its own.

The bounds are `tests/test_torch_dp_train.py`'s: losses within 2e-5
relative of one rank's, and each gradient within 1e-5 of its leaf's max
|g| (a rank's gradient of a split leaf against that slice of the
one-rank gradient). Replicated leaves are bit-equal on every rank after
each step, split leaves bit-equal on the data ranks of one model index,
and every rank holds exactly the slices `param_partition_specs` and
`zero1_moment_specs` give it. The JAX package is imported by the tests
only, never by a rank.
"""

import contextlib
import dataclasses
import io
import json
import multiprocessing as mp
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from icka_tpu_torch.cli import train as train_cli
from icka_tpu_torch.convert import (backbone_variables_from_state_dict,
                                    icka_variables_from_state_dict)
from icka_tpu_torch.core.checkpoint import Checkpointer
from icka_tpu_torch.core.config import EncoderConfig
from icka_tpu_torch.core.mesh import (Mesh, MeshSpec, draw, init_distributed,
                                      make_mesh)
from icka_tpu_torch.nn.attention import (CrossAttentionLayer, FeedForward,
                                         SelfAttentionLayer)
from icka_tpu_torch.nn.bert import TextEmbeddings
from icka_tpu_torch.nn.layers import Dense, additive_mask, dropout
from icka_tpu_torch.parallel.partitioning import (cut, param_partition_specs,
                                                  zero1_moment_specs)
from icka_tpu_torch.parallel.tensor import tensor_parallel
from tests.test_torch_dp_train import (SPEC, STEPS, TRAIN,
                                       _assert_one_rank_step, _batch, _cfg,
                                       _flat, _gate_cl, _numpy, _run,
                                       _trainer)

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
GROUPS = ("1x2", "2x2")        # the process groups; "1x4" runs in "2x2"
VARIANTS = ("ip", "cl", "gate_cl")
REMAT_POLICIES = ("dots", "dots_nb", "alternate", "full")
WIDE = 1024                  # the generic rule's least split output width


def _remat_trainer(policy, **train):
    """`_trainer()` with both self-attention stacks rematerialised under
    `policy`."""
    cfg = _cfg()
    enc = dataclasses.replace(cfg.embedding, remat=True, remat_policy=policy)
    from icka_tpu_torch.train.trainer import ICKATrainer
    return ICKATrainer(dataclasses.replace(cfg, embedding=enc,
                                           last_encoder=enc),
                       _train_cfg(**train), SPEC, resnet_layers=(1, 1, 1, 1),
                       device="cpu")


def _fused_cfg(dropout=True):
    """`_cfg` with a fused qkv and a Pfeiffer adapter in both
    self-attention stacks (the qkv's 96 outputs and the adapter stay
    replicated at this width; `_AttnLayers` holds them split)."""
    cfg = _cfg(dropout)
    enc = dataclasses.replace(cfg.embedding, fuse_qkv=True, adapter_size=8)
    return dataclasses.replace(cfg, embedding=enc, last_encoder=enc)


def _fused_trainer(dropout=True, use_pallas=False, **train):
    from icka_tpu_torch.train.trainer import ICKATrainer
    cfg = _fused_cfg(dropout)
    enc = dataclasses.replace(cfg.embedding, use_pallas=use_pallas)
    tr = ICKATrainer(dataclasses.replace(cfg, embedding=enc,
                                         last_encoder=enc),
                     _train_cfg(**train), SPEC, resnet_layers=(1, 1, 1, 1),
                     device="cpu")
    if not dropout:
        tr.model.map_alignment.dropout = tr.model.map_vision.dropout = 0.0
    return tr


def _train_cfg(**train):
    from icka_tpu_torch.core.config import TrainConfig
    return TrainConfig(**dict(TRAIN, **train))


def _eval_trainer(**train):
    """A trainer whose self-attention stacks run K1 when deterministic
    (its plain version on the CPU)."""
    cfg = _cfg()
    enc = dataclasses.replace(cfg.embedding, use_pallas=True)
    from icka_tpu_torch.train.trainer import ICKATrainer
    return ICKATrainer(dataclasses.replace(cfg, embedding=enc,
                                           last_encoder=enc),
                       _train_cfg(**train), SPEC, resnet_layers=(1, 1, 1, 1),
                       device="cpu")


def _fused_eval_trainer(**train):
    """`_eval_trainer` with `_fused_cfg`'s stacks: K1 on q, k and v read
    as views of the fused projection."""
    return _fused_trainer(use_pallas=True, **train)


def _eval_batches():
    """Two evaluation batches of 8 rows (no crop: eval preprocessing)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        b = {k: v[0] for k, v in _batch(rng, 1, 24).items()}
        b["row_valid"] = np.ones(len(b["label_ids"]), bool)
        out.append(b)
    return out


def _evaluation(tr):
    """The trainer's evaluation: each batch's `eval_step` tags and the
    `evaluate` result's numbers."""
    batches = _eval_batches()
    tags = []
    for b in batches:
        b = {k: v for k, v in b.items() if k != "row_valid"}
        tags.append(tr.eval_step(b)[0].numpy())
    res = tr.evaluate(batches)
    return {"tags": tags, "result": (res.f1, res.loss, res.rows)}


class _Layers(nn.Module):
    """A FeedForward (a column/row pair), a Dense whose 1024 outputs the
    generic rule splits (gathered) and the embeddings (vocabulary of 256:
    vocabulary-parallel), under names the specs match."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(5)
        self.ffn = FeedForward(32, 64, 1e-12, device="cpu", generator=gen)
        self.proj = Dense(16, WIDE, device="cpu", generator=gen)
        self.emb = TextEmbeddings(EncoderConfig.tiny(256), device="cpu",
                                  generator=gen)
        for p in self.parameters():         # biases away from zero
            if p.ndim == 1:
                with torch.no_grad():
                    p.normal_(0.0, 0.1, generator=gen)


def _layer_inputs():
    gen = torch.Generator().manual_seed(6)
    return (torch.randn(2, 5, 32, generator=gen),
            torch.randn(2, 5, 16, generator=gen),
            torch.randint(0, 256, (2, 5), generator=gen),
            [torch.randn(2, 5, n, generator=gen) for n in (32, WIDE, 32)])


def _layers_run(mesh=None):
    """Outputs, input gradients and parameter gradients of `_Layers` (on
    `mesh`'s model axis: this rank's slices, the partial leaves' gradients
    summed over the model group)."""
    layers = _Layers()
    layout = tensor_parallel(layers, mesh) if mesh is not None else None
    x, x16, ids, weights = _layer_inputs()
    x.requires_grad_(True)
    x16.requires_grad_(True)
    outs = (layers.ffn(x), layers.proj(x16), layers.emb.embed_tokens(ids))
    sum((o * w).sum() for o, w in zip(outs, weights)).backward()
    grads = {n: p.grad for n, p in layers.named_parameters()
             if p.grad is not None}
    if layout is not None:
        layout.sum_partial_(grads)
    return {"outs": [o.detach() for o in outs],
            "inputs": [x.grad, x16.grad], "grads": _numpy(grads),
            "modes": (layers.ffn.wi.mode, layers.ffn.wo.mode,
                      layers.proj.mode,
                      layers.emb.vocab_shard is not None)}


def _attn_cfg(hidden, heads, **kw):
    return dataclasses.replace(EncoderConfig.tiny(256), hidden_size=hidden,
                               num_attention_heads=heads,
                               intermediate_size=2 * hidden, **kw)


ATTN_LAYERS = {
    # 3H = 1152 >= 1024: qkv split by the generic rule and gathered; the
    # heads divide at model 2 (3 a rank) and do not at 4
    "fused": lambda gen: SelfAttentionLayer(
        _attn_cfg(384, 6, fuse_qkv=True, use_pallas=True), device="cpu",
        generator=gen),
    # 3H = 96: qkv replicated, the heads' columns cut out of it
    "fused_tiny": lambda gen: SelfAttentionLayer(
        _attn_cfg(32, 4, fuse_qkv=True, use_pallas=True), device="cpu",
        generator=gen),
    # 3 heads of 8: q, k and v split (24 divides) but not the heads
    "uneven": lambda gen: SelfAttentionLayer(
        _attn_cfg(24, 3, use_pallas=True), device="cpu", generator=gen),
    "uneven_cross": lambda gen: CrossAttentionLayer(
        _attn_cfg(24, 3), device="cpu", generator=gen),
    # adapter_up's 1024 outputs split by the generic rule, adapter_down not
    "adapter": lambda gen: FeedForward(WIDE, 64, 1e-12, adapter_size=8,
                                       device="cpu", generator=gen),
}


def _attn_layers_run(name, mesh=None):
    """One of `ATTN_LAYERS` whole or on `mesh`'s model axis: its output
    with dropout (a generator of one seed on every rank) and without (K1's
    path where the layer has it), the input gradients and this rank's
    parameter gradients (partial leaves summed over the model group), and
    how the layout set the layer's Dense layers."""
    gen = torch.Generator().manual_seed(8)
    layer = ATTN_LAYERS[name](gen)
    for p in layer.parameters():                 # biases away from zero
        if p.ndim == 1:
            with torch.no_grad():
                p.normal_(0.0, 0.1, generator=gen)
    layout = tensor_parallel(layer, mesh) if mesh is not None else None
    width = layer.wi.weight.shape[1] if name == "adapter" else (
        layer.attn_out.dense.weight.shape[0])
    x = torch.randn(2, 5, width, generator=gen, requires_grad=True)
    kv = torch.randn(2, 7, width, generator=gen, requires_grad=True)
    weight = torch.randn(2, 5, width, generator=gen)
    args = {"adapter": (x,), "uneven_cross": (x, kv, additive_mask(
        torch.tensor([[1] * 7, [1] * 4 + [0] * 3])))}.get(name, (
            x, additive_mask(torch.tensor([[1] * 5, [1] * 3 + [0] * 2]))))
    out = layer(*args, dropout_gen=torch.Generator().manual_seed(9))
    (out * weight).sum().backward()
    with torch.no_grad():
        plain = layer(*args)
    grads = {n: p.grad for n, p in layer.named_parameters()
             if p.grad is not None}
    if layout is not None:
        layout.sum_partial_(grads)
    modes = {n: m.mode for n, m in layer.named_modules()
             if isinstance(m, Dense)}
    return {"outs": [out.detach(), plain],
            "inputs": [x.grad] + ([kv.grad] if name == "uneven_cross"
                                  else []),
            "grads": _numpy(grads), "modes": modes,
            "heads": None if name == "adapter" else layer.attn.local_heads}


def _tp_run(tr, batches, checkpoint=None):
    """`_run` plus the parameters gathered to the whole layout
    (`state_tree`) and the local shapes this rank holds."""
    seen = _run(tr, batches, checkpoint)
    seen["tree_params"] = _flat(tr.state_tree()["params"])
    seen["local_mu"] = _numpy(tr.opt_state.mu)
    return seen


def _cli(out: Path, rank: int, flags: list) -> None:
    """`cli.train` on the tiny synthetic corpus with `flags`, every rank
    of the group; rank 0's lines go to `out/cli{rank}.txt`."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        train_cli.main(["--synthetic", str(out / "corpus"), "--tiny",
                        "--device", "cpu", "--epochs_override", "1",
                        "--train_batch_size", "2", "--data_axis", "-1",
                        "--output_dir", str(out / "cli"), *flags])
    (out / f"cli{rank}.txt").write_text(text.getvalue())


def _rank_main(rank: int, world: int, model: int, out: str):
    """Every scenario of one mesh; what this rank saw goes to
    `out/rank{rank}.pt`, rank 0's CLI lines to `out/cli{rank}.txt`."""
    out = Path(out)
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{out / 'store'}",
                     rank=rank, world=world)
    data = world // model
    mesh = make_mesh(MeshSpec(data=data, model=model), device="cpu")
    batches = torch.load(out.parent / "batches.pt", weights_only=False)
    axes = dict(data_axis=data, model_axis=model)
    seen = {"coords": (mesh.rank, mesh.model_rank),
            "replicated": _tp_run(_trainer(**axes), batches["train"],
                                  out / "snapshot")}
    if data > 1:
        seen["zero1"] = _tp_run(_trainer(zero1=True, **axes),
                                batches["train"])
        # the same four ranks as one model axis of four
        wide = dict(data_axis=1, model_axis=world)
        seen["1x4"] = {
            "coords": (0, rank),
            "replicated": _tp_run(_trainer(**wide), batches["train"]),
            "gate_cl": {"gate_cl": _run(_gate_cl("gate_cl", **wide),
                                        batches["train"])},
            "fused": _run(_fused_trainer(**wide), batches["train"])}
        wide_mesh = make_mesh(MeshSpec(data=1, model=world), device="cpu")
        seen["1x4"]["attn_layers"] = {
            name: _attn_layers_run(name, wide_mesh) for name in ATTN_LAYERS}
        _cli(out, rank, ["--model", "gate_cl", "--model_axis", str(world)])
        torch.save(seen, out / f"rank{rank}.pt")
        dist.destroy_process_group()
        return
    seen["gate_cl"] = {v: _run(_gate_cl(v, **axes), batches["train"])
                       for v in VARIANTS}
    tr = _trainer(dropout=False, gradient_accumulation_steps=1, **axes)
    tr.init_state(total_steps=1)
    seen["jax_step_loss"] = tr.train_step(batches["jax"], (0, 0)).loss
    seen["remat"] = {policy: _run(_remat_trainer(policy, **axes),
                                  batches["train"][:1])
                     for policy in REMAT_POLICIES}
    seen["evaluation"] = _evaluation(_eval_trainer(**axes))
    seen["fused"] = _run(_fused_trainer(**axes), batches["train"])
    tr = _fused_trainer(dropout=False, gradient_accumulation_steps=1, **axes)
    tr.init_state(total_steps=1)
    seen["fused_jax_step_loss"] = tr.train_step(batches["jax"], (0, 0)).loss
    seen["fused_evaluation"] = _evaluation(_fused_eval_trainer(**axes))
    # the one-rank snapshot resumed here
    again = _trainer(**axes)
    again.init_state(total_steps=2 * STEPS)
    tree, _ = Checkpointer(str(out.parent / "one_rank")).resume()
    again.state_from_checkpoint(tree)
    seen["resumed"] = {"params": _numpy(again.params()),
                       "mu": _numpy(again.opt_state.mu),
                       "nu": _numpy(again.opt_state.nu),
                       "step": again.step}
    seen["layers"] = _layers_run(mesh)
    seen["attn_layers"] = {name: _attn_layers_run(name, mesh)
                           for name in ATTN_LAYERS}
    _cli(out, rank, ["--model_axis", str(model)])
    torch.save(seen, out / f"rank{rank}.pt")
    dist.destroy_process_group()


def _one_rank(root):
    """The one-rank references of the spawned scenarios."""
    batches = torch.load(root / "batches.pt", weights_only=False)
    return {"replicated": _run(_trainer(), batches["train"]),
            "gate_cl": {v: _run(_gate_cl(v), batches["train"])
                        for v in VARIANTS},
            "evaluation": _evaluation(_eval_trainer()),
            "fused": _run(_fused_trainer(), batches["train"]),
            "fused_evaluation": _evaluation(_fused_eval_trainer()),
            "layers": _layers_run(),
            "attn_layers": {name: _attn_layers_run(name)
                            for name in ATTN_LAYERS}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks, started together, and the one-rank references
    computed meanwhile: (root, {mesh: [rank records]}, references)."""
    from tests.test_torch_dp_train import _batches

    root = tmp_path_factory.mktemp("tp")
    torch.save(_batches(), root / "batches.pt")
    # the one-rank snapshot the (1, 2) ranks resume: the reference run's
    first = _trainer()
    first_seen = _run(first, _batches()["train"], root / "one_rank")
    ctx = mp.get_context("spawn")
    procs = {}
    for name in GROUPS:
        data, model = MESHES[name]
        (root / name).mkdir()
        procs[name] = [ctx.Process(target=_rank_main,
                                   args=(r, data * model, model,
                                         str(root / name)))
                       for r in range(data * model)]
        for p in procs[name]:
            p.start()
    refs = _one_rank(root)
    refs["jax_loss"] = _jax_step_loss()
    refs["fused_jax_loss"] = _jax_step_loss(_fused_cfg, _fused_trainer)
    refs["first"] = first_seen
    refs["first_state"] = {"params": _numpy(first.params()),
                           "mu": _numpy(first.opt_state.mu),
                           "nu": _numpy(first.opt_state.nu)}
    for ps in procs.values():
        for p in ps:
            p.join(240)
            if p.is_alive():
                p.kill()
    codes = {n: [p.exitcode for p in ps] for n, ps in procs.items()}
    assert codes == {n: [0] * len(ps) for n, ps in procs.items()}, codes
    seen = {n: [torch.load(root / n / f"rank{r}.pt", weights_only=False)
                for r in range(len(ps))] for n, ps in procs.items()}
    seen["1x4"] = [s.pop("1x4") for s in seen["2x2"]]
    return root, seen, refs


def _mesh_of(name, rank):
    data, model = MESHES[name]
    return Mesh(data, model, rank // model, None, torch.device("cpu"),
                model_rank=rank % model)


def _sliced(tree, mesh, specs):
    """Each leaf of a whole {name: array} cut to `mesh`'s slice."""
    return {n: cut(torch.from_numpy(np.asarray(v)), specs[n], mesh).numpy()
            for n, v in tree.items()}


def _model_slices(run, mesh):
    """A one-rank run's gradients cut to `mesh`'s model slices."""
    specs = param_partition_specs({n: v.shape for n, v in
                                   run["grads"][0].items()}, mesh.model)
    return dict(run, grads=[_sliced(g, mesh, specs) for g in run["grads"]])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_ranks_compute_the_one_rank_step(runs, mesh):
    """Losses and each rank's gradient slices against one rank; the
    parameters each rank holds are its spec slices, and bit-equal where
    the mesh holds them twice; the gathered state has the one-rank
    layout, each rank's slice of it bit-equal to what the rank holds."""
    _, seen, refs = runs
    one = refs["replicated"]
    shapes = {n: v.shape for n, v in one["params"][0].items()}
    specs = param_partition_specs(shapes, MESHES[mesh][1])
    split = {n for n, s in specs.items() if "model" in s}
    assert {"embedding.embeddings.word_embeddings",
            "txt2img.layer_0.attn.key.weight",
            "map_vision.wi.weight",
            "last_encoder.encoder.layer_0.ffn.wo.weight"} <= split
    for rank, s in enumerate(seen[mesh]):
        m = _mesh_of(mesh, rank)
        assert s["coords"] == (m.rank, m.model_rank)
        run = s["replicated"]
        _assert_one_rank_step(run, _model_slices(one, m))
        assert {n: v.shape for n, v in run["params"][0].items()} == {
            n: cut(torch.empty(shp), specs[n], m).shape
            for n, shp in shapes.items()}
        tree = run["tree_params"]
        flax = _flat(icka_variables_from_state_dict(
            {n: torch.from_numpy(v) for n, v in one["params"][-1].items()})[
                "params"])
        assert {n: v.shape for n, v in tree.items()} == {
            n: v.shape for n, v in flax.items()}
        port = {n: v for n, v in _numpy(_state_dict(tree)).items()}
        for name, want in _sliced(port, m, specs).items():
            np.testing.assert_array_equal(run["params"][-1][name], want,
                                          err_msg=name)
        for other, o in enumerate(seen[mesh]):
            same_model = _mesh_of(mesh, other).model_rank == m.model_rank
            for step, (p0, p1) in enumerate(zip(run["params"],
                                                o["replicated"]["params"])):
                for name in p0:
                    if name not in split or same_model:
                        np.testing.assert_array_equal(
                            p0[name], p1[name],
                            err_msg=f"{name} ranks {rank}/{other} {step}")


def _state_dict(flat):
    """A flat flax tree {"a/b/kernel": array} as the port's state dict."""
    from icka_tpu_torch.convert import state_dict_from_flax
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return state_dict_from_flax(tree)


def test_zero1_on_a_2d_mesh_is_the_replicated_update(runs):
    """At (2, 2): parameters after each step and the gathered moments
    bit-equal to the replicated run's; each rank holds its data slice of
    its model slice of every moment leaf, as `zero1_moment_specs` cuts."""
    _, seen, refs = runs
    shapes = {n: v.shape for n, v in refs["replicated"]["params"][0].items()}
    specs = zero1_moment_specs(shapes, 2, 2)
    assert any("model" in s and "data" in s for s in specs.values())
    for rank, s in enumerate(seen["2x2"]):
        rep, z = s["replicated"], s["zero1"]
        for pr, pz in zip(rep["params"], z["params"]):
            for name in pr:
                np.testing.assert_array_equal(pz[name], pr[name],
                                              err_msg=name)
        for key in ("mu", "nu"):
            for name in rep[key]:
                np.testing.assert_array_equal(z[key][name], rep[key][name],
                                              err_msg=f"{key} {name}")
        m = _mesh_of("2x2", rank)
        for name, shape in shapes.items():
            want = cut(torch.empty(shape), specs[name], m).shape
            assert z["local_nu"][name].shape == want, name
            assert z["local_mu"][name].shape == want, name
        np.testing.assert_array_equal(
            z["local_nu"]["map_vision.wi.weight"],
            _sliced({"w": rep["nu"]["map_vision/wi/kernel"].T}, m,
                    {"w": specs["map_vision.wi.weight"]})["w"])


@pytest.mark.parametrize("mesh,variant", [("1x2", v) for v in VARIANTS]
                         + [("1x4", "gate_cl")])
def test_gate_cl_tp_ranks_compute_the_one_rank_step(runs, mesh, variant):
    """Every gate_cl variant at (1, 2), and "gate_cl" at (1, 4): the BERT
    vocabulary-parallel lookup, the encoder's and txt2img's heads and
    columns."""
    _, seen, refs = runs
    want = refs["gate_cl"][variant]
    for rank, s in enumerate(seen[mesh]):
        _assert_one_rank_step(s["gate_cl"][variant],
                              _model_slices(want, _mesh_of(mesh, rank)))


def _jax_step_loss(make_cfg=_cfg, make_trainer=_trainer):
    """Dropout 0, no crop or flip: the JAX `ICKATrainer` step's loss on a
    one-device mesh, from the weights of `make_trainer(dropout=False)`
    (configuration `make_cfg(dropout=False)`), on the batch the ranks take
    their dropout-free step on."""
    import jax
    import jax.numpy as jnp

    from icka_tpu.core import config as jconfig
    from icka_tpu.core.mesh import MeshSpec as JaxMeshSpec
    from icka_tpu.core.mesh import make_mesh as jax_make_mesh
    from icka_tpu.core.mesh import shard_accum_batch
    from icka_tpu.data.features import PromptSpec as JaxPromptSpec
    from icka_tpu.train.optimizer import make_optimizer
    from icka_tpu.train.trainer import ICKATrainer as JaxTrainer
    from icka_tpu.train.trainer import ICKATrainState
    from tests.test_torch_dp_train import LAYERS, _batches

    port = make_trainer(dropout=False)
    params = jax.tree.map(jnp.asarray, icka_variables_from_state_dict(
        port.model.state_dict())["params"])
    train = dict(TRAIN, gradient_accumulation_steps=1, data_axis=1)
    jcfg = jconfig.from_json(jconfig.ICKAConfig, json.dumps(
        dataclasses.asdict(make_cfg(dropout=False))))
    mesh = jax_make_mesh(JaxMeshSpec(data=1), devices=jax.devices()[:1])
    jtr = JaxTrainer(jcfg, jconfig.TrainConfig(**train),
                     JaxPromptSpec(**dataclasses.asdict(SPEC)), mesh=mesh,
                     resnet_layers=LAYERS)
    # deterministic on the JAX side: its dropout streams cannot be matched
    jtr._loss = lambda p, b, mb, rng, t: JaxTrainer._loss(jtr, p, b, mb,
                                                          rng, False)
    state = ICKATrainState.create(
        apply_fn=jtr.model.apply, params=params,
        tx=make_optimizer(jconfig.TrainConfig(**train), 1, params=params),
        backbone_variables=jax.tree.map(
            jnp.asarray, backbone_variables_from_state_dict(
                port.backbone.state_dict())))
    _, loss = jtr.make_train_step()(
        state, shard_accum_batch(mesh, _batches()["jax"]),
        jax.random.PRNGKey(0))
    return float(loss)


def test_tp_step_matches_jax_on_one_device(runs):
    """The (1, 2) step's loss within 1e-4 relative of the JAX step's on
    one device (`_jax_step_loss`, computed while the ranks run)."""
    _, seen, refs = runs
    for s in seen["1x2"]:
        np.testing.assert_allclose(s["jax_step_loss"], refs["jax_loss"],
                                   rtol=1e-4, atol=0)


def test_tp_snapshot_resumes_in_one_rank_and_in_jax(runs):
    """The snapshot rank 0 of (1, 2) wrote: a one-rank port trainer
    resumes it to the gathered state, and JAX's `Checkpointer.resume`
    restores it leaf for leaf bit-equal; the one-rank snapshot resumed at
    (1, 2) gives each rank its slices of the one-rank state bit for bit."""
    import jax
    import jax.numpy as jnp

    from icka_tpu.core import checkpoint as jckpt
    from icka_tpu.core import config as jconfig
    from icka_tpu.models.icka import ICKAModel as JaxICKAModel
    from icka_tpu.train.optimizer import make_optimizer
    from icka_tpu.train.trainer import ICKATrainState

    root, seen, refs = runs
    run = seen["1x2"][0]["replicated"]
    single = _trainer()
    single.init_state(total_steps=2 * STEPS)
    tree, step = Checkpointer(str(root / "1x2" / "snapshot")).resume()
    single.state_from_checkpoint(tree)
    assert step == single.step == STEPS
    got = _flat(icka_variables_from_state_dict(single.model.state_dict())[
        "params"])
    for name, want in run["tree_params"].items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    params = jax.tree.map(jnp.asarray, icka_variables_from_state_dict(
        _trainer().model.state_dict())["params"])
    target = ICKATrainState.create(
        apply_fn=JaxICKAModel(jconfig.from_json(
            jconfig.ICKAConfig, json.dumps(dataclasses.asdict(_cfg())))).apply,
        params=params,
        tx=make_optimizer(jconfig.TrainConfig(**TRAIN), 2 * STEPS,
                          params=params),
        backbone_variables=jax.tree.map(
            jnp.asarray, backbone_variables_from_state_dict(
                single.backbone.state_dict())))
    restored, step = jckpt.Checkpointer(str(root / "1x2" / "snapshot")
                                        ).resume(target)
    assert step == int(restored.step) == STEPS
    got = _flat(jax.device_get(restored.params))
    assert got.keys() == run["tree_params"].keys()
    for name, want in run["tree_params"].items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    adam = restored.opt_state[1][0]
    for key in ("mu", "nu"):
        moments = _flat(jax.device_get(getattr(adam, key)))
        assert moments.keys() == run[key].keys()
        for name, want in run[key].items():
            np.testing.assert_array_equal(moments[name], want,
                                          err_msg=f"{key} {name}")
    first = refs["first_state"]
    specs = param_partition_specs({n: v.shape for n, v in
                                   first["params"].items()}, 2)
    for rank, s in enumerate(seen["1x2"]):
        assert s["resumed"]["step"] == STEPS
        m = _mesh_of("1x2", rank)
        for key in ("params", "mu", "nu"):
            for name, want in _sliced(first[key], m, specs).items():
                np.testing.assert_array_equal(s["resumed"][key][name], want,
                                              err_msg=f"{key} {name}")


def test_tp_evaluation_tags_equal_one_rank(runs):
    """K1's path (its plain version here) on each rank's local heads:
    every batch's tags identical to one rank's, and `evaluate`'s F1 and
    rows; its loss within 1e-5 relative."""
    _, seen, refs = runs
    want = refs["evaluation"]
    for s in seen["1x2"]:
        got = s["evaluation"]
        for a, b in zip(got["tags"], want["tags"]):
            np.testing.assert_array_equal(a, b)
        assert got["result"][0] == want["result"][0]
        assert got["result"][2] == want["result"][2] == 16
        np.testing.assert_allclose(got["result"][1], want["result"][1],
                                   rtol=1e-5)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_tp_step_under_remat_equals_the_plain_step(runs, policy):
    """Remat on both stacks at (1, 2), under each policy (selective for
    "dots" and "dots_nb"): the recompute replays the layers' collectives
    on both ranks in the same order; the loss and every gradient as
    without remat, bit for bit."""
    _, seen, _ = runs
    for s in seen["1x2"]:
        got, plain = s["remat"][policy], s["replicated"]
        assert got["losses"] == plain["losses"][:1]
        for name, g in plain["grads"][0].items():
            np.testing.assert_array_equal(got["grads"][0][name], g,
                                          err_msg=name)


@pytest.mark.parametrize("group", GROUPS)
def test_cli_trains_with_a_model_axis(runs, group):
    """`cli.train --model_axis 2` on two ranks (the flagship) and
    `--model gate_cl --model_axis 4` on four: rank 0 alone prints the
    lines and writes the checkpoint directory in the JAX layout, which a
    one-rank `Checkpointer` reads."""
    root, seen, _ = runs
    out = root / group
    lines = (out / "cli0.txt").read_text().splitlines()
    assert len(lines) == 2, lines
    assert lines[0].startswith("epoch 0: train_loss=")
    assert lines[1].startswith("done; best dev F1 = ")
    for rank in range(1, len(seen[group])):
        assert (out / f"cli{rank}.txt").read_text() == ""
    manifest = Checkpointer(str(out / "cli")).manifest
    assert manifest["steps"] == [3] and manifest["best_step"] == 3


def _assert_layer_equal(got, want, mesh, rank, atol):
    """Outputs, input gradients and this rank's parameter gradients (a
    slice of the whole layer's where the specs split the leaf) within
    `atol`."""
    assert len(got["outs"] + got["inputs"]) == len(
        want["outs"] + want["inputs"])
    for a, b in zip(got["outs"] + got["inputs"],
                    want["outs"] + want["inputs"]):
        torch.testing.assert_close(a, b, rtol=0, atol=atol)
    specs = param_partition_specs(
        {n: v.shape for n, v in want["grads"].items()}, MESHES[mesh][1])
    sliced = _sliced(want["grads"], _mesh_of(mesh, rank), specs)
    assert got["grads"].keys() == sliced.keys()
    for name, w in sliced.items():
        np.testing.assert_allclose(got["grads"][name], w, rtol=0, atol=atol,
                                   err_msg=name)


# each attention layer's Dense modes and heads a rank runs, at model 2 and 4
ATTN_LAYOUTS = {
    "fused": ({"attn.qkv": "gather", "attn_out.dense": "row",
               "ffn.wi": "column", "ffn.wo": "row"}, {2: 3, 4: 6}),
    "fused_tiny": ({"attn.qkv": None, "attn_out.dense": "row",
                    "ffn.wi": "column", "ffn.wo": "row"}, {2: 2, 4: 1}),
    "uneven": ({"attn.query": "gather", "attn.key": "gather",
                "attn.value": "gather", "attn_out.dense": "row",
                "ffn.wi": "column", "ffn.wo": "row"}, {2: 3, 4: 3}),
    "adapter": ({"wi": "column", "wo": "row", "adapter_down": None,
                 "adapter_up": "gather"}, {2: None, 4: None}),
}
ATTN_LAYOUTS["uneven_cross"] = ATTN_LAYOUTS["uneven"]


def _assert_attn_layer(runs, mesh, name):
    """`ATTN_LAYERS[name]` on each rank of `mesh` against the whole layer
    (1e-5: the layers are up to 1024 wide), with the layout it took."""
    _, seen, refs = runs
    modes, heads = ATTN_LAYOUTS[name]
    for rank, s in enumerate(seen[mesh]):
        got = s["attn_layers"][name]
        assert got["modes"] == modes
        assert got["heads"] == heads[MESHES[mesh][1]]
        _assert_layer_equal(got, refs["attn_layers"][name], mesh, rank, 1e-5)


def test_layers_tp_modes_equal_the_whole_layers(runs):
    """The column/row pair (a FeedForward), the gathered Dense of 1024
    outputs and the vocabulary-parallel lookup on two ranks: outputs,
    input gradients and each rank's parameter gradients (the partial
    biases summed over the model group) within 1e-6 of the whole
    layers'. Then the layouts that were refused: a fused qkv split by
    the generic rule and gathered, and replicated, each read at the
    rank's heads; 3 heads on 2 ranks in self- and cross-attention; the
    adapter with its `adapter_up` gathered."""
    _, seen, refs = runs
    for rank, s in enumerate(seen["1x2"]):
        got = s["layers"]
        assert got["modes"] == ("column", "row", "gather", True)
        _assert_layer_equal(got, refs["layers"], "1x2", rank, 1e-6)
    for name in ATTN_LAYERS:
        _assert_attn_layer(runs, "1x2", name)


@pytest.mark.parametrize("name", list(ATTN_LAYERS))
def test_attention_layouts_on_four_ranks(runs, name):
    """The same layers at (1, 4): the fused qkv of 6 heads and the 3-head
    layers every head on every rank, the tiny fused one a head a rank."""
    _assert_attn_layer(runs, "1x4", name)


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_tp_fused_qkv_and_adapter_step_equals_one_rank(runs, mesh):
    """`_fused_cfg` (a fused qkv and an adapter in both stacks, dropout
    on): losses and each rank's gradient slices against one rank's."""
    _, seen, refs = runs
    for rank, s in enumerate(seen[mesh]):
        _assert_one_rank_step(s["fused"], _model_slices(
            refs["fused"], _mesh_of(mesh, rank)))


def test_tp_fused_qkv_and_adapter_step_matches_jax(runs):
    """The (1, 2) step of `_fused_cfg` without dropout within 1e-4
    relative of the JAX step of the same configuration on one device."""
    _, seen, refs = runs
    for s in seen["1x2"]:
        np.testing.assert_allclose(s["fused_jax_step_loss"],
                                   refs["fused_jax_loss"], rtol=1e-4, atol=0)


def test_tp_fused_evaluation_tags_equal_one_rank(runs):
    """K1's path (its plain version here) on the rank's heads read out of
    the fused projection: tags identical to one rank's, F1 and rows
    equal, the loss within 1e-5 relative."""
    _, seen, refs = runs
    want = refs["fused_evaluation"]
    for s in seen["1x2"]:
        got = s["fused_evaluation"]
        for a, b in zip(got["tags"], want["tags"]):
            np.testing.assert_array_equal(a, b)
        assert got["result"][0] == want["result"][0]
        assert got["result"][2] == want["result"][2] == 16
        np.testing.assert_allclose(got["result"][1], want["result"][1],
                                   rtol=1e-5)


@pytest.mark.parametrize("dim", [1, -1])
def test_cut_draws_are_the_whole_draws_sliced(dim):
    """A dropout mask drawn for a model slice (heads, dim 1; columns, the
    last) is the whole draw's slice, with and without a data split of the
    rows."""
    from icka_tpu_torch.core.mesh import RowDraws

    shape = [4, 6, 3, 5]
    n = shape[dim] // 2
    full = dropout(torch.ones(shape), 0.5, torch.Generator().manual_seed(1))
    part = [slice(None)] * 4
    part[dim] = slice(n, 2 * n)
    local = list(shape)
    local[dim] = n
    got = dropout(torch.ones(local), 0.5, torch.Generator().manual_seed(1),
                  cut=(dim, n, shape[dim]))
    assert torch.equal(got, full[tuple(part)])
    rows = RowDraws(torch.Generator().manual_seed(1), 2, 4, 4)
    local[0] = 2
    got = draw(lambda s, g: torch.rand(s, generator=g), local, rows,
               cut=(dim, n, shape[dim]))
    whole = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    part[0] = slice(2, 4)
    assert torch.equal(got, whole[tuple(part)])


def _refused(case):
    """What a model axis refuses, on a mesh of one process (the layout
    is set without a collective)."""
    mesh = Mesh(1, 2, 0, None, torch.device("cpu"), model_rank=0)
    if case == "int8":
        return tensor_parallel(FeedForward(32, 64, 1e-12, quant="int8_static",
                                           device="cpu"), mesh)
    from icka_tpu_torch.models.icka import ICKAModel
    from icka_tpu_torch.serving.bucketed import BucketedICKAServer
    icka = ICKAModel(_cfg(), device="cpu", seed=0)
    tensor_parallel(icka, mesh)
    return BucketedICKAServer(icka, buckets=(16,), max_batch=2,
                              device="cpu")


@pytest.mark.parametrize("case,kind,match", [
    ("int8", NotImplementedError, "int8"),
    ("server", ValueError, "tensor-parallel")])
def test_model_axis_refusals(case, kind, match):
    """An int8 Dense (serving buffers, never trained) and a server given a
    rank's slices of a model."""
    with pytest.raises(kind, match=match):
        _refused(case)
