"""The port's data axis on the CPU: the spec functions against the JAX
package's, the mesh, the row draws, the collectives, data-parallel serving
and the kernel build's lock.

Two gloo ranks on the CPU are started once for the module (`spawn`, a
`FileStore` in the test's directory, so parallel workers never share a
port) and run every multi-rank scenario in that one start: the kernel
build raced by both ranks against a stand-in `nvcc`, `init_distributed`,
the collectives, `make_mesh` over two ranks, and both bucketed servers
with `mesh=` on the tiny configs of `tests/test_serving_dp.py`. Each rank
writes what it saw to a file; the tests hold it against the single-process
answers. The JAX package is imported by the tests only, never by a rank.
"""

import json
import multiprocessing as mp
import stat
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from icka_tpu_torch.core.config import EncoderConfig, GateCLConfig, ICKAConfig
from icka_tpu_torch.core.dtypes import DTypePolicy
from icka_tpu_torch.core.mesh import (Mesh, MeshSpec, RowDraws, draw,
                                      init_distributed, make_mesh,
                                      shard_accum_batch, shard_batch)
from icka_tpu_torch.core.profiling import StepTimer, annotate, trace
from icka_tpu_torch.data.images import preprocess_images
from icka_tpu_torch.kernels import build
from icka_tpu_torch.models.gate_cl import GateCLModel
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.nn.layers import dropout
from icka_tpu_torch.parallel import (param_partition_specs,
                                     shard_train_state, zero1_moment_specs)
from icka_tpu_torch.parallel.collectives import (all_gather_objects,
                                                 all_gather_slices_,
                                                 all_reduce_mean_,
                                                 broadcast_object,
                                                 psum_across_hosts)
from icka_tpu_torch.serving.bucketed import (BucketedGateCLServer,
                                             BucketedICKAServer)
from icka_tpu_torch.train.optimizer import AdamState

WORLD = 2
MAXL = 16                        # gate_cl's top bucket (tests/test_serving)
OFFSET, MASK_POSITIONS = 14, (3, 11)
# a stand-in nvcc: counts its runs, takes a second, writes its -o file
FAKE_NVCC = """#!/bin/sh
echo run >> "$(dirname "$0")/runs"
sleep 1
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
"""


def _icka_cfg():
    return ICKAConfig.tiny()                     # max_seq_length 32


def _gate_cl_cfg():
    return GateCLConfig(encoder=EncoderConfig.tiny(), num_labels=5,
                        layer_num1=1, region_dim=32, max_seq_length=MAXL,
                        variant="ip", negative_rate=2)


def _requests(seed=3):
    """The flagship's and gate_cl's requests, as `tests/test_serving.py`
    draws them (some longer than the top bucket)."""
    rng = np.random.default_rng(seed)
    cfg = _icka_cfg()
    icka = []
    for _ in range(12):
        L = int(rng.integers(3, 37))
        icka.append({
            "ori_input_ids": rng.integers(2, 128, L).astype(np.int32),
            "input_ids": rng.integers(2, 128, OFFSET + L).astype(np.int32),
            "clip_features": rng.standard_normal(cfg.clip_dim)
            .astype(np.float32),
            "visual_mean": rng.standard_normal(cfg.region_dim)
            .astype(np.float32),
            "visual_grid": rng.standard_normal((7, 7, cfg.region_dim))
            .astype(np.float32)})
    gate_cl = []
    for _ in range(20):
        L = int(rng.integers(3, MAXL + 5))
        gate_cl.append({
            "input_ids": rng.integers(2, 120, L).astype(np.int32),
            "visual_mean": rng.standard_normal(32).astype(np.float32),
            "visual_grid": rng.standard_normal((7, 7, 32))
            .astype(np.float32)})
    return icka, gate_cl


def _servers(mesh=None):
    icka = ICKAModel(_icka_cfg(), device="cpu", seed=0).eval()
    gate_cl = GateCLModel(_gate_cl_cfg(), device="cpu", seed=1).eval()
    return (BucketedICKAServer(icka, buckets=(16, 32), max_batch=8,
                               offset=OFFSET, mask_positions=MASK_POSITIONS,
                               mesh=mesh, device="cpu"),
            BucketedGateCLServer(gate_cl, buckets=(8, MAXL), max_batch=8,
                                 mesh=mesh, device="cpu"))


def _serve(mesh=None):
    icka_reqs, gate_cl_reqs = _requests()
    icka, gate_cl = _servers(mesh)
    tags_i, stats_i = icka.predict(icka_reqs)
    tags_g, stats_g = gate_cl.predict(gate_cl_reqs)
    return {"icka": tags_i, "icka_pairs": stats_i.total_pairs,
            "gate_cl": tags_g, "gate_cl_pairs": stats_g.total_pairs}


def _raises(fn, kind) -> bool:
    try:
        fn()
    except kind:
        return True
    return False


def _rank_main(rank: int, out: str):
    """One rank's scenarios; what it saw goes to `out/rank{rank}.pt`."""
    out = Path(out)
    build.BUILD_DIR = out / "kernels"
    build.nvcc_path = lambda: str(out / "bin" / "nvcc")
    libs = build.build(("blockwise_attention",))
    dev = init_distributed("cpu", init_method=f"file://{out / 'store'}",
                           rank=rank, world=WORLD)
    seen = {"device": str(dev), "backend": dist.get_backend(),
            "lib": str(libs["blockwise_attention"])}
    seen["gathered"] = all_gather_objects({"rank": rank,
                                           "x": np.arange(rank + 1)})
    seen["broadcast"] = broadcast_object(f"from {rank}", root=1)
    seen["psum"] = psum_across_hosts(np.array([rank, 1], np.int32))
    mesh = make_mesh(MeshSpec(), device="cpu")
    seen["mesh"] = (mesh.data, mesh.model, mesh.rank, str(mesh.device))
    seen["refused"] = (
        _raises(lambda: make_mesh(MeshSpec(data=3), "cpu"), ValueError),
        _raises(lambda: make_mesh(MeshSpec(data=1), "cpu"), ValueError),
        _raises(lambda: make_mesh(MeshSpec(data=2, model=2), "cpu"),
                ValueError))
    grid = make_mesh(MeshSpec(data=1, model=2), device="cpu")
    seen["grid"] = (grid.data, grid.model, grid.rank, grid.model_rank,
                    dist.get_world_size(grid.model_group),
                    dist.get_world_size(grid.group))
    means = [torch.full((3,), float(rank)), torch.arange(5.0) * (rank + 1)]
    all_reduce_mean_(means)
    seen["means"] = means
    slices = torch.zeros(4, 6)
    slices.narrow(1, 3 * rank, 3).fill_(rank + 1.0)
    all_gather_slices_([slices], [(1, 3)], rank)
    seen["slices"] = slices
    seen.update(_serve(mesh))
    torch.save(seen, out / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' records, from one start of two processes."""
    out = tmp_path_factory.mktemp("ranks")
    nvcc = out / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(240)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]


# -- the spec functions against the JAX package's -----------------------------

@pytest.fixture(scope="module")
def jax_icka_params():
    import jax

    from icka_tpu.core.config import ICKAConfig as JaxICKAConfig
    from icka_tpu.models.icka import ICKAModel as JaxICKAModel

    cfg = JaxICKAConfig.tiny()
    L, B = cfg.max_seq_length, 2
    batch = {
        "input_ids": np.ones((B, OFFSET + L), np.int32),
        "segment_ids": np.zeros((B, OFFSET + L), np.int32),
        "input_mask": np.ones((B, OFFSET + L), np.int32),
        "ori_input_ids": np.ones((B, L), np.int32),
        "ori_input_mask": np.ones((B, L), np.int32),
        "ori_segment_ids": np.zeros((B, L), np.int32),
        "img_mask": np.ones((B, cfg.num_regions), np.int32),
        "clip_features": np.zeros((B, 1, cfg.clip_dim), np.float32),
        "output_mask": np.ones((B, L), np.int32),
        "visual_mean": np.zeros((B, cfg.region_dim), np.float32),
        "visual_grid": np.zeros((B, 7, 7, cfg.region_dim), np.float32)}
    # shapes only: the spec functions read names and shapes
    return jax.eval_shape(lambda: JaxICKAModel(cfg).init(
        jax.random.PRNGKey(0), batch, MASK_POSITIONS, OFFSET,
        mode="test"))["params"]


def _flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_view(path, ndim):
    """The port's name of a flax path and `perm`: port dimension i is flax
    dimension perm[i] (as `icka_tpu_torch.convert` lays a kernel out)."""
    names = list(path)
    if names[-1] == "kernel" and ndim in (2, 4):
        names[-1] = "weight"
        return ".".join(names), (1, 0) if ndim == 2 else (3, 2, 0, 1)
    return ".".join(names), tuple(range(ndim))


@pytest.mark.parametrize("data,model", [(2, 1), (8, 1), (2, 2), (4, 2)])
def test_spec_functions_give_jax_answers(jax_icka_params, data, model):
    """`param_partition_specs` and `zero1_moment_specs` on the port's names
    and shapes give the JAX package's PartitionSpecs on the same leaves,
    dimension for dimension, on 2 and 8 of conftest's virtual devices."""
    from icka_tpu.core.mesh import MeshSpec as JaxMeshSpec
    from icka_tpu.core.mesh import make_mesh as jax_make_mesh
    from icka_tpu.parallel import partitioning as jax_partitioning

    jmesh = jax_make_mesh(JaxMeshSpec(data=data, model=model))
    want = {key: dict(_flat_paths(fn(jax_icka_params, jmesh)))
            for key, fn in (
                ("tp", jax_partitioning.param_partition_specs),
                ("zero1", jax_partitioning.zero1_moment_specs))}
    shapes, perms = {}, {}
    for path, leaf in _flat_paths(jax_icka_params):
        name, perm = _port_view(path, leaf.ndim)
        perms[path] = (name, perm)
        shapes[name] = tuple(leaf.shape[i] for i in perm)
    got = {"tp": param_partition_specs(shapes, model),
           "zero1": zero1_moment_specs(shapes, data, model)}
    split = {"model": 0, "data": 0}
    for key in ("tp", "zero1"):
        for path, spec in want[key].items():
            name, perm = perms[path]
            flax = tuple(spec) + (None,) * (len(perm) - len(spec))
            port = got[key][name]
            inverse = np.argsort(perm)
            assert tuple(port[i] for i in inverse) == flax, \
                (key, name, port, spec)
            for axis in split:
                split[axis] += axis in flax
    # the comparison covers both axes where the mesh has them
    assert split["data"] > 0 and (split["model"] > 0) == (model > 1)


def test_shard_params_and_train_state_apply_the_data_entries():
    """Parameters stay whole (their specs hold no data entry); under
    ZeRO-1 each split moment leaf becomes this rank's slice along the
    dimension `zero1_moment_specs` gives the data axis, the others whole;
    without ZeRO-1 nothing changes."""
    mesh = Mesh(data=2, model=1, rank=1, group=None,
                device=torch.device("cpu"))
    moments = {"a.query.weight": torch.arange(24.0).reshape(6, 4),
               "a.query.bias": torch.arange(3.0)}
    state = AdamState(torch.zeros((), dtype=torch.int32), dict(moments),
                      {n: t + 1 for n, t in moments.items()})
    assert all("data" not in spec for spec in param_partition_specs(
        {n: t.shape for n, t in moments.items()}).values())
    assert shard_train_state(state, mesh) is state
    cut = shard_train_state(state, mesh, zero1=True)
    spec = zero1_moment_specs({n: t.shape for n, t in moments.items()}, 2)
    assert spec == {"a.query.weight": ("data", None),
                    "a.query.bias": (None,)}
    assert torch.equal(cut.mu["a.query.weight"], moments[
        "a.query.weight"][3:])
    assert cut.mu["a.query.weight"].is_contiguous()
    assert torch.equal(cut.nu["a.query.bias"], moments["a.query.bias"] + 1)


# -- the mesh and the row draws -------------------------------------------------

def test_mesh_of_one_process():
    """Without a process group: -1 is one rank, a mesh of more raises
    `ValueError` as JAX's does; rows split only where the axis divides."""
    assert not dist.is_initialized()
    assert MeshSpec().resolve() == (1, 1)
    assert MeshSpec(data=-1).resolve(8) == (8, 1)
    assert MeshSpec(data=-1, model=2).resolve(8) == (4, 2)
    mesh = make_mesh(device="cpu")
    assert (mesh.data, mesh.model, mesh.rank, mesh.group) == (1, 1, 0, None)
    with pytest.raises(ValueError, match="needs 2"):
        make_mesh(MeshSpec(data=2), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh(MeshSpec(data=1, model=2), device="cpu")
    two = Mesh(data=2, model=1, rank=1, group=None,
               device=torch.device("cpu"))
    assert two.rows(8) == (4, 8) and two.rows(7) == (0, 7)
    assert two.shape == {"data": 2, "model": 1}


def test_shard_batch_takes_rows_or_replicates():
    """This rank's rows of dimension 0 (`shard_batch`) and 1
    (`shard_accum_batch`), whole where the axis does not divide, as the
    JAX package's `_put`; numpy arrays and tensors alike."""
    mesh = Mesh(data=2, model=1, rank=1, group=None,
                device=torch.device("cpu"))
    batch = {"a": np.arange(24).reshape(4, 6), "b": torch.arange(3),
             "c": np.float32(1.0)}
    got = shard_batch(mesh, batch)
    np.testing.assert_array_equal(got["a"], batch["a"][2:])
    assert torch.equal(got["b"], batch["b"]) and got["c"] == 1.0
    accum = shard_accum_batch(mesh, {"a": np.arange(24).reshape(2, 4, 3),
                                     "b": np.arange(6).reshape(2, 3)})
    np.testing.assert_array_equal(
        accum["a"], np.arange(24).reshape(2, 4, 3)[:, 2:])
    np.testing.assert_array_equal(accum["b"], np.arange(6).reshape(2, 3))


def test_row_draws_are_the_whole_batch_draws_cut_to_the_rows():
    """Dropout masks and the train crop and flip drawn through `RowDraws`
    for rows [2, 4) of 4 equal rows [2, 4) of the one-rank draws from the
    same seed; a draw of another row count raises."""
    x = torch.randn(4, 5, 6, generator=torch.Generator().manual_seed(0))
    whole = dropout(x, 0.5, torch.Generator().manual_seed(7))
    rows = RowDraws(torch.Generator().manual_seed(7), 2, 4, 4)
    assert torch.equal(dropout(x[2:], 0.5, rows), whole[2:])
    images = np.random.default_rng(0).integers(0, 255, (4, 40, 40, 3),
                                               dtype=np.uint8)
    full = preprocess_images(images, 32, "cpu", train=True,
                             generator=torch.Generator().manual_seed(3))
    part = preprocess_images(images[2:], 32, "cpu", train=True,
                             generator=RowDraws(
                                 torch.Generator().manual_seed(3), 2, 4, 4))
    assert torch.equal(part, full[2:])
    with pytest.raises(ValueError, match="3 rows"):
        draw(lambda s, g: torch.rand(s, generator=g), (3, 2), rows)


# -- multi-rank scenarios --------------------------------------------------------

def test_init_distributed_and_the_mesh_of_two_ranks(ranks):
    _, seen = ranks
    for r, s in enumerate(seen):
        assert (s["device"], s["backend"]) == ("cpu", "gloo")
        assert s["mesh"] == (2, 1, r, "cpu")
        assert s["refused"] == (True, True, True)
        # the model axis: rank = d * model + m, a model group of both
        # ranks, a data group of one
        assert s["grid"] == (1, 2, 0, r, 2, 1)


def test_collectives_of_one_process():
    """Without a process group each collective is its shortcut."""
    assert all_gather_objects({"x": 1}) == [{"x": 1}]
    assert broadcast_object("a") == "a"
    np.testing.assert_array_equal(psum_across_hosts([1, 2]), [1, 2])


def test_collectives_across_ranks(ranks):
    """`all_gather_objects`, `broadcast_object` and `psum_across_hosts`
    give with two ranks what their single-process forms imply, and the
    bulk collectives average and gather."""
    _, seen = ranks
    for s in seen:
        gathered = s["gathered"]
        assert [g["rank"] for g in gathered] == [0, 1]
        np.testing.assert_array_equal(gathered[1]["x"], [0, 1])
        assert s["broadcast"] == "from 1"
        np.testing.assert_array_equal(s["psum"], [1, 2])
        assert torch.equal(s["means"][0], torch.full((3,), 0.5))
        assert torch.equal(s["means"][1], torch.arange(5.0) * 1.5)
        want = torch.cat([torch.ones(4, 3), torch.full((4, 3), 2.0)], 1)
        assert torch.equal(s["slices"], want)


def test_ranks_that_start_together_build_once(ranks):
    """Both ranks called `build` at once: the lock let one stand-in nvcc
    run, and both loaded its library."""
    out, seen = ranks
    assert (out / "bin" / "runs").read_text().split() == ["run"]
    assert seen[0]["lib"] == seen[1]["lib"]
    assert Path(seen[0]["lib"]).read_text() == "lib\n"


@pytest.fixture(scope="module")
def single_device():
    return _serve()


@pytest.mark.parametrize("server", ["icka", "gate_cl"])
def test_dp_serving_matches_single_device(ranks, single_device, server):
    """Every rank of the two-rank mesh returns the single-device server's
    tags, and every request was served once."""
    _, seen = ranks
    want = single_device[server]
    for s in seen:
        assert s[f"{server}_pairs"] == len(want)
        assert len(s[server]) == len(want)
        for a, b in zip(s[server], want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("server", ["icka", "gate_cl"])
def test_dp_server_rejects_indivisible_batch(server):
    mesh = Mesh(data=4, model=1, rank=0, group=None,
                device=torch.device("cpu"))
    if server == "icka":
        model = ICKAModel(_icka_cfg(), device="cpu", seed=0).eval()
        make = lambda: BucketedICKAServer(  # noqa: E731
            model, buckets=(16, 32), max_batch=6, offset=OFFSET,
            mask_positions=MASK_POSITIONS, mesh=mesh, device="cpu")
    else:
        model = GateCLModel(_gate_cl_cfg(), device="cpu", seed=1).eval()
        make = lambda: BucketedGateCLServer(  # noqa: E731
            model, buckets=(8, MAXL), max_batch=6, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        make()


# -- profiling and the dtype policy ----------------------------------------------

def test_trace_holds_the_annotated_region(tmp_path):
    """`trace(log_dir)` writes a trace that holds an `annotate` name;
    `trace(None)` is a no-op and `annotate` also works as a decorator."""
    @annotate("icka/decorated")
    def work(x):
        return x @ x

    with trace(str(tmp_path)):
        with annotate("icka/annotated", device="cpu"):
            work(torch.ones(8, 8))
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"icka/annotated", "icka/decorated"} <= names
    with trace(None):
        work(torch.ones(2, 2))


def test_dtype_policy_and_step_timer():
    assert DTypePolicy.from_str("bf16").compute_dtype == torch.bfloat16
    full = DTypePolicy.from_str("float32")
    assert full == DTypePolicy.full_precision()
    assert (full.param_dtype, full.compute_dtype, full.reduce_dtype) == (
        torch.float32,) * 3
    with pytest.raises(ValueError):
        DTypePolicy.from_str("float16")
    timer = StepTimer(skip_first=1)
    assert timer.items_per_sec == 0.0
    for _ in range(3):
        timer.step(4)
    assert timer.items_per_sec > 0.0
