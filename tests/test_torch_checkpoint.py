"""The port's checkpoint codec and weight bridge against flax: it reads the
`state_best.msgpack` that the JAX `Checkpointer` writes leaf for leaf, bit
for bit; its writer's bytes equal `flax.serialization.to_bytes`'s for the
same tree; flax -> state_dict -> flax is bit-equal for the tiny
`ICKAModel` and the (1, 1, 1, 1) backbone; forms outside flax's subset
raise."""

import io
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
flax_serialization = pytest.importorskip("flax.serialization")
msgpack = pytest.importorskip("msgpack")

from icka_tpu.core import checkpoint as jckpt  # noqa: E402
from icka_tpu.core.config import ICKAConfig, TrainConfig  # noqa: E402
from icka_tpu.data.features import PromptSpec  # noqa: E402
from icka_tpu.train.trainer import ICKATrainer  # noqa: E402
from icka_tpu_torch import convert  # noqa: E402
from icka_tpu_torch.core import checkpoint as tckpt  # noqa: E402
from icka_tpu_torch.core.config import from_json, to_json  # noqa: E402
from icka_tpu_torch.core.config import ICKAConfig as TICKAConfig  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.models.resnet import VisualBackbone  # noqa: E402
from tests.test_torch_icka import MASKS, OFFSET, _batch  # noqa: E402

LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    """A tiny `ICKATrainState` from `ICKATrainer.init_state` (params,
    Adam state, backbone variables), saved by the JAX `Checkpointer`."""
    cfg = ICKAConfig.tiny()
    spec = PromptSpec(OFFSET, MASKS, OFFSET + 32, 32)
    trainer = ICKATrainer(cfg, TrainConfig(compute_dtype="float32"), spec,
                          resnet_layers=LAYERS)
    sample = _batch(cfg, np.random.default_rng(0))
    state = jax.jit(lambda k: trainer.init_state(k, sample, total_steps=4))(
        jax.random.PRNGKey(3))
    directory = tmp_path_factory.mktemp("ckpt")
    ck = jckpt.Checkpointer(str(directory))
    ck.save(state, step=0, metric=0.0)
    return cfg, state, directory


def _leaves_equal(got, want, path="", ordered=True):
    """Same keys (in the same order when `ordered`), bit-equal leaves."""
    assert type(got) is dict and type(want) is dict, path
    if ordered:
        assert list(got) == list(want), path
    assert set(got) == set(want), path
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _leaves_equal(g, w, f"{path}/{k}", ordered)
        else:
            w = np.asarray(w)
            assert isinstance(g, np.ndarray), f"{path}/{k}"
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            assert g.tobytes() == w.tobytes(), f"{path}/{k}"


def test_reads_the_jax_checkpointers_file_bit_equal(jax_state):
    cfg, state, directory = jax_state
    got = tckpt.Checkpointer(str(directory)).restore_best()
    want = flax_serialization.to_state_dict(jax.device_get(state))
    assert set(got) == {"step", "params", "opt_state", "backbone_variables"}
    _leaves_equal(got, want)
    with open(directory / "state_best.msgpack", "rb") as f:
        _leaves_equal(got, flax_serialization.msgpack_restore(f.read()))
    # the snapshot too, and the manifest is read as the JAX package wrote it
    _leaves_equal(tckpt.restore_pytree(str(directory / "state_step0.msgpack")),
                  want)
    assert tckpt.Checkpointer(str(directory)).manifest == json.loads(
        (directory / "manifest.json").read_text())


def test_writer_bytes_equal_flax(jax_state, tmp_path):
    cfg, state, _ = jax_state
    full = flax_serialization.to_state_dict(jax.device_get(state))
    tree = {k: v for k, v in full.items() if k != "opt_state"}
    f = io.BytesIO()
    tckpt.write_msgpack(f, tckpt.state_dict(tree))
    assert f.getvalue() == flax_serialization.to_bytes(tree)
    # both Checkpointers on the same tree, keys out of order and a Python
    # scalar leaf: same files, same manifest
    tree = dict(reversed(list(tree.items())), step=0)
    for pkg, name in ((jckpt, "jax"), (tckpt, "port")):
        ck = pkg.Checkpointer(str(tmp_path / name), keep_n=1)
        ck.save(tree, step=3, metric=0.5)
        ck.save(tree, step=4, metric=0.25)
        ck.save_config(to_json(from_json(TICKAConfig, "{}")))
    for name in ("state_best.msgpack", "state_step4.msgpack",
                 "manifest.json", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert not (tmp_path / "port" / "state_step3.msgpack").exists()
    assert not list(tmp_path.glob("*/*.tmp"))
    # numpy scalars (ext 3), Python leaves and sequences as flax stores them
    extra = {"s": np.float32(1.5), "i": np.int64(-3), "n": None, "b": True,
             "f": 0.25, "big": -2 ** 40, "seq": (np.arange(3), [1, "x"]),
             "raw": b"\x00" * 300, "empty": np.zeros((0, 4), np.float16)}
    f = io.BytesIO()
    tckpt.write_msgpack(f, tckpt.state_dict(extra))
    assert f.getvalue() == flax_serialization.to_bytes(extra)
    back = tckpt.read_msgpack(f.getvalue())
    assert back["s"] == np.float32(1.5) and type(back["s"]) is np.float32
    assert back["seq"]["1"] == {"0": 1, "1": "x"}


def test_bridge_round_trip_icka_and_backbone(jax_state):
    cfg, state, _ = jax_state
    params = jax.device_get(state.params)
    model = ICKAModel(from_json(TICKAConfig, to_json(cfg)), device="cpu")
    model.load_state_dict(convert.icka_state_dict({"params": params}),
                          strict=True)
    # the state_dict's order is the port's module order, not flax's
    back = convert.icka_variables_from_state_dict(model.state_dict())
    _leaves_equal(back["params"], flax_serialization.to_state_dict(params),
                  ordered=False)

    bvars = jax.device_get(state.backbone_variables)
    backbone = VisualBackbone(LAYERS, device="cpu")
    backbone.load_state_dict(convert.backbone_state_dict(bvars), strict=True)
    back = convert.backbone_variables_from_state_dict(backbone.state_dict())
    assert set(back) == {"params", "batch_stats"}
    for col in back:
        _leaves_equal(back[col], flax_serialization.to_state_dict(bvars[col]),
                      ordered=False)
    # what the bridge writes, flax reads into the JAX package's structure
    restored = flax_serialization.from_bytes(
        {"params": params}, flax_serialization.to_bytes(
            convert.icka_variables_from_state_dict(model.state_dict())))
    _leaves_equal(flax_serialization.to_state_dict(restored["params"]),
                  flax_serialization.to_state_dict(params), ordered=False)


def test_forms_outside_the_subset_raise(monkeypatch):
    arr = np.arange(64, dtype=np.float32)
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 16)
    chunked = flax_serialization.msgpack_serialize({"a": arr})
    assert b"__msgpack_chunked_array__" in chunked
    with pytest.raises(ValueError, match="chunked"):
        tckpt.read_msgpack(chunked)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="ext type 2"):
        tckpt.read_msgpack(flax_serialization.to_bytes({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="ext type 5"):
        tckpt.read_msgpack(msgpack.packb(msgpack.ExtType(5, b"abc")))
    with pytest.raises(ValueError):
        tckpt.read_msgpack(msgpack.packb(np.float32(1.0).item(),
                                         use_single_float=True))
    good = flax_serialization.to_bytes({"a": arr})
    with pytest.raises(ValueError, match="truncated"):
        tckpt.read_msgpack(good[:-3])
    with pytest.raises(ValueError, match="trailing"):
        tckpt.read_msgpack(good + b"\xc0")
    for bad in ((1, 2), {1: arr}, np.array([object()]), torch.zeros(2),
                1 + 2j):
        with pytest.raises(TypeError):
            tckpt.write_msgpack(io.BytesIO(), {"x": bad})
