"""Weights from files on disk in the PyTorch/CUDA port
(`icka_tpu_torch.models.pretrained`) against the JAX package's loaders on
the CPU: the cases of tests/test_pretrained.py on the port, the same files
loaded by both packages (configs equal, trees bit-equal), native
directories written by either package read by the other, the port's own
safetensors reader against the `safetensors` package, and the loaded port
`TextEncoder` against HF `BertModel` / `RobertaModel` (5e-4, the JAX
tests' tolerance) and against the JAX `TextEncoder` on the same params
(1e-5).
"""

import dataclasses
import json
import os
import struct
import tarfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.models import pretrained as jpre  # noqa: E402
from icka_tpu.nn.bert import TextEncoder as JaxTextEncoder  # noqa: E402
from icka_tpu_torch.convert import state_dict_from_flax  # noqa: E402
from icka_tpu_torch.models import pretrained as tpre  # noqa: E402
from icka_tpu_torch.nn.bert import TextEncoder  # noqa: E402

CFG_KW = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=32,
              max_position_embeddings=32)


def _hf_dir(tmp_path, name="hf", safetensors=False, roberta=False):
    """A HF directory written by `transformers` from seed 0 (BERT, or
    RoBERTa with pad id 1 and positions offset by 2)."""
    from transformers import (BertConfig, BertModel, RobertaConfig,
                              RobertaModel)

    torch.manual_seed(0)
    if roberta:
        kw = dict(CFG_KW, pad_token_id=1, type_vocab_size=1,
                  layer_norm_eps=1e-5)
        hf = RobertaModel(RobertaConfig(**kw))
        cfg = dict(kw, model_type="roberta", hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
    else:
        hf = BertModel(BertConfig(**CFG_KW))
        cfg = dict(CFG_KW, model_type="bert", pad_token_id=0,
                   layer_norm_eps=1e-12, type_vocab_size=2,
                   hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    src = tmp_path / name
    src.mkdir(parents=True, exist_ok=True)
    if safetensors:
        from safetensors.numpy import save_file

        save_file({k: v.numpy() for k, v in hf.state_dict().items()},
                  src / "model.safetensors")
    else:
        torch.save(hf.state_dict(), src / "pytorch_model.bin")
    (src / "config.json").write_text(json.dumps(cfg))
    return src, hf


def _port_encoder(cfg, params):
    model = TextEncoder(cfg, with_pooler="pooler" in params, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval()


def _ids(rng, vocab=64):
    return rng.integers(2, vocab, (2, 8)).astype(np.int64)


def _port_seq(cfg, params, ids):
    with torch.no_grad():
        seq, _ = _port_encoder(cfg, params)(torch.from_numpy(ids))
    return seq.numpy()


def _assert_matches_torch(cfg, params, hf, rng):
    ids = _ids(rng)
    with torch.no_grad():
        want = hf.eval()(torch.from_numpy(ids)).last_hidden_state.numpy()
    np.testing.assert_allclose(_port_seq(cfg, params, ids), want, atol=5e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_cfg(cfg):
    return jconfig.EncoderConfig(**dataclasses.asdict(cfg))


def test_load_hf_directory(tmp_path, rng):
    src, hf = _hf_dir(tmp_path)
    cfg, params = tpre.load_text_encoder(str(src))
    assert cfg.num_hidden_layers == 2 and cfg.position_offset == 0
    _assert_matches_torch(cfg, params, hf, rng)


def test_load_hf_safetensors(tmp_path, rng):
    src, hf = _hf_dir(tmp_path, safetensors=True)
    cfg, params = tpre.load_text_encoder(str(src))
    _assert_matches_torch(cfg, params, hf, rng)


def test_native_roundtrip_loads_without_torch_dialect(tmp_path, rng):
    src, hf = _hf_dir(tmp_path)
    cfg, params = tpre.load_text_encoder(str(src))
    dst = tmp_path / "native"
    tpre.save_text_encoder(str(dst), cfg, params)
    cfg2, params2 = tpre.load_text_encoder(str(dst))
    assert cfg2 == cfg
    _assert_matches_torch(cfg2, params2, hf, rng)


def test_config_overrides_are_applied(tmp_path):
    src, _ = _hf_dir(tmp_path)
    cfg, _ = tpre.load_text_encoder(str(src), quant="int8_static",
                                    use_pallas=True, fuse_qkv=True)
    assert cfg.quant == "int8_static" and cfg.use_pallas and cfg.fuse_qkv


def test_tarball_resolution_and_cache_reuse(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("ICKA_PRETRAINED_DIR", str(tmp_path / "cache"))
    src, hf = _hf_dir(tmp_path)
    tgz = tmp_path / "model.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(src, arcname="model")

    d1 = tpre.resolve(str(tgz))
    stamp = os.path.getmtime(d1)
    d2 = tpre.resolve(str(tgz))          # the second resolve reuses it
    assert d1 == d2 and os.path.exists(os.path.join(d1, "config.json"))
    assert os.path.getmtime(d1) == stamp
    # the JAX package keys its cache the same way: one extraction for both
    assert jpre.resolve(str(tgz)) == d1
    cfg, params = tpre.load_text_encoder(str(tgz))
    _assert_matches_torch(cfg, params, hf, rng)


def test_bare_name_resolves_under_cache_root(tmp_path, monkeypatch, rng):
    monkeypatch.setenv("ICKA_PRETRAINED_DIR", str(tmp_path / "cache"))
    assert tpre.cache_root() == str(tmp_path / "cache")
    _, hf = _hf_dir(tmp_path / "cache", name="roberta-tiny")
    assert tpre.resolve("roberta-tiny") == str(tmp_path / "cache" /
                                               "roberta-tiny")
    cfg, params = tpre.load_text_encoder("roberta-tiny")
    _assert_matches_torch(cfg, params, hf, rng)
    with pytest.raises(FileNotFoundError, match="not found"):
        tpre.resolve("no-such-model")


def test_encoder_config_from_hf_roberta_offset():
    for d in ({"model_type": "roberta", "pad_token_id": 1,
               "vocab_size": 50265},
              {"model_type": "bert", "pad_token_id": 0, "vocab_size": 30522},
              {"vocab_size": 50265, "pad_token_id": 1}, {}):
        cfg = tpre.encoder_config_from_hf(d)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jpre.encoder_config_from_hf(d))
    cfg = tpre.encoder_config_from_hf(
        {"model_type": "roberta", "pad_token_id": 1, "vocab_size": 50265})
    assert cfg.position_offset == 2 and cfg.pad_token_id == 1
    cfg = tpre.encoder_config_from_hf(
        {"model_type": "bert", "pad_token_id": 0, "vocab_size": 30522})
    assert cfg.position_offset == 0


def test_load_backbone_pth(tmp_path):
    """The torchvision layout, by file and by directory, bit-equal to the
    JAX package's `load_backbone` on the same file."""
    from tests.test_resnet import TorchResNet

    ref = TorchResNet((1, 1, 1, 1))
    src = tmp_path / "resnet152.pth"
    torch.save(ref.state_dict(), src)
    variables = tpre.load_backbone(str(src))
    assert "params" in variables and "batch_stats" in variables
    assert_trees_equal(variables, jax.device_get(jpre.load_backbone(str(src))))
    assert_trees_equal(tpre.load_backbone(str(tmp_path)), variables)


@pytest.mark.parametrize("safetensors", [False, True])
def test_hf_directory_loads_the_same_in_both_packages(tmp_path, safetensors):
    src, _ = _hf_dir(tmp_path, safetensors=safetensors)
    cfg, params = tpre.load_text_encoder(str(src))
    jcfg, jparams = jpre.load_text_encoder(str(src))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(params, jparams)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_native_directory_written_by_either_package(tmp_path, writer):
    src, _ = _hf_dir(tmp_path)
    cfg, params = tpre.load_text_encoder(str(src))
    dst = str(tmp_path / "native")
    if writer == "port":
        tpre.save_text_encoder(dst, cfg, params)
        got_cfg, got = jpre.load_text_encoder(dst)
    else:
        jpre.save_text_encoder(dst, _jax_cfg(cfg), params)
        got_cfg, got = tpre.load_text_encoder(dst)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    assert_trees_equal(jax.device_get(got), params)


def test_safetensors_reader_equals_the_package(tmp_path, rng):
    """F32, F16, I64 (and a 0-d and an empty tensor) equal
    `safetensors.numpy.load_file`; BF16, which that function refuses, equals
    `safetensors.torch.load_file` widened to float32. A truncated header or
    data, and inconsistent offsets, raise."""
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as load_torch
    from safetensors.torch import save_file as save_torch

    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((4,)).astype(np.float16),
              "i64": rng.integers(-2**40, 2**40, (2, 3)).astype(np.int64),
              "scalar": np.asarray(2.5, np.float32),
              "empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "a.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    got, want = tpre._read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    bf = {"bf16": torch.randn(6, 7, generator=torch.Generator().manual_seed(0))
          .bfloat16(), "f32": torch.arange(5, dtype=torch.float32)}
    bpath = str(tmp_path / "b.safetensors")
    save_torch(bf, bpath)
    got, want = tpre._read_safetensors(bpath), load_torch(bpath)
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["bf16"], want["bf16"].float().numpy())
    np.testing.assert_array_equal(got["f32"], want["f32"].numpy())

    raw = open(path, "rb").read()
    (n,) = struct.unpack_from("<Q", raw, 0)
    for name, data in (("header", raw[:8 + n // 2]), ("data", raw[:-4]),
                       ("length", raw[:4])):
        bad = tmp_path / f"bad_{name}.safetensors"
        bad.write_bytes(data)
        with pytest.raises(ValueError):
            tpre._read_safetensors(str(bad))
    header = json.loads(raw[8:8 + n])
    header["f32"]["data_offsets"][1] += 4
    text = json.dumps(header).encode()
    bad = tmp_path / "bad_offsets.safetensors"
    bad.write_bytes(struct.pack("<Q", len(text)) + text + raw[8 + n:])
    with pytest.raises(ValueError, match="offsets"):
        tpre._read_safetensors(str(bad))


@pytest.mark.parametrize("roberta", [False, True])
def test_loaded_encoder_matches_hf_and_jax(tmp_path, rng, roberta):
    """The port's `TextEncoder` on loaded weights against the HF model that
    wrote them (5e-4) and against the JAX `TextEncoder` on the same params
    (1e-5); RoBERTa's position offset is 2."""
    src, hf = _hf_dir(tmp_path, roberta=roberta)
    cfg, params = tpre.load_text_encoder(str(src))
    assert cfg.position_offset == (2 if roberta else 0)
    ids = _ids(rng)
    got = _port_seq(cfg, params, ids)
    with torch.no_grad():
        want_hf = hf.eval()(torch.from_numpy(ids)).last_hidden_state.numpy()
    np.testing.assert_allclose(got, want_hf, atol=5e-4)
    jm = JaxTextEncoder(_jax_cfg(cfg))
    want, _ = jm.apply({"params": params}, ids.astype(np.int32),
                       np.ones(ids.shape, np.int32))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
