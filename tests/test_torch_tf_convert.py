"""The port's copy of the TensorBundle reader and writer
(`icka_tpu_torch.models.tf_convert`) against the JAX package's on the CPU:
crc32c's known vectors, bundles written by either package read by the
other bit for bit (one block and many), data and index corruption
detected, the TF-BERT name mapping both ways leaf for leaf, and
`load_tf_encoder` against the JAX package's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from icka_tpu.models import pretrained as jpre  # noqa: E402
from icka_tpu.models import tf_convert as jtf  # noqa: E402
from icka_tpu_torch.models import pretrained as tpre  # noqa: E402
from icka_tpu_torch.models import tf_convert as ttf  # noqa: E402
from tests.test_torch_pretrained import assert_trees_equal  # noqa: E402

PACKAGES = {"port": ttf, "jax": jtf}


def test_crc32c_known_vectors():
    # RFC 3720 / leveldb crc32c test vectors
    assert ttf.crc32c(b"") == 0
    assert ttf.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert ttf.crc32c(bytes(range(32))) == 0x46DD794E
    assert ttf.crc32c(b"123456789") == 0xE3069283
    data = bytes(range(256)) * 3
    assert ttf.crc32c(data) == jtf.crc32c(data)
    assert ttf._masked_crc(data) == jtf._masked_crc(data)


def _fake_bert_vars(rng, n_layers=3):
    """BERT-style names (long shared prefixes exercise the block builder's
    prefix compression), mixed dtypes and optimizer slots."""
    v = {"bert/embeddings/word_embeddings":
         rng.standard_normal((50, 8)).astype(np.float32)}
    for i in range(n_layers):
        p = f"bert/encoder/layer_{i}/attention/self"
        v[f"{p}/query/kernel"] = rng.standard_normal((8, 8)).astype(
            np.float32)
        v[f"{p}/query/bias"] = rng.standard_normal(8).astype(np.float32)
        v[f"{p}/query/kernel/adam_m"] = np.zeros((8, 8), np.float32)
    v["global_step"] = np.asarray(1234, np.int64)
    v["counts/int32"] = rng.integers(0, 100, (7,)).astype(np.int32)
    v["flags/bool"] = np.asarray([True, False, True])
    v["half/f16"] = rng.standard_normal((3, 5)).astype(np.float16)
    v["wide/f64"] = rng.standard_normal((2, 2, 2))
    v["scalar"] = np.float32(3.5)
    return v


@pytest.mark.parametrize("block_bytes", [256, 4096])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_bundle_written_by_one_package_read_by_the_other(
        tmp_path, rng, writer, reader, block_bytes):
    """256-byte blocks make several data blocks and a multi-entry index;
    4096 one data block. Both writers give the same bytes."""
    variables = _fake_bert_vars(rng)
    prefix = str(tmp_path / writer / "model.ckpt")
    PACKAGES[writer].write_tf_checkpoint(prefix, variables,
                                         block_bytes=block_bytes)
    other = str(tmp_path / "other" / "model.ckpt")
    PACKAGES[reader].write_tf_checkpoint(other, variables,
                                         block_bytes=block_bytes)
    for suffix in (".index", ".data-00000-of-00001"):
        assert open(prefix + suffix, "rb").read() == \
            open(other + suffix, "rb").read()

    rd = PACKAGES[reader]
    listed = rd.list_tf_variables(prefix)
    assert [n for n, _ in listed] == sorted(variables)
    for name, shape in listed:
        assert shape == list(np.shape(variables[name]))
    back = rd.read_tf_checkpoint(prefix)
    assert set(back) == set(variables)
    for name, arr in variables.items():
        arr = np.asarray(arr)
        assert back[name].dtype == arr.dtype and back[name].shape == arr.shape
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_data_corruption_detected(tmp_path, rng):
    prefix = str(tmp_path / "m.ckpt")
    ttf.write_tf_checkpoint(prefix, {"w": rng.standard_normal(16).astype(
        np.float32)})
    data_path = prefix + ".data-00000-of-00001"
    raw = bytearray(open(data_path, "rb").read())
    raw[5] ^= 0xFF
    open(data_path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc mismatch"):
        ttf.read_tf_checkpoint(prefix)
    ttf.read_tf_checkpoint(prefix, verify=False)    # opt-out still reads


def test_index_corruption_detected(tmp_path, rng):
    prefix = str(tmp_path / "m.ckpt")
    ttf.write_tf_checkpoint(prefix, {"w": np.ones(4, np.float32)})
    idx_path = prefix + ".index"
    good = open(idx_path, "rb").read()
    raw = bytearray(good)
    raw[-1] ^= 0xFF                              # clobber the table magic
    open(idx_path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="magic"):
        ttf.read_tf_checkpoint(prefix)
    raw = bytearray(good)
    raw[3] ^= 0x01                               # a byte of the first block
    open(idx_path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        ttf.read_tf_checkpoint(prefix)


def _encoder_params(rng, layers=2, H=8, I=16, V=20):
    def dense(i, o):
        return {"kernel": rng.standard_normal((i, o)).astype(np.float32),
                "bias": rng.standard_normal(o).astype(np.float32)}

    def ln():
        return {"scale": rng.standard_normal(H).astype(np.float32),
                "bias": rng.standard_normal(H).astype(np.float32)}
    enc = {f"layer_{i}": {
        "attn": {n: dense(H, H) for n in ("query", "key", "value")},
        "attn_out": {"dense": dense(H, H), "norm": ln()},
        "ffn": {"wi": dense(H, I), "wo": dense(I, H), "norm": ln()}}
        for i in range(layers)}
    return {"embeddings": {
        "word_embeddings": rng.standard_normal((V, H)).astype(np.float32),
        "position_embeddings": rng.standard_normal((12, H)).astype(
            np.float32),
        "token_type_embeddings": rng.standard_normal((2, H)).astype(
            np.float32),
        "norm": ln()}, "encoder": enc, "pooler": {"dense": dense(H, H)}}


def test_tf_name_mapping_equals_jax(tmp_path, rng):
    """`encoder_params_to_tf` and `encoder_params_from_tf` give the JAX
    package's leaves; optimizer slots and `global_step` are skipped; a
    bundle on disk loads through `load_tf_encoder` as in the JAX package."""
    params = _encoder_params(rng)
    tfvars = ttf.encoder_params_to_tf(params)
    want = jtf.encoder_params_to_tf(params)
    assert sorted(tfvars) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(tfvars[k], want[k], err_msg=k)
    tfvars["bert/embeddings/word_embeddings/adam_m"] = np.zeros(
        (20, 8), np.float32)
    tfvars["global_step"] = np.asarray(77, np.int64)
    got = ttf.encoder_params_from_tf(tfvars, 2)
    assert_trees_equal(got, jtf.encoder_params_from_tf(tfvars, 2))
    assert_trees_equal(got, params)

    prefix = str(tmp_path / "bert" / "model.ckpt")
    ttf.write_tf_checkpoint(prefix, tfvars, block_bytes=512)
    loaded = tpre.load_tf_encoder(prefix + ".index")
    assert_trees_equal(loaded, jpre.load_tf_encoder(prefix))
    assert_trees_equal(loaded, params)
