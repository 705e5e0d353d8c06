"""TensorFlow checkpoint → param pytrees, without TensorFlow (a copy of
`icka_tpu.models.tf_convert`, which imports only numpy: the port keeps its
own). The trees are the JAX package's flax layout, leaf for leaf;
`icka_tpu_torch.convert.state_dict_from_flax` makes them a state_dict.
Bundles written by either package read in the other.

Reference parity: `my_bert/convert_tf_checkpoint_to_pytorch.py` +
`load_tf_weights_in_bert` (`my_bert/gate_cl_modeling.py:55-119`) convert a
TF-1.x BERT checkpoint into the torch model. The reference's converter is
dead (broken import of a nonexistent `my_bert/modeling.py`) and requires a
TensorFlow install; this module reimplements the *capability* natively:

  - `read_tf_checkpoint(prefix)` parses the TensorBundle on-disk format
    (`prefix.index` + `prefix.data-NNNNN-of-MMMMM`) in pure Python — a
    LevelDB-format SSTable of BundleEntryProto records over raw tensor
    shards — so no tensorflow dependency is needed (it is not in this
    environment, and the zero-egress rule forbids installing it).
  - `encoder_params_from_tf(...)` maps TF-BERT variable names into the
    `TextEncoder` pytree, mirroring the reference loader's rules: skip
    `adam_v`/`adam_m`/`global_step` slots (:81-84), `gamma`→LayerNorm
    scale / `beta`→bias (:89-92), embeddings map directly (:108-109).
    The reference transposes `kernel` for torch's (out,in) Linear (:111);
    flax Dense kernels are (in,out) = TF's native layout, so kernels map
    untransposed here.
  - `write_tf_checkpoint(prefix, vars)` emits the same format (single
    shard), used by the round-trip tests and as a general exporter.

Format notes (sources: tensorflow/core/util/tensor_bundle — BundleEntryProto
wire layout; tensorflow/core/lib/io/format.cc + leveldb table_format.txt —
SSTable blocks, restarts, 48-byte footer, magic 0xdb4775248b80fb57; crc32c
is the Castagnoli polynomial with LevelDB's rotate-add masking).
"""

from __future__ import annotations

import os
import struct

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_SIZE = 48
_CRC_MASK_DELTA = 0xA282EAD8

# TF DataType enum values → numpy dtypes (tensorflow/core/framework/types.proto)
_DTYPES = {
    1: np.dtype(np.float32),
    2: np.dtype(np.float64),
    3: np.dtype(np.int32),
    4: np.dtype(np.uint8),
    5: np.dtype(np.int16),
    6: np.dtype(np.int8),
    9: np.dtype(np.int64),
    10: np.dtype(np.bool_),
    17: np.dtype(np.uint16),
    19: np.dtype(np.float16),
    22: np.dtype(np.uint32),
    23: np.dtype(np.uint64),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected poly 0x82F63B78) — table-driven, pure Python.
# ---------------------------------------------------------------------------

def _make_crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _CRC_MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varint + minimal protobuf wire helpers
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.
    value is int for varint/fixed, bytes for length-delimited."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:                    # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                    # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _field(num: int, wire: int, payload) -> bytes:
    tag = _write_varint((num << 3) | wire)
    if wire == 0:
        return tag + _write_varint(payload)
    if wire == 2:
        return tag + _write_varint(len(payload)) + payload
    if wire == 5:
        return tag + struct.pack("<I", payload)
    raise ValueError(wire)


# ---------------------------------------------------------------------------
# BundleEntryProto / BundleHeaderProto / TensorShapeProto
# ---------------------------------------------------------------------------

def _parse_shape(buf: bytes):
    dims = []
    for field, _, val in _iter_fields(buf):
        if field == 2:                     # repeated Dim
            size = 0
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
        elif field == 3 and val:
            raise ValueError("unknown-rank tensor shape in checkpoint")
    return tuple(dims)


def _encode_shape(shape) -> bytes:
    out = b""
    for d in shape:
        out += _field(2, 2, _field(1, 0, int(d)))
    return out


def _parse_entry(buf: bytes):
    dtype = shape = None
    shard = offset = size = crc = 0
    for field, _, val in _iter_fields(buf):
        if field == 1:
            dtype = val
        elif field == 2:
            shape = _parse_shape(val)
        elif field == 3:
            shard = val
        elif field == 4:
            offset = val
        elif field == 5:
            size = val
        elif field == 6:
            crc = val
        elif field == 7:
            raise ValueError("sliced (partitioned) tensors not supported")
    return dtype, shape or (), shard, offset, size, crc


def _encode_entry(dtype_code, shape, shard, offset, size, crc) -> bytes:
    out = _field(1, 0, dtype_code)
    out += _field(2, 2, _encode_shape(shape))
    if shard:
        out += _field(3, 0, shard)
    if offset:
        out += _field(4, 0, offset)
    out += _field(5, 0, size)
    out += _field(6, 5, crc)
    return out


def _parse_header(buf: bytes) -> int:
    """BundleHeaderProto → num_shards (endianness 'BIG' rejected)."""
    num_shards = 1
    for field, _, val in _iter_fields(buf):
        if field == 1:
            num_shards = val
        elif field == 2 and val == 1:
            raise ValueError("big-endian checkpoints not supported")
    return num_shards


# ---------------------------------------------------------------------------
# LevelDB-format SSTable (the .index file)
# ---------------------------------------------------------------------------

def _parse_block(data: bytes):
    """Decode one table block into an ordered list of (key, value)."""
    if len(data) < 4:
        return []
    (num_restarts,) = struct.unpack_from("<I", data, len(data) - 4)
    limit = len(data) - 4 - 4 * num_restarts
    pos, key, out = 0, b"", []
    while pos < limit:
        shared, pos = _read_varint(data, pos)
        unshared, pos = _read_varint(data, pos)
        vlen, pos = _read_varint(data, pos)
        key = key[:shared] + data[pos:pos + unshared]
        pos += unshared
        out.append((key, data[pos:pos + vlen]))
        pos += vlen
    return out


def _read_block(buf: bytes, offset: int, size: int, verify: bool):
    data = buf[offset:offset + size]
    ctype = buf[offset + size]
    if verify:
        (stored,) = struct.unpack_from("<I", buf, offset + size + 1)
        if _masked_crc(buf[offset:offset + size + 1]) != stored:
            raise ValueError("block checksum mismatch in checkpoint index")
    if ctype == 1:
        raise ValueError("snappy-compressed checkpoint blocks not supported "
                         "(TensorFlow writes bundle indexes uncompressed)")
    if ctype != 0:
        raise ValueError(f"unknown block compression type {ctype}")
    return _parse_block(data)


def _read_index_entries(index_path: str, verify: bool = True):
    with open(index_path, "rb") as f:
        buf = f.read()
    if len(buf) < _FOOTER_SIZE:
        raise ValueError(f"{index_path}: too small to be a checkpoint index")
    footer = buf[-_FOOTER_SIZE:]
    (magic,) = struct.unpack_from("<Q", footer, _FOOTER_SIZE - 8)
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{index_path}: bad table magic "
                         f"(not a TensorFlow checkpoint index)")
    # footer = metaindex BlockHandle + index BlockHandle (varints) + padding
    moff, p = _read_varint(footer, 0)
    msize, p = _read_varint(footer, p)
    ioff, p = _read_varint(footer, p)
    isize, p = _read_varint(footer, p)
    entries = []
    for _, handle in _read_block(buf, ioff, isize, verify):
        boff, q = _read_varint(handle, 0)
        bsize, _ = _read_varint(handle, q)
        entries.extend(_read_block(buf, boff, bsize, verify))
    return entries


class _BlockBuilder:
    """LevelDB block builder with prefix-compressed keys + restart array."""

    def __init__(self, restart_interval: int = 16):
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.interval = restart_interval
        self.last_key = b""

    def add(self, key: bytes, value: bytes):
        shared = 0
        if self.counter < self.interval:
            n = min(len(key), len(self.last_key))
            while shared < n and key[shared] == self.last_key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        self.buf += _write_varint(shared)
        self.buf += _write_varint(len(key) - shared)
        self.buf += _write_varint(len(value))
        self.buf += key[shared:]
        self.buf += value
        self.counter += 1
        self.last_key = key

    def finish(self) -> bytes:
        out = bytes(self.buf)
        for r in self.restarts:
            out += struct.pack("<I", r)
        return out + struct.pack("<I", len(self.restarts))


def _append_block(out: bytearray, block: bytes):
    """Append block + trailer; return its BlockHandle bytes."""
    handle = _write_varint(len(out)) + _write_varint(len(block))
    out += block
    out += b"\x00"                                   # no compression
    out += struct.pack("<I", _masked_crc(block + b"\x00"))
    return handle


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def list_tf_variables(prefix: str, verify: bool = True):
    """`tf.train.list_variables` equivalent: [(name, shape), ...] sorted."""
    out = []
    for key, value in _read_index_entries(prefix + ".index", verify):
        if not key:
            continue
        dtype, shape, _, _, _, _ = _parse_entry(value)
        out.append((key.decode("utf-8"), list(shape)))
    return out


def read_tf_checkpoint(prefix: str, verify: bool = True) -> dict:
    """Read every tensor of a TF checkpoint into {name: np.ndarray}.

    `prefix` is the checkpoint prefix (e.g. `.../model.ckpt`), exactly what
    `tf.train.load_checkpoint` takes; `prefix.index` and the
    `prefix.data-NNNNN-of-MMMMM` shards must exist.
    """
    entries = _read_index_entries(prefix + ".index", verify)
    num_shards, shards, out = 1, {}, {}
    for key, value in entries:
        if not key:
            num_shards = _parse_header(value)
            continue
        dtype_code, shape, shard, offset, size, crc = _parse_entry(value)
        dt = _DTYPES.get(dtype_code)
        if dt is None:
            raise ValueError(
                f"{key.decode()}: unsupported dtype code {dtype_code} "
                "(string/resource tensors are not checkpoint weights)")
        if shard not in shards:
            path = prefix + f".data-{shard:05d}-of-{num_shards:05d}"
            with open(path, "rb") as f:
                shards[shard] = f.read()
        raw = shards[shard][offset:offset + size]
        if len(raw) != size:
            raise ValueError(f"{key.decode()}: truncated data shard")
        if verify and crc and crc != _masked_crc(raw) and crc != crc32c(raw):
            raise ValueError(f"{key.decode()}: tensor data crc mismatch")
        out[key.decode("utf-8")] = (
            np.frombuffer(raw, dtype=dt).reshape(shape).copy())
    return out


def write_tf_checkpoint(prefix: str, variables: dict,
                        block_bytes: int = 4096) -> None:
    """Write {name: array} as a single-shard TF TensorBundle checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    names = sorted(variables)
    data = bytearray()
    entries = []
    for name in names:
        arr = np.asarray(variables[name])
        if arr.ndim:        # ascontiguousarray would promote 0-d to (1,)
            arr = np.ascontiguousarray(arr)
        if arr.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name}: cannot write dtype {arr.dtype}")
        raw = arr.tobytes()
        entries.append((name.encode("utf-8"),
                        _encode_entry(_DTYPE_CODES[arr.dtype], arr.shape, 0,
                                      len(data), len(raw), _masked_crc(raw))))
        data += raw
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))

    header = _field(1, 0, 1)                         # num_shards = 1
    # version { producer: 1 } (field 3 → VersionDef.producer field 1)
    header += _field(3, 2, _field(1, 0, 1))
    records = [(b"", header)] + entries

    out = bytearray()
    index_entries = []                               # (last_key, handle)
    block = _BlockBuilder()
    blk_keys = 0
    for key, value in records:
        block.add(key, value)
        blk_keys += 1
        if len(block.buf) >= block_bytes:
            index_entries.append((key, _append_block(out, block.finish())))
            block, blk_keys = _BlockBuilder(), 0
    if blk_keys:
        index_entries.append((records[-1][0],
                              _append_block(out, block.finish())))

    idx = _BlockBuilder()
    for last_key, handle in index_entries:
        idx.add(last_key, handle)
    index_handle = _append_block(out, idx.finish())
    meta_handle = _append_block(out, _BlockBuilder().finish())

    footer = meta_handle + index_handle
    footer += b"\x00" * (_FOOTER_SIZE - 8 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    out += footer
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(out))


_SKIP_TOKENS = ("adam_v", "adam_m", "global_step")   # ref :81-84


def encoder_params_from_tf(tfvars: dict, num_layers: int,
                           prefix: str = "bert/") -> dict:
    """TF-BERT checkpoint variables → `TextEncoder` param pytree.

    Mirrors `load_tf_weights_in_bert` (`my_bert/gate_cl_modeling.py:55-119`):
    optimizer slot variables are skipped, `gamma`/`beta` are the LayerNorm
    scale/bias, `*_embeddings` map to the tables directly. TF stores Dense
    kernels as (in, out) — flax's native layout — so unlike the torch
    loader (:111) nothing is transposed.
    """
    sd = {}
    for name, arr in tfvars.items():
        parts = name.split("/")
        if any(p in _SKIP_TOKENS for p in parts):
            continue
        if prefix and name.startswith(prefix):
            sd[name[len(prefix):]] = np.asarray(arr, np.float32)
    def ln(p):
        return {"scale": sd[f"{p}/gamma"], "bias": sd[f"{p}/beta"]}

    def dense(p):
        return {"kernel": sd[f"{p}/kernel"], "bias": sd[f"{p}/bias"]}

    emb = {
        "word_embeddings": sd["embeddings/word_embeddings"],
        "position_embeddings": sd["embeddings/position_embeddings"],
        "token_type_embeddings": sd["embeddings/token_type_embeddings"],
        "norm": ln("embeddings/LayerNorm"),
    }
    encoder = {}
    for i in range(num_layers):
        p = f"encoder/layer_{i}"
        encoder[f"layer_{i}"] = {
            "attn": {
                "query": dense(f"{p}/attention/self/query"),
                "key": dense(f"{p}/attention/self/key"),
                "value": dense(f"{p}/attention/self/value"),
            },
            "attn_out": {
                "dense": dense(f"{p}/attention/output/dense"),
                "norm": ln(f"{p}/attention/output/LayerNorm"),
            },
            "ffn": {
                "wi": dense(f"{p}/intermediate/dense"),
                "wo": dense(f"{p}/output/dense"),
                "norm": ln(f"{p}/output/LayerNorm"),
            },
        }
    params = {"embeddings": emb, "encoder": encoder}
    if f"{prefix}pooler/dense/kernel" in tfvars:
        params["pooler"] = {"dense": dense("pooler/dense")}
    return params


def encoder_params_to_tf(params: dict, prefix: str = "bert/") -> dict:
    """Inverse mapping: `TextEncoder` pytree → TF-BERT variable dict."""
    out = {}

    def ln(p, t):
        out[f"{p}/gamma"] = np.asarray(t["scale"], np.float32)
        out[f"{p}/beta"] = np.asarray(t["bias"], np.float32)

    def dense(p, t):
        out[f"{p}/kernel"] = np.asarray(t["kernel"], np.float32)
        out[f"{p}/bias"] = np.asarray(t["bias"], np.float32)

    emb = params["embeddings"]
    out[f"{prefix}embeddings/word_embeddings"] = np.asarray(
        emb["word_embeddings"], np.float32)
    out[f"{prefix}embeddings/position_embeddings"] = np.asarray(
        emb["position_embeddings"], np.float32)
    out[f"{prefix}embeddings/token_type_embeddings"] = np.asarray(
        emb["token_type_embeddings"], np.float32)
    ln(f"{prefix}embeddings/LayerNorm", emb["norm"])
    for name, layer in params["encoder"].items():
        p = f"{prefix}encoder/{name}"
        dense(f"{p}/attention/self/query", layer["attn"]["query"])
        dense(f"{p}/attention/self/key", layer["attn"]["key"])
        dense(f"{p}/attention/self/value", layer["attn"]["value"])
        dense(f"{p}/attention/output/dense", layer["attn_out"]["dense"])
        ln(f"{p}/attention/output/LayerNorm", layer["attn_out"]["norm"])
        dense(f"{p}/intermediate/dense", layer["ffn"]["wi"])
        dense(f"{p}/output/dense", layer["ffn"]["wo"])
        ln(f"{p}/output/LayerNorm", layer["ffn"]["norm"])
    if "pooler" in params:
        dense(f"{prefix}pooler/dense", params["pooler"]["dense"])
    return out
