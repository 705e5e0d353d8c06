"""Local pretrained-model resolution: one call from files on disk to a
config and weights (port of `icka_tpu.models.pretrained`).

Names resolve against local storage only, as in the JAX package:

  - an explicit directory or file path, or
  - a bare model name (e.g. ``"roberta-large"``) looked up under the cache
    root ``$ICKA_PRETRAINED_DIR`` (default ``~/.cache/icka_tpu``).

Checkpoint dialects (converted by :mod:`icka_tpu_torch.models.convert`,
:mod:`icka_tpu_torch.models.resnet` and
:mod:`icka_tpu_torch.models.tf_convert`):

  - HF directory: ``config.json`` + ``pytorch_model.bin`` or
    ``model.safetensors`` (BERT/RoBERTa key layouts, legacy gamma/beta
    names). The safetensors file is read by this module's own reader
    (`_read_safetensors`): the `safetensors` package is not needed. BF16
    tensors are widened to float32 exactly, as every other leaf is;
  - native directory: ``config.json`` (tagged ``format: icka_tpu``, the
    fields of `EncoderConfig`) + ``params.msgpack``, written by
    :func:`save_text_encoder` in either package and read by either;
  - ``.tar.gz`` archive holding either layout, extracted once into the
    cache root and reused;
  - torchvision ResNet ``.pth`` state dict or a ``resnet.msgpack``
    (:func:`load_backbone`);
  - TF-1.x BERT checkpoint prefix (``model.ckpt.index`` + data shards),
    read without tensorflow (:func:`load_tf_encoder`).

Every loader returns the JAX package's flax-layout trees of numpy arrays,
the same leaves `icka_tpu`'s loaders return; `icka_tpu_torch.convert`
(`state_dict_from_flax`, `backbone_state_dict`) carries them into the
port's modules. These are host functions: they take no device. The JAX
package's `load_chunker` (an adapter BERT behind `ModelChunker`) is not
ported: it waits for the adapter and the chunker.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import struct
import tarfile
from typing import Optional, Tuple

import numpy as np
import torch

from icka_tpu_torch.core.checkpoint import restore_pytree, save_pytree
from icka_tpu_torch.core.config import EncoderConfig, _from_dict
from icka_tpu_torch.models.convert import encoder_params_from_torch
from icka_tpu_torch.models.resnet import resnet_params_from_torch
from icka_tpu_torch.models.tf_convert import (encoder_params_from_tf,
                                              read_tf_checkpoint)

CACHE_ENV = "ICKA_PRETRAINED_DIR"
WEIGHTS_TORCH = "pytorch_model.bin"
WEIGHTS_SAFETENSORS = "model.safetensors"
WEIGHTS_NATIVE = "params.msgpack"
CONFIG_NAME = "config.json"

# safetensors dtype names -> numpy; BF16 is read apart (numpy has none)
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def cache_root() -> str:
    return os.environ.get(
        CACHE_ENV, os.path.join(os.path.expanduser("~"), ".cache",
                                "icka_tpu"))


def _extract_archive(path: str, cache_dir: Optional[str]) -> str:
    """Extract a local .tar.gz once into the cache and reuse it.

    The cache key hashes the archive's identity (path, size, mtime); a
    ``.done`` stamp makes partially extracted directories (crash
    mid-extract) invisible. Key and layout are the JAX package's, so the
    two share one cache.
    """
    st = os.stat(path)
    key = hashlib.sha256(
        f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}"
        .encode()).hexdigest()[:24]
    root = cache_dir or cache_root()
    dst = os.path.join(root, "extracted", key)
    stamp = dst + ".done"
    if not os.path.exists(stamp):
        os.makedirs(dst, exist_ok=True)
        with tarfile.open(path, "r:*") as tf:
            tf.extractall(dst, filter="data")
        with open(stamp, "w") as f:
            f.write(os.path.abspath(path))
    # archives often wrap a single top-level directory: descend into it
    entries = [e for e in os.listdir(dst) if not e.startswith(".")]
    if len(entries) == 1 and os.path.isdir(os.path.join(dst, entries[0])):
        return os.path.join(dst, entries[0])
    return dst


def resolve(name_or_path: str, cache_dir: Optional[str] = None) -> str:
    """Resolve a model name/path to a local directory holding its files:
    an existing directory as it is, an existing ``.tar.gz`` archive
    (extracted to the cache), else a bare name under the cache root (a
    directory or ``<name>.tar.gz``). Raises ``FileNotFoundError`` naming
    the searched locations otherwise."""
    if os.path.isdir(name_or_path):
        return name_or_path
    if os.path.isfile(name_or_path) and name_or_path.endswith(
            (".tar.gz", ".tgz")):
        return _extract_archive(name_or_path, cache_dir)
    root = cache_dir or cache_root()
    candidates = [os.path.join(root, name_or_path),
                  os.path.join(root, name_or_path + ".tar.gz")]
    for c in candidates:
        if os.path.isdir(c):
            return c
        if os.path.isfile(c):
            return _extract_archive(c, cache_dir)
    raise FileNotFoundError(
        f"pretrained model '{name_or_path}' not found; looked for a "
        f"directory/archive at that path and under {root} "
        f"(set ${CACHE_ENV} to change the cache root)")


def encoder_config_from_hf(d: dict) -> EncoderConfig:
    """HF ``config.json`` dict -> :class:`EncoderConfig`.

    ``position_offset`` is derived from the config: pad_token_id + 1 for
    roberta-family models, 0 for BERT-style ones.
    """
    model_type = d.get("model_type", "")
    is_roberta = model_type == "roberta" or (
        not model_type and d.get("vocab_size", 0) >= 50000
        and d.get("pad_token_id", 0) == 1)
    pad = d.get("pad_token_id", 1 if is_roberta else 0)
    fields = dict(
        vocab_size=d.get("vocab_size", 50265),
        hidden_size=d.get("hidden_size", 1024),
        num_hidden_layers=d.get("num_hidden_layers", 24),
        num_attention_heads=d.get("num_attention_heads", 16),
        intermediate_size=d.get("intermediate_size", 4096),
        max_position_embeddings=d.get("max_position_embeddings", 514),
        type_vocab_size=d.get("type_vocab_size", 2),
        hidden_dropout_prob=d.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=d.get(
            "attention_probs_dropout_prob", 0.1),
        layer_norm_eps=d.get("layer_norm_eps", 1e-5),
        pad_token_id=pad,
        position_offset=(pad + 1) if is_roberta else 0,
    )
    return EncoderConfig(**fields)


def _read_safetensors(path: str) -> dict:
    """A ``.safetensors`` file -> {name: np.ndarray}, the arrays
    `safetensors.numpy.load_file` gives, without that package: an 8-byte
    little-endian header length, a JSON header of {name: {dtype, shape,
    data_offsets}} (and an optional ``__metadata__``), then the raw
    little-endian bytes, offsets relative to their start. BF16 tensors are
    widened to float32 exactly. A truncated file or a header whose sizes
    or offsets do not add up raises ``ValueError``."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    if size < 8:
        raise ValueError(f"{path}: too small to be a safetensors file")
    (n,) = struct.unpack_from("<Q", buf, 0)
    if n > size - 8:
        raise ValueError(f"{path}: header of {n} bytes in a file of {size}")
    try:
        header = json.loads(bytes(buf[8:8 + n]))
    except ValueError as e:
        raise ValueError(f"{path}: unreadable header ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    start, data_len = 8 + n, size - 8 - n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = meta.get("dtype"), list(meta.get("shape", ()))
        begin, end = meta.get("data_offsets", (None, None))
        item = 2 if dtype == "BF16" else (
            np.dtype(_SAFETENSORS_DTYPES[dtype]).itemsize
            if dtype in _SAFETENSORS_DTYPES else None)
        if item is None:
            raise ValueError(f"{path}: {name}: unsupported dtype {dtype!r}")
        count = math.prod(shape)
        if (not isinstance(begin, int) or not isinstance(end, int)
                or not 0 <= begin <= end <= data_len
                or end - begin != count * item):
            raise ValueError(
                f"{path}: {name}: offsets {begin}..{end} do not hold "
                f"{dtype} {shape} in {data_len} bytes of data")
        if dtype == "BF16":
            arr = (torch.frombuffer(buf, dtype=torch.bfloat16, count=count,
                                    offset=start + begin).float().numpy()
                   if count else np.zeros(0, np.float32))
        else:
            arr = np.frombuffer(buf, dtype=_SAFETENSORS_DTYPES[dtype],
                                count=count, offset=start + begin)
        out[name] = arr.reshape(shape)
    return out


def _load_state_dict(directory: str) -> dict:
    """Read a torch-dialect state dict from a resolved directory."""
    st_path = os.path.join(directory, WEIGHTS_SAFETENSORS)
    if os.path.exists(st_path):
        return _read_safetensors(st_path)
    bin_path = os.path.join(directory, WEIGHTS_TORCH)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no weights in {directory}: expected {WEIGHTS_NATIVE}, "
        f"{WEIGHTS_SAFETENSORS} or {WEIGHTS_TORCH}")


def load_text_encoder(name_or_path: str,
                      cache_dir: Optional[str] = None,
                      **config_overrides) -> Tuple[EncoderConfig, dict]:
    """One call: resolve -> config -> converted params for `TextEncoder`
    (the flax tree; `state_dict_from_flax` makes it the module's
    state_dict). ``config_overrides`` replace EncoderConfig fields after
    the config.json parse (deployment knobs such as quant, use_pallas or
    fuse_qkv are not checkpoint properties)."""
    directory = resolve(name_or_path, cache_dir)
    cfg_path = os.path.join(directory, CONFIG_NAME)
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"no {CONFIG_NAME} in {directory}")
    with open(cfg_path) as f:
        cfg_dict = json.load(f)

    native = os.path.join(directory, WEIGHTS_NATIVE)
    if cfg_dict.get("format") == "icka_tpu" or os.path.exists(native):
        cfg = _from_dict(EncoderConfig, cfg_dict.get("config", cfg_dict))
        params = restore_pytree(native)
    else:
        cfg = encoder_config_from_hf(cfg_dict)
        sd = _load_state_dict(directory)
        prefix = ""
        if any(k.startswith("roberta.") for k in sd):
            prefix = "roberta."
        elif any(k.startswith("bert.") for k in sd):
            prefix = "bert."
        params = encoder_params_from_torch(sd, cfg.num_hidden_layers,
                                           prefix=prefix)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    return cfg, params


def save_text_encoder(dst_dir: str, cfg, params) -> None:
    """Write the native layout :func:`load_text_encoder` reads without a
    torch-dialect file: ``config.json`` (tagged ``format: icka_tpu``) +
    ``params.msgpack``, the bytes the JAX package writes."""
    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(dst_dir, CONFIG_NAME), "w") as f:
        json.dump({"format": "icka_tpu",
                   "config": dataclasses.asdict(cfg)}, f, indent=2)
    save_pytree(os.path.join(dst_dir, WEIGHTS_NATIVE), params)


def load_backbone(name_or_path: str,
                  cache_dir: Optional[str] = None) -> dict:
    """Resolve + convert visual-backbone weights -> the JAX package's
    `VisualBackbone` variables ({"params", "batch_stats"};
    `icka_tpu_torch.convert.backbone_state_dict` makes them a state_dict).

    Accepts a torchvision ``.pth``/``.bin`` state-dict file (the
    reference's ``resnet152.pth``), a directory containing one, or a native
    msgpack written by ``cli/convert.py``.
    """
    path = name_or_path
    if not os.path.exists(path):
        path = resolve(name_or_path, cache_dir)
    if os.path.isdir(path):
        for fname in ("resnet.msgpack", "resnet152.pth",
                      "pytorch_resnet.bin"):
            cand = os.path.join(path, fname)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no backbone weights in {path}")
    if path.endswith(".msgpack"):
        return restore_pytree(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "net" in sd:
        sd = sd["net"]
    return resnet_params_from_torch(sd)


def tf_encoder_layers(tfvars: dict) -> int:
    """The number of encoder layers in a TF-BERT checkpoint's names."""
    return 1 + max(
        int(name.split("/")[2].split("_")[1])
        for name in tfvars if name.startswith("bert/encoder/layer_"))


def load_tf_encoder(ckpt_prefix: str) -> dict:
    """TF-1.x BERT checkpoint prefix -> TextEncoder params (no tensorflow;
    every block's and tensor's crc32c checked)."""
    if ckpt_prefix.endswith(".index"):
        ckpt_prefix = ckpt_prefix[:-len(".index")]
    tfvars = read_tf_checkpoint(ckpt_prefix)
    return encoder_params_from_tf(tfvars, tf_encoder_layers(tfvars))
