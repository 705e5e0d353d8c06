"""Checkpoint files of the JAX package, read and written without flax
(port of the best-checkpoint half of `icka_tpu.core.checkpoint`).

The JAX `Checkpointer` stores each train state as the bytes of
`flax.serialization.to_bytes`: msgpack of the state dict, ndarray leaves
as ext type 1 holding `packb((shape, dtype.name, buffer))`, numpy scalars
as ext type 3 in the same form. This module carries its own codec for
exactly that subset (maps with str keys, arrays, nil, bool, int, float64,
str, bin, ext 1 and ext 3), so neither flax nor msgpack is needed.
Anything else raises, flax's `__msgpack_chunked_array__` form of a leaf
above 2**30 bytes included (RoBERTa-large's largest leaf is 206 MB).

The writer streams each leaf's buffer to the file: a full-width state is
about 4 GB and is never joined into one `bytes`. For the same tree of
dicts of numpy arrays, its bytes equal `flax.serialization.to_bytes`'s.

`Checkpointer` keeps the JAX package's directory layout and manifest; both
writes are atomic (`.tmp`, then rename). Resuming a run and preemption
handling wait for training to be ported.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, BinaryIO, Mapping, Optional

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_LEAF_BYTES = 2 ** 30        # flax chunks a leaf above this size


# -- encoder -----------------------------------------------------------------

def _sized(n: int, small: Optional[int], small_max: int,
           codes: tuple) -> bytes:
    """The header of a str/bin/array/map of length n: a fix form below
    `small_max` (when `small` is given), else the 8-, 16- or 32-bit form
    of `codes` (None where the family has no such form)."""
    if small is not None and n < small_max:
        return bytes([small | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                                (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if n >= -(1 << bits):
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _sized(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _ndarray_prefix(arr: np.ndarray) -> bytes:
    """`packb((shape, dtype.name, buffer))` up to the buffer itself."""
    shape = _sized(arr.ndim, 0x90, 16, (None, 0xDC, 0xDD)) + b"".join(
        _int(int(d)) for d in arr.shape)
    return (bytes([0x93]) + shape + _str(arr.dtype.name)
            + _bin_header(arr.nbytes))


def _write_ndarray(f: BinaryIO, code: int, arr: np.ndarray) -> None:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise TypeError(f"dtype {arr.dtype} cannot be stored")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"a leaf of {arr.nbytes} bytes would need flax's "
                         f"chunked form, which this codec does not write")
    prefix = _ndarray_prefix(arr)
    f.write(_ext_header(code, len(prefix) + arr.nbytes))
    f.write(prefix)
    f.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data)


def write_msgpack(f: BinaryIO, obj: Any) -> None:
    """Stream `obj` to `f` as flax's msgpack (strict types: a subclass or
    a tuple is not packed)."""
    t = type(obj)
    if obj is None:
        f.write(b"\xc0")
    elif t is bool:
        f.write(b"\xc3" if obj else b"\xc2")
    elif t is int:
        f.write(_int(obj))
    elif t is float:
        f.write(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        f.write(_str(obj))
    elif t is bytes:
        f.write(_bin_header(len(obj)) + obj)
    elif t is list:
        f.write(_sized(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            write_msgpack(f, v)
    elif t is dict:
        f.write(_sized(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            if type(k) is not str:
                raise TypeError(f"map key {k!r} is not a str")
            f.write(_str(k))
            write_msgpack(f, v)
    elif isinstance(obj, np.ndarray):
        _write_ndarray(f, EXT_NDARRAY, obj)
    elif isinstance(obj, np.generic):
        _write_ndarray(f, EXT_NPSCALAR, np.asarray(obj))
    else:
        raise TypeError(f"cannot store a {t.__name__} in a checkpoint")


# -- decoder -----------------------------------------------------------------

def _bfloat16_as_float32(buf) -> np.ndarray:
    """bfloat16 bits widened exactly to float32 (numpy has no bfloat16)."""
    bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",       # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",       # str
                 0xDC: ">H", 0xDD: ">I",                   # array
                 0xDE: ">H", 0xDF: ">I"}                   # map
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xDB:
                return str(self.take(n), "utf-8")
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map(n)
        numbers = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
                   0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H",
                                         0xC9: ">I"}[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                         f"subset flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if type(k) is not str:
                raise ValueError(f"map key {k!r} is not a str")
            out[k] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax's chunked array form is not read: no "
                             "leaf of a supported model exceeds 2**30 bytes")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = _Reader(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not read")
        if payload.take(1)[0] != 0x93:
            raise ValueError("an ndarray ext must hold (shape, dtype, data)")
        shape, name = payload.read(), payload.read()
        head = payload.take(1)[0]
        if head not in (0xC4, 0xC5, 0xC6):
            raise ValueError("an ndarray ext must end in a bin")
        buf = payload.take(payload.unpack(
            {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[head]))
        if payload.pos != len(payload.data):
            raise ValueError("trailing bytes in an ndarray ext")
        if name == "bfloat16":
            arr = _bfloat16_as_float32(buf)
        else:
            arr = np.frombuffer(buf, np.dtype(name))
        arr = arr.reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def read_msgpack(data) -> Any:
    """Decode flax's msgpack: maps become dicts, ext 1 numpy arrays
    (read-only views of `data`), ext 3 numpy scalars. bfloat16 leaves are
    widened to float32, exactly."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# -- trees and files ---------------------------------------------------------

def state_dict(tree: Any) -> Any:
    """flax's `to_state_dict` for trees of mappings, lists and tuples:
    every container becomes a dict with str keys ("0", "1", ... for a
    sequence); leaves pass unchanged."""
    if isinstance(tree, Mapping):
        return {str(k): state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict(v) for i, v in enumerate(tree)}
    return tree


def _to_host(tree: Any) -> Any:
    """What the JAX package's `jax.tree.map(np.asarray, tree)` makes of a
    tree before it is stored: mapping keys sorted, every leaf but None an
    ndarray."""
    if isinstance(tree, Mapping):
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree if tree is None else np.asarray(tree)


def save_pytree(path: str, tree: Any) -> None:
    """Atomic write (stream to .tmp, then rename): a crash mid-save never
    tears an existing checkpoint. The bytes are those the JAX package's
    `save_pytree` writes for the same tree."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_msgpack(f, state_dict(_to_host(tree)))
    os.replace(tmp, path)


def restore_pytree(path: str) -> Any:
    """The stored tree as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return read_msgpack(f.read())


class Checkpointer:
    """Directory layout (the JAX package's):

        {dir}/manifest.json            best metric, latest step, files
        {dir}/state_best.msgpack       best-F1 train state
        {dir}/state_step{N}.msgpack    periodic snapshots (keep_n retained)
        {dir}/config.json              model config
    """

    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "manifest.json")
        self.manifest = {"best_metric": None, "best_step": None,
                         "steps": []}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)

    def _write_manifest(self):
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f, indent=2)
        os.replace(tmp, self._manifest_path)

    def save_config(self, config_json: str) -> None:
        with open(os.path.join(self.directory, "config.json"), "w") as f:
            f.write(config_json)

    def save(self, state: Any, step: int, metric: Optional[float] = None,
             best_only: bool = False) -> None:
        if metric is not None and (
                self.manifest["best_metric"] is None
                or metric > self.manifest["best_metric"]):
            save_pytree(os.path.join(self.directory, "state_best.msgpack"),
                        state)
            self.manifest["best_metric"] = float(metric)
            self.manifest["best_step"] = int(step)
        if not best_only:
            save_pytree(os.path.join(self.directory,
                                     f"state_step{int(step)}.msgpack"), state)
            self.manifest["steps"].append(int(step))
            while len(self.manifest["steps"]) > self.keep_n:
                old = self.manifest["steps"].pop(0)
                try:
                    os.remove(os.path.join(
                        self.directory, f"state_step{old}.msgpack"))
                except FileNotFoundError:
                    pass
        self._write_manifest()

    def restore_best(self) -> dict:
        """The best state as nested dicts of numpy arrays (no target tree:
        the caller picks the collections it needs)."""
        return restore_pytree(
            os.path.join(self.directory, "state_best.msgpack"))
