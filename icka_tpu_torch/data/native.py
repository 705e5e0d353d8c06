"""ctypes bindings for the repo's native data-plane library
(native/icka_native.cpp), the port's own copy of `icka_tpu.data.native`.

Auto-builds `libicka_native.so` with `make` on first use if the toolchain is
available. Where the library does not load (a machine without
libjpeg.so.62), `decode_jpeg` and `decode_jpeg_batch` decode through PIL's
own libjpeg at the library's DCT scale and box filter
(`icka_tpu_torch.data.jpeg`), which gives its pixels bit for bit, on a
thread pool; `decoder()` says which runs. Never PIL's bicubic resize
(`images.decode_image`): the library box-resizes, and the loader decodes
`.jpg` through this module first, as the JAX package's loader does, so
both packages give the same pixels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from icka_tpu_torch.data import jpeg

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libicka_native.so")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.icka_decode_jpeg_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.icka_decode_jpeg_file.restype = ctypes.c_int
        lib.icka_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.icka_decode_jpeg_batch.restype = ctypes.c_int
        lib.icka_crc32.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_uint64]
        lib.icka_crc32.restype = ctypes.c_uint32
        _lib = lib
    except Exception:
        _load_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def decoder() -> str:
    """The decoder in use: "native" where the library loads, else
    "pil_draft" (raising where PIL cannot decode JPEGs: the route never
    yields zeros for want of a decoder)."""
    if _load() is not None:
        return "native"
    jpeg.pil_image()
    return "pil_draft"


def decode_jpeg(path: str, out_size: int = 256) -> Optional[np.ndarray]:
    """Decode+resize -> (out_size, out_size, 3) uint8, or None where the
    library fails (caller falls back to PIL's resize / the fallback
    image)."""
    lib = _load()
    if lib is None:
        return jpeg.decode_file(path, out_size)
    out = np.empty((out_size, out_size, 3), np.uint8)
    rc = lib.icka_decode_jpeg_file(
        path.encode(), out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def decode_jpeg_batch(paths: Sequence[str], out_size: int = 256,
                      num_threads: int = 4) -> tuple[np.ndarray, int]:
    """Threaded batch decode -> ((N, S, S, 3) uint8, n_failures); failed
    rows are zeroed."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    if lib is None:
        def one(i):
            arr = jpeg.decode_file(paths[i], out_size)
            out[i] = 0 if arr is None else arr
            return arr is None
        # PIL releases the GIL while libjpeg decodes
        with ThreadPoolExecutor(max(1, min(num_threads, n))) as pool:
            return out, sum(pool.map(one, range(n)))
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.icka_decode_jpeg_batch(
        arr, n, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    return out, int(failures)


def crc32(buf: np.ndarray) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    flat = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return int(lib.icka_crc32(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size))
