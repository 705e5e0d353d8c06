"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source `csrc/<name>.cu` has a plain C interface and compiles with
`nvcc` into its own shared library under `build/kernels/` at the root of
the checkout (listed in `.gitignore`). The library's file name carries a
hash of the source, of every header `csrc/*.cuh` and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded. `build()` starts one `nvcc` per source, all
at once, and waits for them, under an exclusive lock on a file in the
build directory: processes that start together (the ranks of a
data-parallel run) build once and load the same libraries. The lock is an
`flock`, which the system drops when its holder exits, so a process killed
mid-build leaves none behind. Nothing here runs at import time: the CPU
tests import every module on a host without `nvcc`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# --split-compile=0 runs nvcc's optimiser on every core (the attention
# library holds 49 instances); the -Xptxas -v log gives the same registers
# and spills as without it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("blockwise_attention", "int8_conv")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc printed for `name` (with -Xptxas -v: registers, shared
    memory and spills of every kernel instance), or "" if nothing was
    built in this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no library yet, one nvcc process
    per source, all started together, holding the build directory's lock
    (a process that waited for it finds the libraries built). Raises with
    nvcc's output on error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build(names)
    return {name: library_path(name) for name in names}


def _build(names) -> None:
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log_path = out.with_suffix(".log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log_path))
    failed = []
    for name, proc, tmp, out, log_path in jobs:
        if proc.wait() == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}:\n{log_path.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    return ctypes.CDLL(str(build((name,))[name]))
