#!/usr/bin/env python3
"""Print what a machine offers the port: Python, torch and the CUDA it was
built for, the cards (name and power limit as nvidia-smi gives them), which
optional packages are installed (with versions), and the JPEG decoders
there are: libjpeg in the linker cache, `jpeglib.h`, and the CUDA toolkit's
nvJPEG library and header. It reads only; it installs and builds nothing.

    python tools/card_env.py
"""

from __future__ import annotations

import glob
import importlib.metadata
import importlib.util
import os
import shutil
import subprocess
import sys

OPTIONAL = ("jax", "flax", "torchvision", "PIL", "triton", "numpy", "scipy",
            "pytest")
DISTRIBUTIONS = {"PIL": "pillow"}


def run(cmd) -> str:
    if shutil.which(cmd[0]) is None:
        return f"({cmd[0]} not found)"
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return proc.stdout.strip()


def main() -> int:
    import torch

    print(f"python {sys.version.split()[0]}; torch {torch.__version__}, "
          f"built for CUDA {torch.version.cuda}; cuda available "
          f"{torch.cuda.is_available()}, {torch.cuda.device_count()} "
          f"device(s)")
    print("cards: " + run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]))
    for name in OPTIONAL:
        if importlib.util.find_spec(name) is None:
            print(f"{name}: not installed")
            continue
        try:
            version = importlib.metadata.version(DISTRIBUTIONS.get(name,
                                                                   name))
        except importlib.metadata.PackageNotFoundError:
            version = "version unknown"
        print(f"{name}: {version}")
    jpeg = [line.strip() for line in run(["ldconfig", "-p"]).splitlines()
            if "jpeg" in line.lower()]
    print("linker cache, jpeg: " + ("; ".join(jpeg) or "none"))
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for what, patterns in (
            ("jpeglib.h", ["/usr/include/jpeglib.h",
                           "/usr/include/*/jpeglib.h",
                           "/usr/local/include/jpeglib.h"]),
            ("nvJPEG", [f"{cuda}/include/nvjpeg.h",
                        f"{cuda}/lib64/libnvjpeg*"])):
        found = sorted({p for pat in patterns for p in glob.glob(pat)})
        print(f"{what}: " + (", ".join(found) or "none"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
