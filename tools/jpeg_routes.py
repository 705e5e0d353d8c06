#!/usr/bin/env python3
"""How far each of the port's JPEG routes lands from the native library's
pixels, on a machine where `native/libicka_native.so` loads (the JAX
package's decoder: libjpeg at a power-of-two DCT scale, then its box
filter).

    python tools/jpeg_routes.py [--size 256] [--out DIR]

For seeded files (`chip_smoke.photo`, written by `chip_smoke.write_jpeg`:
sizes from 200x150 to 4000x3000 at each chroma subsampling, grayscale,
progressive, truncated, and a truncated progressive one) it prints, per
file, the largest |difference| in levels between the library's decode
at --size^2 and
  - `bicubic`: PIL's bicubic resize (`images.decode_image`, what the
    loader uses for a file the library refuses);
  - `pil_draft`: `icka_tpu_torch.data.jpeg.decode_file`, the route taken
    where the library does not load.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from icka_tpu_torch.data import jpeg, native  # noqa: E402
from icka_tpu_torch.data.images import decode_image  # noqa: E402

SIZES = ((257, 999), (300, 200), (513, 1025), (640, 480), (1024, 768),
         (2048, 1536), (4000, 3000), (200, 150))
OTHERS = (("gray", 640, 480), ("progressive", 640, 480),
          ("truncated", 1024, 768), ("truncated_progressive", 640, 480))


def library_decode(lib, path, size):
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.icka_decode_jpeg_file(
        path.encode(), size, out.ctypes.data_as(ctypes.POINTER(
            ctypes.c_uint8)))
    return out if rc == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    lib = native._load()
    if lib is None:
        print("native/libicka_native.so does not load here: no reference",
              file=sys.stderr)
        return 2
    root = args.out or tempfile.mkdtemp()
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    files = []
    for w, h in SIZES:
        pixels = chip_smoke.photo(rng, w, h)
        for sub in (0, 1, 2):
            files.append((f"{w}x{h}_{sub}", pixels, None, sub))
    for name, w, h in OTHERS:
        files.append((name, chip_smoke.photo(rng, w, h), name, 2))
    print(f"# max |difference| from the library's {args.size}^2 decode, in "
          f"levels (PIL {jpeg.pil_image().__version__})")
    for name, pixels, kind, sub in files:
        path = os.path.join(root, f"{name}.jpg")
        if kind == "truncated_progressive":
            chip_smoke.write_jpeg(path, pixels, "progressive")
            with open(path, "rb") as f:
                data = f.read()
            with open(path, "wb") as f:
                f.write(data[:len(data) // 2])
        else:
            chip_smoke.write_jpeg(path, pixels, kind, sub)
        want = library_decode(lib, path, args.size).astype(np.int16)
        bicubic = np.abs(decode_image(path, args.size) - want).max()
        draft = np.abs(jpeg.decode_file(path, args.size) - want).max()
        print(f"{name:24s} bicubic {int(bicubic):3d}  pil_draft "
              f"{int(draft):3d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
