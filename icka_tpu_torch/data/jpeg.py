"""The native library's JPEG decode (native/icka_native.cpp) through PIL.

`icka_decode_jpeg_file` asks libjpeg for RGB at a power-of-two DCT scale
(`scale_denom` 1, 2, 4 or 8: the largest that keeps both sides at least
`out_size`) and box-filters the result to `out_size`^2 with integer sums
and floor division. PIL reads JPEGs with its own libjpeg(-turbo), and
`Image.draft` sets the same `scale_denom`, so the same steps give the
library's pixels bit for bit where libjpeg.so is missing (PIL's bicubic
`resize`, `images.decode_image`, lands tens of levels off them:
`tools/jpeg_routes.py`).

What the library refuses, this refuses too (None): a file that does not
open, is not a JPEG, or decodes to other than 1 or 3 components (CMYK and
YCCK); a stream libjpeg stops on. A truncated stream decodes as libjpeg's
stdio source reads it: at the end of the file it inserts an EOI marker,
and the scan's missing blocks decode from zero coefficients. PIL raises on
such a file; it is decoded again with that EOI appended to its bytes.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

_EOI = b"\xff\xd9"


def pil_image():
    """PIL's `Image` module, raising where PIL or its JPEG codec is
    missing: without it no JPEG gives the reference's pixels."""
    from PIL import Image, features
    if not features.check("jpg"):
        raise ImportError("PIL was built without JPEG support")
    return Image


def scale_denom(w: int, h: int, out_size: int) -> int:
    """The library's DCT scale (icka_native.cpp, before
    `jpeg_start_decompress`)."""
    d = 1
    while d < 8 and w // (2 * d) >= out_size and h // (2 * d) >= out_size:
        d *= 2
    return d


def box_bounds(n: int, out: int) -> tuple[np.ndarray, np.ndarray]:
    """The library's `box_resize` bounds along one axis of n pixels:
    [oy*n // out, (oy+1)*n // out), at least one pixel, clipped to n."""
    o = np.arange(out, dtype=np.int64)
    lo = o * n // out
    hi = np.minimum(np.maximum((o + 1) * n // out, lo + 1), n)
    return lo, hi


def box_resize(pixels: np.ndarray, out_size: int) -> np.ndarray:
    """(h, w, 3) uint8 -> (out_size, out_size, 3) uint8: each output pixel
    the floor of the mean over its box, as `box_resize` computes it. The
    box is separable: rows are summed through a running sum down the
    columns, then columns through one along the rows. uint32 as in the
    library; a running sum may wrap, a box's difference of two is exact."""
    h, w = pixels.shape[:2]
    y0, y1 = box_bounds(h, out_size)
    x0, x1 = box_bounds(w, out_size)
    run = np.zeros((h + 1, w, 3), np.uint32)
    np.cumsum(pixels, axis=0, dtype=np.uint32, out=run[1:])
    rows = run[y1] - run[y0]                              # (out, w, 3)
    run = np.zeros((out_size, w + 1, 3), np.uint32)
    np.cumsum(rows, axis=1, out=run[:, 1:])
    sums = run[:, x1] - run[:, x0]                        # (out, out, 3)
    count = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).astype(np.uint32)
    return (sums // count[:, :, None]).astype(np.uint8)


class DraftMismatch(RuntimeError):
    """PIL scaled a JPEG to another size than libjpeg's `scale_denom`
    gives: its pixels would differ from the native library's."""


def _decode_pixels(Image, data: bytes, out_size: int) -> Optional[np.ndarray]:
    """Open, refuse, draft and decode a JPEG's bytes to libjpeg's RGB
    output at the library's scale, or None where the library refuses the
    file. PIL raises OSError on a truncated stream."""
    with Image.open(io.BytesIO(data)) as im:
        if im.format not in ("JPEG", "MPO") or im.mode not in ("L", "RGB"):
            return None
        w, h = im.size
        d = scale_denom(w, h, out_size)
        # floor sizes: PIL picks the scale from integer quotients, and the
        # rounded-up size can fall short of d (513x1025 at d=2: no scaling)
        im.draft("RGB", (w // d, h // d))
        want = (-(-w // d), -(-h // d))     # libjpeg's output_width/height
        if im.size != want:
            raise DraftMismatch(f"PIL's JPEG draft gave {im.size} for "
                                f"{w}x{h} at 1/{d}, not libjpeg's {want}")
        im.load()
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _pixels(Image, data: bytes, out_size: int) -> Optional[np.ndarray]:
    """`_decode_pixels`, a truncated stream ended as libjpeg's stdio
    source ends it: with an EOI marker."""
    try:
        return _decode_pixels(Image, data, out_size)
    except OSError as e:
        if "truncated" not in str(e):
            raise
    return _decode_pixels(Image, data + _EOI, out_size)


def decode_file(path: str, out_size: int = 256) -> Optional[np.ndarray]:
    """One file -> (out_size, out_size, 3) uint8 equal to the native
    library's `icka_decode_jpeg_file`, or None where the library returns
    an error. A file that exists needs PIL with its JPEG codec and raises
    without it; so does a PIL that scales otherwise than libjpeg."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    Image = pil_image()
    try:
        pixels = _pixels(Image, data, out_size)
    except DraftMismatch:
        raise
    except Exception:                # a stream libjpeg stops on
        return None
    return None if pixels is None else box_resize(pixels, out_size)
