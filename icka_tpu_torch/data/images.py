"""Image pipeline: host-side decode, device-side preprocessing (port of
`icka_tpu.data.images`).

  host   : decode -> uint8 RGB resized to `decode_size`^2 (256): JPEGs
           through the loader's `native` module (the native library's
           box filter, from the library or PIL's libjpeg), what it
           refuses through `decode_image` (PIL's bicubic resize);
  device : crop (random at train, center at eval) + horizontal flip at
           train + ImageNet normalisation.

The training draws (crop offsets and flips) come from the caller's
`torch.Generator` (or `core.mesh.RowDraws` of one, for a rank's rows of a
batch); `augment_images` takes them explicitly.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from icka_tpu_torch.core.device import resolve_device
from icka_tpu_torch.core.mesh import draw

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode_image(path: str, decode_size: int = 256,
                 fallback: Optional[str] = None) -> np.ndarray:
    """Host decode -> (decode_size, decode_size, 3) uint8. On failure, falls
    back to `fallback` (the reference substitutes a known-good image) or a
    zero image. A file that exists needs PIL, imported here only, and
    raises without it; a missing file gives the fallback or zeros, as the
    JAX package does with PIL, so a missing PIL never turns an image into
    zeros."""
    zeros = np.zeros((decode_size, decode_size, 3), np.uint8)
    candidates = [p for p in (path, fallback)
                  if p is not None and os.path.exists(p)]
    if not candidates:
        return zeros
    from PIL import Image

    def _load(p):
        with Image.open(p) as im:
            im = im.convert("RGB").resize((decode_size, decode_size))
            return np.asarray(im, dtype=np.uint8)

    for p in candidates:
        try:
            return _load(p)
        except Exception:
            pass
    return zeros


def _normalize(x, dev):
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return (x - mean) / std


def preprocess_images(images, crop_size: int = 224, device="cuda",
                      train: bool = False, generator=None):
    """uint8 (B, S, S, 3) -> normalised float32 (B, crop, crop, 3) on
    `device`. Eval: /255, center crop at margin // 2, ImageNet mean/std.
    Train (the reference's RandomCrop + RandomHorizontalFlip): a crop
    offset in [0, margin] per axis and a flip with probability 1/2 per
    image, drawn from `generator` (a CPU generator, so the draws do not
    depend on the device), then `augment_images`. With no margin, training
    takes the center crop and no flip, as the JAX package does."""
    dev = resolve_device(device)
    x = torch.as_tensor(images).to(dev)
    B, S = x.shape[:2]
    if S < crop_size:
        raise ValueError(f"image size {S} is smaller than crop {crop_size}")
    margin = S - crop_size
    if train and margin > 0:
        offsets = draw(lambda shape, gen: torch.randint(
            0, margin + 1, shape, generator=gen), (B, 2), generator)
        flips = draw(lambda shape, gen: torch.rand(shape, generator=gen),
                     (B,), generator) < 0.5
        return augment_images(x, offsets, flips, crop_size)
    o = margin // 2
    x = x[:, o:o + crop_size, o:o + crop_size, :].float() / 255.0
    return _normalize(x, dev)


def augment_images(images, offsets, flips, crop_size: int = 224):
    """The training crop and flip on given draws: image b is cut at rows
    offsets[b, 0] and columns offsets[b, 1] + [0, crop), mirrored left to
    right where flips[b], then /255 and ImageNet mean/std. `images` uint8
    (B, S, S, 3) on its device; offsets (B, 2) int, flips (B,) bool."""
    x = torch.as_tensor(images)
    dev = x.device
    offsets = torch.as_tensor(offsets).to(dev).long()
    flips = torch.as_tensor(flips).to(dev).bool()
    span = torch.arange(crop_size, device=dev)
    rows = offsets[:, 0, None] + span                        # (B, crop)
    cols = offsets[:, 1, None] + torch.where(flips[:, None],
                                             crop_size - 1 - span, span)
    b = torch.arange(x.shape[0], device=dev)[:, None, None]
    x = x[b, rows[:, :, None], cols[:, None, :]].float() / 255.0
    return _normalize(x, dev)
