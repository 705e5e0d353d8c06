"""Image pipeline: host-side decode, device-side eval preprocessing (port
of `icka_tpu.data.images`).

  host   : decode (PIL) -> uint8 RGB resized to `decode_size`^2 (256);
  device : center crop + ImageNet normalisation.

The training augmentation (random crop and flip) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from icka_tpu_torch.core.device import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode_image(path: str, decode_size: int = 256,
                 fallback: Optional[str] = None) -> np.ndarray:
    """Host decode -> (decode_size, decode_size, 3) uint8. On failure, falls
    back to `fallback` (the reference substitutes a known-good image) or a
    zero image. Needs PIL, imported here only."""
    from PIL import Image

    def _load(p):
        with Image.open(p) as im:
            im = im.convert("RGB").resize((decode_size, decode_size))
            return np.asarray(im, dtype=np.uint8)

    try:
        return _load(path)
    except Exception:
        if fallback is not None:
            try:
                return _load(fallback)
            except Exception:
                pass
        return np.zeros((decode_size, decode_size, 3), np.uint8)


def preprocess_images(images, crop_size: int = 224, device="cuda"):
    """Eval preprocessing: uint8 (B, S, S, 3) -> normalised float32
    (B, crop, crop, 3) on `device`: /255, center crop at margin // 2,
    ImageNet mean/std."""
    dev = resolve_device(device)
    x = torch.as_tensor(images).to(dev)
    S = x.shape[1]
    if S < crop_size:
        raise ValueError(f"image size {S} is smaller than crop {crop_size}")
    o = (S - crop_size) // 2
    x = x[:, o:o + crop_size, o:o + crop_size, :].float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return (x - mean) / std
