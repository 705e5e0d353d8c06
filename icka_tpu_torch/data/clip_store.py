"""CLIP text-feature store (a copy of `icka_tpu.data.clip_store`).

The reference loads precomputed CLIP features from
`Clip/{split}_features.pkl` — a dict `img_id → {"text_features": tensor}`
(`My_cross_attention.py:231-242`). This store reads that exact layout (torch
tensors or numpy) and also a plain `.npz` alternative, returning float32
numpy rows.
"""

from __future__ import annotations

import os
import pickle
from typing import Mapping

import numpy as np


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32).reshape(-1)


class ClipFeatureStore(Mapping):
    def __init__(self, data: dict[str, np.ndarray], dim: int = 512):
        self._data = data
        self.dim = dim

    @classmethod
    def from_pickle(cls, path: str) -> "ClipFeatureStore":
        with open(path, "rb") as f:
            raw = pickle.load(f)
        data = {}
        for key, val in raw.items():
            feat = val["text_features"] if isinstance(val, dict) else val
            data[str(key)] = _to_np(feat)
        dim = len(next(iter(data.values()))) if data else 512
        return cls(data, dim)

    @classmethod
    def from_split(cls, data_dir: str, split: str) -> "ClipFeatureStore":
        """`Clip/{split}_features.pkl` under the dataset directory."""
        return cls.from_pickle(
            os.path.join(data_dir, "Clip", f"{split}_features.pkl"))

    @classmethod
    def from_npz(cls, path: str) -> "ClipFeatureStore":
        raw = np.load(path)
        data = {k: np.asarray(raw[k], np.float32).reshape(-1) for k in raw}
        dim = len(next(iter(data.values()))) if data else 512
        return cls(data, dim)

    def __getitem__(self, key: str) -> np.ndarray:
        return self._data[str(key)]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)
