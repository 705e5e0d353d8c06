"""Eval batch loader with host decode cache and background prefetch (port
of the `train=False` half of `icka_tpu.data.loader.MNERLoader`).

Features stay columnar (numpy); images are decoded once to a compact uint8
cache and assembled per batch; a prefetch thread keeps the next batch
ready while the device computes. Batches cover the split in order; the
tail batch is padded by repeating its last row, and `row_valid` flags the
real rows so evaluators drop the duplicates.

JPEG paths go through the native threaded decoder
(`icka_tpu_torch.data.native`) when it loads, else through
`icka_tpu_torch.data.images.decode_image`, in the same order as the JAX
loader, so both give the same pixels. Training batches (shuffle, the
gradient-accumulation axis) and per-host sharding are not ported.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from icka_tpu_torch.data import native
from icka_tpu_torch.data.features import MMFeatures
from icka_tpu_torch.data.images import decode_image


class MNERLoader:
    def __init__(self, features: MMFeatures, image_dir: str,
                 batch_size: int, train: bool = True,
                 decode_size: int = 256,
                 fallback_image: Optional[str] = None,
                 cache_images: bool = True,
                 prefetch: int = 2, decode_threads: int = 4):
        if train:
            raise NotImplementedError(
                "train=True (shuffled batches with an accumulation axis) "
                "waits for training to be ported; pass train=False")
        self.features = features
        self.image_dir = image_dir
        self.batch_size = batch_size
        self.decode_size = decode_size
        self.fallback_image = fallback_image
        self.prefetch = prefetch
        self.decode_threads = decode_threads
        self._tmp: dict = {}
        self._cache: Optional[dict[int, np.ndarray]] = (
            {} if cache_images else None)
        self.indices = np.arange(len(features))

    def __len__(self) -> int:
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def _path(self, row: int) -> str:
        img_id = self.features.img_ids[row]
        return os.path.join(self.image_dir, img_id) if img_id else ""

    def _image(self, row: int) -> np.ndarray:
        if self._cache is not None and row in self._cache:
            return self._cache[row]
        if row in self._tmp:
            return self._tmp[row]
        path = self._path(row)
        arr = None
        if path.endswith((".jpg", ".jpeg")):
            arr = native.decode_jpeg(path, self.decode_size)
        if arr is None:
            arr = decode_image(path, self.decode_size, self.fallback_image)
        if self._cache is not None:
            self._cache[row] = arr
        return arr

    def _decode_uncached(self, rows) -> None:
        """Decode `rows` not yet in the cache with the native threaded
        batch decoder when available (single-image path otherwise). Cached
        mode fills `self._cache`; uncached mode fills the transient
        per-batch `self._tmp`."""
        sink = self._cache if self._cache is not None else self._tmp
        if self._cache is None:
            self._tmp = sink = {}
        todo = [int(r) for r in rows if int(r) not in sink]
        if not todo:
            return
        paths = [self._path(r) for r in todo]
        if all(p.endswith((".jpg", ".jpeg")) for p in paths):
            res = native.decode_jpeg_batch(paths, self.decode_size,
                                           num_threads=self.decode_threads)
            if res is not None:
                arrs, failures = res
                for i, r in enumerate(todo):
                    arr = arrs[i]
                    if arr.any() or failures == 0:
                        sink[r] = arr
                        continue
                    # zeroed row = native failure -> PIL/fallback path
                    sink[r] = decode_image(
                        paths[i], self.decode_size, self.fallback_image)
                return
        # otherwise _image() decodes one image at a time

    def _assemble(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        batch = self.features.batch_dict(rows)
        batch["label_ids"] = self.features.label_ids[rows]
        self._decode_uncached(rows)
        batch["images"] = np.stack([self._image(int(r)) for r in rows])
        return batch

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        B = self.batch_size
        for i in range(len(self)):
            rows = self.indices[i * B:(i + 1) * B]
            n_valid = len(rows)
            if n_valid < B:
                # pad the tail batch by repeating the last row; row_valid
                # flags the duplicates
                rows = np.concatenate([rows, np.repeat(rows[-1:],
                                                       B - n_valid)])
            batch = self._assemble(rows)
            valid = np.zeros(B, np.int32)
            valid[:n_valid] = 1
            batch["row_valid"] = valid
            yield batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:  # surface in the consumer thread
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]
