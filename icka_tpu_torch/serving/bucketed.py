"""Length-bucketed serving of the flagship ICKA model and of the gate_cl
family (port of `icka_tpu.serving.bucketed`).

Each request goes to the smallest length bucket that holds it, and bucket
queues run as fixed-size batches: short tweets pass through a 16- or
24-token encoder instead of the 128-token reference layout. Partial batches
are padded by repeating the chunk's first request; padded rows' outputs are
dropped. Additive -10000 key masks keep padding keys out of every valid
token's attention, so:

  - gate_cl's "ip" and "cl" variants decode bucketed exactly as in the
    128-padded layout; "gate_cl" does with `GateCLConfig.masked_crs=True`,
    and with the reference-quirk default (its relation gate flattens
    padding-position activations) the agreement is statistical;
  - the flagship decodes exactly with `ICKAConfig.masked_lstm=True`; with
    the torch-parity default the agreement is statistical (the BiLSTM runs
    through a shorter padding tail).

`warmup` runs every bucket's batch once, so that the first request does
not pay for the first launches (kernel builds, library handles, the
allocator's growth). The servers run eager PyTorch: there is no program to
compile per bucket as there is under `jax.jit`.

Data-parallel serving (`mesh=`, a `core.mesh.Mesh`): every rank gets the
same requests and holds the whole model, runs its share of the rows of
each device batch, and the tags are gathered from the ranks, so every rank
returns the single-device server's tags. The batch must divide by the
data size. A placement change, never a math change: no collective runs
inside the model. On a mesh with a model axis the server does as the JAX
package's `_dp_shardings`: the weights are whole on every rank, the rows
go by the data index (the ranks of one data index run the same rows) and
the tags are gathered over the data group. A model cut to a rank's
tensor-parallel slices (`parallel.tensor.tensor_parallel`) is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from icka_tpu_torch.core.device import resolve_device
from icka_tpu_torch.core.mesh import shard_batch
from icka_tpu_torch.parallel.collectives import all_gather_objects


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; longer sequences are truncated to the
    largest bucket (the reference truncates to max_seq_length too)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class ServingStats:
    """Per-request accounting: how many pairs ran in each bucket and how
    many device batches were dispatched."""

    pairs_per_bucket: dict
    batches_per_bucket: dict

    @property
    def total_pairs(self) -> int:
        return sum(self.pairs_per_bucket.values())


def _features(examples, rows, key, shape, device):
    """One float32 feature of each row's example, stacked on `device`
    (tensors already there are not copied through the host)."""
    return torch.stack([torch.as_tensor(examples[i][key]).to(
        device, torch.float32).reshape(shape) for i in rows])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _server_device(model, mesh, device):
    """The device a server runs on: the mesh's when there is one; the
    model must live there."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    if getattr(model, "tp_layout", None) is not None:
        raise ValueError("the model holds a rank's tensor-parallel slices; "
                         "a server takes the whole model (on a mesh with a "
                         "model axis, whole on every rank)")
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, server on {dev}")
    return dev


def _predict(batches, forward, mesh, n: int):
    """(tags, stats) of `n` examples from `batches` (the servers'
    `batches()`): each device batch through `forward`, on a mesh this
    rank's rows of it, the ranks' tags gathered in rank order."""
    results: list = [None] * n
    pairs: dict[int, int] = {}
    counts: dict[int, int] = {}
    tags, kept = [], []
    with torch.inference_mode():
        for b, chunk, lens, batch in batches:
            if mesh is not None:
                batch = shard_batch(mesh, batch)
            tags.append(forward(batch).cpu().numpy())
            kept.append((chunk, lens))
            pairs[b] = pairs.get(b, 0) + len(chunk)
            counts[b] = counts.get(b, 0) + 1
    if mesh is not None:
        ranks = all_gather_objects(tags, mesh.group)
        tags = [np.concatenate([r[i] for r in ranks])
                for i in range(len(tags))]
    for t, (chunk, lens) in zip(tags, kept):
        for r, i in enumerate(chunk):
            results[i] = t[r, :lens[r]].astype(np.int32)
    return results, ServingStats(pairs, counts)


class BucketedGateCLServer:
    """Bucketed request-level inference for `GateCLModel` (every variant).

    model: a `GateCLModel` whose parameters live on `device`, built at
        max_seq_length = the largest bucket (the relation classifier's
        flatten width; that bucket is the reference layout).
    buckets: ascending padded lengths.
    max_batch: rows per device batch: one int for every bucket, a
        {bucket: batch} mapping (128 for buckets it does not list), or None
        for `RECOMMENDED_BATCH`.

    mesh: a `core.mesh.Mesh` for data-parallel serving (see the module
        docstring); every bucket's batch must divide by its data size.

    Examples are dicts with a variable-length 1-D ``input_ids`` (optional
    ``segment_ids``), ``visual_mean`` (R,), ``visual_grid`` (7, 7, R) and
    optional ``img_mask`` (49,), as numpy arrays or tensors.
    """

    #: the JAX package's per-bucket batches (buckets not listed take 128);
    #: part of the `_batch_of` contract, untuned on the H100
    RECOMMENDED_BATCH = {16: 512, 24: 256, 32: 256}

    def __init__(self, model, buckets: Sequence[int] = (16, 24, 32, 48, 64,
                                                        128),
                 max_batch=None, mesh=None, device="cuda"):
        buckets = tuple(sorted(buckets))
        if buckets[-1] != model.cfg.max_seq_length:
            raise ValueError(
                f"largest bucket {buckets[-1]} must equal "
                f"max_seq_length {model.cfg.max_seq_length}")
        self.device = _server_device(model, mesh, device)
        self.model = model
        self.buckets = buckets
        self.max_batch = max_batch
        self.mesh = mesh
        if mesh is not None:
            for b in buckets:
                if self._batch_of(b) % mesh.data:
                    raise ValueError(
                        f"bucket {b} batch {self._batch_of(b)} not "
                        f"divisible by mesh size {mesh.data}")

    def _batch_of(self, bucket: int) -> int:
        if self.max_batch is None:
            return self.RECOMMENDED_BATCH.get(bucket, 128)
        if isinstance(self.max_batch, dict):
            return self.max_batch.get(bucket, 128)
        return self.max_batch

    def _empty_batch(self, B: int, b: int):
        cfg = self.model.cfg
        return {
            "input_ids": np.full((B, b), cfg.encoder.pad_token_id, np.int64),
            "segment_ids": np.zeros((B, b), np.int64),
            "input_mask": np.zeros((B, b), np.int64),
            "img_mask": np.ones((B, cfg.num_regions), np.int64),
        }

    def _to_device(self, batch):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def warmup(self) -> None:
        """Run every bucket's batch once (one valid token a row, zero
        images)."""
        cfg = self.model.cfg
        for b in self.buckets:
            B = self._batch_of(b)
            batch = self._empty_batch(B, b)
            batch["input_ids"][:, 0] = 0
            batch["input_mask"][:, 0] = 1
            batch = self._to_device(batch)
            batch["visual_mean"] = torch.zeros(B, cfg.region_dim,
                                               device=self.device)
            batch["visual_grid"] = torch.zeros(B, 7, 7, cfg.region_dim,
                                               device=self.device)
            if self.mesh is not None:
                batch = shard_batch(self.mesh, batch)
            with torch.inference_mode():
                self.model(**batch)
        _sync(self.device)

    def batches(self, examples: Sequence[dict]):
        """Yields (bucket, chunk, lens, batch): `chunk` the example indices
        of one device batch, `lens` their (possibly truncated) lengths, and
        `batch` the model's keyword inputs on the device, rows padded by
        repeating `chunk[0]`."""
        order: dict[int, list[int]] = {b: [] for b in self.buckets}
        for i, ex in enumerate(examples):
            L = min(len(ex["input_ids"]), self.buckets[-1])
            order[pick_bucket(L, self.buckets)].append(i)
        for b, idxs in order.items():
            B = self._batch_of(b)
            for lo in range(0, len(idxs), B):
                chunk = idxs[lo:lo + B]
                rows = chunk + [chunk[0]] * (B - len(chunk))
                batch = self._empty_batch(B, b)
                lens = []
                for r, i in enumerate(rows):
                    ex = examples[i]
                    L = min(len(ex["input_ids"]), b)
                    lens.append(L)
                    batch["input_ids"][r, :L] = np.asarray(
                        ex["input_ids"][:L])
                    if "segment_ids" in ex:
                        batch["segment_ids"][r, :L] = np.asarray(
                            ex["segment_ids"][:L])
                    batch["input_mask"][r, :L] = 1
                    if "img_mask" in ex:
                        batch["img_mask"][r] = np.asarray(ex["img_mask"])
                batch = self._to_device(batch)
                batch["visual_mean"] = _features(examples, rows,
                                                 "visual_mean", (-1,),
                                                 self.device)
                batch["visual_grid"] = _features(examples, rows,
                                                 "visual_grid", (7, 7, -1),
                                                 self.device)
                yield b, chunk, lens, batch

    def predict(self, examples: Sequence[dict]):
        """Returns (tags, stats): ``tags[i]`` is a 1-D int32 numpy array of
        decoded labels at the example's true (possibly truncated) length
        (the same on every rank of a mesh)."""
        return _predict(self.batches(examples),
                        lambda batch: self.model(**batch), self.mesh,
                        len(examples))


class BucketedICKAServer:
    """Bucketed request-level inference for `ICKAModel` (`mode="test"`).

    Examples are dicts at their TRUE sentence length L:

      - ``ori_input_ids`` (L,): bare-sentence token ids
      - ``input_ids`` (offset + L,): prompted layout
      - optional ``ori_segment_ids`` (L,), ``img_mask`` (49,)
      - ``visual_mean`` (R,), ``visual_grid`` (7, 7, R),
        ``clip_features`` (C,) or (1, C): numpy arrays or tensors (tensors
        already on the device are not copied through the host)

    The model's parameters must live on `device` (on `mesh`'s device for
    data-parallel serving, see the module docstring; `max_batch` must
    divide by its data size).
    """

    def __init__(self, model, buckets: Sequence[int] = (16, 24, 32, 48, 64,
                                                        128),
                 max_batch: int = 128, offset: int = 14,
                 mask_positions: tuple = (3, 11), mesh=None, device="cuda"):
        buckets = tuple(sorted(buckets))
        if buckets[-1] != model.cfg.max_seq_length:
            raise ValueError(
                f"largest bucket {buckets[-1]} must equal "
                f"max_seq_length {model.cfg.max_seq_length}")
        self.device = _server_device(model, mesh, device)
        self.model = model
        self.buckets = buckets
        self.max_batch = max_batch
        self.offset = offset
        self.mask_positions = tuple(mask_positions)
        self.mesh = mesh
        if mesh is not None and max_batch % mesh.data:
            raise ValueError(f"max_batch {max_batch} not divisible by mesh "
                             f"size {mesh.data}")

    def _empty_batch(self, b: int):
        cfg = self.model.cfg
        B, off = self.max_batch, self.offset
        pad = cfg.embedding.pad_token_id
        return {
            "input_ids": np.full((B, off + b), pad, np.int64),
            "segment_ids": np.concatenate(
                [np.zeros((B, off), np.int64), np.ones((B, b), np.int64)], 1),
            "input_mask": np.zeros((B, off + b), np.int64),
            "ori_input_ids": np.full((B, b), pad, np.int64),
            "ori_input_mask": np.zeros((B, b), np.int64),
            "ori_segment_ids": np.zeros((B, b), np.int64),
            "img_mask": np.ones((B, cfg.num_regions), np.int64),
            "output_mask": np.zeros((B, b), np.int64),
        }

    def warmup(self) -> None:
        """Run every bucket's batch once (one valid token a row, the prompt
        head, zero features)."""
        cfg = self.model.cfg
        B = self.max_batch
        for b in self.buckets:
            batch = self._empty_batch(b)
            batch["input_mask"][:, :self.offset + 1] = 1
            batch["ori_input_mask"][:, 0] = 1
            batch["output_mask"][:, 0] = 1
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            for key, shape in (("clip_features", (1, cfg.clip_dim)),
                               ("visual_mean", (cfg.region_dim,)),
                               ("visual_grid", (7, 7, cfg.region_dim))):
                batch[key] = torch.zeros(B, *shape, device=self.device)
            if self.mesh is not None:
                batch = shard_batch(self.mesh, batch)
            with torch.inference_mode():
                self.model(batch, self.mask_positions, self.offset,
                           mode="test")
        _sync(self.device)

    def batches(self, examples: Sequence[dict]):
        """Yields (bucket, chunk, lens, batch): `chunk` the example indices
        of one device batch, `lens` their (possibly truncated) lengths, and
        `batch` the padded tensors on the device, rows padded by repeating
        `chunk[0]`."""
        off = self.offset
        order: dict[int, list[int]] = {b: [] for b in self.buckets}
        for i, ex in enumerate(examples):
            L = min(len(ex["ori_input_ids"]), self.buckets[-1])
            order[pick_bucket(L, self.buckets)].append(i)
        for b, idxs in order.items():
            for lo in range(0, len(idxs), self.max_batch):
                chunk = idxs[lo:lo + self.max_batch]
                rows = chunk + [chunk[0]] * (self.max_batch - len(chunk))
                batch = self._empty_batch(b)
                lens = []
                for r, i in enumerate(rows):
                    ex = examples[i]
                    L = min(len(ex["ori_input_ids"]), b)
                    lens.append(L)
                    batch["ori_input_ids"][r, :L] = np.asarray(
                        ex["ori_input_ids"][:L])
                    batch["ori_input_mask"][r, :L] = 1
                    batch["output_mask"][r, :L] = 1
                    if "ori_segment_ids" in ex:
                        batch["ori_segment_ids"][r, :L] = np.asarray(
                            ex["ori_segment_ids"][:L])
                    pl = min(len(ex["input_ids"]), off + L)
                    batch["input_ids"][r, :pl] = np.asarray(
                        ex["input_ids"][:pl])
                    batch["input_mask"][r, :pl] = 1
                    if "img_mask" in ex:
                        batch["img_mask"][r] = np.asarray(ex["img_mask"])
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                for key, shape in (("clip_features", (1, -1)),
                                   ("visual_mean", (-1,)),
                                   ("visual_grid", (7, 7, -1))):
                    batch[key] = _features(examples, rows, key, shape,
                                           self.device)
                yield b, chunk, lens, batch

    def predict(self, examples: Sequence[dict]):
        """Returns (tags, stats): ``tags[i]`` is a 1-D int32 numpy array of
        decoded labels at the example's true (possibly truncated) length
        (the same on every rank of a mesh)."""
        return _predict(
            self.batches(examples),
            lambda batch: self.model(batch, self.mask_positions, self.offset,
                                     mode="test"),
            self.mesh, len(examples))


def sample_tweet_lengths(n: int, rng: np.random.Generator,
                         max_len: int = 128,
                         median: float = 22.0) -> np.ndarray:
    """Synthetic stand-in for the Twitter-2015 subtoken-length distribution:
    a clipped lognormal with p50 about 22 and p95 about 52 (published tweet
    statistics after byte-level BPE plus <s>/</s>). The distribution is
    assumed, not measured; `median` shifts its location."""
    lens = np.exp(rng.normal(np.log(median), 0.45, n)) + 2
    return np.clip(lens.astype(np.int64), 5, max_len)
