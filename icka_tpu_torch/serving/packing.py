"""Sequence-packed serving of the gate_cl family and of the flagship ICKA
model (port of `icka_tpu.serving.packing`: `PackedStats`,
`pack_first_fit`, `PackedGateCLServer`, `PackedICKAServer`).

Bucketed serving (`icka_tpu_torch.serving.bucketed`) still pads every
request to its bucket and gives it a batch row of its own. Packing puts
several short requests into one row of a fixed-shape program and keeps them
apart exactly:

  - block-diagonal self-attention: a token's keys are its own sentence's
    tokens (`GateCLModel.forward_packed`, `ICKAModel.forward_packed`);
  - per-slot visual keys: a sentence cross-attends only to its own image's
    49 regions;
  - per-segment position ids, computed on the host in the encoder's dialect;
  - BiLSTM carries reset (the flagship's) and the Viterbi lattice cut at
    segment boundaries, so one (B, L) decode gives every packed sentence
    the path it would get alone.

gate_cl's relation gate runs with the `masked_crs=True` semantics (missing
positions contribute exact zeros to its flatten): the reference-quirk
padding-tail flatten has no packed counterpart.

The host side is numpy; the device program is one `forward_packed` call per
batch under `torch.inference_mode()`, its arrays moved to the device once.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from icka_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class PackedStats:
    """Packing efficiency accounting for one predict() call."""

    pairs: int
    rows: int
    batches: int
    token_fill: float      # valid tokens / (rows * row_len)
    slot_fill: float       # segments / (rows * max_slots)


def pack_first_fit(lengths: Sequence[int], row_len: int,
                   max_slots: int) -> list:
    """First-fit-decreasing bin packing of segment lengths into rows.

    Returns a list of rows, each a list of request indices. A row holds at
    most `max_slots` segments and at most `row_len` tokens in all."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    rows: list = []
    space: list = []
    slots: list = []
    for i in order:
        ln = lengths[i]
        for r in range(len(rows)):
            if space[r] >= ln and slots[r] < max_slots:
                rows[r].append(i)
                space[r] -= ln
                slots[r] += 1
                break
        else:
            rows.append([i])
            space.append(row_len - ln)
            slots.append(1)
    return rows


def _position_ids(cfg, length: int) -> np.ndarray:
    """The positions a segment would see if it ran alone: the RoBERTa
    dialect counts from pad_token_id + 1, legacy BERT from 0."""
    if cfg.position_offset > 0:
        return np.arange(1, length + 1, dtype=np.int32) + cfg.pad_token_id
    return np.arange(length, dtype=np.int32)


def _to_device(host: dict, placed: Sequence, features: Sequence, device):
    """A host batch's integer arrays as int64 on `device`, beside per-slot
    float32 features (key, shape): zeros, but for the examples in
    `placed`, a list of (row, slot, example)."""
    B, S = host["img_mask"].shape[:2]
    batch = {k: torch.from_numpy(v).to(device, torch.int64)
             for k, v in host.items()}
    for key, shape in features:
        batch[key] = torch.zeros(B, S, *shape, device=device)
        if placed:
            rows, slots, exs = zip(*placed)
            batch[key][list(rows), list(slots)] = torch.stack([
                torch.as_tensor(ex[key]).to(device, torch.float32)
                .reshape(shape) for ex in exs])
    return batch


def _tier_of(tiers, length: int) -> int:
    for t, (L, _) in enumerate(tiers):
        if length <= L:
            return t
    return len(tiers) - 1


class PackedGateCLServer:
    """Packed request-level inference for `GateCLModel` (every variant).

    model: a `GateCLModel` whose parameters live on `device`, built at the
        deployment's max_seq_length (the relation classifier's flatten
        width).
    tiers: ((row_len, max_slots), ...) ascending. A request goes to the
        first tier whose row length holds it, so short tweets pack into
        short rows and the long tail still gets a full-length tier.
        Requests longer than the last tier are truncated to it. The default
        is the JAX package's; its optimum on the H100 is not yet measured.
    max_batch: rows per device batch.
    row_len, max_slots: single-tier shorthand, overrides `tiers`.

    Examples are dicts as for `BucketedGateCLServer.predict`:
    variable-length ``input_ids``, optional ``segment_ids`` / ``img_mask``,
    ``visual_grid`` (7, 7, R); ``visual_mean`` is accepted and unused (only
    the training-time contrastive heads read it).
    """

    def __init__(self, model, tiers: Sequence = ((48, 2), (128, 2)),
                 max_batch: int = 128, row_len: int | None = None,
                 max_slots: int = 6, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        if row_len is not None:
            tiers = ((int(row_len), int(max_slots)),)
        self.tiers = tuple((int(a), int(b)) for a, b in tiers)
        self.max_batch = int(max_batch)

    def _features(self):
        return (("visual_grid", (7, 7, self.model.cfg.region_dim)),)

    def apply_packed(self, batch):
        """One packed forward on a batch from `build_batch`: (B, L) int32
        tags in packed order, on the device."""
        with torch.inference_mode():
            return self.model.forward_packed(batch)

    def _empty_batch(self, B: int, row_len: int, max_slots: int):
        cfg = self.model.cfg
        L, S = row_len, max_slots
        return {
            "ids": np.full((B, L), cfg.encoder.pad_token_id, np.int32),
            "pos": np.zeros((B, L), np.int32),
            "types": np.zeros((B, L), np.int32),
            "slot": np.full((B, L), S, np.int32),      # sentinel slot
            "valid": np.zeros((B, L), np.int32),
            "seg_start": np.zeros((B, L), np.int32),
            "img_mask": np.ones((B, S, cfg.num_regions), np.int32),
            "seg_gather": np.full((B, S, cfg.max_seq_length), L, np.int32),
        }

    def warmup(self) -> None:
        """Run every tier's batch once (one valid token a row)."""
        for L, S in self.tiers:
            b = self._empty_batch(self.max_batch, L, S)
            b["valid"][:, 0] = 1
            b["seg_start"][:, 0] = 1
            b["slot"][:, 0] = 0
            self.apply_packed(_to_device(b, (), self._features(),
                                         self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_batch(self, examples, lengths, chunk_rows, row_len=None,
                    max_slots=None):
        """One device batch from packed rows. `chunk_rows`: at most
        `max_batch` rows from `pack_first_fit`, each a list of example
        indices; `row_len` / `max_slots` select the tier (default: the
        last, longest). Returns (dict of tensors on the device, spans as
        (row, example index, start, length), count of valid tokens)."""
        cfg = self.model.cfg
        if row_len is None:
            row_len, max_slots = self.tiers[-1]
        b = self._empty_batch(self.max_batch, row_len, max_slots)
        spans: list = []
        placed: list = []
        valid_tokens = 0
        for r, segs in enumerate(chunk_rows):
            cursor = 0
            for s, i in enumerate(segs):
                ex = examples[i]
                ln = lengths[i]
                a = cursor
                b["ids"][r, a:a + ln] = np.asarray(ex["input_ids"][:ln],
                                                   np.int32)
                b["pos"][r, a:a + ln] = _position_ids(cfg.encoder, ln)
                if "segment_ids" in ex:
                    b["types"][r, a:a + ln] = np.asarray(
                        ex["segment_ids"][:ln], np.int32)
                b["slot"][r, a:a + ln] = s
                b["valid"][r, a:a + ln] = 1
                b["seg_start"][r, a] = 1
                if "img_mask" in ex:
                    b["img_mask"][r, s] = np.asarray(ex["img_mask"], np.int32)
                b["seg_gather"][r, s, :ln] = np.arange(a, a + ln,
                                                       dtype=np.int32)
                placed.append((r, s, ex))
                spans.append((r, i, a, ln))
                cursor += ln
            valid_tokens += cursor
        return (_to_device(b, placed, self._features(), self.device), spans,
                valid_tokens)

    def predict(self, examples: Sequence[dict]):
        """Returns (tags, stats): ``tags[i]`` is a 1-D int32 numpy array at
        the example's true (possibly truncated) length."""
        Lmax = self.tiers[-1][0]
        lengths = [min(len(ex["input_ids"]), Lmax) for ex in examples]
        return _predict_packed(self, examples, lengths)


def _predict_packed(server, examples, lengths):
    """Route each example to its tier, pack each tier's examples
    first-fit-decreasing into rows, and run them `max_batch` rows a batch
    through `server.build_batch` and `server.apply_packed`. Returns (tags,
    PackedStats)."""
    by_tier: dict[int, list[int]] = {t: [] for t in range(len(server.tiers))}
    for i, ln in enumerate(lengths):
        by_tier[_tier_of(server.tiers, ln)].append(i)
    results: list = [None] * len(examples)
    batches = total_rows = valid_tokens = cap_tokens = total_slots = 0
    for t, idxs in by_tier.items():
        if not idxs:
            continue
        L, S = server.tiers[t]
        rows = pack_first_fit([lengths[i] for i in idxs], L, S)
        rows = [[idxs[j] for j in row] for row in rows]
        total_rows += len(rows)
        cap_tokens += len(rows) * L
        total_slots += len(rows) * S
        for lo in range(0, len(rows), server.max_batch):
            chunk = rows[lo:lo + server.max_batch]
            b, spans, toks = server.build_batch(examples, lengths, chunk, L,
                                                S)
            valid_tokens += toks
            tags = server.apply_packed(b).cpu().numpy()
            batches += 1
            for r, i, a, ln in spans:
                results[i] = tags[r, a:a + ln].astype(np.int32)
    stats = PackedStats(
        pairs=len(examples), rows=total_rows, batches=batches,
        token_fill=valid_tokens / max(1, cap_tokens),
        slot_fill=len(examples) / max(1, total_slots))
    return results, stats


class PackedICKAServer:
    """Packed request-level inference for `ICKAModel`
    (`ICKAModel.forward_packed` describes the two token layouts).

    model: an `ICKAModel` whose parameters live on `device`.
    mask_positions, offset: the prompted layout, as `BucketedICKAServer`
        takes them.
    tiers: ((row_len, max_slots), ...) ascending. A request goes to the
        first tier whose row length holds it, so short tweets pack into
        short rows (attention cost grows with the row's length, not the
        tweet's) and the long tail still gets a full-length tier. Requests
        longer than the last tier are truncated to it. The default is the
        JAX package's; its optimum on the H100 is not yet measured. Each
        tier runs two packed token axes: layout A of `row_len` tokens and
        layout B of `row_len + max_slots * (offset - 2 + 2 * prompt_len)`.
    max_batch: rows per device batch.
    row_len, max_slots: single-tier shorthand, overrides `tiers`.

    Examples are dicts at their true sentence length L, as for
    `BucketedICKAServer.predict`: ``ori_input_ids`` (L,), ``input_ids``
    (offset + L,), optional ``ori_segment_ids`` / ``segment_ids`` /
    ``img_mask``, and ``visual_mean`` (R,), ``visual_grid`` (7, 7, R),
    ``clip_features`` (C,) or (1, C) as numpy arrays or tensors (tensors
    already on the device are not copied through the host).

    Decoded tags equal those of the one-example-padded layout when the solo
    model runs `masked_lstm=True` (a packed row has no padding tail for the
    unmasked BiLSTM to scan); against the unmasked default the agreement is
    statistical.
    """

    def __init__(self, model, mask_positions=(3, 11), offset: int = 14,
                 tiers: Sequence = ((48, 2), (128, 2)), max_batch: int = 128,
                 row_len: int | None = None, max_slots: int = 6,
                 device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.offset = int(offset)
        self.mask_positions = tuple(mask_positions)
        if row_len is not None:
            tiers = ((int(row_len), int(max_slots)),)
        self.tiers = tuple((int(a), int(b)) for a, b in tiers)
        self.max_batch = int(max_batch)

    def _seg_overhead(self) -> int:
        """Layout-B tokens a segment takes beyond its sentence: the spliced
        prompt head."""
        return self.offset - 2 + 2 * self.model.cfg.prompt_len

    def _lengths(self, examples) -> list:
        """Each example's sentence length, truncated to the last tier, after
        checking that its prompted ids cover offset + length."""
        Lmax = self.tiers[-1][0]
        lengths = [min(len(ex["ori_input_ids"]), Lmax) for ex in examples]
        for i, (ex, ln) in enumerate(zip(examples, lengths)):
            if len(ex["input_ids"]) < self.offset + ln:
                raise ValueError(
                    f"example {i}: input_ids has {len(ex['input_ids'])} "
                    f"tokens, offset + sentence needs {self.offset + ln}")
        return lengths

    # -- device program ----------------------------------------------------

    def apply_packed(self, batch):
        """One packed forward on a batch from `build_batch`: (B, L1) int32
        tags in packed order, on the device."""
        with torch.inference_mode():
            return self.model.forward_packed(batch)

    def _empty_batch(self, B: int, row_len: int, max_slots: int):
        cfg = self.model.cfg
        L1, S = row_len, max_slots
        L2 = row_len + max_slots * self._seg_overhead()
        K = S * 2 * cfg.prompt_len
        pad_a = cfg.embedding.pad_token_id
        pad_b = cfg.last_encoder.pad_token_id
        return {
            "ids_a": np.full((B, L1), pad_a, np.int32),
            "pos_a": np.full((B, L1), pad_a, np.int32),
            "types_a": np.zeros((B, L1), np.int32),
            "slot_a": np.full((B, L1), S, np.int32),
            "valid_a": np.zeros((B, L1), np.int32),
            "seg_start": np.zeros((B, L1), np.int32),
            "seg_end": np.zeros((B, L1), np.int32),
            "ids_b": np.full((B, L2), pad_b, np.int32),
            "pos_b": np.full((B, L2), pad_b, np.int32),
            "types_b": np.zeros((B, L2), np.int32),
            "slot_b": np.full((B, L2), S, np.int32),
            "prompt_gather": np.full((B, L2), K, np.int32),
            "sent_gather": np.full((B, L1), L2, np.int32),
            "seg_first": np.full((B, S), L1, np.int32),
            "img_mask": np.ones((B, S, cfg.num_regions), np.int32),
        }

    def _features(self):
        cfg = self.model.cfg
        return (("visual_grid", (7, 7, cfg.region_dim)),
                ("visual_mean", (cfg.region_dim,)),
                ("clip_features", (cfg.clip_dim,)))

    def warmup(self) -> None:
        """Run every tier's program once on a one-token batch."""
        for L, S in self.tiers:
            b = self._empty_batch(self.max_batch, L, S)
            for key in ("valid_a", "seg_start", "seg_end"):
                b[key][:, 0] = 1
            b["slot_a"][:, 0] = 0
            b["seg_first"][:, 0] = 0
            self.apply_packed(_to_device(b, (), self._features(),
                                         self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host packing ------------------------------------------------------

    def build_batch(self, examples, lengths, chunk_rows, row_len=None,
                    max_slots=None):
        """One device batch from packed rows. `chunk_rows`: at most
        `max_batch` rows from `pack_first_fit`, each a list of example
        indices; `row_len` / `max_slots` select the tier (default: the
        last, longest). Returns (dict of tensors on the device, spans as
        (row, example index, layout-A start, length), count of valid
        layout-A tokens)."""
        cfg = self.model.cfg
        off = self.offset
        m1, m2 = self.mask_positions
        P = cfg.prompt_len
        if row_len is None:
            row_len, max_slots = self.tiers[-1]
        ovh = self._seg_overhead()
        b = self._empty_batch(self.max_batch, row_len, max_slots)
        placeholder = np.full(P, cfg.last_encoder.pad_token_id, np.int32)
        spans: list = []
        placed: list = []
        valid_tokens = 0
        for r, segs in enumerate(chunk_rows):
            ca = cb = 0
            for s, i in enumerate(segs):
                ex = examples[i]
                ln = lengths[i]
                a = ca
                # -- layout A: the bare sentence --------------------------
                b["ids_a"][r, a:a + ln] = np.asarray(
                    ex["ori_input_ids"][:ln], np.int32)
                b["pos_a"][r, a:a + ln] = _position_ids(cfg.embedding, ln)
                if "ori_segment_ids" in ex:
                    b["types_a"][r, a:a + ln] = np.asarray(
                        ex["ori_segment_ids"][:ln], np.int32)
                b["slot_a"][r, a:a + ln] = s
                b["valid_a"][r, a:a + ln] = 1
                b["seg_start"][r, a] = 1
                b["seg_end"][r, a + ln - 1] = 1
                b["seg_first"][r, s] = a
                # -- layout B: the spliced prompted sequence --------------
                prompted = np.asarray(ex["input_ids"][:off + ln], np.int32)
                sp = np.concatenate([
                    prompted[:m1], placeholder, prompted[m1 + 1:m2],
                    placeholder, prompted[m2 + 1:]])
                lb = ln + ovh
                if sp.shape[0] != lb:
                    raise ValueError(
                        f"example {i}: input_ids has {prompted.shape[0]} "
                        f"tokens, offset + sentence needs {off + ln}")
                bb = cb
                b["ids_b"][r, bb:bb + lb] = sp
                b["pos_b"][r, bb:bb + lb] = _position_ids(
                    cfg.last_encoder, lb)
                if "segment_ids" in ex:
                    ty = np.asarray(ex["segment_ids"][:off + ln], np.int32)
                else:
                    ty = np.concatenate([np.zeros(off, np.int32),
                                         np.ones(ln, np.int32)])
                # the prompt slots take the type at their mask position, as
                # on the solo path
                b["types_b"][r, bb:bb + lb] = np.concatenate([
                    ty[:m1], np.full(P, ty[m1], np.int32), ty[m1 + 1:m2],
                    np.full(P, ty[m2], np.int32), ty[m2 + 1:]])
                b["slot_b"][r, bb:bb + lb] = s
                k0 = s * 2 * P
                p1 = bb + m1
                b["prompt_gather"][r, p1:p1 + P] = np.arange(
                    k0, k0 + P, dtype=np.int32)
                p2 = bb + m2 - 1 + P
                b["prompt_gather"][r, p2:p2 + P] = np.arange(
                    k0 + P, k0 + 2 * P, dtype=np.int32)
                b["sent_gather"][r, a:a + ln] = np.arange(
                    bb + ovh, bb + ovh + ln, dtype=np.int32)
                # -- per-slot visual and CLIP features --------------------
                if "img_mask" in ex:
                    b["img_mask"][r, s] = np.asarray(ex["img_mask"], np.int32)
                placed.append((r, s, ex))
                spans.append((r, i, a, ln))
                ca += ln
                cb += lb
            valid_tokens += ca
        return (_to_device(b, placed, self._features(), self.device), spans,
                valid_tokens)

    def predict(self, examples: Sequence[dict]):
        """Returns (tags, stats): ``tags[i]`` is a 1-D int32 numpy array at
        the example's true (possibly truncated) length."""
        return _predict_packed(self, examples, self._lengths(examples))
