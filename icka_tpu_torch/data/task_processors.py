"""Vision-language task processors: VQA / GQA / NLVR2 / VCR (a copy of
`icka_tpu.data.task_processors`, host code: json, pickle and numpy).

`utils/task_utils.py` (reference component #26): JSON -> typed examples ->
fixed-shape arrays for sentence-pair + image-region classification heads.
Features are columnar numpy (structure of arrays) ready for device
batching; image-region features are padded to `max_img_seq_length` with an
attention-mask extension like the reference's
`convert_examples_to_features_vqa` (:415-594). `convert_vl_examples` takes
the port's tokenizers (`data.tokenization`).
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclass
class VLInstance:
    """One VL-classification example (`InputInstance` equivalent)."""

    guid: str
    text_a: str
    text_b: Optional[Any] = None       # str, or list of choices for VCR
    label: Any = None
    score: Any = None
    img_key: str = ""
    q_id: int = 0


class VLProcessor:
    train_file = ""
    dev_file = ""
    test_file = ""

    def _load(self, data_dir: str, file_name: str):
        with open(os.path.join(data_dir, file_name)) as f:
            return json.load(f)

    def get_train_examples(self, data_dir, file_name=None):
        return self._create(self._load(data_dir,
                                       file_name or self.train_file),
                            "train")

    def get_dev_examples(self, data_dir, file_name=None):
        return self._create(self._load(data_dir, file_name or self.dev_file),
                            "dev")

    def get_test_examples(self, data_dir, file_name=None):
        return self._create(self._load(data_dir,
                                       file_name or self.test_file),
                            "test")

    def get_labels(self, label_file=None):
        raise NotImplementedError

    def _create(self, lines, set_type) -> List[VLInstance]:
        raise NotImplementedError


class VQATextProcessor(VLProcessor):
    """VQA: question + object tags → soft multi-answer target."""

    train_file = "train2014_qla.json"
    dev_file = "val2014_qla.json"
    test_file = "test2015_qla.json"

    def get_labels(self, label_file=None):
        if label_file:
            with open(label_file, "rb") as f:
                return list(pickle.load(f).values())
        return list(range(3129))

    def _create(self, lines, set_type):
        out = []
        for i, line in enumerate(lines):
            if set_type != "test" and len(line["an"]) == 0:
                continue
            out.append(VLInstance(
                guid=f"{set_type}-{i}",
                text_a=line["q"],
                text_b=line["o"].replace(";", " ").strip(),
                label=None if set_type.startswith("test") else line["an"],
                score=None if set_type.startswith("test") else line["s"],
                img_key=line["img_id"],
                q_id=int(line["q_id"]) if set_type.startswith("test") else 0,
            ))
        return out


class GQAProcessor(VLProcessor):
    train_file = "train_qla.json"
    dev_file = "val_qla.json"
    test_file = "test_qla.json"

    def get_labels(self, label_file=None):
        if label_file:
            with open(label_file, "rb") as f:
                return list(pickle.load(f).values())
        return list(range(1853))

    def _create(self, lines, set_type):
        out = []
        for i, line in enumerate(lines):
            if set_type != "test" and len(str(line["an"])) == 0:
                continue
            out.append(VLInstance(
                guid=f"{set_type}-{i}",
                text_a=line["q"],
                text_b=line.get("o", "").replace(";", " ").strip(),
                label=None if set_type.startswith("test") else line["an"],
                score=0,
                img_key=line["img_id"],
                q_id=int(line["q_id"]) if set_type.startswith("test") else 0,
            ))
        return out


class NLVRProcessor(VLProcessor):
    """NLVR2: statement over an image pair → {False, True}."""

    train_file = "nlvr2_train.json"
    dev_file = "nlvr2_dev.json"
    test_file = "nlvr2_test1.json"

    def get_labels(self, label_file=None):
        return [0, 1]

    def _create(self, lines, set_type):
        out = []
        for i, line in enumerate(lines):
            out.append(VLInstance(
                guid=f"{set_type}-{i}",
                text_a=line["q"],
                text_b=line.get("o", ""),
                label=line.get("label"),
                score=0,
                img_key=line["img_id"],
                q_id=0,
            ))
        return out


class VCRQAProcessor(VLProcessor):
    """VCR question → answer choice (4-way presented as per-choice binary)."""

    train_file = "vcr_train.json"
    dev_file = "vcr_val.json"
    test_file = "vcr_test.json"

    def get_labels(self, label_file=None):
        return [0, 1]

    def _create(self, lines, set_type):
        out = []
        for i, line in enumerate(lines):
            out.append(VLInstance(
                guid=f"{set_type}-{i}",
                text_a=line["q"],
                text_b=line["choices"],
                label=None if set_type.startswith("test")
                else line["label"],
                score=line.get("objects"),
                img_key=line["img_id"],
                q_id=int(line["annot_id"].split("-")[-1]),
            ))
        return out


class VCRQARProcessor(VCRQAProcessor):
    """VCR question+answer → rationale choice; same JSON layout with the
    rationale fields substituted upstream."""


PROCESSORS = {
    "vqa": VQATextProcessor,
    "gqa": GQAProcessor,
    "nlvr": NLVRProcessor,
    "vcr_qa": VCRQAProcessor,
    "vcr_qar": VCRQARProcessor,
}


@dataclass
class VLFeatures:
    input_ids: np.ndarray       # (N, L)
    input_mask: np.ndarray      # (N, L + max_img_seq)
    segment_ids: np.ndarray
    label: np.ndarray
    img_feats: np.ndarray       # (N, max_img_seq, img_dim)


def _truncate_pair(a: list, b: list, max_len: int):
    while len(a) + len(b) > max_len:
        (a if len(a) > len(b) else b).pop()


def convert_vl_examples(examples: Sequence[VLInstance], img_feats: dict,
                        label_list, max_img_seq_length: int,
                        max_seq_length: int, tokenizer,
                        output_mode: str = "classification") -> VLFeatures:
    """Sentence(-pair) + image-region features → fixed arrays.

    Layout: [CLS] A [SEP] (B [SEP]) + pad, segments 0/1, then
    `max_img_seq_length` region slots appended to the attention mask (1 for
    real regions, 0 for pad) — the joint text⊕image mask the `SeqBertImgModel`
    family consumes.
    """
    label_map = {l: i for i, l in enumerate(label_list)}
    n = len(examples)
    img_dim = next(iter(img_feats.values())).shape[-1] if img_feats else 2048

    f = VLFeatures(
        input_ids=np.zeros((n, max_seq_length), np.int32),
        input_mask=np.zeros((n, max_seq_length + max_img_seq_length),
                            np.int32),
        segment_ids=np.zeros((n, max_seq_length), np.int32),
        label=np.zeros((n,), np.int32) if output_mode == "classification"
        else np.zeros((n, len(label_list)), np.float32),
        img_feats=np.zeros((n, max_img_seq_length, img_dim), np.float32),
    )

    cls_tok, sep_tok = tokenizer.bos_token, tokenizer.eos_token
    for row, ex in enumerate(examples):
        tokens_a = tokenizer.tokenize(ex.text_a)
        tokens_b = (tokenizer.tokenize(ex.text_b)
                    if isinstance(ex.text_b, str) and ex.text_b else None)
        if tokens_b:
            _truncate_pair(tokens_a, tokens_b, max_seq_length - 3)
        else:
            tokens_a = tokens_a[: max_seq_length - 2]
        tokens = [cls_tok] + tokens_a + [sep_tok]
        segs = [0] * len(tokens)
        if tokens_b:
            tokens += tokens_b + [sep_tok]
            segs += [1] * (len(tokens_b) + 1)
        ids = tokenizer.convert_tokens_to_ids(tokens)
        f.input_ids[row, : len(ids)] = ids
        f.segment_ids[row, : len(segs)] = segs
        f.input_mask[row, : len(ids)] = 1

        feats = img_feats.get(str(ex.img_key))
        if feats is not None:
            k = min(len(feats), max_img_seq_length)
            f.img_feats[row, :k] = feats[:k]
            f.input_mask[row, max_seq_length:max_seq_length + k] = 1

        if ex.label is not None:
            if output_mode == "classification":
                f.label[row] = label_map.get(ex.label, 0) \
                    if not isinstance(ex.label, list) \
                    else label_map.get(ex.label[0], 0)
            else:
                for lab, sc in zip(ex.label, ex.score or []):
                    if lab in label_map:
                        f.label[row, label_map[lab]] = sc
    return f
