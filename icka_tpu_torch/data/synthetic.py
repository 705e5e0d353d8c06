"""Synthetic Twitter-MNER-format dataset generator (a copy of
`icka_tpu.data.synthetic`; PIL is imported only to write images).

The real Twitter-2015/2017 data is not distributed with either repo, so
tests, benchmarks and smoke training runs use a generated dataset with the
exact on-disk layout the reference consumes:

    {root}/train.txt, valid.txt, test.txt     (IMGID: + token\tlabel lines)
    {root}/Clip/{split}_features.pkl          (img_id → {"text_features"})
    {root}/images/{img_id}.jpg                (RGB jpegs)

Sentences are sampled from a small vocabulary with planted PER/LOC/ORG/MISC
entities so a real model can actually learn (loss ↓, F1 ↑) on it.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Sequence

import numpy as np

PEOPLE = ["alice", "bob", "carol", "david", "erin"]
PLACES = ["paris", "tokyo", "berlin", "oslo"]
ORGS = ["nasa", "google", "united", "acme"]
MISCS = ["olympics", "oscars"]
FILLER = ["the", "a", "went", "to", "saw", "meets", "in", "at", "with",
          "today", "photo", "great", "game", "new", "rt"]

VOCAB_WORDS = PEOPLE + PLACES + ORGS + MISCS + FILLER


def _sentence(rng: random.Random):
    tokens, labels = [], []
    n_spans = rng.randint(1, 2)
    for _ in range(rng.randint(2, 5)):
        tokens.append(rng.choice(FILLER))
        labels.append("O")
    for _ in range(n_spans):
        kind = rng.choice(["PER", "LOC", "ORG", "MISC"])
        pool = {"PER": PEOPLE, "LOC": PLACES, "ORG": ORGS,
                "MISC": MISCS}[kind]
        span = rng.sample(pool, rng.randint(1, min(2, len(pool))))
        tokens.append(span[0])
        labels.append(f"B-{kind}")
        for w in span[1:]:
            tokens.append(w)
            labels.append(f"I-{kind}")
        for _ in range(rng.randint(1, 3)):
            tokens.append(rng.choice(FILLER))
            labels.append("O")
    return tokens, labels


def generate_dataset(root: str, n_train=64, n_valid=16, n_test=16,
                     clip_dim: int = 512, image_size: int = 64,
                     seed: int = 0, write_images: bool = True):
    """Write the synthetic dataset; returns the root path."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "Clip"), exist_ok=True)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    counter = 0
    for split, n in (("train", n_train), ("valid", n_valid),
                     ("test", n_test)):
        clip = {}
        lines = []
        for _ in range(n):
            tokens, labels = _sentence(rng)
            img_id = f"{counter}"
            counter += 1
            lines.append(f"IMGID:{img_id}\n")
            for t, l in zip(tokens, labels):
                lines.append(f"{t}\t{l}\n")
            lines.append("\n")
            clip[img_id] = {
                "text_features": nprng.standard_normal(clip_dim)
                .astype(np.float32)}
            if write_images:
                from PIL import Image
                arr = nprng.integers(0, 255, (image_size, image_size, 3),
                                     dtype=np.uint8)
                Image.fromarray(arr).save(
                    os.path.join(img_dir, f"{img_id}.jpg"))
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.writelines(lines)
        with open(os.path.join(root, "Clip", f"{split}_features.pkl"),
                  "wb") as f:
            pickle.dump(clip, f)
    return root


def tiny_tokenizer(directory: str):
    """A byte-level BPE tokenizer whose vocab covers the synthetic words."""
    from icka_tpu_torch.data.tokenization import (
        ByteLevelBPETokenizer,
        tiny_bpe_files,
    )

    vpath, mpath = tiny_bpe_files(directory, VOCAB_WORDS + [
        "Image", "is", "Bridge", "between", "and", "the", "Text"])
    return ByteLevelBPETokenizer(vpath, mpath)
