"""CoNLL-style dataset readers for Twitter-2015/2017 MNER files (a copy of
`icka_tpu.data.conll`).

Format (reference `mmreadfile`, `My_cross_attention.py:64-113`):

    IMGID:1860693
    RT      O
    @BBCWorld       B-ORG
    ...
    <blank line separates sentences>

Token and label are tab-separated; the label keeps everything after the last
tab minus the trailing newline. B-OTHER/I-OTHER normalize to B-MISC/I-MISC
(:96-99). `read_conll` handles the plain space-separated CoNLL-2003 dialect
(`readfile` :35-62, -DOCSTART skipping included).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class MMExample:
    """One sentence + attached image id + BIO labels."""

    tokens: List[str]
    labels: List[str]
    img_id: str = ""
    aux_labels: List[str] = field(default_factory=list)

    @property
    def text(self) -> str:
        return " ".join(self.tokens)


def read_conll(path: str):
    """Plain CoNLL: space-separated `token ... label` lines."""
    data = []
    sentence, labels = [], []
    with open(path) as f:
        for line in f:
            if (not line.strip()) or line.startswith("-DOCSTART"):
                if sentence:
                    data.append((sentence, labels))
                    sentence, labels = [], []
                continue
            parts = line.split(" ")
            sentence.append(parts[0])
            labels.append(parts[-1].rstrip("\n"))
    if sentence:
        data.append((sentence, labels))
    return data


_OTHER = {"B-OTHER": "B-MISC", "I-OTHER": "I-MISC"}


def read_mm_conll(path: str) -> List[MMExample]:
    """Multimodal dialect with IMGID: headers and tab separation."""
    examples: List[MMExample] = []
    tokens, labels, aux = [], [], []
    img_id = ""
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.startswith("IMGID:"):
                img_id = line.strip().split("IMGID:")[1] + ".jpg"
                continue
            if not line.strip():
                if tokens:
                    examples.append(MMExample(tokens, labels, img_id, aux))
                    tokens, labels, aux = [], [], []
                    img_id = ""
                continue
            parts = line.split("\t")
            tokens.append(parts[0])
            lab = parts[-1].rstrip("\n")
            lab = _OTHER.get(lab, lab)
            labels.append(lab)
            aux.append(lab[0])
    if tokens:
        examples.append(MMExample(tokens, labels, img_id, aux))
    return examples
