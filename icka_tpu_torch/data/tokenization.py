r"""Tokenizers: BERT WordPiece and RoBERTa byte-level BPE (a copy of
`icka_tpu.data.tokenization` on the standard library's `re`).

Self-contained reimplementations of the two tokenization dialects the
reference consumes:

  - WordPiece (`my_bert/tokenization.py:51-332`): unicode cleanup, optional
    lowercasing + accent stripping, CJK spacing, punctuation splitting, then
    greedy longest-match wordpiece with `##` continuations and per-word
    max-length fallback to `[UNK]`;
  - byte-level BPE (the HF `RobertaTokenizer` loaded by the reference script,
    `My_cross_attention.py:661,670`): GPT-2 byte↔unicode table, merge-rank
    BPE over a `vocab.json` + `merges.txt` pair, `Ġ`-prefixed space marking.

Both load from local files only (no hub access). A `tiny_bpe_files` helper
builds a miniature-but-real vocab for tests and synthetic benchmarks.

The JAX package splits BPE words with the `regex` module's `\p{L}`/`\p{N}`
classes. Here the same pattern is built for stdlib `re` from explicit
code-point ranges: the letter and number classes are `regex`'s own, kept as
a table (`icka_tpu_torch.data._unicode_classes`, which names the `regex`
version), so the split does not depend on the interpreter's Unicode; and
whitespace is the Unicode White_Space property (what `regex`'s `\s`
matches; stdlib `\s` also takes U+001C..U+001F). The pattern is built once
at the first BPE tokenizer.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Iterable, List

import re

from icka_tpu_torch.data._unicode_classes import LETTER, NUMBER


# ---------------------------------------------------------------------------
# WordPiece (BERT dialect)
# ---------------------------------------------------------------------------

def load_vocab(path: str) -> dict[str, int]:
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BasicTokenizer:
    """Whitespace/punct/CJK splitting with optional lowercasing."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        tokens = []
        for tok in text.strip().split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return " ".join(tokens).strip().split()

    @staticmethod
    def _clean(text):
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text):
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text):
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(text):
        out, word = [], []
        for ch in text:
            if _is_punctuation(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out


class WordpieceTokenizer:
    """Greedy longest-match subwords with `##` continuation prefix."""

    def __init__(self, vocab: dict[str, int], unk_token="[UNK]",
                 max_chars_per_word=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in text.strip().split():
            if len(word) > self.max_chars_per_word:
                out.append(self.unk_token)
                continue
            start, pieces, bad = 0, [], False
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    piece = word[start:end]
                    if start > 0:
                        piece = "##" + piece
                    if piece in self.vocab:
                        cur = piece
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                pieces.append(cur)
                start = end
            out.extend([self.unk_token] if bad else pieces)
        return out


class BertTokenizer:
    """Full WordPiece pipeline + id conversion (BERT dialect)."""

    cls_token = "[CLS]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    unk_token = "[UNK]"
    mask_token = "[MASK]"

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(self.vocab)

    # The bos/eos aliases let feature construction treat BERT and RoBERTa
    # uniformly (the reference switches by hand, :284-298).
    @property
    def bos_token(self):
        return self.cls_token

    @property
    def eos_token(self):
        return self.sep_token

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]


# ---------------------------------------------------------------------------
# Byte-level BPE (RoBERTa dialect)
# ---------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte → printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# the Unicode White_Space property: the code points `regex` matches by \s
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


def _char_class(ranges) -> str:
    """Ranges as the body of a `re` character class."""
    def esc(cp):
        return f"\\U{cp:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in ranges)


@lru_cache(maxsize=None)
def bpe_pattern() -> re.Pattern:
    """The GPT-2 split pattern
    `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`
    with explicit letter, number and whitespace classes."""
    letter = _char_class(LETTER)
    number = _char_class(NUMBER)
    space = _char_class(_WHITE_SPACE)
    return re.compile(
        rf"""'s|'t|'re|'ve|'m|'ll|'d| ?[{letter}]+| ?[{number}]+"""
        rf"""| ?[^{space}{letter}{number}]+|[{space}]+(?![^{space}])"""
        rf"""|[{space}]+""")


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ByteLevelBPETokenizer:
    """RoBERTa/GPT-2 tokenizer over local vocab.json + merges.txt."""

    bos_token = "<s>"
    eos_token = "</s>"
    pad_token = "<pad>"
    unk_token = "<unk>"
    mask_token = "<mask>"

    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab: dict[str, int] = json.load(f)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        with open(merges_file, encoding="utf-8") as f:
            merges = [tuple(line.split())
                      for line in f.read().split("\n")
                      if line and not line.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, str] = {}
        self._pattern = bpe_pattern()

    @property
    def pad_token_id(self):
        return self.vocab[self.pad_token]

    @property
    def mask_token_id(self):
        return self.vocab[self.mask_token]

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self._pattern.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out.extend(self._bpe(tok).split(" "))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.convert_ids_to_tokens(ids))
        data = bytearray(self.byte_decoder.get(c, ord(" ")) for c in text)
        return data.decode("utf-8", errors="replace")


def tiny_bpe_files(directory: str, words: Iterable[str] = ()) -> tuple[str, str]:
    """Write a miniature vocab.json/merges.txt with full byte coverage plus
    whole-word entries for `words` — enough for tests and synthetic data."""
    os.makedirs(directory, exist_ok=True)
    byte_syms = list(bytes_to_unicode().values())
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    for s in byte_syms:
        vocab.setdefault(s, len(vocab))
    merges: list[tuple[str, str]] = []
    enc = bytes_to_unicode()
    space = enc[ord(" ")]
    for w in words:
        sym = "".join(enc[b] for b in w.encode("utf-8"))
        if sym not in vocab:
            # chain merges left-to-right: (a, b), (ab, c), ...
            acc = sym[0]
            for ch in sym[1:]:
                merges.append((acc, ch))
                acc += ch
                vocab.setdefault(acc, len(vocab))
        # space-prefixed variant merges AFTER the plain word is complete so
        # ranked BPE (which applies the lowest-rank inner merges first)
        # still reaches the single Ġword token.
        if space + sym not in vocab:
            merges.append((space, sym))
            vocab.setdefault(space + sym, len(vocab))
    vpath = os.path.join(directory, "vocab.json")
    mpath = os.path.join(directory, "merges.txt")
    with open(vpath, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(mpath, "w", encoding="utf-8") as f:
        f.write("#version: tiny\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return vpath, mpath
