"""The text data plane of the PyTorch/CUDA port against the JAX package's,
bit for bit: the synthetic corpus on disk, the CoNLL readers, both
tokenizers (the port's stdlib-`re` BPE split against the `regex` one), the
prompted features key by key, the CLIP store and `filter_predictions`."""

import filecmp
import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
regex = pytest.importorskip("regex")

from icka_tpu.data import clip_store as jclip  # noqa: E402
from icka_tpu.data import conll as jconll  # noqa: E402
from icka_tpu.data import features as jfeatures  # noqa: E402
from icka_tpu.data import labels as jlabels  # noqa: E402
from icka_tpu.data import synthetic as jsynthetic  # noqa: E402
from icka_tpu.data import tokenization as jtok  # noqa: E402
from icka_tpu.train.trainer import filter_predictions as jfilter  # noqa: E402
from icka_tpu_torch.data import clip_store as tclip  # noqa: E402
from icka_tpu_torch.data import conll as tconll  # noqa: E402
from icka_tpu_torch.data import features as tfeatures  # noqa: E402
from icka_tpu_torch.data import labels as tlabels  # noqa: E402
from icka_tpu_torch.data import synthetic as tsynthetic  # noqa: E402
from icka_tpu_torch.data import tokenization as ttok  # noqa: E402
from icka_tpu_torch.train.trainer import filter_predictions  # noqa: E402

# ASCII, contractions, accented Latin (composed and with combining marks),
# Greek, Cyrillic, CJK, Arabic-Indic digits, vulgar fractions, super- and
# subscripts, emoji with modifiers and joiners, underscores, and every
# kind of space the split treats apart
TEXTS = [
    "RT @BBCWorld: it's 2024, they're here & we'll see!",
    "café naïve résumé Ñandú Ærø Łódź",
    "é ä ñ combininǵ̣ marks",
    "Αθήνα είναι ωραία ΩΣ",
    "Москва 123 ёжик",
    "東京タワー 漢字テスト 한국어",
    "٣٤٥ ١٢ ۴۵ arabic-indic",
    "½ cup ² x³ ¼ ⅞ H₂O Ⅻ",
    "emoji 😀🎉 👍🏽 👨‍👩‍👧 ok",
    "under_score x__y __init__",
    "tab\there new\nline  two   three nbsp　ideo thin ",
    "\x1cfile\x1fsep\x0bvt\x85nel",
    "I'm he'd you've 'S 'LL",
    "mixed123abc 42nd 3.14 -7",
    "",
    "   ",
]
EXTRA_WORDS = ["Image", "is", "Bridge", "between", "and", "the", "Text"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same corpus written by both packages (images and all)."""
    root = tmp_path_factory.mktemp("corpus")
    kw = dict(n_train=6, n_valid=7, n_test=5, clip_dim=16, image_size=32,
              seed=3)
    jsynthetic.generate_dataset(str(root / "jax"), **kw)
    tsynthetic.generate_dataset(str(root / "port"), **kw)
    jsynthetic.generate_dataset(str(root / "jax_noimg"), write_images=False,
                                **kw)
    tsynthetic.generate_dataset(str(root / "port_noimg"), write_images=False,
                                **kw)
    return root


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    return (jsynthetic.tiny_tokenizer(str(root / "jax")),
            tsynthetic.tiny_tokenizer(str(root / "port")))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("images", [True, False])
def test_generate_dataset_files_are_byte_equal(corpus, images):
    a, b = ((corpus / "jax", corpus / "port") if images else
            (corpus / "jax_noimg", corpus / "port_noimg"))
    names = _files(a)
    assert names == _files(b)
    assert sum(n.endswith(".jpg") for n in names) == (18 if images else 0)
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def test_read_mm_conll_and_read_conll(corpus, tmp_path):
    for split in ("train", "valid", "test"):
        path = str(corpus / "jax" / f"{split}.txt")
        want = jconll.read_mm_conll(path)
        got = tconll.read_mm_conll(path)
        assert [vars(e) for e in got] == [vars(e) for e in want]
    path = tmp_path / "plain.txt"
    path.write_text("-DOCSTART- -X- O O\n\nEU NNP B-NP B-ORG\nrejects VBZ "
                    "B-VP O\n\nPeter NNP B-NP B-PER\nB-OTHER x I-OTHER\n")
    assert tconll.read_conll(str(path)) == jconll.read_conll(str(path))
    mm = tmp_path / "mm.txt"
    mm.write_text("IMGID:9\nBob\tB-PER\nNASA\tB-OTHER\nrocks\tI-OTHER\n\n"
                  "IMGID:10\nno\tO\n")
    got, want = tconll.read_mm_conll(str(mm)), jconll.read_mm_conll(str(mm))
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert got[0].labels == ["B-PER", "B-MISC", "I-MISC"]


def test_labels_are_the_jax_packages():
    assert tlabels.MNER_LABELS == jlabels.MNER_LABELS
    assert tlabels.MNER_AUX_LABELS == jlabels.MNER_AUX_LABELS
    assert tlabels.FILTERED_LABELS == jlabels.FILTERED_LABELS
    assert tlabels.label_map() == jlabels.label_map()
    assert tlabels.id_to_label() == jlabels.id_to_label()
    assert tlabels.num_labels() == jlabels.num_labels()


@pytest.mark.parametrize("text", TEXTS)
def test_bpe_split_equals_regex(text):
    """The stdlib pattern splits exactly as the JAX package's `regex` one."""
    assert ttok.bpe_pattern().findall(text) == \
        regex.findall(jtok._BPE_PATTERN, text)


def test_bpe_classes_equal_regex_on_every_code_point():
    """The port's letter and number classes (its table, compiled into the
    stdlib pattern) against `regex`'s \\p{L} and \\p{N}, and its whitespace
    class against `regex`'s \\s, on every code point from 0 to 0x10FFFF:
    one pass each over a string of all code points in order, whose maximal
    runs are the classes' ranges."""
    from icka_tpu_torch.data import _unicode_classes as table

    assert table.REGEX_VERSION == regex.__version__
    text = "".join(chr(c) for c in range(0x110000))
    cls = ttok._char_class
    space = cls(ttok._WHITE_SPACE)
    for port, want in ((cls(table.LETTER), r"\p{L}+"),
                       (cls(table.NUMBER), r"\p{N}+"), (space, r"\s+")):
        got = [m.span() for m in ttok.re.finditer(f"[{port}]+", text)]
        assert got == [m.span() for m in regex.finditer(want, text)], want
    # and the table is what the pattern is built from
    assert cls(table.LETTER) in ttok.bpe_pattern().pattern


def test_bpe_split_of_a_letter_newer_than_the_interpreter():
    """U+088F is a letter to `regex` 2026.7.19 (Unicode 17) and unassigned
    in Python 3.12's Unicode 15.0: the split keeps it in the word, as the
    JAX package does."""
    text = "ok ࢏abc"
    assert ttok.bpe_pattern().findall(text) == \
        regex.findall(jtok._BPE_PATTERN, text) == ["ok", " ࢏abc"]


def test_bpe_ids_with_a_merge_across_that_letter(tmp_path):
    """One merge added to the tiny files, `ı a` (the last byte of U+088F's
    UTF-8 and the letter after it), applies only where U+088F and "abc" are
    one word: both packages give the same 7 ids, the merged one among them
    (a split before "abc" gives 8)."""
    vpath, mpath = ttok.tiny_bpe_files(str(tmp_path), ["ok"])
    vocab = ttok.json.loads(open(vpath, encoding="utf-8").read())
    vocab["ıa"] = len(vocab)
    with open(vpath, "w", encoding="utf-8") as f:
        ttok.json.dump(vocab, f, ensure_ascii=False)
    with open(mpath, "a", encoding="utf-8") as f:
        f.write("ı a\n")
    jt = jtok.ByteLevelBPETokenizer(vpath, mpath)
    tt = ttok.ByteLevelBPETokenizer(vpath, mpath)
    text = "ok ࢏abc"
    ids = tt.convert_tokens_to_ids(tt.tokenize(text))
    assert ids == jt.convert_tokens_to_ids(jt.tokenize(text))
    assert len(ids) == 7 and vocab["ıa"] in ids


def test_bpe_token_ids(tokenizers):
    jt, tt = tokenizers
    assert tt.vocab == jt.vocab and tt.bpe_ranks == jt.bpe_ranks
    words = jsynthetic.VOCAB_WORDS + EXTRA_WORDS
    assert tsynthetic.VOCAB_WORDS == jsynthetic.VOCAB_WORDS
    for text in words + [" ".join(words)] + TEXTS:
        toks = tt.tokenize(text)
        assert toks == jt.tokenize(text), text
        ids = tt.convert_tokens_to_ids(toks)
        assert ids == jt.convert_tokens_to_ids(toks)
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.decode(ids) == text


@pytest.mark.parametrize("lower", [True, False])
def test_wordpiece_token_ids(tmp_path, lower):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cafe",
             "café", "##s", "##ing", "run", "東", "京", "1", "##2", "!", ",",
             "α", "##θ", "моск", "##ва", "½", "x", "##³", "RT", "@", "bbc"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    jt = jtok.BertTokenizer(str(path), do_lower_case=lower)
    tt = ttok.BertTokenizer(str(path), do_lower_case=lower)
    for text in TEXTS + ["the runs running, cafés! 東京 12", "RT @bbc"]:
        toks = tt.tokenize(text)
        assert toks == jt.tokenize(text), text
        assert tt.convert_tokens_to_ids(toks) == \
            jt.convert_tokens_to_ids(toks)


def test_features_key_by_key(corpus, tokenizers):
    jt, tt = tokenizers
    path = str(corpus / "jax" / "train.txt")
    jclips = jclip.ClipFeatureStore.from_split(str(corpus / "jax"), "train")
    tclips = tclip.ClipFeatureStore.from_split(str(corpus / "jax"), "train")
    examples = jconll.read_mm_conll(path)
    # one sentence long enough to be truncated
    examples.append(jconll.MMExample(["alice"] * 40, ["B-PER"] * 40,
                                     examples[0].img_id))
    for msl in (16, 48):
        want = jfeatures.convert_examples(examples, jt, msl, jclips, 16)
        got = tfeatures.convert_examples(
            tconll.read_mm_conll(path) + [tconll.MMExample(
                ["alice"] * 40, ["B-PER"] * 40, examples[0].img_id)],
            tt, msl, tclips, 16)
        assert vars(got.spec) == vars(want.spec)
        assert got.img_ids == want.img_ids
        for key in ("input_ids", "input_mask", "segment_ids",
                    "ori_input_ids", "ori_input_mask", "ori_segment_ids",
                    "label_ids", "aux_label_ids", "output_mask",
                    "added_input_mask", "clip_features"):
            a, b = getattr(got, key), getattr(want, key)
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        rows = np.array([0, 3, len(examples) - 1])
        gb, wb = got.batch_dict(rows), want.batch_dict(rows)
        assert gb.keys() == wb.keys()
        for key in gb:
            np.testing.assert_array_equal(gb[key], wb[key], err_msg=key)


def test_clip_feature_store(corpus, tmp_path):
    d = str(corpus / "jax")
    for split in ("train", "test"):
        a = tclip.ClipFeatureStore.from_split(d, split)
        b = jclip.ClipFeatureStore.from_split(d, split)
        assert list(a) == list(b) and a.dim == b.dim == 16
        for k in b:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    # torch tensors in the pickle, as the reference stores them, and npz
    rng = np.random.default_rng(0)
    raw = {7: {"text_features": torch.from_numpy(
        rng.standard_normal((1, 8)).astype(np.float32))},
           "x": rng.standard_normal(8)}
    pkl = tmp_path / "f.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(raw, f)
    npz = tmp_path / "f.npz"
    np.savez(npz, a=rng.standard_normal((1, 8)), b=np.ones(8))
    for load in ("from_pickle", "from_npz"):
        p = str(pkl if load == "from_pickle" else npz)
        a = getattr(tclip.ClipFeatureStore, load)(p)
        b = getattr(jclip.ClipFeatureStore, load)(p)
        assert list(a) == list(b) and len(a) == 2 and a.dim == b.dim == 8
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_predictions(seed):
    rng = np.random.default_rng(seed)
    B, L = 6, 20
    n_tags = len(tlabels.MNER_LABELS) + 1
    labels = rng.integers(0, n_tags, (B, L))
    preds = rng.integers(0, n_tags, (B, L))
    lens = rng.integers(0, L + 1, B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    mask[0, 5] = 0                  # a hole: the walk stops there
    got = filter_predictions(preds, labels, mask)
    want = jfilter(preds, labels, mask)
    assert got == want
    assert any(got[0]) and not any(len(r) > lens[i] for i, r in
                                   enumerate(got[0]))
