"""The VCR task plane's host code in the PyTorch/CUDA port against the JAX
package, bit for bit: the VQA, GQA, NLVR2 and VCR processors on the same
JSON files, `convert_vl_examples` on the port's tiny tokenizer against the
JAX package's pipeline, the retrieval metrics, and the TSV files (written
byte for byte alike, read, concatenated, reordered, deleted)."""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

from icka_tpu.data import synthetic as jsynthetic
from icka_tpu.data import task_processors as jtp
from icka_tpu.evaluation import retrieval as jret
from icka_tpu.utils import tsv_file as jtsv
from icka_tpu_torch.data import synthetic
from icka_tpu_torch.data import task_processors as tp
from icka_tpu_torch.evaluation import itm_eval, recall_at_k, retrieval
from icka_tpu_torch.utils import TSVFile, tsv_file, tsv_writer

VQA = [{"q": "what color is the dog", "o": "dog;ball", "an": ["brown"],
        "s": [1.0], "img_id": "img1", "q_id": 7},
       {"q": "empty answers skipped", "o": "x", "an": [], "s": [],
        "img_id": "img2", "q_id": 8},
       {"q": "how many", "o": "cat; cat;", "an": ["two", "2"],
        "s": [0.9, 0.3], "img_id": "img3", "q_id": "9"}]
GQA = [{"q": "is it red", "an": "yes", "img_id": "g1", "q_id": 3},
       {"q": "skipped", "an": "", "img_id": "g2", "q_id": 4},
       {"q": "what is left", "o": "a;b", "an": 0, "img_id": "g3",
        "q_id": "5"}]
NLVR = [{"q": "the game", "o": "", "label": 1, "img_id": "k1"},
        {"q": "a photo", "label": 0, "img_id": "missing"}]
VCR = [{"q": "why is he smiling", "choices": ["a", "b", "c", "d"],
        "label": 2, "img_id": "vcr1", "annot_id": "train-42",
        "objects": ["person", "dog"]},
       {"q": "what next", "choices": ["x", "y"], "label": 0,
        "img_id": "vcr2", "annot_id": "val-7"}]


def _as_dicts(examples):
    return [dataclasses.asdict(e) for e in examples]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vl")
    for names, rows in (((jtp.VQATextProcessor.train_file,
                          jtp.VQATextProcessor.test_file), VQA),
                        ((jtp.GQAProcessor.dev_file,
                          jtp.GQAProcessor.test_file), GQA),
                        ((jtp.NLVRProcessor.train_file,), NLVR),
                        ((jtp.VCRQAProcessor.train_file,
                          jtp.VCRQAProcessor.test_file), VCR)):
        for name in names:
            (d / name).write_text(json.dumps(rows))
    with open(d / "labels.pkl", "wb") as f:
        pickle.dump({"brown": "brown", "two": "two", "2": "2"}, f)
    return d


@pytest.mark.parametrize("name", sorted(jtp.PROCESSORS))
def test_processors_equal_jax(data_dir, name):
    port, ref = tp.PROCESSORS[name](), jtp.PROCESSORS[name]()
    for split in ("train", "dev", "test"):
        path = data_dir / getattr(ref, f"{split}_file")
        if not path.exists():
            continue
        got = getattr(port, f"get_{split}_examples")(str(data_dir))
        want = getattr(ref, f"get_{split}_examples")(str(data_dir))
        assert got and _as_dicts(got) == _as_dicts(want)
    assert port.get_labels() == ref.get_labels()
    if name in ("vqa", "gqa"):
        pkl = str(data_dir / "labels.pkl")
        assert port.get_labels(pkl) == ref.get_labels(pkl)


def test_processor_fields(data_dir):
    vqa = tp.VQATextProcessor().get_train_examples(str(data_dir))
    assert len(vqa) == 2 and vqa[0].text_b == "dog ball"
    assert vqa[0].label == ["brown"]
    vcr = tp.VCRQAProcessor().get_train_examples(str(data_dir))
    assert vcr[0].q_id == 42 and vcr[0].text_b == ["a", "b", "c", "d"]
    assert vcr[0].label == 2 and vcr[0].score == ["person", "dog"]
    assert tp.VCRQAProcessor().get_test_examples(str(data_dir))[1].label \
        is None


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    return (synthetic.tiny_tokenizer(str(d / "port")),
            jsynthetic.tiny_tokenizer(str(d / "jax")))


@pytest.mark.parametrize("name,mode", [("nlvr", "classification"),
                                       ("vqa", "classification"),
                                       ("vqa", "regression"),
                                       ("vcr_qa", "classification")])
def test_convert_vl_examples_bit_equal(data_dir, tokenizers, name, mode):
    """Every array of the features equal to the JAX pipeline's (the JAX
    processors and tokenizer), regions truncated, padded and missing."""
    tok, jtok = tokenizers
    rng = np.random.default_rng(0)
    feats = {"k1": rng.standard_normal((3, 8)).astype(np.float32),
             "img1": rng.standard_normal((7, 8)).astype(np.float32),
             "img3": rng.standard_normal((2, 8)).astype(np.float32),
             "vcr1": rng.standard_normal((5, 8)).astype(np.float32)}
    labels = {"nlvr": [0, 1], "vqa": ["brown", "two", "2"],
              "vcr_qa": [0, 1]}[name]
    ex = tp.PROCESSORS[name]().get_train_examples(str(data_dir))
    jex = jtp.PROCESSORS[name]().get_train_examples(str(data_dir))
    kw = dict(max_img_seq_length=5, max_seq_length=12, output_mode=mode)
    got = tp.convert_vl_examples(ex, feats, labels, tokenizer=tok, **kw)
    want = jtp.convert_vl_examples(jex, feats, labels, tokenizer=jtok, **kw)
    for field in ("input_ids", "input_mask", "segment_ids", "label",
                  "img_feats"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.input_ids[0, 0] == tok.vocab[tok.bos_token]
    if name == "nlvr":
        assert got.input_mask[0, 12:15].sum() == 3
        assert got.input_mask[1, 12:].sum() == 0       # image missing


def test_retrieval_equal_jax():
    rng = np.random.default_rng(1)
    sim = rng.standard_normal((12, 9)).astype(np.float32)
    sim[np.arange(9), np.arange(9)] += 2.0
    assert itm_eval(sim) == jret.itm_eval(sim)
    gold_t, gold_i = rng.integers(0, 9, 12), rng.integers(0, 12, 9)
    assert itm_eval(sim, gold_t, gold_i) == jret.itm_eval(sim, gold_t, gold_i)
    assert recall_at_k(sim, gold_t, (1, 3)) == jret.recall_at_k(sim, gold_t,
                                                                (1, 3))
    perfect = itm_eval(np.eye(6, dtype=np.float32))
    assert perfect["txt_r1"] == perfect["img_r1"] == 1.0

    def score(texts, imgs):
        return texts[:, :1] @ imgs[:, :1].T
    texts = rng.standard_normal((7, 3)).astype(np.float32)
    imgs = rng.standard_normal((5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        retrieval.score_all_pairs(score, texts, imgs, batch_size=2),
        jret.score_all_pairs(score, texts, imgs, batch_size=2))


def _files(d):
    return {p: open(os.path.join(d, p), "rb").read()
            for p in sorted(os.listdir(d))}


def test_tsv_files_byte_equal(tmp_path):
    """The same operations through both packages leave the same bytes
    (tsv files and line indexes); reads agree row for row."""
    rows_a = [["k1", "x"], ["k2", "yy"], ["k4", "é\tq"]]
    rows_b = [["k3", "zzz"]]
    for mod, sub in ((tsv_file, "port"), (jtsv, "jax")):
        d = tmp_path / sub
        d.mkdir()
        a, b = str(d / "a.tsv"), str(d / "b.tsv")
        mod.tsv_writer(rows_a, a)
        mod.tsv_writer(rows_b, b)
        out = str(d / "all.tsv")
        mod.concat_tsv_files([a, b], out, generate_lineidx=True)
        mod.reorder_tsv_keys(out, ["k3", "k1", "k4", "k2"],
                             str(d / "ordered.tsv"))
        mod.build_lineidx(a, str(d / "a.rebuilt"))
        mod.delete_tsv_files([b])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert not os.path.exists(tmp_path / "port" / "b.lineidx")
    f = TSVFile(str(tmp_path / "port" / "all.tsv"), generate_lineidx=False)
    g = jtsv.TSVFile(str(tmp_path / "jax" / "all.tsv"),
                     generate_lineidx=False)
    assert len(f) == len(g) == 4
    assert [f[i] for i in range(4)] == [g[i] for i in range(4)]
    assert f[3] == ["k3", "zzz"]
    f.close()
    g.close()
    ordered = TSVFile(str(tmp_path / "port" / "ordered.tsv"))
    assert [ordered[i][0] for i in range(4)] == ["k3", "k1", "k4", "k2"]
    assert tsv_file.load_list_file(str(tmp_path / "port" / "a.lineidx")) \
        == jtsv.load_list_file(str(tmp_path / "jax" / "a.lineidx"))


def test_region_features_through_tsv_bit_equal(tmp_path):
    """Region features written as TSV rows (key, shape, float32 bytes in
    hex) read back bit-equal, as the VCR data path stores them."""
    rng = np.random.default_rng(2)
    feats = {f"img{i}": rng.standard_normal((i + 1, 6)).astype(np.float32)
             for i in range(4)}
    path = str(tmp_path / "feats.tsv")
    tsv_writer(([k, ",".join(map(str, v.shape)), v.tobytes().hex()]
                for k, v in feats.items()), path)
    f = TSVFile(path)
    for i, (k, v) in enumerate(feats.items()):
        key, shape, data = f[i]
        back = np.frombuffer(bytes.fromhex(data), np.float32).reshape(
            tuple(int(x) for x in shape.split(",")))
        assert key == k and back.tobytes() == v.tobytes()
    f.close()
