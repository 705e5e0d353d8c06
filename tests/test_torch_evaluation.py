"""Chunk F1, the per-class F1s and the seqeval-style report of the
PyTorch/CUDA port against the JAX package's, equal on seeded random BIO
sequences, with the reference's gold PAD/X filtering in front."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from icka_tpu import evaluation as jeval  # noqa: E402
from icka_tpu.evaluation import report as jreport  # noqa: E402
from icka_tpu.train.trainer import filter_predictions as jfilter  # noqa: E402
from icka_tpu_torch import evaluation as teval  # noqa: E402
from icka_tpu_torch.data.labels import MNER_LABELS  # noqa: E402
from icka_tpu_torch.evaluation import report as treport  # noqa: E402
from icka_tpu_torch.evaluation.chunk_f1 import ChunkMetrics  # noqa: E402
from icka_tpu_torch.train.trainer import filter_predictions  # noqa: E402

LABEL_MAP = dict({l: i for i, l in enumerate(MNER_LABELS, 1)}, PAD=0)
BIO = [i for l, i in LABEL_MAP.items() if l == "O" or l[:2] in ("B-", "I-")]


def _sequences(seed, B=12, L=24):
    """Gold and predicted id rows: mostly BIO tags with X, <s>, </s> and
    PAD mixed in, ragged masks; the prediction is the gold with some tags
    changed."""
    rng = np.random.default_rng(seed)
    special = [LABEL_MAP[k] for k in ("X", "<s>", "</s>", "PAD")]
    gold = rng.choice(BIO, (B, L))
    gold = np.where(rng.random((B, L)) < 0.15,
                    rng.choice(special, (B, L)), gold)
    gold[:, 0] = LABEL_MAP["<s>"]
    pred = np.where(rng.random((B, L)) < 0.3,
                    rng.choice(BIO + special, (B, L)), gold)
    lens = rng.integers(2, L + 1, B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    return pred, gold, mask


@pytest.mark.parametrize("seed", range(4))
def test_chunk_metrics_per_class_and_report(seed):
    pred, gold, mask = _sequences(seed)
    got = filter_predictions(pred, gold, mask)
    want = jfilter(pred, gold, mask)
    assert got == want
    yt, yp, yt_idx, yp_idx = got
    m = teval.evaluate_chunk_f1(yp_idx, yt_idx, LABEL_MAP)
    mj = jeval.evaluate_chunk_f1(yp_idx, yt_idx, LABEL_MAP)
    assert isinstance(m, ChunkMetrics) and tuple(m) == tuple(mj)
    assert 0.0 < m.f1 < 1.0
    for cls in ("PER", "LOC", "ORG", "MISC"):
        assert teval.evaluate_class_f1(yp_idx, yt_idx, LABEL_MAP, cls) == \
            jeval.evaluate_class_f1(yp_idx, yt_idx, LABEL_MAP, cls)
    assert teval.classification_report(yt, yp) == \
        jeval.classification_report(yt, yp)
    assert treport.get_entities(yp) == jreport.get_entities(yp)
    assert treport.precision_recall_f1(yt, yp) == \
        jreport.precision_recall_f1(yt, yp)


@pytest.mark.parametrize("seed", range(2))
def test_unfiltered_sequences_and_dump(seed, tmp_path):
    """Without the filter, bare tags such as <s> become their own chunk
    type, as in the reference; the optional dump file is written alike."""
    pred, gold, _ = _sequences(seed + 10, B=5, L=12)
    for row in range(len(gold)):
        assert teval.extract_chunks(gold[row], LABEL_MAP) == \
            jeval.extract_chunks(gold[row], LABEL_MAP)
    id2 = {i: l for l, i in LABEL_MAP.items()}
    words = [[f"w{j}" for j in range(len(r))] for r in gold]
    tags = [[id2[int(i)] for i in r] for r in gold]
    ptags = [[id2[int(i)] for i in r] for r in pred]
    dumps = []
    for mod, name in ((teval, "port"), (jeval, "jax")):
        path = tmp_path / f"{name}.txt"
        m = mod.evaluate_chunk_f1(pred, gold, LABEL_MAP, dump_path=str(path),
                                  pred_tags=ptags, gold_tags=tags,
                                  words=words)
        dumps.append((tuple(m), path.read_text()))
    assert dumps[0] == dumps[1]
    assert teval.classification_report(tags, ptags, digits=2) == \
        jeval.classification_report(tags, ptags, digits=2)


def test_no_correct_chunk_gives_zeros():
    o, b_per = LABEL_MAP["O"], LABEL_MAP["B-PER"]
    m = teval.evaluate_chunk_f1([[o, o]], [[b_per, o]], LABEL_MAP)
    assert tuple(m) == tuple(jeval.evaluate_chunk_f1([[o, o]], [[b_per, o]],
                                                     LABEL_MAP))
    assert (m.f1, m.precision, m.recall, m.acc) == (0.0, 0.0, 0.0, 0.5)
    assert teval.classification_report([], []) == \
        jeval.classification_report([], [])
