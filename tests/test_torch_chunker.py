"""The CoNLL-2000 chunker of the PyTorch/CUDA port against the JAX package
on the CPU: the Pfeiffer adapter in `FeedForward` (1e-5), the
adapter-transformers converter read back bit for bit, `ChunkTagger` logits
against JAX's (1e-4; JAX's tests hold JAX's to HF BERT with the adapter
patched in), `ModelChunker` labels and spans, `load_chunker` on files the
test writes, the numpy chunking functions bit-equal; and the two small pieces
of the same slice, `MNERLoader.eval_view` (batches equal to JAX's) and
`resnet152` (stages and parameter tree equal). Weights are the JAX
modules', carried across by `icka_tpu_torch.convert`."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.data import chunking as jchunking  # noqa: E402
from icka_tpu.models import chunker as jchunker  # noqa: E402
from icka_tpu.models import pretrained as jpretrained  # noqa: E402
from icka_tpu.models import resnet as jresnet  # noqa: E402
from icka_tpu.nn.attention import FeedForward as JaxFeedForward  # noqa: E402
from icka_tpu_torch.convert import (backbone_variables_from_state_dict,  # noqa: E402
                                    chunk_tagger_state_dict,
                                    state_dict_from_flax)
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.data import chunking  # noqa: E402
from icka_tpu_torch.models import chunker  # noqa: E402
from icka_tpu_torch.models.pretrained import load_chunker  # noqa: E402
from icka_tpu_torch.models.resnet import resnet152  # noqa: E402
from icka_tpu_torch.nn.attention import FeedForward  # noqa: E402

TINY = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40)
ADAPTER = 8
NUM_LABELS = len(chunker.CONLL2000_LABELS)


def _jax_cfg(**kw):
    return jconfig.EncoderConfig(**TINY, layer_norm_eps=1e-12,
                                 position_offset=0, pad_token_id=0,
                                 type_vocab_size=2, adapter_size=ADAPTER,
                                 **kw)


def _port_cfg(jcfg):
    return tconfig.from_json(tconfig.EncoderConfig, jconfig.to_json(jcfg))


def _hf_layout(params):
    """A `ChunkTagger` flax tree under adapter-transformers'
    `BertModelWithHeads` key names (torch (out, in) weights, adapters
    named conll2000, a Sequential head at index 1)."""
    sd = {}

    def lin(name, t):
        sd[f"{name}.weight"] = torch.from_numpy(np.array(t["kernel"]).T)
        sd[f"{name}.bias"] = torch.from_numpy(np.array(t["bias"]))

    def norm(name, t):
        sd[f"{name}.LayerNorm.weight"] = torch.from_numpy(np.array(t["scale"]))
        sd[f"{name}.LayerNorm.bias"] = torch.from_numpy(np.array(t["bias"]))
    emb = params["bert"]["embeddings"]
    for table in ("word", "position", "token_type"):
        sd[f"bert.embeddings.{table}_embeddings.weight"] = torch.from_numpy(
            np.array(emb[f"{table}_embeddings"]))
    norm("bert.embeddings", emb["norm"])
    for i, t in enumerate(params["bert"]["encoder"][f"layer_{i}"]
                          for i in range(TINY["num_hidden_layers"])):
        p = f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.self.{n}", t["attn"][n])
        lin(f"{p}.attention.output.dense", t["attn_out"]["dense"])
        norm(f"{p}.attention.output", t["attn_out"]["norm"])
        lin(f"{p}.intermediate.dense", t["ffn"]["wi"])
        lin(f"{p}.output.dense", t["ffn"]["wo"])
        norm(f"{p}.output", t["ffn"]["norm"])
        a = f"{p}.output.adapters.conll2000"
        lin(f"{a}.adapter_down.0", t["ffn"]["adapter_down"])
        lin(f"{a}.adapter_up", t["ffn"]["adapter_up"])
    lin("heads.conll2000.1", params["head"])
    return sd


@pytest.fixture(scope="module")
def ckpt():
    """JAX `ChunkTagger` params (adapters and head drawn larger than the
    init's, so that both matter) and the same weights as an
    adapter-transformers state dict."""
    jcfg = _jax_cfg()
    params = jax.device_get(jax.jit(jchunker.ChunkTagger(jcfg).init)(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32)))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    for i in range(TINY["num_hidden_layers"]):
        ffn = params["bert"]["encoder"][f"layer_{i}"]["ffn"]
        for name in ("adapter_down", "adapter_up"):
            ffn[name] = jax.tree.map(lambda x: rng.standard_normal(
                x.shape).astype(np.float32) * 0.2, ffn[name])
    params["head"]["kernel"] = params["head"]["kernel"] * 40.0
    return params, _hf_layout(params)


def _ids(rng, B=2, S=12, cut=9):
    ids = rng.integers(3, TINY["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, cut:] = 0
    ids[1, cut:] = 0
    return ids, mask


@pytest.mark.parametrize("adapter", [0, 5])
def test_feed_forward_adapter_equals_jax(adapter):
    rng = np.random.default_rng(adapter)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    jm = JaxFeedForward(24, 1e-12, adapter_size=adapter)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), x))
    want = jm.apply(params, x)
    tm = FeedForward(16, 24, 1e-12, adapter_size=adapter, device="cpu")
    tm.load_state_dict(state_dict_from_flax(params["params"]), strict=True)
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_converter_reads_the_adapter_layout_back(ckpt):
    """`chunker_params_from_torch` on the adapter-transformers state dict
    gives back the tree it was written from, as JAX's converter does."""
    params, sd = ckpt
    for conv in (chunker.chunker_params_from_torch,
                 jchunker.chunker_params_from_torch):
        got = conv(sd, TINY["num_hidden_layers"])
        assert jax.tree.structure(got) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_chunk_tagger_equals_jax(ckpt, use_pallas):
    """`ChunkTagger` logits, JAX's against the port's on one checkpoint,
    through the plain core and through K1 (its plain version here; JAX's
    kernel in interpret mode), a padded row included."""
    params, _ = ckpt
    ids, mask = _ids(np.random.default_rng(0))
    jcfg = _jax_cfg(use_pallas=use_pallas)
    want = np.asarray(jax.jit(jchunker.ChunkTagger(jcfg).apply)(
        {"params": params}, ids, mask))
    tm = chunker.ChunkTagger(_port_cfg(jcfg), device="cpu").eval()
    tm.load_state_dict(chunk_tagger_state_dict({"params": params}),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_converter_takes_any_adapter_name_and_head_index(ckpt):
    _, sd = ckpt
    renamed = {k.replace("conll2000", "chunk").replace(
        "adapter_down.0", "adapter_down").replace("heads.chunk.1",
                                                  "heads.chunk.3"): v
               for k, v in sd.items()}
    want = chunker.chunker_params_from_torch(sd, 2)
    got = chunker.chunker_params_from_torch(renamed, 2)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="adapter"):
        chunker.chunker_params_from_torch(
            {k: v for k, v in sd.items() if ".0.output.adapters" not in k},
            2)
    with pytest.raises(KeyError, match="head"):
        chunker.chunker_params_from_torch(
            {k: v for k, v in sd.items() if not k.startswith("heads.")}, 2)


@pytest.fixture(scope="module")
def model_chunkers(ckpt):
    """JAX's and the port's `ModelChunker` on one tagger."""
    params, _ = ckpt
    jcfg = _jax_cfg()
    return (jchunker.ModelChunker(params, jcfg, bucket=16),
            chunker.ModelChunker(params, _port_cfg(jcfg), bucket=16,
                                 device="cpu"))


def test_model_chunker_labels_and_spans_equal_jax(model_chunkers):
    jm, tm = model_chunkers
    rng = np.random.default_rng(1)
    # lengths on both sides of a bucket edge: padded to 16 and to 32
    seqs = [[2] + rng.integers(3, TINY["vocab_size"], n).tolist() + [3]
            for n in (9, 3, 14, 20)]
    got = tm.tag(seqs)
    assert got == jm.tag(seqs)
    assert len(set(lab for row in got for lab in row)) > 2
    assert [len(r) for r in got] == [9, 3, 14, 20]
    assert tm.batch(seqs)[0].shape == (4, 32)
    for seq in seqs:
        spans = tm(seq)
        assert spans == jm(seq)
        covered = sorted(t for s, e in spans for t in range(s, e))
        assert set(covered) == set(range(len(seq) - 2))


def test_load_chunker_from_local_dir(tmp_path, ckpt):
    """`load_chunker` on a torch checkpoint directory the test writes (with
    BERT's pooler, as `BertModelWithHeads` saves it): the adapter width (8)
    and the tiny dims come from the files, not from bert-base; tags equal
    to JAX's `load_chunker` on the same directory."""
    _, sd = ckpt
    gen = torch.Generator().manual_seed(9)
    H = TINY["hidden_size"]
    # BertModelWithHeads keeps BERT's pooler, which the tagger ignores
    sd = dict(sd, **{"bert.pooler.dense.weight": torch.randn(
        H, H, generator=gen), "bert.pooler.dense.bias": torch.zeros(H)})
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    tm = load_chunker(str(tmp_path), device="cpu", use_pallas=True)
    jm = jpretrained.load_chunker(str(tmp_path))
    assert tm.cfg.adapter_size == ADAPTER and tm.cfg.use_pallas
    assert tm.cfg.hidden_size == TINY["hidden_size"]
    seqs = [[2] + np.random.default_rng(n).integers(
        3, TINY["vocab_size"], n).tolist() + [3] for n in (6, 11)]
    assert tm.tag(seqs) == jm.tag(seqs)
    spans = tm(seqs[0])
    assert sorted(t for s, e in spans for t in range(s, e)) == list(range(6))


def test_labels_match_reference_id2label():
    assert chunker.CONLL2000_LABELS == jchunker.CONLL2000_LABELS
    assert chunker.CONLL2000_ID2LABEL == jchunker.CONLL2000_ID2LABEL
    assert chunker.CONLL2000_ID2LABEL[11] == "B-NP"
    assert chunker.CONLL2000_ID2LABEL[22] == "I-VP"
    assert len(chunker.CONLL2000_ID2LABEL) == 23
    assert (jconfig.to_json(jchunker.chunker_config())
            == tconfig.to_json(chunker.chunker_config()))


def _random_bio(rng, n):
    tags = ["O", "B-NP", "I-NP", "B-VP", "I-VP"]
    return [tags[i] for i in rng.integers(0, len(tags), n)]


@pytest.mark.parametrize("seed", range(4))
def test_chunk_mask_v4_and_spans_bit_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 5, 13):
        labels = _random_bio(rng, n)
        total, offsets = chunking.chunk_mask_v4(labels, n + 2)
        jtotal, joffsets = jchunking.chunk_mask_v4(labels, n + 2)
        assert total.dtype == jtotal.dtype
        np.testing.assert_array_equal(total, jtotal)
        assert offsets == joffsets
        assert chunking.bio_spans(labels) == jchunking.bio_spans(labels)


def test_chunk_mask_v4_reference_semantics():
    labels = ["B-NP", "I-NP", "O", "O", "I-NP", "O"]
    total, offsets = chunking.chunk_mask_v4(labels, mask_len=8)
    assert total[0].sum() == 8 and total[7].sum() == 8
    # an O before an I is absorbed across the gap into the open chunk
    assert offsets == [[1, 2, 4, 5], [3], [6]]
    assert total[3][1] == 0 and total[1][3] == 0
    labels = ["B-NP", "I-NP", "I-NP", "B-VP", "O"]
    total, offsets = chunking.chunk_mask_v4(labels, mask_len=7)
    assert offsets == [[1, 2, 3], [4], [5]]
    assert chunking.bio_spans(["B-NP", "I-NP", "O", "B-VP"]) == [
        (0, 2), (2, 3), (3, 4)]
    assert chunking.bio_spans([]) == []


def test_heuristic_chunks_and_arrays_bit_equal_jax():
    sentences = ["the red car is parked".split(),
                 "A dog , and the cat 's toy ( red ) .".split(),
                 ["a"], ["dog"]]
    for toks in sentences:
        assert chunking.heuristic_chunks(toks) == \
            jchunking.heuristic_chunks(toks)
    spans = chunking.heuristic_chunks(sentences[0])
    assert (0, 1) in spans and (1, 3) in spans and (3, 4) in spans
    for hypo_len, max_chunks in ((6, 4), (9, 8), (16, 3)):
        for s in ([(0, 2), (2, 3)], spans):
            for got, want in zip(
                    chunking.chunk_arrays(s, hypo_len, max_chunks),
                    jchunking.chunk_arrays(s, hypo_len, max_chunks)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        for chunker_fn in (chunking.heuristic_chunks, None):
            kw = {} if chunker_fn is None else {"chunker": chunker_fn}
            got = chunking.batch_chunk_arrays(sentences, hypo_len,
                                              max_chunks, **kw)
            want = jchunking.batch_chunk_arrays(sentences, hypo_len,
                                                max_chunks)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    gather, mask = chunking.chunk_arrays([(0, 2), (2, 3)], hypo_len=6,
                                         max_chunks=4)
    assert gather[1] == gather[2] == 0 and gather[3] == 1
    assert gather[0] == 3 and mask[0].all() and mask[:, 0].all()


def test_eval_view_batches_equal_jax(tmp_path):
    """`MNERLoader.eval_view` of a train loader (accumulation 2, shuffled,
    split across 2 processes) against the JAX package's eval_view of the
    same loader: one batch a step, every row, in order, key by key."""
    from icka_tpu.data.clip_store import ClipFeatureStore
    from icka_tpu.data.conll import read_mm_conll
    from icka_tpu.data.features import convert_examples
    from icka_tpu.data.loader import MNERLoader as JaxLoader
    from icka_tpu.data.synthetic import generate_dataset, tiny_tokenizer
    from icka_tpu_torch.data.loader import MNERLoader

    root = str(tmp_path)
    generate_dataset(root, n_train=0, n_valid=7, n_test=0, clip_dim=8,
                     image_size=40, seed=3)
    tok = tiny_tokenizer(os.path.join(root, "tok"))
    feats = convert_examples(read_mm_conll(os.path.join(root, "valid.txt")),
                             tok, 24, ClipFeatureStore.from_split(root,
                                                                  "valid"), 8)
    images = os.path.join(root, "images")
    kw = dict(accum_steps=2, train=True, decode_size=36, seed=4,
              process_index=1, process_count=2, cache_images=False)
    view = MNERLoader(feats, images, 3, **kw).eval_view()
    jview = JaxLoader(feats, images, 3, **kw).eval_view()
    assert (view.train, view.accum_steps, len(view.indices)) == (False, 1, 7)
    assert len(view) == len(jview) == 3
    got, want = list(view), list(jview)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_resnet152_equals_jax():
    """Stages (3, 8, 36, 3) and the parameter and batch-stats trees, names
    and shapes, of JAX's `resnet152()` (shapes from `jax.eval_shape`)."""
    jm = jresnet.resnet152()
    assert tuple(jm.layers) == (3, 8, 36, 3)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    tm = resnet152(device="cpu", seed=0)
    got = backbone_variables_from_state_dict(tm.state_dict())
    flat = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_leaves_with_path(got)}
    want_flat = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
                 jax.tree_util.tree_leaves_with_path(dict(want))}
    assert flat == want_flat
