"""`TokenClassifier` (the BERT text-only NER baseline) and
`SequenceClassifier` of the PyTorch/CUDA port against the JAX package on
the CPU, at a tiny size in the BERT dialect with `use_pallas=True` on both
sides (the JAX kernel in interpret mode): logits and the fp32
cross-entropy within 1e-5, with and without an attention mask. Weights are
the JAX model's, carried across by
`icka_tpu_torch.convert.token_classifier_state_dict`."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.models import token_classifier as jtc  # noqa: E402
from icka_tpu_torch.convert import (token_classifier_state_dict,  # noqa: E402
                                    token_classifier_variables_from_state_dict)
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.models import token_classifier as ttc  # noqa: E402

B, L, NUM_LABELS = 4, 12, 9
HEADS = ("TokenClassifier", "SequenceClassifier")


def _enc():
    return dataclasses.replace(
        jconfig.EncoderConfig.tiny(77), position_offset=0, pad_token_id=0,
        layer_norm_eps=1e-12, use_pallas=True)


@pytest.fixture(scope="module")
def heads():
    """{head: (JAX module, params, port model on its weights), inputs}."""
    rng = np.random.default_rng(3)
    lens = np.array([L, 9, 5, 2])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    d = {"ids": np.where(mask > 0, rng.integers(1, 77, (B, L)), 0)
         .astype(np.int32),
         "mask": mask,
         "types": (np.arange(L)[None] >= 6).astype(np.int32)
         .repeat(B, 0),
         "tok_labels": rng.integers(0, NUM_LABELS, (B, L)).astype(np.int32),
         "seq_labels": rng.integers(0, NUM_LABELS, B).astype(np.int32)}
    port_enc = tconfig.from_json(tconfig.EncoderConfig,
                                 jconfig.to_json(_enc()))
    out = {}
    for i, name in enumerate(HEADS):
        jm = getattr(jtc, name)(_enc(), NUM_LABELS)
        params = jax.device_get(jm.init(jax.random.PRNGKey(i), d["ids"],
                                        d["mask"], d["types"]))
        tm = getattr(ttc, name)(port_enc, NUM_LABELS, device="cpu").eval()
        tm.load_state_dict(token_classifier_state_dict(params), strict=True)
        back = token_classifier_variables_from_state_dict(tm.state_dict())
        assert jax.tree.structure(back) == jax.tree.structure(
            jax.tree.map(np.asarray, params))
        out[name] = (jm, params, tm)
    return out, d


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("name", HEADS)
def test_logits_and_loss_match_jax(heads, name, masked):
    models, d = heads
    jm, params, tm = models[name]
    mask = d["mask"] if masked else None
    labels = d["tok_labels" if name == "TokenClassifier" else "seq_labels"]
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tmask = t["mask"] if masked else None
    want = np.asarray(jm.apply(params, d["ids"], mask, d["types"]))
    want_loss = float(jm.apply(params, d["ids"], mask, d["types"],
                               labels=labels))
    with torch.no_grad():
        got = tm(t["ids"], tmask, t["types"])
        got_loss = float(tm(t["ids"], tmask, t["types"],
                            labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert abs(got_loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
