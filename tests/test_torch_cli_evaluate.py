"""The port's evaluation entry point against the JAX package's on one
checkpoint directory: the JAX side initialises the tiny flagship with
`ICKATrainer.init_state` and saves it as `cli/train.py` does; both CLIs
evaluate `--synthetic DIR --tiny --split valid --eval_batch_size 3` (the
port with `--device cpu`) and must print the same report, per-class lines
and P/R/F1, with the loss within 1e-5. Only this test imports both
packages."""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from icka_tpu.cli import evaluate as jax_cli  # noqa: E402
from icka_tpu.core.checkpoint import Checkpointer  # noqa: E402
from icka_tpu.core.config import ICKAConfig, TrainConfig, to_json  # noqa: E402
from icka_tpu.data.clip_store import ClipFeatureStore  # noqa: E402
from icka_tpu.data.conll import read_mm_conll  # noqa: E402
from icka_tpu.data.features import convert_examples  # noqa: E402
from icka_tpu.data.synthetic import generate_dataset, tiny_tokenizer  # noqa: E402
from icka_tpu.train.trainer import ICKATrainer  # noqa: E402
from icka_tpu_torch.cli import evaluate as port_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 3
ARGS = ["--tiny", "--split", "valid", "--eval_batch_size", str(BATCH)]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    ds, out = str(root / "ds"), str(root / "out")
    # cli/train.py's --synthetic --tiny corpus and model configuration
    generate_dataset(ds, n_train=4, n_valid=8, n_test=2, image_size=64,
                     clip_dim=16)
    tok = tiny_tokenizer(os.path.join(ds, "tokenizer"))
    cfg = dataclasses.replace(
        ICKAConfig.tiny(vocab_size=len(tok.vocab) + 8), max_seq_length=48,
        region_dim=2048, clip_dim=16)
    feats = convert_examples(read_mm_conll(os.path.join(ds, "valid.txt")),
                             tok, cfg.max_seq_length,
                             ClipFeatureStore.from_split(ds, "valid"),
                             cfg.clip_dim)
    trainer = ICKATrainer(cfg, TrainConfig(eval_batch_size=BATCH,
                                           compute_dtype="float32"),
                          feats.spec, resnet_layers=(1, 1, 1, 1))
    # the sample the JAX CLI initialises with, so its init finds the
    # operations compiled
    sample = feats.batch_dict(np.arange(BATCH))
    sample["visual_mean"] = np.zeros((BATCH, cfg.region_dim), np.float32)
    sample["visual_grid"] = np.zeros((BATCH, 7, 7, cfg.region_dim),
                                     np.float32)
    state = trainer.init_state(jax.random.PRNGKey(0), sample, total_steps=1)
    ck = Checkpointer(out)
    ck.save(state, step=0, metric=0.0)
    ck.save_config(to_json(cfg))

    argv = ["--synthetic", ds, "--output_dir", out] + ARGS
    jax_result, jax_out = _run(jax_cli.main, argv)
    port_result, port_out = _run(port_cli.main, argv + ["--device", "cpu"])
    proc = subprocess.run(
        [sys.executable, "-m", "icka_tpu_torch.cli.evaluate"] + argv
        + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    return jax_result, jax_out, port_result, port_out, proc.stdout


def _split_loss(text):
    """The printed lines, and the loss taken out of the last one."""
    lines = text.rstrip("\n").split("\n")
    head, loss = lines[-1].rsplit("loss ", 1)
    return lines[:-1] + [head], float(loss.rstrip(")"))


def test_report_string_equal(runs):
    jax_result, _, port_result, _, _ = runs
    assert port_result.report == jax_result.report
    assert "micro avg" in port_result.report


def test_per_class_f1_equal(runs):
    jax_result, _, port_result, _, _ = runs
    assert port_result.per_class == jax_result.per_class
    assert list(port_result.per_class) == ["PER", "LOC", "ORG", "MISC"]


def test_overall_prf_equal_and_loss_within_1e_5(runs):
    jax_result, _, port_result, _, _ = runs
    for key in ("f1", "precision", "recall", "acc"):
        assert getattr(port_result, key) == getattr(jax_result, key), key
    assert np.isfinite(port_result.loss) and port_result.loss > 0
    assert abs(port_result.loss - jax_result.loss) <= 1e-5
    # 8 rows in batches of 3: the padded tail rows were dropped
    assert (port_result.rows, port_result.batches) == (8, 3)


@pytest.mark.parametrize("which", ["in_process", "python_m"])
def test_printed_lines_equal(runs, which):
    _, jax_out, _, port_out, module_out = runs
    got = port_out if which == "in_process" else module_out
    got_lines, got_loss = _split_loss(got)
    want_lines, want_loss = _split_loss(jax_out)
    assert got_lines == want_lines
    assert abs(got_loss - want_loss) <= 1e-4     # printed to 4 places
