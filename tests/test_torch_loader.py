"""The port's eval loader against the JAX package's `MNERLoader(train=False)`
key by key, images through the native decoder, prefetch on and off; the
port's own ctypes binding to the native library; decode without PIL."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from icka_tpu.data import native as jnative  # noqa: E402
from icka_tpu.data.clip_store import ClipFeatureStore  # noqa: E402
from icka_tpu.data.conll import read_mm_conll  # noqa: E402
from icka_tpu.data.features import convert_examples  # noqa: E402
from icka_tpu.data.loader import MNERLoader as JaxLoader  # noqa: E402
from icka_tpu.data.synthetic import generate_dataset, tiny_tokenizer  # noqa: E402
from icka_tpu_torch.core.config import TrainConfig  # noqa: E402
from icka_tpu_torch.data import native  # noqa: E402
from icka_tpu_torch.data.loader import MNERLoader  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A valid split of 7 rows with 48x40 JPEGs, one of them corrupt and
    one missing, and its features."""
    root = str(tmp_path_factory.mktemp("ds"))
    generate_dataset(root, n_train=0, n_valid=7, n_test=0, clip_dim=8,
                     image_size=48, seed=5)
    images = os.path.join(root, "images")
    with open(os.path.join(images, "2.jpg"), "wb") as f:
        f.write(b"not a jpeg")
    os.remove(os.path.join(images, "4.jpg"))
    tok = tiny_tokenizer(os.path.join(root, "tok"))
    feats = convert_examples(read_mm_conll(os.path.join(root, "valid.txt")),
                             tok, 24, ClipFeatureStore.from_split(root,
                                                                  "valid"), 8)
    return feats, images


def test_native_binding_loads_and_matches_the_jax_packages(split):
    _, images = split
    assert native.native_available() and jnative.native_available()
    path = os.path.join(images, "0.jpg")
    got = native.decode_jpeg(path, 32)
    assert got.shape == (32, 32, 3) and got.any()
    np.testing.assert_array_equal(got, jnative.decode_jpeg(path, 32))
    paths = [os.path.join(images, f"{i}.jpg") for i in range(7)]
    out, failures = native.decode_jpeg_batch(paths, 32, num_threads=3)
    want, want_failures = jnative.decode_jpeg_batch(paths, 32)
    assert failures == want_failures == 2
    np.testing.assert_array_equal(out, want)
    assert native.decode_jpeg(os.path.join(images, "2.jpg"), 32) is None
    assert native.crc32(out) == jnative.crc32(want)


@pytest.mark.parametrize("prefetch,cache,batch_size", [
    (0, True, 3), (2, True, 3), (2, False, 4), (0, False, 7)])
def test_batches_equal_the_jax_loaders(split, prefetch, cache, batch_size):
    feats, images = split
    kw = dict(train=False, decode_size=40, cache_images=cache)
    got = list(MNERLoader(feats, images, batch_size, prefetch=prefetch, **kw))
    want = list(JaxLoader(feats, images, batch_size, prefetch=prefetch, **kw))
    assert len(got) == len(want) == -(-7 // batch_size)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    tail = got[-1]
    n_tail = 7 - (len(got) - 1) * batch_size
    assert tail["row_valid"].tolist() == [1] * n_tail + [0] * (
        batch_size - n_tail)
    # the padded rows repeat the split's last row
    np.testing.assert_array_equal(tail["input_ids"][n_tail:],
                                  np.repeat(feats.input_ids[-1:],
                                            batch_size - n_tail, 0))
    images_seen = np.concatenate([b["images"] for b in got])
    assert images_seen[0].any()          # decoded, not zeros
    assert not images_seen[2].any() and not images_seen[4].any()


def test_train_mode_is_not_ported_and_errors_reach_the_consumer(split):
    feats, images = split
    # training batches are ported, and so are the data axis that shards
    # them over ranks and the model axis
    assert len(MNERLoader(feats, images, 2)) == 3
    TrainConfig(data_axis=2, zero1=True)
    assert TrainConfig(model_axis=2).model_axis == 2
    loader = MNERLoader(feats, images, 2, train=False, prefetch=2)

    def broken(rows):
        raise OSError("disk gone")
    loader._assemble = broken
    with pytest.raises(OSError, match="disk gone"):
        list(loader)


def test_decode_image_without_pil(split, tmp_path):
    """A missing file gives zeros without PIL; an existing one needs it."""
    _, images = split
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "from icka_tpu_torch.data.images import decode_image\n"
        "z = decode_image(sys.argv[1], 16)\n"
        "assert z.shape == (16, 16, 3) and not z.any()\n"
        "try:\n"
        "    decode_image(sys.argv[2], 16)\n"
        "except ImportError:\n"
        "    print('raised')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "missing.jpg"),
         os.path.join(images, "0.jpg")], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "raised", \
        proc.stdout + proc.stderr
