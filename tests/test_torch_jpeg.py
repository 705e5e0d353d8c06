"""The port's JPEG decode without the native library (PIL's libjpeg at the
library's DCT scale, then its box filter) held bit for bit to the JAX
package's native decode on seeded files: sizes that scale by 1, 2, 4 and 8,
an upscale, the size where PIL's rounded-up draft would not scale, each at
4:4:4, 4:2:2 and 4:2:0; grayscale, progressive, truncated, CMYK (both
refuse) and a missing file. Then the port's `MNERLoader` against the JAX
package's over a batch of such files, batch and single-image paths, cached
and uncached."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")

from icka_tpu.data import native as jnative  # noqa: E402
from icka_tpu.data.clip_store import ClipFeatureStore  # noqa: E402
from icka_tpu.data.conll import read_mm_conll  # noqa: E402
from icka_tpu.data.features import convert_examples  # noqa: E402
from icka_tpu.data.loader import MNERLoader as JaxLoader  # noqa: E402
from icka_tpu.data.synthetic import generate_dataset, tiny_tokenizer  # noqa: E402
from icka_tpu_torch.data import jpeg, native  # noqa: E402
from icka_tpu_torch.data.images import decode_image  # noqa: E402
from icka_tpu_torch.data.loader import MNERLoader  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(257, 999), (300, 200), (513, 1025), (640, 480), (2048, 1536)]
SUBSAMPLING = (0, 1, 2)
OTHERS = ["gray", "progressive", "truncated"]


def photo(rng, w, h):
    """A seeded photo-like image: smooth colour fields plus grain."""
    base = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3), np.uint8)
    smooth = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))
    grain = rng.integers(-20, 21, (h, w, 3))
    return np.clip(smooth.astype(np.int16) + grain, 0, 255).astype(np.uint8)


def write_corpus(root):
    """Every listed file under `root`, by name."""
    rng = np.random.default_rng(19)
    files = {}
    for w, h in SIZES:
        arr = photo(rng, w, h)
        for ss in SUBSAMPLING:
            files[f"{w}x{h}_{ss}"] = (arr, dict(quality=90, subsampling=ss))
    arr = photo(rng, 640, 480)
    files["gray"] = (arr, dict(mode="L"))
    files["progressive"] = (arr, dict(progressive=True))
    files["cmyk"] = (arr, dict(mode="CMYK"))
    paths = {}
    for name, (a, kw) in files.items():
        im = Image.fromarray(a)
        mode = kw.pop("mode", None)
        if mode:
            im = im.convert(mode)
        paths[name] = os.path.join(root, f"{name}.jpg")
        im.save(paths[name], **kw)
    with open(paths["640x480_2"], "rb") as f:
        whole = f.read()
    paths["truncated"] = os.path.join(root, "truncated.jpg")
    with open(paths["truncated"], "wb") as f:
        f.write(whole[:len(whole) * 3 // 5])
    paths["missing"] = os.path.join(root, "missing.jpg")
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if not jnative.native_available():
        pytest.skip("the JAX package's native library (libjpeg) did not "
                    "load: no reference pixels to hold the decoder to")
    return write_corpus(str(tmp_path_factory.mktemp("jpeg")))


@pytest.fixture
def no_library(monkeypatch):
    """The port's native module as on a machine without libjpeg.so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)


NAMES = [f"{w}x{h}_{ss}" for w, h in SIZES for ss in SUBSAMPLING] + OTHERS


@pytest.mark.parametrize("name", NAMES)
def test_decode_is_the_native_librarys(corpus, no_library, name):
    assert native.decoder() == "pil_draft"
    path = corpus[name]
    for out in (256, 40):
        want = jnative.decode_jpeg(path, out)
        got = native.decode_jpeg(path, out)
        assert want is not None and got is not None
        assert got.shape == (out, out, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{name} at {out}")


def test_pils_resize_is_not_the_native_librarys(corpus):
    """The fault the decoder repairs: PIL's bicubic resize of the same
    file is tens of levels off the library's box filter."""
    path = corpus["300x200_2"]
    off = np.abs(decode_image(path, 256).astype(int)
                 - jnative.decode_jpeg(path, 256)).max()
    assert off > 20


@pytest.mark.parametrize("name", ["cmyk", "missing"])
def test_both_refuse(corpus, no_library, name):
    assert jnative.decode_jpeg(corpus[name], 256) is None
    assert native.decode_jpeg(corpus[name], 256) is None


def test_batch_equals_the_native_batch(corpus, no_library):
    paths = [corpus[n] for n in ("640x480_0", "cmyk", "gray", "missing",
                                 "truncated", "257x999_2")]
    got, failures = native.decode_jpeg_batch(paths, 64, num_threads=3)
    want, want_failures = jnative.decode_jpeg_batch(paths, 64)
    assert failures == want_failures == 2
    np.testing.assert_array_equal(got, want)
    assert native.decode_jpeg_batch([], 64)[0].shape == (0, 64, 64, 3)


def test_scale_and_bounds_follow_the_library():
    # 513x1025 at 256: 1/2 (513 // 4 < 256); PIL's draft from the
    # rounded-up 257x513 would not scale at all
    assert jpeg.scale_denom(513, 1025, 256) == 2
    assert jpeg.scale_denom(4000, 3000, 256) == 8
    assert jpeg.scale_denom(300, 200, 256) == 1
    lo, hi = jpeg.box_bounds(3, 8)          # an upscale picks one pixel
    assert (hi - lo).tolist() == [1] * 8 and lo.tolist() == [
        0, 0, 0, 1, 1, 1, 2, 2]
    lo, hi = jpeg.box_bounds(10, 4)
    assert lo.tolist() == [0, 2, 5, 7] and hi.tolist() == [2, 5, 7, 10]


def test_a_pil_that_scales_otherwise_raises(corpus, no_library,
                                            monkeypatch):
    """A draft that does not give libjpeg's output size must fail, never
    hand back other pixels."""
    from PIL import JpegImagePlugin
    monkeypatch.setattr(JpegImagePlugin.JpegImageFile, "draft",
                        lambda self, mode, size: None)
    with pytest.raises(jpeg.DraftMismatch):
        native.decode_jpeg(corpus["2048x1536_0"], 256)   # at 1/4


def test_truncated_stream_leaves_pils_flag_alone(corpus, no_library):
    from PIL import ImageFile
    assert native.decode_jpeg(corpus["truncated"], 256) is not None
    assert ImageFile.LOAD_TRUNCATED_IMAGES is False


def test_decoder_without_pil_raises(corpus):
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "from icka_tpu_torch.data import native\n"
        "native._lib, native._load_failed = None, True\n"
        "assert native.decode_jpeg(sys.argv[1], 16) is None\n"
        "for call in (native.decoder,\n"
        "             lambda: native.decode_jpeg(sys.argv[2], 16)):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError:\n"
        "        print('raised')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, corpus["missing"], corpus["640x480_0"]],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["raised"] * 2, \
        proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def split(corpus, tmp_path_factory):
    """A valid split of 8 rows whose images are the corpus's files: four
    sizes, grayscale, truncated, CMYK (decode_image's pixels) and a
    missing one (the fallback image)."""
    root = str(tmp_path_factory.mktemp("ds"))
    generate_dataset(root, n_train=0, n_valid=8, n_test=0, clip_dim=8,
                     image_size=48, seed=7)
    images = os.path.join(root, "images")
    rows = ["640x480_1", "2048x1536_2", "gray", "513x1025_0", "truncated",
            "cmyk", None, "300x200_2"]
    for i, name in enumerate(rows):
        dst = os.path.join(images, f"{i}.jpg")
        if name is None:
            os.remove(dst)
        else:
            with open(corpus[name], "rb") as src, open(dst, "wb") as f:
                f.write(src.read())
    tok = tiny_tokenizer(os.path.join(root, "tok"))
    feats = convert_examples(read_mm_conll(os.path.join(root, "valid.txt")),
                             tok, 24, ClipFeatureStore.from_split(root,
                                                                  "valid"), 8)
    return feats, images, corpus["300x200_0"]


@pytest.mark.parametrize("path", ["batch", "single"])
@pytest.mark.parametrize("cache", [True, False])
def test_loader_images_equal_the_jax_loaders(split, no_library, path,
                                             cache):
    feats, images, fallback = split
    kw = dict(train=False, decode_size=256, cache_images=cache, prefetch=0,
              fallback_image=fallback)
    loader = MNERLoader(feats, images, 8, **kw)
    want = next(iter(JaxLoader(feats, images, 8, **kw)))["images"]
    if path == "batch":
        got = next(iter(loader))["images"]
    else:
        got = np.stack([loader._image(r) for r in range(8)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[5], decode_image(
        os.path.join(images, "5.jpg"), 256))
    np.testing.assert_array_equal(got[6], decode_image(fallback, 256))
