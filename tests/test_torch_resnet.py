"""Visual side of the PyTorch/CUDA port against the JAX package on the CPU:
`VisualBackbone` (float path) and eval `preprocess_images`."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.data import images as jimages  # noqa: E402
from icka_tpu.models.resnet import VisualBackbone as JaxBackbone  # noqa: E402
from icka_tpu_torch.convert import backbone_state_dict  # noqa: E402
from icka_tpu_torch.data import images as timages  # noqa: E402
from icka_tpu_torch.models.resnet import VisualBackbone  # noqa: E402


@pytest.mark.parametrize("size", [64, 224])
def test_visual_backbone_matches_jax(size):
    """layers=(1,1,1,1): 64^2 gives a 2x2 map (the adaptive-pool branch),
    224^2 a 7x7 one. The JAX stem is the space-to-depth rewrite, the port's
    the plain 7x7/s2 conv: equal up to summation order, so the bound is
    1e-5 of the output's scale (fp32, 14 convs deep). Random BN statistics
    exercise the folding."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2 if size == 64 else 1, size, size, 3)) \
        .astype(np.float32)
    jm = JaxBackbone(layers=(1, 1, 1, 1))
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])}
    want = jm.apply(v, x)
    tm = VisualBackbone(layers=(1, 1, 1, 1), device="cpu").eval()
    tm.load_state_dict(backbone_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got[2].shape) == (x.shape[0], 7, 7, 2048)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_preprocess_images_eval_matches_jax():
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    want = jimages.preprocess_images(imgs, jax.random.PRNGKey(0),
                                     crop_size=224, train=False)
    got = timages.preprocess_images(imgs, 224, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError):
        timages.preprocess_images(imgs[:, :200, :200], 224, device="cpu")


def test_decode_image_matches_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    path = tmp_path / "img.png"
    Image.fromarray(rng.integers(0, 256, (120, 90, 3), dtype=np.uint8)) \
        .save(path)
    got = timages.decode_image(str(path), decode_size=64)
    np.testing.assert_array_equal(got, jimages.decode_image(str(path), 64))
    assert got.shape == (64, 64, 3)
    np.testing.assert_array_equal(
        timages.decode_image(str(tmp_path / "missing.png"), 32),
        np.zeros((32, 32, 3), np.uint8))
