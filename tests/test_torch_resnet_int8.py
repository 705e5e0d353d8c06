"""The int8 paths of the port's ResNet against the JAX package on the CPU:
`ConvBN` in `int8` and `int8_static`, `StemPoolS2D`, and the composed
`VisualBackbone` fused and unfused, on the same numpy inputs with weights
carried by the bridge. Where the JAX model reaches a Pallas kernel it runs
in interpret mode; the port's wrappers take their plain versions here.

Tolerances: the static paths are held bit-equal. Integer sums are exact, the
scales are the same fp32 numbers, and XLA:CPU rounds to bf16 at the same
points as PyTorch on these graphs. The dynamic (`int8`) path derives its
weights from `rsqrt` at each call, where the two libraries differ in the last
bit of about a third of the values, so a folded weight can land on the other
side of a rounding boundary: single layers are still held bit-equal (they
are, at these seeds), the composed dynamic backbone within one bf16 ulp of
the output's largest value (18 of 8,192 values differ by more than half of
that), and its calibration record within one bf16 ulp (exactly in the stem
and the first stage).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.models.convert import (  # noqa: E402
    static_quantize_backbone as jax_static_quantize_backbone)
from icka_tpu.models.resnet import ConvBN as JaxConvBN  # noqa: E402
from icka_tpu.models.resnet import StemPoolS2D as JaxStem  # noqa: E402
from icka_tpu.models.resnet import VisualBackbone as JaxBackbone  # noqa: E402
from icka_tpu_torch.convert import (backbone_state_dict,  # noqa: E402
                                    backbone_static_state_dict,
                                    calib_from_flax)
from icka_tpu_torch.kernels import conv as tconv  # noqa: E402
from icka_tpu_torch.nn.quant import int8_matmul  # noqa: E402
from icka_tpu_torch.models.convert import calibration_amax  # noqa: E402
from icka_tpu_torch.models.resnet import (Bottleneck, ConvBN,  # noqa: E402
                                          StemPoolS2D, VisualBackbone,
                                          _im2col)

LAYERS = (3, 2)       # layer1_1 -> layer1_2 chain in int8 through out_scale


def _equal(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def _nhwc(module, x):
    """Run an NCHW-shaped port module on an NHWC tensor."""
    with torch.no_grad():
        return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _static_params(rng, k, C, F):
    return {"wq": rng.integers(-127, 128, (k * k * C, F)).astype(np.int8),
            "w_scale": rng.uniform(1e-4, 1e-3, (F,)).astype(np.float32),
            "fused_bias": rng.normal(0, .5, (F,)).astype(np.float32),
            "act_scale": np.float32(0.02)}


def _random_stats(rng, variables):
    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map(
                lambda a: (a + rng.uniform(0.5, 1.5, a.shape))
                .astype(np.float32), variables["batch_stats"])}


@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (3, 2), (1, 2), (7, 2)])
def test_static_convbn_matches_jax(k, s):
    """Equal int32 accumulators and equal bf16 outputs. With unit scales and
    no bias the JAX module's fp32 output *is* its int32 accumulator (sums
    here stay below 2^24), which the port's `int8_matmul` must equal."""
    rng = np.random.default_rng(10 * k + s)
    C, F = 16, 32
    x = rng.standard_normal((2, 12, 12, C)).astype(np.float32)
    p = _static_params(rng, k, C, F)

    unit = dict(p, w_scale=np.ones(F, np.float32),
                fused_bias=np.zeros(F, np.float32),
                act_scale=np.float32(1.0))
    xi = rng.integers(-127, 128, x.shape).astype(np.float32)
    acc_jax = JaxConvBN(F, k, s, quant="int8_static").apply(
        {"params": unit}, jnp.asarray(xi))
    acc = int8_matmul(_im2col(torch.from_numpy(xi).to(torch.int8), k, s),
                      torch.from_numpy(p["wq"]))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(acc_jax).astype(np.int32))

    want = JaxConvBN(F, k, s, dtype=jnp.bfloat16, quant="int8_static") \
        .apply({"params": p}, jnp.asarray(x, jnp.bfloat16))
    tm = ConvBN(C, F, k, s, dtype=torch.bfloat16, quant="int8_static",
                device="cpu")
    tm.load_state_dict(backbone_static_state_dict({"params": p}),
                       strict=True)
    got = _nhwc(tm, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _equal(got, want)


@pytest.mark.parametrize("k,s", [(1, 1), (3, 2)])
def test_dynamic_convbn_matches_jax(k, s):
    """The calibration mode: equal outputs and an equal amax record, which
    max-merges over calls."""
    rng = np.random.default_rng(20 * k + s)
    C, F = 16, 32
    x = rng.standard_normal((2, 12, 12, C)).astype(np.float32)
    jm = JaxConvBN(F, k, s, dtype=jnp.bfloat16, quant="int8")
    v = _random_stats(rng, jax.device_get(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))))
    want, calib = jm.apply(v, jnp.asarray(x, jnp.bfloat16),
                           mutable=["calib"])
    tm = ConvBN(C, F, k, s, dtype=torch.bfloat16, quant="int8", device="cpu")
    tm.load_state_dict(backbone_state_dict(v), strict=True)
    _equal(_nhwc(tm, torch.from_numpy(x).bfloat16()), want)
    assert tm.calib_amax.item() == float(calib["calib"]["amax"])
    _nhwc(tm, torch.from_numpy(x).bfloat16() * 0.5)       # smaller: kept
    assert tm.calib_amax.item() == float(calib["calib"]["amax"])
    _nhwc(tm, torch.from_numpy(x).bfloat16() * 2)         # larger: raised
    assert tm.calib_amax.item() == 2 * float(calib["calib"]["amax"])


@pytest.mark.parametrize("fused", [False, True])
def test_static_stem_s2d_matches_jax(fused):
    """StemPoolS2D, the XLA tail and the Pallas tail (interpret mode)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    p = _static_params(rng, 7, 3, 64)
    want = JaxStem(dtype=jnp.bfloat16, quant="int8_static",
                   fused_pallas=fused, pallas_interpret=True) \
        .apply({"params": p}, jnp.asarray(x, jnp.bfloat16))
    tm = StemPoolS2D(dtype=torch.bfloat16, quant="int8_static",
                     fused_kernel=fused, device="cpu")
    tm.load_state_dict(backbone_static_state_dict({"params": p}),
                       strict=True)
    before = tconv.int8_stem_pool.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16())
    assert tconv.int8_stem_pool.launches == before
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 8, 8, 64)
    _equal(got, want)


def test_dynamic_stem_s2d_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    jm = JaxStem(dtype=jnp.bfloat16, quant="int8")
    v = _random_stats(rng, jax.device_get(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))))
    want, calib = jm.apply(v, jnp.asarray(x, jnp.bfloat16),
                           mutable=["calib"])
    tm = StemPoolS2D(dtype=torch.bfloat16, quant="int8", device="cpu")
    tm.load_state_dict(backbone_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16())
    _equal(got, want)
    assert tm.calib_amax.item() == float(calib["calib"]["amax"])


def test_float_stem_s2d_matches_jax():
    """`quant="none"`: BatchNorm folded into the float weights, the
    space-to-depth product in fp32; within 1e-5 of the JAX module's float
    path and of the im2col stem + ReLU + max-pool on the same parameters."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = JaxStem(dtype=jnp.float32)
    v = _random_stats(rng, jax.device_get(
        jm.init(jax.random.PRNGKey(0), x)))
    want = jm.apply(v, x)
    tm = StemPoolS2D(quant="none", device="cpu")
    tm.load_state_dict(backbone_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        conv = tm.plain_conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        pooled = torch.nn.functional.max_pool2d(torch.relu(conv), 3, 2, 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8, 8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(got, pooled.permute(0, 2, 3, 1), atol=1e-5,
                               rtol=0)


def test_stem_s2d_equals_the_im2col_stem():
    """Same integer products, integer accumulation: the space-to-depth stem
    is bit-identical to conv 7x7/s2 + ReLU + max-pool 3x3/s2."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3))
                         .astype(np.float32)).bfloat16()
    tm = StemPoolS2D(dtype=torch.bfloat16, quant="int8_static", device="cpu")
    tm.load_state_dict(backbone_static_state_dict(
        {"params": _static_params(rng, 7, 3, 64)}), strict=True)
    with torch.no_grad():
        got = tm(x)
        conv = tm.plain_conv(x.permute(0, 3, 1, 2))
        want = torch.nn.functional.max_pool2d(torch.relu(conv), 3, 2, 1)
    assert torch.equal(got, want.permute(0, 2, 3, 1))


@pytest.fixture(scope="module")
def quantised():
    """A 2-stage backbone of 3 + 2 blocks: float variables, the JAX
    calibration record of the dynamic model, and the static variables quantised by the JAX
    package (with `out_scale`, for the fused model)."""
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((4, 32, 32, 3)).astype(np.float32) * 0.5
    fvars = jax.device_get(JaxBackbone(layers=LAYERS, att_size=2).init(
        jax.random.PRNGKey(0), jnp.asarray(imgs)))
    dyn = JaxBackbone(layers=LAYERS, att_size=2, dtype=jnp.bfloat16,
                      quant="int8")
    dyn_out, calib = dyn.apply(fvars, jnp.asarray(imgs, jnp.bfloat16),
                               mutable=["calib"])
    fused = JaxBackbone(layers=LAYERS, att_size=2, dtype=jnp.bfloat16,
                        quant="int8_static", fused_pallas=True,
                        pallas_interpret=True)
    target = jax.eval_shape(fused.init, jax.random.PRNGKey(1),
                            jnp.asarray(imgs, jnp.bfloat16))
    qvars = jax_static_quantize_backbone(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), target),
        fvars, jax.device_get(calib["calib"]))
    return dict(imgs=imgs, fvars=fvars, calib=jax.device_get(calib["calib"]),
                dyn_out=dyn_out, qvars=qvars)


def _drop_out_scale(t):
    if isinstance(t, dict):
        return {k: _drop_out_scale(v) for k, v in t.items()
                if k != "out_scale"}
    return t


@pytest.mark.parametrize("mode", ["unfused", "fused_stem", "fused"])
def test_static_backbone_matches_jax(quantised, mode):
    """The backbone as a whole: weights quantised by the JAX package, carried
    by the bridge, loaded strictly; pooled, fc and att bit-equal."""
    kw = {"fused": dict(fused_pallas=True),
          "fused_stem": dict(fused_stem=True), "unfused": {}}[mode]
    qvars = quantised["qvars"] if mode == "fused" \
        else _drop_out_scale(quantised["qvars"])
    x = quantised["imgs"]
    want = JaxBackbone(layers=LAYERS, att_size=2, dtype=jnp.bfloat16,
                       quant="int8_static", pallas_interpret=True, **kw) \
        .apply(qvars, jnp.asarray(x, jnp.bfloat16))
    tm = VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                        quant="int8_static", device="cpu", **kw).eval()
    tm.load_state_dict(backbone_static_state_dict(qvars), strict=True)
    launches = (tconv.int8_bottleneck_v2.launches,
                tconv.int8_stem_pool.launches)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16())
    assert launches == (tconv.int8_bottleneck_v2.launches,
                        tconv.int8_stem_pool.launches)
    assert tuple(got[2].shape) == (4, 2, 2, 512)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _equal(g, w)


def test_dynamic_backbone_and_its_calibration_match_jax(quantised):
    """att within one bf16 ulp (2^-7 relative) of the output's largest
    value (see the module docstring); the amax of every ConvBN within one
    bf16 ulp, and exactly up to the end of the first stage."""
    tm = VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                        quant="int8", device="cpu").eval()
    tm.load_state_dict(backbone_state_dict(quantised["fvars"]), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(quantised["imgs"]).bfloat16())
    want = np.asarray(quantised["dyn_out"][2].astype(jnp.float32))
    np.testing.assert_allclose(got[2].float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
    mine, theirs = calibration_amax(tm), calib_from_flax(quantised["calib"])
    assert sorted(mine) == sorted(theirs) and len(mine) == 18
    assert all(abs(mine[k] - theirs[k]) <= 2.0 ** -7 * theirs[k]
               for k in theirs)
    early = [k for k in theirs if "layer2" not in k]
    assert len(early) == 11 and all(mine[k] == theirs[k] for k in early)


def test_plain_kernels_selects_the_plain_versions(quantised):
    models = [VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                             quant="int8_static", fused_pallas=True,
                             plain_kernels=p, device="cpu").eval()
              for p in (False, True)]
    sd = backbone_static_state_dict(quantised["qvars"])
    x = torch.from_numpy(quantised["imgs"]).bfloat16()
    outs = []
    for m in models:
        m.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs.append(m(x)[2])
    assert torch.equal(*outs)
    fused = [n for n, b in models[0].resnet.named_children()
             if isinstance(b, Bottleneck) and b.fused]
    assert fused == ["layer1_1", "layer1_2", "layer2_1"]
    assert "resnet.layer1_1.out_scale" in sd
    assert "resnet.layer1_2.out_scale" not in sd     # last of its stage


def test_odd_input_size_falls_back_to_the_im2col_stem(quantised):
    """30x30 is not a multiple of 4: conv 7x7/s2 + max-pool, as in JAX."""
    x = np.random.default_rng(6).standard_normal((2, 30, 30, 3)) \
        .astype(np.float32)
    qvars = _drop_out_scale(quantised["qvars"])
    want = JaxBackbone(layers=LAYERS, att_size=2, dtype=jnp.bfloat16,
                       quant="int8_static").apply(
        qvars, jnp.asarray(x, jnp.bfloat16))
    tm = VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                        quant="int8_static", device="cpu").eval()
    tm.load_state_dict(backbone_static_state_dict(qvars), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16())
    _equal(got[2], want[2])


def test_int8_input_to_an_unfused_block_raises():
    block = Bottleneck(64, 16, quant="int8_static", dtype=torch.bfloat16,
                       device="cpu")
    with pytest.raises(ValueError):
        block(torch.zeros(1, 64, 4, 4, dtype=torch.int8))
    with pytest.raises(ValueError):
        StemPoolS2D(quant="int4", device="cpu")
    with pytest.raises(ValueError):
        ConvBN(3, 8, 1, quant="int4", device="cpu")
