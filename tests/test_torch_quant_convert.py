"""Calibration, the offline quantiser and the int8-static weight bridge of
the PyTorch/CUDA port against the JAX package's `static_quantize_backbone`.

Both quantisers are numpy on the same float weights and the same
calibration record, so every leaf (`wq`, `w_scale`, `fused_bias`,
`act_scale`, `out_scale`) must be equal bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.models.convert import (  # noqa: E402
    static_quantize_backbone as jax_static_quantize_backbone)
from icka_tpu.models.resnet import VisualBackbone as JaxBackbone  # noqa: E402
from icka_tpu_torch.convert import (backbone_state_dict,  # noqa: E402
                                    backbone_static_state_dict,
                                    calib_from_flax)
from icka_tpu_torch.models.convert import (calibration_amax,  # noqa: E402
                                           merge_calib,
                                           static_quantize_backbone)
from icka_tpu_torch.models.resnet import VisualBackbone  # noqa: E402

LAYERS = (3, 2)       # layer1_1 is fused and not last: it has an out_scale


@pytest.fixture(scope="module")
def jax_side():
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((2, 32, 32, 3)).astype(np.float32) * 0.5
    fvars = jax.device_get(JaxBackbone(layers=LAYERS, att_size=2).init(
        jax.random.PRNGKey(0), jnp.asarray(imgs)))
    fvars = {"params": fvars["params"],
             "batch_stats": jax.tree_util.tree_map(
                 lambda a: (a * rng.uniform(0.5, 1.0, a.shape)
                            + rng.uniform(-0.05, 0.05, a.shape))
                 .astype(np.float32), fvars["batch_stats"])}
    _, calib = JaxBackbone(layers=LAYERS, att_size=2, dtype=jnp.bfloat16,
                           quant="int8").apply(
        fvars, jnp.asarray(imgs, jnp.bfloat16), mutable=["calib"])
    calib = jax.device_get(calib["calib"])
    targets, qvars = {}, {}
    for fused in (False, True):
        model = JaxBackbone(layers=LAYERS, att_size=2, dtype=jnp.bfloat16,
                            quant="int8_static", fused_pallas=fused,
                            pallas_interpret=True)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(1),
                                jnp.asarray(imgs, jnp.bfloat16))
        targets[fused] = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes)
        qvars[fused] = jax_static_quantize_backbone(targets[fused], fvars,
                                                    calib)
    return dict(imgs=imgs, fvars=fvars, calib=calib, qvars=qvars)


def _static_model(fused):
    return VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                          quant="int8_static", fused_pallas=fused,
                          device="cpu").eval()


@pytest.mark.parametrize("fused", [False, True])
def test_quantiser_equals_jax_quantiser(jax_side, fused):
    want = backbone_static_state_dict(jax_side["qvars"][fused])
    model = _static_model(fused)
    got = static_quantize_backbone(model.state_dict().keys(),
                                   backbone_state_dict(jax_side["fvars"]),
                                   calib_from_flax(jax_side["calib"]))
    assert sorted(got) == sorted(want)
    assert [k for k in got if k.endswith(".out_scale")] \
        == (["resnet.layer1_1.out_scale"] if fused else [])
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
    model.load_state_dict(got, strict=True)


def test_out_scale_is_the_next_blocks_conv1_act_scale(jax_side):
    sd = static_quantize_backbone(
        _static_model(True).state_dict().keys(),
        backbone_state_dict(jax_side["fvars"]),
        calib_from_flax(jax_side["calib"]))
    assert sd["resnet.layer1_1.out_scale"].ndim == 0
    assert sd["resnet.layer1_1.out_scale"] > 0
    assert torch.equal(sd["resnet.layer1_1.out_scale"],
                       sd["resnet.layer1_2.conv1.act_scale"])
    assert "resnet.layer1_2.out_scale" not in sd     # last of its stage


def test_port_calibration_feeds_the_port_quantiser(jax_side):
    """The port's own flow: dynamic model -> calibration_amax -> static
    state_dict, equal to the one made from the JAX calibration record."""
    dyn = VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                         quant="int8", device="cpu").eval()
    fp32_sd = backbone_state_dict(jax_side["fvars"])
    dyn.load_state_dict(fp32_sd, strict=True)
    assert "resnet.stem.calib_amax" not in dyn.state_dict()
    x = torch.from_numpy(jax_side["imgs"]).bfloat16()
    with torch.no_grad():
        dyn(x[:1])
        first = calibration_amax(dyn)
        dyn(x[1:])
    both = calibration_amax(dyn)
    theirs = calib_from_flax(jax_side["calib"])
    assert sorted(both) == sorted(theirs)
    assert all(both[k] >= first[k] for k in both)
    # per-tensor maxima over batches of one image merge to the maxima over
    # both images wherever activations do not depend on the batch
    assert both["resnet.stem"] == theirs["resnet.stem"]
    other = VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                           quant="int8", device="cpu").eval()
    other.load_state_dict(fp32_sd, strict=True)
    with torch.no_grad():
        other(x[1:])
    merged = merge_calib(first, calibration_amax(other))
    assert all(merged[k] == both[k] for k in both)
    keys = _static_model(False).state_dict().keys()
    mine = static_quantize_backbone(keys, fp32_sd, both)
    ref = static_quantize_backbone(keys, fp32_sd, theirs)
    for k in ref:
        if not k.endswith("act_scale"):
            assert torch.equal(mine[k], ref[k]), k


def test_bridge_keeps_int8_and_loads_strictly(jax_side):
    qvars = jax_side["qvars"][True]
    sd = backbone_static_state_dict(qvars)
    calib = calib_from_flax(jax_side["calib"])
    assert min(float(v) for v in calib.values()) > 0    # no dead layer
    wq = sd["resnet.layer1_1.conv2.wq"]
    assert wq.dtype == torch.int8 and tuple(wq.shape) == (9 * 64, 64)
    np.testing.assert_array_equal(
        wq.numpy(), qvars["params"]["resnet"]["layer1_1"]["conv2"]["wq"])
    assert sd["resnet.stem.act_scale"].ndim == 0
    assert sd["resnet.stem.act_scale"].dtype == torch.float32
    model = _static_model(True)
    model.load_state_dict(sd, strict=True)
    assert not list(model.parameters())         # buffers, not parameters
    assert model.resnet.stem.wq.dtype == torch.int8
    with pytest.raises(RuntimeError):           # a float tree does not fit
        model.load_state_dict(backbone_state_dict(jax_side["fvars"]),
                              strict=True)
    with pytest.raises(ValueError):
        backbone_static_state_dict(dict(
            qvars, batch_stats=jax_side["fvars"]["batch_stats"]))


def test_quantiser_wants_a_calibration_value_for_every_convbn(jax_side):
    calib = calib_from_flax(jax_side["calib"])
    del calib["resnet.layer2_0.downsample"]
    with pytest.raises(ValueError, match="layer2_0.downsample"):
        static_quantize_backbone(_static_model(False).state_dict().keys(),
                                 backbone_state_dict(jax_side["fvars"]),
                                 calib)
    with pytest.raises(ValueError, match="successor"):
        static_quantize_backbone(
            ["resnet.layer1_1.out_scale"], {}, {})
