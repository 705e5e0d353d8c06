"""K3-K6, the int8 conv kernels of the PyTorch/CUDA port.

On the CPU each plain version (`conv3x3_reference`, `bottleneck_reference`,
`bottleneck_v2_reference`, `stem_pool_reference`) is held against the JAX
package's Pallas kernel run in interpret mode on the same numpy inputs, and
must be bit-equal: the integer sums are exact and every epilogue is the
same sequence of fp32 multiplies, adds and roundings. The CUDA kernels run
only on a card: `tests/test_torch_on_card.py` holds them against the plain
versions there.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.kernels import conv as jconv  # noqa: E402
from icka_tpu_torch.kernels import conv as tconv  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(got, want):
    """Bit-equality of a torch result with a JAX one (bf16 through fp32,
    which is exact)."""
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16
        want, got = want.astype(np.float32), got.float()
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _conv3_inputs(seed=0, B=2, H=6, W=5, C=16, F=32):
    rng = np.random.default_rng(seed)
    return dict(
        x_pad=rng.integers(-127, 128, (B, H + 2, W + 2, C)).astype(np.int8),
        w_q=rng.integers(-127, 128, (9 * C, F)).astype(np.int8),
        scale=rng.uniform(1e-4, 1e-3, (F,)).astype(np.float32),
        bias=rng.normal(0, 1, (F,)).astype(np.float32),
        residual=rng.normal(0, 1, (B, H, W, F)).astype(np.float32))


def _bottleneck_inputs(seed=0, B=4, H=8, W=8, Cw=16):
    rng = np.random.default_rng(seed)
    Cin = 4 * Cw
    return [
        rng.integers(-127, 128, (B, H, W, Cin)).astype(np.int8),
        rng.integers(-127, 128, (Cin, Cw)).astype(np.int8),
        rng.integers(-127, 128, (9 * Cw, Cw)).astype(np.int8),
        rng.integers(-127, 128, (Cw, Cin)).astype(np.int8),
        rng.uniform(1e-4, 1e-3, (Cw,)).astype(np.float32),
        rng.normal(0, 1, (Cw,)).astype(np.float32),
        rng.uniform(1e-4, 1e-3, (Cw,)).astype(np.float32),
        rng.normal(0, 1, (Cw,)).astype(np.float32),
        rng.uniform(1e-4, 1e-3, (Cin,)).astype(np.float32),
        rng.normal(0, 1, (Cin,)).astype(np.float32)]


def _stem_inputs(seed=0, B=3, OB=8, F=64, K=432):
    rng = np.random.default_rng(seed)
    return [rng.integers(-127, 128, (B, OB, OB, K)).astype(np.int8),
            rng.integers(-127, 128, (K, 4 * F)).astype(np.int8),
            rng.uniform(1e-4, 1e-3, (4 * F,)).astype(np.float32),
            rng.normal(0, 0.5, (4 * F,)).astype(np.float32)]


CONV3_MODES = {
    "bf16": dict(),
    "bf16_residual": dict(residual=True),
    "bf16_residual_norelu": dict(residual=True, relu=False),
    "fp32": dict(out_dtype="float32"),
    "int8": dict(out_scale=0.05),
    "int8_residual_norelu": dict(out_scale=0.031, residual=True, relu=False),
}


@pytest.mark.parametrize("mode", list(CONV3_MODES))
def test_conv3x3_plain_version_equals_pallas_kernel(mode):
    """K3, every output mode, with and without residual and ReLU."""
    a = _conv3_inputs()
    m = CONV3_MODES[mode]
    res = a["residual"] if m.get("residual") else None
    dt = m.get("out_dtype", "bfloat16")
    want = jconv.int8_conv3x3(
        jnp.asarray(a["x_pad"]), jnp.asarray(a["w_q"]),
        jnp.asarray(a["scale"]), jnp.asarray(a["bias"]),
        residual=None if res is None else jnp.asarray(res),
        relu=m.get("relu", True), out_scale=m.get("out_scale"),
        out_dtype=jnp.dtype(dt), interpret=True)
    got = tconv.conv3x3_reference(
        _t(a["x_pad"]), _t(a["w_q"]), _t(a["scale"]), _t(a["bias"]),
        residual=None if res is None else _t(res), relu=m.get("relu", True),
        out_scale=m.get("out_scale"), out_dtype=getattr(torch, dt))
    if dt == "float32":
        # XLA:CPU contracts the epilogue's multiply and add into one FMA;
        # the port (and the TPU, which has none) rounds twice. Before any
        # rounding to bf16 or int8 that shows as one fp32 ulp of the sum.
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-7,
                                   atol=2e-6)
    else:
        _equal(got, want)


@pytest.mark.parametrize("padded_io", [False, True])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("out_bf16", [False, True])
def test_bottleneck_v2_plain_version_equals_pallas_kernel(out_bf16, g,
                                                          padded_io):
    """K4 through the port's wrapper on the CPU (which takes the plain
    version and handles the padded layout), for g in {1, 2} and both
    layouts. Padded inputs carry arbitrary borders; outputs zero ones."""
    args = _bottleneck_inputs()
    x = args[0]
    B, H = x.shape[:2]
    if padded_io:
        Wp = -(-(H + 2) // 32) * 32
        xp = np.random.default_rng(5).integers(
            -127, 128, (B, H + 2, Wp, x.shape[3])).astype(np.int8)
        xp[:, 1:H + 1, 1:H + 1] = x
        args = [xp] + args[1:]
    want = jconv.int8_bottleneck_v2(
        *(jnp.asarray(a) for a in args), 0.37, out_bf16=out_bf16, g=g,
        padded_io=padded_io, interpret=True)
    got = tconv.int8_bottleneck_v2(
        *(_t(a) for a in args), torch.tensor([0.37]), out_bf16=out_bf16,
        g=g, padded_io=padded_io)
    _equal(got, want)
    if padded_io:
        border = got.clone()
        border[:, 1:H + 1, 1:H + 1] = 0
        assert not border.any()


@pytest.mark.parametrize("out_bf16", [False, True])
def test_bottleneck_plain_version_equals_pallas_kernel(out_bf16):
    """K6: res_scale a Python float, a non-square grid."""
    args = _bottleneck_inputs(seed=1, B=2, H=6, W=8)
    want = jconv.int8_bottleneck(*(jnp.asarray(a) for a in args),
                                 res_scale=0.37, out_bf16=out_bf16,
                                 interpret=True)
    got = tconv.bottleneck_reference(*(_t(a) for a in args), 0.37,
                                     out_bf16=out_bf16)
    _equal(got, want)
    _equal(tconv.bottleneck_v2_reference(*(_t(a) for a in args),
                                         torch.tensor([0.37]),
                                         out_bf16=out_bf16), want)


def test_stem_pool_plain_version_equals_pallas_kernel():
    """K5, with its bf16 rounding points."""
    args = _stem_inputs()
    want = jconv.int8_stem_pool(*(jnp.asarray(a) for a in args),
                                interpret=True)
    _equal(tconv.stem_pool_reference(*(_t(a) for a in args)), want)


def test_int_dot_is_exact_where_fp32_is_not():
    """Sums of 9*512 products of +-127 reach 7.4e7, beyond fp32's 2^24."""
    a = torch.full((3, 9 * 512), 127, dtype=torch.int8)
    w = torch.full((9 * 512, 2), 127, dtype=torch.int8)
    w[0, 1] = 126
    got = tconv.int_dot(a, w)
    assert got.dtype == torch.int32
    assert got[0].tolist() == [9 * 512 * 127 * 127, 9 * 512 * 127 * 127 - 127]


def _call(name):
    """(wrapper, plain version, arguments) of one kernel at a small shape."""
    if name == "int8_conv3x3":
        a = _conv3_inputs()
        args = [_t(a[k]) for k in ("x_pad", "w_q", "scale", "bias",
                                           "residual")]
        return tconv.int8_conv3x3, tconv.conv3x3_reference, args, {}
    if name == "int8_stem_pool":
        args = [_t(a) for a in _stem_inputs()]
        return tconv.int8_stem_pool, tconv.stem_pool_reference, args, {}
    args = [_t(a) for a in _bottleneck_inputs()]
    if name == "int8_bottleneck":
        return (tconv.int8_bottleneck, tconv.bottleneck_reference,
                args + [0.37], {})
    return (tconv.int8_bottleneck_v2, tconv.bottleneck_v2_reference,
            args + [torch.tensor([0.37])], {})


KERNELS = ["int8_conv3x3", "int8_bottleneck_v2", "int8_stem_pool",
           "int8_bottleneck"]


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_takes_plain_version_on_cpu(name):
    wrapper, plain, args, kw = _call(name)
    before = wrapper.launches
    got = wrapper(*args, **kw)
    assert wrapper.launches == before
    assert torch.equal(got, plain(*args, **kw))


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_rejects_bad_shapes_and_types(name):
    wrapper, _, args, kw = _call(name)
    with pytest.raises(ValueError):
        wrapper(args[0].float(), *args[1:], **kw)        # not int8
    with pytest.raises(ValueError):
        wrapper(args[0], args[1][:-1], *args[2:], **kw)  # K mismatch


def test_bottleneck_v2_wants_square_grids_and_g_dividing_the_batch():
    _, _, args, _ = _call("int8_bottleneck_v2")
    with pytest.raises(ValueError):
        tconv.int8_bottleneck_v2(args[0][:, :, :6].contiguous(), *args[1:])
    with pytest.raises(ValueError):
        tconv.int8_bottleneck_v2(*args, g=3)
    with pytest.raises(ValueError):                      # Wp must be 32
        tconv.int8_bottleneck_v2(
            torch.zeros(4, 10, 10, 64, dtype=torch.int8), *args[1:],
            padded_io=True)
