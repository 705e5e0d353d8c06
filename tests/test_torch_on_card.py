"""The port's tests that need an NVIDIA GPU: each int8 conv kernel against
its plain version, bit-equal, the fused int8-static backbone against the
same backbone on the plain versions, and the two attention kernels against
their plain versions and against each other, within a stated tolerance. All
six kernels are covered. Besides, the exact int8 product (`torch._int_mm`)
and an int8-static `Dense` and BiLSTM input projection on the card against
the float64 product and the CPU, bit for bit; K1 at the gate_cl family's
12 heads, and a small gate_cl model served through K1 against the plain
core; K1 and K2 on the strided q/k/v views of one fused projection, and a
tiny fused int8-static gate_cl on the card against the CPU. And the modules
of rematerialised training without a kernel: a remat'd stack with dropout
against its plain step under each policy, the CRF's log-depth Viterbi and
marginals, the float space-to-depth stem, `sparsemax` and `MLP` against the
CPU (`chip_smoke.py` phase 11 runs these).

This file imports only torch and the port, so it also runs on a machine that
has a card but not the JAX package's dependencies:

    python -m pytest tests/test_torch_on_card.py -q

Every test carries the `cuda` marker and skips without a card.
"""

import pytest
import torch

from icka_tpu_torch.kernels import attention as tattn
from icka_tpu_torch.kernels import conv as tconv
from icka_tpu_torch.models.convert import (calibration_amax,
                                           static_quantize_backbone)
from icka_tpu_torch.models.resnet import VisualBackbone
from icka_tpu_torch.nn.layers import Dense
from icka_tpu_torch.nn.lstm import BiLSTM
from icka_tpu_torch.nn.quant import column_major, int8_matmul

pytestmark = pytest.mark.cuda

LAYERS = (3, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int32) \
        .to(torch.int8)


def _scales(gen, n):
    return torch.rand(n, generator=gen) * 9e-4 + 1e-4


def _conv3_case(gen, B, H, W, C, F):
    return [_int8(gen, B, H + 2, W + 2, C), _int8(gen, 9 * C, F),
            _scales(gen, F), torch.randn(F, generator=gen),
            torch.randn(B, H, W, F, generator=gen)]


def _bottleneck_case(gen, B, H, W, Cw):
    Cin = 4 * Cw
    return [_int8(gen, B, H, W, Cin), _int8(gen, Cin, Cw),
            _int8(gen, 9 * Cw, Cw), _int8(gen, Cw, Cin),
            _scales(gen, Cw), torch.randn(Cw, generator=gen),
            _scales(gen, Cw), torch.randn(Cw, generator=gen),
            _scales(gen, Cin), torch.randn(Cin, generator=gen)]


def _stem_case(gen, B, OB, F=64, K=432):
    return [_int8(gen, B, OB, OB, K), _int8(gen, K, 4 * F),
            _scales(gen, 4 * F), torch.randn(4 * F, generator=gen) * 0.5]


def _held(wrapper, plain, args, dev, **kw):
    """One launch of `wrapper` on the card, bit-equal to `plain`."""
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    before = wrapper.launches
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(*args, **kw)
    assert got.dtype == want.dtype and got.is_cuda
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", [
    dict(), dict(relu=False), dict(out_scale=0.05),
    dict(out_scale=0.031, relu=False), dict(out_dtype=torch.float32)])
@pytest.mark.parametrize("residual", [None, torch.float32, torch.bfloat16])
def test_int8_conv3x3_equals_plain_version(cuda_device, residual, mode):
    """Ragged tiles: 2*6*5 pixels and 48 channels fill no tile exactly."""
    gen = torch.Generator().manual_seed(0)
    *args, res = _conv3_case(gen, B=2, H=6, W=5, C=16, F=48)
    res = None if residual is None else res.to(residual)
    _held(tconv.int8_conv3x3, tconv.conv3x3_reference, args + [res],
          cuda_device, **mode)


@pytest.mark.parametrize("padded_io", [False, True])
@pytest.mark.parametrize("out_bf16", [False, True])
def test_int8_bottleneck_v2_equals_plain_version(cuda_device, out_bf16,
                                                 padded_io):
    gen = torch.Generator().manual_seed(1)
    args = _bottleneck_case(gen, B=4, H=8, W=8, Cw=16)
    rs = torch.tensor([0.37])
    if not padded_io:
        _held(tconv.int8_bottleneck_v2, tconv.bottleneck_v2_reference,
              args + [rs], cuda_device, out_bf16=out_bf16)
        return
    dev = cuda_device
    want = tconv.bottleneck_v2_reference(*(a.to(dev) for a in args),
                                         rs.to(dev), out_bf16)
    xp = _int8(gen, 4, 10, 32, 64)                  # arbitrary borders
    xp[:, 1:9, 1:9] = args[0]
    got = tconv.int8_bottleneck_v2(xp.to(dev), *(a.to(dev) for a in args[1:]),
                                   rs.to(dev), out_bf16, g=2, padded_io=True)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 1:9, 1:9], want)
    got[:, 1:9, 1:9] = 0
    assert not got.any()


@pytest.mark.parametrize("out_bf16", [False, True])
def test_int8_bottleneck_equals_plain_version(cuda_device, out_bf16):
    """res_scale a Python float, a non-square grid."""
    gen = torch.Generator().manual_seed(2)
    args = _bottleneck_case(gen, B=2, H=6, W=8, Cw=16)
    _held(tconv.int8_bottleneck, tconv.bottleneck_reference, args + [0.37],
          cuda_device, out_bf16=out_bf16)


def _stage_case(gen, B, H, Cw):
    """K4 operands whose requantised intermediates spread over [0, 127]:
    x as a block of a chain sees it, each scale about 40 steps over the
    product's spread."""
    Cin = 4 * Cw
    x = torch.randint(0, 128, (B, H, H, Cin), generator=gen,
                      dtype=torch.int32).to(torch.int8)

    def scale(n, k, rms):
        return 40.0 / (k ** 0.5 * rms * 73.3) * (0.5 + torch.rand(
            n, generator=gen))
    return [x, _int8(gen, Cin, Cw), _int8(gen, 9 * Cw, Cw),
            _int8(gen, Cw, Cin), scale(Cw, Cin, 73.5),
            torch.randn(Cw, generator=gen) * 10, scale(Cw, 9 * Cw, 28.0),
            torch.randn(Cw, generator=gen) * 10, scale(Cin, Cw, 28.0),
            torch.randn(Cin, generator=gen) * 10]


@pytest.mark.parametrize("out_bf16", [False, True])
@pytest.mark.parametrize("H,Cw", [(56, 64), (28, 128), (14, 256), (7, 512)])
def test_bottleneck_body_at_the_serving_stages(cuda_device, H, Cw, out_bf16):
    """The wgmma body at each ResNet-152 stage at the serving batch of 16,
    in clusters of the size `bottleneck_geometry` gives (1, 1, 2, 4): K4 in
    the plain and the padded layout and K6, one launch a call, counted by
    cluster size, bit-equal to the plain versions; a1q and a2q spread."""
    gen = torch.Generator().manual_seed(H)
    args = [a.to(cuda_device) for a in _stage_case(gen, 16, H, Cw)]
    rs = torch.tensor([0.37], device=cuda_device)
    cl = tconv.bottleneck_geometry(16, H, H, Cw, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)["CL"]
    want = tconv.bottleneck_v2_reference(*args, rs, out_bf16)
    assert want.float().std() > 5
    Wp = -(-(H + 2) // 32) * 32
    xp = torch.randint(-127, 128, (16, H + 2, Wp, 4 * Cw), generator=gen,
                       dtype=torch.int32).to(torch.int8).to(cuda_device)
    xp[:, 1:H + 1, 1:H + 1] = args[0]
    for fn, call in (
            (tconv.int8_bottleneck_v2,
             lambda: tconv.int8_bottleneck_v2(*args, rs, out_bf16)),
            (tconv.int8_bottleneck_v2,
             lambda: tconv.int8_bottleneck_v2(xp, *args[1:], rs, out_bf16,
                                              padded_io=True)),
            (tconv.int8_bottleneck,
             lambda: tconv.int8_bottleneck(*args, 0.37, out_bf16))):
        before = (fn.launches, fn.cluster_launches[cl])
        got = call()
        torch.cuda.synchronize()
        assert (fn.launches, fn.cluster_launches[cl]) == (before[0] + 1,
                                                          before[1] + 1)
        if got.shape[2] == Wp:
            assert torch.equal(got[:, 1:H + 1, 1:H + 1], want)
            got[:, 1:H + 1, 1:H + 1] = 0
            assert not got.float().any()
        else:
            assert torch.equal(got, want)


def test_bottleneck_body_on_column_tiles_and_padded_widths(cuda_device):
    """A grid too wide for whole rows (strips of columns with their own
    halo) and a width whose rows pad (Cw = 48: 64-byte rows, conv3 at 192
    channels), both output types."""
    gen = torch.Generator().manual_seed(11)
    for B, H, W, Cw in ((1, 3, 100, 16), (2, 12, 12, 48)):
        args = _bottleneck_case(gen, B, H, W, Cw)
        for out_bf16 in (False, True):
            _held(tconv.int8_bottleneck, tconv.bottleneck_reference,
                  args + [0.37], cuda_device, out_bf16=out_bf16)


@pytest.mark.parametrize("OB", [8, 20])
def test_int8_stem_pool_equals_plain_version(cuda_device, OB):
    """8: one ragged tile; 20: ragged tiles in both axes with halos."""
    gen = torch.Generator().manual_seed(3)
    _held(tconv.int8_stem_pool, tconv.stem_pool_reference,
          _stem_case(gen, 3, OB), cuda_device)


def test_int8_stem_pool_at_the_serving_batch(cuda_device):
    """B = 16 images of 56 x 56 outputs: 1024 tiles of 7 x 7, each
    consumer warpgroup of the 132 CTAs taking about four in turn; through
    the private entry with the weight laid out once, as the model calls
    it."""
    gen = torch.Generator().manual_seed(12)
    args = [a.to(cuda_device) for a in _stem_case(gen, 16, 56)]
    tiles = tconv.kmajor_tiles(args[1])
    before = tconv.int8_stem_pool.launches
    got = tconv._int8_stem_pool_tiled(tiles, *args)
    torch.cuda.synchronize()
    assert tconv.int8_stem_pool.launches == before + 1
    assert torch.equal(got, tconv.stem_pool_reference(*args))


@pytest.mark.parametrize("K,F", [(640, 64), (2048, 64), (1024, 32),
                                 (1296, 32)])
def test_int8_stem_pool_at_every_weight_placement(cuda_device, K, F):
    """K = 640 and 2048 at 4F = 256, 1296 at 128: the weight streams with
    the patches; 1024 at 128: resident, eight spans a tile through a ring
    of four slots a warpgroup. Ragged tiles, several a warpgroup."""
    gen = torch.Generator().manual_seed(K + F)
    g = tconv.stem_geometry(5, 20, K, 4 * F)
    assert g["resident"] == (K == 1024)
    _held(tconv.int8_stem_pool, tconv.stem_pool_reference,
          _stem_case(gen, 5, 20, F=F, K=K), cuda_device)


@pytest.mark.parametrize("B,H,C,F", [(1, 4, 5248, 16), (2, 7, 12288, 64),
                                     (1, 2, 16, 24576)])
def test_int8_conv3x3_at_widths_shared_memory_cannot_hold(cuda_device, B,
                                                          H, C, F):
    """A box of 41 spans a tap in two groups of 21 and 20, one of 96 in
    eight of 12; F = 24576 outputs, their scales and biases read from a
    padded global copy."""
    gen = torch.Generator().manual_seed(C + F)
    g = tconv.conv3x3_geometry(B, H, H, C, F)
    assert (g["ngroups"] > 1) == (C > 16) and g["staged"] == (F < 24576)
    *args, res = _conv3_case(gen, B=B, H=H, W=H, C=C, F=F)
    _held(tconv.int8_conv3x3, tconv.conv3x3_reference,
          args + [res.bfloat16()], cuda_device, out_scale=0.05)


@pytest.mark.parametrize("C", [64, 512])
def test_int8_conv3x3_at_stage_widths(cuda_device, C):
    """C = F = 64 at 56 x 56 (strips of whole rows, each tap's channels
    half a span) and 512 at 7 x 7 (four spans a tap, passes of 256
    channels), int8 out with a bf16 residual and bf16 out without."""
    gen = torch.Generator().manual_seed(C)
    H = 56 if C == 64 else 7
    *args, res = _conv3_case(gen, B=2, H=H, W=H, C=C, F=C)
    _held(tconv.int8_conv3x3, tconv.conv3x3_reference,
          args + [res.bfloat16()], cuda_device, out_scale=0.05)
    _held(tconv.int8_conv3x3, tconv.conv3x3_reference, args, cuda_device)


def test_kernels_refuse_what_they_cannot_take(cuda_device):
    """A CUDA tensor launches the kernel or raises: no silent plain path."""
    gen = torch.Generator().manual_seed(4)
    args = [a.to(cuda_device)
            for a in _conv3_case(gen, B=1, H=4, W=4, C=8, F=32)[:4]]
    before = tconv.int8_conv3x3.launches
    with pytest.raises(ValueError, match="C % 16"):
        tconv.int8_conv3x3(*args)
    with pytest.raises(ValueError, match="several devices"):
        tconv.int8_conv3x3(args[0].cpu(), *args[1:])
    assert tconv.int8_conv3x3.launches == before


def fused_backbones(dev, seed=0):
    """The port's own flow at a small depth: a float backbone, calibrated in
    the dynamic int8 mode, quantised offline, loaded into the fused backbone
    on the kernel wrappers and on their plain versions. Returns both models
    and the images."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(4, 32, 32, 3, generator=gen) * 0.5).to(dev).bfloat16()
    fp32_sd = VisualBackbone(LAYERS, att_size=2, device=dev,
                             seed=seed).state_dict()
    dyn = VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                         quant="int8", device=dev).eval()
    dyn.load_state_dict(fp32_sd, strict=True)
    with torch.no_grad():
        dyn(x)
    models = [VisualBackbone(LAYERS, att_size=2, dtype=torch.bfloat16,
                             quant="int8_static", fused_pallas=True,
                             plain_kernels=plain, device=dev).eval()
              for plain in (False, True)]
    sd = static_quantize_backbone(models[0].state_dict().keys(), fp32_sd,
                                  calibration_amax(dyn))
    for m in models:
        m.load_state_dict(sd, strict=True)
    return models, x


def test_fused_backbone_equals_the_backbone_on_plain_versions(cuda_device):
    """K5 once and K4 once per identity block, and a bit-identical att."""
    models, x = fused_backbones(cuda_device)
    outs = []
    for m, want in zip(models, ((1, 3), (0, 0))):
        before = (tconv.int8_stem_pool.launches,
                  tconv.int8_bottleneck_v2.launches)
        with torch.no_grad():
            outs.append(m(x)[2])
        torch.cuda.synchronize()
        after = (tconv.int8_stem_pool.launches,
                 tconv.int8_bottleneck_v2.launches)
        assert (after[0] - before[0], after[1] - before[1]) == want
    assert outs[0].dtype == torch.bfloat16
    assert tuple(outs[0].shape) == (4, 2, 2, 512)
    assert outs[0].float().std() > 0
    assert torch.equal(*outs)


# -- the attention kernels ----------------------------------------------------

def _assert_attn_close(got, want):
    """fp32: summation order only, max |got - want| <= 2e-5. bf16: outputs
    and probabilities are rounded to bf16 (in K2 at exp(s - m_running), where
    K1's plain version rounds the normalised p), so two right results differ
    by a few bf16 steps of each output, and the outputs shrink with the
    number of keys: every element within 6 steps of bf16 at its own size (a
    step is 2^-7 of its power of two; no finer than at the rms of all
    values), and an rms difference below 1e-2 of the values' rms (one
    rounding each gives about 0.003)."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        assert diff.max().item() <= 2e-5
        return
    size = want.float().abs()
    rms = size.square().mean().sqrt()
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(size, rms))) - 7)
    assert (diff / step).max().item() <= 6
    assert diff.square().mean().sqrt() <= 1e-2 * rms


def _attn_case(dev, dtype, B, Sq, Sk, N, hd, bias_kind, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, s, N * hd, generator=gen).to(dev, dtype)
               for s in (Sq, Sk, Sk))
    key = torch.zeros(B, Sk)
    key[:, Sk - 3:] = -10000.0
    if bias_kind == "B11Sk":
        bias = key[:, None, None, :]
    elif bias_kind == "BSk":
        bias = key
    else:                    # block-diagonal, as the packed server's masks
        slot = torch.arange(Sq)[:, None] * 3 // Sq
        slot_k = torch.arange(Sk)[None, :] * 3 // Sk
        bias = ((slot != slot_k) * -10000.0).expand(B, 1, Sq, Sk)
    return q, k, v, bias.to(dev)


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 128])
def test_fused_attention_at_other_head_widths(cuda_device, hd, dtype):
    """K1 at the widths beside the main path's 64; ragged key tiles."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind in ("B11Sk", "full"):
        q, k, v, bias = _attn_case(cuda_device, dtype, 3, 45, 70, 4, hd, kind)
        before = tattn.fused_attention.launches
        got = tattn.fused_attention(q, k, v, bias, 4)
        torch.cuda.synchronize()
        assert tattn.fused_attention.launches == before + 1
        want = tattn.attention_reference(q, k, v, bias, 4)
        _assert_attn_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_kind", ["B11Sk", "BSk", "full"])
@pytest.mark.parametrize("shape,hd,blocks", [
    ((23, 23), 64, (128, 128)), ((150, 150), 64, (32, 32)),
    ((172, 172), 64, (128, 128)), ((48, 256), 16, (16, 128)),
    ((150, 23), 32, (64, 64)), ((300, 300), 128, (128, 128))])
def test_blockwise_kernel_matches_plain_version_and_k1(
        cuda_device, shape, hd, blocks, bias_kind, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias = _attn_case(cuda_device, dtype, 2, *shape, 4, hd,
                               bias_kind)
    before = tattn.fused_attention_blockwise.launches
    got = tattn.fused_attention_blockwise(q, k, v, bias, 4, *blocks)
    torch.cuda.synchronize()
    assert tattn.fused_attention_blockwise.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = tattn.attention_blockwise_reference(q, k, v, bias, 4, *blocks)
    _assert_attn_close(got, want)
    _assert_attn_close(got, tattn.fused_attention(q, k, v, bias, 4))


def test_blockwise_tilings_agree_on_card(cuda_device):
    q, k, v, bias = _attn_case(cuda_device, torch.float32, 2, 150, 300, 4, 64,
                               "BSk")
    outs = [tattn.fused_attention_blockwise(q, k, v, bias, 4, bq, bk)
            for bq, bk in ((32, 32), (16, 128), (128, 128))]
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert _max_err(outs[0], other) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minus_inf_key_tiles_stay_finite(cuda_device, dtype):
    """-inf over the first whole key tiles of every second row: both kernels
    (on the tensor-core bodies, bf16 wgmma at this width and 3xTF32) start
    the running maximum at -1e30, so p = 0 and alpha = 1 there."""
    q, k, v, _ = _attn_case(cuda_device, dtype, 2, 40, 256, 2, 64, "BSk")
    bias = torch.zeros(2, 40, 256, device=cuda_device)
    bias[:, ::2, :128] = float("-inf")
    k1 = tattn.fused_attention(q, k, v, bias, 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(k1).all())
    _assert_attn_close(k1, tattn.attention_reference(q, k, v, bias, 2))
    for blocks in ((32, 128), (32, 32), (64, 64)):
        got = tattn.fused_attention_blockwise(q, k, v, bias, 2, *blocks)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        _assert_attn_close(got, tattn.attention_blockwise_reference(
            q, k, v, bias, 2, *blocks))
        _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 2))


def test_attention_kernels_refuse_what_they_cannot_take(cuda_device):
    """A CUDA tensor launches the kernel or raises: no silent plain path.
    No head width is refused (`test_wide_heads_run_both_kernels`)."""
    q = torch.zeros(1, 8, 2 * 64, device=cuda_device)
    bias = torch.zeros(1, 8, device=cuda_device)
    counts = (tattn.fused_attention.launches,
              tattn.fused_attention_blockwise.launches)
    for fn in (tattn.fused_attention, tattn.fused_attention_blockwise):
        with pytest.raises(ValueError, match="several devices"):
            fn(q, q, q, bias.cpu(), 2)
        with pytest.raises(TypeError):
            fn(q.half(), q.half(), q.half(), bias, 2)
    strided = torch.zeros(1, 8, 128, device=cuda_device)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_attention_blockwise(strided, strided, strided, bias, 2)
    assert counts == (tattn.fused_attention.launches,
                      tattn.fused_attention_blockwise.launches)


@pytest.mark.parametrize("hd", [8, 24, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_head_widths_run_both_kernels(cuda_device, dtype, hd):
    """A width without an instance runs on the next one, zero-padded: one
    launch of each kernel, the plain versions' result on the unpadded
    tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind in ("B11Sk", "full"):
        q, k, v, bias = _attn_case(cuda_device, dtype, 2, 45, 70, 4, hd, kind)
        for fn, plain in ((tattn.fused_attention, tattn.attention_reference),
                          (tattn.fused_attention_blockwise,
                           tattn.attention_blockwise_reference)):
            before = fn.launches
            got = fn(q, k, v, bias, 4)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            assert got.dtype == dtype and got.shape == q.shape
            _assert_attn_close(got, plain(q, k, v, bias, 4))


@pytest.mark.parametrize("hd", list(tattn.HEAD_DIMS) + [8, 40])
def test_blockwise_bf16_at_every_head_width(cuda_device, hd):
    """K2's tensor-core body at every instance's width and two padded ones,
    a ragged last tile in both dimensions, key and full bias."""
    for kind, blocks in (("BSk", (64, 128)), ("full", (128, 64))):
        q, k, v, bias = _attn_case(cuda_device, torch.bfloat16, 2, 150, 200,
                                   4, hd, kind, seed=hd)
        before = tattn.fused_attention_blockwise.launches
        got = tattn.fused_attention_blockwise(q, k, v, bias, 4, *blocks)
        torch.cuda.synchronize()
        assert tattn.fused_attention_blockwise.launches == before + 1
        _assert_attn_close(got, tattn.attention_blockwise_reference(
            q, k, v, bias, 4, *blocks))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sk,blocks,hd", [(129, (128, 128), 64),
                                          (65, (32, 64), 64),
                                          (33, (64, 32), 32)])
def test_blockwise_last_key_tile_of_one_key(cuda_device, Sk, blocks, hd,
                                            dtype):
    """Sk one past a multiple of the key tile: the last tile holds one key,
    its other rows arrive as zeros and score -inf (every tensor-core body:
    3xTF32, bf16 wgmma at width 64 and bf16 mma.sync at 32, whose key tile
    of 32 the wgmma body does not have)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias = _attn_case(cuda_device, dtype, 2, 70, Sk, 4, hd, "BSk")
    got = tattn.fused_attention_blockwise(q, k, v, bias, 4, *blocks)
    torch.cuda.synchronize()
    assert Sk % tattn.blockwise_tiles(70, Sk, hd, dtype, *blocks)[1] == 1
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, tattn.attention_blockwise_reference(
        q, k, v, bias, 4, *blocks))


def test_bf16_blockwise_raises_rather_than_launch_another_body(cuda_device):
    """A bf16 CUDA tensor reaches its tensor-core body (wgmma at 64,
    mma.sync at 40 padded to 48) or raises: a view two bytes past a 16-byte
    boundary (TMA and cp.async need 16) is refused before any launch at an
    instance's width; at a padded width the kernel reads the padded
    copies, fresh aligned allocations, and launches."""
    bias = torch.zeros(1, 8, device=cuda_device)
    before = tattn.fused_attention_blockwise.launches
    for hd in (64, 40):
        flat = torch.zeros(8 * 2 * hd + 1, device=cuda_device,
                           dtype=torch.bfloat16)
        q = flat[1:].view(1, 8, 2 * hd)
        assert q.is_contiguous() and q.data_ptr() % 16 == 2
        if hd % 16 == 0:
            with pytest.raises(ValueError, match="aligned to 16 bytes"):
                tattn.fused_attention_blockwise(q, q, q, bias, 2)
        else:       # the padded copies are fresh, aligned allocations
            tattn.fused_attention_blockwise(q, q, q, bias, 2)
            before += 1
    torch.cuda.synchronize()
    assert tattn.fused_attention_blockwise.launches == before


def test_k1_bf16_runs_the_tensor_core_body(cuda_device):
    """K1 in bf16 at head width 64 is one launch of the blockwise library's
    wgmma body at `K1_WGMMA_TILES`, counted on K1 (and on its
    `wgmma_launches`) and never on K2, bit-equal to K2 asked for the same
    tiling, and it raises on a view two bytes past a 16-byte boundary (TMA
    needs 16) before any launch."""
    counts = (tattn.fused_attention.launches,
              tattn.fused_attention_blockwise.launches,
              tattn.fused_attention.wgmma_launches)
    for kind in ("B11Sk", "full"):
        q, k, v, bias = _attn_case(cuda_device, torch.bfloat16, 3, 150, 150,
                                   16, 64, kind)
        got = tattn.fused_attention(q, k, v, bias, 16)
        torch.cuda.synchronize()
        _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 16))
        assert torch.equal(got, tattn.fused_attention_blockwise(
            q, k, v, bias, 16, *tattn.K1_WGMMA_TILES))
    assert (tattn.fused_attention.launches - counts[0],
            tattn.fused_attention_blockwise.launches - counts[1],
            tattn.fused_attention.wgmma_launches - counts[2]) == (2, 2, 2)
    flat = torch.zeros(8 * 128 + 1, device=cuda_device, dtype=torch.bfloat16)
    q = flat[1:].view(1, 8, 128)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        tattn.fused_attention(q, q, q, torch.zeros(1, 8, device=cuda_device),
                              2)
    assert tattn.fused_attention.launches - counts[0] == 2


def test_k1_fp32_runs_the_tensor_core_body(cuda_device):
    """K1 in fp32 at head width 64 is one launch of the blockwise library's
    3xTF32 wgmma body at `K1_FP32_TILES` (never the bf16 wgmma body),
    counted on K1 (and on its `tf32_wgmma_launches`) and never on K2,
    bit-equal to K2 asked for the same tiling and within 2e-5 of the plain
    version; it raises on a view four bytes past a 16-byte boundary (TMA
    needs 16) before any launch. TF32 matmuls stay off for the plain
    version; the kernel never reads that switch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = (tattn.fused_attention.launches,
              tattn.fused_attention_blockwise.launches,
              tattn.fused_attention.tf32_wgmma_launches)
    wgmma = tattn.fused_attention.wgmma_launches
    for kind in ("B11Sk", "full"):
        q, k, v, bias = _attn_case(cuda_device, torch.float32, 3, 150, 150,
                                   16, 64, kind)
        got = tattn.fused_attention(q, k, v, bias, 16)
        torch.cuda.synchronize()
        _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 16))
        assert torch.equal(got, tattn.fused_attention_blockwise(
            q, k, v, bias, 16, *tattn.K1_FP32_TILES))
    assert (tattn.fused_attention.launches - counts[0],
            tattn.fused_attention_blockwise.launches - counts[1],
            tattn.fused_attention.tf32_wgmma_launches - counts[2]) == (2, 2,
                                                                      2)
    assert tattn.fused_attention.wgmma_launches == wgmma
    flat = torch.zeros(8 * 128 + 1, device=cuda_device)
    q = flat[1:].view(1, 8, 128)
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        tattn.fused_attention(q, q, q, torch.zeros(1, 8, device=cuda_device),
                              2)
    assert tattn.fused_attention.launches - counts[0] == 2


WGMMA_TILINGS = [(bq, bk) for bq in tattn.WGMMA_BLOCK_SIZES
                 for bk in tattn.WGMMA_BLOCK_SIZES]


@pytest.mark.parametrize("blocks", WGMMA_TILINGS,
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("shape,kind", [
    ((150, 150), "B11Sk"), ((172, 172), "full"), ((23, 150), "BSk"),
    ((150, 23), "full"), ((300, 1024), "B11Sk")])
def test_wgmma_body_matches_both_plain_versions(cuda_device, shape, kind,
                                                blocks):
    """The wgmma body (bf16, head width 64) at each of its tilings through
    K2, and K1 at its own, against both plain versions: K1's and K2's
    serving shapes with a key and a full bias, ragged in both dimensions,
    and a long key sequence. B = 24 at 16 heads gives more work items than
    the persistent grid has blocks."""
    q, k, v, bias = _attn_case(cuda_device, torch.bfloat16, 24, *shape, 16,
                               64, kind)
    before = tattn.fused_attention_blockwise.wgmma_launches
    got = tattn.fused_attention_blockwise(q, k, v, bias, 16, *blocks)
    torch.cuda.synchronize()
    assert tattn.fused_attention_blockwise.wgmma_launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_attn_close(got, tattn.attention_blockwise_reference(
        q, k, v, bias, 16, *blocks))
    _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 16))
    k1 = tattn.fused_attention(q, k, v, bias, 16)
    torch.cuda.synchronize()
    _assert_attn_close(k1, tattn.attention_reference(q, k, v, bias, 16))


@pytest.mark.parametrize("blocks", WGMMA_TILINGS,
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_wgmma_body_at_one_key_and_a_minus_inf_tile(cuda_device, blocks):
    """One key (a tile of one valid row, the rest TMA's zeros), and -inf
    over the first 128 keys of every second row: finite, within the bound
    of both plain versions."""
    q, k, v, bias = _attn_case(cuda_device, torch.bfloat16, 3, 70, 1, 4, 64,
                               "BSk")
    bias = torch.zeros(3, 1, device=cuda_device)
    got = tattn.fused_attention_blockwise(q, k, v, bias, 4, *blocks)
    torch.cuda.synchronize()
    _assert_attn_close(got, tattn.attention_blockwise_reference(
        q, k, v, bias, 4, *blocks))
    _assert_attn_close(got, v.expand_as(got))     # one key: its value
    q, k, v, _ = _attn_case(cuda_device, torch.bfloat16, 3, 70, 256, 4, 64,
                            "BSk")
    bias = torch.zeros(3, 70, 256, device=cuda_device)
    bias[:, ::2, :128] = float("-inf")
    got = tattn.fused_attention_blockwise(q, k, v, bias, 4, *blocks)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, tattn.attention_blockwise_reference(
        q, k, v, bias, 4, *blocks))
    _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 4))


TF32_WGMMA_TILINGS = [(bq, 64) for bq in tattn.WGMMA_BLOCK_SIZES]


@pytest.mark.parametrize("blocks", TF32_WGMMA_TILINGS,
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("shape,kind", [
    ((150, 150), "B11Sk"), ((172, 172), "full"), ((23, 150), "BSk"),
    ((150, 23), "full"), ((300, 1024), "B11Sk")])
def test_tf32_wgmma_body_matches_both_plain_versions(cuda_device, shape,
                                                     kind, blocks):
    """The 3xTF32 wgmma body (fp32, head width 64) at each of its
    instances through K2, and K1 at its own, within 2e-5 of both plain
    versions: K1's and K2's serving shapes with a key and a full bias,
    ragged in both dimensions (a query tile of 128 whose second warpgroup
    has no row), and a long key sequence. B = 24 at 16 heads gives more
    work items than the persistent grid has blocks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias = _attn_case(cuda_device, torch.float32, 24, *shape, 16,
                               64, kind)
    before = tattn.fused_attention_blockwise.tf32_wgmma_launches
    got = tattn.fused_attention_blockwise(q, k, v, bias, 16, *blocks)
    torch.cuda.synchronize()
    assert tattn.fused_attention_blockwise.tf32_wgmma_launches == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    _assert_attn_close(got, tattn.attention_blockwise_reference(
        q, k, v, bias, 16, *blocks))
    _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 16))
    k1 = tattn.fused_attention(q, k, v, bias, 16)
    torch.cuda.synchronize()
    _assert_attn_close(k1, tattn.attention_reference(q, k, v, bias, 16))


@pytest.mark.parametrize("blocks", TF32_WGMMA_TILINGS,
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_tf32_wgmma_body_at_one_key_and_a_minus_inf_tile(cuda_device,
                                                         blocks):
    """One key (a tile of one valid row, the rest TMA's zeros), and -inf
    over the first two key tiles of every second row: finite, within 2e-5
    of both plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = _attn_case(cuda_device, torch.float32, 3, 70, 1, 4, 64,
                            "BSk")
    bias = torch.zeros(3, 1, device=cuda_device)
    got = tattn.fused_attention_blockwise(q, k, v, bias, 4, *blocks)
    torch.cuda.synchronize()
    _assert_attn_close(got, tattn.attention_blockwise_reference(
        q, k, v, bias, 4, *blocks))
    _assert_attn_close(got, v.expand_as(got))     # one key: its value
    q, k, v, _ = _attn_case(cuda_device, torch.float32, 3, 70, 256, 4, 64,
                            "BSk")
    bias = torch.zeros(3, 70, 256, device=cuda_device)
    bias[:, ::2, :128] = float("-inf")
    got = tattn.fused_attention_blockwise(q, k, v, bias, 4, *blocks)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, tattn.attention_blockwise_reference(
        q, k, v, bias, 4, *blocks))
    _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 4))


@pytest.mark.parametrize("wrapper", ["fused_attention",
                                     "fused_attention_blockwise"])
def test_tf32_wgmma_body_on_strided_views(cuda_device, wrapper):
    """The TMA tensor maps of fp32 q, k and v read in place: the views of
    one fused (B, S, 3D) projection and a tensor-parallel rank's columns
    of a gathered (8, 150, 3 x 1024) projection, each bit-equal to the same
    call on contiguous copies and within 2e-5 of the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = getattr(tattn, wrapper)
    plain = (tattn.attention_reference if wrapper == "fused_attention"
             else tattn.attention_blockwise_reference)
    q, k, v, bias = _attn_case(cuda_device, torch.float32, 3, 150, 150, 16,
                               64, "B11Sk")
    fused = torch.cat([q, k, v], dim=-1).split(q.shape[-1], dim=-1)
    H, n = 1024, 512
    qkv = torch.zeros(8, 150, 3 * H, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv.normal_(generator=gen)
    tp = [qkv[..., j * H + n:j * H + 2 * n] for j in range(3)]
    tp_bias = bias[:1].expand(8, 1, 1, 150)
    for views, b, N in ((fused, bias, 16), (tp, tp_bias, 8)):
        before = (fn.launches, fn.strided_launches, fn.tf32_wgmma_launches)
        got = fn(*views, b, N)
        torch.cuda.synchronize()
        assert (fn.launches - before[0], fn.strided_launches - before[1],
                fn.tf32_wgmma_launches - before[2]) == (1, 1, 1)
        copies = [t.contiguous() for t in views]
        assert torch.equal(got, fn(*copies, b, N))
        _assert_attn_close(got, plain(*copies, b, N))


@pytest.mark.parametrize("wrapper", ["fused_attention",
                                     "fused_attention_blockwise"])
def test_wgmma_launches_count_bf16_at_width_64_only(cuda_device, wrapper):
    """`wgmma_launches` rises by one for each bf16 launch at head width 64
    (and at 56, padded to 64), on contiguous tensors and on the strided
    views of a fused projection, and not at widths 48 or 128 in bf16 nor
    at 64 in fp32; `tf32_wgmma_launches` likewise for each fp32 launch at
    64 (and 56) and at no other width or type; `bf16_launches` counts
    every bf16 launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = getattr(tattn, wrapper)
    for dtype, hd, wgmma, tf32 in ((torch.bfloat16, 64, 1, 0),
                                   (torch.bfloat16, 56, 1, 0),
                                   (torch.bfloat16, 48, 0, 0),
                                   (torch.bfloat16, 128, 0, 0),
                                   (torch.float32, 64, 0, 1),
                                   (torch.float32, 56, 0, 1),
                                   (torch.float32, 48, 0, 0)):
        q, k, v, bias = _attn_case(cuda_device, dtype, 2, 45, 70, 4, hd,
                                   "BSk")
        fused = torch.cat([q, q], dim=-1)[..., :4 * hd]
        for args in ((q, k, v), (fused, k, v)):
            before = (fn.launches, fn.wgmma_launches, fn.bf16_launches,
                      fn.tf32_wgmma_launches)
            got = fn(*args, bias, 4)
            torch.cuda.synchronize()
            assert (fn.launches - before[0], fn.wgmma_launches - before[1],
                    fn.bf16_launches - before[2],
                    fn.tf32_wgmma_launches - before[3]) == (
                1, wgmma, int(dtype == torch.bfloat16), tf32)
            plain = (tattn.attention_reference if wrapper == "fused_attention"
                     else tattn.attention_blockwise_reference)
            _assert_attn_close(got, plain(*args, bias, 4))


@pytest.mark.parametrize("hd", [w for w in tattn.HEAD_DIMS if w <= 128]
                         + [8, 24, 40])
def test_fp32_at_every_head_width_up_to_128(cuda_device, hd):
    """Both wrappers in fp32 on the 3xTF32 body at every instance's width up
    to 128 and three padded ones, within 2e-5 of their plain versions; a
    ragged last tile in both dimensions, key and full bias."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, blocks in (("BSk", (64, 128)), ("full", (128, 64))):
        q, k, v, bias = _attn_case(cuda_device, torch.float32, 2, 150, 200,
                                   4, hd, kind, seed=hd)
        for fn, plain, args in (
                (tattn.fused_attention, tattn.attention_reference, ()),
                (tattn.fused_attention_blockwise,
                 tattn.attention_blockwise_reference, blocks)):
            before = fn.launches
            got = fn(q, k, v, bias, 4, *args)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            _assert_attn_close(got, plain(q, k, v, bias, 4, *args))


@pytest.mark.parametrize("hd", [144, 160, 256, 272, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_heads_run_both_kernels(cuda_device, dtype, hd):
    """Widths above 128 run the CUDA-core blockwise body through both
    wrappers (144 zero-padded to 160, 272 to 288; above 256 in column
    chunks of at most 256), one launch each, the plain versions' result;
    ragged tiles in both dimensions, key and full bias."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind in ("BSk", "full"):
        q, k, v, bias = _attn_case(cuda_device, dtype, 2, 75, 70, 2, hd, kind,
                                   seed=hd)
        for fn, plain in ((tattn.fused_attention, tattn.attention_reference),
                          (tattn.fused_attention_blockwise,
                           tattn.attention_blockwise_reference)):
            before = fn.launches
            got = fn(q, k, v, bias, 2)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            assert got.dtype == dtype and got.shape == q.shape
            _assert_attn_close(got, plain(q, k, v, bias, 2))


@pytest.mark.parametrize("case", ["conv3x3", "bottleneck_v2", "bottleneck",
                                  "stem"])
def test_conv_kernels_bit_equal_at_ragged_shapes(cuda_device, case):
    """Pixel counts that no tile divides, F = 64 channels, and the stem's
    K = 432 (no multiple of the 128-byte span a TMA box brings): the boxes
    arrive zero-filled past the image and past K or C, and the stem runs
    only the k-steps that reach K."""
    gen = torch.Generator().manual_seed(5)
    if case == "conv3x3":            # M = 3 * 7 * 9 = 189, F = 64
        *args, res = _conv3_case(gen, B=3, H=7, W=9, C=32, F=64)
        _held(tconv.int8_conv3x3, tconv.conv3x3_reference, args + [res],
              cuda_device, out_scale=0.05)
    elif case == "bottleneck_v2":    # M = 2 * 9 * 9 = 162, Cw = 64
        args = _bottleneck_case(gen, B=2, H=9, W=9, Cw=64)
        _held(tconv.int8_bottleneck_v2, tconv.bottleneck_v2_reference,
              args + [torch.tensor([0.37])], cuda_device)
    elif case == "bottleneck":       # M = 3 * 5 * 7 = 105, F = 64 in conv3
        args = _bottleneck_case(gen, B=3, H=5, W=7, Cw=16)
        _held(tconv.int8_bottleneck, tconv.bottleneck_reference,
              args + [0.37], cuda_device, out_bf16=True)
    else:                            # K = 432, 13 x 13 outputs
        _held(tconv.int8_stem_pool, tconv.stem_pool_reference,
              _stem_case(gen, 2, 13), cuda_device)


@pytest.mark.parametrize("M,K,N", [(5, 64, 64), (16, 1024, 1024),
                                   (17, 64, 64), (17, 1024, 4096),
                                   (392, 1024, 1024), (33, 147, 60)])
def test_int8_matmul_exact_on_card(cuda_device, M, K, N):
    """M, K and N padded up to multiples of 8 (M to at least 24) where the
    card's `_int_mm` needs it; either layout of the weight."""
    gen = torch.Generator().manual_seed(M + K + N)
    a, w = _int8(gen, M, K), _int8(gen, K, N)
    want = tconv.int_dot(a, w)
    for wt in (w, column_major(w)):
        got = int8_matmul(a.to(cuda_device), wt.to(cuda_device))
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_static_text_modules_equal_cpu(cuda_device, dtype):
    """Division, rounding and the scale multiplies are correctly rounded on
    both devices, so the card's results equal the CPU's bit for bit."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 21, 64, generator=gen) * 2).to(dtype)
    dense = Dense(64, 48, dtype=dtype, quant="int8_static", device="cpu")
    lstm = BiLSTM(64, 16, dtype=dtype, quant="int8_static", device="cpu")
    for mod, wq in ((dense, "kernel_q"), (lstm, "w_ih_q")):
        sd = mod.state_dict()
        sd[wq] = _int8(gen, *sd[wq].shape)
        sd["act_scale"] = torch.tensor(0.021)
        mod.load_state_dict(sd)
    for mod, fn in ((dense, lambda m, v: m(v)),
                    (lstm, lambda m, v: m.input_projection(v))):
        with torch.no_grad():
            want = fn(mod, x)
            got = fn(mod.to(cuda_device), x.to(cuda_device)).cpu()
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_k1_refuses_a_gradient_on_the_card(cuda_device):
    """The kernel launches in the forward; autograd's backward through it
    raises instead of taking the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 24, 64, device=cuda_device, generator=gen,
                           requires_grad=True) for _ in range(3))
    bias = torch.zeros(2, 1, 1, 24, device=cuda_device)
    before = tattn.fused_attention.launches
    out = tattn.fused_attention(q, k, v, bias, 4)
    assert tattn.fused_attention.launches == before + 1
    with pytest.raises(RuntimeError, match="no backward"):
        out.sum().backward()


def test_tiny_train_steps_on_the_card_equal_the_cpus(cuda_device, tmp_path):
    """Two fp32 train steps of the tiny flagship, TF32 off and dropout 0,
    from the same weights and batches: the losses and gradient norms within
    1e-5 and 1e-4 relative, the moments after the first step (lr 0 under
    warmup) within 1e-4 in relative L2, and the second step's parameter
    updates within 1e-3 in relative L2 (`chip_smoke.py` phase 8's bounds,
    where the full-width step at depth two reads 4.4e-5)."""
    import dataclasses

    from icka_tpu_torch.core.config import EncoderConfig, ICKAConfig, \
        TrainConfig
    from icka_tpu_torch.data.clip_store import ClipFeatureStore
    from icka_tpu_torch.data.conll import read_mm_conll
    from icka_tpu_torch.data.features import convert_examples
    from icka_tpu_torch.data.loader import MNERLoader
    from icka_tpu_torch.data.synthetic import (generate_dataset,
                                               tiny_tokenizer)
    from icka_tpu_torch.train.trainer import ICKATrainer

    ds = str(tmp_path)
    generate_dataset(ds, n_train=8, n_valid=0, n_test=0, clip_dim=8,
                     write_images=False)
    tok = tiny_tokenizer(ds + "/tok")
    feats = convert_examples(read_mm_conll(ds + "/train.txt"), tok, 24,
                             ClipFeatureStore.from_split(ds, "train"), 8)
    enc = dataclasses.replace(EncoderConfig.tiny(len(tok.vocab) + 8),
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    cfg = dataclasses.replace(ICKAConfig.tiny(), embedding=enc,
                              last_encoder=enc, clip_dim=8,
                              max_seq_length=24, region_dim=2048)
    tcfg = TrainConfig(learning_rate=1e-3, train_batch_size=2,
                       gradient_accumulation_steps=2,
                       compute_dtype="float32")
    batches = list(MNERLoader(feats, ds + "/images", 2, 2, train=True,
                              decode_size=40, prefetch=0))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu, card = (ICKATrainer(cfg, tcfg, feats.spec,
                                 resnet_layers=(1, 1, 1, 1), device=d)
                     for d in ("cpu", cuda_device))
        for t in (cpu, card):
            t.model.load_state_dict(cpu.model.state_dict())
            t.backbone.load_state_dict(cpu.backbone.state_dict())
            t.model.map_alignment.dropout = 0.0
            t.model.map_vision.dropout = 0.0
            t.init_state(4)
        p0 = {n: p.detach().clone() for n, p in cpu.params().items()}

        def rel_l2(pairs):
            num = den = 0.0
            for a, b in pairs:
                a, b = a.detach().cpu().double(), b.detach().cpu().double()
                num += float((a - b).square().sum())
                den += float(b.square().sum())
            return (num / den) ** 0.5

        for i, batch in enumerate(batches):
            want, got = (t.train_step(batch, (0, i)) for t in (cpu, card))
            assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)
            assert abs(got.grad_norm - want.grad_norm) <= \
                1e-4 * want.grad_norm
            if i == 0:
                assert rel_l2((getattr(card.opt_state, k)[n],
                               getattr(cpu.opt_state, k)[n])
                              for k in ("mu", "nu") for n in p0) <= 1e-4
        cards = card.params()
        assert rel_l2((cards[n].cpu() - p0[n], p - p0[n])
                      for n, p in cpu.params().items()) <= 1e-3
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,bias_kind", [(16, "B11Sk"), (24, "B11Sk"),
                                         (128, "B11Sk"), (48, "full")])
def test_fused_attention_at_bert_base_heads(cuda_device, S, bias_kind,
                                            dtype):
    """K1 at the gate_cl family's shapes: 12 heads of 64, the bucketed
    lengths below and at the kernel's (64, 32) tile with a key bias, and a
    packed row of 48 with a block-diagonal full bias."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias = _attn_case(cuda_device, dtype, 4, S, S, 12, 64,
                               bias_kind)
    before = tattn.fused_attention.launches
    got = tattn.fused_attention(q, k, v, bias, 12)
    torch.cuda.synchronize()
    assert tattn.fused_attention.launches == before + 1
    _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 12))


def test_gate_cl_bucketed_kernel_path_equals_plain_core(cuda_device):
    """A small gate_cl model (BERT dialect, 12 heads of 64) served bucketed
    in fp32 through K1 and through the plain attention core on the same
    weights: one launch per self-attention layer a batch, emissions within
    1e-4 and the same tags."""
    import dataclasses

    import numpy as np

    from icka_tpu_torch.core.config import EncoderConfig, GateCLConfig
    from icka_tpu_torch.models.gate_cl import GateCLModel
    from icka_tpu_torch.serving.bucketed import BucketedGateCLServer

    enc = dataclasses.replace(EncoderConfig.bert_base(),
                              num_hidden_layers=2, vocab_size=200)
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        models = {p: GateCLModel(GateCLConfig(
            encoder=dataclasses.replace(enc, use_pallas=p), region_dim=64,
            max_seq_length=32, masked_crs=True), device=cuda_device,
            seed=3).eval() for p in (True, False)}
        rng = np.random.default_rng(0)
        exs = [{"input_ids": rng.integers(1, 200, n).astype(np.int64),
                "visual_mean": rng.standard_normal(64).astype(np.float32),
                "visual_grid": rng.standard_normal((7, 7, 64))
                .astype(np.float32)} for n in (5, 16, 17, 30, 40)]
        servers = {p: BucketedGateCLServer(m, buckets=(16, 32), max_batch=4,
                                           device=cuda_device)
                   for p, m in models.items()}
        before = tattn.fused_attention.launches
        tags, stats = servers[True].predict(exs)
        batches = sum(stats.batches_per_bucket.values())
        assert tattn.fused_attention.launches == before + 2 * batches
        want, _ = servers[False].predict(exs)
        for g, w in zip(tags, want):
            np.testing.assert_array_equal(g, w)
        with torch.inference_mode():
            _, _, _, batch = next(servers[True].batches(exs))
            em = [m(**batch, return_emissions=True) for m in models.values()]
        assert (em[0] - em[1]).abs().max().item() <= 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,hd", [(12, 64), (16, 64), (8, 128), (12, 40)])
@pytest.mark.parametrize("wrapper", ["fused_attention",
                                     "fused_attention_blockwise"])
def test_attention_reads_strided_qkv_views(cuda_device, wrapper, N, hd,
                                           dtype):
    """q, k and v as the (B, S, D) slices of one fused (B, S, 3D)
    projection (`fuse_qkv`): the kernel reads them in place (widths with an
    instance) or as padded copies (40), bit-equal to the same kernel on
    contiguous copies and within the plain version's bounds, counted as a
    strided launch. Key and block-diagonal biases, a ragged length."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = getattr(tattn, wrapper)
    plain = (tattn.attention_reference if wrapper == "fused_attention"
             else tattn.attention_blockwise_reference)
    gen = torch.Generator().manual_seed(N * hd)
    B, S, D = 3, 37, N * hd
    fused = torch.randn(B, S, 3 * D, generator=gen).to(cuda_device, dtype)
    q, k, v = fused.split(D, dim=-1)
    assert not q.is_contiguous() and q.stride(1) == 3 * D
    for kind in ("B11Sk", "full"):
        _, _, _, bias = _attn_case(cuda_device, dtype, B, S, S, N, hd, kind)
        before = (fn.launches, fn.strided_launches)
        got = fn(q, k, v, bias, N)
        torch.cuda.synchronize()
        assert (fn.launches, fn.strided_launches) == (before[0] + 1,
                                                      before[1] + 1)
        assert got.is_contiguous() and got.shape == q.shape
        want = fn(*(t.contiguous() for t in (q, k, v)), bias, N)
        assert fn.strided_launches == before[1] + 1
        assert torch.equal(got, want)
        _assert_attn_close(got, plain(q, k, v, bias, N))


def test_attention_refuses_a_misaligned_row_stride(cuda_device):
    """Rows a number of elements apart that is not a multiple of 8, or
    batches not S rows apart, raise before any launch."""
    bias = torch.zeros(2, 8, device=cuda_device)
    for dtype, extra in ((torch.float32, 4), (torch.bfloat16, 2)):
        fused = torch.zeros(2, 8, 3 * 128 + extra, device=cuda_device,
                            dtype=dtype)
        q, k, v = fused[..., :384].split(128, dim=-1)
        batches = torch.zeros(2, 9, 128, device=cuda_device,
                              dtype=dtype)[:, :8]
        for fn in (tattn.fused_attention, tattn.fused_attention_blockwise):
            before = fn.launches
            with pytest.raises(ValueError, match="multiple of 8"):
                fn(q, k, v, bias, 2)
            with pytest.raises(ValueError, match="batches S rows apart"):
                fn(batches, batches, batches, bias, 2)
            assert fn.launches == before


def test_fused_int8_static_gate_cl_on_card_equals_cpu(cuda_device):
    """A tiny gate_cl (BERT dialect, 2 heads of 64) in bench.py's serving
    layout, int8-static with `fuse_qkv` and K1, calibrated and quantised
    on the CPU: on the card the fused `qkv` Dense gives the CPU's output
    bit for bit, K1 runs once a self-attention layer on strided views, and
    the served tags and emissions follow the CPU's."""
    import copy
    import dataclasses

    import numpy as np

    from icka_tpu_torch.core.config import EncoderConfig, GateCLConfig
    from icka_tpu_torch.models.convert import (calibration_amax,
                                               fuse_qkv_params,
                                               quantize_params_like,
                                               static_quantize_params_like)
    from icka_tpu_torch.models.gate_cl import GateCLModel
    from icka_tpu_torch.serving.bucketed import BucketedGateCLServer

    enc = dataclasses.replace(EncoderConfig.bert_base(), hidden_size=128,
                              num_attention_heads=2, intermediate_size=256,
                              num_hidden_layers=2, vocab_size=200,
                              use_pallas=True)

    def model(**kw):
        cfg = GateCLConfig(encoder=dataclasses.replace(enc, **kw),
                           region_dim=64, max_seq_length=32, masked_crs=True)
        return GateCLModel(cfg, device="cpu", seed=3).eval()
    rng = np.random.default_rng(0)
    exs = [{"input_ids": rng.integers(1, 200, n).astype(np.int64),
            "visual_mean": rng.standard_normal(64).astype(np.float32),
            "visual_grid": rng.standard_normal((7, 7, 64)).astype(np.float32)}
           for n in (5, 16, 17, 30, 40)]
    fp = model()
    dyn = model(quant="int8")
    dyn.load_state_dict(quantize_params_like(dyn.state_dict().keys(),
                                             fp.state_dict()), strict=True)
    BucketedGateCLServer(dyn, buckets=(16, 32), max_batch=4,
                         device="cpu").predict(exs)
    cpu = model(quant="int8_static", fuse_qkv=True)
    keys = cpu.state_dict().keys()
    cpu.load_state_dict(static_quantize_params_like(
        keys, fuse_qkv_params(keys, fp.state_dict()),
        fuse_qkv_params(keys, calibration_amax(dyn))), strict=True)
    card = copy.deepcopy(cpu).to(cuda_device)

    x = torch.randn(4, 32, 128, generator=torch.Generator().manual_seed(1))
    qkv = cpu.bert.encoder.layer_0.attn.qkv
    with torch.inference_mode():
        want = qkv(x)
        got = card.bert.encoder.layer_0.attn.qkv(x.to(cuda_device)).cpu()
    assert torch.equal(got, want)

    servers = [BucketedGateCLServer(m, buckets=(16, 32), max_batch=4,
                                    device=d)
               for m, d in ((card, cuda_device), (cpu, "cpu"))]
    before = (tattn.fused_attention.launches,
              tattn.fused_attention.strided_launches)
    tags, stats = servers[0].predict(exs)
    torch.cuda.synchronize()
    batches = sum(stats.batches_per_bucket.values())
    assert (tattn.fused_attention.launches - before[0],
            tattn.fused_attention.strided_launches - before[1]) == \
        (2 * batches, 2 * batches)
    want_tags, _ = servers[1].predict(exs)
    agree = sum(int((g == w).sum()) for g, w in zip(tags, want_tags))
    assert agree / sum(len(w) for w in want_tags) >= 0.99
    with torch.inference_mode():
        _, _, _, batch = next(servers[0].batches(exs))
        em = card(**batch, return_emissions=True).double().cpu()
        em_cpu = cpu(**{k: v.cpu() for k, v in batch.items()},
                     return_emissions=True).double()
    cos = (em * em_cpu).sum(-1) / (em.norm(dim=-1) * em_cpu.norm(dim=-1))
    assert cos.min().item() >= 0.999


@pytest.fixture
def strict_fp32(cuda_device):
    """TF32 off for the test's fp32 products, the flags restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.parametrize("policy", ["dots", "dots_nb", "alternate", "full"])
def test_remat_encoder_on_the_card_equals_its_plain_step(strict_fp32,
                                                         policy):
    """A 2-layer stack in fp32 with dropout 0.1 drawn from a generator on
    the card: each policy's gradients within 1e-6 of the plain stack's and
    the generator left in the same state; and the products each policy
    recomputes, as the CPU tests pin them (the card's `F.linear` and
    einsum lower to the same `mm` and `bmm`)."""
    import collections
    import dataclasses

    from torch.utils._python_dispatch import TorchDispatchMode

    from icka_tpu_torch.core.config import EncoderConfig
    from icka_tpu_torch.nn.attention import Encoder

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts[func.name().split(".")[0]] += 1
            return func(*args, **(kwargs or {}))

    dev = strict_fp32

    def run(remat):
        cfg = dataclasses.replace(EncoderConfig.tiny(), hidden_size=64,
                                  remat=remat, remat_policy=policy)
        enc = Encoder(cfg, device=dev,
                      generator=torch.Generator(dev).manual_seed(1))
        x = torch.randn(4, 40, 64, device=dev,
                        generator=torch.Generator(dev).manual_seed(2),
                        requires_grad=True)
        bias = torch.zeros(4, 1, 1, 40, device=dev)
        bias[1, ..., 30:] = -10000.0
        gen = torch.Generator(dev).manual_seed(5)
        with Ops() as ops:
            enc(x, bias, gen).square().sum().backward()
        torch.cuda.synchronize()
        return ([x.grad] + [p.grad for p in enc.parameters()],
                gen.get_state(), ops.counts)
    want, want_state, plain_ops = run(False)
    got, state, ops = run(True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
    assert torch.equal(state, want_state)
    extra = ops - plain_ops
    layers = 1 if policy == "alternate" else 2
    per_layer = {"dots": (0, 0), "dots_nb": (0, 2)}.get(policy, (6, 2))
    assert (extra["aten::mm"], extra["aten::bmm"]) == tuple(
        layers * n for n in per_layer), extra


def test_crf_parallel_decode_and_marginals_on_the_card(cuda_device):
    """At the flagship's serving shape (B=8, L=128, its 15 labels):
    `crf_decode_parallel` on the card gives the sequential decode's tags
    and the CPU's, `crf_marginals` the CPU's within 1e-4. (At 128 steps the
    log-potentials reach about 350, where one fp32 step is 3.05e-5: the
    CPU's own fp32 marginals are 1.2e-5 from float64's on such inputs;
    `chip_smoke.py`'s CRF_MARGINALS_TOL.)"""
    from icka_tpu_torch.nn.crf import (crf_decode, crf_decode_parallel,
                                       crf_marginals)

    gen = torch.Generator().manual_seed(0)
    B, L, T = 8, 128, 15
    em = torch.randn(B, L, T, generator=gen)
    lens = torch.tensor([128, 100, 64, 33, 17, 5, 2, 1])
    mask = (torch.arange(L)[None] < lens[:, None]).int()
    params = [torch.rand(T, generator=gen) - 0.5,
              torch.rand(T, generator=gen) - 0.5,
              torch.rand(T, T, generator=gen) - 0.5]
    card = [t.to(cuda_device) for t in (em, mask, *params)]
    tags = crf_decode_parallel(*card)
    assert torch.equal(tags, crf_decode(*card))
    assert torch.equal(tags.cpu(), crf_decode_parallel(em, mask, *params))
    marg = crf_marginals(*card).cpu()
    torch.testing.assert_close(marg, crf_marginals(em, mask, *params),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(marg.sum(-1), torch.ones(B, L), atol=1e-4,
                               rtol=0)


def test_float_stem_sparsemax_and_mlp_on_the_card(strict_fp32):
    """The float `StemPoolS2D` (fp32, TF32 off), `sparsemax` and `MLP` on
    the card against the same modules on the CPU, within 1e-5."""
    import copy

    from icka_tpu_torch.models.resnet import StemPoolS2D
    from icka_tpu_torch.nn.layers import MLP, sparsemax

    dev = strict_fp32
    gen = torch.Generator().manual_seed(0)
    stem = StemPoolS2D(quant="none", device="cpu", generator=gen).eval()
    with torch.no_grad():
        stem.mean.uniform_(-0.2, 0.2, generator=gen)
        stem.var.uniform_(0.5, 1.5, generator=gen)
    x = torch.randn(2, 224, 224, 3, generator=gen)
    mlp = MLP(64, 256, 32, device="cpu", generator=gen)
    h = torch.randn(3, 17, 64, generator=gen)
    logits = torch.randn(4, 9, 33, generator=gen) * 2
    with torch.no_grad():
        for module, inp in ((stem, x), (mlp, h)):
            want = module(inp)
            got = copy.deepcopy(module).to(dev)(inp.to(dev)).cpu()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(sparsemax(logits.to(dev)).cpu(),
                               sparsemax(logits), atol=1e-5, rtol=0)
