"""The port's tests that need an NVIDIA GPU: each int8 conv kernel against
its plain version, bit-equal, the fused int8-static backbone against the
same backbone on the plain versions, and the two attention kernels against
their plain versions and against each other, within a stated tolerance. All
six kernels are covered. Besides, the exact int8 product (`torch._int_mm`)
and an int8-static `Dense` and BiLSTM input projection on the card against
the float64 product and the CPU, bit for bit; K1 at the gate_cl family's
12 heads, and a small gate_cl model served through K1 against the plain
core; K1 and K2 on the strided q/k/v views of one fused projection, and a
tiny fused int8-static gate_cl on the card against the CPU.

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


@pytest.mark.parametrize("OB", [8, 20])
def test_int8_stem_pool_equals_plain_version(cuda_device, OB):
    """8: one ragged tile; 20: ragged tiles in both axes with halos."""
    gen = torch.Generator().manual_seed(3)
    _held(tconv.int8_stem_pool, tconv.stem_pool_reference,
          _stem_case(gen, 3, OB), cuda_device)


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
    (on the tensor-core bodies, bf16 and 3xTF32) start the running maximum
    at -1e30, so p = 0 and alpha = 1 there."""
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
@pytest.mark.parametrize("Sk,blocks", [(129, (128, 128)), (65, (32, 64)),
                                       (33, (64, 32))])
def test_blockwise_last_key_tile_of_one_key(cuda_device, Sk, blocks, dtype):
    """Sk one past a multiple of the key tile: the last tile holds one key,
    its other rows arrive as zeros and score -inf (both tensor-core
    bodies)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias = _attn_case(cuda_device, dtype, 2, 70, Sk, 4, 64, "BSk")
    got = tattn.fused_attention_blockwise(q, k, v, bias, 4, *blocks)
    torch.cuda.synchronize()
    assert Sk % tattn.blockwise_tiles(70, Sk, 64, dtype, *blocks)[1] == 1
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, tattn.attention_blockwise_reference(
        q, k, v, bias, 4, *blocks))


def test_bf16_blockwise_raises_rather_than_launch_another_body(cuda_device):
    """A bf16 CUDA tensor reaches the tensor-core body or raises: a view two
    bytes past a 16-byte boundary (cp.async needs 16) is refused before any
    launch at an instance's width; at a padded width the kernel reads the
    padded copies, fresh aligned allocations, and launches."""
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
    """K1 in bf16 is one launch of the blockwise library's tensor-core body,
    counted on K1 and never on K2, and it raises on a view two bytes past a
    16-byte boundary (cp.async needs 16) before any launch."""
    counts = (tattn.fused_attention.launches,
              tattn.fused_attention_blockwise.launches)
    for kind in ("B11Sk", "full"):
        q, k, v, bias = _attn_case(cuda_device, torch.bfloat16, 3, 150, 150,
                                   16, 64, kind)
        got = tattn.fused_attention(q, k, v, bias, 16)
        torch.cuda.synchronize()
        _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 16))
        _assert_attn_close(got, tattn.fused_attention_blockwise(
            q, k, v, bias, 16, *tattn.K1_TILES))
    assert (tattn.fused_attention.launches - counts[0],
            tattn.fused_attention_blockwise.launches - counts[1]) == (2, 2)
    flat = torch.zeros(8 * 128 + 1, device=cuda_device, dtype=torch.bfloat16)
    q = flat[1:].view(1, 8, 128)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        tattn.fused_attention(q, q, q, torch.zeros(1, 8, device=cuda_device),
                              2)
    assert tattn.fused_attention.launches - counts[0] == 2


def test_k1_fp32_runs_the_tensor_core_body(cuda_device):
    """K1 in fp32 is one launch of the blockwise library's 3xTF32 body at
    `K1_FP32_TILES`, counted on K1 and never on K2, bit-equal to K2 asked
    for the same tiling and within 2e-5 of the plain version; it raises on a
    view four bytes past a 16-byte boundary (cp.async needs 16) before any
    launch. TF32 matmuls stay off for the plain version; the kernel never
    reads that switch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = (tattn.fused_attention.launches,
              tattn.fused_attention_blockwise.launches)
    for kind in ("B11Sk", "full"):
        q, k, v, bias = _attn_case(cuda_device, torch.float32, 3, 150, 150,
                                   16, 64, kind)
        got = tattn.fused_attention(q, k, v, bias, 16)
        torch.cuda.synchronize()
        _assert_attn_close(got, tattn.attention_reference(q, k, v, bias, 16))
        assert torch.equal(got, tattn.fused_attention_blockwise(
            q, k, v, bias, 16, *tattn.K1_FP32_TILES))
    assert (tattn.fused_attention.launches - counts[0],
            tattn.fused_attention_blockwise.launches - counts[1]) == (2, 2)
    flat = torch.zeros(8 * 128 + 1, device=cuda_device)
    q = flat[1:].view(1, 8, 128)
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        tattn.fused_attention(q, q, q, torch.zeros(1, 8, device=cuda_device),
                              2)
    assert tattn.fused_attention.launches - counts[0] == 2


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
    K = 432 (no multiple of the 64-byte chunk): the int8 tensor-core main
    loop zero-fills the ragged edges."""
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
