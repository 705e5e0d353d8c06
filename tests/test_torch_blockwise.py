"""K2, the blockwise attention kernel of the PyTorch/CUDA port.

On the CPU the port's plain version (`attention_blockwise_reference`, the
online-softmax recurrence tile by tile) is held against the JAX package's
Pallas kernel run in interpret mode, on the same numpy inputs. The two tile
differently (the TPU kernel snaps blocks to divisors of the sequence, the
port masks a ragged last tile), so they agree up to summation order: fp32
within 2e-5, the TPU kernel's own test bound; bf16 within 6e-2 (outputs and
probabilities rounded to bf16). The CUDA kernel itself runs only on a card
(`tests/test_torch_on_card.py`).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.kernels.attention import (  # noqa: E402
    fused_attention_blockwise as jax_blockwise)
from icka_tpu_torch.kernels.attention import (  # noqa: E402
    BLOCK_SIZES, K1_FP32_TILES, _blockwise_bias, _smem_bytes,
    attention_blockwise_reference, attention_reference, blockwise_tiles,
    fused_attention_blockwise)

TOL = {"float32": 2e-5, "bfloat16": 6e-2}


def _qkv(rng, B, Sq, Sk, D):
    return (rng.standard_normal((B, s, D)).astype(np.float32)
            for s in (Sq, Sk, Sk))


def _both(q, k, v, bias, N, blocks, dtype="float32"):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_blockwise(jnp.asarray(q, jd), jnp.asarray(k, jd),
                         jnp.asarray(v, jd), jnp.asarray(bias), num_heads=N,
                         block_q=blocks[0], block_k=blocks[1], interpret=True)
    got = attention_blockwise_reference(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        torch.from_numpy(bias), N, *blocks)
    assert got.dtype == td and tuple(got.shape) == q.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("shape,blocks", [
    ((2, 128, 64, 8), (32, 32)),     # several tiles in both dimensions
    ((2, 64, 64, 4), (64, 64)),      # a single tile
    ((1, 48, 256, 4), (16, 128)),    # long keys; block_q below the smallest
    ((2, 24, 24, 4), (128, 128)),    # tiles larger than the sequence
])
def test_plain_version_matches_pallas_kernel(shape, blocks):
    """The shapes and tilings of the JAX package's own test, head width 16,
    a (B,1,1,Sk) key mask."""
    B, Sq, Sk, N = shape
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, B, Sq, Sk, N * 16)
    keep = np.ones((B, Sk), np.float32)
    keep[:, Sk - 7:] = 0
    bias = ((1.0 - keep) * -10000.0)[:, None, None, :]
    got, want = _both(q, k, v, bias, N, blocks)
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("four_d", [False, True])
def test_full_bias_matches_pallas_kernel(dtype, four_d):
    """A block-diagonal (packed-style) full bias, head width 32, as
    (B, Sq, Sk) and as the (B, 1, Sq, Sk) the model passes."""
    B, S, N = 2, 64, 4
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, B, S, S, N * 32)
    slot = np.arange(S) // 32
    full = (slot[:, None] == slot[None, :]).astype(np.float32)
    bias = ((1.0 - full) * -10000.0)[None].repeat(B, 0)
    got, want = _both(q, k, v, bias[:, None] if four_d else bias, N,
                      (32, 32), dtype)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("shape", [(23, 150), (150, 23), (172, 172)])
def test_ragged_tiles_match_one_shot_softmax(shape):
    """No block size divides these lengths: the last tile of either
    dimension is masked. Held against the one-shot softmax."""
    Sq, Sk = shape
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, Sq, Sk, 2 * 16))
    bias = torch.from_numpy(rng.standard_normal((2, Sq, Sk))
                            .astype(np.float32))
    got = attention_blockwise_reference(q, k, v, bias, 2, 32, 64)
    want = attention_reference(q, k, v, bias, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL["float32"],
                               rtol=0)


def test_two_tilings_agree():
    """block_q / block_k change the order of summation and nothing else."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 250, 300, 4 * 16))
    bias = torch.zeros(2, 300)
    bias[:, -9:] = -10000.0
    assert blockwise_tiles(250, 300, 16, q.dtype, 32, 32) == (32, 32)
    assert blockwise_tiles(250, 300, 16, q.dtype, 128, 128) == (128, 64)
    a = attention_blockwise_reference(q, k, v, bias, 4, 32, 32)
    b = attention_blockwise_reference(q, k, v, bias, 4, 128, 128)
    assert not torch.equal(a, b)               # they do tile differently
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL["float32"],
                               rtol=0)


def test_minus_inf_over_a_whole_key_tile_stays_finite():
    """A -inf bias over the first whole key tile of some rows: the running
    maximum starts at -1e30, so p = 0 and alpha = 1 there, not NaN. Equal to
    the Pallas kernel (whose key tile is 128 wide here) within 2e-5."""
    B, Sq, Sk, N = 2, 32, 256, 2
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, B, Sq, Sk, N * 16)
    bias = np.zeros((B, Sq, Sk), np.float32)
    bias[:, ::2, :128] = -np.inf
    got, want = _both(q, k, v, bias, N, (32, 128))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=0)
    small, _ = _both(q, k, v, bias, N, (32, 32))    # four -inf tiles
    np.testing.assert_allclose(small, want, atol=TOL["float32"], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [144, 256, 272, 512])
def test_plain_version_matches_pallas_kernel_at_wide_heads(hd, dtype):
    """Widths above 128 tile as the wide CUDA-core body does (keys by 32,
    rows by at most 64; above 256 in column chunks), ragged in both
    dimensions, against the Pallas kernel in interpret mode; a key mask."""
    B, Sq, Sk, N = 1, 40, 70, 2
    rng = np.random.default_rng(hd)
    q, k, v = _qkv(rng, B, Sq, Sk, N * hd)
    bias = np.zeros((B, 1, 1, Sk), np.float32)
    bias[..., -6:] = -10000.0
    assert blockwise_tiles(Sq, Sk, hd, getattr(torch, dtype)) == (64, 32)
    got, want = _both(q, k, v, bias, N, (128, 128), dtype)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


def test_tiles_snap_and_fit_shared_memory():
    f32, bf16 = torch.float32, torch.bfloat16
    assert blockwise_tiles(1024, 1024, 64, bf16) == (128, 128)
    assert blockwise_tiles(150, 150, 64, bf16, 100, 70) == (64, 64)
    assert blockwise_tiles(23, 23, 48, f32) == (32, 32)
    # fp32 at width 64 (the wgmma body): a warpgroup's 64 rows, 64 keys
    assert blockwise_tiles(23, 23, 64, f32) == (64, 64)
    assert blockwise_tiles(48, 256, 16, bf16, 16, 128) == (32, 128)
    # fp32 up to width 128: at most 64 keys a tile (the 3xTF32 body)
    assert blockwise_tiles(48, 256, 16, f32, 16, 128) == (32, 64)
    # a ragged last tile is masked, not avoided: 150 rows take two of 128
    assert blockwise_tiles(150, 150, 64, bf16) == (128, 128)
    assert blockwise_tiles(64, 65, 64, bf16) == (64, 128)
    # the 3xTF32 body stages Q as hi and lo planes and K/V in fp32, rows
    # padded by 16 bytes: at width 128, (128, 64) needs 270,848 bytes, so
    # keys are halved once more; at 64 the wgmma body's (128, 64) fits
    assert _smem_bytes(128, 64, 128, f32) == 2 * 128 * 528 + 2 * (
        2 * 64 * 528 + 256)
    assert blockwise_tiles(1024, 1024, 128, f32) == (128, 32)
    assert blockwise_tiles(1024, 1024, 64, f32) == (128, 64)
    assert _smem_bytes(128, 64, 64, f32) <= 232448
    # K1's fp32 tiling at the serving shape, as asked
    assert blockwise_tiles(150, 150, 64, f32, *K1_FP32_TILES) == K1_FP32_TILES
    # above 128 both types take the wide CUDA-core body's one tiling, at
    # any width: above 256 shared memory holds one column chunk (<= 256)
    for dt in (f32, bf16):
        assert blockwise_tiles(1024, 1024, 256, dt) == (64, 32)
        assert blockwise_tiles(1024, 1024, 144, dt, 32, 128) == (32, 32)
        assert _smem_bytes(64, 32, 256, dt) <= 232448
        for hd in (272, 512, 4096):
            assert blockwise_tiles(1024, 1024, hd, dt) == (64, 32)
            assert _smem_bytes(64, 32, hd, dt) <= _smem_bytes(64, 32, 256,
                                                              dt)


@pytest.mark.parametrize("hd", [8, 40, 64, 128])
def test_every_bf16_tiling_fits_at_every_head_width(hd):
    """The tensor-core bodies stage bf16 rows (query tile, stages of K and
    V) and keep the scores in registers: every (block_q, block_k) they are
    asked for fits shared memory as asked, at every width up to 128
    (padded widths at the instance's width). At 64 the wgmma body takes at
    least a warpgroup's 64 rows and 64 keys a tile."""
    low = 64 if hd == 64 else 0
    for bq in BLOCK_SIZES:
        for bk in BLOCK_SIZES:
            assert blockwise_tiles(1024, 1024, hd, torch.bfloat16,
                                   bq, bk) == (max(bq, low), max(bk, low))
    assert _smem_bytes(128, 128, 128, torch.bfloat16) <= 232448


def test_key_bias_stays_unbroadcast():
    """A key-only bias is kept (B, Sk); a (B,1,Sq,Sk) bias is a view."""
    key = torch.zeros(3, 1, 1, 40)
    mode, b = _blockwise_bias(key, 3, 7, 40)
    assert mode and tuple(b.shape) == (3, 40)
    assert b.data_ptr() == key.data_ptr()
    mode, b = _blockwise_bias(torch.zeros(1, 40), 3, 7, 40)
    assert mode and b.stride() == (0, 1)
    full = torch.zeros(3, 1, 7, 40)
    mode, b = _blockwise_bias(full, 3, 7, 40)
    assert not mode and tuple(b.shape) == (3, 7, 40)
    assert b.data_ptr() == full.data_ptr()


def test_wrapper_takes_plain_version_on_cpu_and_checks_shapes():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 12, 23, 4 * 16))
    bias = torch.zeros(2, 23)
    before = fused_attention_blockwise.launches
    got = fused_attention_blockwise(q, k, v, bias, 4, 32, 32)
    assert fused_attention_blockwise.launches == before
    assert torch.equal(got, attention_blockwise_reference(q, k, v, bias, 4,
                                                          32, 32))
    with pytest.raises(ValueError):
        fused_attention_blockwise(q, k[:, :-1], v, bias, 4)
    with pytest.raises(ValueError):
        fused_attention_blockwise(q, k, v, bias, 5)
