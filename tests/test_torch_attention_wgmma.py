"""The wgmma body of the port's attention kernels (bf16 at head width 64),
on the CPU.

On the card, K1 (`fused_attention`) and K2 (`fused_attention_blockwise`)
run bf16 heads of 64 on `csrc/attention_wgmma.cuh`: the online softmax over
key tiles at the tiling `blockwise_tiles` gives, its scores prescaled by
log2(e) (each score fma(acc, scale log2 e, bias log2 e)) and exponentiated
with exp2, the running maximum starting at -1e30, p rounded to bf16 before
P.V while l sums the unrounded p. Here that arithmetic is emulated in
PyTorch tile by tile (bf16 products summed in fp32) and held, within the
bf16 bound the card holds the kernel to (every element within 6 bf16 steps
of its own size, no finer than at the rms of all values; the rms of the
difference within 1e-2 of the values' rms), to the port's plain version
and to the JAX package's Pallas kernels run in interpret mode, on inputs
made from a numpy seed. The host geometry is checked too: which body runs,
the tilings and their shared memory, and the tensor maps of every layout
`row_stride` accepts. The kernel itself runs only on a card
(`tests/test_torch_on_card.py`).
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.kernels.attention import (  # noqa: E402
    fused_attention as jax_attention,
    fused_attention_blockwise as jax_blockwise)
from icka_tpu_torch.kernels.attention import (  # noqa: E402
    K1_WGMMA_TILES, WGMMA_BLOCK_SIZES, _SMEM_LIMIT, _blockwise_bias,
    _smem_bytes, _snap, attention_blockwise_reference, attention_body,
    attention_reference, blockwise_tiles, tensor_map_geometry, wgmma_stages)

LOG2E = math.log2(math.e)
BF16 = torch.bfloat16
TILINGS = [(bq, bk) for bq in WGMMA_BLOCK_SIZES for bk in WGMMA_BLOCK_SIZES]


def emulated_wgmma(q, k, v, bias, num_heads, block_q, block_k):
    """The wgmma body's arithmetic on bf16 q, k, v: per query tile and key
    tile of `blockwise_tiles`, S in fp32 from bf16 products, scores in log2
    units, exp2, p rounded to bf16 for P V, l of the unrounded p."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // num_heads
    bq, bk = blockwise_tiles(Sq, Sk, hd, q.dtype, block_q, block_k)
    key_mode, b = _blockwise_bias(bias, B, Sq, Sk)
    b = b[:, None, None, :] if key_mode else b[:, None]
    qh = q.reshape(B, Sq, num_heads, hd).permute(0, 2, 1, 3).float()
    kh = k.reshape(B, Sk, num_heads, hd).permute(0, 2, 3, 1).float()
    vh = v.reshape(B, Sk, num_heads, hd).permute(0, 2, 1, 3).float()
    scale_log2 = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    out = torch.empty(B, num_heads, Sq, hd)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        m = torch.full((B, num_heads, q1 - q0, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, num_heads, q1 - q0, hd)
        for k0 in range(0, Sk, bk):
            k1 = min(k0 + bk, Sk)
            bias_t = b[..., k0:k1] if key_mode else b[:, :, q0:q1, k0:k1]
            s = torch.matmul(qh[:, :, q0:q1], kh[..., k0:k1]) * scale_log2 \
                + bias_t * LOG2E
            m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(BF16).float(),
                                             vh[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc * (1.0 / l)
    return out.permute(0, 2, 1, 3).reshape(B, Sq, D).to(BF16)


def assert_bf16_close(got, want):
    """chip_smoke's `attention_close` in bf16, as the card holds the
    kernel."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    size = want.abs()
    rms = size.square().mean().sqrt()
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(size, rms))) - 7)
    assert (diff / step).max().item() <= 6
    assert diff.square().mean().sqrt().item() <= 1e-2 * rms.item()


def _case(B, Sq, Sk, N, bias_kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, s, N * 64))
                                .astype(np.float32)).to(BF16)
               for s in (Sq, Sk, Sk))
    if bias_kind == "key":
        bias = np.zeros((B, 1, 1, Sk), np.float32)
        bias[..., Sk - min(3, Sk - 1):] = -10000.0
    else:                  # block-diagonal, as the packed server's masks
        slot_q = np.arange(Sq)[:, None] * 3 // Sq
        slot_k = np.arange(Sk)[None, :] * 3 // Sk
        bias = np.broadcast_to(((slot_q != slot_k) * -10000.0)
                               .astype(np.float32), (B, 1, Sq, Sk)).copy()
        bias += rng.standard_normal(bias.shape).astype(np.float32)
    return q, k, v, torch.from_numpy(bias)


def _pallas(q, k, v, bias, N, blocks=None):
    args = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    if blocks is None:
        out = jax_attention(*args, jnp.asarray(bias.numpy()), num_heads=N,
                            interpret=True)
    else:
        out = jax_blockwise(*args, jnp.asarray(bias.numpy()), num_heads=N,
                            block_q=blocks[0], block_k=blocks[1],
                            interpret=True)
    return np.asarray(out, np.float32)


# (Sq, Sk, bias): one key; 150 keys, a ragged last tile at block_k 128;
# fewer queries than keys and more; a full (block-diagonal) bias
SHAPES = [(40, 1, "key"), (150, 150, "key"), (23, 150, "key"),
          (150, 23, "full"), (172, 172, "full")]


@pytest.mark.parametrize("tiles", TILINGS, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}-{s[2]}")
def test_emulation_holds_the_bf16_bound_of_the_plain_version(shape, tiles):
    Sq, Sk, kind = shape
    q, k, v, bias = _case(2, Sq, Sk, 2, kind, seed=Sq + Sk)
    got = emulated_wgmma(q, k, v, bias, 2, *tiles)
    assert got.dtype == BF16 and got.shape == q.shape
    assert_bf16_close(got, attention_blockwise_reference(q, k, v, bias, 2,
                                                         *tiles))
    assert_bf16_close(got, attention_reference(q, k, v, bias, 2))


@pytest.mark.parametrize("shape,tiles", [
    ((150, 150, "key"), (64, 128)), ((23, 150, "key"), (128, 128)),
    ((150, 23, "full"), (128, 64)), ((40, 1, "key"), (64, 64)),
    ((172, 172, "full"), K1_WGMMA_TILES)],
    ids=lambda x: "x".join(map(str, x)))
def test_emulation_holds_the_bf16_bound_of_the_pallas_kernels(shape, tiles):
    """K2's and K1's Pallas kernels in interpret mode, in bf16: the TPU
    kernel tiles by divisors of the sequence, the port masks a ragged last
    tile, so the two agree up to the order of sums and roundings."""
    Sq, Sk, kind = shape
    q, k, v, bias = _case(1, Sq, Sk, 2, kind, seed=7 * Sq + Sk)
    got = emulated_wgmma(q, k, v, bias, 2, *tiles)
    assert_bf16_close(got, _pallas(q, k, v, bias, 2, tiles))
    assert_bf16_close(got, _pallas(q, k, v, bias, 2))


@pytest.mark.parametrize("tiles", TILINGS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_a_minus_inf_key_tile_stays_finite(tiles):
    """-inf over the first whole key tile of every second row: the running
    maximum starts at -1e30, so exp2 gives p = 0 and alpha = 1 there."""
    q, k, v, _ = _case(2, 40, 256, 2, "key", seed=4)
    bias = torch.zeros(2, 40, 256)
    bias[:, ::2, :128] = float("-inf")
    got = emulated_wgmma(q, k, v, bias, 2, *tiles)
    assert bool(torch.isfinite(got).all())
    assert_bf16_close(got, attention_blockwise_reference(q, k, v, bias, 2,
                                                         *tiles))
    assert_bf16_close(got, attention_reference(q, k, v, bias, 2))


# -- the host geometry --------------------------------------------------------

def test_attention_body_by_type_and_width():
    for hd in (49, 56, 64):          # widths that run at the instance 64
        assert attention_body(BF16, hd) == "wgmma"
        assert attention_body(torch.float32, hd) == "wgmma_tf32"
    for hd in (16, 32, 48, 80, 112, 128):
        assert attention_body(BF16, hd) == "mma"
        assert attention_body(torch.float32, hd) == "tf32"
    for hd in (144, 256, 272):
        assert attention_body(BF16, hd) == "wide"
        assert attention_body(torch.float32, hd) == "wide"


@pytest.mark.parametrize("tiles", TILINGS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_each_tiling_fits_shared_memory(tiles):
    """The sum `wgmma_smem_bytes` takes in the source: 1024 bytes to align
    the tiles, two query tiles and the K/V stages of 128-byte rows, a full
    and an empty barrier a stage and a query tile. At block_q 64 two blocks
    share an SM (228 KB, 1 KB of it reserved a block)."""
    bq, bk = tiles
    stages = wgmma_stages(bq, bk)
    want = 1024 + (2 * bq + 2 * stages * bk) * 128 + (2 * stages + 4) * 8
    got = _smem_bytes(bq, bk, 64, BF16)
    assert got == want <= _SMEM_LIMIT
    if bq == 64:
        assert 2 * (got + 1024) <= 228 * 1024
    assert blockwise_tiles(1024, 1024, 64, BF16, bq, bk) == tiles


# Sq = Sk on the main paths at head width 64: the chunker's buckets, the
# gate_cl family's buckets and packed tiers, the captioner's 90, the VCR
# plane's 100, 103 and 150, the flagship's buckets, prompted lengths and
# packed rows (154, 172)
MAIN_PATH_LENGTHS = (16, 24, 32, 48, 64, 90, 100, 103, 128, 150, 154, 172)


@pytest.mark.parametrize("S", MAIN_PATH_LENGTHS)
def test_k1_and_k2_tilings_at_the_main_path_lengths(S):
    """K1 asks `K1_WGMMA_TILES`; K2 keeps its contract, (128, 128) asked,
    each snapped to what the sequence needs, never below a warpgroup's 64
    rows or one 64-key tile."""
    assert blockwise_tiles(S, S, 64, BF16, *K1_WGMMA_TILES) == (64, 64)
    snapped = max(_snap(128, S), 64)
    assert blockwise_tiles(S, S, 64, BF16) == (snapped, snapped)
    assert blockwise_tiles(S, 103, 64, BF16) == (snapped, 128)
    assert blockwise_tiles(S, S, 64, BF16, 32, 32) == (64, 64)


def _layouts():
    """(B, S, D) bf16 tensors of every layout `row_stride` accepts, with
    their heads: contiguous, the q/k/v views of one fused (B, S, 3D)
    projection, one row, one batch element, rows padded to a wider
    stride."""
    out = []
    for B, S, N in ((3, 150, 16), (2, 37, 12), (4, 1, 2), (1, 23, 8)):
        D = N * 64
        out.append((torch.zeros(B, S, D, dtype=BF16), N))
        fused = torch.zeros(B, S, 3 * D, dtype=BF16)
        out += [(t, N) for t in fused.split(D, dim=-1)]
        out.append((torch.zeros(B, S, D + 8, dtype=BF16)[..., :D], N))
    return out


def test_tensor_maps_of_every_accepted_layout():
    for x, N in _layouts():
        for rows in WGMMA_BLOCK_SIZES:
            dims, strides, box = tensor_map_geometry(x, N, rows)
            assert dims == (N * 64, x.shape[1], x.shape[0])
            assert all(s % 16 == 0 for s in strides)
            assert strides[0] >= dims[0] * 2
            assert strides[1] == dims[1] * strides[0]
            assert box == (64, rows, 1) and box[1] <= 256
            assert box[0] * x.element_size() == 128   # one swizzle span
    misaligned = torch.zeros(2, 8, 3 * 128 + 2, dtype=BF16)[..., :128]
    with pytest.raises(ValueError, match="multiple of 8"):
        tensor_map_geometry(misaligned, 2, 64)
