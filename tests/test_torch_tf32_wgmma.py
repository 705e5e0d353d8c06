"""The fp32 wgmma body of the port's attention kernels (3xTF32 at head width
64), on the CPU.

On the card, K1 (`fused_attention`) and K2 (`fused_attention_blockwise`)
run fp32 heads of 64 on `csrc/attention_wgmma_tf32.cuh`: the online softmax
over key tiles of 64 at the tiling `blockwise_tiles` gives, its scores
prescaled by log2(e) and exponentiated with exp2, the running maximum
starting at -1e30, and both products in 3xTF32 (each operand split as
hi = tf32(x), lo = tf32(x - hi), rounded as `cvt.rna` rounds; lo*hi, hi*lo
and hi*hi summed into one fp32 accumulator), p split for P V but not
rounded, l summing the unsplit p. Here that arithmetic is emulated in
PyTorch tile by tile and held within the fp32 contract, 2e-5, to the port's
plain versions and to the JAX package's Pallas kernels run in interpret
mode, on inputs made from a numpy seed.

The body's shared-memory layouts are checked by index: the query and key
planes as TMA lands them (two column panels of 32, 128-byte swizzled) read
back through the wgmma descriptors' k-steps, and V transposed into V^T with
key 2t at k-position t and key 2t + 1 at t + 4 of each group of 8, which,
paired with P taken from the score accumulator's registers as the A
fragment, gives P V exactly. And the host geometry: which body runs, the
instances' shared memory, the tilings at the main paths' lengths, and the
fp32 tensor maps of every layout `row_stride` accepts. The kernel itself
runs only on a card (`tests/test_torch_on_card.py`).
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
    K1_FP32_TILES, TF32_MAX_BLOCK_K, TF32_WGMMA_STAGES, WGMMA_BLOCK_SIZES,
    _SMEM_LIMIT, _blockwise_bias, _smem_bytes, _snap,
    attention_blockwise_reference, attention_body, attention_reference,
    blockwise_tiles, tensor_map_geometry, tf32_q_buffers)

LOG2E = math.log2(math.e)
FP32_TOL = 2e-5
F32 = torch.float32
TILINGS = [(bq, TF32_MAX_BLOCK_K) for bq in WGMMA_BLOCK_SIZES]


def tf32_rna(x):
    """x rounded to TF32 as the kernel rounds it (`tf32` in
    `csrc/attention_common.cuh`): 0x1000 added to the int32 view, the 13
    low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def emulated_tf32_wgmma(q, k, v, bias, num_heads, block_q, block_k):
    """The fp32 wgmma body's arithmetic: per query tile and key tile of
    `blockwise_tiles`, S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi, scores in
    log2 units, exp2, l of the unsplit p, then O rescaled and p_lo V_hi,
    p_hi V_lo and p_hi V_hi added to it in that order."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // num_heads
    bq, bk = blockwise_tiles(Sq, Sk, hd, q.dtype, block_q, block_k)
    key_mode, b = _blockwise_bias(bias, B, Sq, Sk)
    b = b[:, None, None, :] if key_mode else b[:, None]
    q_hi, q_lo = split(q.reshape(B, Sq, num_heads, hd).permute(0, 2, 1, 3))
    k_hi, k_lo = split(k.reshape(B, Sk, num_heads, hd).permute(0, 2, 3, 1))
    v_hi, v_lo = split(v.reshape(B, Sk, num_heads, hd).permute(0, 2, 1, 3))
    scale_log2 = torch.tensor(hd ** -0.5 * LOG2E, dtype=F32)
    out = torch.empty(B, num_heads, Sq, hd)
    for q0 in range(0, Sq, bq):
        qs = slice(q0, min(q0 + bq, Sq))
        m = torch.full((B, num_heads, qs.stop - q0, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, num_heads, qs.stop - q0, hd)
        for k0 in range(0, Sk, bk):
            ks = slice(k0, min(k0 + bk, Sk))
            bias_t = b[..., ks] if key_mode else b[:, :, qs, ks]
            q_h, q_l, k_h, k_l = (q_hi[:, :, qs], q_lo[:, :, qs],
                                  k_hi[..., ks], k_lo[..., ks])
            s = q_l @ k_h + q_h @ k_l + q_h @ k_h
            s = s * scale_log2 + bias_t * LOG2E
            m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            p_hi, p_lo = split(p)
            acc = acc * alpha
            acc = acc + p_lo @ v_hi[:, :, ks]
            acc = acc + p_hi @ v_lo[:, :, ks]
            acc = acc + p_hi @ v_hi[:, :, ks]
            m = m_new
        out[:, :, qs] = acc * (1.0 / l)
    return out.permute(0, 2, 1, 3).reshape(B, Sq, D)


def _case(B, Sq, Sk, N, bias_kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, s, N * 64))
                                .astype(np.float32)) for s in (Sq, Sk, Sk))
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


def _max_err(got, want):
    got, want = (torch.tensor(np.asarray(x)) for x in (got, want))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    return (got.float() - want.float()).abs().max().item()


# (Sq, Sk, bias): one key; 150 keys, a ragged last tile; fewer queries than
# keys and more; a full (block-diagonal) bias at the packed rows' 172
SHAPES = [(40, 1, "key"), (150, 150, "key"), (23, 150, "key"),
          (150, 23, "full"), (172, 172, "full")]


@pytest.mark.parametrize("tiles", TILINGS, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}-{s[2]}")
def test_emulation_holds_the_fp32_contract_of_the_plain_versions(shape,
                                                                 tiles):
    Sq, Sk, kind = shape
    q, k, v, bias = _case(2, Sq, Sk, 2, kind, seed=Sq + Sk)
    got = emulated_tf32_wgmma(q, k, v, bias, 2, *tiles)
    assert got.dtype == F32 and got.shape == q.shape
    assert _max_err(got, attention_blockwise_reference(
        q, k, v, bias, 2, *tiles)) <= FP32_TOL
    assert _max_err(got, attention_reference(q, k, v, bias, 2)) <= FP32_TOL


def _pallas(q, k, v, bias, N, blocks=None):
    args = [jnp.asarray(t.numpy()) for t in (q, k, v)]
    if blocks is None:
        out = jax_attention(*args, jnp.asarray(bias.numpy()), num_heads=N,
                            interpret=True)
    else:
        out = jax_blockwise(*args, jnp.asarray(bias.numpy()), num_heads=N,
                            block_q=blocks[0], block_k=blocks[1],
                            interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("shape,tiles", [
    ((150, 150, "key"), (128, 64)), ((23, 150, "key"), (64, 64)),
    ((150, 23, "full"), (128, 64)), ((40, 1, "key"), (64, 64)),
    ((172, 172, "full"), K1_FP32_TILES)],
    ids=lambda x: "x".join(map(str, x)))
def test_emulation_holds_the_fp32_contract_of_the_pallas_kernels(shape,
                                                                 tiles):
    """K2's and K1's Pallas kernels in interpret mode, in fp32: the TPU
    kernel tiles by divisors of the sequence, the port masks a ragged last
    tile, so the two agree up to the order of sums."""
    Sq, Sk, kind = shape
    q, k, v, bias = _case(1, Sq, Sk, 2, kind, seed=7 * Sq + Sk)
    got = emulated_tf32_wgmma(q, k, v, bias, 2, *tiles)
    assert _max_err(got, _pallas(q, k, v, bias, 2, tiles)) <= FP32_TOL
    assert _max_err(got, _pallas(q, k, v, bias, 2)) <= FP32_TOL


@pytest.mark.parametrize("tiles", TILINGS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_a_minus_inf_key_tile_stays_finite(tiles):
    """-inf over the first two whole key tiles of every second row: the
    running maximum starts at -1e30, so exp2 gives p = 0 and alpha = 1
    there."""
    q, k, v, _ = _case(2, 40, 256, 2, "key", seed=4)
    bias = torch.zeros(2, 40, 256)
    bias[:, ::2, :128] = float("-inf")
    got = emulated_tf32_wgmma(q, k, v, bias, 2, *tiles)
    assert bool(torch.isfinite(got).all())
    assert _max_err(got, attention_blockwise_reference(
        q, k, v, bias, 2, *tiles)) <= FP32_TOL
    assert _max_err(got, attention_reference(q, k, v, bias, 2)) <= FP32_TOL


# -- the shared-memory layouts, by index --------------------------------------
#
# A plane of `rows` rows of a head is two column panels of rows x 128 bytes
# (32 fp32), 1024-byte aligned; TMA's and wgmma's 128-byte swizzle puts the
# 16-byte chunk c of the row r at chunk c ^ (r % 8), i.e. it flips address
# bits 4-6 by bits 7-9.

def swizzle(addr):
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_plane(x):
    """(rows, 64) fp32 as the kernel's two TMA boxes land it: a flat float
    array of the plane's bytes / 4."""
    rows = x.shape[0]
    r, c = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    addr = (c // 32) * rows * 128 + r * 128 + (c % 32) * 4
    plane = np.full(rows * 64, np.nan, x.dtype)
    plane[swizzle(addr) // 4] = x
    return plane


def wgmma_operand(plane, start, rows=64):
    """The (rows, 8) K-major operand a wgmma descriptor at byte `start`
    reads from a 128-byte swizzled plane: row r, element e at
    start + (r // 8) * 1024 + (r % 8) * 128 + 4 e, swizzled."""
    r, e = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    return plane[swizzle(start + (r // 8) * 1024 + (r % 8) * 128 + 4 * e)
                 // 4]


def transpose_v(vin, vt):
    """`transpose_v` of the kernel on one plane: V as landed (keys x dims)
    into V^T (dims x k-positions, two panels of 32 keys) over `vt`, lane u
    owning dim u % 64 and keys 8 (u // 64) .. + 7, written as two 16-byte
    chunks."""
    for u in range(64 * 8):
        d, j = u % 64, u // 64
        dp, dc, de = d // 32, (d % 32) // 4, d % 4
        x = [vin[(dp * 64 + 8 * j + k) * 32 + (dc ^ k) * 4 + de]
             for k in range(8)]
        row, c = (j // 4) * 64 + d, 2 * (j % 4)
        for odd in range(2):
            at16 = row * 8 + ((c + odd) ^ (d % 8))
            vt[4 * at16:4 * at16 + 4] = x[odd::2]
    return vt


def a_fragments(p, j):
    """The (64, 8) A operand of k-step j that the consumer warpgroup's
    registers hold, taken from the score accumulator p (64 rows x 64 keys)
    as `split_p` takes it: warp w's thread (g, t) puts (row 16 w + g, key
    8 j + 2 t) at (g, t), (row + 8, that key) at (g + 8, t), and keys
    8 j + 2 t + 1 at (g, t + 4) and (g + 8, t + 4)."""
    a = np.zeros((64, 8), p.dtype)
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for rr in (0, 8):
                    row = 16 * w + g + rr
                    a[row, t] = p[row, 8 * j + 2 * t]
                    a[row, t + 4] = p[row, 8 * j + 2 * t + 1]
    return a


@pytest.mark.parametrize("bq", WGMMA_BLOCK_SIZES)
def test_the_descriptors_read_q_and_k_as_landed(bq):
    """S's k-step kk reads columns 8 kk .. 8 kk + 7 of Q's rows (each
    consumer warpgroup its 64) and of K's 64 keys: 32 bytes a step along
    the swizzled rows, the fifth step at the second column panel."""
    rng = np.random.default_rng(bq)
    q = rng.integers(-9, 10, (bq, 64)).astype(np.float64)
    k = rng.integers(-9, 10, (64, 64)).astype(np.float64)
    q_plane, k_plane = tma_plane(q), tma_plane(k)
    for wg in range(bq // 64):
        s = np.zeros((64, 64))
        for kk in range(8):
            a = wgmma_operand(q_plane, wg * 64 * 128 + (kk // 4) * bq * 128
                              + (kk % 4) * 32)
            b = wgmma_operand(k_plane, (kk // 4) * 64 * 128 + (kk % 4) * 32)
            assert np.array_equal(a, q[wg * 64:wg * 64 + 64,
                                       8 * kk:8 * kk + 8])
            assert np.array_equal(b, k[:, 8 * kk:8 * kk + 8])
            s += a @ b.T
        assert np.array_equal(s, q[wg * 64:wg * 64 + 64] @ k.T)


@pytest.mark.parametrize("valid", [64, 22])
def test_the_vt_write_order_gives_p_v_exactly(valid):
    """V^T written with key 2t at k-position t and key 2t + 1 at t + 4 of
    each group of 8, read by P V's descriptors, against P taken from the
    accumulator as it stands: every entry of P V exact, each key's value
    row met by its own probability. With 22 valid keys (S = 150's last
    tile: TMA lands zeros past them), over a plane a previous tile left
    behind: every entry of V^T written, the zeros included, so p = 0
    never meets a stale Inf."""
    rng = np.random.default_rng(valid)
    v = rng.integers(-9, 10, (64, 64)).astype(np.float64)
    v[valid:] = 0.0
    p = rng.integers(0, 7, (64, 64)).astype(np.float64)
    stale = np.full(64 * 64, np.inf)
    vt = transpose_v(tma_plane(v), stale)
    assert np.isfinite(vt).all()
    o = np.zeros((64, 64))
    for kk in range(8):
        b = wgmma_operand(vt, (kk // 4) * 64 * 128 + (kk % 4) * 32)  # (n, k)
        keys = 8 * kk + np.array([0, 2, 4, 6, 1, 3, 5, 7])
        assert np.array_equal(b, v[keys].T)
        o += a_fragments(p, kk) @ b.T
    assert np.array_equal(o, p @ v)


def test_the_transpose_is_free_of_bank_conflicts():
    """Each 8 consecutive lanes of a transform warp (one 16-byte store
    each) write 8 distinct 16-byte bank groups of V^T's planes, and each
    warp's 32 loads of a key row read 32 distinct banks."""
    for base in range(0, 96, 32):           # the transform's three warps
        for it in range(6):
            lanes = [base + lane + 96 * it for lane in range(32)]
            lanes = [u for u in lanes if u < 64 * 8]
            for odd in range(2):
                for q8 in range(0, len(lanes), 8):
                    groups = {((2 * ((u // 64) % 4) + odd) ^ (u % 64 % 8))
                              for u in lanes[q8:q8 + 8]}
                    assert len(groups) == len(lanes[q8:q8 + 8])
            for k in range(8):
                banks = {((((u % 64) % 32) // 4 ^ k) * 4 + u % 4) % 32
                         for u in lanes}
                assert len(banks) == len(lanes)


# -- the host geometry --------------------------------------------------------

def test_attention_body_in_fp32():
    for hd in (49, 56, 64):          # widths that run at the instance 64
        assert attention_body(F32, hd) == "wgmma_tf32"
        assert attention_body(torch.bfloat16, hd) == "wgmma"
    for hd in (16, 32, 48, 80, 112, 128):
        assert attention_body(F32, hd) == "tf32"
    assert attention_body(F32, 144) == "wide"


@pytest.mark.parametrize("bq", WGMMA_BLOCK_SIZES)
def test_each_instance_fits_shared_memory(bq):
    """`tf32_wgmma_smem_bytes` in the source: 1024 bytes to align the
    planes, the query buffers (hi and lo planes), two stages of the K ring
    (K hi, K lo) and of the V ring (V as landed, V^T hi, V^T lo), fp32 rows
    of 64, a full, a ready and an empty barrier for each stage of both
    rings and each query buffer."""
    nq = tf32_q_buffers(bq)
    want = (1024 + nq * 2 * bq * 256 + TF32_WGMMA_STAGES * 5 * 64 * 256
            + (6 * TF32_WGMMA_STAGES + 3 * nq) * 8)
    got = _smem_bytes(bq, 64, 64, F32)
    assert got == want <= _SMEM_LIMIT
    assert (nq, got) == {64: (2, 230544), 128: (1, 230520)}[bq]
    assert blockwise_tiles(1024, 1024, 64, F32, bq, 128) == (bq, 64)


# Sq = Sk on the main paths at head width 64 (see
# tests/test_torch_attention_wgmma.py)
MAIN_PATH_LENGTHS = (16, 24, 32, 48, 64, 90, 100, 103, 128, 150, 154, 172)


@pytest.mark.parametrize("S", MAIN_PATH_LENGTHS)
def test_k1_and_k2_tilings_at_the_main_path_lengths(S):
    """K1 asks `K1_FP32_TILES`; K2 keeps its contract, (128, 128) asked;
    each query tile snapped to what the sequence needs, never below a
    warpgroup's 64 rows, and keys in the body's one tile of 64."""
    assert K1_FP32_TILES[1] == TF32_MAX_BLOCK_K == 64
    k1 = (max(_snap(K1_FP32_TILES[0], S), 64), 64)
    assert blockwise_tiles(S, S, 64, F32, *K1_FP32_TILES) == k1
    assert blockwise_tiles(S, S, 64, F32) == (max(_snap(128, S), 64), 64)
    assert blockwise_tiles(S, 103, 64, F32, 32, 32) == (64, 64)
    for tiles in (blockwise_tiles(S, S, 64, F32, *K1_FP32_TILES),
                  blockwise_tiles(S, S, 64, F32)):
        assert _smem_bytes(*tiles, 64, F32) <= _SMEM_LIMIT


def _layouts():
    """(B, S, D) fp32 tensors of every layout `row_stride` accepts, with
    their heads: contiguous, the q/k/v views of one fused (B, S, 3D)
    projection, a tensor-parallel rank's columns of a gathered (8, 150,
    3 x 1024) projection, one row, one batch element, rows padded to a
    wider stride."""
    out = []
    for B, S, N in ((3, 150, 16), (2, 37, 12), (4, 1, 2), (1, 23, 8)):
        D = N * 64
        out.append((torch.zeros(B, S, D), N))
        fused = torch.zeros(B, S, 3 * D)
        out += [(t, N) for t in fused.split(D, dim=-1)]
        out.append((torch.zeros(B, S, D + 8)[..., :D], N))
    H, n = 1024, 512
    qkv = torch.zeros(8, 150, 3 * H)
    out += [(qkv[..., j * H + n:j * H + 2 * n], 8) for j in range(3)]
    return out


def test_fp32_tensor_maps_of_every_accepted_layout():
    for x, N in _layouts():
        for rows in WGMMA_BLOCK_SIZES:
            dims, strides, box = tensor_map_geometry(x, N, rows)
            assert dims == (N * 64, x.shape[1], x.shape[0])
            assert all(s % 16 == 0 for s in strides)
            assert strides[0] >= dims[0] * 4
            assert strides[1] == dims[1] * strides[0]
            assert box == (32, rows, 1) and box[1] <= 256
            assert box[0] * x.element_size() == 128   # one swizzle span
            assert x.data_ptr() % 16 == 0
    misaligned = torch.zeros(2, 8, 3 * 128 + 4)[..., :128]
    with pytest.raises(ValueError, match="multiple of 8"):
        tensor_map_geometry(misaligned, 2, 64)
