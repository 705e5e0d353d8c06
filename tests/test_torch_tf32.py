"""3xTF32, the arithmetic of the port's fp32 attention body, on the CPU.

In fp32 both attention kernels (K1 `fused_attention` and K2
`fused_attention_blockwise`, up to head width 128) run their two products
on the TF32 tensor cores of the card: each operand x is split into
hi = tf32(x) and lo = tf32(x - hi) (`cvt.rna.tf32.f32`: to nearest, ties
away from zero, 10 stored mantissa bits), and each product sums lo*hi,
hi*lo and hi*hi into one fp32 accumulator; lo*lo is dropped. Both products
are split (Q and K for the scores, p and V for the output); nothing else
departs from `attention_blockwise_reference`.

Here that arithmetic is emulated in PyTorch: the rounding on the int32
view, the split, and each product as three fp32 matmuls of the rounded
parts (a product of two TF32 values is exact in fp32) in the kernel's
order. The emulation is held to both plain versions within the fp32
contract, 2e-5 (the TPU kernel's own test bound), on inputs made from a
numpy seed, and its error against a float64 attention is held below that
of a single TF32 product on the same inputs, which does not keep the
contract. The card holds the kernel itself to the same bound
(`tests/test_torch_on_card.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

from icka_tpu_torch.kernels.attention import (
    K1_FP32_TILES, _blockwise_bias, attention_blockwise_reference,
    attention_reference, blockwise_tiles)

FP32_TOL = 2e-5
B, N = 2, 2


def tf32_rna(x):
    """x rounded to TF32 as `cvt.rna.tf32.f32` rounds it: half of the lowest
    kept bit (0x1000) added to the int32 view, which carries into the kept
    bits away from zero, then the 13 dropped bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def matmul_3xtf32(a, b):
    """a @ b as the kernel takes it: lo*hi, then hi*lo, then hi*hi."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def matmul_tf32(a, b):
    """a @ b as one TF32 product: both operands rounded once."""
    return tf32_rna(a) @ tf32_rna(b)


def emulated_attention(q, k, v, bias, num_heads, block_q, block_k, matmul):
    """`attention_blockwise_reference`'s recurrence, tile by tile at the
    tiling `blockwise_tiles` gives, with both products taken by `matmul`
    (fp32 inputs: p is not rounded)."""
    Bq, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // num_heads
    bq, bk = blockwise_tiles(Sq, Sk, hd, q.dtype, block_q, block_k)
    key_mode, b = _blockwise_bias(bias, Bq, Sq, Sk)
    b = b[:, None, None, :] if key_mode else b[:, None]
    qh = q.reshape(Bq, Sq, num_heads, hd).permute(0, 2, 1, 3)
    kh = k.reshape(Bq, Sk, num_heads, hd).permute(0, 2, 3, 1)
    vh = v.reshape(Bq, Sk, num_heads, hd).permute(0, 2, 1, 3)
    out = torch.empty(Bq, num_heads, Sq, hd)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        m = torch.full((Bq, num_heads, q1 - q0, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(Bq, num_heads, q1 - q0, hd)
        for k0 in range(0, Sk, bk):
            k1 = min(k0 + bk, Sk)
            s = matmul(qh[:, :, q0:q1], kh[..., k0:k1]) * hd ** -0.5
            s = s + (b[..., k0:k1] if key_mode else b[:, :, q0:q1, k0:k1])
            m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + matmul(p, vh[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / l
    return out.permute(0, 2, 1, 3).reshape(Bq, Sq, D)


def exact_attention(q, k, v, bias, num_heads):
    """The same function in float64, the yardstick of both errors."""
    Bq, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // num_heads
    qh, kh, vh = (t.double().reshape(Bq, -1, num_heads, hd)
                  for t in (q, k, v))
    _, b = _blockwise_bias(bias, Bq, Sq, Sk)
    b = b.double().expand(Bq, Sq, Sk) if b.ndim == 3 else (
        b.double()[:, None, :].expand(Bq, Sq, Sk))
    s = torch.einsum("bqnh,bknh->bnqk", qh, kh) * hd ** -0.5 + b[:, None]
    out = torch.einsum("bnqk,bknh->bqnh", torch.softmax(s, dim=-1), vh)
    return out.reshape(Bq, Sq, D)


# (head width, Sq, Sk, bias, tiling asked): the serving shapes at K1's fp32
# tiling (a key mask at 150, the packed server's block-diagonal mask at
# 172), the narrowest and widest instance, and a long key sequence
CASES = [(64, 150, 150, "key", K1_FP32_TILES),
         (64, 172, 172, "block_diagonal", K1_FP32_TILES),
         (16, 150, 150, "key", (128, 128)),
         (128, 150, 150, "key", (128, 128)),
         (64, 64, 1024, "key", (128, 128))]


def _case(hd, Sq, Sk, bias_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, s, N * hd))
                                .astype(np.float32)) for s in (Sq, Sk, Sk))
    if bias_kind == "key":
        bias = torch.zeros(B, 1, 1, Sk)
        bias[..., Sk - 5:] = -10000.0
    else:
        slot_q = torch.arange(Sq)[:, None] * 3 // Sq
        slot_k = torch.arange(Sk)[None, :] * 3 // Sk
        bias = ((slot_q != slot_k) * -10000.0).float().expand(B, 1, Sq, Sk)
    return q, k, v, bias


def _id(case):
    hd, Sq, Sk, kind, tiles = case
    return f"hd{hd}-{Sq}x{Sk}-{kind}-{tiles[0]}x{tiles[1]}"


@pytest.mark.parametrize("plain", ["attention_reference",
                                   "attention_blockwise_reference"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_3xtf32_holds_the_fp32_contract(case, plain):
    hd, Sq, Sk, kind, tiles = case
    q, k, v, bias = _case(hd, Sq, Sk, kind)
    got = emulated_attention(q, k, v, bias, N, *tiles, matmul_3xtf32)
    if plain == "attention_reference":
        want = attention_reference(q, k, v, bias, N)
    else:
        want = attention_blockwise_reference(q, k, v, bias, N, *tiles)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= FP32_TOL


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_3xtf32_is_closer_than_one_tf32_product(case):
    """Against float64: 3xTF32 within the contract, closer than one TF32
    product, which breaks it."""
    hd, Sq, Sk, kind, tiles = case
    q, k, v, bias = _case(hd, Sq, Sk, kind, seed=1)
    exact = exact_attention(q, k, v, bias, N)
    err3 = (emulated_attention(q, k, v, bias, N, *tiles, matmul_3xtf32)
            .double() - exact).abs().max().item()
    err1 = (emulated_attention(q, k, v, bias, N, *tiles, matmul_tf32)
            .double() - exact).abs().max().item()
    assert err3 <= FP32_TOL < err1
    assert err3 < err1 / 50


def test_tf32_rounding_is_to_nearest_ties_away():
    """The int32 trick against the definition: 10 stored mantissa bits,
    to nearest, a tie away from zero, the sign kept."""
    one_ulp = 2.0 ** -10                   # TF32's step at 1.0
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 3.0 + 0.7 * one_ulp * 2,
                      1e-3, -7.25e4])
    got = tf32_rna(x)
    assert got[0].item() == 1.0 + one_ulp and got[1].item() == -got[0]
    assert got[2].item() == 1.0
    assert got[3].item() == 3.0 + 2 * one_ulp
    for value, r in zip(x[4:].tolist(), got[4:].tolist()):
        m, e = np.frexp(value)                 # value = m * 2**e, |m| < 1
        assert r == np.round(m * 2.0 ** 11) * 2.0 ** (e - 11)
    hi, lo = split_tf32(x)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
