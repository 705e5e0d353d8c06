"""K1, the fused attention kernel of the PyTorch/CUDA port.

On the CPU the port's plain version (`attention_reference`) is held against
the JAX package's Pallas kernel run in interpret mode, on the same numpy
inputs. The CUDA kernel itself runs only on a card: those tests carry the
`cuda` marker and skip here.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.kernels.attention import fused_attention as jax_fused_attention  # noqa: E402
from icka_tpu_torch.kernels import attention as kattn  # noqa: E402
from icka_tpu_torch.kernels.attention import (  # noqa: E402
    HEAD_DIMS, _check_kernel_inputs, _normalize_bias, attention_reference,
    column_chunk, crop_heads, fused_attention, kernel_width, pad_heads)

# fp32: summation order only (the TPU kernel's own test bound,
# tests/test_kernels.py); bf16: outputs and probabilities rounded to bf16
TOL = {"float32": 2e-5, "bfloat16": 6e-2}
B, SQ, SK, N, HD = 2, 12, 23, 4, 16      # Sk not a multiple of 16


def _inputs(bias_kind, seed=0, sq=SQ, sk=SK):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, N * HD)).astype(np.float32)
    k = rng.standard_normal((B, sk, N * HD)).astype(np.float32)
    v = rng.standard_normal((B, sk, N * HD)).astype(np.float32)
    keep = np.ones((B, sk), np.float32)
    keep[:, sk - 5:] = 0
    key_bias = (1.0 - keep) * -10000.0
    if bias_kind == "B11Sk":
        bias = key_bias[:, None, None, :]
    elif bias_kind == "BSk":
        bias = key_bias
    else:
        bias = (rng.standard_normal((B, sq, sk)).astype(np.float32)
                + key_bias[:, None, :])
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["B11Sk", "BSk", "BSqSk"])
def test_plain_version_matches_pallas_kernel(bias_kind, dtype):
    q, k, v, bias = _inputs(bias_kind)
    jd = jnp.dtype(dtype)
    want = jax_fused_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                               jnp.asarray(v, jd), jnp.asarray(bias),
                               num_heads=N, interpret=True)
    td = getattr(torch, dtype)
    got = attention_reference(torch.from_numpy(q).to(td),
                              torch.from_numpy(k).to(td),
                              torch.from_numpy(v).to(td),
                              torch.from_numpy(bias), N)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 144, 256])
def test_plain_version_matches_pallas_kernel_at_head_width(hd, dtype):
    """The head widths of the JAX package's own kernel tests, and two wide
    ones the card runs on the wide CUDA-core body; full bias."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.standard_normal((B, s, N * hd)).astype(np.float32)
               for s in (SQ, SK, SK))
    bias = rng.standard_normal((B, SQ, SK)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_fused_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                               jnp.asarray(v, jd), jnp.asarray(bias),
                               num_heads=N, interpret=True)
    got = attention_reference(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                              torch.from_numpy(bias), N)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("hd", [8, 24, 40, 130, 144, 256, 272])
def test_kernel_refuses_other_head_widths(hd):
    """No head width is refused: the kernels have an instance for every
    multiple of 16 up to 128 and for 160, 192, 224 and 256, and above 256
    run the wide body in column chunks of at most 256 at every multiple of
    32. A width in between runs on the next instance width, zero-padded.
    Checked on CPU tensors through the wrapper's own gate, which CUDA
    tensors pass through before the launch."""
    assert HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128,
                         160, 192, 224, 256)
    q = torch.zeros(1, 4, 2 * hd)
    _check_kernel_inputs("fused_attention", q, q, q, 2)
    width = kernel_width(hd)
    assert 0 <= width - hd < (16 if hd <= 128 else 32)
    if width <= 256:
        assert width in HEAD_DIMS
    else:
        assert width % 32 == 0
    if width > 128:       # the wide body's chunks: instance widths, <= 256
        chunk = column_chunk(width)
        assert chunk in HEAD_DIMS[8:] and -(-width // chunk) * 256 >= width
    with pytest.raises(ValueError, match="head_dim=0"):
        _check_kernel_inputs("fused_attention", torch.zeros(1, 4, 0),
                             torch.zeros(1, 4, 0), torch.zeros(1, 4, 0), 2)


@pytest.mark.parametrize("plain", ["attention_reference",
                                   "attention_blockwise_reference"])
@pytest.mark.parametrize("hd", [8, 24, 40])
def test_zero_padded_heads_are_the_same_function(hd, plain):
    """What the wrappers do for a width without an instance: each head of
    q, k and v zero-padded to the next multiple of 16, the unpadded width's
    scale, the padded output columns dropped. Zero columns add exact zeros to
    every product, so the plain version on the padded tensors equals the
    plain version on the unpadded ones. The plain version scales by the
    padded width, so q is scaled by (width / hd) ** 0.5 to give it hd's."""
    fn = getattr(kattn, plain)
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, s, N * hd))
                                .astype(np.float32)) for s in (SQ, SK, SK))
    bias = torch.from_numpy(rng.standard_normal((B, SQ, SK))
                            .astype(np.float32))
    width = kernel_width(hd)
    padded = [pad_heads(t, N, width) for t in (q, k, v)]
    assert padded[0].shape == (B, SQ, N * width)
    assert torch.equal(crop_heads(padded[1], N, hd), k)
    assert not padded[2].view(B, SK, N, width)[..., hd:].any()
    padded[0] = padded[0] * (width / hd) ** 0.5
    got = crop_heads(fn(*padded, bias, N), N, hd)
    want = fn(q, k, v, bias, N)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-6


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs("B11Sk"))
    before = fused_attention.launches
    got = fused_attention(q, k, v, bias, N)
    assert fused_attention.launches == before
    torch.testing.assert_close(got, attention_reference(q, k, v, bias, N),
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs("B11Sk"))
    with pytest.raises(ValueError):
        fused_attention(q, k[:, :-1], v, bias, N)
    with pytest.raises(ValueError):
        fused_attention(q, k, v, bias, 5)


def test_key_bias_is_broadcast_by_strides():
    """A (B,1,1,Sk) key mask reaches the kernel as a stride-0 view, not a
    (B, Sq, Sk) copy."""
    bias = torch.zeros(B, 1, 1, SK)
    b3 = _normalize_bias(bias, B, SQ, SK)
    assert b3.shape == (B, SQ, SK) and b3.stride() == (SK, 0, 1)
    assert b3.data_ptr() == bias.data_ptr()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["B11Sk", "BSk", "BSqSk"])
def test_kernel_matches_plain_version_on_card(cuda_device, bias_kind, dtype):
    """Main-path head width (64), Sq != Sk, a ragged key tile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    td = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 150, 1024))
                         .astype(np.float32)).to(cuda_device, td)
    k = torch.from_numpy(rng.standard_normal((3, 23, 1024))
                         .astype(np.float32)).to(cuda_device, td)
    v = torch.from_numpy(rng.standard_normal((3, 23, 1024))
                         .astype(np.float32)).to(cuda_device, td)
    bias = torch.zeros(3, 23, device=cuda_device)
    bias[:, -4:] = -10000.0
    if bias_kind == "B11Sk":
        bias = bias[:, None, None, :]
    elif bias_kind == "BSqSk":
        bias = bias[:, None, :] + torch.randn(3, 150, 23, device=cuda_device)
    before = fused_attention.launches
    got = fused_attention(q, k, v, bias, 16)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    want = attention_reference(q, k, v, bias, 16)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
