"""int8 serving arithmetic shared by the text and visual halves.

`quantize_activation` is the symmetric int8 of the JAX package's quantised
layers, `clip(round(x / scale), -127, 127)` in fp32 (round half to even in
both packages). `int8_matmul` is the exact int32 product of the JAX
package's `lax.dot_general(..., preferred_element_type=int32)`
(`icka_tpu/nn/layers.py:143-146`, `icka_tpu/models/resnet.py:145,158`):
`torch._int_mm`, which runs on the CPU and, through cuBLASLt's int8 tensor
cores, on the card. It never falls back to a float product: a shape or type
the card's `_int_mm` refuses raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_CUDA_MIN_ROWS = 24
_CUDA_MULTIPLE = 8


def quantize_activation(x, act_scale):
    """Symmetric int8: round(x / act_scale) clipped to +-127, in fp32.
    `act_scale` is a tensor (0-d, or broadcastable per row): a tensor
    divisor keeps the division correctly rounded on the card, where a
    Python float divisor turns into a multiply by its reciprocal."""
    return (x.float() / act_scale).round().clamp(-127, 127).to(torch.int8)


def abs_max_scale(amax):
    """The symmetric int8 scale of an abs-max: max(amax, 1e-8) / 127."""
    return amax.clamp_min(1e-8) / amax.new_tensor(127.0)


def quantize_weight_cols(w):
    """Per-output-column abs-max int8 of a (K, F) float matrix:
    (int8 weights, fp32 scale (F,))."""
    w_s = abs_max_scale(w.float().abs().amax(dim=0))
    return quantize_activation(w, w_s[None, :]), w_s


def column_major(w):
    """`w` (K, F) with column-major strides: the layout in which cuBLASLt's
    int8 product takes its second operand. On an H100 a row-major one made
    `_int_mm` 6-11x slower at the text FFN's shapes and was refused at
    small ones (K = F = 64 with 17 or 24 rows). Shape, values and the
    state_dict view are unchanged."""
    return w.t().contiguous().t()


def _card_operands(a2, w):
    """(M, K) and (K, F) int8 operands as the card's `_int_mm` takes them:
    zero-padded to M, K and F multiples of 8 and at least 24 rows (zeros
    add nothing to the sums; the caller slices the (M, F) corner), the
    weight column-major."""
    M, K = a2.shape
    pad_m = max(_CUDA_MIN_ROWS, M + -M % _CUDA_MULTIPLE) - M
    pad_k = -K % _CUDA_MULTIPLE
    pad_n = -w.shape[1] % _CUDA_MULTIPLE
    if pad_m or pad_k:
        a2 = F.pad(a2, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_n, 0, pad_k))
    if w.stride(0) != 1:
        w = column_major(w)
    return a2, w


def int8_matmul(a, w):
    """Exact int32 sums of int8 products: (..., K) x (K, F) -> (..., F).

    On the card the operands are laid out as `_int_mm` needs them
    (`_card_operands`): a weight that is not held `column_major` costs a
    copy at every call, so modules hold theirs column-major."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {w.dtype}")
    if w.ndim != 2 or a.shape[-1] != w.shape[0]:
        raise ValueError(f"int8_matmul: {tuple(a.shape)} x {tuple(w.shape)}")
    lead, (K, N) = a.shape[:-1], w.shape
    a2 = a.reshape(-1, K)
    M = a2.shape[0]
    if a.device.type == "cuda":
        a2, w = _card_operands(a2, w)
    elif a.device.type != "cpu":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    out = torch._int_mm(a2.contiguous(), w)
    return out[:M, :N].reshape(*lead, N)
