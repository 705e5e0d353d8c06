"""Fused multi-head attention for short sequences: a hand-written CUDA
kernel for Hopper (`csrc/fused_attention.cu`) and its plain PyTorch version.

Replaces `icka_tpu/kernels/attention.py::fused_attention` (the Pallas TPU
kernel). The contract is the TPU kernel's:

    out[b] = softmax(Q[b] K[b]^T * head_dim^-0.5 + bias[b]) V[b]   per head

q (B, Sq, D), k/v (B, Sk, D), D = num_heads * head_dim, bias additive fp32
of shape (B, 1, 1, Sk) (`additive_mask`), (B, Sk) or (B, Sq, Sk). Softmax
is fp32. fp32 inputs give fp32 math; bf16 inputs give bf16 products with
fp32 accumulation and probabilities rounded to bf16 before P.V. The output
has q's dtype.

`fused_attention` takes the plain version `attention_reference` for tensors
on the CPU, and only then. For CUDA tensors it launches the kernel or
raises. `fused_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icka_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64                # the one head width the kernel is built for
_GRID_LIMIT = 65535          # grid.y (heads) and grid.z (batch)


def _normalize_bias(bias, B: int, Sq: int, Sk: int):
    """fp32 (B, Sq, Sk) view of a (B,1,1,Sk), (B,Sk) or (B,Sq,Sk) bias,
    broadcast by strides: a key mask is not copied to (B, Sq, Sk)."""
    bias = torch.as_tensor(bias).float()
    if bias.ndim == 4:
        bias = bias[:, 0]
    if bias.ndim == 2:
        bias = bias[:, None, :]
    return bias.expand(B, Sq, Sk)


def attention_reference(q, k, v, bias, num_heads: int):
    """Plain PyTorch version with the kernel's semantics (the CPU path, and
    what the kernel is held against on the card)."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // num_heads
    qh = q.reshape(B, Sq, num_heads, hd).float()
    kh = k.reshape(B, Sk, num_heads, hd).float()
    vh = v.reshape(B, Sk, num_heads, hd).float()
    scores = torch.einsum("bqnh,bknh->bnqk", qh, kh) * hd ** -0.5
    scores = scores + _normalize_bias(bias, B, Sq, Sk)[:, None]
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bnqk,bknh->bqnh", p.float(), vh)
    return out.reshape(B, Sq, D).to(q.dtype)


@functools.cache
def _kernel():
    fn = build.load("fused_attention").icka_fused_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_attention(q, k, v, bias, num_heads: int):
    """q (B, Sq, D), k/v (B, Sk, D), bias broadcastable to (B, Sq, Sk)
    additive fp32. Returns (B, Sq, D) in q.dtype."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"fused_attention wants q (B,Sq,D), k = v (B,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, D = q.shape
    Sk = k.shape[1]
    if k.shape[0] != B or k.shape[2] != D or D % num_heads:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} do not "
                         f"fit {num_heads} heads")
    bias3 = _normalize_bias(bias, B, Sq, Sk)
    devices = {t.device for t in (q, k, v, bias3)}
    if len(devices) != 1:
        raise ValueError(f"fused_attention inputs on several devices: "
                         f"{devices}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on CUDA or the CPU, not "
                         f"{q.device}")

    hd = D // num_heads
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if hd != HEAD_DIM:
        raise ValueError(f"fused_attention kernel takes head_dim "
                         f"{HEAD_DIM}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention kernel needs contiguous q, k, v")
    if min(B, Sq, Sk) == 0 or max(B, num_heads) > _GRID_LIMIT:
        raise ValueError(f"fused_attention kernel cannot take B={B}, "
                         f"Sq={Sq}, Sk={Sk}, num_heads={num_heads}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias3.data_ptr(), out.data_ptr(), B, Sq, Sk, num_heads, hd,
            *bias3.stride(), hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
