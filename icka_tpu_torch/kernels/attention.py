"""Fused multi-head attention: two hand-written CUDA kernels for Hopper and
their plain PyTorch versions.

`fused_attention` replaces `icka_tpu/kernels/attention.py::fused_attention`,
the Pallas TPU kernel for short sequences; `fused_attention_blockwise`
(`csrc/blockwise_attention.cu`) replaces `fused_attention_blockwise` there,
the length-scalable variant. The contract of both is the TPU kernels':

    out[b] = softmax(Q[b] K[b]^T * head_dim^-0.5 + bias[b]) V[b]   per head

q (B, Sq, D), k/v (B, Sk, D), D = num_heads * head_dim, bias additive fp32
of shape (B, 1, 1, Sk) (`additive_mask`), (B, Sk) or (B, Sq, Sk). Softmax
is fp32. fp32 inputs give fp32 math; bf16 inputs give bf16 products with
fp32 accumulation and probabilities rounded to bf16 before P.V. The output
has q's dtype.

Which body runs (`csrc/blockwise_attention.cu`, one library for both
wrappers): up to head width 128, the tensor-core bodies, in bf16 on
bf16 `mma.sync` and in fp32 on TF32 `mma.sync` through 3xTF32 (each operand
split into a TF32 high and low part, three products into one fp32 sum,
held to the fp32 contract); `fused_attention` asks them for a short-sequence
tiling (`K1_TILES` in bf16, `K1_FP32_TILES` in fp32), K2 for the tiling
its caller asks. Above 128 both wrappers run the CUDA-core body in either
type, at one key tile of 32, in column chunks of at most 256 (any width).
Every width without an instance is zero-padded per head of q, k and v to
the next instance (`kernel_width`; above 256 the next multiple of 32), with
the unpadded width's scale (zero columns add exact zeros to every
product), and the padded output columns are dropped. Every body stages q,
k and v by 16-byte copies and reads them through a row stride each, so q,
k and v may be strided views: the (B, S, D) slices of one fused (B, S, 3D)
projection (`fuse_qkv`) are read in place, not copied. A CUDA tensor must
be aligned to 16 bytes, its last dimension contiguous, its rows a multiple
of 8 elements apart and its batches S rows apart (`row_stride`); any other
layout raises before the launch. The output is contiguous (B, Sq, D).

Each wrapper takes its plain version (`attention_reference`,
`attention_blockwise_reference`) for tensors on the CPU, and only then. For
CUDA tensors it launches a kernel or raises. `<wrapper>.launches` counts
kernel launches, `<wrapper>.strided_launches` those of them whose q, k or v
was not contiguous.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from icka_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NARROW_MAX_HEAD_DIM = 128    # widest head of the tensor-core bodies
# head widths with a kernel instance up to 256: the multiples of 16 up to
# 128, then the wide CUDA-core body's chunks (one output column per lane
# and 32); wider heads run that body in several chunks
HEAD_DIMS = (tuple(range(16, NARROW_MAX_HEAD_DIM + 1, 16))
             + (160, 192, 224, 256))
WIDE_MAX_CHUNK = HEAD_DIMS[-1]  # columns a wide-body block owns, at most
BLOCK_SIZES = (32, 64, 128)  # query rows and keys per tile of the blockwise
WIDE_BLOCK_K = 32            # the one key tile above NARROW_MAX_HEAD_DIM
WIDE_MAX_BLOCK_Q = 64        # ... and its largest query tile
TF32_MAX_BLOCK_K = 64        # widest key tile of the fp32 (3xTF32) body
# the tilings `fused_attention` asks of the tensor-core bodies: the fastest
# of (64, 64), (128, 64), (64, 32) and (32, 64) at K1's serving shapes
# (S = 150 and 172, 16 heads of 64; PERF.md), in bf16 and in fp32
K1_TILES = (64, 32)
K1_FP32_TILES = (64, 32)
_SMEM_LIMIT = 232448         # bytes of shared memory a block can use (sm_90)
_KV_ROW_PAD = 4              # wide body: elements of padding per K/V row
_MMA_ROW_PAD_BYTES = 16      # tensor-core bodies: padding per staged row
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


def _check_shapes(name, q, k, v, num_heads):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{name} wants q (B,Sq,D), k = v (B,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, D = q.shape
    Sk = k.shape[1]
    if k.shape[0] != B or k.shape[2] != D or D % num_heads:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} do not "
                         f"fit {num_heads} heads")
    return B, Sq, Sk, D


def _on_cpu(name, *tensors) -> bool:
    """True when all tensors lie on the CPU, False when all lie on one CUDA
    device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs on several devices: {devices}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or the CPU, not {device}")
    return device.type == "cpu"


def _check_kernel_inputs(name, q, k, v, num_heads):
    """What both kernels ask of CUDA tensors; raises before any launch."""
    B, Sq, D = q.shape
    Sk, hd = k.shape[1], D // num_heads
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if min(B, Sq, Sk, hd) == 0 or max(B, num_heads) > _GRID_LIMIT:
        raise ValueError(f"{name} kernel cannot take B={B}, Sq={Sq}, "
                         f"Sk={Sk}, num_heads={num_heads}, head_dim={hd}")


def row_stride(name, x) -> int:
    """The elements between two rows of a (B, S, D) CUDA tensor the kernel
    reads in place: its last dimension contiguous, rows a multiple of 8
    elements apart (16-byte copies in either type), batches S rows apart,
    and its first element aligned to 16 bytes. Raises otherwise."""
    B, S, D = x.shape
    ld = x.stride(1) if S > 1 else (x.stride(0) if B > 1 else D)
    if ((D > 1 and x.stride(2) != 1) or ld < D or ld % 8
            or (B > 1 and x.stride(0) != S * ld)
            or x.data_ptr() % 16):
        raise ValueError(
            f"{name} kernel cannot read a (B, S, D) = {tuple(x.shape)} "
            f"tensor with strides {x.stride()} at {x.data_ptr() % 16} bytes "
            f"past a 16-byte boundary: it needs the last dimension "
            f"contiguous, rows a multiple of 8 elements apart, batches S "
            f"rows apart, and q, k, v aligned to 16 bytes")
    return ld


def kernel_width(hd: int) -> int:
    """The width a head runs at: the narrowest of `HEAD_DIMS` that holds it;
    above 256 the next multiple of 32 (the wide body's column chunks)."""
    if hd > HEAD_DIMS[-1]:
        return -(-hd // 32) * 32
    return next(w for w in HEAD_DIMS if w >= hd)


def column_chunk(width: int) -> int:
    """Columns a block of the wide body owns at instance width `width` (a
    multiple of 32 above 128; `column_chunk` in the CUDA source): the width
    itself up to 256, above it the width split evenly into the fewest
    chunks of at most 256, each rounded up to a multiple of 32."""
    n = -(-width // WIDE_MAX_CHUNK)
    per_chunk = -(-width // n)
    return -(-per_chunk // 32) * 32


def pad_heads(x, num_heads: int, width: int):
    """(B, S, num_heads * hd) -> (B, S, num_heads * width): each head's
    columns followed by width - hd zeros. x itself when width == hd."""
    B, S, D = x.shape
    hd = D // num_heads
    if width == hd:
        return x
    return F.pad(x.view(B, S, num_heads, hd),
                 (0, width - hd)).view(B, S, num_heads * width)


def crop_heads(x, num_heads: int, hd: int):
    """The inverse of `pad_heads`: the first hd columns of each head."""
    B, S, D = x.shape
    if D == num_heads * hd:
        return x
    return x.view(B, S, num_heads, D // num_heads)[..., :hd].reshape(
        B, S, num_heads * hd)


class _NoBackward(torch.autograd.Function):
    """Runs `run(*inputs)` as a node of the autograd graph whose backward
    raises: the kernel, like the JAX package's, has no backward, and a
    gradient through it is refused rather than taken from another path."""

    @staticmethod
    def forward(ctx, run, *inputs):
        return run(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "fused_attention (K1) has no backward: train with attention "
            "dropout (the plain core) or without use_pallas")


def fused_attention(q, k, v, bias, num_heads: int):
    """q (B, Sq, D), k/v (B, Sk, D), bias broadcastable to (B, Sq, Sk)
    additive fp32. Returns (B, Sq, D) in q.dtype. Where autograd records
    the call, the result's backward raises, on the card and on the CPU
    alike."""
    inputs = (q, k, v, torch.as_tensor(bias))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _NoBackward.apply(
            lambda *t: _fused_attention(*t, num_heads), *inputs)
    return _fused_attention(*inputs, num_heads)


def _fused_attention(q, k, v, bias, num_heads: int):
    name = "fused_attention"
    B, Sq, Sk, D = _check_shapes(name, q, k, v, num_heads)
    bias3 = _normalize_bias(bias, B, Sq, Sk)
    if _on_cpu(name, q, k, v, bias3):
        return attention_reference(q, k, v, bias, num_heads)
    _check_kernel_inputs(name, q, k, v, num_heads)
    tiles = K1_TILES if q.dtype == torch.bfloat16 else K1_FP32_TILES
    out = _blockwise_launch(name, q, k, v, bias, num_heads, *tiles)
    _count(fused_attention, q, k, v)
    return out


def _count(wrapper, q, k, v):
    wrapper.launches += 1
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        wrapper.strided_launches += 1


fused_attention.launches = 0
fused_attention.strided_launches = 0


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention, the length-scalable variant
# ---------------------------------------------------------------------------

def _snap(want: int, total: int) -> int:
    """The largest tile size <= want (at least the smallest there is) that
    the sequence needs: not one whose half already covers `total`."""
    sizes = [b for b in BLOCK_SIZES if b <= max(want, BLOCK_SIZES[0])]
    for size in reversed(sizes[1:]):
        if size // 2 < total:
            return size
    return sizes[0]


def _smem_bytes(bq: int, bk: int, hd: int, dtype) -> int:
    """Shared memory of the kernel at this tiling and instance width. Up to
    width 128, the tensor-core bodies (`mma_smem_bytes` and
    `tf32_smem_bytes` in `csrc/blockwise_attention.cu`): the query tile
    (in fp32 its hi and lo planes), two stages of K and V tiles and two of
    the key-bias strip, rows padded by 16 bytes. Above, the wide CUDA-core
    body (`smem_bytes` there) at its column chunk: fp32 query chunk and
    probability tile, the key-bias strip, K and V chunks in the input type
    with padded rows."""
    elt = torch.empty((), dtype=dtype).element_size()
    if hd <= NARROW_MAX_HEAD_DIM:
        row = hd * elt + _MMA_ROW_PAD_BYTES
        planes = 2 if dtype == torch.float32 else 1
        return planes * bq * row + 2 * (2 * bk * row + bk * 4)
    cw = column_chunk(hd)
    return (bq * cw * 4 + bq * bk * 4 + bk * 4
            + 2 * bk * (cw + _KV_ROW_PAD) * elt)


def blockwise_tiles(Sq: int, Sk: int, head_dim: int, dtype,
                    block_q: int = 128, block_k: int = 128):
    """(bq, bk) the blockwise kernel runs for a request of (block_q,
    block_k): each snapped down to 32, 64 or 128, no larger than the
    sequence needs, and both halved (keys first) until the tiles fit a
    block's shared memory at the instance's width (`kernel_width`). In
    fp32 up to width 128 the keys take at most `TF32_MAX_BLOCK_K`; above
    width 128 the keys take `WIDE_BLOCK_K` and the rows at most
    `WIDE_MAX_BLOCK_Q`, the wide body's one tiling. The sizes need not
    divide Sq or Sk: the last tile of either dimension is masked."""
    bq, bk = _snap(block_q, Sq), _snap(block_k, Sk)
    width = kernel_width(head_dim)
    if width > NARROW_MAX_HEAD_DIM:
        bq, bk = min(bq, WIDE_MAX_BLOCK_Q), WIDE_BLOCK_K
    elif dtype == torch.float32:
        bk = min(bk, TF32_MAX_BLOCK_K)
    while _smem_bytes(bq, bk, width, dtype) > _SMEM_LIMIT:
        if bk > BLOCK_SIZES[0]:
            bk //= 2
        elif bq > BLOCK_SIZES[0]:
            bq //= 2
        else:
            raise ValueError(f"no tiling fits head_dim {head_dim}")
    return bq, bk


def _blockwise_bias(bias, B: int, Sq: int, Sk: int):
    """(key_mode, fp32 view). A key-only bias ((B,1,1,Sk) or (B,Sk)) stays
    (B, Sk) and is tiled along k; anything else becomes a (B, Sq, Sk)
    stride view, so a (B, 1, Sq, Sk) mask is not copied."""
    bias = torch.as_tensor(bias).float()
    key_mode = (bias.ndim == 4 and bias.shape[1] == 1
                and bias.shape[2] == 1) or bias.ndim == 2
    if key_mode:
        return True, bias.reshape(bias.shape[0], Sk).expand(B, Sk)
    return False, _normalize_bias(bias, B, Sq, Sk)


def attention_blockwise_reference(q, k, v, bias, num_heads: int,
                                  block_q: int = 128, block_k: int = 128):
    """Plain PyTorch version of the blockwise kernel: the same online-softmax
    recurrence, tile by tile at the tiling `blockwise_tiles` gives. The
    running maximum starts at -1e30 (finite, so a key tile whose scores are
    all -inf gives p = 0 and alpha = 1), p is cast to the input type before
    P.V, and acc / l is taken at the end."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // num_heads
    bq, bk = blockwise_tiles(Sq, Sk, hd, q.dtype, block_q, block_k)
    key_mode, b = _blockwise_bias(bias, B, Sq, Sk)
    b = b[:, None, None, :] if key_mode else b[:, None]     # (B,1,1|Sq,Sk)
    qh = q.reshape(B, Sq, num_heads, hd).permute(0, 2, 1, 3).float()
    kh = k.reshape(B, Sk, num_heads, hd).permute(0, 2, 3, 1).float()
    vh = v.reshape(B, Sk, num_heads, hd).permute(0, 2, 1, 3).float()
    out = torch.empty(B, num_heads, Sq, hd, device=q.device)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        m = torch.full((B, num_heads, q1 - q0, 1), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, num_heads, q1 - q0, hd, device=q.device)
        for k0 in range(0, Sk, bk):
            k1 = min(k0 + bk, Sk)
            s = torch.matmul(qh[:, :, q0:q1], kh[..., k0:k1]) * hd ** -0.5
            s = s + (b[..., k0:k1] if key_mode else b[:, :, q0:q1, k0:k1])
            m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(q.dtype).float(),
                                             vh[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / l
    return out.permute(0, 2, 1, 3).reshape(B, Sq, D).to(q.dtype)


@functools.cache
def _blockwise_kernel():
    fn = build.load("blockwise_attention").icka_blockwise_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _blockwise_launch(name, q, k, v, bias, num_heads: int, block_q: int,
                      block_k: int):
    """One launch of `csrc/blockwise_attention.cu` on CUDA tensors that
    passed `_check_kernel_inputs`; returns the output. q, k and v are read
    in place through their row strides (`row_stride`, which raises before
    the launch on any other layout), or as zero-padded copies at widths
    without an instance."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    key_mode, b = _blockwise_bias(bias, B, Sq, Sk)
    hd = D // num_heads
    width = kernel_width(hd)
    q, k, v = (pad_heads(t, num_heads, width) for t in (q, k, v))
    lds = [row_stride(name, t) for t in (q, k, v)]
    bq, bk = blockwise_tiles(Sq, Sk, hd, q.dtype, block_q, block_k)
    strides = (b.stride(0), 0, b.stride(1)) if key_mode else b.stride()
    out = torch.empty(B, Sq, num_heads * width, dtype=q.dtype,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _blockwise_kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            b.data_ptr(), out.data_ptr(), *lds, B, Sq, Sk, num_heads, width,
            bq, bk, int(key_mode), *strides, hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return crop_heads(out, num_heads, hd)


def fused_attention_blockwise(q, k, v, bias, num_heads: int,
                              block_q: int = 128, block_k: int = 128):
    """Blockwise fused attention, any length. q (B, Sq, D), k/v (B, Sk, D);
    bias additive fp32, either key-only ((B,1,1,Sk) or (B,Sk): kept (B, Sk),
    never broadcast to (B, Sq, Sk) in memory) or full ((B,Sq,Sk) or
    (B,1,Sq,Sk), read through strides). `block_q` / `block_k` ask for a
    tiling (see `blockwise_tiles`); they change the order of summation and
    nothing else. Returns (B, Sq, D) in q.dtype."""
    name = "fused_attention_blockwise"
    B, Sq, Sk, D = _check_shapes(name, q, k, v, num_heads)
    _, b = _blockwise_bias(bias, B, Sq, Sk)
    if _on_cpu(name, q, k, v, b):
        return attention_blockwise_reference(q, k, v, bias, num_heads,
                                             block_q, block_k)
    _check_kernel_inputs(name, q, k, v, num_heads)
    out = _blockwise_launch(name, q, k, v, bias, num_heads, block_q,
                            block_k)
    _count(fused_attention_blockwise, q, k, v)
    return out


fused_attention_blockwise.launches = 0
fused_attention_blockwise.strided_launches = 0
