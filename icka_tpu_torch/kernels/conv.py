"""int8 convolutions with fused epilogues: hand-written CUDA kernels for
Hopper (`csrc/int8_conv.cu`) and their plain PyTorch versions.

Replaces the four Pallas TPU kernels of `icka_tpu/kernels/conv.py`:

  int8_conv3x3        3x3/s1 conv of a pre-padded int8 image with the
                      scale/bias/residual/ReLU/requant epilogue;
  int8_bottleneck_v2  the identity ResNet bottleneck, int8 in, int8 or bf16
                      out (`g`, `padded_io`, `res_scale` a (1,) tensor);
  int8_stem_pool      the space-to-depth stem's dot, epilogue and max-pool;
  int8_bottleneck     the bottleneck with `res_scale` a Python float.

Activations are NHWC, weights `(k*k*Cin, F)` int8 in im2col order (tap
major, channel minor): the stored `wq` layout of `ConvBN`. Every kernel is
bit-equal to its plain version: integer sums are exact and each epilogue is
a separate fp32 multiply and add in the order written below.

Each wrapper takes its plain version for tensors on the CPU, and only then.
For CUDA tensors it launches the kernel or raises. `<wrapper>.launches`
counts calls that launched, one launch each. Every kernel runs on int8
wgmma and reads its weights K-major (`kmajor_tiles`): the public wrappers
lay them out at every call, the model keeps that copy beside its weights
and calls a private entry (`_int8_bottleneck_v2_tiled`,
`_int8_stem_pool_tiled`). The two bottleneck wrappers run one body
(`csrc/int8_bottleneck_wgmma.cuh`) whose geometry `bottleneck_geometry`
chooses; `<wrapper>.cluster_launches` counts their launches by the size of
the thread block clusters that split a tile's channels. The stem and the
3x3 conv run `csrc/int8_conv_wgmma.cuh`, whose geometry `stem_geometry`
and `conv3x3_geometry` choose.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch
import torch.nn.functional as tfn

from icka_tpu_torch.kernels import build

_RES_KIND = {torch.bfloat16: 2, torch.float32: 3}
_OUT_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def int_dot(a, w):
    """Exact int32 sums of int8 products over the last axis of `a`:
    (..., K) x (K, F). float64 holds every partial sum exactly (K * 127^2 is
    far below 2^53) on the CPU and on the card, where an int8 `@` would
    overflow."""
    return (a.double() @ w.double()).to(torch.int32)


def _taps3x3(x_pad, H: int, W: int):
    """(B, H, W, 9C) im2col patches of a pre-padded image, tap major."""
    return torch.cat([x_pad[:, i:i + H, j:j + W, :]
                      for i in range(3) for j in range(3)], dim=-1)


def _f32(value, like):
    """A Python float or a tensor as an fp32 scalar tensor beside `like`."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=like.device).reshape(())


# ---- plain versions -------------------------------------------------------


def conv3x3_reference(x_pad, w_q, scale, bias, residual=None,
                      relu: bool = True, out_scale: float | None = None,
                      out_dtype=torch.bfloat16):
    """Plain version of `int8_conv3x3`."""
    B, Hp, Wp, C = x_pad.shape
    H, W = Hp - 2, Wp - 2
    acc = int_dot(_taps3x3(x_pad, H, W), w_q)
    out = acc.float() * scale + bias
    if residual is not None:
        out = out + residual.float()
    if relu:
        out = torch.relu(out)
    if out_scale is not None:
        out = out * _f32(1.0 / out_scale, out)
        return out.round().clamp(-127, 127).to(torch.int8)
    return out.to(out_dtype)


def bottleneck_reference(x_q, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                         res_scale, out_bf16: bool = False):
    """Plain version of `int8_bottleneck` and `int8_bottleneck_v2`."""
    a1 = torch.relu(int_dot(x_q, w1).float() * s1 + b1)
    a1q = a1.round().clamp(0, 127).to(torch.int8)
    B, H, W, Cw = a1q.shape
    xp = torch.nn.functional.pad(a1q, (0, 0, 1, 1, 1, 1))
    a2 = torch.relu(int_dot(_taps3x3(xp, H, W), w2).float() * s2 + b2)
    a2q = a2.round().clamp(0, 127).to(torch.int8)
    out = int_dot(a2q, w3).float() * s3 + b3 \
        + x_q.float() * _f32(res_scale, x_q)
    out = torch.relu(out)
    if out_bf16:
        return out.to(torch.bfloat16)
    return out.round().clamp(0, 127).to(torch.int8)


def bottleneck_v2_reference(x_q, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                            res_scale, out_bf16: bool = False):
    """Plain version of `int8_bottleneck_v2` on the unpadded layout."""
    return bottleneck_reference(x_q, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                                res_scale, out_bf16)


def stem_pool_reference(patches, w2, scale, bias, out_dtype=torch.bfloat16):
    """Plain version of `int8_stem_pool`: (int32 -> fp32 * scale) ->
    out_dtype, + bias in out_dtype, ReLU, then the 3x3/s2 max-pool in
    space-to-depth space. Output row i pools conv rows {2i-1, 2i, 2i+1},
    which are sub-pixel planes p0(i), p1(i), p1(i-1); columns likewise.
    Zero padding is exact because the planes are >= 0."""
    B, OB, _, K = patches.shape
    F = w2.shape[1] // 4
    y = (int_dot(patches, w2).float() * scale).to(out_dtype) \
        + bias.to(out_dtype)
    y = torch.relu(y.reshape(B, OB, OB, 2, 2, F))
    p0, p1 = y[:, :, :, 0], y[:, :, :, 1]                 # (B,OB,OB,2,F)
    p1s = torch.cat([torch.zeros_like(p1[:, :1]), p1[:, :-1]], dim=1)
    r = torch.maximum(torch.maximum(p0, p1), p1s)
    q0, q1 = r[:, :, :, 0], r[:, :, :, 1]                 # (B,OB,OB,F)
    q1s = torch.cat([torch.zeros_like(q1[:, :, :1]), q1[:, :, :-1]], dim=2)
    return torch.maximum(torch.maximum(q0, q1), q1s)


# ---- the kernels ----------------------------------------------------------


@functools.cache
def _lib():
    lib = build.load("int8_conv")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.icka_int8_conv3x3.argtypes = ([p] * 6 + [i, p] + [i] * 7 + [f]
                                      + [i] * 8 + [p])
    lib.icka_int8_bottleneck.argtypes = ([p] * 11 + [f] + [p]
                                         + [i] * 18 + [p])
    lib.icka_int8_stem_pool.argtypes = [p] * 5 + [i] * 7 + [p]
    for fn in (lib.icka_int8_conv3x3, lib.icka_int8_bottleneck,
               lib.icka_int8_stem_pool):
        fn.restype = ctypes.c_int
    return lib


def _on_cpu(name: str, *tensors) -> bool:
    """True if every tensor lies on the CPU, False if every one lies on one
    CUDA device; anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or the CPU, not {dev}")
    return dev.type == "cpu"


def _want(name: str, what: str, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} wants {what} {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _kernel_operand(name: str, what: str, t):
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs {what} contiguous and "
                         f"16-byte aligned")
    return t.data_ptr()


def _launch(name: str, fn, x, *args):
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def int8_conv3x3(x_pad, w_q, scale, bias, residual=None, relu: bool = True,
                 out_scale: float | None = None, out_dtype=torch.bfloat16):
    """Fused int8 3x3/s1 conv.

    x_pad (B, H+2, W+2, C) int8, spatially pre-padded by 1; w_q (9C, F) int8
    tap major; scale (F,) fp32 = act_scale * per-channel weight scale; bias
    (F,) fp32; residual: optional (B, H, W, F) added before the ReLU;
    out_scale: None gives `out_dtype`, a float gives int8 requantised as
    round(out * (1/out_scale)) clipped to +-127. Returns (B, H, W, F).

    The kernel reads w_q K-major (`kmajor_tiles(w_q, 9)`): this wrapper lays
    it out on the device at every call."""
    name = "int8_conv3x3"
    if x_pad.ndim != 4 or w_q.ndim != 2:
        raise ValueError(f"{name} wants x_pad (B,H+2,W+2,C) and w_q (9C,F)")
    B, Hp, Wp, C = x_pad.shape
    H, W, F = Hp - 2, Wp - 2, w_q.shape[1]
    _want(name, "x_pad", x_pad, torch.int8, (B, Hp, Wp, C))
    _want(name, "w_q", w_q, torch.int8, (9 * C, F))
    _want(name, "scale", scale, torch.float32, (F,))
    _want(name, "bias", bias, torch.float32, (F,))
    if residual is not None and tuple(residual.shape) != (B, H, W, F):
        raise ValueError(f"{name} wants residual {(B, H, W, F)}, got "
                         f"{tuple(residual.shape)}")
    if _on_cpu(name, x_pad, w_q, scale, bias, residual):
        return conv3x3_reference(x_pad, w_q, scale, bias, residual, relu,
                                 out_scale, out_dtype)
    out_dt = torch.int8 if out_scale is not None else out_dtype
    if out_dt not in _OUT_KIND:
        raise TypeError(f"{name} kernel writes int8, bfloat16 or float32, "
                        f"not {out_dt}")
    if residual is not None and residual.dtype not in _RES_KIND:
        raise TypeError(f"{name} kernel takes a bfloat16 or float32 "
                        f"residual, not {residual.dtype}")
    if min(B, H, W) < 1 or C % 16 or F % 16:
        raise ValueError(f"{name} kernel needs C % 16 == 0 and F % 16 == 0, "
                         f"got B={B} H={H} W={W} C={C} F={F}")
    g = conv3x3_geometry(B, H, W, C, F, _sm_count(x_pad.device.index or 0))
    return _conv3x3_launch(x_pad, w_q, scale, bias, residual, relu,
                           out_scale, out_dt, g)


def _conv3x3_launch(x_pad, w_q, scale, bias, residual, relu, out_scale,
                    out_dt, g):
    """One launch of the 3x3 conv body on operands `int8_conv3x3` has
    checked, at geometry `g` (`conv3x3_geometry`'s; a tool that times the
    alternatives passes `_conv3_geometry`'s at other product sizes)."""
    name = "int8_conv3x3"
    B, Hp, Wp, C = x_pad.shape
    F = w_q.shape[1]
    tiles = kmajor_tiles(w_q, 9)
    vecs = None
    if not g["staged"]:                 # F too wide for shared memory
        vecs = torch.zeros(2, g["Fp"], device=x_pad.device)
        vecs[0, :F], vecs[1, :F] = scale, bias
    out = torch.empty((B, Hp - 2, Wp - 2, F), dtype=out_dt,
                      device=x_pad.device)
    _launch(name, _lib().icka_int8_conv3x3, x_pad,
            _kernel_operand(name, "x_pad", x_pad),
            _kernel_operand(name, "w_q's tiles", tiles),
            _kernel_operand(name, "scale", scale),
            _kernel_operand(name, "bias", bias),
            None if vecs is None else vecs.data_ptr(),
            None if residual is None
            else _kernel_operand(name, "residual", residual),
            0 if residual is None else _RES_KIND[residual.dtype],
            out.data_ptr(), _OUT_KIND[out_dt], B, Hp - 2, Wp - 2, C, F,
            int(relu), 1.0 if out_scale is None else 1.0 / out_scale,
            *(g[k] for k in _CONV3_ARGS))
    int8_conv3x3.launches += 1
    return out


int8_conv3x3.launches = 0


def _bottleneck_shapes(name, x_q, w1, w2, w3, vectors):
    B, Cin, Cw = x_q.shape[0], x_q.shape[3], w1.shape[1]
    if x_q.dtype != torch.int8 or Cin != 4 * Cw:
        raise ValueError(f"{name} wants x_q int8 with 4*Cw channels, got "
                         f"{x_q.dtype} {tuple(x_q.shape)} for Cw={Cw}")
    _want(name, "w1", w1, torch.int8, (Cin, Cw))
    _want(name, "w2", w2, torch.int8, (9 * Cw, Cw))
    _want(name, "w3", w3, torch.int8, (Cw, Cin))
    for what, t, n in zip(("s1", "b1", "s2", "b2", "s3", "b3"), vectors,
                          (Cw, Cw, Cw, Cw, Cin, Cin)):
        _want(name, what, t, torch.float32, (n,))
    return B, Cin, Cw


# ---- the bottleneck's wgmma body: its geometry and its weights ----------
#
# The body (`csrc/int8_bottleneck_wgmma.cuh`) walks tiles of TR x TC output
# pixels of one image, each with the one-pixel halo conv2 reads, on a
# persistent grid of clusters of CL CTAs that split a tile's channels. Its
# products are units of one 64-row block by one 64-channel slice (wgmma
# m64n64k32), shared by two warpgroups; its operands stream through a ring
# of shared-memory slots in chunks of 128 bytes of K.

_BNECK_SMEM_LIMIT = 232448       # bytes a block may have (H100)
_BNECK_SPAN = 128                # bytes of K a chunk: one swizzle span
_BNECK_BLOCK = 64                # rows of an m-block, an n-slice, a tile
_BNECK_SWIZZLE_ATOM = 8 * _BNECK_SPAN
_BNECK_MAX_SLOTS = 4
_BNECK_MAX_CLUSTER = 8           # the portable cluster size
# conv3's staging rows: 8 consumer warps x 16 rows x 72 fp32 words
_BNECK_STAGE_BYTES = 8 * 16 * 72 * 4
# (conv1's rows, conv2's and conv3's rows) to try, largest first: conv1's
# rows are TMA box rows (at most 256); conv2's and conv3's two warpgroups
# hold at most two 64-row blocks each
_BNECK_ROW_LIMITS = ((256, 128), (128, 128), (128, 64), (64, 64))


def padded_width(c: int) -> int:
    """Bytes a row of a1q or a2q takes for c channels, and each tap of a
    K-major weight: 16-byte units that a swizzle keeps inside the row, 4 of
    them or a multiple of 8 (`padded_width` in the CUDA source)."""
    return 64 if c <= 64 else -(-c // 128) * 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def bottleneck_units(MB: int, NS: int, wg: int) -> tuple[int, int]:
    """(m-blocks, slices) warpgroup `wg` (0 or 1) holds of a pass over MB
    64-row blocks and NS 64-channel slices: the two split the m-blocks
    where they are even in number or there is one slice, else the slices
    (`Units` in the CUDA source)."""
    if NS == 1 or MB % 2 == 0:
        mbw, nsw = (MB - wg + 1) // 2, NS
    else:
        mbw, nsw = MB, (NS - wg + 1) // 2
    return (0, 0) if mbw <= 0 or nsw <= 0 else (mbw, nsw)


def _shape_ok(mbw: int, nsw: int) -> bool:
    """A warpgroup's share the body has an instance for: at most 2 units
    (32 accumulator registers each; `shape_ok` in the CUDA source)."""
    return mbw == 0 or (nsw == 1 and mbw <= 2) or (mbw == 1 and nsw == 2)


def _pass_width(channels: int, MB: int, shape_ok=None) -> int:
    """The widest pass over a CTA's `channels`: a power-of-two count of
    64-channel slices that divides them and whose shares both warpgroups
    hold (`shape_ok(mbw, nsw, wm)`; the bottleneck's `_shape_ok` by
    default)."""
    if shape_ok is None:
        def shape_ok(mbw, nsw, wm):
            return _shape_ok(mbw, nsw)
    width, ns = _BNECK_BLOCK, 1
    while (channels // _BNECK_BLOCK) % ns == 0 and ns <= channels // 64:
        wm = 2 if ns == 1 or MB % 2 == 0 else 1
        if all(shape_ok(*bottleneck_units(MB, ns, wg), wm)
               for wg in (0, 1)):
            width = _BNECK_BLOCK * ns
        ns *= 2
    return width


def _tile_shape(H: int, W: int, rows: int, out_rows: int):
    """(TR, TC): whole rows of the image where three of them fit conv1's
    `rows` (the halo adds a row above and below), else strips of at most 4
    rows by columns with their own halo; evened out over the image."""
    if 3 * W <= rows and W <= out_rows:
        tr, tc = min(H, out_rows // W, rows // W - 2), W
    else:
        tr = min(H, 4)
        tc = min(W, out_rows // tr, rows // (tr + 2) - 2)
        tc = -(-W // -(-W // tc))
    tr = -(-H // -(-H // tr))
    return tr, tc


def _bottleneck_smem_bytes(g: dict) -> int:
    """Dynamic shared memory of the body (`smem_bytes` in the CUDA source):
    up to 1024 bytes to align the ring to the swizzle's atom, the ring's
    slots, a1q's conv1 rows and its zero row, a2q's rows (of Cwp bytes
    each), the CTA's scales and biases (four fp32 vectors over its Cwp / CL
    channels of a1q and a2q, two over its 4Cw / CL of the output), conv3's
    staging rows (16 x 72 fp32 words a consumer warp), a full and an empty
    barrier a slot and the two exchange barriers."""
    return (_BNECK_SWIZZLE_ATOM + g["slots"] * g["slot_bytes"]
            + (g["BM1"] + 1) * g["Cwp"] + g["BM"] * g["Cwp"]
            + 4 * (4 * g["Cwp"] + 8 * g["Cw"]) // g["CL"]
            + _BNECK_STAGE_BYTES + (2 * g["slots"] + 2) * 8)


def bottleneck_geometry(B: int, H: int, W: int, Cw: int,
                        sms: int = 132) -> dict:
    """The body's geometry (see `_geometry`), a fresh dict each call."""
    return dict(_geometry(B, H, W, Cw, sms, None))


@functools.lru_cache(maxsize=256)
def _geometry(B: int, H: int, W: int, Cw: int, sms: int,
              cluster: int | None) -> dict:
    """The body's geometry for a (B, H, W) grid of bottlenecks of width Cw
    on a card of `sms` SMs: tile rows TR and columns TC, rows of conv1's
    product BM1 (the halo box (TR + 2) x BC, BC = W for whole rows, else
    TC + 2) and of conv2's and conv3's BM, each a multiple of 64; the
    cluster size CL, doubled while the channels split evenly into 64-wide
    slices and the clusters' CTAs fill at most half the SMs (above that
    the exchanges cost more than the idle SMs: PERF.md); the channels a
    pass of each product (np1, np2, np3) and the ring's slots, at most 4
    and at least 2 within 232,448 bytes (the passes narrowed, then the
    tiles made smaller, until they fit). `cluster`, where not None, sets CL
    instead of the rule (`tools/int8_conv_launches.py --clusters` measures
    the rule so). Raises ValueError for a width whose a1q and a2q do not
    fit."""
    Cin, Cwp = 4 * Cw, padded_width(Cw)
    for rows, out_rows in _BNECK_ROW_LIMITS:
        tr, tc = _tile_shape(H, W, rows, out_rows)
        bc = W if tc == W else tc + 2
        g = dict(TR=tr, TC=tc, BC=bc, cpad=int(tc < W), Cwp=Cwp, Cw=Cw,
                 BM=_round_up(tr * tc, _BNECK_BLOCK),
                 BM1=_round_up((tr + 2) * bc, _BNECK_BLOCK),
                 nty=-(-H // tr), ntx=-(-W // tc))
        g["ntiles"] = B * g["nty"] * g["ntx"]
        cl = 1
        while (cl < _BNECK_MAX_CLUSTER and (Cwp // 64) % (2 * cl) == 0
               and (Cin // 64) % (2 * cl) == 0
               and g["ntiles"] * 2 * cl <= sms // 2):
            cl *= 2
        if cluster is not None:
            if cluster not in (1, 2, 4, 8) or (Cwp // 64) % cluster \
                    or (Cin // 64) % cluster:
                raise ValueError(f"no cluster of {cluster} CTAs splits "
                                 f"Cw={Cw} into 64-channel slices")
            cl = cluster
        MB1, MB = g["BM1"] // 64, g["BM"] // 64
        nps = {"np1": _pass_width(Cwp // cl, MB1),
               "np2": _pass_width(Cwp // cl, MB),
               "np3": _pass_width(Cin // cl, MB)}
        while True:
            g.update(CL=cl, **nps)
            g["slot_bytes"] = _BNECK_SPAN * max(g["BM1"] + nps["np1"],
                                                nps["np2"], nps["np3"])
            g["slots"] = 0
            fixed = _bottleneck_smem_bytes(g)
            g["slots"] = min(_BNECK_MAX_SLOTS, (_BNECK_SMEM_LIMIT - fixed)
                             // (g["slot_bytes"] + 16))
            if g["slots"] >= 2:
                g["smem"] = _bottleneck_smem_bytes(g)
                return g
            # narrow the pass that sets the slot's size, if it can be
            sizes = {"np1": g["BM1"] + nps["np1"], "np2": nps["np2"],
                     "np3": nps["np3"]}
            widest = max((k for k in sizes if nps[k] > _BNECK_BLOCK),
                         key=sizes.get, default=None)
            if widest is None:
                break
            nps[widest] //= 2
    raise ValueError(f"the int8 bottleneck kernel cannot fit a1q and a2q "
                     f"of width Cw={Cw} in shared memory")


def x_tensor_map_geometry(B: int, H: int, W: int, Cw: int, view, g: dict):
    """(dims, byte strides, box) of the 4-D tensor map the body reads x
    through (`x_tensor_map` in the CUDA source): dims (4Cw, W, H, B) from
    the grid's origin, strides of a pixel, a row and an image of the
    storage (Hs, Ws) = view[:2], a box of 128 channels (one 128-byte
    swizzle span) by BC columns by TR + 2 rows of one image. TMA wants the
    strides multiples of 16 bytes and at most 256 a box dimension."""
    Hs, Ws = view[0], view[1]
    Cin = 4 * Cw
    return ((Cin, W, H, B), (Cin, Cin * Ws, Cin * Ws * Hs),
            (_BNECK_SPAN, g["BC"], g["TR"] + 2, 1))


def kmajor_tiles(wq, taps: int = 1):
    """A (taps * Cin, F) int8 weight in the JAX layout, tap major, as the
    bottleneck body reads it: K-major (F rows of K bytes: 8-bit wgmma reads
    both operands K-major only), each tap's Cin channels padded with zeros
    to `padded_width(Cin)`, rows to `padded_width(F)`, K to a multiple of
    128; cut into tiles of 64 rows by 128 bytes ordered by chunk of K, then
    by rows, so that one chunk of a run of rows is contiguous; inside a
    tile, row r's 16-byte unit u at unit u ^ (r % 8), the 128-byte swizzle
    TMA and wgmma use. Flat int8 on wq's device."""
    K, F = wq.shape
    cin = K // taps
    cp, fp = padded_width(cin), padded_width(F)
    kp = _round_up(taps * cp, _BNECK_SPAN)
    wk = torch.zeros((fp, taps, cp), dtype=torch.int8, device=wq.device)
    wk[:F, :, :cin] = wq.reshape(taps, cin, F).permute(2, 0, 1)
    wk = tfn.pad(wk.reshape(fp, taps * cp), (0, kp - taps * cp))
    t = wk.reshape(fp // 64, 64, kp // _BNECK_SPAN, 8, 16) \
        .permute(2, 0, 1, 3, 4)
    r = torch.arange(64, device=wq.device)
    unit = torch.arange(8, device=wq.device)[None, :] ^ (r[:, None] & 7)
    return t[:, :, r[:, None], unit].contiguous().reshape(-1)


def bottleneck_weight_tiles(w1, w2, w3):
    """`kmajor_tiles` of the three weights of a bottleneck."""
    return kmajor_tiles(w1), kmajor_tiles(w2, 9), kmajor_tiles(w3)


# ---- the stem's and the 3x3 conv's wgmma bodies: their geometry --------
#
# Both bodies (`csrc/int8_conv_wgmma.cuh`) run a producer warpgroup and two
# consumer warpgroups on a persistent grid, as the bottleneck's does. The
# stem's tiles are 7 x 7 outputs, an 8 x 8 box of pixels with its halo (one
# 64-row m-block), each consumer warpgroup taking the CTA's tiles in turn;
# its weight stays in shared memory where it fits (else it streams with the
# patches) and the patches stream through a ring of one-span slots a
# warpgroup. The 3x3 conv's work items are passes over tiles of TR
# x TC outputs whose halo box stays in shared memory while the pass's
# weight streams through the ring.

_STEM_BOX = 8                    # box side: 7 outputs and the halo
_STEM_SLOT_BYTES = _BNECK_BLOCK * _BNECK_SPAN
_STEM_MAX_SLOTS = 4              # a consumer warpgroup's ring
_CONV3_MAX_ROWS = 256            # of the product and of a box side
_CONV3_MAX_SLOTS = 4
# the product's rows to try, largest first: tiles of 256 rows (two
# m-blocks by one slice a warpgroup) ran slower than 128 (PERF.md)
_CONV3_ROWS = (128, 64)
_CONV3_ARGS = ("TR", "TC", "BM", "np", "slots", "boxes", "sg", "grid")


def _stem_smem_bytes(g: dict) -> int:
    """Dynamic shared memory of the stem's body (`stem_smem_bytes` in the
    CUDA source): up to 1024 bytes to align, the resident weight (N rows of
    nsp spans of 128 bytes), the two consumer warpgroups' rings (`slots`
    slots each of one span of one box, and of the weight's span where it
    streams), the warps' U words (two warpgroups x two tile parities x four
    warps x F / 8 words x 32 lanes), the output stage (eight warps x 16
    pixels x F / 2 + 4 words), scales (fp32) and biases (bf16), and a full
    and an empty barrier a slot and the weight's barriers (`nwb`: one a
    resident span, else one)."""
    N = g["N"]
    return (_BNECK_SWIZZLE_ATOM + g["resident"] * N * g["nsp"] * _BNECK_SPAN
            + 2 * g["slots"] * g["slot_bytes"] + 64 * N
            + 8 * 64 * (N // 8 + 4) + 6 * N + 8 * (4 * g["slots"] + g["nwb"]))


def stem_geometry(B: int, OB: int, K: int, N: int, sms: int = 132) -> dict:
    """The stem body's geometry for (B, OB, OB, K) patches and N = 4F
    columns on a card of `sms` SMs: tiles of 7 x 7 outputs (`tiles_x` a
    side, `ntiles` in all), the K-spans of 128 bytes (`nsp`) and the stages
    of two k32 steps that reach K (`nstages`); the weight resident in
    shared memory where it leaves room for two slots a consumer warpgroup
    (`resident` 1), else streamed span by span beside the patches in each
    slot (`resident` 0, K above 512 at 4F = 256, above 1280 at 4F = 128);
    each warpgroup's ring of 2 to 4 slots within 232,448 bytes; the grid
    (one CTA a SM, at most one for two tiles)."""
    nsp = -(-K // _BNECK_SPAN)
    g = dict(B=B, OB=OB, K=K, N=N, nsp=nsp, nstages=-(-K // 64),
             tiles_x=-(-OB // (_STEM_BOX - 1)))
    g["ntiles"] = B * g["tiles_x"] ** 2
    for resident in (1, 0):
        g.update(resident=resident, slots=0, nwb=nsp if resident else 1,
                 slot_bytes=_STEM_SLOT_BYTES
                 + (1 - resident) * N * _BNECK_SPAN)
        g["slots"] = min(_STEM_MAX_SLOTS,
                         (_BNECK_SMEM_LIMIT - _stem_smem_bytes(g))
                         // (2 * (g["slot_bytes"] + 16)))
        if g["slots"] >= 2:
            break
    g["smem"] = _stem_smem_bytes(g)
    g["grid"] = min(sms, -(-g["ntiles"] // 2))
    return g


def stem_tensor_map_geometry(B: int, OB: int, K: int):
    """(dims, byte strides, box) of the 4-D tensor map the stem body reads
    the patches through (`stem_tensor_map` in the CUDA source): dims (K, OB,
    OB, B), strides of a pixel, a row and an image, a box of one 128-byte
    swizzle span by 8 x 8 pixels of one image."""
    return ((K, OB, OB, B), (K, K * OB, K * OB * OB),
            (_BNECK_SPAN, _STEM_BOX, _STEM_BOX, 1))


def _conv3_smem_bytes(g: dict) -> int:
    """Dynamic shared memory of the 3x3 conv's body (`conv3_smem_bytes` in
    the CUDA source): up to 1024 bytes to align, the box buffers (sg spans
    of (TR + 2) (TC + 2) rows of 128 bytes, each span 1024-aligned), the
    ring's slots (np rows of 128 bytes), the epilogue's staged rows (16 x
    72 fp32 words a consumer warp), scale and bias over the padded channels
    (fp32) where they are staged, a full and an empty barrier a slot and a
    box."""
    return (_BNECK_SWIZZLE_ATOM + g["boxes"] * g["box_bytes"]
            + g["slots"] * g["slot_bytes"] + _BNECK_STAGE_BYTES
            + 8 * g["Fp"] * g["staged"]
            + 8 * (2 * g["slots"] + 2 * g["boxes"]))


def conv3_shape_ok(mbw: int, nsw: int, wm: int) -> bool:
    """A warpgroup's share of a pass the 3x3 conv's body has an instance
    for (`conv3_shape_ok` in the CUDA source): the bottleneck's, or one
    m-block by two or four neighbouring slices (one m64n128 or m64n256
    product; neighbours where the warpgroups split the m-blocks, wm = 2)."""
    return mbw == 0 or (nsw == 1 and mbw <= 2) or \
        (mbw == 1 and nsw in (2, 4) and wm == 2)


def _conv3_tile(H: int, W: int, rows: int):
    """(TR, TC): whole rows of the image where they fit `rows` and a box of
    at most 256 rows (the halo adds a row above and below, a column each
    side), else strips of at most 4 rows by columns; evened out over the
    image."""
    if W <= rows and 3 * (W + 2) <= _CONV3_MAX_ROWS:
        tr, tc = min(H, rows // W, _CONV3_MAX_ROWS // (W + 2) - 2), W
    else:
        tr = min(H, 4)
        tc = min(W, rows // tr, _CONV3_MAX_ROWS // (tr + 2) - 2)
        tc = -(-W // -(-W // tc))
    tr = -(-H // -(-H // tr))
    return tr, tc


def conv3x3_geometry(B: int, H: int, W: int, C: int, F: int,
                     sms: int = 132) -> dict:
    """The 3x3 conv body's geometry (see `_conv3_geometry`), a fresh dict
    each call."""
    return dict(_conv3_geometry(B, H, W, C, F, sms, None))


def _box_groups(spans: int):
    """Spans a box buffer holds, to try in turn: all of them, then about a
    half, a quarter, ... down to one."""
    sg = spans
    while True:
        yield sg
        if sg == 1:
            return
        sg = -(-sg // 2)


@functools.lru_cache(maxsize=256)
def _conv3_geometry(B: int, H: int, W: int, C: int, F: int, sms: int,
                    rows: int | None) -> dict:
    """The 3x3 conv body's geometry for a (B, H, W) output of F channels
    from C on a card of `sms` SMs: tile rows TR and columns TC (whole rows
    where they fit, the largest product first: 128 rows, then 64), the
    product's rows BM (TR TC rounded up to 64), the channels a pass np
    (the widest both warpgroups hold, `_pass_width` with
    `conv3_shape_ok`), the ring's slots (2 to 4) and the box buffers (2
    where they fit beside 2 slots, else 1) within 232,448 bytes, the
    passes narrowed, then the tiles made smaller, until they fit; where no
    box of all the channels' spans fits, the spans a box holds (`sg`, of
    `spans`) halved until one does, the box then coming in `ngroups`
    groups; scale and bias staged in shared memory (`staged`) unless F is
    too wide for any of these, and then read from a padded global copy.
    The work items (one pass of one tile each: `nitems` =
    `ntiles` x `npass`) and the grid (one CTA a SM, at most one an item).
    `rows`, where not None, is the only product size tried, 256 too
    (`tools/int8_conv_launches.py --tiles` times them so)."""
    Cp, Fp = padded_width(C), padded_width(F)
    spans = -(-Cp // _BNECK_SPAN)
    for staged, sg in itertools.product((1, 0), _box_groups(spans)):
        for r in (rows,) if rows else _CONV3_ROWS:
            tr, tc = _conv3_tile(H, W, r)
            g = dict(TR=tr, TC=tc, BM=_round_up(tr * tc, _BNECK_BLOCK),
                     Cp=Cp, Fp=Fp, spans=spans, sg=sg, staged=staged,
                     ngroups=-(-spans // sg), BC=tc + 2, nty=-(-H // tr),
                     ntx=-(-W // tc), kc=-(-9 * Cp // _BNECK_SPAN))
            g["ntiles"] = B * g["nty"] * g["ntx"]
            g["span_stride"] = _round_up(g["BC"] * (tr + 2) * _BNECK_SPAN,
                                         _BNECK_SWIZZLE_ATOM)
            g["box_bytes"] = sg * g["span_stride"]
            np_ = _pass_width(Fp, g["BM"] // _BNECK_BLOCK, conv3_shape_ok)
            while True:
                g.update(np=np_, slot_bytes=np_ * _BNECK_SPAN)
                for boxes in (2, 1):
                    g.update(boxes=boxes, slots=0)
                    g["slots"] = min(_CONV3_MAX_SLOTS,
                                     (_BNECK_SMEM_LIMIT
                                      - _conv3_smem_bytes(g))
                                     // (g["slot_bytes"] + 16))
                    if g["slots"] >= 2:
                        g["smem"] = _conv3_smem_bytes(g)
                        g["npass"] = Fp // np_
                        g["nitems"] = g["ntiles"] * g["npass"]
                        g["grid"] = min(sms, g["nitems"])
                        return g
                if np_ == _BNECK_BLOCK:
                    break
                np_ //= 2
    raise AssertionError("a box of one span fits any tile shape")


def conv3_tensor_map_geometry(B: int, H: int, W: int, C: int, g: dict):
    """(dims, byte strides, box) of the 4-D tensor map the 3x3 conv body
    reads x_pad through (`conv3_tensor_map` in the CUDA source): dims (C,
    W + 2, H + 2, B), strides of a pixel, a row and an image, a box of one
    128-byte swizzle span by TC + 2 columns by TR + 2 rows of one image."""
    return ((C, W + 2, H + 2, B), (C, C * (W + 2), C * (W + 2) * (H + 2)),
            (_BNECK_SPAN, g["TC"] + 2, g["TR"] + 2, 1))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_GEOMETRY_ARGS = ("TR", "TC", "BM1", "BM", "CL", "np1", "np2", "np3",
                  "slots")


def _bottleneck_launch(name, x_q, weights, vectors, rs_tensor, rs_float,
                       out, H, W, Cw, view, out_bf16, tiles, g=None):
    """One launch of the body; returns its cluster size. Without `tiles`
    the weights are laid out for it on the device first; without `g`,
    `bottleneck_geometry` chooses the geometry."""
    B = x_q.shape[0]
    if min(B, H, W) < 1 or Cw % 16:
        raise ValueError(f"{name} kernel needs Cw % 16 == 0, got B={B} "
                         f"H={H} W={W} Cw={Cw}")
    if g is None:
        g = bottleneck_geometry(B, H, W, Cw,
                                _sm_count(x_q.device.index or 0))
    if tiles is None:
        tiles = bottleneck_weight_tiles(*weights)
    for what, t, w, taps in zip(("w1", "w2", "w3"), tiles, weights,
                                (1, 9, 1)):
        K, F = w.shape
        want = padded_width(F) * _round_up(taps * padded_width(K // taps),
                                           _BNECK_SPAN)
        if t.dtype != torch.int8 or t.numel() != want \
                or t.device != x_q.device:
            raise ValueError(f"{name} wants {what}'s tiles as "
                             f"`kmajor_tiles` makes them ({want} int8)")
    ptrs = [_kernel_operand(name, "x_q", x_q)]
    ptrs += [_kernel_operand(name, f"{w}'s tiles", t)
             for w, t in zip(("w1", "w2", "w3"), tiles)]
    ptrs += [_kernel_operand(name, "a scale or bias", v) for v in vectors]
    _launch(name, _lib().icka_int8_bottleneck, x_q, *ptrs,
            None if rs_tensor is None else rs_tensor.data_ptr(), rs_float,
            out.data_ptr(), B, H, W, Cw, *view, int(out_bf16),
            *(g[k] for k in _GEOMETRY_ARGS))
    return g["CL"]


def int8_bottleneck_v2(x_q, w1, w2, w3, s1, b1, s2, b2, s3, b3, res_scale,
                       out_bf16: bool = False, g: int = 1,
                       padded_io: bool = False):
    """Fused int8-resident identity bottleneck.

    x_q (B, H, H, 4Cw) int8 in this block's conv1 activation domain, or with
    `padded_io=True` the padded layout (B, H+2, Wp, 4Cw), Wp = H+2 rounded
    up to 32, whose border content is arbitrary; w1 (4Cw, Cw), w2 (9Cw, Cw),
    w3 (Cw, 4Cw) int8; s*/b* fp32, pre-folded so each requant is one
    multiply and add:
      s1 = a0*w1s/q2, b1 = bias1/q2   (q2 = conv2's act scale)
      s2 = q2*w2s/q3, b2 = bias2/q3   (q3 = conv3's act scale)
      s3 = q3*w3s/qN, b3 = bias3/qN   (qN = the next block's input act
                                       scale, or 1.0 with out_bf16=True)
    res_scale (1,) fp32 = a0/qN. `g` (images per step of the TPU grid,
    B % g == 0) changes no result and no launch here. Returns int8 in the
    next block's domain (or bf16) in the layout of the input; padded
    outputs have zero borders. The kernel computes on the (H, H) grid in
    both layouts and reaches the padded one through strides.

    The kernel reads the weights K-major (`kmajor_tiles`): this wrapper
    lays them out on the device at every call. The model keeps that copy
    beside its weights and calls `_int8_bottleneck_v2_tiled` instead."""
    return _int8_bottleneck_v2_tiled(None, x_q, w1, w2, w3, s1, b1, s2, b2,
                                     s3, b3, res_scale, out_bf16, g,
                                     padded_io)


def _int8_bottleneck_v2_tiled(tiles, x_q, w1, w2, w3, s1, b1, s2, b2, s3,
                              b3, res_scale, out_bf16: bool = False,
                              g: int = 1, padded_io: bool = False):
    """`int8_bottleneck_v2` with the kernel's K-major weights given: `tiles`
    is `bottleneck_weight_tiles(w1, w2, w3)` (None: made here). The kernel
    reads w1..w3 only through `tiles`, and nothing checks that they agree,
    so only a caller that keeps the copy beside its weights passes it
    (`Bottleneck._fused`, with each `ConvBN.kmajor_tiles()`)."""
    name = "int8_bottleneck_v2"
    if x_q.ndim != 4 or w1.ndim != 2:
        raise ValueError(f"{name} wants x_q (B,H,H,4Cw) and w1 (4Cw,Cw)")
    B, Hx, Wx = x_q.shape[:3]
    H = Hx - 2 if padded_io else Hx
    Wp = -(-(H + 2) // 32) * 32
    if Wx != (Wp if padded_io else H):
        raise ValueError(f"{name} takes square grids"
                         + (f" padded to width {Wp}" if padded_io else "")
                         + f", got {tuple(x_q.shape)}")
    vectors = (s1, b1, s2, b2, s3, b3)
    B, Cin, Cw = _bottleneck_shapes(name, x_q, w1, w2, w3, vectors)
    if g < 1 or B % g:
        raise ValueError(f"{name}: batch {B} is not a multiple of g={g}")
    rs = torch.as_tensor(res_scale, dtype=torch.float32,
                         device=x_q.device).reshape(1)
    out_dt = torch.bfloat16 if out_bf16 else torch.int8
    if _on_cpu(name, x_q, w1, w2, w3, *vectors, rs):
        inner = x_q[:, 1:H + 1, 1:H + 1, :] if padded_io else x_q
        out = bottleneck_v2_reference(inner, w1, w2, w3, *vectors, rs,
                                      out_bf16)
        if not padded_io:
            return out
        full = torch.zeros((B, H + 2, Wp, Cin), dtype=out_dt)
        full[:, 1:H + 1, 1:H + 1, :] = out
        return full
    if padded_io:
        out = torch.zeros((B, H + 2, Wp, Cin), dtype=out_dt,
                          device=x_q.device)
        view = (H + 2, Wp, 1, 1)
    else:
        out = torch.empty((B, H, H, Cin), dtype=out_dt, device=x_q.device)
        view = (H, H, 0, 0)
    cl = _bottleneck_launch(name, x_q, (w1, w2, w3), vectors, rs, 0.0, out,
                            H, H, Cw, view, out_bf16, tiles)
    int8_bottleneck_v2.launches += 1
    int8_bottleneck_v2.cluster_launches[cl] += 1
    return out


int8_bottleneck_v2.launches = 0
int8_bottleneck_v2.cluster_launches = dict.fromkeys((1, 2, 4, 8), 0)


def int8_bottleneck(x_q, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                    res_scale: float, out_bf16: bool = False):
    """Fused int8-resident identity bottleneck, `res_scale` a Python float:
    x_q (B, H, W, 4Cw) int8, weights, scales and biases as in
    `int8_bottleneck_v2`, whose weights it also lays out at every call.
    Returns (B, H, W, 4Cw) int8 (or bf16)."""
    return _int8_bottleneck_tiled(None, x_q, w1, w2, w3, s1, b1, s2, b2, s3,
                                  b3, res_scale, out_bf16)


def _int8_bottleneck_tiled(tiles, x_q, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                           res_scale: float, out_bf16: bool = False):
    """`int8_bottleneck` with `tiles` as in `_int8_bottleneck_v2_tiled`."""
    name = "int8_bottleneck"
    if x_q.ndim != 4 or w1.ndim != 2:
        raise ValueError(f"{name} wants x_q (B,H,W,4Cw) and w1 (4Cw,Cw)")
    H, W = x_q.shape[1:3]
    vectors = (s1, b1, s2, b2, s3, b3)
    B, Cin, Cw = _bottleneck_shapes(name, x_q, w1, w2, w3, vectors)
    res_scale = float(res_scale)
    if _on_cpu(name, x_q, w1, w2, w3, *vectors):
        return bottleneck_reference(x_q, w1, w2, w3, *vectors, res_scale,
                                    out_bf16)
    out = torch.empty((B, H, W, Cin), device=x_q.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.int8)
    cl = _bottleneck_launch(name, x_q, (w1, w2, w3), vectors, None,
                            res_scale, out, H, W, Cw, (H, W, 0, 0), out_bf16,
                            tiles)
    int8_bottleneck.launches += 1
    int8_bottleneck.cluster_launches[cl] += 1
    return out


int8_bottleneck.launches = 0
int8_bottleneck.cluster_launches = dict.fromkeys((1, 2, 4, 8), 0)


def int8_stem_pool(patches, w2, scale, bias, out_dtype=torch.bfloat16):
    """Fused dot, epilogue and max-pool of the space-to-depth ResNet stem.

    patches (B, OB, OB, K) int8, the space-to-depth im2col views built by
    `models/resnet.py::StemPoolS2D`; w2 (K, 4F) int8 in the scatter layout
    (sub-pixel-major output columns); scale (4F,) fp32 = act_scale * tiled
    weight scale; bias (4F,) fp32 tiled fused bias. Only the pooled
    (B, OB, OB, F) output is written.

    The kernel reads w2 K-major (`kmajor_tiles(w2)`): this wrapper lays it
    out on the device at every call. `StemPoolS2D` keeps that copy beside
    its weights and calls `_int8_stem_pool_tiled` instead."""
    return _int8_stem_pool_tiled(None, patches, w2, scale, bias, out_dtype)


def _int8_stem_pool_tiled(tiles, patches, w2, scale, bias,
                          out_dtype=torch.bfloat16):
    """`int8_stem_pool` with the kernel's K-major weight given: `tiles` is
    `kmajor_tiles(w2)` (None: made here). The kernel reads w2 only through
    `tiles`, and nothing checks that they agree, so only a caller that keeps
    the copy beside its weights passes it (`StemPoolS2D.forward`, with its
    `kmajor_tiles()`)."""
    name = "int8_stem_pool"
    if patches.ndim != 4 or w2.ndim != 2 \
            or patches.shape[1] != patches.shape[2]:
        raise ValueError(f"{name} wants patches (B,OB,OB,K) and w2 (K,4F)")
    B, OB, _, K = patches.shape
    N = w2.shape[1]
    _want(name, "patches", patches, torch.int8, (B, OB, OB, K))
    _want(name, "w2", w2, torch.int8, (K, N))
    _want(name, "scale", scale, torch.float32, (N,))
    _want(name, "bias", bias, torch.float32, (N,))
    if N % 4:
        raise ValueError(f"{name} wants 4F output columns, got {N}")
    if _on_cpu(name, patches, w2, scale, bias):
        return stem_pool_reference(patches, w2, scale, bias, out_dtype)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel writes bfloat16, not {out_dtype}")
    if min(B, OB) < 1 or K % 16 or N not in (128, 256):
        raise ValueError(f"{name} kernel needs K % 16 == 0 and 4F in "
                         f"(128, 256), got B={B} OB={OB} K={K} 4F={N}")
    g = stem_geometry(B, OB, K, N, _sm_count(patches.device.index or 0))
    if tiles is None:
        tiles = kmajor_tiles(w2)
    want = N * _round_up(padded_width(K), _BNECK_SPAN)
    if tiles.dtype != torch.int8 or tiles.numel() != want \
            or tiles.device != patches.device:
        raise ValueError(f"{name} wants w2's tiles as `kmajor_tiles(w2)` "
                         f"makes them ({want} int8)")
    out = torch.empty((B, OB, OB, N // 4), dtype=out_dtype,
                      device=patches.device)
    _launch(name, _lib().icka_int8_stem_pool, patches,
            _kernel_operand(name, "patches", patches),
            _kernel_operand(name, "w2's tiles", tiles),
            _kernel_operand(name, "scale", scale),
            _kernel_operand(name, "bias", bias),
            out.data_ptr(), B, OB, K, N, g["slots"], g["resident"],
            g["grid"])
    int8_stem_pool.launches += 1
    return out


int8_stem_pool.launches = 0
