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
counts calls that launched, one launch each. The two bottleneck wrappers
run one body (`csrc/int8_bottleneck_wgmma.cuh`) whose geometry
`bottleneck_geometry` chooses; `<wrapper>.cluster_launches` counts their
launches by the size of the thread block clusters that split a tile's
channels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as tfn

from icka_tpu_torch.kernels import build

_GRID_LIMIT = 65535
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
    lib.icka_int8_conv3x3.argtypes = [p, p, p, p, p, i, p, i,
                                      i, i, i, i, i, i, f, p]
    lib.icka_int8_bottleneck.argtypes = ([p] * 11 + [f] + [p]
                                         + [i] * 18 + [p])
    lib.icka_int8_stem_pool.argtypes = [p] * 5 + [i] * 4 + [p]
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
    round(out * (1/out_scale)) clipped to +-127. Returns (B, H, W, F)."""
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
    out = torch.empty((B, H, W, F), dtype=out_dt, device=x_pad.device)
    _launch(name, _lib().icka_int8_conv3x3, x_pad,
            _kernel_operand(name, "x_pad", x_pad),
            _kernel_operand(name, "w_q", w_q),
            _kernel_operand(name, "scale", scale),
            _kernel_operand(name, "bias", bias),
            None if residual is None
            else _kernel_operand(name, "residual", residual),
            0 if residual is None else _RES_KIND[residual.dtype],
            out.data_ptr(), _OUT_KIND[out_dt], B, H, W, C, F, int(relu),
            1.0 if out_scale is None else 1.0 / out_scale)
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


def _pass_width(channels: int, MB: int) -> int:
    """The widest pass over a CTA's `channels`: a power-of-two count of
    64-channel slices that divides them and that both warpgroups hold."""
    width, ns = _BNECK_BLOCK, 1
    while (channels // _BNECK_BLOCK) % ns == 0 and ns <= channels // 64:
        if all(_shape_ok(*bottleneck_units(MB, ns, wg)) for wg in (0, 1)):
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
    (B, OB, OB, F) output is written."""
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
    if min(B, OB) < 1 or B > _GRID_LIMIT or K % 16 or N % 128 or N > 256:
        raise ValueError(f"{name} kernel needs K % 16 == 0 and 4F in "
                         f"(128, 256), got B={B} OB={OB} K={K} 4F={N}")
    out = torch.empty((B, OB, OB, N // 4), dtype=out_dtype,
                      device=patches.device)
    _launch(name, _lib().icka_int8_stem_pool, patches,
            _kernel_operand(name, "patches", patches),
            _kernel_operand(name, "w2", w2),
            _kernel_operand(name, "scale", scale),
            _kernel_operand(name, "bias", bias),
            out.data_ptr(), B, OB, K, N // 4)
    int8_stem_pool.launches += 1
    return out


int8_stem_pool.launches = 0
