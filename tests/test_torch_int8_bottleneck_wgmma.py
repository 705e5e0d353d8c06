"""The int8 bottleneck's wgmma body (K4 `int8_bottleneck_v2` and K6
`int8_bottleneck`, `icka_tpu_torch/kernels/csrc/int8_bottleneck_wgmma.cuh`)
on the CPU.

The body runs only on a card, so its schedule is emulated here in PyTorch,
byte for byte where it addresses memory: the tiles `bottleneck_geometry`
chooses, x's halo box as TMA lands it (zeros outside the image and past
the channels, stale bytes below it), the weights' K-major tiles read back
through their swizzle chunk by chunk, conv1's interior mask, a1q and a2q
in swizzled rows (`act_offset`) with the zero row, the nine taps' gathers,
the cluster's channel split with each rank's slice written into every
rank's copy, and the epilogues' fp32 arithmetic in the kernel's order. The
emulation is held bit-equal to both plain versions and to the Pallas
kernels in interpret mode. Besides: the geometry at the serving stages, the
shared-memory sum against the CUDA source's own expression, the tensor
map's geometry in both layouts, the K-major copy a `ConvBN` keeps, and
which weight tiles each entry point hands the launch.
"""

import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.kernels import conv as jconv  # noqa: E402
from icka_tpu_torch.kernels import conv as tconv  # noqa: E402
from icka_tpu_torch.models.resnet import ConvBN  # noqa: E402

SOURCE = (Path(tconv.__file__).resolve().parent / "csrc"
          / "int8_bottleneck_wgmma.cuh")
SPAN, BLOCK = 128, 64
# the ResNet-152 stages (H, Cw), at the serving batch and at B=128
STAGES = ((56, 64), (28, 128), (14, 256), (7, 512))


def _inputs(seed, B, H, W, Cw):
    rng = np.random.default_rng(seed)
    Cin = 4 * Cw
    return [rng.integers(-127, 128, (B, H, W, Cin)).astype(np.int8),
            rng.integers(-127, 128, (Cin, Cw)).astype(np.int8),
            rng.integers(-127, 128, (9 * Cw, Cw)).astype(np.int8),
            rng.integers(-127, 128, (Cw, Cin)).astype(np.int8),
            rng.uniform(1e-4, 1e-3, (Cw,)).astype(np.float32),
            rng.normal(0, 1, (Cw,)).astype(np.float32),
            rng.uniform(1e-4, 1e-3, (Cw,)).astype(np.float32),
            rng.normal(0, 1, (Cw,)).astype(np.float32),
            rng.uniform(1e-4, 1e-3, (Cin,)).astype(np.float32),
            rng.normal(0, 1, (Cin,)).astype(np.float32)]


# ---- the emulation ---------------------------------------------------------


def act_offset(row, col, Cwp):
    """`act_offset` of the CUDA source: byte `col` of row `row` of a1q or
    a2q, its 16-byte units XOR-swizzled by the row."""
    x = row & 7 if Cwp >= 128 else (row >> 1) & 3
    return row * Cwp + (((col >> 4) ^ x) << 4) + (col & 15)


def weight_chunk(tiles, nb, c, row0, rows):
    """(rows, 128) bytes of K chunk c of K-major rows row0.. as the ring's
    slot holds them after one bulk copy, read back through the 128-byte
    swizzle as wgmma reads them."""
    off = (c * nb + row0 // BLOCK) * BLOCK * SPAN
    t = tiles[off:off + rows * SPAN].reshape(rows, 8, 16)
    r = torch.arange(rows)
    unit = torch.arange(8)[None, :] ^ (r[:, None] & 7)
    return t[r[:, None], unit].reshape(rows, SPAN)


def _requant(acc, s, b):
    v = torch.relu(acc.to(torch.float32) * s + b)
    return v.round().clamp(0, 127).to(torch.int8)


def emulate(store, view, H, W, w, vectors, rs, g, out_bf16, seed=0):
    """The body's result in the storage layout of `store` (B, Hs, Ws, 4Cw)
    int8 whose (H, W) grid sits at view = (Hs, Ws, oy, ox). `w` are the
    three weights in the JAX layout, `g` a `bottleneck_geometry`."""
    B, Hs, Ws, Cin = store.shape
    _, _, oy, ox = view
    Cw, Cwp, CL = Cin // 4, g["Cwp"], g["CL"]
    TR, TC, BC, cpad = g["TR"], g["TC"], g["BC"], g["cpad"]
    BM1, BM = g["BM1"], g["BM"]
    s1, b1, s2, b2, s3, b3 = vectors
    tiles = tconv.bottleneck_weight_tiles(*w)
    nb12, nb3 = Cwp // BLOCK, tconv.padded_width(Cin) // BLOCK
    n12, n3 = Cwp // CL, Cin // CL
    kc1, kc2, kc3 = (-(-k // SPAN) for k in (Cin, 9 * Cwp, Cwp))
    stale = torch.Generator().manual_seed(seed)
    out = torch.randint(-127, 128, store.shape, generator=stale,
                        dtype=torch.int32).to(
        torch.bfloat16 if out_bf16 else torch.int8)
    if (oy, ox) != (0, 0):
        out.zero_()                 # the padded layout's zero borders
    grid = store[:, oy:oy + H, ox:ox + W]

    for tile in range(g["ntiles"]):
        b, rem = divmod(tile, g["nty"] * g["ntx"])
        y0, x0 = rem // g["ntx"] * TR, rem % g["ntx"] * TC
        xb = x0 - 1 if cpad else 0
        # x's halo box, (TR + 2) x BC pixels by the chunks' channels, as
        # TMA lands it in conv1's rows; stale bytes below the box
        box = torch.zeros((TR + 2, BC, kc1 * SPAN), dtype=torch.int8)
        ys = torch.arange(y0 - 1, y0 + TR + 1)
        xs = torch.arange(xb, xb + BC)
        yi, xi = ys[:, None], xs[None, :]
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        box[..., :Cin][inside] = grid[b, yi.clamp(0, H - 1),
                                      xi.clamp(0, W - 1)][inside]
        a1 = torch.randint(-127, 128, (BM1, kc1 * SPAN), generator=stale,
                           dtype=torch.int32).to(torch.int8)
        a1[:(TR + 2) * BC] = box.reshape(-1, kc1 * SPAN)
        # every rank's copies of a1q and a2q: rows of Cwp bytes, swizzled,
        # a1q with its zero row
        a1q = [torch.zeros((BM1 + 1) * Cwp, dtype=torch.int8)
               for _ in range(CL)]
        a2q = [torch.zeros(BM * Cwp, dtype=torch.int8) for _ in range(CL)]
        hi = torch.arange(BM1)
        hy, hx = hi // BC, hi % BC
        y, x = y0 - 1 + hy, xb + hx
        row_ok = (hy < TR + 2) & (y >= 0) & (y < H) & (x >= 0) & (x < W)

        def exchange(copies, rows, col0, q, ncols):
            """Rank r's quantised (rows, ncols) block into every copy."""
            cols = col0 + torch.arange(ncols)
            at = act_offset(torch.arange(q.shape[0])[:, None],
                            cols[None, :], Cwp)
            for copy in copies:
                copy[at.reshape(-1)] = q.reshape(-1)

        for r in range(CL):                     # conv1, rank by rank
            for q in range(n12 // g["np1"]):
                row0 = r * n12 + q * g["np1"]
                bw = torch.cat([weight_chunk(tiles[0], nb12, c, row0,
                                             g["np1"])
                                for c in range(kc1)], dim=1)
                acc = (a1.double() @ bw.double().T).to(torch.int64)
                n = row0 + torch.arange(g["np1"])
                real = n < Cw
                sc = torch.where(real, s1[n.clamp(max=Cw - 1)], 0.0)
                bi = torch.where(real, b1[n.clamp(max=Cw - 1)], 0.0)
                qv = _requant(acc, sc, bi)
                qv[~row_ok] = 0
                qv[:, ~real] = 0
                exchange(a1q, BM1, row0, qv, g["np1"])
        # conv2's A: each pixel's nine taps, gathered row by row
        m = torch.arange(BM)
        ty = torch.where(m < TR * TC, m // TC, -1)
        tx = m - ty.clamp(min=0) * TC
        kb = torch.arange(kc2 * SPAN)
        tap, ch = kb // Cwp, kb % Cwp
        dy, dx = tap // 3, tap % 3
        hxg = tx[:, None] + dx[None, :] - 1 + cpad
        valid = (ty[:, None] >= 0) & (hxg >= 0) & (hxg < BC) & (tap < 9)
        rows = torch.where(valid, (ty[:, None] + dy[None, :]) * BC + hxg,
                           BM1)
        a1_at = act_offset(rows, ch[None, :].expand_as(rows), Cwp)
        for r in range(CL):
            a2 = a1q[r][a1_at]
            a2[~(tap < 9).expand_as(a2)] = 0     # K past the 9 taps
            for q in range(n12 // g["np2"]):
                row0 = r * n12 + q * g["np2"]
                bw = torch.cat([weight_chunk(tiles[1], nb12, c, row0,
                                             g["np2"])
                                for c in range(kc2)], dim=1)
                acc = (a2.double() @ bw.double().T).to(torch.int64)
                n = row0 + torch.arange(g["np2"])
                real = n < Cw
                qv = _requant(acc, torch.where(real, s2[n.clamp(max=Cw - 1)],
                                               0.0),
                              torch.where(real, b2[n.clamp(max=Cw - 1)],
                                          0.0))
                qv[:, ~real] = 0
                exchange(a2q, BM, row0, qv, g["np2"])
        for r in range(1, CL):
            assert torch.equal(a1q[r], a1q[0]) and torch.equal(a2q[r], a2q[0])
        # conv3 and its epilogue, at the tile's pixels inside the image
        kb3 = torch.arange(kc3 * SPAN)
        a3 = torch.where(kb3[None, :] < Cwp,
                         a2q[0][act_offset(m[:, None],
                                           kb3.clamp(max=Cwp - 1)[None, :],
                                           Cwp)], torch.zeros((), dtype=torch.int8))
        oty, otx = m // TC, m % TC
        oy_, ox_ = y0 + oty, x0 + otx
        ok = (m < TR * TC) & (oy_ < H) & (ox_ < W)
        for r in range(CL):
            for q in range(n3 // g["np3"]):
                row0 = r * n3 + q * g["np3"]
                bw = torch.cat([weight_chunk(tiles[2], nb3, c, row0,
                                             g["np3"])
                                for c in range(kc3)], dim=1)
                acc = (a3.double() @ bw.double().T).to(torch.int64)
                n = row0 + torch.arange(g["np3"])
                res = grid[b, oy_[ok], ox_[ok]][:, n].to(torch.float32) * rs
                v = acc[ok].to(torch.float32) * s3[n] + b3[n]
                v = torch.relu(v + res)
                v = v.to(torch.bfloat16) if out_bf16 else \
                    v.round().clamp(0, 127).to(torch.int8)
                out[b, oy_[ok] + oy, ox_[ok] + ox, row0:row0 + g["np3"]] = v
    return out


def _emulated(args, res_scale, out_bf16, padded, W=None, sms=132):
    x = torch.from_numpy(args[0])
    B, H, Wx, Cin = x.shape
    Cw = Cin // 4
    w = [torch.from_numpy(a) for a in args[1:4]]
    vectors = [torch.from_numpy(a) for a in args[4:]]
    if padded:
        Wp = -(-(H + 2) // 32) * 32
        store = torch.from_numpy(np.random.default_rng(9).integers(
            -127, 128, (B, H + 2, Wp, Cin)).astype(np.int8))
        store[:, 1:H + 1, 1:Wx + 1] = x
        view = (H + 2, Wp, 1, 1)
    else:
        store, view = x, (H, Wx, 0, 0)
    g = tconv.bottleneck_geometry(B, H, Wx, Cw, sms)
    rs = torch.tensor(res_scale, dtype=torch.float32)
    return emulate(store, view, H, Wx, w, vectors, rs, g, out_bf16), g


def _equal(got, want):
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        want, got = want.astype(np.float32), got.float()
    np.testing.assert_array_equal(got.numpy(), want)


# B, H, W, Cw: ragged tiles, the K6 grid (5, 7), strips of whole rows with
# halo rows in and out of the image, Cw whose rows pad (16, 48), one tile
CASES = ((2, 6, 6, 16), (3, 5, 7, 16), (2, 9, 9, 32), (2, 14, 14, 16),
         (2, 12, 12, 48))


@pytest.mark.parametrize("out_bf16", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_emulation_equals_the_plain_versions(case, out_bf16):
    """Both layouts where the grid is square (K4), the plain one for K6's
    non-square grids; against `bottleneck_reference` bit for bit."""
    B, H, W, Cw = case
    args = _inputs(sum(case), B, H, W, Cw)
    t = [torch.from_numpy(a) for a in args]
    want = tconv.bottleneck_reference(*t, 0.37, out_bf16)
    for padded in ((False, True) if H == W else (False,)):
        got, _ = _emulated(args, 0.37, out_bf16, padded)
        if padded:
            inner = got[:, 1:H + 1, 1:W + 1]
            assert torch.equal(inner, want)
            got[:, 1:H + 1, 1:W + 1] = 0
            assert not got.float().any()     # pad columns never stored
        else:
            assert torch.equal(got, want)
    if H == W:
        rs = torch.tensor([0.37])
        assert torch.equal(tconv.bottleneck_v2_reference(*t, rs, out_bf16),
                           want)


@pytest.mark.parametrize("out_bf16", [False, True])
def test_emulation_equals_the_pallas_kernels(out_bf16):
    """K4 in the padded layout and K6 on a non-square grid, against the
    JAX package's Pallas kernels in interpret mode."""
    args = _inputs(3, 2, 8, 8, 16)
    x = args[0]
    Wp = 32
    xp = np.random.default_rng(9).integers(
        -127, 128, (2, 10, Wp, 64)).astype(np.int8)
    xp[:, 1:9, 1:9] = x
    want = jconv.int8_bottleneck_v2(*(jnp.asarray(a) for a in [xp] + args[1:]),
                                    0.37, out_bf16=out_bf16, g=2,
                                    padded_io=True, interpret=True)
    got, _ = _emulated(args, 0.37, out_bf16, True)
    _equal(got, want)
    args = _inputs(4, 2, 5, 7, 16)
    want = jconv.int8_bottleneck(*(jnp.asarray(a) for a in args),
                                 res_scale=0.37, out_bf16=out_bf16,
                                 interpret=True)
    got, _ = _emulated(args, 0.37, out_bf16, False)
    _equal(got, want)


@pytest.mark.parametrize("case", [(1, 5, 5, 128, 2), (1, 3, 3, 256, 4)],
                         ids=["CL2", "CL4"])
def test_cluster_split_and_exchange(case):
    """Clusters of 2 and 4 CTAs each computing a slice of a1q, a2q and the
    output, every rank's copy equal after the exchange, the result the
    plain version's."""
    B, H, W, Cw, CL = case
    args = _inputs(CL, B, H, W, Cw)
    got, g = _emulated(args, 0.37, False, False, sms=2 * CL)
    assert g["CL"] == CL
    t = [torch.from_numpy(a) for a in args]
    assert torch.equal(got, tconv.bottleneck_reference(*t, 0.37))


def test_column_tiles_with_their_own_halo():
    """A grid too wide for whole rows: strips of columns whose halo columns
    conv1 computes and masks where they fall outside the image."""
    args = _inputs(7, 1, 3, 100, 16)
    got, g = _emulated(args, 0.37, True, False)
    assert g["cpad"] == 1 and g["TC"] < 100 and g["BC"] == g["TC"] + 2
    t = [torch.from_numpy(a) for a in args]
    assert torch.equal(got, tconv.bottleneck_reference(*t, 0.37, True))


# ---- the host's geometry ---------------------------------------------------

# (TR, TC, BM1, BM, CL) by stage, at the serving batch and at B=128
WANT = {16: ((2, 56, 256, 128, 1), (4, 28, 192, 128, 1), (7, 14, 128, 128, 2),
             (7, 7, 64, 64, 4)),
        128: ((2, 56, 256, 128, 1), (4, 28, 192, 128, 1),
              (7, 14, 128, 128, 1), (7, 7, 64, 64, 1))}


@pytest.mark.parametrize("B", [16, 128])
@pytest.mark.parametrize("stage", range(4))
def test_geometry_at_the_serving_stages(B, stage):
    """Whole rows a tile, the halo in conv1's rows; clusters only where the
    tiles leave the 132 SMs idle (layer3 and layer4 at B=16); every pass a
    share each warpgroup has an instance for, every (m-block, slice) unit
    held once; the ring at 2-4 slots within 232,448 bytes. Clusters fill
    at most half the SMs."""
    H, Cw = STAGES[stage]
    g = tconv.bottleneck_geometry(B, H, H, Cw, 132)
    assert (g["TR"], g["TC"], g["BM1"], g["BM"], g["CL"]) == WANT[B][stage]
    assert g["TR"] * g["TC"] <= g["BM"] and (g["TR"] + 2) * g["BC"] <= g["BM1"]
    assert g["ntiles"] * g["CL"] <= 66 or g["CL"] == 1
    assert g["ntiles"] * 2 * g["CL"] > 66 or g["CL"] == 8
    Cin = 4 * Cw
    for np_, n, MB in ((g["np1"], g["Cwp"] // g["CL"], g["BM1"] // 64),
                       (g["np2"], g["Cwp"] // g["CL"], g["BM"] // 64),
                       (g["np3"], Cin // g["CL"], g["BM"] // 64)):
        assert n % np_ == 0 and np_ % 64 == 0
        seen = []
        for wg in (0, 1):
            mbw, nsw = tconv.bottleneck_units(MB, np_ // 64, wg)
            assert tconv._shape_ok(mbw, nsw) and mbw * nsw <= 2
            wm = 2 if np_ // 64 == 1 or MB % 2 == 0 else 1
            seen += [(wg + 2 * i if wm == 2 else i,
                      j if wm == 2 else wg + 2 * j)
                     for i in range(mbw) for j in range(nsw)]
        assert sorted(seen) == [(i, j) for i in range(MB)
                                for j in range(np_ // 64)]
    assert 2 <= g["slots"] <= 4 and g["smem"] <= 232448


def _c_smem_bytes(g):
    """The CUDA source's `smem_bytes` expression and constants, evaluated."""
    text = SOURCE.read_text()
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                 re.M):
        consts[name] = eval(expr, {}, dict(consts))
    body = re.search(r"inline int smem_bytes\(const Args& p\) \{\s*return "
                     r"([^;]+);", text).group(1)
    return eval(f"({body})", {}, dict(consts, p=SimpleNamespace(**g)))


@pytest.mark.parametrize("case", [(16, 56, 56, 64), (16, 14, 14, 256),
                                  (128, 7, 7, 512), (2, 5, 7, 16),
                                  (1, 3, 100, 16), (2, 5, 5, 1024)],
                         ids=lambda c: "x".join(map(str, c)))
def test_shared_memory_sum_equals_the_c_side(case):
    g = tconv.bottleneck_geometry(*case)
    assert tconv._bottleneck_smem_bytes(g) == g["smem"] == _c_smem_bytes(g)
    assert g["smem"] <= 232448
    assert g["slot_bytes"] == 128 * max(g["BM1"] + g["np1"], g["np2"],
                                        g["np3"])


def test_geometry_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        tconv.bottleneck_geometry(1, 56, 56, 2048)


@pytest.mark.parametrize("case,padded", [
    ((16, 56, 56, 64), False), ((16, 56, 56, 64), True),
    ((16, 14, 14, 256), False), ((16, 14, 14, 256), True),
    ((4, 7, 7, 512), True), ((3, 5, 7, 16), False), ((1, 3, 100, 16), False)],
    ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else
    ("padded" if c else "plain"))
def test_tensor_map_geometry(case, padded):
    """Strides multiples of 16 bytes, each box dimension at most 256, the
    inner box one 128-byte swizzle span; the box holds the halo rows and
    fits conv1's rows. The padded layout is K4's, on square grids."""
    B, H, W, Cw = case
    g = tconv.bottleneck_geometry(B, H, W, Cw)
    view = (H + 2, -(-(H + 2) // 32) * 32, 1, 1) if padded else (H, W, 0, 0)
    dims, strides, box = tconv.x_tensor_map_geometry(B, H, W, Cw, view, g)
    assert dims == (4 * Cw, W, H, B)
    assert all(s % 16 == 0 for s in strides)
    assert strides[1] == view[1] * strides[0]
    assert strides[2] == view[0] * strides[1]
    assert box[0] == 128 and all(d <= 256 for d in box)
    assert box[1] * box[2] <= g["BM1"] and box[2] == g["TR"] + 2


@pytest.mark.parametrize("taps,cin,F", [(1, 256, 64), (9, 48, 48),
                                        (1, 16, 64), (9, 256, 256)])
def test_kmajor_tiles_read_back(taps, cin, F):
    """Chunk by chunk through the swizzle, the tiles give the weight
    K-major, each tap's channels and the rows padded with zeros."""
    rng = np.random.default_rng(taps + cin)
    wq = torch.from_numpy(rng.integers(-127, 128, (taps * cin, F))
                          .astype(np.int8))
    tiles = tconv.kmajor_tiles(wq, taps)
    cp, fp = tconv.padded_width(cin), tconv.padded_width(F)
    kc = -(-taps * cp // 128)
    got = torch.cat([weight_chunk(tiles, fp // 64, c, 0, fp)
                     for c in range(kc)], dim=1)
    want = torch.zeros((fp, kc * 128), dtype=torch.int8)
    want[:F, :taps * cp] = torch.nn.functional.pad(
        wq.reshape(taps, cin, F).permute(2, 0, 1), (0, cp - cin)) \
        .reshape(F, taps * cp)
    assert torch.equal(got, want)


def test_kmajor_copy_follows_the_weights():
    """The copy a `ConvBN` keeps: out of the state dict, made again after
    `load_state_dict` and after an in-place write, kept otherwise."""
    conv = ConvBN(64, 48, 3, quant="int8_static", device="cpu")
    first = conv.kmajor_tiles()
    assert conv.kmajor_tiles() is first
    assert "_tiles" not in conv.state_dict()
    sd = conv.state_dict()
    sd["wq"] = torch.randint(-127, 128, sd["wq"].shape, dtype=torch.int8)
    conv.load_state_dict(sd)
    loaded = conv.kmajor_tiles()
    assert loaded is not first
    assert torch.equal(loaded, tconv.kmajor_tiles(sd["wq"], 9))
    conv.wq.mul_(-1)
    assert torch.equal(conv.kmajor_tiles(),
                       tconv.kmajor_tiles(-sd["wq"], 9))


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("name", ["int8_bottleneck_v2", "int8_bottleneck"])
def test_which_weight_tiles_reach_the_launch(monkeypatch, name, tiled):
    """The public wrappers take the JAX layout only and leave the K-major
    copy to the launch, which makes it from w1..w3; the private entries
    that the model calls pass the copy they are given. Launches are faked:
    the routing runs as on a card."""
    public = getattr(tconv, name)
    private = getattr(tconv, f"_{name}_tiled")
    seen = []

    def launch(name, x_q, weights, vectors, rs_tensor, rs_float, out, H, W,
               Cw, view, out_bf16, tiles, g=None):
        seen.append(tiles)
        return 1

    monkeypatch.setattr(tconv, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(tconv, "_bottleneck_launch", launch)
    monkeypatch.setattr(public, "launches", 0)
    monkeypatch.setattr(public, "cluster_launches",
                        dict.fromkeys((1, 2, 4, 8), 0))
    args = [torch.from_numpy(a) for a in _inputs(5, 1, 3, 3, 16)]
    rs = torch.tensor([0.37]) if name == "int8_bottleneck_v2" else 0.37
    assert "weight_tiles" not in str(inspect.signature(public))
    if tiled:
        tiles = tconv.bottleneck_weight_tiles(*args[1:4])
        private(tiles, *args, rs)
        assert seen == [tiles]
    else:
        public(*args, rs)
        assert seen == [None]
    assert (public.launches, public.cluster_launches[1]) == (1, 1)
