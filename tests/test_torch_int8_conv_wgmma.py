"""The int8 stem's and the int8 3x3 conv's wgmma bodies (K5 `int8_stem_pool`
and K3 `int8_conv3x3`, `icka_tpu_torch/kernels/csrc/int8_conv_wgmma.cuh`)
on the CPU.

The bodies run only on a card, so their schedules are emulated here in
PyTorch, byte for byte where they address memory: the TMA boxes as they
land (128-byte swizzled rows; zeros at coordinates outside the image and
past K or C; stale bytes where nothing lands), the K-major weight tiles read
back through their swizzle with only the k-steps that run, the row
to pixel map of a tile with its halo, the stem's pool on the accumulator
layout (the left pixel from lane g - 1, the pixel above from the other row
or from the warp before through its U words, the per-warp output stage read
16 bytes a lane), and K3's nine tap gathers by ldmatrix address, its staged
epilogue rows and every output mode through the byte addresses of its
16-byte loads and stores. Each emulation is held bit-equal to the plain
versions and to the Pallas kernels in interpret mode. Besides: the
geometries, the shared-memory sums against the CUDA source's own
expressions, the tensor maps, the K-major copy `StemPoolS2D` keeps, and
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
from icka_tpu_torch.models.resnet import StemPoolS2D  # noqa: E402

CSRC = Path(tconv.__file__).resolve().parent / "csrc"
SPAN, BLOCK = 128, 64


def _stem_inputs(seed, B, OB, K=432, F=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(-127, 128, (B, OB, OB, K)).astype(np.int8),
            rng.integers(-127, 128, (K, 4 * F)).astype(np.int8),
            rng.uniform(1e-4, 1e-3, (4 * F,)).astype(np.float32),
            rng.normal(0, 0.5, (4 * F,)).astype(np.float32)]


def _conv3_inputs(seed, B, H, W, C, F):
    rng = np.random.default_rng(seed)
    return dict(
        x_pad=rng.integers(-127, 128, (B, H + 2, W + 2, C)).astype(np.int8),
        w_q=rng.integers(-127, 128, (9 * C, F)).astype(np.int8),
        scale=rng.uniform(1e-4, 1e-3, (F,)).astype(np.float32),
        bias=rng.normal(0, 1, (F,)).astype(np.float32),
        residual=rng.normal(0, 1, (B, H, W, F)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(got, want):
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        want, got = want.astype(np.float32), got.float()
    np.testing.assert_array_equal(got.numpy(), want)


# ---- shared memory, as the bodies address it -------------------------------


def land_swizzled(buf, base, rows):
    """TMA's landing of (R, 128) bytes at byte `base` of `buf` with the
    128-byte swizzle (`base` 1024-aligned): row r's 16-byte unit u at unit
    u ^ (r % 8)."""
    R = rows.shape[0]
    r = torch.arange(R)
    unit = torch.arange(8)[None, :] ^ (r[:, None] & 7)
    at = base + r[:, None, None] * SPAN + unit[:, :, None] * 16 \
        + torch.arange(16)[None, None, :]
    buf[at.reshape(-1)] = rows.reshape(R, 8, 16).reshape(-1)


def read_swizzled(buf, base, rows, k0, k1):
    """Bytes k0..k1 of `rows` 128-byte rows at `base`, as a wgmma descriptor
    (start + k0 bytes) reads them through the 128-byte swizzle."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(k0, k1)[None, :]
    return buf[base + r * SPAN + (((k >> 4) ^ (r & 7)) << 4) + (k & 15)]


def weight_span(tiles, nb, c, row0, rows):
    """Rows row0.. of K chunk c of `kmajor_tiles`, one bulk copy's bytes
    read back through the swizzle: (rows, 128)."""
    off = (c * nb + row0 // BLOCK) * BLOCK * SPAN
    return read_swizzled(tiles[off:off + rows * SPAN], 0, rows, 0, SPAN)


# ---- K5: the stem ------------------------------------------------------------


def stem_box(patches, b, i0, j0, sp):
    """The box of span sp anchored at (i0 - 1, j0 - 1), as TMA lands it:
    (64, 128) int8 rows ti * 8 + tj, zeros at pixels outside the image and
    at bytes past K."""
    _, OB, _, K = patches.shape
    box = torch.zeros((8, 8, SPAN), dtype=torch.int8)
    ys = torch.arange(i0 - 1, i0 + 7)[:, None]
    xs = torch.arange(j0 - 1, j0 + 7)[None, :]
    inside = (ys >= 0) & (ys < OB) & (xs >= 0) & (xs < OB)
    k0, k1 = sp * SPAN, min(K, sp * SPAN + SPAN)
    got = patches[b, ys.clamp(0, OB - 1), xs.clamp(0, OB - 1), k0:k1]
    box[..., :k1 - k0][inside] = got[inside]
    return box.reshape(64, SPAN)


def _bf16_words(x):
    """bf16 (..., 2n) -> (..., n) pairs, the 4-byte words of a bf16x2."""
    return x.reshape(*x.shape[:-1], -1, 2)


def stem_tiles(g):
    """(CTA, its k-th tile, the tile): CTA c takes tiles c + k grid, its
    warpgroup k % 2 each k-th one."""
    for c in range(g["grid"]):
        for k in range(-(-(g["ntiles"] - c) // g["grid"])):
            yield c, k, c + k * g["grid"]


def emulate_stem(patches, w2, scale, bias, g, seed=0):
    """The stem body's output, tile by tile in each CTA's order: the boxes
    landed in the slot of the ring of the tile's warpgroup and read back
    through the swizzle, the weight likewise (resident, or landed beside
    the box in the slot), the products over the stages that run, the planes
    on the accumulator layout (rows 16w + 8h + g of the m-block are box
    pixels (2w + h, g)), the neighbours by shuffle and through the U words,
    the output through each warp's stage and its 16-byte stores. Returns
    the output and the count of k-steps run a tile."""
    B, OB, _, K = patches.shape
    N = w2.shape[1]
    F, nsp, nst = N // 4, g["nsp"], g["nstages"]
    JF, PW, UPP = F // 8, F // 2 + 4, F // 8
    slots, sb = g["slots"], g["slot_bytes"]
    tiles = tconv.kmajor_tiles(w2)
    wspan = N * SPAN
    assert tiles.numel() == nsp * wspan
    if g["resident"]:
        # the weight as the bulk copies land it, read back span by span
        wsm = tiles.clone()
        wk = torch.cat([read_swizzled(wsm, sp * wspan, N, 0, SPAN)
                        for sp in range(nsp)], dim=1)
    else:
        assert sb == 64 * SPAN + wspan
    kb = 64 * nst                           # the K bytes the stages run
    stale = torch.Generator().manual_seed(seed)
    out = torch.randn((B, OB, OB, F), generator=stale).bfloat16()
    s = scale.reshape(4, F)
    bb = bias.to(torch.bfloat16).reshape(4, F)
    zero = torch.zeros((), dtype=torch.bfloat16)
    # both warpgroups' rings, stale bytes where nothing has landed
    ring = torch.randint(-127, 128, (2 * slots * sb,), generator=stale,
                         dtype=torch.int32).to(torch.int8)
    w_ = torch.arange(4)[:, None, None]
    h_ = torch.arange(2)[None, :, None]
    g_ = torch.arange(8)[None, None, :]
    # the row <-> pixel map: accumulator row 16w + 8h + g is box row
    # (2w + h) * 8 + g
    assert torch.equal(16 * w_ + 8 * h_ + g_, (2 * w_ + h_) * 8 + g_)
    per_image = g["tiles_x"] ** 2
    for _, k, tile in stem_tiles(g):
        b, rem = divmod(tile, per_image)
        i0, j0 = rem // g["tiles_x"] * 7, rem % g["tiles_x"] * 7
        a, wt = [], []
        for sp in range(nsp):
            q = (k >> 1) * nsp + sp
            at = ((k & 1) * slots + q % slots) * sb
            land_swizzled(ring, at, stem_box(patches, b, i0, j0, sp))
            a.append(read_swizzled(ring, at, 64, 0, SPAN))
            if not g["resident"]:
                ring[at + 64 * SPAN:at + sb] = \
                    tiles[sp * wspan:(sp + 1) * wspan]
                wt.append(read_swizzled(ring, at + 64 * SPAN, N, 0, SPAN))
        a = torch.cat(a, dim=1)
        if not g["resident"]:
            wk = torch.cat(wt, dim=1)
        acc = (a[:, :kb].double() @ wk[:, :kb].double().T).to(torch.int64)
        # the planes: (w, h, g, plane, f)
        accf = acc.to(torch.float32).reshape(4, 2, 8, 4, F)
        y = (accf * s).to(torch.bfloat16) + bb
        y = torch.maximum(y, zero)
        ii, jj = i0 - 1 + 2 * w_ + h_, j0 - 1 + g_
        inside = (ii >= 0) & (ii < OB) & (jj >= 0) & (jj < OB)
        y = torch.where(inside[..., None, None], y, zero)
        pa, pb, pc, pd = y.unbind(3)
        cd, bd = torch.maximum(pc, pd), torch.maximum(pb, pd)
        m4 = torch.maximum(torch.maximum(pa, pb), cd)

        def left(x):                       # __shfl_up_sync(.., 4): lane g-1
            return torch.cat([x[:, :, :1], x[:, :, :-1]], dim=2)
        x1 = left(torch.maximum(bd[:, 1:2], pd[:, 0:1]))[:, 0]
        out1 = torch.maximum(torch.maximum(m4[:, 1], cd[:, 0]), x1)
        u1 = torch.maximum(cd[:, 1], left(pd[:, 1:2])[:, 0])
        out0 = torch.maximum(m4[:, 0], left(bd[:, 0:1])[:, 0])
        # U words [w][jf][lane], lane = 4g + t holding channels 8jf + 2t, +1
        ubuf = torch.full((4 * JF * 32, 2), float("nan")).bfloat16()
        wq, jfq, gq, tq = torch.meshgrid(torch.arange(4), torch.arange(JF),
                                         torch.arange(8), torch.arange(4),
                                         indexing="ij")
        at = (wq * JF + jfq) * 32 + 4 * gq + tq
        ubuf[at.reshape(-1)] = _bf16_words(u1)[wq, gq, 4 * jfq + tq] \
            .reshape(-1, 2)
        wp = (wq - 1).clamp(min=0)
        up = ubuf[((wp * JF + jfq) * 32 + 4 * gq + tq).reshape(-1)] \
            .reshape(4, JF, 8, 4, 2).permute(0, 2, 1, 3, 4).reshape(4, 8, F)
        out0 = torch.maximum(out0, up)
        # each warp's stage: pixel q = 8h + g at words q * PW + 4 jf + t;
        # lane l reads 16-byte unit l % UPP of pixel rd * 32 / UPP + l / UPP
        for w in range(4):
            stage = torch.full((16 * PW, 2), float("nan")).bfloat16()
            for h, o in ((0, out0), (1, out1)):
                gq2, jq, tq2 = torch.meshgrid(torch.arange(8),
                                              torch.arange(JF),
                                              torch.arange(4), indexing="ij")
                stage[((8 * h + gq2) * PW + 4 * jq + tq2).reshape(-1)] = \
                    _bf16_words(o[w])[gq2, 4 * jq + tq2].reshape(-1, 2)
            for rd in range(16 * UPP // 32):
                for lane in range(32):
                    qx, u = rd * (32 // UPP) + lane // UPP, lane % UPP
                    ti, tj = 2 * w + qx // 8, qx % 8
                    i, j = i0 - 1 + ti, j0 - 1 + tj
                    if ti >= 1 and tj >= 1 and i < OB and j < OB:
                        out[b, i, j, 8 * u:8 * u + 8] = \
                            stage[qx * PW + 4 * u:qx * PW + 4 * u + 4] \
                            .reshape(-1)
    return out, 2 * nst


@pytest.mark.parametrize("OB,B,F", [(56, 1, 64), (20, 2, 64), (13, 2, 64),
                                    (13, 1, 32)])
def test_stem_emulation_equals_the_plain_version(OB, B, F):
    """56: the serving stem, whole tiles; 20 and 13: ragged tiles in both
    axes, halos in and out of the image; F = 32: the other width."""
    args = [_t(a) for a in _stem_inputs(OB + F, B, OB, F=F)]
    g = tconv.stem_geometry(B, OB, 432, 4 * F)
    got, ksteps = emulate_stem(*args, g)
    assert ksteps == 14                  # of the 16 k32 steps of 4 spans
    assert torch.equal(got, tconv.stem_pool_reference(*args))


@pytest.mark.parametrize("OB", [20, 13])
def test_stem_emulation_equals_the_pallas_kernel(OB):
    args = _stem_inputs(OB, 1, OB)
    want = jconv.int8_stem_pool(*(jnp.asarray(a) for a in args),
                                interpret=True)
    got, _ = emulate_stem(*(_t(a) for a in args),
                          tconv.stem_geometry(1, OB, 432, 256))
    _equal(got, want)


@pytest.mark.parametrize("K,N", [(48, 256), (400, 256), (432, 256),
                                 (512, 256), (640, 256), (1024, 128),
                                 (1296, 128)])
def test_stem_runs_only_the_k_steps_that_reach_k(K, N):
    """The stages of two k32 steps cover K, at most one step past it; the
    bytes past K read zero in the box and in the weight. K = 640 at 4F =
    256 and 1296 at 128: the weight streams with the patches; 1024 at 128:
    resident, eight spans a tile in a ring of four slots."""
    args = [_t(a) for a in _stem_inputs(K, 1, 8, K=K, F=N // 4)]
    g = tconv.stem_geometry(1, 8, K, N)
    assert g["resident"] == (K <= 512 or (N == 128 and K <= 1280))
    got, ksteps = emulate_stem(*args, g)
    assert 32 * ksteps >= K and 32 * (ksteps - 2) < K
    assert ksteps <= 4 * g["nsp"]
    assert torch.equal(got, tconv.stem_pool_reference(*args))
    box = stem_box(args[0], 0, 0, 0, g["nsp"] - 1)
    assert not box[:, K - SPAN * (g["nsp"] - 1):].any()
    assert not box[:8].any() and not box[::8].any()     # the halo row, col


class _Barrier:
    """An mbarrier: `count` arrivals and the bytes expected complete a
    phase; a wait on parity P passes once the phase of parity P is
    complete (a fresh barrier's "phase -1", of parity 1, counts as
    complete)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.pending -= 1
        self.tx += tx
        self._flip()

    def complete_tx(self, n):
        self.tx -= n
        self._flip()

    def _flip(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


def _stem_ring_programs(nsp, nstages, slots, ntl, shared):
    """The stem body's ring protocol, one CTA of `ntl` tiles: the
    producers' and the two consumer warpgroups' operations on the slots,
    with the slot and parity each computes. `shared`: the two warpgroups on
    one ring of `slots` slots fed by one producer, counting chunks over all
    the CTA's tiles (a tile's chunk q = k nsp + sp), as the body must not;
    else the body's rings, one a warpgroup with a producer of its own (q =
    (k / 2) nsp + sp in warpgroup k % 2's)."""
    def where(k, sp):
        if shared:
            q = k * nsp + sp
            return 0, q % slots, (q // slots) & 1
        q = (k >> 1) * nsp + sp
        return k & 1, q % slots, (q // slots) & 1

    def producer(ks):
        for k in ks:
            for sp in range(nsp):
                r, s, par = where(k, sp)
                yield "wait", ("empty", r, s), par ^ 1
                yield "load", (r, s), (k, sp)

    def consumer(wg):
        for k in range(wg, ntl, 2):
            for st in range(nstages):
                r, s, par = where(k, st >> 1)
                yield "wait", ("full", r, s), par
                yield "read", (r, s), (k, st >> 1)
                pst = st - 1
                if st > 0 and pst & 1:
                    yield "release", where(k, pst >> 1)[:2], (k, pst >> 1)
            last = (nstages - 1) >> 1
            yield "release", where(k, last)[:2], (k, last)

    producers = [producer(range(ntl))] if shared else \
        [producer(range(r, ntl, 2)) for r in (0, 1)]
    return producers + [consumer(0), consumer(1)]


def simulate_stem_ring(nsp, nstages, slots, ntl, seed, shared=False):
    """Runs the protocol with the agents' steps and the TMA loads' landings
    in a random order (loads land in any order: PTX promises none).
    Returns the first fault: a read of a slot whose chunk has not landed,
    a landing over a chunk still being read, or a deadlock; None if
    none."""
    rng = np.random.default_rng(seed)
    rings = 1 if shared else 2
    bars = {(kind, r, s): _Barrier(1) for kind in ("full", "empty")
            for r in range(rings) for s in range(slots)}
    content, reading, flight = {}, {}, []
    progs = _stem_ring_programs(nsp, nstages, slots, ntl, shared)
    nxt = [next(pr, None) for pr in progs]
    while True:
        moves = [("land", i) for i in range(len(flight))]
        moves += [("step", a) for a, op in enumerate(nxt) if op is not None
                  and (op[0] != "wait" or bars[op[1]].passed(op[2]))]
        if not moves:
            return None if not flight and all(op is None for op in nxt) \
                else "deadlock"
        kind, i = moves[rng.integers(len(moves))]
        if kind == "land":
            slot, tag = flight.pop(i)
            if slot in reading:
                return f"{tag} landed over {reading[slot]}, still read"
            content[slot] = tag
            bars[("full", *slot)].complete_tx(1)
            continue
        op, arg, val = nxt[i]
        if op == "load":
            bars[("full", *arg)].arrive(tx=1)
            flight.append((arg, val))
        elif op == "read":
            if content.get(arg) != val:
                return f"read {val} from a slot holding {content.get(arg)}"
            reading[arg] = val
        elif op == "release":
            assert reading.pop(arg) == val
            bars[("empty", *arg)].arrive()
        nxt[i] = next(progs[i], None)


@pytest.mark.parametrize("K,N", [(48, 256), (432, 256), (640, 256),
                                 (1024, 128), (1296, 128)])
def test_stem_ring_protocol_holds_in_any_order(K, N):
    """Each warpgroup's ring: a slot's chunk is read only once it has
    landed, never overwritten while read, and nothing deadlocks, whatever
    the order of the steps and of the loads' landings."""
    g = tconv.stem_geometry(1, 8, K, N)
    for ntl in (1, 2, 5):
        for seed in range(40):
            assert simulate_stem_ring(g["nsp"], g["nstages"], g["slots"],
                                      ntl, seed) is None


def test_stem_ring_protocol_check_sees_a_shared_ring():
    """The same check finds the fault of one ring for both warpgroups: at
    K = 640, 4F = 256 with 3 slots (nsp = 5), warpgroup 1's first chunk
    waits on a parity its slot's barrier shows at once."""
    faults = [simulate_stem_ring(5, 10, 3, 4, seed, shared=True)
              for seed in range(40)]
    assert any(f and f.startswith("read") for f in faults)


# ---- K3: the 3x3 conv ---------------------------------------------------------


def conv3_groups(g):
    """(first span, spans, chunks, channels the box holds, K chunk of each
    chunk) of each group of spans a box round brings: one group of every
    span, whose chunks run over K in order (a chunk may span taps where Cp
    = 64), or groups of sg spans, each chunk one tap's span."""
    spans, sg = g["spans"], g["sg"]
    if g["ngroups"] == 1:
        return [(0, spans, g["kc"], g["Cp"], list(range(g["kc"])))]
    out = []
    for sg0 in range(0, spans, sg):
        n = min(sg, spans - sg0)
        out.append((sg0, n, 9 * n, n * SPAN,
                    [c // n * spans + sg0 + c % n for c in range(9 * n)]))
    return out


def conv3_box(x_pad, b, y0, x0, g, seed, sg0=0, sgn=None):
    """A box round's buffer as TMA leaves it: each of spans sg0.. (sgn of
    them, all by default)'s (TR + 2) x (TC + 2) pixels of x_pad from (y0,
    x0), swizzled, zeros past C and past the image; stale bytes past the
    box in each span's 1024-aligned region."""
    B, Hp, Wp, C = x_pad.shape
    BC, R = g["BC"], g["BC"] * (g["TR"] + 2)
    gen = torch.Generator().manual_seed(seed)
    buf = torch.randint(-127, 128, (g["box_bytes"],), generator=gen,
                        dtype=torch.int32).to(torch.int8)
    r = torch.arange(R)
    y, x = y0 + r // BC, x0 + r % BC
    inside = (y < Hp) & (x < Wp)
    for i in range(g["spans"] if sgn is None else sgn):
        sp = sg0 + i
        rows = torch.zeros((R, SPAN), dtype=torch.int8)
        k1 = max(0, min(C, sp * SPAN + SPAN) - sp * SPAN)
        rows[inside, :k1] = x_pad[b, y[inside], x[inside],
                                  sp * SPAN:sp * SPAN + k1]
        land_swizzled(buf, i * g["span_stride"], rows)
    return buf


def gather_taps(buf, g, mb, c, cg=None):
    """A of the box round's chunk c for m-block mb, as the ldmatrix
    addresses of the body gather it, the box holding cg channels of each
    tap (Cp by default): lane (lane & 15) of warp w gives row 16w + (lane &
    15) of the m-block, 16 bytes at channel offset 16 (lane >> 4) of each
    k-step's 32; rows past the tile's pixels read row 0. (64, 128) int8."""
    TR, TC, BC = g["TR"], g["TC"], g["BC"]
    Cp = g["Cp"] if cg is None else cg
    m = mb * BLOCK + torch.arange(BLOCK)
    ty = m // TC
    arow = torch.where(m < TR * TC, ty * BC + m - ty * TC, 0)
    a = torch.empty((BLOCK, SPAN), dtype=torch.int8)
    for k4 in range(4):
        kb = c * SPAN + 32 * k4
        tp = kb // Cp
        tap = min(tp, 8)
        dy, dx = divmod(tap, 3)
        for half in range(2):
            ch = kb - tp * Cp + 16 * half
            r = arow + dy * BC + dx
            at = (ch >> 7) * g["span_stride"] + r * SPAN \
                + ((((ch >> 4) & 7) ^ (r & 7)) << 4)
            a[:, 32 * k4 + 16 * half:32 * k4 + 16 * half + 16] = \
                buf[at[:, None] + torch.arange(16)[None, :]]
    return a


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8)


def emulate_conv3(x_pad, w_q, scale, bias, residual=None, relu=True,
                  out_scale=None, out_dtype=torch.bfloat16, g=None, seed=0):
    """The 3x3 conv body's output, work item by work item (one pass of one
    tile each): the box round by round (a group of spans each, or all of
    them), each unit's A gathered tap by tap and B from the ring's chunks
    through the swizzle, then the epilogue: (acc * s + b) staged a warp's
    16 rows by 64 channels (rows of 72 fp32 words), lane l taking 32
    channels of row l / 2, the residual and the output through the byte
    addresses of the body's predicated 16-byte loads and stores."""
    B, Hp, Wp, C = x_pad.shape
    H, W, F = Hp - 2, Wp - 2, w_q.shape[1]
    if g is None:
        g = tconv.conv3x3_geometry(B, H, W, C, F)
    TR, TC, Fp, np_ = g["TR"], g["TC"], g["Fp"], g["np"]
    tiles = tconv.kmajor_tiles(w_q, 9)
    nbf = Fp // BLOCK
    out_dt = torch.int8 if out_scale is not None else out_dtype
    osize = torch.empty((), dtype=out_dt).element_size()
    stale = torch.Generator().manual_seed(seed + 1)
    outb = torch.randint(0, 256, (B * H * W * F * osize,), generator=stale,
                         dtype=torch.int32).to(torch.uint8)
    resb = None if residual is None else _bytes(residual)
    rsize = 0 if residual is None else residual.element_size()
    sv = torch.zeros(2 * Fp)
    sv[:F], sv[Fp:Fp + F] = scale, bias
    qmul = torch.tensor(1.0 if out_scale is None else 1.0 / out_scale,
                        dtype=torch.float32)
    MB, NS = g["BM"] // BLOCK, np_ // BLOCK
    for item in range(g["nitems"]):
        tile, q = divmod(item, g["npass"])
        b, rem = divmod(tile, g["nty"] * g["ntx"])
        y0, x0 = rem // g["ntx"] * TR, rem % g["ntx"] * TC
        rounds = [(conv3_box(x_pad, b, y0, x0, g, seed + item, sg0, sgn),
                   nck, cg, kcs)
                  for sg0, sgn, nck, cg, kcs in conv3_groups(g)]
        units = []
        for wg in (0, 1):
            mbw, nsw = tconv.bottleneck_units(MB, NS, wg)
            wm = 2 if NS == 1 or MB % 2 == 0 else 1
            units += [(wg + 2 * i if wm == 2 else i,
                       j if wm == 2 else wg + 2 * j)
                      for i in range(mbw) for j in range(nsw)]
        assert sorted(units) == [(i, j) for i in range(MB)
                                 for j in range(NS)]
        for mb, ns in units:
            nl = q * np_ + ns * BLOCK
            a = torch.cat([gather_taps(buf, g, mb, c, cg)
                           for buf, nck, cg, _ in rounds
                           for c in range(nck)], dim=1)
            bw = torch.cat([weight_span(tiles, nbf, c, nl, BLOCK)
                            for *_, kcs in rounds for c in kcs], dim=1)
            acc = (a.double() @ bw.double().T).to(torch.int64)
            cols = nl + torch.arange(BLOCK)
            staged = acc.to(torch.float32) * sv[cols] + sv[Fp + cols]
            for w in range(4):
                stage = torch.full((16, 72), float("nan"))
                stage[:, :64] = staged[16 * w:16 * w + 16]
                for lane in range(32):
                    r, half = lane >> 1, lane & 1
                    m = mb * BLOCK + 16 * w + r
                    ty, tx = divmod(m, TC)
                    y, x = y0 + ty, x0 + tx
                    ok = m < TR * TC and y < H and x < W
                    pix = ((b * H + y) * W + x) if ok else 0
                    c0 = nl + 32 * half
                    o = stage[r, 32 * half:32 * half + 32].clone()
                    if residual is not None:
                        raw = torch.zeros(128, dtype=torch.uint8)
                        for v in range(8 if rsize == 4 else 4):
                            if ok and c0 + v * (16 // rsize) < F:
                                at = (pix * F + c0) * rsize + 16 * v
                                raw[16 * v:16 * v + 16] = \
                                    resb[at:at + 16]
                        rv = raw.view(residual.dtype)[:32].float()
                        o = o + rv
                    if relu:
                        o = torch.relu(o)
                    if out_dt == torch.int8:
                        o = (o * qmul).round().clamp(-127, 127) \
                            .to(torch.int8)
                    else:
                        o = o.to(out_dt)
                    ob = _bytes(o)
                    per = 16 // osize           # channels a store
                    for v in range(32 // per):
                        if ok and c0 + per * v < F:
                            at = (pix * F + c0) * osize + 16 * v
                            outb[at:at + 16] = ob[16 * v:16 * v + 16]
    return outb.view(out_dt).reshape(B, H, W, F)


CONV3_MODES = {
    "bf16": dict(),
    "bf16_residual": dict(residual=torch.float32),
    "bf16_residual_bf16_norelu": dict(residual=torch.bfloat16, relu=False),
    "fp32": dict(out_dtype=torch.float32),
    "int8": dict(out_scale=0.05),
    "int8_residual_norelu": dict(out_scale=0.031, residual=torch.float32,
                                 relu=False),
}


def _conv3_call(a, mode):
    m = dict(CONV3_MODES[mode])
    res = m.pop("residual", None)
    args = [_t(a[k]) for k in ("x_pad", "w_q", "scale", "bias")]
    r = None if res is None else _t(a["residual"]).to(res)
    return args, dict(residual=r, **m)


@pytest.mark.parametrize("mode", list(CONV3_MODES))
def test_conv3_emulation_every_mode(mode):
    """Ragged tiles (2 x 6 x 5 pixels), C = 16 padded to 64 bytes a tap,
    F = 48 in a 64-channel slice: held to the plain version bit for bit."""
    a = _conv3_inputs(7, 2, 6, 5, 16, 48)
    args, kw = _conv3_call(a, mode)
    got = emulate_conv3(*args, **kw)
    assert torch.equal(got, tconv.conv3x3_reference(*args, **kw))


@pytest.mark.parametrize("mode", ["bf16_residual", "int8_residual_norelu"])
def test_conv3_emulation_equals_the_pallas_kernel(mode):
    a = _conv3_inputs(8, 2, 6, 5, 16, 48)
    args, kw = _conv3_call(a, mode)
    want = jconv.int8_conv3x3(
        *(jnp.asarray(a[k]) for k in ("x_pad", "w_q", "scale", "bias")),
        residual=jnp.asarray(a["residual"]), relu=kw.get("relu", True),
        out_scale=kw.get("out_scale"), interpret=True)
    _equal(emulate_conv3(*args, **kw), want)


# B, H, W, C, F: the card's ragged case (a 7 x 9 grid, C = 32), two spans a
# tap (C = 256) with m-blocks split between the warpgroups, a tap that
# pads to two spans (C = 144), strips of columns with their own halo, a box
# in two groups of 21 and 20 spans (C = 5248)
CONV3_CASES = ((3, 7, 9, 32, 64), (1, 5, 6, 256, 128), (1, 4, 4, 144, 64),
               (1, 3, 100, 16, 32), (1, 4, 4, 5248, 16))


@pytest.mark.parametrize("case", CONV3_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_conv3_emulation_equals_the_plain_version(case):
    B, H, W, C, F = case
    a = _conv3_inputs(sum(case), B, H, W, C, F)
    args, kw = _conv3_call(a, "int8_residual_norelu")
    g = tconv.conv3x3_geometry(B, H, W, C, F)
    if W == 100:
        assert g["TC"] < W and g["BC"] == g["TC"] + 2
    if C == 5248:
        assert (g["spans"], g["sg"], g["ngroups"]) == (41, 21, 2)
    got = emulate_conv3(*args, **kw, g=g)
    assert torch.equal(got, tconv.conv3x3_reference(*args, **kw))


def test_conv3_emulation_at_every_product_size():
    """The tool's `rows` override: 64, 128 and 256 rows a product, with
    the shares each gives (one m-block by four slices, two m-blocks by
    one), the same result."""
    a = _conv3_inputs(3, 1, 18, 18, 32, 256)
    args, kw = _conv3_call(a, "bf16_residual")
    want = tconv.conv3x3_reference(*args, **kw)
    seen = set()
    for rows in (64, 128, 256):
        g = tconv._conv3_geometry(1, 18, 18, 32, 256, 132, rows)
        seen.add((g["BM"], g["np"]))
        assert torch.equal(emulate_conv3(*args, **kw, g=g), want)
    assert seen == {(64, 128), (128, 256), (192, 64)}


# ---- the host's geometry ------------------------------------------------------


def _c_expression(fn, g):
    """The CUDA sources' constants and `fn`'s return expression, evaluated
    with `p` the geometry."""
    consts = {}
    for src in ("int8_bottleneck_wgmma.cuh", "int8_conv_wgmma.cuh"):
        text = (CSRC / src).read_text()
        for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                     text, re.M):
            consts[name] = eval(expr, {}, dict(consts))
    text = (CSRC / "int8_conv_wgmma.cuh").read_text()
    body = re.search(rf"inline int {fn}\(const \w+& p\) \{{\s*return "
                     r"([^;]+);", text).group(1)
    return eval(f"({body})", {}, dict(consts, p=SimpleNamespace(**g)))


@pytest.mark.parametrize("case", [(128, 56, 432, 256), (16, 56, 432, 256),
                                  (2, 13, 432, 128), (1, 8, 640, 256),
                                  (1, 8, 48, 256), (1, 8, 1024, 128),
                                  (1, 8, 8192, 256), (1, 8, 8192, 128)],
                         ids=lambda c: "x".join(map(str, c)))
def test_stem_geometry_and_shared_memory(case):
    B, OB, K, N = case
    g = tconv.stem_geometry(B, OB, K, N)
    assert tconv._stem_smem_bytes(g) == g["smem"] == \
        _c_expression("stem_smem_bytes", g)
    assert g["smem"] <= 232448 and 2 <= g["slots"] <= 4
    assert g["tiles_x"] * 7 >= OB > (g["tiles_x"] - 1) * 7
    assert g["grid"] == min(132, -(-g["ntiles"] // 2))
    assert g["slot_bytes"] == 64 * 128 + (1 - g["resident"]) * N * 128
    assert g["nwb"] == (g["nsp"] if g["resident"] else 1)
    if (K, N) == (432, 256):
        assert g["nsp"] == 4 and g["nstages"] == 7 and g["slots"] == 3
        assert g["resident"] == 1


def test_stem_geometry_at_the_serving_batches():
    """The serving batch fills the card (1024 tiles, 3.9 a warpgroup), and
    B = 128 gives every CTA 62 or 63 tiles."""
    g16 = tconv.stem_geometry(16, 56, 432, 256)
    g128 = tconv.stem_geometry(128, 56, 432, 256)
    assert (g16["ntiles"], g16["grid"]) == (1024, 132)
    assert (g128["ntiles"], g128["grid"]) == (8192, 132)


@pytest.mark.parametrize("N", [128, 256])
def test_stem_geometry_streams_a_weight_shared_memory_cannot_hold(N):
    """The weight stays resident up to the K whose spans leave room for
    two slots a warpgroup, and streams beyond it, at any K."""
    last = 512 if N == 256 else 1280
    for K in (last, last + 16, 65536):
        g = tconv.stem_geometry(1, 56, K, N)
        assert g["resident"] == (K == last)
        assert g["smem"] <= 232448 and g["slots"] >= 2


@pytest.mark.parametrize("case", [(128, 14, 14, 256, 256),
                                  (4, 56, 56, 64, 64), (4, 28, 28, 128, 128),
                                  (4, 7, 7, 512, 512), (3, 7, 9, 32, 64),
                                  (2, 6, 5, 16, 48), (1, 3, 100, 16, 32),
                                  (1, 4, 4, 2048, 64), (2, 5, 5, 64, 512),
                                  (1, 4, 4, 16384, 64), (1, 2, 2, 16, 24576),
                                  (1, 200, 200, 100000, 100000)],
                         ids=lambda c: "x".join(map(str, c)))
def test_conv3_geometry_and_shared_memory(case):
    """Every pass a share each warpgroup has an instance for, every unit
    held once; the box within 256 rows a side; the ring at 2-4 slots and the
    sum within 232,448 bytes, equal to the C side's."""
    g = tconv.conv3x3_geometry(*case)
    assert tconv._conv3_smem_bytes(g) == g["smem"] == \
        _c_expression("conv3_smem_bytes", g)
    assert g["smem"] <= 232448 and 2 <= g["slots"] <= 4
    assert g["TR"] * g["TC"] <= g["BM"] <= 256 and g["BM"] % 64 == 0
    assert g["BC"] <= 256 and g["TR"] + 2 <= 256
    assert g["Fp"] % g["np"] == 0
    MB, NS = g["BM"] // 64, g["np"] // 64
    for wg in (0, 1):
        mbw, nsw = tconv.bottleneck_units(MB, NS, wg)
        wm = 2 if NS == 1 or MB % 2 == 0 else 1
        assert tconv.conv3_shape_ok(mbw, nsw, wm)
        # two or four slices a warpgroup go as one product: neighbours only
        # (the warpgroups split the m-blocks, so each holds every slice)
        assert nsw < 2 or wm == 2
    assert g["span_stride"] % 1024 == 0 and \
        g["span_stride"] >= g["BC"] * (g["TR"] + 2) * 128
    assert g["nitems"] == g["ntiles"] * (g["Fp"] // g["np"])
    assert g["grid"] == min(132, g["nitems"])
    # the box holds every span, or groups of them, whose chunks cover K
    assert g["ngroups"] == -(-g["spans"] // g["sg"])
    assert g["box_bytes"] == g["sg"] * g["span_stride"]
    assert sorted(c for *_, kcs in conv3_groups(g) for c in kcs) == \
        list(range(g["kc"]))
    assert g["ngroups"] == 1 or g["Cp"] % 128 == 0


def test_conv3_geometry_at_the_table_shape():
    """B = 128, 14 x 14, C = F = 256: 7 x 14 tiles (128 rows), each
    warpgroup one m-block by all 256 channels (one n256 product) in one
    pass; the 256-row alternative the tool times beside it: two m-blocks
    by one slice a warpgroup, four passes."""
    g = tconv.conv3x3_geometry(128, 14, 14, 256, 256)
    assert (g["TR"], g["TC"], g["BM"], g["np"], g["ntiles"]) == \
        (7, 14, 128, 256, 256)
    assert [tconv.bottleneck_units(2, 4, wg) for wg in (0, 1)] == \
        [(1, 4), (1, 4)]
    g = tconv._conv3_geometry(128, 14, 14, 256, 256, 132, 256)
    assert (g["TR"], g["TC"], g["BM"], g["np"], g["ntiles"]) == \
        (14, 14, 256, 64, 128)


def test_conv3_geometry_takes_any_width():
    """Channels whose box does not fit come in groups of spans; output
    channels whose scales and biases do not fit read them from a padded
    global copy; the staged layouts of narrower widths are as before."""
    g = tconv.conv3x3_geometry(1, 4, 4, 16384, 64)
    assert (g["sg"], g["ngroups"], g["staged"]) == (32, 4, 1)
    g = tconv.conv3x3_geometry(1, 2, 2, 16, 24576)
    assert (g["ngroups"], g["staged"]) == (1, 0)
    assert tconv.conv3x3_geometry(1, 2, 2, 16, 16384)["staged"] == 1
    for case in ((128, 14, 14, 256, 256), (4, 7, 7, 512, 512)):
        g = tconv.conv3x3_geometry(*case)
        assert (g["ngroups"], g["staged"]) == (1, 1)


def test_tensor_map_geometry():
    """Strides multiples of 16 bytes, each box dimension at most 256, the
    inner box one 128-byte swizzle span."""
    dims, strides, box = tconv.stem_tensor_map_geometry(16, 56, 432)
    assert dims == (432, 56, 56, 16) and box == (128, 8, 8, 1)
    assert all(s % 16 == 0 for s in strides)
    assert strides == (432, 432 * 56, 432 * 56 * 56)
    for case in ((128, 14, 14, 256, 256), (3, 7, 9, 32, 64),
                 (1, 3, 100, 16, 32)):
        B, H, W, C, F = case
        g = tconv.conv3x3_geometry(*case)
        dims, strides, box = tconv.conv3_tensor_map_geometry(B, H, W, C, g)
        assert dims == (C, W + 2, H + 2, B)
        assert all(s % 16 == 0 for s in strides)
        assert box[0] == 128 and all(d <= 256 for d in box)
        assert box[1] * box[2] * 128 * g["spans"] <= g["box_bytes"]


# ---- the weights each entry hands the launch ---------------------------------


def test_stem_kmajor_copy_follows_the_weights():
    """`StemPoolS2D.kmajor_tiles()`: the K-major tiles of its space-to-depth
    weight, out of the state dict, made again after `load_state_dict` and
    after an in-place write, kept otherwise."""
    stem = StemPoolS2D(dtype=torch.bfloat16, quant="int8_static",
                       fused_kernel=True, device="cpu")
    first = stem.kmajor_tiles()
    assert stem.kmajor_tiles() is first
    assert "_tiles" not in stem.state_dict()
    assert torch.equal(first, tconv.kmajor_tiles(stem._s2d_weight(stem.wq)))
    sd = stem.state_dict()
    sd["wq"] = torch.randint(-127, 128, sd["wq"].shape, dtype=torch.int8)
    stem.load_state_dict(sd)
    loaded = stem.kmajor_tiles()
    assert loaded is not first and first.numel() == 256 * 512
    assert torch.equal(loaded, tconv.kmajor_tiles(stem._s2d_weight(sd["wq"])))
    stem.wq.mul_(-1)
    assert torch.equal(stem.kmajor_tiles(),
                       tconv.kmajor_tiles(stem._s2d_weight(-sd["wq"])))


def _fake_launches(monkeypatch, seen):
    """Launches faked: the routing runs as on a card, each launch's
    operands recorded."""
    class Lib:
        icka_int8_stem_pool = icka_int8_conv3x3 = None

    monkeypatch.setattr(tconv, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(tconv, "_launch",
                        lambda what, fn, x, *ptrs: seen.append(ptrs))
    monkeypatch.setattr(tconv, "_lib", lambda: Lib)
    monkeypatch.setattr(tconv, "_sm_count", lambda index: 132)


@pytest.mark.parametrize("name,tiled", [("int8_stem_pool", False),
                                        ("int8_stem_pool", True),
                                        ("int8_conv3x3", False)])
def test_which_weight_tiles_reach_the_launch(monkeypatch, name, tiled):
    """The public wrappers take the JAX layout only and lay out the K-major
    copy for the launch; the stem's private entry passes the copy it is
    given (the 3x3 conv, with no model caller, has none)."""
    public = getattr(tconv, name)
    seen = []

    _fake_launches(monkeypatch, seen)
    monkeypatch.setattr(public, "launches", 0)
    if name == "int8_stem_pool":
        args = [_t(a) for a in _stem_inputs(5, 1, 8)]
        layout = tconv.kmajor_tiles(args[1])
    else:
        a = _conv3_inputs(5, 1, 4, 4, 16, 32)
        args = [_t(a[k]) for k in ("x_pad", "w_q", "scale", "bias")]
        layout = tconv.kmajor_tiles(args[1], 9)
    assert "tiles" not in str(inspect.signature(public))
    assert not hasattr(tconv, "_int8_conv3x3_tiled")
    if tiled:
        tiles = layout.clone()
        tconv._int8_stem_pool_tiled(tiles, *args)
        assert [ptrs[1] for ptrs in seen] == [tiles.data_ptr()]
        with pytest.raises(ValueError, match="tiles"):
            tconv._int8_stem_pool_tiled(layout[:-16].clone(), *args)
    else:
        made = []
        real = tconv.kmajor_tiles
        monkeypatch.setattr(tconv, "kmajor_tiles",
                            lambda *a: made.append(real(*a)) or made[-1])
        public(*args)
        assert len(made) == 1 and torch.equal(made[0], layout)
        assert [ptrs[1] for ptrs in seen] == [made[0].data_ptr()]
    assert public.launches == 1


@pytest.mark.parametrize("F,staged", [(32, True), (24576, False)])
def test_conv3_scale_and_bias_reach_the_launch(monkeypatch, F, staged):
    """Staged in shared memory (no global copy passed), or, for output
    channels too wide for it, a padded global copy passed beside them."""
    seen = []
    _fake_launches(monkeypatch, seen)
    a = _conv3_inputs(6, 1, 2, 2, 16, F)
    args = [_t(a[k]) for k in ("x_pad", "w_q", "scale", "bias")]
    tconv.int8_conv3x3(*args)
    assert tconv.conv3x3_geometry(1, 2, 2, 16, F)["staged"] == staged
    assert (seen[0][4] is None) == staged
