// The int8 identity bottleneck for Hopper (sm_90a) in one launch: int8
// wgmma on TMA-fed shared memory, the intermediates a1q and a2q kept on
// chip, thread block clusters that split the channels where the spatial
// tiles alone leave the card idle.
//
// Replaces the TPU kernels `int8_bottleneck_v2` (icka_tpu/kernels/conv.py:
// 280-377, `_bneck_v2_kernel`) and `int8_bottleneck` (:178-204): for every
// output pixel of an NHWC image x (int8, 4Cw channels)
//
//     a1q = clip(rint(relu(x . w1 * s1 + b1)), 0, 127)        1x1, Cw
//     a2q = clip(rint(relu(taps3x3(a1q) . w2 * s2 + b2)), 0, 127)  3x3, Cw
//     out = relu((a2q . w3 * s3 + b3) + x * res_scale)        1x1, 4Cw
//
// then int8 (rint, clipped to [0, 127]) or bf16, bit-equal to the plain
// version (`bottleneck_reference` in icka_tpu_torch/kernels/conv.py):
// integer sums are exact in any order; each multiply and add is a separate
// round-to-nearest operation (__fmul_rn, __fadd_rn, never an FMA) in the
// reference's order; rounding is half to even (rintf).
//
// What bounds it: at B = 128 the block is bound by operations (layer3:
// 55.9 GOP against 52.5 MB, 0.028 ms at the int8 tensor-core peak), at the
// serving batch of 16 by bytes at layer1-2 and by operations at layer3-4,
// each a few microseconds. So the products run on wgmma, the only way to
// the card's int8 rate, a1q and a2q never leave the SM, and the weights,
// which every tile needs whole, stream from L2 through TMA with no thread
// spending instructions on the copies.
//
// The design. A tile is TR rows by TC columns of output pixels of one
// image (full rows where three rows fit the 256 rows of conv1's product)
// plus the one-pixel halo conv2 reads. A cluster of CL CTAs (1, 2, 4 or 8)
// owns a tile; a persistent grid of clusters walks the tiles. CTA rank r
// computes channels [r Cwp / CL, (r + 1) Cwp / CL) of a1q and a2q and
// [r 4Cw / CL, ...) of the output, and writes its a1q and a2q channels
// into every peer's shared memory, so that each CTA holds the whole of
// both; after each product a named barrier of the CTA's consumers, and in
// a cluster an mbarrier in each CTA that one thread of every CTA arrives
// on, orders the exchange.
//   - A producer warpgroup, one thread working, its registers given to the
//     consumers (setmaxnreg), streams the CTA's operands through a ring of
//     shared-memory slots (a full and an empty barrier each), in the order
//     the consumers take them, across tiles: conv1's K chunks (128 bytes of
//     channels: x's halo box by a 4-D TMA load over the NHWC view, rows and
//     columns outside the image arriving as zeros; beside it the CTA's rows
//     of w1), then w2's chunks, then w3's.
//   - The weights are stored once, K-major (8-bit wgmma reads K-major
//     only), zero-padded to whole chunks, cut into tiles of 64 rows of 128
//     bytes, 128-byte swizzled as TMA would land them, so one bulk copy
//     brings a contiguous run of tiles (`kmajor_tiles` in
//     icka_tpu_torch/kernels/conv.py makes them).
//   - Two consumer warpgroups share each product, as units of one m64
//     block by one n64 slice (wgmma m64n64k32 s8), at most two units a
//     warpgroup (with four, ptxas serialised every wgmma for want of
//     registers): conv1 from shared memory through descriptors (A the x
//     box, B w1), one chunk's products in flight while the next chunk's
//     are issued; conv2 and conv3 with A in registers, loaded by ldmatrix
//     (any 16-byte row: conv2's nine taps gather the a1q row of each
//     pixel's neighbour, a zero row beyond the tile's columns), B from the
//     ring, each chunk's products awaited before the next chunk's A is
//     loaded (the other warpgroup's run meanwhile).
//   - The code around the products has no branch ptxas cannot prove
//     uniform (arrivals and stores are predicated inside the PTX, the taps
//     stepped by selects): otherwise it serialises every wgmma (C7520).
//   - Epilogues on the accumulator registers, the scales and biases staged
//     in shared memory once a kernel: conv1's writes a1q, exactly 0 at
//     halo pixels outside the image (the TPU kernel's interior mask:
//     without it conv1's bias would leak into conv2), conv2's writes a2q,
//     both as 4-byte words into swizzled rows of Cwp bytes in every CTA of
//     the cluster; conv3's stages each warp's (acc * s3 + b3) through
//     shared memory so that a lane takes 32 channels of one pixel: the
//     int8 residual, read again from x (L2, in flight under the products),
//     and the output go 16 bytes a load and a store, through the view's
//     strides (the plain or the padded layout), never to a pad column.
//
// What holds it back (PERF.md): the epilogues, 56-75% of a tile's time at
// B = 128, run by both warpgroups at once, so the tensor cores idle
// through them; the conv2 main loop's per-chunk waits.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "ptx.cuh"
#include "tensor_map.cuh"

namespace icka_bneck {

using namespace icka_ptx;

constexpr int kConsumerThreads = 256;           // two warpgroups
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads + 128; // and the producer's
// Registers a thread at launch (the launch bounds give ptxas this count:
// 65,536 over 384 threads), what the producer warpgroup keeps and what each
// consumer warpgroup takes: the producer's release of (168 - 56) x 128
// registers pays exactly for the consumers' rise, so setmaxnreg.inc never
// waits on registers that do not exist. With 24 or 40 for the producer,
// its loop spilled.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kSpan = 128;        // bytes of K a chunk: one swizzle span
constexpr int kBlock = 64;        // rows of an m-block, an n-slice, a tile
constexpr int kTileBytes = kBlock * kSpan;
constexpr int kSwizzleAtom = 8 * kSpan;
constexpr int kMaxSlots = 4;
constexpr int kMaxRows = 256;     // conv1's rows (a TMA box's rows too)
constexpr int kMaxOutRows = 128;  // conv2's and conv3's rows
constexpr int kSmemLimit = 232448;
// conv3's epilogue stages a warp's 16 rows x 64 channels of fp32 through
// shared memory; rows of 72 words, so that the fragments' 8-byte stores of
// a half-warp meet 32 banks once
constexpr int kStagePitch = 72;
constexpr int kStageBytes = kConsumerWarps * 16 * kStagePitch * 4;

// The width a1q and a2q rows take (and each tap of w2's K): a swizzle of
// 16-byte units that stays inside the row needs 4 units or a multiple of 8
__host__ __device__ constexpr int padded_width(int c) {
  return c <= 64 ? 64 : (c + 127) / 128 * 128;
}

struct Args {
  const int8_t* x;           // storage: (B, Hs, Ws, 4Cw), the grid at (oy, ox)
  const int8_t* w1t;         // K-major tiles (`kmajor_tiles`)
  const int8_t* w2t;
  const int8_t* w3t;
  const float *s1, *b1, *s2, *b2, *s3, *b3;
  const float* rs_ptr;       // res_scale on the device, or null
  float rs_val;              // res_scale from the host
  void* out;                 // storage as x's
  int B, H, W, Cw;
  int Hs, Ws, oy, ox;
  int out_bf16;
  int TR, TC;                // output rows and columns a tile
  int BM1, BM;               // rows of conv1's product, of conv2's and 3's
  int CL;                    // CTAs a cluster
  int np1, np2, np3;         // channels a pass of conv1, conv2, conv3
  int slots;                 // of the ring
  // derived (`derive`)
  int Cwp, BC, cpad, nty, ntx, ntiles, slot_bytes;
};

// A warpgroup's share of one pass of a product over MB m-blocks and NS
// n-slices: the two warpgroups split the m-blocks (wm = 2) where they are
// even in number or there is one slice, else the slices. Uniform in a
// warpgroup.
struct Units {
  int mbw, nsw, wm, wg;
  __host__ __device__ Units(int MB, int NS, int wg_) : wg(wg_) {
    wm = (NS == 1 || MB % 2 == 0) ? 2 : 1;
    mbw = wm == 2 ? (MB - wg + 1) / 2 : MB;
    nsw = wm == 2 ? NS : (NS - wg + 1) / 2;
    if (mbw <= 0 || nsw <= 0) mbw = nsw = 0;
  }
  __device__ int mb(int i) const { return wm == 2 ? wg + 2 * i : i; }
  __device__ int ns(int j) const { return wm == 2 ? j : wg + 2 * j; }
};

// The (m-blocks, slices) a warpgroup may hold, each an instance below: at
// most 2 units (2 x 32 accumulator registers; with 4, ptxas serialised the
// wgmmas for want of registers and spilled 25 KB)
__host__ __device__ inline bool shape_ok(int mbw, int nsw) {
  return mbw == 0 || (nsw == 1 && mbw <= 2) || (mbw == 1 && nsw == 2);
}

__host__ __device__ inline bool pass_ok(int MB, int NS) {
  for (int wg = 0; wg < 2; ++wg) {
    const Units u(MB, NS, wg);
    if (!shape_ok(u.mbw, u.nsw)) return false;
  }
  return true;
}

template <int M, int N>
struct Shape {
  static constexpr int kM = M, kN = N;
};

// f(Shape<mbw, nsw>) for the instance of this warpgroup's share
template <typename F>
__device__ __forceinline__ void dispatch(const Units& u, F&& f) {
  if (u.mbw == 0)
    f(Shape<0, 0>{});
  else if (u.nsw == 2)
    f(Shape<1, 2>{});
  else if (u.mbw == 2)
    f(Shape<2, 1>{});
  else
    f(Shape<1, 1>{});
}

// Byte offset of byte `col` of row `row` of a1q or a2q (rows of Cwp bytes):
// 16-byte units XOR-swizzled by the row, so that the 8 rows one ldmatrix
// matrix reads (consecutive pixels) meet 8 bank groups
__device__ __forceinline__ unsigned act_offset(int row, int col, int Cwp) {
  const int x = Cwp >= 128 ? (row & 7) : ((row >> 1) & 3);
  return (unsigned)(row * Cwp + ((((col >> 4) ^ x)) << 4) + (col & 15));
}

__device__ __forceinline__ int requant(int acc, float s, float b) {
  const float v = fmaxf(__fadd_rn(__fmul_rn((float)acc, s), b), 0.0f);
  return (int)fminf(rintf(v), 127.0f);
}

__global__ void __launch_bounds__(kThreads, 1)
    int8_bottleneck_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned ring = (smem_u32(smem) + kSwizzleAtom - 1) &
                        ~(unsigned)(kSwizzleAtom - 1);
  const int Cwp = p.Cwp, Cin = 4 * p.Cw, CL = p.CL;
  const unsigned a1q = ring + p.slots * p.slot_bytes;
  const unsigned zero_row = a1q + p.BM1 * Cwp;
  const unsigned a2q = zero_row + Cwp;
  const int n12 = Cwp / CL, n3 = Cin / CL;   // this CTA's channels
  // the CTA's scales and biases: s1, b1, s2, b2 over its n12 channels of
  // a1q and a2q (0 past Cw), s3, b3 over its n3 of the output
  const unsigned vecs = a2q + p.BM * Cwp;
  const float* sv = reinterpret_cast<const float*>(
      smem + (vecs - smem_u32(smem)));
  const unsigned stage = vecs + 4 * (4 * n12 + 2 * n3);
  const unsigned bars = stage + kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.slots + s); };
  const unsigned a1_ready = bars + 16 * p.slots, a2_ready = a1_ready + 8;

  // the warpgroup, broadcast from lane 0 so that ptxas knows it uniform:
  // setmaxnreg and wgmma under a branch it cannot prove uniform are
  // serialised, and the consumers keep the launch's registers
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const unsigned rank = CL > 1 ? cluster_ctarank() : 0;
  const int cluster = blockIdx.x / CL, nclusters = gridDim.x / CL;
  const int nb12 = Cwp / kBlock, nb3 = padded_width(Cin) / kBlock;
  const int kc1 = (Cin + kSpan - 1) / kSpan;   // chunks of K
  const int kc2 = (9 * Cwp + kSpan - 1) / kSpan;
  const int kc3 = (Cwp + kSpan - 1) / kSpan;
  const unsigned box_bytes = kSpan * p.BC * (p.TR + 2);
  const int per_image = p.nty * p.ntx;

  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(a1_ready, CL);
    mbar_init(a2_ready, CL);
    mbar_fence_init();
  }
  for (int i = tid; i < Cwp / 4; i += kThreads)   // the zero row
    st_shared_u32(zero_row + 4 * i, 0u);
  for (int i = tid; i < 4 * n12 + 2 * n3; i += kThreads) {
    const int v = i < 4 * n12 ? i / n12 : 4 + (i - 4 * n12) / n3;
    const int n = v < 4 ? rank * n12 + i % n12 : rank * n3 + (i - 4 * n12) % n3;
    const float* src = v == 0 ? p.s1 : v == 1 ? p.b1 : v == 2 ? p.s2
                     : v == 3 ? p.b2 : v == 4 ? p.s3 : p.b3;
    st_shared_u32(vecs + 4 * i, __float_as_uint(
                                    v >= 4 || n < p.Cw ? __ldg(src + n)
                                                       : 0.0f));
  }
  __syncthreads();
  if (CL > 1) cluster_sync();   // every peer's barriers initialised

  if (wg == kConsumerThreads / 128) {
    // the producer: the ring's slots in the consumers' order, across tiles
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumerThreads) {
      int s = 0, ph = 0;
      auto slot = [&](unsigned bytes) {   // the next slot, once it is free
        mbar_wait(empty(s), ph ^ 1);
        mbar_arrive_expect_tx(full(s), bytes);
        return ring + s * p.slot_bytes;
      };
      auto advance = [&] {
        if (++s == p.slots) {
          s = 0;
          ph ^= 1;
        }
      };
      auto tiles = [&](const int8_t* w, int nb, int c, int row) {
        return w + ((size_t)c * nb + row / kBlock) * kTileBytes;
      };
      for (int tile = cluster; tile < p.ntiles; tile += nclusters) {
        const int b = tile / per_image, rem = tile - b * per_image;
        const int y0 = rem / p.ntx * p.TR, x0 = rem % p.ntx * p.TC;
        const int xb = p.cpad ? x0 - 1 : 0;
        for (int q = 0; q < n12 / p.np1; ++q)
          for (int c = 0; c < kc1; ++c) {
            const unsigned dst = slot(box_bytes + p.np1 * kSpan);
            tma_load_4d(dst, &tm_x, c * kSpan, xb, y0 - 1, b, full(s));
            bulk_load(dst + p.BM1 * kSpan,
                      tiles(p.w1t, nb12, c, rank * n12 + q * p.np1),
                      p.np1 * kSpan, full(s));
            advance();
          }
        for (int q = 0; q < n12 / p.np2; ++q)
          for (int c = 0; c < kc2; ++c) {
            const unsigned dst = slot(p.np2 * kSpan);
            bulk_load(dst, tiles(p.w2t, nb12, c, rank * n12 + q * p.np2),
                      p.np2 * kSpan, full(s));
            advance();
          }
        for (int q = 0; q < n3 / p.np3; ++q)
          for (int c = 0; c < kc3; ++c) {
            const unsigned dst = slot(p.np3 * kSpan);
            bulk_load(dst, tiles(p.w3t, nb3, c, rank * n3 + q * p.np3),
                      p.np3 * kSpan, full(s));
            advance();
          }
      }
    }
    __syncwarp();
  } else {
    // the consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
    const float rs = p.rs_ptr ? __ldg(p.rs_ptr) : p.rs_val;
    // the ring: the next slot to wait for, and the oldest not released
    int head = 0, head_ph = 0, tail = 0, tphase = 0;
    auto wait_slot = [&] {
      mbar_wait(full(head), head_ph);
      const unsigned at = ring + head * p.slot_bytes;
      if (++head == p.slots) {
        head = 0;
        head_ph ^= 1;
      }
      return at;
    };
    auto release_slot = [&] {
      __syncwarp();
      mbar_arrive_if(empty(tail), lane == 0);
      if (++tail == p.slots) tail = 0;
    };
    // this thread's 4-byte word of a1q or a2q, in every CTA of the cluster
    auto store_all = [&](unsigned addr, unsigned v) {
      if (CL == 1) {
        st_shared_u32(addr, v);
      } else {
        for (int r = 0; r < CL; ++r) st_cluster_u32(mapa(addr, r), v);
      }
    };
    // every consumer thread of the cluster past its writes of a1q or a2q:
    // in one CTA a named barrier of the consumers; in a cluster each
    // thread's writes fenced, the consumers' barrier, then lane r of the
    // CTA's first warp arrives on `bar` in the CTA of rank r, and all wait
    // for their own (arrivals and stores predicated, not branched on: a
    // branch around the code before a wgmma serialises it, C7520)
    auto exchange = [&](unsigned bar) {
      if (CL == 1) {
        named_barrier(1, kConsumerThreads);
        return;
      }
      fence_cluster();
      named_barrier(1, kConsumerThreads);
      mbar_arrive_cluster_if(mapa(bar, lane < CL ? lane : 0),
                             warp == 0 && lane < CL);
      mbar_wait_cluster(bar, tphase);
    };
    // Byte pairs of one 8-column group of rows g and g + 8 (v0: columns
    // 2t, 2t + 1 of row g; v1 the same of row g + 8) joined across the
    // quad into a 4-byte word: even t gets row g's columns 2t .. 2t + 3,
    // odd t row g + 8's columns 2t - 2 .. 2t + 1
    auto join = [&](unsigned v0, unsigned v1) {
      const unsigned recv = __shfl_xor_sync(0xffffffffu, t & 1 ? v0 : v1, 1);
      return t & 1 ? (recv | v1 << 16) : (v0 | recv << 16);
    };

    for (int tile = cluster; tile < p.ntiles; tile += nclusters) {
      const int b = tile / per_image, rem = tile - b * per_image;
      const int y0 = rem / p.ntx * p.TR, x0 = rem % p.ntx * p.TC;
      const int xb = p.cpad ? x0 - 1 : 0;

      // One pass of a product: conv1 (KIND 1: x's halo box as A, both
      // operands from the ring through descriptors), conv2 (2: nine taps
      // of a1q gathered by ldmatrix into registers) or conv3 (3: a2q), B
      // from the ring; then its epilogue (bf16: conv3's output type)
      auto product = [&](auto kind, int np, int nchunks, int q, auto bf16) {
        constexpr int KIND = decltype(kind)::value;
        const Units u((KIND == 1 ? p.BM1 : p.BM) / kBlock, np / kBlock, wg);
        const int col0 = q * np;       // of the CTA's channels
        dispatch(u, [&](auto shape) {
          constexpr int MBW = decltype(shape)::kM, NSW = decltype(shape)::kN;
          if constexpr (MBW == 0) {
            for (int c = 0; c < nchunks; ++c) {
              wait_slot();
              release_slot();
            }
          } else {
            // this lane's ldmatrix row in each m-block: conv2's pixel
            // (ty, tx) of the tile as the a1q row of its (dy, dx) = (0, 0)
            // tap, in[dx] whether tap column dx lies in the box (a pixel
            // past the tile's has none); conv3's a2q row
            int arow[MBW];
            [[maybe_unused]] bool in[MBW][3];
#pragma unroll
            for (int i = 0; i < MBW; ++i) {
              const int m = u.mb(i) * kBlock + 16 * w + (lane & 15);
              arow[i] = m;
              if constexpr (KIND == 2) {
                const int ty = m / p.TC, tx = m - ty * p.TC;
                arow[i] = ty * p.BC + tx - 1 + p.cpad;
#pragma unroll
                for (int dx = 0; dx < 3; ++dx)
                  in[i][dx] = m < p.TR * p.TC &&
                              (unsigned)(tx + dx - 1 + p.cpad) <
                                  (unsigned)p.BC;
              }
            }
            // conv3: lane l's output row (l / 2 of the warp's 16 in each
            // m-block) and its residual, 32 channels of each slice, in
            // flight under the products
            [[maybe_unused]] size_t at3[MBW];
            [[maybe_unused]] bool in3[MBW];
            [[maybe_unused]] uint4 xr[MBW * NSW][2];
            if constexpr (KIND == 3) {
#pragma unroll
              for (int i = 0; i < MBW; ++i) {
                const int m = u.mb(i) * kBlock + 16 * w + (lane >> 1);
                const int ty = m / p.TC, y = y0 + ty, x = x0 + m - ty * p.TC;
                in3[i] = ty < p.TR && y < p.H && x < p.W;
                at3[i] = in3[i] ? (((size_t)b * p.Hs + y + p.oy) * p.Ws + x +
                                   p.ox) * Cin + rank * n3 + col0 +
                                      32 * (lane & 1)
                                : 0;
#pragma unroll
                for (int j = 0; j < NSW; ++j) {
                  const uint4* xs = reinterpret_cast<const uint4*>(
                      p.x + at3[i] + u.ns(j) * kBlock);
                  xr[i * NSW + j][0] = __ldg(xs);
                  xr[i * NSW + j][1] = __ldg(xs + 1);
                }
              }
            }
            // zeroed here, in code ptxas sees uniform: the warpgroup
            // arrive it puts before a wgmma whose registers other code
            // wrote must not land in a path it thinks divergent (C7520)
            int acc[MBW * NSW][32];
#pragma unroll
            for (int i = 0; i < MBW * NSW; ++i)
#pragma unroll
              for (int e = 0; e < 32; ++e) acc[i][e] = 0;
            [[maybe_unused]] unsigned fr[MBW][4][4];
            // K byte 128 c of conv2 is channel ch0 of tap (dy0, dx0),
            // stepped chunk by chunk with selects, not branches (C7520; a
            // chunk spans at most two taps: Cwp >= 64)
            [[maybe_unused]] int ch0 = 0, dy0 = 0, dx0 = 0;
            auto next_tap = [&](int& ch, int& dy, int& dx) {
              const bool wrap = ch >= Cwp;
              ch -= wrap ? Cwp : 0;
              dy += wrap && dx == 2;
              dx = wrap ? (dx == 2 ? 0 : dx + 1) : dx;
            };
            // chunk c: its A (conv2, conv3: registers), its four k-steps'
            // products issued (K is zero-padded to whole chunks in the
            // weights: A's bytes past K, read inside shared memory, meet
            // zeros); conv1 keeps them in flight while the next chunk's are
            // issued, and releases the slot of the chunk before; conv2 and
            // conv3 wait for them (a second A buffer under products in
            // flight made ptxas serialise every wgmma for want of
            // registers, C7512) and the other warpgroup's fill the gap
            for (int c = 0; c < nchunks; ++c) {
              const unsigned sl = wait_slot();
              const unsigned sb = KIND == 1 ? sl + p.BM1 * kSpan : sl;
              if constexpr (KIND != 1) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  int ch = (KIND == 2 ? ch0 : kSpan * c) + 32 * k;
                  [[maybe_unused]] int dy = dy0, dx = dx0;
                  if constexpr (KIND == 2) next_tap(ch, dy, dx);
                  ch += 16 * (lane >> 4);
#pragma unroll
                  for (int i = 0; i < MBW; ++i) {
                    unsigned addr = a2q + act_offset(arow[i], ch, Cwp);
                    if constexpr (KIND == 2)
                      addr = in[i][dx] ? a1q + act_offset(
                                             arow[i] + dy * p.BC + dx, ch,
                                             Cwp)
                                       : zero_row + ch;
                    ldmatrix_x4(fr[i][k], addr);
                  }
                }
              }
              wgmma_fence();
#pragma unroll
              for (int k = 0; k < 4; ++k) {
#pragma unroll
                for (int i = 0; i < MBW; ++i)
#pragma unroll
                  for (int j = 0; j < NSW; ++j) {
                    const uint64_t bd =
                        wgmma_desc(sb + u.ns(j) * kTileBytes, kSwizzleAtom,
                                   kSwizzleAtom) + 2 * k;
                    if constexpr (KIND == 1)
                      wgmma_m64n64k32_s8_ss(
                          acc[i * NSW + j],
                          wgmma_desc(sl + u.mb(i) * kTileBytes, kSwizzleAtom,
                                     kSwizzleAtom) + 2 * k,
                          bd, 1);
                    else
                      wgmma_m64n64k32_s8_rs(acc[i * NSW + j], fr[i][k], bd,
                                            1);
                  }
              }
              if constexpr (KIND == 2) {
                ch0 += kSpan;
                next_tap(ch0, dy0, dx0);
                next_tap(ch0, dy0, dx0);
              }
              wgmma_commit();
              if constexpr (KIND == 1) {
                wgmma_wait<1>();
                if (c > 0) release_slot();
              } else {
                wgmma_wait<0>();
#pragma unroll
                for (int i = 0; i < MBW; ++i)
#pragma unroll
                  for (int k = 0; k < 4; ++k)
#pragma unroll
                    for (int e = 0; e < 4; ++e) fence_operand(fr[i][k][e]);
                release_slot();
              }
            }
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < MBW * NSW; ++i)
#pragma unroll
              for (int e = 0; e < 32; ++e) fence_operand(acc[i][e]);
            if constexpr (KIND == 1) release_slot();

            [[maybe_unused]] const unsigned stg =
                stage + warp * 16 * kStagePitch * 4;
#pragma unroll
            for (int i = 0; i < MBW; ++i) {
              const int row0 = u.mb(i) * kBlock + 16 * w + g;
              // conv1: halo pixels outside the box or the image are 0
              [[maybe_unused]] bool keep[2] = {true, true};
              if constexpr (KIND == 1) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int hi = row0 + 8 * h, hy = hi / p.BC;
                  const int y = y0 - 1 + hy, x = xb + hi - hy * p.BC;
                  keep[h] = hy < p.TR + 2 && (unsigned)y < (unsigned)p.H &&
                            (unsigned)x < (unsigned)p.W;
                }
              }
#pragma unroll
              for (int j = 0; j < NSW; ++j) {
                const int(&a)[32] = acc[i * NSW + j];
                const int nl = col0 + u.ns(j) * kBlock;   // CTA's channel
                if constexpr (KIND == 3) __syncwarp();   // stage free
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                  const int c = nl + 8 * jj + 2 * t;
                  if constexpr (KIND != 3) {
                    // a1q or a2q (the scales are 0 past Cw: so is q)
                    const float* vs = sv + (KIND == 1 ? 0 : 2 * n12);
                    const float2 sc = *reinterpret_cast<const float2*>(vs + c);
                    const float2 bi =
                        *reinterpret_cast<const float2*>(vs + n12 + c);
                    const unsigned q0 =
                        keep[0] ? requant(a[4 * jj], sc.x, bi.x) |
                                      requant(a[4 * jj + 1], sc.y, bi.y) << 8
                                : 0u;
                    const unsigned q1 =
                        keep[1] ? requant(a[4 * jj + 2], sc.x, bi.x) |
                                      requant(a[4 * jj + 3], sc.y, bi.y) << 8
                                : 0u;
                    const unsigned word = join(q0, q1);
                    store_all((KIND == 1 ? a1q : a2q) +
                                  act_offset(row0 + 8 * (t & 1),
                                             rank * n12 + c - 2 * (t & 1),
                                             Cwp),
                              word);
                  } else {
                    // (acc * s3 + b3), staged (see below)
                    const float2 sc =
                        *reinterpret_cast<const float2*>(sv + 4 * n12 + c);
                    const float2 bi = *reinterpret_cast<const float2*>(
                        sv + 4 * n12 + n3 + c);
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                      st_shared_v2(
                          stg + 4 * ((g + 8 * h) * kStagePitch + 8 * jj +
                                     2 * t),
                          __fadd_rn(__fmul_rn((float)a[4 * jj + 2 * h], sc.x),
                                    bi.x),
                          __fadd_rn(
                              __fmul_rn((float)a[4 * jj + 2 * h + 1], sc.y),
                              bi.y));
                  }
                }
                if constexpr (KIND == 3) {
                  // + x * res_scale, ReLU, out: lane l takes 32 channels
                  // of the unit's row l / 2, so that the residual comes in
                  // and the output goes out 16 bytes a load and a store
                  __syncwarp();
                  const int r = lane >> 1, half = lane & 1;
                  {
                    const size_t at = at3[i] + u.ns(j) * kBlock;
                    const uint4(&x01)[2] = xr[i * NSW + j];
                    const unsigned xb32[8] = {x01[0].x, x01[0].y, x01[0].z,
                                              x01[0].w, x01[1].x, x01[1].y,
                                              x01[1].z, x01[1].w};
                    unsigned packed[16];
#pragma unroll
                    for (int k = 0; k < 32; k += 4) {
                      const float4 v4 = ld_shared_v4(
                          stg + 4 * (r * kStagePitch + 32 * half + k));
                      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
                      float o[4];
#pragma unroll
                      for (int e = 0; e < 4; ++e)
                        o[e] = fmaxf(
                            __fadd_rn(vv[e],
                                      __fmul_rn((float)(int8_t)(
                                                    xb32[k / 4] >> (8 * e)),
                                                rs)),
                            0.0f);
                      if constexpr (decltype(bf16)::value) {
                        const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
                        const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
                        packed[k / 2] = *reinterpret_cast<const unsigned*>(&lo);
                        packed[k / 2 + 1] = *reinterpret_cast<const unsigned*>(&hi);
                      } else {
                        unsigned word = 0;
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                          word |= (unsigned)fminf(rintf(o[e]), 127.0f)
                                  << (8 * e);
                        packed[k / 4] = word;
                      }
                    }
                    if constexpr (decltype(bf16)::value) {
                      uint4* o = reinterpret_cast<uint4*>(
                          static_cast<__nv_bfloat16*>(p.out) + at);
#pragma unroll
                      for (int v = 0; v < 4; ++v)
                        st_global_v4_if(
                            o + v,
                            make_uint4(packed[4 * v], packed[4 * v + 1],
                                       packed[4 * v + 2], packed[4 * v + 3]),
                            in3[i]);
                    } else {
                      uint4* o = reinterpret_cast<uint4*>(
                          static_cast<int8_t*>(p.out) + at);
#pragma unroll
                      for (int v = 0; v < 2; ++v)
                        st_global_v4_if(
                            o + v,
                            make_uint4(packed[4 * v], packed[4 * v + 1],
                                       packed[4 * v + 2], packed[4 * v + 3]),
                            in3[i]);
                    }
                  }
                }
              }
            }
          }
        });
      };

      // ---- conv1 -> a1q, then every CTA of the cluster holds all of it ----
      const std::false_type int8_out;
      for (int q = 0; q < n12 / p.np1; ++q)
        product(std::integral_constant<int, 1>{}, p.np1, kc1, q,
                int8_out);
      exchange(a1_ready);
      // ---- conv2 -> a2q (rows past the tile's pixels hold what the zero
      // row gave; conv3 computes them and stores none) ----
      for (int q = 0; q < n12 / p.np2; ++q)
        product(std::integral_constant<int, 2>{}, p.np2, kc2, q,
                int8_out);
      exchange(a2_ready);
      // ---- conv3 + the residual -> out ----
      for (int q = 0; q < n3 / p.np3; ++q) {
        if (p.out_bf16)
          product(std::integral_constant<int, 3>{}, p.np3, kc3, q,
                  std::true_type{});
        else
          product(std::integral_constant<int, 3>{}, p.np3, kc3, q,
                  int8_out);
      }
      tphase ^= 1;
    }
  }
  // no CTA leaves while a peer may still write its shared memory
  if (CL > 1) cluster_sync();
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// Bytes of dynamic shared memory: up to 1024 to align the ring to the
// swizzle's atom, the ring's slots, a1q's rows and its zero row, a2q's
// rows, the CTA's scales and biases (fp32: four vectors over its Cwp / CL
// channels of a1q and a2q, two over its 4Cw / CL of the output), conv3's
// staging rows, and a full and an empty barrier a slot and the two
// exchange barriers. `_bottleneck_smem_bytes` in icka_tpu_torch/kernels/conv.py
// computes the same sum.
inline int smem_bytes(const Args& p) {
  return kSwizzleAtom + p.slots * p.slot_bytes + (p.BM1 + 1) * p.Cwp +
         p.BM * p.Cwp + 4 * (4 * p.Cwp + 8 * p.Cw) / p.CL + kStageBytes +
         (2 * p.slots + 2) * 8;
}

// Fills the derived fields; false for a geometry the body does not take
// (`bottleneck_geometry` in icka_tpu_torch/kernels/conv.py chooses one it
// takes)
inline bool derive(Args& p) {
  const int Cin = 4 * p.Cw;
  if (p.B < 1 || p.H < 1 || p.W < 1 || p.Cw < 16 || p.Cw % 16) return false;
  p.Cwp = padded_width(p.Cw);
  p.cpad = p.TC < p.W ? 1 : 0;
  p.BC = p.cpad ? p.TC + 2 : p.W;
  if (p.TR < 1 || p.TC < 1 || p.TC > p.W || p.TR * p.TC > p.BM ||
      (p.TR + 2) * p.BC > p.BM1 || p.BM1 % kBlock || p.BM1 > kMaxRows ||
      p.BM % kBlock || p.BM < kBlock || p.BM > kMaxOutRows ||
      p.BC > kMaxRows || p.TR + 2 > kMaxRows)
    return false;
  if (p.CL != 1 && p.CL != 2 && p.CL != 4 && p.CL != 8) return false;
  if ((p.Cwp / kBlock) % p.CL || (Cin / kBlock) % p.CL) return false;
  const int n12 = p.Cwp / p.CL, n3 = Cin / p.CL;
  for (const int np : {p.np1, p.np2})
    if (np < kBlock || np % kBlock || n12 % np) return false;
  if (p.np3 < kBlock || p.np3 % kBlock || n3 % p.np3) return false;
  if (!pass_ok(p.BM1 / kBlock, p.np1 / kBlock) ||
      !pass_ok(p.BM / kBlock, p.np2 / kBlock) ||
      !pass_ok(p.BM / kBlock, p.np3 / kBlock))
    return false;
  if (p.slots < 2 || p.slots > kMaxSlots) return false;
  p.nty = (p.H + p.TR - 1) / p.TR;
  p.ntx = (p.W + p.TC - 1) / p.TC;
  const long long ntiles = (long long)p.B * p.nty * p.ntx;
  if (ntiles > (1LL << 30)) return false;
  p.ntiles = (int)ntiles;
  p.slot_bytes = kSpan * std::max(p.BM1 + p.np1, std::max(p.np2, p.np3));
  return smem_bytes(p) <= kSmemLimit;
}

// The 4-D map of x's NHWC view: dims (4Cw, W, H, B) innermost first from
// the grid's origin inside the storage, byte strides of a pixel, a row and
// an image of the storage, a box of 128 channels by BC columns by TR + 2
// rows of one image, 128-byte swizzled; what lies outside the grid
// (the halo past the image, channels past 4Cw) arrives as zeros
inline bool x_tensor_map(CUtensorMap* map, const Args& p) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t Cin = 4 * (cuuint64_t)p.Cw;
  const cuuint64_t dims[4] = {Cin, (cuuint64_t)p.W, (cuuint64_t)p.H,
                              (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {Cin, Cin * p.Ws, Cin * p.Ws * p.Hs};
  const cuuint32_t box[4] = {(cuuint32_t)kSpan, (cuuint32_t)p.BC,
                             (cuuint32_t)(p.TR + 2), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const int8_t* base = p.x + ((size_t)p.oy * p.Ws + p.ox) * Cin;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<int8_t*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch: a persistent grid of as many clusters as the card holds at
// once (no more than the tiles). A cluster launch the driver refuses
// returns its error; nothing falls back.
inline cudaError_t launch(Args p, cudaStream_t stream) {
  if (!derive(p)) return cudaErrorInvalidValue;
  const int smem = smem_bytes(p);
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (attr != cudaSuccess) return attr;
  // setmaxnreg's counts balance only at the launch count they were set
  // for: refuse a build that launches with another
  static const int regs = [] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, int8_bottleneck_kernel) == cudaSuccess
               ? a.numRegs
               : -1;
  }();
  if (regs != kLaunchRegs) return cudaErrorInvalidKernelImage;
  CUtensorMap tm;
  if (!x_tensor_map(&tm, p)) return cudaErrorInvalidValue;

  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.CL;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  // clusters resident at once, by cluster size and shared memory (one
  // card: the process's current device)
  static int cache[4][kSmemLimit / 1024 + 2] = {};
  int& resident = cache[p.CL == 1 ? 0 : p.CL == 2 ? 1 : p.CL == 4 ? 2 : 3]
                       [smem / 1024];
  if (resident == 0) {
    cfg.gridDim = dim3(p.CL * std::min(p.ntiles, 1024));
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&resident, int8_bottleneck_kernel,
                                       &cfg);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3(p.CL * std::min(p.ntiles, resident));
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, int8_bottleneck_kernel, tm, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace icka_bneck
