// The int8 space-to-depth stem (K5) and the int8 3x3 conv (K3) for Hopper
// (sm_90a): int8 wgmma on TMA-fed shared memory, a producer warpgroup and
// two consumer warpgroups on a persistent grid. The scaffolding is the
// bottleneck body's (int8_bottleneck_wgmma.cuh, included): the register
// split between the warpgroups (setmaxnreg), a ring of shared-memory slots
// with a full and an empty barrier each, the warpgroups' shares of a
// product (`Units`), the staged epilogue rows.
//
// K5 replaces the TPU kernel `int8_stem_pool` (icka_tpu/kernels/conv.py:467,
// `_stem_pool_kernel` :405-439): (B, OB, OB, K) int8 patches x (K, 4F) int8
// into int32; per sub-pixel plane (fp32 * scale) -> bf16, + the bf16 bias in
// bf16, ReLU; the 3x3/s2 max-pool in space-to-depth space; (B, OB, OB, F)
// bf16 out. What bounds it on the H100: bytes (B = 128, OB = 56, K = 432,
// F = 64: 224.8 MB, 0.067 ms at 3.35 TB/s, against 88.8 GOP, 0.045 ms at
// the int8 peak; with the padding below the products run take 0.06 ms,
// so operations come close). The design:
//   - A tile is 7 x 7 outputs with the row above and the column to the left
//     that the pool reads: an 8 x 8 box of pixels, one 64-row m-block (49
//     outputs in 64 rows, a fill of 77%, as the earlier body's 7 x 14 tiles
//     had: 98 in 128). The patches come by TMA: a 4-D map over (K, OB,
//     OB, B), one 128-byte swizzle span of K a box, anchored at (i0 - 1,
//     j0 - 1); rows and columns outside the image and bytes past K arrive
//     as zeros, and no thread computes a patch address.
//   - The weight, K-major as `kmajor_tiles` lays it out on the host, stays
//     in shared memory: N rows of K padded to whole spans (128 KB at K =
//     432, N = 256), loaded once a CTA, span by span on a barrier each.
//     Streamed from L2 through the ring it would move 128 KB a tile, 1.07 GB
//     a launch at B = 128; it streams so only where it does not fit (K
//     above 512 at N = 256, above 1280 at N = 128): a slot then holds a
//     span of the box and the same span of the weight, on one barrier.
//   - Each consumer warpgroup owns whole tiles, taking the CTA's tiles in
//     turn with the other: one m64 x N product (wgmma m64n256k32 s8, A and
//     B through descriptors), every column from one landing of A, two k32
//     steps a stage over the stages that reach K (7 at K = 432: 14 of the
//     16 k-steps of four spans). While one warpgroup runs its epilogue the
//     other's products run. Each warpgroup has a ring of its own (`slots`
//     slots each, their full and empty barriers its own) and a producer
//     thread of its own, so that the round a slot's barrier finished
//     before is always the same warpgroup's chunk (with one ring for both,
//     a warpgroup waiting on a slot whose earlier round was the other's
//     chunk would see that round's phase as its own and read the slot
//     before its box lands), and so that neither ring's loads wait behind
//     the other's (with one producer for both rings in tile order, K5 at
//     B = 128 took 13% longer).
//   - The pool from the registers: a thread holds, for each of its two
//     rows, the same column offset in every n8 block, so the four planes of
//     a channel. Its rows are the box pixels (2w + h, g) of warp w, lane
//     (g, t), h = 0, 1: the pixel to the left is lane g - 1's (a shuffle),
//     the pixel above is the thread's other row or, for the warp's first
//     row, the warp before's second row (one bf16x2 word a channel pair
//     through shared memory). Each plane as the reference computes it:
//     __fmul_rn, rounded to bf16, + the bf16 bias in bf16, ReLU; 0 outside
//     the image (exact: the planes are >= 0). Then out = max(max4 planes,
//     max(b, d) of the left pixel, max(c, d) of the pixel above, d of the
//     one above-left). The output goes out through a per-warp stage, 16
//     bytes a lane.
//
// K3 replaces `int8_conv3x3` (icka_tpu/kernels/conv.py:107, `_conv3_kernel`
// :36-59): a 3x3/s1 conv of a pre-padded int8 NHWC image, the nine taps'
// products into int32, then fp32 acc * scale + bias [+ residual, bf16 or
// fp32] [ReLU] and bf16, fp32 or int8 out (rint(v * qmul) clipped to
// +-127). What bounds it on the H100: operations (B = 128, 14 x 14, C = F =
// 256: 29.6 GOP, 0.015 ms at the int8 peak, against 21.8 MB). The design:
//   - A tile is TR x TC output pixels of one image (whole rows where they
//     fit 128 rows); a work item of the persistent grid is one pass of np
//     output channels over one tile, so that few tiles still fill the
//     card. The item's halo box of (TR + 2) x (TC + 2) pixels comes by a
//     4-D TMA load over x_pad, span by span of 128 channels (channels past
//     C arrive as zeros), into one of two box buffers. Where the box of
//     every span does not fit (C in the thousands), it comes in groups of
//     `sg` spans, each group's nine taps run before the next group lands
//     (the int32 sums are exact in any order).
//   - The nine taps give A in registers (wgmma's register operand): each
//     lane's ldmatrix row is its pixel's neighbour in the box, stepped tap
//     by tap, through the box's 128-byte swizzle. A chunk's products are
//     awaited before the next chunk's A is loaded (loading it under them
//     made ptxas serialise every wgmma, C7513); the other warpgroup's
//     products fill the gap.
//   - B, `kmajor_tiles(w_q, 9)` (each tap's channels padded to 64 or whole
//     spans), streams through the ring in chunks of 128 bytes of K by a
//     bulk copy each; a pass takes np output channels, and the two
//     warpgroups share its m-blocks and 64-channel slices: one m-block by
//     one, two or four neighbouring slices (one product), or two m-blocks
//     by one slice. At B = 128, 14 x 14, C = F = 256 a tile is 7 x 14
//     outputs (98 of 128 rows, 77%), each warpgroup one m-block by all 256
//     channels in one pass (tiles of 256 rows, two m-blocks by one slice a
//     warpgroup over four passes, ran slower: PERF.md).
//   - Epilogues on the accumulator registers, the scales and biases in
//     shared memory once a CTA (read from a zero-padded global copy where
//     F is too wide for that), each warp's rows staged so that residual
//     loads and output stores go 16 bytes a lane; the modes branch on the
//     kernel's arguments only (uniform), edges are predicated.
//
// Neither body has a branch before a wgmma that ptxas could not prove
// uniform: arrivals, loads and stores are predicated inside the PTX, K3's
// modes branch on the kernel's arguments, and loops run over counts from
// them. Results are bit-equal to the plain versions in
// icka_tpu_torch/kernels/conv.py (`stem_pool_reference`,
// `conv3x3_reference`): integer sums are exact in any order, each multiply
// and add a separate round-to-nearest operation in the reference's order.
//
// What holds them back (clock64 sums a consumer warpgroup,
// tools/int8_conv_clocks.py on an H100; PERF.md): K5 at B = 128 waits for
// patches 15% of its cycles and spends 24% in its epilogue, the rest
// issuing products behind the other warpgroup's: the tensor cores are
// about half busy and HBM moves about 0.6 of its rate. K3 at the table's
// shape awaits its products 23% of its cycles, loads A 15%, spends 31% in
// its epilogue: one warpgroup's A loads and epilogue are not always
// covered by the other's products.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "int8_bottleneck_wgmma.cuh"
#include "ptx.cuh"
#include "tensor_map.cuh"

namespace icka_convw {

using namespace icka_ptx;
using icka_bneck::kBlock;
using icka_bneck::kConsumerRegs;
using icka_bneck::kConsumerThreads;
using icka_bneck::kConsumerWarps;
using icka_bneck::kLaunchRegs;
using icka_bneck::kProducerRegs;
using icka_bneck::kSmemLimit;
using icka_bneck::kSpan;
using icka_bneck::kStageBytes;
using icka_bneck::kStagePitch;
using icka_bneck::kSwizzleAtom;
using icka_bneck::kThreads;
using icka_bneck::kTileBytes;
using icka_bneck::padded_width;
using icka_bneck::Units;

// ---------------------------------------------------------------------------
// K5: the stem
// ---------------------------------------------------------------------------

constexpr int kStemBox = 8;                 // box side: 7 outputs + the halo
constexpr int kStemOut = kStemBox - 1;
constexpr int kStemSlotBytes = kBlock * kSpan;   // one span of one box
constexpr int kStemMaxSlots = 4;                 // a warpgroup's ring

struct StemArgs {
  const int8_t* patches;     // (B, OB, OB, K)
  const int8_t* wt;          // (K, N) as `kmajor_tiles` lays it out
  const float* scale;        // (N,)
  const float* bias;         // (N,)
  __nv_bfloat16* out;        // (B, OB, OB, N / 4)
  int B, OB, K, N;
  int slots;                 // of each consumer warpgroup's ring
  int resident;              // 1: the weight stays in shared memory; 0: a
                             // slot brings its span with the box's
  // derived (`derive_stem`)
  int nsp, nstages, tiles_x, ntiles, slot_bytes, nwb;
};

// Bytes of dynamic shared memory: up to 1024 to align to the swizzle's
// atom, the resident weight (N rows of nsp spans), the two rings' slots,
// the warps' U words (two warpgroups x two tile parities x four warps x F /
// 8 words x 32 lanes), the output stage (eight warps x 16 pixels x F / 2 +
// 4 words), the scales (fp32) and biases (bf16), and a full and an empty
// barrier a slot and the weight's barriers (one a span, or one).
// `_stem_smem_bytes` in icka_tpu_torch/kernels/conv.py computes the same
// sum.
inline int stem_smem_bytes(const StemArgs& p) {
  return kSwizzleAtom + p.resident * p.N * p.nsp * kSpan +
         2 * p.slots * p.slot_bytes + 64 * p.N +
         kConsumerWarps * 64 * (p.N / 8 + 4) + 6 * p.N +
         8 * (4 * p.slots + p.nwb);
}

inline bool derive_stem(StemArgs& p) {
  if (p.B < 1 || p.OB < 1 || p.K < 16 || p.K % 16) return false;
  if (p.N != 128 && p.N != 256) return false;
  if (p.slots < 2 || p.slots > kStemMaxSlots) return false;
  if (p.resident != 0 && p.resident != 1) return false;
  p.nsp = (p.K + kSpan - 1) / kSpan;
  p.slot_bytes = kStemSlotBytes + (1 - p.resident) * p.N * kSpan;
  p.nwb = p.resident ? p.nsp : 1;
  p.nstages = (p.K + 63) / 64;
  p.tiles_x = (p.OB + kStemOut - 1) / kStemOut;
  const long long ntiles = (long long)p.B * p.tiles_x * p.tiles_x;
  if (ntiles > (1LL << 30)) return false;
  p.ntiles = (int)ntiles;
  return stem_smem_bytes(p) <= kSmemLimit;
}

__device__ __forceinline__ unsigned bf2u(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 u2bf(unsigned u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ unsigned hmax2(unsigned a, unsigned b) {
  return bf2u(__hmax2(u2bf(a), u2bf(b)));
}

// d (64 x 64 NS, s32) (+)= a b over one k32 step, both through descriptors
template <int NS>
__device__ __forceinline__ void stem_mma(int (&d)[32 * NS], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (NS == 4)
    wgmma_m64n256k32_s8_ss(d, a, b, accumulate);
  else
    wgmma_m64n128k32_s8_ss(d, a, b, accumulate);
}

// NS: 64-column slices of N = 4F (4 for F = 64, 2 for F = 32)
template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
    int8_stem_pool_kernel(const __grid_constant__ CUtensorMap tm,
                          const StemArgs p) {
  constexpr int N = 64 * NS, F = N / 4, JF = F / 8;
  constexpr int PW = F / 2 + 4;     // words of a staged output pixel
  constexpr int UPP = F / 8;        // 16-byte units of an output pixel
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned wsm = (smem_u32(smem) + kSwizzleAtom - 1) &
                       ~(unsigned)(kSwizzleAtom - 1);
  const unsigned ring = wsm + p.resident * N * p.nsp * kSpan;
  const unsigned ubuf = ring + 2 * p.slots * p.slot_bytes;
  const unsigned ostage = ubuf + 64 * N;
  const unsigned svec = ostage + kConsumerWarps * 64 * PW;
  const unsigned bvec = svec + 4 * N;
  const unsigned bars = bvec + 2 * N;
  const float* sv = reinterpret_cast<const float*>(
      smem + (svec - smem_u32(smem)));
  const unsigned* bv = reinterpret_cast<const unsigned*>(
      smem + (bvec - smem_u32(smem)));
  // warpgroup r's ring: slots r * slots.., its full and empty barriers
  auto slot_at = [&](int r, int s) {
    return ring + (r * p.slots + s) * p.slot_bytes;
  };
  auto full = [&](int r, int s) { return bars + 8 * (r * p.slots + s); };
  auto empty = [&](int r, int s) {
    return bars + 8 * ((2 + r) * p.slots + s);
  };
  auto wbar = [&](int s) { return bars + 8 * (4 * p.slots + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int per_image = p.tiles_x * p.tiles_x;
  // this CTA's tiles: blockIdx.x + k gridDim.x
  const int ntl = (p.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                  (int)gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < 2 * p.slots; ++s) {
      mbar_init(full(0, s), 1);
      mbar_init(empty(0, s), 4);        // the four warps of one warpgroup
    }
    for (int s = 0; s < p.nwb; ++s) mbar_init(wbar(s), 1);
    mbar_fence_init();
  }
  {
    float* svw = reinterpret_cast<float*>(smem + (svec - smem_u32(smem)));
    __nv_bfloat16* bvw = reinterpret_cast<__nv_bfloat16*>(
        smem + (bvec - smem_u32(smem)));
    for (int i = tid; i < N; i += kThreads) {
      svw[i] = __ldg(p.scale + i);
      bvw[i] = __float2bfloat16_rn(__ldg(p.bias + i));
    }
  }
  __syncthreads();

  if (wg == kConsumerThreads / 128) {
    // two producers, lane 0 of the first two warps, one a consumer
    // warpgroup's ring, so that neither ring waits on the other: producer
    // r fills ring r with the spans of tiles k = r, r + 2, ... (its chunk
    // q = (k / 2) nsp + sp in slot q % slots); producer 0 first lands the
    // resident weight span by span
    setmaxnreg_dec<kProducerRegs>();
    const int r = warp - kConsumerWarps;
    if (lane == 0 && r < 2) {
      const unsigned wspan = N * kSpan;
      if (r == 0 && p.resident) {
        for (int s = 0; s < p.nsp; ++s) {
          mbar_arrive_expect_tx(wbar(s), wspan);
          bulk_load(wsm + s * wspan, p.wt + (size_t)s * wspan, wspan,
                    wbar(s));
        }
      } else if (r == 0) {
        mbar_arrive(wbar(0));
      }
      for (int k = r; k < ntl; k += 2) {
        const int tile = blockIdx.x + k * gridDim.x;
        const int b = tile / per_image, rem = tile - b * per_image;
        const int i0 = rem / p.tiles_x * kStemOut;
        const int j0 = rem % p.tiles_x * kStemOut;
        for (int sp = 0; sp < p.nsp; ++sp) {
          const int q = (k >> 1) * p.nsp + sp, s = q % p.slots;
          mbar_wait(empty(r, s), ((q / p.slots) & 1) ^ 1);
          mbar_arrive_expect_tx(full(r, s), p.slot_bytes);
          tma_load_4d(slot_at(r, s), &tm, sp * kSpan, j0 - 1, i0 - 1, b,
                      full(r, s));
          if (!p.resident)
            bulk_load(slot_at(r, s) + kStemSlotBytes,
                      p.wt + (size_t)sp * wspan, wspan, full(r, s));
        }
      }
    }
    __syncwarp();
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
    const unsigned zero2 = 0u;
    int acc[32 * NS];
    for (int k = wg, parity = 0; k < ntl; k += 2, parity ^= 1) {
      const int tile = blockIdx.x + k * gridDim.x;
      const int b = tile / per_image, rem = tile - b * per_image;
      const int i0 = rem / p.tiles_x * kStemOut;
      const int j0 = rem % p.tiles_x * kStemOut;
      // the tile's first chunk in this warpgroup's ring
      const int q0 = (k >> 1) * p.nsp;

      // stage st: k-steps 2 (st & 1), + 1 of span st >> 1; the slot of a
      // span is released once its last stage's products are done
      for (int st = 0; st < p.nstages; ++st) {
        const int q = q0 + (st >> 1);
        const int slot = q % p.slots;
        mbar_wait(wbar(p.resident ? st >> 1 : 0), 0);
        mbar_wait(full(wg, slot), (q / p.slots) & 1);
        const unsigned a = slot_at(wg, slot);
        const unsigned bw = p.resident ? wsm + (st >> 1) * N * kSpan
                                       : a + kStemSlotBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int ks = 2 * (st & 1) + kk;
          stem_mma<NS>(acc,
                       wgmma_desc(a, kSwizzleAtom, kSwizzleAtom) + 2 * ks,
                       wgmma_desc(bw, kSwizzleAtom, kSwizzleAtom) + 2 * ks,
                       (st | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        // stage st - 1 is done: the second half of its span frees the slot
        const int pst = st > 0 ? st - 1 : 0;
        mbar_arrive_if(empty(wg, (q0 + (pst >> 1)) % p.slots),
                       lane == 0 && (pst & 1) && st > 0);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32 * NS; ++e) fence_operand(acc[e]);
      mbar_arrive_if(empty(wg, (q0 + ((p.nstages - 1) >> 1)) % p.slots),
                     lane == 0);

      // ---- the planes in registers: rows h = 0, 1 are box pixels (2w +
      // h, g), and a pixel outside the image is 0 ----
      const int jimg = j0 - 1 + g;
      bool inside[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int iimg = i0 - 1 + 2 * w + h;
        inside[h] = (unsigned)iimg < (unsigned)p.OB &&
                    (unsigned)jimg < (unsigned)p.OB;
      }
      // ... and the neighbours, channel pair by channel pair: lane g - 1
      // holds the pixel to the left; row 1's pixel above is row 0, row 0's
      // the warp before's row 1 (its U words, below)
      unsigned out0[JF], out1[JF], u1[JF];
#pragma unroll
      for (int jf = 0; jf < JF; ++jf) {
        float2 sc[4];
        unsigned bb[4];
#pragma unroll
        for (int pl = 0; pl < 4; ++pl) {
          const int col = pl * F + 8 * jf + 2 * t;
          sc[pl] = *reinterpret_cast<const float2*>(sv + col);
          bb[pl] = bv[col / 2];
        }
        unsigned m4[2], bd[2], cd[2], dd[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned v[4];
#pragma unroll
          for (int pl = 0; pl < 4; ++pl) {
            const int jn = pl * JF + jf;
            __nv_bfloat162 y = __floats2bfloat162_rn(
                __fmul_rn((float)acc[4 * jn + 2 * h], sc[pl].x),
                __fmul_rn((float)acc[4 * jn + 2 * h + 1], sc[pl].y));
            y = __hmax2(__hadd2(y, u2bf(bb[pl])), u2bf(zero2));
            v[pl] = inside[h] ? bf2u(y) : zero2;
          }
          // planes a, b, c, d: p0q0, p0q1, p1q0, p1q1
          cd[h] = hmax2(v[2], v[3]);
          bd[h] = hmax2(v[1], v[3]);
          m4[h] = hmax2(hmax2(v[0], v[1]), cd[h]);
          dd[h] = v[3];
        }
        const unsigned x1 = __shfl_up_sync(0xffffffffu,
                                           hmax2(bd[1], dd[0]), 4);
        const unsigned d1 = __shfl_up_sync(0xffffffffu, dd[1], 4);
        const unsigned b0 = __shfl_up_sync(0xffffffffu, bd[0], 4);
        out1[jf] = hmax2(hmax2(m4[1], cd[0]), x1);
        u1[jf] = hmax2(cd[1], d1);
        out0[jf] = hmax2(m4[0], b0);
      }
      // the U words of warp w's second row, [jf][lane], for warp w + 1; a
      // buffer a tile parity, so that a warp's next write never meets a
      // read of this one
      const unsigned ub = ubuf + (((wg * 2 + parity) * 4) * JF) * 128;
#pragma unroll
      for (int jf = 0; jf < JF; ++jf)
        st_shared_u32(ub + ((w * JF + jf) * 32 + lane) * 4, u1[jf]);
      named_barrier(1 + wg, 128);
      const int wp = w > 0 ? w - 1 : 0;   // warp 0's first row is the halo
#pragma unroll
      for (int jf = 0; jf < JF; ++jf)
        out0[jf] = hmax2(out0[jf],
                         ld_shared_u32(ub + ((wp * JF + jf) * 32 + lane) * 4));

      // ---- out: the warp's 16 pixels through its stage, 16 bytes a lane
      const unsigned os = ostage + warp * 16 * PW * 4;
      __syncwarp();                     // the stage's last reads are done
#pragma unroll
      for (int jf = 0; jf < JF; ++jf) {
        st_shared_u32(os + (g * PW + 4 * jf + t) * 4, out0[jf]);
        st_shared_u32(os + ((8 + g) * PW + 4 * jf + t) * 4, out1[jf]);
      }
      __syncwarp();
#pragma unroll
      for (int rd = 0; rd < 16 * UPP / 32; ++rd) {
        const int qx = rd * (32 / UPP) + lane / UPP, u = lane % UPP;
        const int ti = 2 * w + qx / 8, tj = qx % 8;
        const int i = i0 - 1 + ti, j = j0 - 1 + tj;
        const bool ok = ti >= 1 && tj >= 1 && i < p.OB && j < p.OB;
        const uint4 v = ld_shared_v4_u32(os + (qx * PW + 4 * u) * 4);
        st_global_v4_if(p.out + (((size_t)b * p.OB + i) * p.OB + j) * F +
                            8 * u,
                        v, ok);
      }
    }
  }
}

// The 4-D map of the patches: dims (K, OB, OB, B) innermost first, a box of
// one 128-byte span by 8 x 8 pixels of one image, 128-byte swizzled; what
// lies outside (the halo past the image, bytes past K) arrives as zeros
inline bool stem_tensor_map(CUtensorMap* map, const StemArgs& p) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t K = p.K, OB = p.OB;
  const cuuint64_t dims[4] = {K, OB, OB, (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {K, K * OB, K * OB * OB};
  const cuuint32_t box[4] = {(cuuint32_t)kSpan, kStemBox, kStemBox, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<int8_t*>(p.patches), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once a kernel: its dynamic shared memory allowed, and a build whose launch
// register count is not the one the setmaxnreg counts balance at refused
template <typename Kernel>
cudaError_t ready(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  return a.numRegs == kLaunchRegs ? cudaSuccess
                                  : cudaErrorInvalidKernelImage;
}

template <int NS>
cudaError_t launch_stem_ns(const StemArgs& p, int grid, cudaStream_t stream) {
  static const cudaError_t ok = ready(int8_stem_pool_kernel<NS>);
  if (ok != cudaSuccess) return ok;
  CUtensorMap tm;
  if (!stem_tensor_map(&tm, p)) return cudaErrorInvalidValue;
  int8_stem_pool_kernel<NS><<<grid, kThreads, stem_smem_bytes(p), stream>>>(
      tm, p);
  return cudaGetLastError();
}

// One launch on a persistent grid of `grid` CTAs (the host gives at most
// one a SM and two tiles a CTA); a geometry the body does not take returns
// cudaErrorInvalidValue
inline cudaError_t launch_stem(StemArgs p, int grid, cudaStream_t stream) {
  if (!derive_stem(p) || grid < 1) return cudaErrorInvalidValue;
  grid = std::min(grid, (p.ntiles + 1) / 2);
  return p.N == 256 ? launch_stem_ns<4>(p, grid, stream)
                    : launch_stem_ns<2>(p, grid, stream);
}

// ---------------------------------------------------------------------------
// K3: the 3x3 conv
// ---------------------------------------------------------------------------

enum { RES_NONE = 0, RES_BF16 = 2, RES_F32 = 3 };

// A warpgroup's share of a pass (`Units`): the bottleneck's (at most two
// m64n64 units), or one m-block by two or four slices that are neighbours,
// one m64n128 or m64n256 product (the warpgroups then split the m-blocks)
__host__ __device__ inline bool conv3_shape_ok(int mbw, int nsw, int wm) {
  return mbw == 0 || (nsw == 1 && mbw <= 2) ||
         (mbw == 1 && (nsw == 2 || nsw == 4) && wm == 2);
}

__host__ __device__ inline bool conv3_pass_ok(int MB, int NS) {
  for (int wg = 0; wg < 2; ++wg) {
    const Units u(MB, NS, wg);
    if (!conv3_shape_ok(u.mbw, u.nsw, u.wm)) return false;
  }
  return true;
}

// f(Shape<mbw, nsw>) for the instance of this warpgroup's share
template <typename F>
__device__ __forceinline__ void conv3_dispatch(const Units& u, F&& f) {
  using icka_bneck::Shape;
  if (u.mbw == 0)
    f(Shape<0, 0>{});
  else if (u.nsw == 4)
    f(Shape<1, 4>{});
  else if (u.nsw == 2)
    f(Shape<1, 2>{});
  else if (u.mbw == 2)
    f(Shape<2, 1>{});
  else
    f(Shape<1, 1>{});
}
enum { OUT_INT8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };
constexpr int kConvMaxRows = 256;     // of the product and of a box side
constexpr int kConvMaxSlots = 4;

struct Conv3Args {
  const int8_t* x;           // x_pad (B, H + 2, W + 2, C)
  const int8_t* wt;          // w_q (9C, F) as `kmajor_tiles(w_q, 9)` lays it
  const float* scale;        // (F,)
  const float* bias;         // (F,)
  const float* vecs;         // (2 Fp,) scale then bias, zero-padded, where
                             // shared memory has no room for them; else null
  const void* res;           // (B, H, W, F) bf16 or fp32, or null
  int res_kind;
  void* out;                 // (B, H, W, F)
  int out_kind;
  int relu;
  float qmul;                // int8 out: rint(v * qmul) clipped to +-127
  int B, H, W, C, F;
  int TR, TC;                // output rows and columns a tile
  int BM;                    // rows of the product: TR TC rounded to 64
  int np;                    // output channels a pass
  int slots, boxes;          // of the ring; box buffers (1 or 2)
  int sg;                    // spans a box holds: all, or a group of them
  // derived (`derive_conv3`)
  int Cp, Fp, spans, BC, span_stride, box_bytes, slot_bytes, kc, nty, ntx,
      ntiles, npass, nitems, ngroups, staged;
};

// Bytes of dynamic shared memory: up to 1024 to align, the box buffers
// (sg spans of (TR + 2) (TC + 2) rows of 128 bytes, each 1024-aligned),
// the ring's slots (np rows of 128 bytes), the staged rows of the
// epilogue, scale and bias over the padded channels (fp32) unless they are
// read from `vecs`, a full and an
// empty barrier a slot and a box. `_conv3_smem_bytes` in
// icka_tpu_torch/kernels/conv.py computes the same sum.
inline int conv3_smem_bytes(const Conv3Args& p) {
  return kSwizzleAtom + p.boxes * p.box_bytes + p.slots * p.slot_bytes +
         kStageBytes + 8 * p.Fp * p.staged + 8 * (2 * p.slots + 2 * p.boxes);
}

inline bool derive_conv3(Conv3Args& p) {
  if (p.B < 1 || p.H < 1 || p.W < 1 || p.C < 16 || p.C % 16 || p.F < 16 ||
      p.F % 16)
    return false;
  p.Cp = padded_width(p.C);
  p.Fp = padded_width(p.F);
  p.staged = p.vecs == nullptr;
  p.spans = (p.Cp + kSpan - 1) / kSpan;
  p.BC = p.TC + 2;
  if (p.TR < 1 || p.TC < 1 || p.TR > p.H || p.TC > p.W ||
      p.TR * p.TC > p.BM || p.BM % kBlock || p.BM > kConvMaxRows ||
      p.BC > kConvMaxRows || p.TR + 2 > kConvMaxRows)
    return false;
  if (p.np < kBlock || p.np % kBlock || p.Fp % p.np ||
      !conv3_pass_ok(p.BM / kBlock, p.np / kBlock))
    return false;
  if (p.slots < 2 || p.slots > kConvMaxSlots || p.boxes < 1 || p.boxes > 2 ||
      p.sg < 1 || p.sg > p.spans)
    return false;
  // groups of spans: each tap's channels are whole spans (Cp > 64)
  p.ngroups = (p.spans + p.sg - 1) / p.sg;
  p.span_stride = (p.BC * (p.TR + 2) * kSpan + kSwizzleAtom - 1) /
                  kSwizzleAtom * kSwizzleAtom;
  p.box_bytes = p.sg * p.span_stride;
  p.slot_bytes = p.np * kSpan;
  p.kc = (9 * p.Cp + kSpan - 1) / kSpan;
  p.nty = (p.H + p.TR - 1) / p.TR;
  p.ntx = (p.W + p.TC - 1) / p.TC;
  p.npass = p.Fp / p.np;
  const long long ntiles = (long long)p.B * p.nty * p.ntx;
  if (ntiles * p.npass > (1LL << 30)) return false;
  p.ntiles = (int)ntiles;
  p.nitems = p.ntiles * p.npass;
  return conv3_smem_bytes(p) <= kSmemLimit;
}

__device__ __forceinline__ int requant(float v, float qmul) {
  const float q = rintf(__fmul_rn(v, qmul));     // half to even
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

// kWide 0: every span in one box round, scales and biases staged, as
// every width up to the thousands takes; 1: the box in groups of spans
// and/or the vectors read from `vecs` (an instance of its own, so that the
// common one carries neither the group loop nor the vectors' branch)
template <int kWide>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv3x3_kernel(const __grid_constant__ CUtensorMap tm,
                        const Conv3Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int ngroups = kWide ? p.ngroups : 1;
  const int staged = kWide ? p.staged : 1;
  const unsigned box = (smem_u32(smem) + kSwizzleAtom - 1) &
                       ~(unsigned)(kSwizzleAtom - 1);
  const unsigned ring = box + p.boxes * p.box_bytes;
  const unsigned stage = ring + p.slots * p.slot_bytes;
  const unsigned vecs = stage + kStageBytes;   // scale, then bias, over Fp
  const unsigned bars = vecs + 8 * p.Fp * staged;
  const float* sv = reinterpret_cast<const float*>(
      smem + (vecs - smem_u32(smem)));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.slots + s); };
  auto box_full = [&](int i) { return bars + 8 * (2 * p.slots + i); };
  auto box_empty = [&](int i) {
    return bars + 8 * (2 * p.slots + p.boxes + i);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int per_image = p.nty * p.ntx;

  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    for (int i = 0; i < p.boxes; ++i) {
      mbar_init(box_full(i), 1);
      mbar_init(box_empty(i), kConsumerWarps);
    }
    mbar_fence_init();
  }
  {
    float* svw = reinterpret_cast<float*>(smem + (vecs - smem_u32(smem)));
    for (int i = tid; i < p.Fp * staged; i += kThreads) {
      svw[i] = i < p.F ? __ldg(p.scale + i) : 0.0f;
      svw[p.Fp + i] = i < p.F ? __ldg(p.bias + i) : 0.0f;
    }
  }
  __syncthreads();

  if (wg == kConsumerThreads / 128) {
    // the producer: an item's box, then its pass's weight chunks; group by
    // group of spans where the box comes so (K chunk tap * spans + span)
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumerThreads) {
      int s = 0, ph = 0, k = 0;
      const int nbf = p.Fp / kBlock;
      for (int item = blockIdx.x; item < p.nitems; item += gridDim.x) {
        const int tile = item / p.npass, q = item - tile * p.npass;
        const int b = tile / per_image, rem = tile - b * per_image;
        const int y0 = rem / p.ntx * p.TR, x0 = rem % p.ntx * p.TC;
        for (int gi = 0; gi < ngroups; ++gi, ++k) {
          const int sg0 = gi * p.sg, sgn = min(p.sg, p.spans - sg0);
          const int bi = k % p.boxes;
          mbar_wait(box_empty(bi), ((k / p.boxes) & 1) ^ 1);
          mbar_arrive_expect_tx(box_full(bi),
                                sgn * kSpan * p.BC * (p.TR + 2));
          for (int sp = 0; sp < sgn; ++sp)
            tma_load_4d(box + bi * p.box_bytes + sp * p.span_stride, &tm,
                        (sg0 + sp) * kSpan, x0, y0, b, box_full(bi));
          const int nck = ngroups == 1 ? p.kc : 9 * sgn;
          for (int c = 0; c < nck; ++c) {
            const int kc = ngroups == 1 ? c
                                          : c / sgn * p.spans + sg0 + c % sgn;
            mbar_wait(empty(s), ph ^ 1);
            mbar_arrive_expect_tx(full(s), p.slot_bytes);
            bulk_load(ring + s * p.slot_bytes,
                      p.wt + ((size_t)kc * nbf + q * p.np / kBlock) *
                                 kTileBytes,
                      p.slot_bytes, full(s));
            if (++s == p.slots) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
    __syncwarp();
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
    int head = 0, head_ph = 0, tail = 0;
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
    const bool has_res = p.res_kind != RES_NONE;
    const bool res_f32 = p.res_kind == RES_F32;
    const int res_size = res_f32 ? 4 : 2;
    const int out_size = p.out_kind == OUT_F32 ? 4
                       : p.out_kind == OUT_BF16 ? 2 : 1;

    // box round k: a group of spans of an item's box, its buffer k % boxes;
    // awaited, then freed once every consumer warp is past its chunks
    int k = 0;
    auto box_wait = [&] {
      mbar_wait(box_full(k % p.boxes), (k / p.boxes) & 1);
      return box + k % p.boxes * p.box_bytes;
    };
    auto box_release = [&] {
      mbar_arrive_if(box_empty(k % p.boxes), lane == 0);
      ++k;
    };
    // the spans of group gi, and its chunks (9 taps by its spans; all of
    // K's chunks, taps spanning chunks where Cp = 64, for one group)
    auto group_spans = [&](int gi) {
      return min(p.sg, p.spans - gi * p.sg);
    };
    auto group_chunks = [&](int sgn) {
      return ngroups == 1 ? p.kc : 9 * sgn;
    };
    for (int item = blockIdx.x; item < p.nitems; item += gridDim.x) {
      const int tile = item / p.npass, q = item - tile * p.npass;
      const int b = tile / per_image, rem = tile - b * per_image;
      const int y0 = rem / p.ntx * p.TR, x0 = rem % p.ntx * p.TC;
      {
        const Units u(p.BM / kBlock, p.np / kBlock, wg);
        conv3_dispatch(u, [&](auto shape) {
          constexpr int MBW = decltype(shape)::kM, NSW = decltype(shape)::kN;
          if constexpr (MBW == 0) {
            for (int gi = 0; gi < ngroups; ++gi) {
              box_wait();
              for (int c = 0; c < group_chunks(group_spans(gi)); ++c) {
                wait_slot();
                release_slot();
              }
              box_release();
            }
          } else {
            // this lane's ldmatrix row in each m-block: its pixel (ty,
            // tx) as the box row of tap (0, 0); rows past the tile's
            // pixels read row 0 and are never stored
            int arow[MBW];
#pragma unroll
            for (int i = 0; i < MBW; ++i) {
              const int m = u.mb(i) * kBlock + 16 * w + (lane & 15);
              const int ty = m / p.TC;
              arow[i] = m < p.TR * p.TC ? ty * p.BC + m - ty * p.TC : 0;
            }
            int acc[MBW * NSW][32];
#pragma unroll
            for (int i = 0; i < MBW * NSW; ++i)
#pragma unroll
              for (int e = 0; e < 32; ++e) acc[i][e] = 0;
            // a chunk's A, its four k-steps by ldmatrix: the group's K byte
            // 128 c is channel ch0 (of the cg the box holds) of tap tap0,
            // stepped chunk by chunk and k-step by k-step with selects (a
            // chunk spans at most three taps: cg >= 64); a tap past the
            // ninth, in the last chunk's padding, reads tap 8 against zero
            // weights
            int ch0 = 0, tap0 = 0, cg = p.Cp;
            unsigned bx = box;
            auto load_a = [&](unsigned (&f)[MBW][4][4]) {
#pragma unroll
              for (int k4 = 0; k4 < 4; ++k4) {
                int ch = ch0 + 32 * k4, tap = tap0;
                const bool wrap = ch >= cg;
                ch -= wrap ? cg : 0;
                tap += wrap;
                tap = tap < 8 ? tap : 8;
                const int dy = tap / 3;
                const int off = dy * p.BC + tap - 3 * dy;
                ch += 16 * (lane >> 4);
                const unsigned cb = bx + (ch >> 7) * p.span_stride;
                const int unit = (ch >> 4) & 7;
#pragma unroll
                for (int i = 0; i < MBW; ++i) {
                  const int r = arow[i] + off;
                  ldmatrix_x4(f[i][k4],
                              cb + r * kSpan + ((unit ^ (r & 7)) << 4));
                }
              }
#pragma unroll
              for (int w2 = 0; w2 < 2; ++w2) {
                const bool wrap = ch0 + (w2 ? 0 : kSpan) >= cg;
                ch0 += w2 ? 0 : kSpan;
                ch0 -= wrap ? cg : 0;
                tap0 += wrap;
              }
            };
            // chunk c: its A, then its products, awaited before the next
            // chunk's A is loaded (loading it under the products in flight
            // defines a wgmma's input registers inside a pipeline stage:
            // ptxas then serialises every wgmma, C7513); the other
            // warpgroup's products fill the gap. A warpgroup's two or four
            // slices are neighbours (`conv3_shape_ok`): one n128 or n256
            // product.
            unsigned fr[MBW][4][4];
            for (int gi = 0; gi < ngroups; ++gi) {
              const int sgn = group_spans(gi);
              bx = box_wait();
              cg = ngroups == 1 ? p.Cp : sgn * kSpan;
              ch0 = 0;
              tap0 = 0;
              for (int c = 0; c < group_chunks(sgn); ++c) {
                const unsigned sb = wait_slot();
                load_a(fr);
                wgmma_fence();
#pragma unroll
                for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
                  for (int i = 0; i < MBW; ++i) {
                    const uint64_t bd = wgmma_desc(sb + u.ns(0) * kTileBytes,
                                                   kSwizzleAtom,
                                                   kSwizzleAtom) + 2 * k4;
                    if constexpr (NSW == 4)
                      wgmma_m64n256k32_s8_rs(
                          reinterpret_cast<int(&)[128]>(acc[i * NSW]),
                          fr[i][k4], bd, 1);
                    else if constexpr (NSW == 2)
                      wgmma_m64n128k32_s8_rs(
                          reinterpret_cast<int(&)[64]>(acc[i * NSW]),
                          fr[i][k4], bd, 1);
                    else
                      wgmma_m64n64k32_s8_rs(acc[i], fr[i][k4], bd, 1);
                  }
                wgmma_commit();
                wgmma_wait<0>();
#pragma unroll
                for (int i = 0; i < MBW; ++i)
#pragma unroll
                  for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
                    for (int e = 0; e < 4; ++e) fence_operand(fr[i][k4][e]);
                release_slot();
              }
              box_release();
            }
#pragma unroll
            for (int i = 0; i < MBW * NSW; ++i)
#pragma unroll
              for (int e = 0; e < 32; ++e) fence_operand(acc[i][e]);

            // epilogue, unit by unit: (acc * s + b) staged a warp's 16
            // rows by 64 channels; then lane l takes 32 channels of row
            // l / 2: + residual, ReLU, out, 16 bytes a load and a store
            const unsigned stg = stage + warp * 16 * kStagePitch * 4;
#pragma unroll
            for (int i = 0; i < MBW; ++i) {
              const int r = lane >> 1, half = lane & 1;
              const int m = u.mb(i) * kBlock + 16 * w + r;
              const int ty = m / p.TC, tx = m - ty * p.TC;
              const int y = y0 + ty, x = x0 + tx;
              const bool ok = m < p.TR * p.TC && y < p.H && x < p.W;
              const size_t pix = ok ? ((size_t)b * p.H + y) * p.W + x : 0;
#pragma unroll
              for (int j = 0; j < NSW; ++j) {
                const int(&a)[32] = acc[i * NSW + j];
                const int nl = q * p.np + u.ns(j) * kBlock;
                const int c0 = nl + 32 * half;
                // the residual's bytes, in flight under the staging (the
                // mode branches are on the kernel's arguments: uniform)
                uint4 raw[8];
                if (has_res) {
#pragma unroll
                  for (int v = 0; v < 8; ++v)
                    raw[v] = ld_global_v4_if(
                        static_cast<const char*>(p.res) +
                            (pix * p.F + c0) * res_size + 16 * v,
                        ok && (res_f32 || v < 4) &&
                            c0 + v * (16 / res_size) < p.F);
                }
                __syncwarp();                    // stage free
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                  const int c = nl + 8 * jj + 2 * t;
                  // staged: shared loads; else the global copy (the
                  // branch is on the kernel's arguments: uniform)
                  float2 sc, bi2;
                  if (staged) {
                    sc = *reinterpret_cast<const float2*>(sv + c);
                    bi2 = *reinterpret_cast<const float2*>(sv + p.Fp + c);
                  } else {
                    sc = __ldg(reinterpret_cast<const float2*>(p.vecs + c));
                    bi2 = __ldg(reinterpret_cast<const float2*>(
                        p.vecs + p.Fp + c));
                  }
#pragma unroll
                  for (int h = 0; h < 2; ++h)
                    st_shared_v2(
                        stg + 4 * ((g + 8 * h) * kStagePitch + 8 * jj + 2 * t),
                        __fadd_rn(__fmul_rn((float)a[4 * jj + 2 * h], sc.x),
                                  bi2.x),
                        __fadd_rn(
                            __fmul_rn((float)a[4 * jj + 2 * h + 1], sc.y),
                            bi2.y));
                }
                __syncwarp();
                float o[32];
#pragma unroll
                for (int kq = 0; kq < 8; ++kq) {
                  const float4 v4 =
                      ld_shared_v4(stg + 4 * (r * kStagePitch + 32 * half +
                                              4 * kq));
                  o[4 * kq] = v4.x;
                  o[4 * kq + 1] = v4.y;
                  o[4 * kq + 2] = v4.z;
                  o[4 * kq + 3] = v4.w;
                }
                if (has_res) {
                  if (res_f32) {
#pragma unroll
                    for (int v = 0; v < 8; ++v) {
                      o[4 * v] = __fadd_rn(o[4 * v], __uint_as_float(raw[v].x));
                      o[4 * v + 1] =
                          __fadd_rn(o[4 * v + 1], __uint_as_float(raw[v].y));
                      o[4 * v + 2] =
                          __fadd_rn(o[4 * v + 2], __uint_as_float(raw[v].z));
                      o[4 * v + 3] =
                          __fadd_rn(o[4 * v + 3], __uint_as_float(raw[v].w));
                    }
                  } else {
#pragma unroll
                    for (int v = 0; v < 4; ++v) {
                      const unsigned wv[4] = {raw[v].x, raw[v].y, raw[v].z,
                                              raw[v].w};
#pragma unroll
                      for (int e = 0; e < 4; ++e) {
                        o[8 * v + 2 * e] = __fadd_rn(
                            o[8 * v + 2 * e], __uint_as_float(wv[e] << 16));
                        o[8 * v + 2 * e + 1] =
                            __fadd_rn(o[8 * v + 2 * e + 1],
                                      __uint_as_float(wv[e] & 0xffff0000u));
                      }
                    }
                  }
                }
                if (p.relu) {
#pragma unroll
                  for (int e = 0; e < 32; ++e) o[e] = fmaxf(o[e], 0.0f);
                }
                // out: bf16 (4 stores), int8 (2) or fp32 (8) of 16 bytes
                char* ob = static_cast<char*>(p.out) +
                           (pix * p.F + c0) * out_size;
                if (p.out_kind == OUT_BF16) {
#pragma unroll
                  for (int v = 0; v < 4; ++v) {
                    unsigned wb[4];
#pragma unroll
                    for (int wi = 0; wi < 4; ++wi)
                      wb[wi] = bf2u(__floats2bfloat162_rn(
                          o[8 * v + 2 * wi], o[8 * v + 2 * wi + 1]));
                    st_global_v4_if(ob + 16 * v,
                                    make_uint4(wb[0], wb[1], wb[2], wb[3]),
                                    ok && c0 + 8 * v < p.F);
                  }
                } else if (p.out_kind == OUT_INT8) {
#pragma unroll
                  for (int v = 0; v < 2; ++v) {
                    unsigned wq[4];
#pragma unroll
                    for (int wi = 0; wi < 4; ++wi) {
                      unsigned word = 0;
#pragma unroll
                      for (int e = 0; e < 4; ++e)
                        word |= (unsigned)(requant(o[16 * v + 4 * wi + e],
                                                   p.qmul) & 0xff)
                                << (8 * e);
                      wq[wi] = word;
                    }
                    st_global_v4_if(ob + 16 * v,
                                    make_uint4(wq[0], wq[1], wq[2], wq[3]),
                                    ok && c0 + 16 * v < p.F);
                  }
                } else {
#pragma unroll
                  for (int v = 0; v < 8; ++v)
                    st_global_v4_if(
                        ob + 16 * v,
                        make_uint4(__float_as_uint(o[4 * v]),
                                   __float_as_uint(o[4 * v + 1]),
                                   __float_as_uint(o[4 * v + 2]),
                                   __float_as_uint(o[4 * v + 3])),
                        ok && c0 + 4 * v < p.F);
                }
              }
            }
          }
        });
      }
    }
  }
}

// The 4-D map of x_pad: dims (C, W + 2, H + 2, B) innermost first, a box of
// one 128-byte span by TC + 2 columns by TR + 2 rows of one image, 128-byte
// swizzled; channels past C and pixels past the image arrive as zeros
inline bool conv3_tensor_map(CUtensorMap* map, const Conv3Args& p) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t C = p.C, Wp = p.W + 2, Hp = p.H + 2;
  const cuuint64_t dims[4] = {C, Wp, Hp, (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {C, C * Wp, C * Wp * Hp};
  const cuuint32_t box[4] = {(cuuint32_t)kSpan, (cuuint32_t)p.BC,
                             (cuuint32_t)(p.TR + 2), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<int8_t*>(p.x), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch on a persistent grid of at most `grid` CTAs (the host gives
// one a SM, at most one an item); a geometry the body does not take
// returns cudaErrorInvalidValue
template <int kWide>
cudaError_t launch_conv3_wide(const Conv3Args& p, int grid,
                              cudaStream_t stream) {
  static const cudaError_t ok = ready(int8_conv3x3_kernel<kWide>);
  if (ok != cudaSuccess) return ok;
  CUtensorMap tm;
  if (!conv3_tensor_map(&tm, p)) return cudaErrorInvalidValue;
  int8_conv3x3_kernel<kWide>
      <<<grid, kThreads, conv3_smem_bytes(p), stream>>>(tm, p);
  return cudaGetLastError();
}

inline cudaError_t launch_conv3(Conv3Args p, int grid, cudaStream_t stream) {
  if (!derive_conv3(p) || grid < 1) return cudaErrorInvalidValue;
  grid = std::min(grid, p.nitems);
  return p.ngroups > 1 || !p.staged ? launch_conv3_wide<1>(p, grid, stream)
                                    : launch_conv3_wide<0>(p, grid, stream);
}

}  // namespace icka_convw
