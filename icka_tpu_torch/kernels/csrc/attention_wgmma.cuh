// The bf16 attention body at head width 64 for Hopper (sm_90a): wgmma on
// TMA-fed shared memory, in the shape of FlashAttention-3 kept simple.
//
// Replaces, for bf16 at head width 64 (every full-width model of the repo:
// RoBERTa-large 16 x 64, BERT-base, the chunker, the captioner and GPT-2
// 12 x 64), both TPU kernels of icka_tpu/kernels/attention.py:
// `fused_attention` (:87) and `fused_attention_blockwise` (:246). It
// computes what blockwise_attention.cu's bodies compute, on their contract:
//
//     out[b, :, h] = softmax(Q_h K_h^T * scale + bias[b]) V_h
//
// by the online-softmax recurrence over key tiles, the running maximum
// starting at -1e30 (a key tile that is all -inf stays finite), p rounded
// to bf16 before P.V, l summing the unrounded p; q, k and v read through a
// row stride each; a key-mode (B, Sk) or full (B, Sq, Sk) bias through
// strides; ragged Sq and Sk masked; the output contiguous bf16.
//
// What bounds it: at B = 128, 16 heads of 64, it moves Q, K, V and O once
// (4 * S * 2 KB a head and batch row) against 4 * S^2 * 64 FLOP of the two
// products: at the 989 TFLOP/s bf16 peak and 3.35 TB/s, bytes bound it
// below about 600 keys and operations above (blockwise_attention.cu's
// note reckons the same). So the products must reach the tensor cores'
// full rate, which on Hopper only wgmma does, and K and V must stream at
// the memory's rate with no thread spending instructions on the copies.
//
// The design. A work item is BQ = 64 or 128 query rows of one head and
// batch element; a persistent grid of one block per SM (two at BQ = 64)
// walks the items. A block has one consumer warpgroup per 64 rows and a
// producer warpgroup whose single working thread issues TMA loads (the
// others exit); the producer gives up its registers with setmaxnreg.dec
// and the consumers take them with setmaxnreg.inc. On the host the C entry
// point encodes three 3-D tensor maps, (num_heads * 64, S, B) with row
// strides ld * 2 and S * ld * 2 bytes and a box of (64, rows, 1),
// 128-byte swizzled: one row of a head is exactly one 128-byte swizzle
// span. Rows past Sq or Sk arrive as zeros (TMA's fill), so p = 0 meets
// V = 0, never a stale Inf or NaN. Q has two buffers and K and V move
// through a ring of 2 or 3 stages, each with a full barrier (TMA's bytes)
// and an empty one (one arrival per consumer warp); the ring runs on across
// items, so the producer loads the next tiles, and the next item's Q, while
// the consumers compute. S = Q K^T is wgmma m64nBKk16 with both operands in
// shared memory (K-major, four k-steps of 16 columns); the softmax runs on
// the accumulator registers: each score becomes fma(acc, scale log2 e,
// bias log2 e), then exp2 (one MUFU op), with the row max and sum reduced
// over the quad that holds a row (a thread holds two rows, as in
// mma.sync's m16n8 layout, which is each warp's part of the m64
// accumulator). p, rounded to bf16 and packed in registers, is the A
// operand of O += P V, wgmma m64n64k16 with V in shared memory as stored
// (keys-major, so B is MN-major and the transpose bit set). Within a
// warpgroup, S of tile t + 1 is issued before P V of tile t, so the tensor
// cores run both while the warpgroup computes the softmax of tile t + 1
// (at BK = 64 into a second P buffer, so P V of tile t overlaps it too);
// at BK = 64 the next item's first S is issued before this item's O is
// written out. The bias is read by each consumer thread for its own
// accumulator elements, in flight under the products (a (B, Sk) fp32 row
// need not be a multiple of 16 bytes long, so it cannot come by TMA).
// Instances: (BQ, BK) in {64, 128}^2.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no driver call is linked)

#include <algorithm>
#include <climits>
#include <type_traits>

#include "attention_common.cuh"
#include "ptx.cuh"
#include "tensor_map.cuh"

namespace icka_wgmma {

using namespace icka_attention;
using namespace icka_ptx;
using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;      // the body's only width
constexpr int kRowBytes = 128;    // one bf16 row of a head: one swizzle span
constexpr int kSpan = 8 * kRowBytes;  // the swizzle's atom: 8 rows
constexpr int kWarpgroup = 128;   // threads
constexpr int kProducerRegs = 24; // what the producer warpgroup keeps
constexpr float kLog2e = 1.4426950408889634f;

// Registers a thread at launch (the launch bounds give ptxas this count)
// and what each consumer warpgroup takes: the producer warpgroup's release
// of (launch - 24) x 128 registers pays exactly for the consumers' rise,
// so setmaxnreg.inc never waits on registers that do not exist. BQ = 64:
// two warpgroups, two blocks an SM; BQ = 128: three, one block an SM.
template <int BQ>
struct Regs;
template <>
struct Regs<64> {
  static constexpr int launch = 128, consumer = 232, blocks_per_sm = 2;
};
template <>
struct Regs<128> {
  static constexpr int launch = 168, consumer = 240, blocks_per_sm = 1;
};

// K/V stages of the ring: three (tile t + 2 in flight while t computes),
// but two at (64, 128), where three would leave room for one block an SM
// instead of two
__host__ __device__ constexpr int stages(int bq, int bk) {
  return bq == 64 && bk == 128 ? 2 : 3;
}

// Bytes of dynamic shared memory for a (bq, bk) tiling: up to 1024 bytes
// to align the tiles to the swizzle's 1024-byte atom, two query tiles,
// the stages of K and V, then a full and an empty barrier for each stage
// and for each query tile. The Python wrapper computes the same sum
// (`_smem_bytes`).
inline size_t wgmma_smem_bytes(int bq, int bk) {
  const int st = stages(bq, bk);
  return kSpan + (size_t)(2 * bq + 2 * st * bk) * kRowBytes +
         (2 * st + 4) * 8;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (N == 64)
    wgmma_m64n64k16_ss(d, a, b, accumulate);
  else
    wgmma_m64n128k16_ss(d, a, b, accumulate);
}

// A persistent grid: block i takes the work items i, i + gridDim.x, ...,
// an item being one tile of BQ query rows of one head and batch element
// (query tiles fastest, then heads: the blocks that share a head's K and V
// run together and meet them in L2). (BQ / 64 + 1) warpgroups: the
// consumers first (wgmma wants warpgroup-aligned warps), the producer
// last. The ring runs on across items, and Q has two buffers, so the
// producer loads the next item while the consumers finish this one. In
// the accumulator of an m64nN wgmma, warp w of the warpgroup holds rows
// 16 w .. 16 w + 15; its thread (g = lane / 4, t = lane % 4) holds, of each
// 8 columns j, (row g, columns 8 j + 2 t, + 1) in d[4 j], d[4 j + 1] and
// (row g + 8, the same columns) in d[4 j + 2], d[4 j + 3].
template <int BQ, int BK>
__global__ void __launch_bounds__((BQ / 64 + 1) * kWarpgroup,
                                  Regs<BQ>::blocks_per_sm)
    blockwise_attention_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ bias, bf16* __restrict__ out, int Sq,
        int Sk, int num_heads, int B, int key_mode, long long bias_sb,
        long long bias_sq, long long bias_sk, float scale_log2) {
  constexpr int kConsumers = BQ / 64;
  constexpr int kStages = stages(BQ, BK);
  constexpr int kTile = BK * kRowBytes;   // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char smem[];
  // the tiles start on a boundary of the swizzle's atom
  const unsigned q_s = (smem_u32(smem) + kSpan - 1) & ~(kSpan - 1u);
  const unsigned k_s = q_s + 2 * BQ * kRowBytes;   // two Q buffers, then
  const unsigned v_s = k_s + kStages * kTile;      // kStages K and V tiles
  const unsigned bars = v_s + kStages * kTile;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto q_full = [&](int i) { return bars + 8 * (2 * kStages + i); };
  auto q_empty = [&](int i) { return bars + 8 * (2 * kStages + 2 + i); };

  // the warpgroup, broadcast from lane 0 so that ptxas knows it uniform
  // across the warp (else the wgmma under a branch on it is serialised)
  const int tid = threadIdx.x,
            wg = __shfl_sync(0xffffffffu, tid / kWarpgroup, 0);
  const int n_q = (Sq + BQ - 1) / BQ, n_tiles = (Sk + BK - 1) / BK;
  const int n_items = n_q * num_heads * B;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);   // one arrival a consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // the producer: one thread keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * kWarpgroup) {
      int kv = 0, it = 0;   // K/V tiles and items loaded so far
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int qt = item % n_q, h = item / n_q % num_heads,
                  b = item / (n_q * num_heads);
        const int qb = it & 1;
        // the buffer's previous query tile consumed (the first round
        // passes)
        mbar_wait(q_empty(qb), ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full(qb), BQ * kRowBytes);
        tma_load_3d(q_s + qb * BQ * kRowBytes, &tm_q, h * kHeadDim, qt * BQ,
                    b, q_full(qb));
        for (int t = 0; t < n_tiles; ++t, ++kv) {
          const int s = kv % kStages;
          mbar_wait(empty(s), ((kv / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), 2 * kTile);
          tma_load_3d(k_s + s * kTile, &tm_k, h * kHeadDim, t * BK, b,
                      full(s));
          tma_load_3d(v_s + s * kTile, &tm_v, h * kHeadDim, t * BK, b,
                      full(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<Regs<BQ>::consumer>();
    const int lane = tid & 31, warp = (tid % kWarpgroup) >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int my_row = wg * 64 + warp * 16 + g;   // in the query tile
    // two adjacent keys in one 8-byte load where the strides allow it
    const bool pairs = bias_sk == 1 && (key_mode || bias_sq % 2 == 0) &&
                       bias_sb % 2 == 0 &&
                       (reinterpret_cast<size_t>(bias) & 7) == 0;
    // this warp is done with the K/V stage of ring tile i (or with query
    // buffer i): the producer may refill it
    auto release = [&](unsigned bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // one work item: the block's it-th, number `item` (its query tile
    // fastest, then its head, then its batch element); what else an item
    // needs is recomputed where it is used rather than held in registers
    struct Item {
      int item, it;
    };
    auto qtile = [&](const Item& w) { return w.item % n_q; };
    auto active = [&](const Item& w) {   // warpgroup-uniform
      return qtile(w) * BQ + wg * 64 < Sq;
    };
    // the bias row of this thread's row r (key bias: the batch's one row;
    // full bias: rows past Sq run on the last row's bias, never stored)
    auto bias_row = [&](const Item& w, int r) {
      const int b = w.item / (n_q * num_heads);
      return bias + b * bias_sb +
             min(qtile(w) * BQ + my_row + 8 * r, Sq - 1) * bias_sq;
    };

    // every item of this block, specialised on the bias mode (a key bias
    // is one row for both of the thread's rows)
    auto run = [&](auto key_c) {
      constexpr bool KEY = decltype(key_c)::value;
      constexpr int R = KEY ? 1 : 2;
      float o[32];                 // O of the item (accumulator layout)
      float m[2], l[2];            // l: this thread's part of the row sum
      // keys whose bias is held at once (at BK = 128 half the tile: S, O
      // and P take the registers)
      constexpr int kChunk = 64;
      float sc[BK / 2];            // S of one tile
      float2 bv[kChunk / 8][R];    // bias of a chunk: keys 8 j + 2 t4 (+ 1)
      unsigned pa[2][BK / 16][4];  // P, A operand of P V, two buffers

      // the ring tile of the item's key tile t and its stage
      auto ring = [&](const Item& w, int t) { return w.it * n_tiles + t; };
      auto stage = [&](const Item& w, int t) {
        return ring(w, t) % kStages;
      };
      // S = Q K^T of tile t, four k-steps of 16 columns, into sc. Every
      // operand is one 128-byte swizzle span wide: K-major Q and K (a
      // k-step of 16 columns moves the start 32 bytes along the swizzled
      // row) and MN-major V (a k-step of 16 keys moves it 2048 bytes).
      // Their 8-row groups lie 1024 bytes apart; the other offset, to the
      // next span of the contiguous dimension, is never taken at width 64,
      // and is given the same value, so neither reading of the two fields
      // can differ.
      auto issue_s = [&](const Item& w, int t) {
        const int s = stage(w, t);
        mbar_wait(full(s), (ring(w, t) / kStages) & 1);
        const uint64_t q_desc = wgmma_desc(
            q_s + ((w.it & 1) * BQ + wg * 64) * kRowBytes, kSpan, kSpan);
        const uint64_t k_desc = wgmma_desc(k_s + s * kTile, kSpan, kSpan);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHeadDim / 16; ++kk)
          wgmma_qk<BK>(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
        wgmma_commit();
      };
      // the bias of this thread's elements of chunk c of tile t: one
      // straight run of loads, all in flight together (zeros past Sk,
      // masked later)
      auto load_bias = [&](const Item& w, int t, int c) {
        const int k0 = t * BK + c * kChunk;
        const float* brow[R];
#pragma unroll
        for (int r = 0; r < R; ++r) brow[r] = bias_row(w, r);
        if (pairs && k0 + kChunk <= Sk) {
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
            for (int r = 0; r < R; ++r)
              bv[j][r] = *reinterpret_cast<const float2*>(
                  brow[r] + k0 + 8 * j + 2 * t4);
        } else {
          const float* src[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            src[r] = brow[r] + (long long)(k0 + 2 * t4) * bias_sk;
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j) {
            const int key = k0 + 8 * j + 2 * t4;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              bv[j][r].x = key < Sk ? src[r][0] : 0.f;
              bv[j][r].y = key + 1 < Sk ? src[r][bias_sk] : 0.f;
              src[r] += 8 * bias_sk;
            }
          }
        }
      };
      // the online softmax of tile t from sc and the bias (its first
      // chunk already in bv) into P (p), m and l; returns the rescale of O
      // in alpha
      auto softmax = [&](const Item& w, int t, unsigned (&p)[BK / 16][4],
                         float (&alpha)[2]) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
        // scores in log2 units, keys past Sk at -inf; the row maxima
        const int k0 = t * BK;
        const bool ragged = k0 + BK > Sk;   // uniform
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int key = k0 + 8 * j + 2 * t4;
          if (j > 0 && j % (kChunk / 8) == 0)
            load_bias(w, t, j / (kChunk / 8));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 bb = bv[j % (kChunk / 8)][KEY ? 0 : r];
            float s0 = fmaf(sc[4 * j + 2 * r], scale_log2, bb.x * kLog2e);
            float s1 = fmaf(sc[4 * j + 2 * r + 1], scale_log2, bb.y * kLog2e);
            if (ragged) {
              if (key >= Sk) s0 = -INFINITY;
              if (key + 1 >= Sk) s1 = -INFINITY;
            }
            sc[4 * j + 2 * r] = s0;
            sc[4 * j + 2 * r + 1] = s1;
            mx[r] = fmaxf(mx[r], fmaxf(s0, s1));
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);  // finite
          alpha[r] = fast_exp2(m[r] - m_new);
          m[r] = m_new;
        }
        // p, rounded to bf16, packed as the A operand of P V (keys 16 kk
        // .. 16 kk + 15: the thread's columns of the n8 tiles 2 kk and
        // 2 kk + 1); l sums the unrounded p
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = fast_exp2(sc[4 * j + 2 * r] - m[r]);
            const float p1 = fast_exp2(sc[4 * j + 2 * r + 1] - m[r]);
            psum[r] += p0 + p1;
            p[j / 2][(j % 2) * 2 + r] = pack_bf16(p0, p1);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
      };
      auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
      };
      // O += P V of tile t, one k-step of 16 keys at a time
      auto issue_pv = [&](const Item& w, int t,
                          const unsigned (&p)[BK / 16][4]) {
        const uint64_t v_desc =
            wgmma_desc(v_s + stage(w, t) * kTile, kSpan, kSpan);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n64k16_rs(o, p[kk], v_desc + kk * (16 * kRowBytes >> 4));
        wgmma_commit();
      };
      // P V of tile t done: O final for the rescale, tile t's stage free
      auto finish_pv = [&](const Item& w, int t, unsigned (&p)[BK / 16][4]) {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(o[i]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_operand(p[kk][i]);
        release(empty(stage(w, t)));
      };
      // Tile t of item w, its P in pc: S of tile t + 1 is issued first
      // (sc is free: S of tile t is in pc), then P V of tile t, so the
      // tensor cores run both while this warpgroup computes the softmax of
      // tile t + 1 into pn. At BK = 64 pn is the other buffer, and P V of
      // tile t overlaps that softmax too; at BK = 128 (registers for one
      // buffer) P V completes first.
      auto step = [&](const Item& w, int t, unsigned (&pc)[BK / 16][4],
                      unsigned (&pn)[BK / 16][4]) {
        if (t + 1 == n_tiles) {
          issue_pv(w, t, pc);
          finish_pv(w, t, pc);
          return;
        }
        issue_s(w, t + 1);
        issue_pv(w, t, pc);
        load_bias(w, t + 1, 0);
        float alpha[2];
        if constexpr (BK == 64) {
          wgmma_wait<1>();   // S of tile t + 1 (P V of tile t may run on)
          softmax(w, t + 1, pn, alpha);
          finish_pv(w, t, pc);
        } else {
          finish_pv(w, t, pc);
          softmax(w, t + 1, pn, alpha);
        }
        rescale(alpha);
      };
      // the first tile's S and bias of an item whose rows this warpgroup
      // has (issued while the previous item's O is written out)
      auto start = [&](const Item& w) {
        mbar_wait(q_full(w.it & 1), (w.it >> 1) & 1);
        issue_s(w, 0);
        load_bias(w, 0, 0);
      };

      Item w{(int)blockIdx.x, 0};   // the grid holds no idle block
      if (active(w)) start(w);
      for (; w.item < n_items; w.item += gridDim.x, ++w.it) {
        const int next = w.item + gridDim.x;
        if (!active(w)) {
          // this warpgroup's rows all lie past Sq: it only keeps the ring
          mbar_wait(q_full(w.it & 1), (w.it >> 1) & 1);
          for (int t = 0; t < n_tiles; ++t) {
            mbar_wait(full(stage(w, t)), (ring(w, t) / kStages) & 1);
            release(empty(stage(w, t)));
          }
          release(q_empty(w.it & 1));
          if (next < n_items && active(Item{next, w.it + 1}))
            start(Item{next, w.it + 1});
          continue;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
        m[0] = m[1] = kMinusBig;
        l[0] = l[1] = 0.f;
        wgmma_wait<0>();
        {
          float alpha[2];
          softmax(w, 0, pa[0], alpha);   // O is zero: no rescale
        }
        if constexpr (BK == 64) {
          for (int t = 0; t < n_tiles; t += 2) {
            step(w, t, pa[0], pa[1]);
            if (t + 1 == n_tiles) break;
            step(w, t + 1, pa[1], pa[0]);
          }
        } else {
          for (int t = 0; t < n_tiles; ++t) step(w, t, pa[0], pa[0]);
        }
        // ... and with the query tile
        release(q_empty(w.it & 1));

        // at BK = 64 the next item's first S and bias in flight, then this
        // O out (at 128 the registers hold one tile's S and O, not both)
        const Item after{next, w.it + 1};
        if constexpr (BK == 64)
          if (next < n_items && active(after)) start(after);
        const long long D = (long long)num_heads * kHeadDim;  // a row
        const int h = w.item / n_q % num_heads,
                  b = w.item / (n_q * num_heads);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          const int row = qtile(w) * BQ + my_row + 8 * r;
          if (row < Sq) {
            const float inv = 1.f / l[r];
            bf16* orow = out + ((long long)b * Sq + row) * D + h * kHeadDim;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
                  __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                        o[4 * j + 2 * r + 1] * inv);
          }
        }
        if constexpr (BK == 128)
          if (next < n_items && active(after)) start(after);
      }
    };
    if (key_mode)
      run(std::true_type{});
    else
      run(std::false_type{});
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and the launch
// ---------------------------------------------------------------------------

// The 3-D map of a (B, S, num_heads * 64) tensor of `elt`-byte elements
// (2: bf16, 4: fp32) whose rows are ld elements apart and whose batches S
// rows apart: dims (num_heads * 64, S, B), byte strides (ld * elt,
// S * ld * elt), a box of one 128-byte swizzle span of columns (64 bf16,
// 32 fp32: half a head) by `rows` rows of one batch element, 128-byte
// swizzled; what lies past S in a box is filled with zeros.
inline bool tensor_map(CUtensorMap* map, const void* base, int num_heads,
                       int S, int B, long long ld, int rows, int elt) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)num_heads * kHeadDim,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * elt,
                                 (cuuint64_t)S * ld * elt};
  const cuuint32_t box[3] = {(cuuint32_t)(kRowBytes / elt),
                             (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BQ, int BK>
cudaError_t launch_wgmma_tile(const void* q, const void* k, const void* v,
                              const float* bias, void* out, long long ldq,
                              long long ldk, long long ldv, int B, int Sq,
                              int Sk, int num_heads, int key_mode,
                              long long sb, long long sq, long long sk,
                              float scale, cudaStream_t stream) {
  auto kernel = blockwise_attention_wgmma_kernel<BQ, BK>;
  const size_t smem = wgmma_smem_bytes(BQ, BK);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // setmaxnreg's counts balance only at the launch count they were set
  // for: refuse a build that launches with another rather than risk a
  // consumer waiting for registers that never come
  static const int regs = [&] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs
                                                               : -1;
  }();
  if (regs != Regs<BQ>::launch) return cudaErrorInvalidKernelImage;
  // one block an SM per Regs<BQ>::blocks_per_sm, none idle
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, num_heads, Sq, B, ldq, BQ, 2) ||
      !tensor_map(&tk, k, num_heads, Sk, B, ldk, BK, 2) ||
      !tensor_map(&tv, v, num_heads, Sk, B, ldv, BK, 2))
    return cudaErrorInvalidValue;
  const long long items = (long long)(Sq + BQ - 1) / BQ * num_heads * B;
  if (items > INT_MAX) return cudaErrorInvalidValue;   // the kernel's count
  const int grid =
      (int)std::min<long long>(items, (long long)sms * Regs<BQ>::blocks_per_sm);
  kernel<<<grid, (BQ / 64 + 1) * kWarpgroup, smem, stream>>>(
      tq, tk, tv, bias, static_cast<bf16*>(out), Sq, Sk, num_heads, B,
      key_mode, sb, sq, sk, scale * kLog2e);
  return cudaGetLastError();
}

// block_q and block_k each 64 or 128
inline cudaError_t launch_wgmma(int bq, int bk, const void* q, const void* k,
                                const void* v, const float* bias, void* out,
                                long long ldq, long long ldk, long long ldv,
                                int B, int Sq, int Sk, int num_heads,
                                int key_mode, long long sb, long long sq,
                                long long sk, float scale,
                                cudaStream_t stream) {
#define ICKA_WGMMA(BQ, BK)                                                   \
  if (bq == BQ && bk == BK)                                                  \
    return launch_wgmma_tile<BQ, BK>(q, k, v, bias, out, ldq, ldk, ldv, B,   \
                                     Sq, Sk, num_heads, key_mode, sb, sq,    \
                                     sk, scale, stream);
  ICKA_WGMMA(64, 64)
  ICKA_WGMMA(64, 128)
  ICKA_WGMMA(128, 64)
  ICKA_WGMMA(128, 128)
#undef ICKA_WGMMA
  return cudaErrorInvalidValue;
}

}  // namespace icka_wgmma
