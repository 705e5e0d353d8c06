// The fp32 attention body at head width 64 for Hopper (sm_90a): 3xTF32 on
// wgmma, with TMA-fed shared memory and the operands split in shared
// memory.
//
// Replaces, for fp32 at head width 64 (the flagship's and gate_cl's fp32
// serving and evaluation, the chunker, the captioner, the VCR plane and
// a tensor-parallel rank's heads), both TPU kernels of
// icka_tpu/kernels/attention.py: `fused_attention` (:87) and
// `fused_attention_blockwise` (:246). It computes the function of
// blockwise_attention.cu's bodies on their fp32 contract, held to 2e-5 of
// the plain versions: each product in 3xTF32 (each operand split as
// x = hi + lo, hi = tf32(x) and lo = tf32(x - hi) rounded as cvt.rna rounds;
// lo*hi, hi*lo and hi*hi summed into one fp32 accumulator, lo*lo dropped),
// Q and K split for the scores, p and V for the output, p itself not
// rounded and l summing the unsplit p; the online softmax over key tiles
// with the running maximum starting at -1e30, on scores prescaled by
// log2 e and exponentiated with exp2; q, k and v read through a row
// stride each; a key-mode (B, Sk) or full (B, Sq, Sk) bias through
// strides; ragged Sq and Sk masked; the output contiguous fp32.
//
// What bounds it: at B = 128, 16 heads of 64, S = 150, it moves 315 MB
// (0.094 ms at 3.35 TB/s) against three TF32 products of 11.8 GFLOP
// (0.072 ms at the 494.7 TFLOP/s TF32 peak): bytes bound it, but only just,
// so the three products must run at the tensor cores' rate, which on
// Hopper only wgmma reaches, and K and V must stream by TMA.
//
// The design, attention_wgmma.cuh's scaffolding at fp32. A work item is
// BQ = 64 or 128 query rows of one head and batch element, walked by a
// persistent grid of one block an SM (shared memory holds one). A block has
// one consumer warpgroup per 64 rows and a producer warpgroup. What differs
// from the bf16 body follows from two facts of the card:
//
// (1) TF32 wgmma takes both operands K-major only (no transpose bit for
// 32-bit types). S = Q K^T fits as stored: Q and K are (rows, dims), dims
// contiguous, both read from shared memory. P V does not: V is keys-major.
// So the body writes V^T (dims, keys; keys contiguous) into shared memory
// itself. P is the A operand from registers, and the S accumulator holds
// keys 2t and 2t + 1 of each 8 for thread (g, t) where the m64k8 A fragment
// holds k-positions t and t + 4: V^T takes key 2t at k-position t and key
// 2t + 1 at t + 4 within each group of 8 keys, so P goes from the
// accumulator to A with no shuffle (the permutation of
// blockwise_attention.cu's 3xTF32 body, written here by the transpose at
// no cost).
//
// (2) A B operand cannot be split in registers, so the split planes live in
// shared memory: TMA lands Q, K and V (fp32 rows of a head are 256 bytes,
// two 128-byte swizzle spans: each is loaded as two column panels of 32);
// three warps of the producer warpgroup (the fourth issues the TMA loads)
// round Q and K to their hi parts in place and write their lo planes
// beside them at the same swizzled offsets, and write V^T's hi and lo
// planes from V's landing buffer, 16-byte stores a lane, each 8 lanes on
// 8 distinct 16-byte bank groups under the swizzle. K and V move through
// two rings of two stages each, a K stage (K hi, K lo) and a V stage (V as
// landed, V^T hi, V^T lo), 80 KB a key tile of 64 in all, and each
// transform has its own barrier between "landed by TMA" (full) and "ready
// for wgmma" (ready), each writer fencing its stores to the async proxy
// before it arrives. The rings are apart because the consumers hold K of
// tile t + 1 and V of tile t at once: a K stage is free once its S has
// completed and a V stage once its P V has, so each ring loads and
// transforms its next tile a whole iteration ahead (in one ring of two
// stages the load and transform of tile t + 2 waited for P V of tile t,
// and its latency showed on every tile). Two stages of each and the query
// planes fill the 227 KB: Q has two buffers at BQ = 64 and one at 128,
// released by the consumers as soon as the item's last S has completed,
// so the next item's Q loads and splits under this item's last P V and
// store.
//
// The consumers run S = Q K^T as 3 x 8 wgmma m64n64k8 from shared memory
// (lo*hi, hi*lo, hi*hi, each over the eight k-steps: a k-step moves the
// descriptors 32 bytes along a swizzled row, and the fifth moves them to
// the next column panel), the softmax on the accumulator as the bf16 body
// does (fma(acc, scale log2 e, bias log2 e), exp2, quad reductions, the
// bias read by each thread for its own elements), p split into hi and lo A
// fragments, then O += P V as 3 x 8 wgmma from registers against V^T. S of
// tile t + 1 and P V of tile t are issued together and the softmax of
// tile t + 1 runs after both have completed (at BQ = 128 the tensor cores
// run one warpgroup's products while the other computes its softmax).
// The softmax under P V in flight, as the bf16 body runs it, took 1.57x
// the time at BQ = 64 (S = 150, B = 128, 16 heads; NVIDIA H100 80GB HBM3,
// 700 W) and did not fit BQ = 128's 224 registers a consumer thread. One
// key tile of 64; instances BQ in {64, 128}.

#pragma once

#include "attention_wgmma.cuh"

namespace icka_wgmma_tf32 {

using namespace icka_attention;
using namespace icka_ptx;
using icka_wgmma::fast_exp2;
using icka_wgmma::kHeadDim;
using icka_wgmma::kLog2e;
using icka_wgmma::kRowBytes;   // one 128-byte swizzle span: 32 fp32
using icka_wgmma::kSpan;       // the swizzle's atom: 8 rows of 128 bytes
using icka_wgmma::kWarpgroup;

constexpr int kBlockK = 64;        // keys a tile: the body's one key tile
constexpr int kPanel = kRowBytes / 4;   // fp32 columns of a column panel
constexpr int kStages = 2;
constexpr int kTransformWarps = 3;      // of the producer warpgroup
constexpr int kTransformThreads = 32 * kTransformWarps;

// Bytes of a plane of `rows` rows of one head: two column panels of rows
// x 128 bytes
__host__ __device__ constexpr int plane_bytes(int rows) {
  return rows * kHeadDim * 4;
}

// Query buffers (each a hi and a lo plane): two at BQ = 64, one at 128,
// where a second would not fit beside the two stages
__host__ __device__ constexpr int q_buffers(int bq) { return bq == 64 ? 2 : 1; }

// Bytes of dynamic shared memory at block_q bq: up to 1024 bytes to align
// the planes to the swizzle's atom, the query buffers, the K stages (K hi,
// K lo) and the V stages (V as landed, V^T hi, V^T lo), then a full, a
// ready and an empty barrier for each stage of both rings and each query
// buffer. The Python wrapper computes the same sum (`_smem_bytes`).
inline size_t tf32_wgmma_smem_bytes(int bq) {
  const int nq = q_buffers(bq);
  return kSpan + (size_t)nq * 2 * plane_bytes(bq) +
         (size_t)kStages *
             (3 * plane_bytes(kBlockK) + 2 * plane_bytes(kHeadDim)) +
         (6 * kStages + 3 * nq) * 8;
}

// Registers at BQ = 128 (three warpgroups, one block an SM): the launch
// count the launch bounds give ptxas, what the producer warpgroup keeps
// (the TMA thread and the transform) and what each consumer takes; the
// producer's release of (168 - 56) x 128 pays exactly for the two
// consumers' rise of 2 x (224 - 168) x 128. At BQ = 64 (two warpgroups of
// up to 255 registers in one block an SM) nothing is moved.
struct Regs128 {
  static constexpr int launch = 168, producer = 56, consumer = 224;
};

// generic pointer to the shared-memory address `addr` (of smem_u32)
template <typename T>
__device__ __forceinline__ T* at(unsigned char* smem, unsigned addr) {
  return reinterpret_cast<T*>(smem + (addr - smem_u32(smem)));
}

// x's hi part in place, its lo part at the same offset of the lo plane
__device__ __forceinline__ void split4(float4& x, float4& lo) {
  unsigned h, l;
  split_tf32(x.x, h, l), x.x = __uint_as_float(h), lo.x = __uint_as_float(l);
  split_tf32(x.y, h, l), x.y = __uint_as_float(h), lo.y = __uint_as_float(l);
  split_tf32(x.z, h, l), x.z = __uint_as_float(h), lo.z = __uint_as_float(l);
  split_tf32(x.w, h, l), x.w = __uint_as_float(h), lo.w = __uint_as_float(l);
}

// A persistent grid: block i takes the work items i, i + gridDim.x, ...,
// an item being one tile of BQ query rows of one head and batch element
// (query tiles fastest, then heads, then batch elements). (BQ / 64 + 1)
// warpgroups: the consumers first, the producer last. In the accumulator
// of an m64n64 wgmma, warp w of a warpgroup holds rows 16 w .. 16 w + 15;
// its thread (g = lane / 4, t = lane % 4) holds, of each 8 columns j, (row
// g, columns 8 j + 2 t, + 1) in d[4 j], d[4 j + 1] and (row g + 8, the same
// columns) in d[4 j + 2], d[4 j + 3].
template <int BQ>
__global__ void __launch_bounds__((BQ / 64 + 1) * kWarpgroup, 1)
    blockwise_attention_wgmma_tf32_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ bias, float* __restrict__ out, int Sq,
        int Sk, int num_heads, int B, int key_mode, long long bias_sb,
        long long bias_sq, long long bias_sk, float scale_log2) {
  constexpr int kConsumers = BQ / 64;
  constexpr int NQ = q_buffers(BQ);
  // the bias of tile t + 1 loaded under S of tile t + 1 and P V of tile
  // t, where the registers hold it beside S, O and P's fragments (at
  // BQ = 128, with 224 a consumer thread, they spilled)
  constexpr bool kPrefetchBias = BQ == 64;
  constexpr int kQPlane = plane_bytes(BQ);
  constexpr int kKPlane = plane_bytes(kBlockK);   // K hi, K lo, V landed
  constexpr int kVPlane = plane_bytes(kHeadDim);  // V^T hi, V^T lo
  constexpr int kStage = 3 * kKPlane + 2 * kVPlane;   // a K and a V stage
  extern __shared__ __align__(1024) unsigned char smem[];
  // the planes start on a boundary of the swizzle's atom: query buffer i
  // (its hi plane, then its lo plane), then stage s of each ring
  const unsigned q0 = (smem_u32(smem) + kSpan - 1) & ~(kSpan - 1u);
  auto q_hi = [&](int i) { return q0 + i * 2 * kQPlane; };
  const unsigned s0 = q0 + NQ * 2 * kQPlane;
  auto k_hi = [&](int s) { return s0 + s * kStage; };     // K lo after it
  auto v_in = [&](int s) { return k_hi(s) + 2 * kKPlane; };
  auto vt_hi = [&](int s) { return k_hi(s) + 3 * kKPlane; };  // lo after
  // barriers: full (TMA's bytes), ready (the transform's three warps) and
  // empty (one arrival a consumer warp) of K stage s, of V stage s, and
  // of query buffer i
  const unsigned bars = s0 + kStages * kStage;
  auto k_full = [&](int s) { return bars + 8 * s; };
  auto k_ready = [&](int s) { return bars + 8 * (kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 * kStages + s); };
  auto v_full = [&](int s) { return bars + 8 * (3 * kStages + s); };
  auto v_ready = [&](int s) { return bars + 8 * (4 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (5 * kStages + s); };
  auto q_full = [&](int i) { return bars + 8 * (6 * kStages + i); };
  auto q_ready = [&](int i) { return bars + 8 * (6 * kStages + NQ + i); };
  auto q_empty = [&](int i) { return bars + 8 * (6 * kStages + 2 * NQ + i); };

  // the warpgroup and the warp, broadcast from lane 0 so that ptxas knows
  // them uniform across the warp (else a wgmma under a branch on them is
  // serialised)
  const int tid = threadIdx.x, lane = tid & 31,
            wg = __shfl_sync(0xffffffffu, tid / kWarpgroup, 0),
            warp = __shfl_sync(0xffffffffu, (tid % kWarpgroup) >> 5, 0);
  const int n_q = (Sq + BQ - 1) / BQ, n_tiles = (Sk + kBlockK - 1) / kBlockK;
  const int n_items = n_q * num_heads * B;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_ready(s), kTransformWarps);
      mbar_init(k_empty(s), kConsumers * 4);
      mbar_init(v_full(s), 1);
      mbar_init(v_ready(s), kTransformWarps);
      mbar_init(v_empty(s), kConsumers * 4);
    }
    for (int i = 0; i < NQ; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_ready(i), kTransformWarps);
      mbar_init(q_empty(i), kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    if constexpr (BQ == 128) setmaxnreg_dec<Regs128::producer>();
    if (warp == 0) {
      // one thread keeps the rings full: per item its query tile, then
      // its key tiles, K and V each as two column panels
      if (lane == 0) {
        int kv = 0, it = 0;
        for (int item = blockIdx.x; item < n_items;
             item += gridDim.x, ++it) {
          const int qt = item % n_q, h = item / n_q % num_heads,
                    b = item / (n_q * num_heads), qb = it % NQ;
          mbar_wait(q_empty(qb), ((it / NQ) & 1) ^ 1);
          mbar_arrive_expect_tx(q_full(qb), kQPlane);
          for (int p = 0; p < 2; ++p)
            tma_load_3d(q_hi(qb) + p * BQ * kRowBytes, &tm_q,
                        h * kHeadDim + p * kPanel, qt * BQ, b, q_full(qb));
          for (int t = 0; t < n_tiles; ++t, ++kv) {
            const int s = kv % kStages, parity = ((kv / kStages) & 1) ^ 1;
            mbar_wait(k_empty(s), parity);
            mbar_arrive_expect_tx(k_full(s), kKPlane);
            for (int p = 0; p < 2; ++p)
              tma_load_3d(k_hi(s) + p * kBlockK * kRowBytes, &tm_k,
                          h * kHeadDim + p * kPanel, t * kBlockK, b,
                          k_full(s));
            mbar_wait(v_empty(s), parity);
            mbar_arrive_expect_tx(v_full(s), kKPlane);
            for (int p = 0; p < 2; ++p)
              tma_load_3d(v_in(s) + p * kBlockK * kRowBytes, &tm_v,
                          h * kHeadDim + p * kPanel, t * kBlockK, b,
                          v_full(s));
          }
        }
      }
    } else {
      // the transform, in the rings' order: split each query tile and
      // each K tile in place (hi) and beside it (lo), and write V^T's
      // planes
      const int tt = tid % kWarpgroup - 32;   // 0 .. 95
      // the plane of `bytes` bytes at addr; its lo plane follows it
      auto split_plane = [&](unsigned addr, int bytes) {
        float4* hi = at<float4>(smem, addr);
        float4* lo = at<float4>(smem, addr + bytes);
        for (int i = tt; i < bytes / 16; i += kTransformThreads) {
          float4 x = hi[i], l;
          split4(x, l);
          hi[i] = x;
          lo[i] = l;
        }
      };
      // V (keys x dims as landed: two panels of 32 dims, row = key) into
      // V^T (dims x keys: two panels of 32 keys, row = dim), hi and lo. A
      // lane owns a dim and a group of 8 keys: it reads the 8 keys of its
      // dim (a warp reads 32 dims of a key row, 32 banks) and writes the
      // 8 k-positions of its row, keys 0, 2, 4, 6 then 1, 3, 5, 7, as two
      // 16-byte chunks a plane. Swizzle: 16-byte chunk c of row r lies at
      // chunk c ^ (r % 8) of the row.
      auto transpose_v = [&](int s) {
        const float* vin = at<float>(smem, v_in(s));
        float4* vh = at<float4>(smem, vt_hi(s));
        float4* vl = at<float4>(smem, vt_hi(s) + kVPlane);
        for (int u = tt; u < kHeadDim * (kBlockK / 8);
             u += kTransformThreads) {
          const int d = u % kHeadDim, j = u / kHeadDim;
          const int dp = d / kPanel, dc = (d % kPanel) / 4, de = d % 4;
          float x[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            x[k] = vin[(dp * kBlockK + 8 * j + k) * kPanel +
                       ((dc ^ k) * 4) + de];
          // keys 8 j .. 8 j + 7 are k-positions 8 j .. of panel j / 4,
          // chunks 2 (j % 4) (even keys) and + 1 (odd keys)
          const int row = (j / 4) * kHeadDim + d, c = 2 * (j % 4);
#pragma unroll
          for (int odd = 0; odd < 2; ++odd) {
            float4 h = make_float4(x[odd], x[odd + 2], x[odd + 4],
                                   x[odd + 6]),
                   l;
            split4(h, l);
            const int at16 = row * (kPanel / 4) + ((c + odd) ^ (d % 8));
            vh[at16] = h;
            vl[at16] = l;
          }
        }
      };
      int kv = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int qb = it % NQ;
        mbar_wait(q_full(qb), (it / NQ) & 1);
        split_plane(q_hi(qb), kQPlane);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(q_ready(qb));
        for (int t = 0; t < n_tiles; ++t, ++kv) {
          const int s = kv % kStages, parity = (kv / kStages) & 1;
          mbar_wait(k_full(s), parity);
          split_plane(k_hi(s), kKPlane);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(k_ready(s));
          mbar_wait(v_full(s), parity);
          transpose_v(s);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(v_ready(s));
        }
      }
    }
  } else {
    if constexpr (BQ == 128) setmaxnreg_inc<Regs128::consumer>();
    const int g = lane >> 2, t4 = lane & 3;
    const int my_row = wg * 64 + warp * 16 + g;   // in the query tile
    // two adjacent keys in one 8-byte load where the strides allow it
    const bool pairs = bias_sk == 1 && (key_mode || bias_sq % 2 == 0) &&
                       bias_sb % 2 == 0 &&
                       (reinterpret_cast<size_t>(bias) & 7) == 0;
    // this warp is done with what barrier `bar` guards: the producer may
    // refill it
    auto release = [&](unsigned bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // one work item: the block's it-th, number `item`
    struct Item {
      int item, it;
    };
    auto qtile = [&](const Item& w) { return w.item % n_q; };
    auto active = [&](const Item& w) {   // warpgroup-uniform
      return qtile(w) * BQ + wg * 64 < Sq;
    };
    auto bias_row = [&](const Item& w, int r) {
      const int b = w.item / (n_q * num_heads);
      return bias + b * bias_sb +
             min(qtile(w) * BQ + my_row + 8 * r, Sq - 1) * bias_sq;
    };

    auto run = [&](auto key_c) {
      constexpr bool KEY = decltype(key_c)::value;
      constexpr int R = KEY ? 1 : 2;
      float o[32];               // O of the item (accumulator layout)
      float m[2], l[2];          // l: this thread's part of the row sum
      float sc[32];              // S of a tile, then its p
      float2 bv[kBlockK / 8][R]; // bias of a tile: keys 8 j + 2 t4 (+ 1)
      unsigned ph[kBlockK / 8][4], pl[kBlockK / 8][4];  // P's A fragments

      auto ring = [&](const Item& w, int t) { return w.it * n_tiles + t; };
      auto stage = [&](const Item& w, int t) {
        return ring(w, t) % kStages;
      };
      // S = Q K^T of tile t into sc: lo*hi, hi*lo, hi*hi, each over eight
      // k-steps of 8 columns (32 bytes along a swizzled row; the fifth
      // starts the second column panel). The 8-row groups of every plane
      // lie 1024 bytes apart; the other offset is never taken (a k-step
      // stays within a span) and is given the same value.
      auto parity = [&](const Item& w, int t) {
        return (ring(w, t) / kStages) & 1;
      };
      auto issue_s = [&](const Item& w, int t) {
        const int s = stage(w, t);
        mbar_wait(k_ready(s), parity(w, t));
        const unsigned qa = q_hi(w.it % NQ) + wg * 64 * kRowBytes;
        wgmma_fence();
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          const uint64_t a = wgmma_desc(qa + (pass == 0 ? kQPlane : 0),
                                        kSpan, kSpan);
          const uint64_t b = wgmma_desc(k_hi(s) + (pass == 1 ? kKPlane : 0),
                                        kSpan, kSpan);
#pragma unroll
          for (int kk = 0; kk < kHeadDim / 8; ++kk)
            wgmma_m64n64k8_tf32_ss(
                sc, a + (((kk / 4) * BQ * kRowBytes + (kk % 4) * 32) >> 4),
                b + (((kk / 4) * kBlockK * kRowBytes + (kk % 4) * 32) >> 4),
                pass > 0 || kk > 0);
        }
        wgmma_commit();
      };
      // the bias of this thread's elements of tile t: one straight run of
      // loads, all in flight together (zeros past Sk, masked later)
      auto load_bias = [&](const Item& w, int t) {
        const int k0 = t * kBlockK;
        const float* brow[R];
#pragma unroll
        for (int r = 0; r < R; ++r) brow[r] = bias_row(w, r);
        if (pairs && k0 + kBlockK <= Sk) {
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
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
          for (int j = 0; j < kBlockK / 8; ++j) {
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
      // the online softmax of tile t: sc from scores to p (exp2 of the
      // scores in log2 units less the new maximum; keys past Sk at -inf),
      // m and l; returns the rescale of O in alpha
      auto softmax = [&](int t, float (&alpha)[2]) {
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(sc[i]);
        const int k0 = t * kBlockK;
        const bool ragged = k0 + kBlockK > Sk;   // uniform
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
          const int key = k0 + 8 * j + 2 * t4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 bb = bv[j][KEY ? 0 : r];
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
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);  // finite
          alpha[r] = fast_exp2(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = fast_exp2(sc[4 * j + 2 * r] - m[r]);
            const float p1 = fast_exp2(sc[4 * j + 2 * r + 1] - m[r]);
            psum[r] += p0 + p1;
            sc[4 * j + 2 * r] = p0;
            sc[4 * j + 2 * r + 1] = p1;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
      };
      // p split into the A fragments of P V: of k-step j (keys 8 j ..
      // 8 j + 7), position t4 is key 8 j + 2 t4 and t4 + 4 key 8 j + 2 t4 + 1,
      // where the accumulator holds them (V^T's k-positions follow)
      auto split_p = [&]() {
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
          split_tf32(sc[4 * j], ph[j][0], pl[j][0]);       // (g, 2 t4)
          split_tf32(sc[4 * j + 2], ph[j][1], pl[j][1]);   // (g + 8, 2 t4)
          split_tf32(sc[4 * j + 1], ph[j][2], pl[j][2]);   // (g, 2 t4 + 1)
          split_tf32(sc[4 * j + 3], ph[j][3], pl[j][3]);   // (g + 8, + 1)
        }
      };
      // O += P V of tile t: lo*hi, hi*lo, hi*hi, eight k-steps each (a
      // k-step of 8 keys: 32 bytes along V^T's swizzled rows, the fifth
      // starts the second key panel)
      auto pv_pass = [&](const unsigned (&a)[kBlockK / 8][4], unsigned vt) {
        const uint64_t b = wgmma_desc(vt, kSpan, kSpan);
#pragma unroll
        for (int kk = 0; kk < kBlockK / 8; ++kk)
          wgmma_m64n64k8_tf32_rs(
              o, a[kk],
              b + (((kk / 4) * kHeadDim * kRowBytes + (kk % 4) * 32) >> 4));
      };
      auto issue_pv = [&](const Item& w, int t) {
        mbar_wait(v_ready(stage(w, t)), parity(w, t));
        const unsigned vt = vt_hi(stage(w, t));
        wgmma_fence();
        pv_pass(pl, vt);
        pv_pass(ph, vt + kVPlane);
        pv_pass(ph, vt);
        wgmma_commit();
      };

      Item w{(int)blockIdx.x, 0};   // the grid holds no idle block
      for (; w.item < n_items; w.item += gridDim.x, ++w.it) {
        const int qb = w.it % NQ;
        mbar_wait(q_ready(qb), (w.it / NQ) & 1);
        if (!active(w)) {
          // this warpgroup's rows all lie past Sq: it only keeps the rings
          for (int t = 0; t < n_tiles; ++t) {
            mbar_wait(k_ready(stage(w, t)), parity(w, t));
            release(k_empty(stage(w, t)));
            mbar_wait(v_ready(stage(w, t)), parity(w, t));
            release(v_empty(stage(w, t)));
          }
          release(q_empty(qb));
          continue;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
        m[0] = m[1] = kMinusBig;
        l[0] = l[1] = 0.f;
        issue_s(w, 0);
        load_bias(w, 0);
        wgmma_wait<0>();
        release(k_empty(stage(w, 0)));
        if (n_tiles == 1) release(q_empty(qb));   // the item's last S done
        {
          float alpha[2];
          softmax(0, alpha);   // O is zero: no rescale
        }
        split_p();
        for (int t = 0; t < n_tiles; ++t) {
          const bool more = t + 1 < n_tiles;   // uniform
          // S of tile t + 1, then P V of tile t, on the tensor cores
          if (more) issue_s(w, t + 1);
          issue_pv(w, t);
          if constexpr (kPrefetchBias)
            if (more) load_bias(w, t + 1);
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_operand(o[i]);
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              fence_operand(ph[j][i]);
              fence_operand(pl[j][i]);
            }
          release(v_empty(stage(w, t)));
          if (more) {
            release(k_empty(stage(w, t + 1)));
            if (t + 2 == n_tiles) release(q_empty(qb));   // the last S
            if constexpr (!kPrefetchBias) load_bias(w, t + 1);
            float alpha[2];
            softmax(t + 1, alpha);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[4 * j] *= alpha[0];
              o[4 * j + 1] *= alpha[0];
              o[4 * j + 2] *= alpha[1];
              o[4 * j + 3] *= alpha[1];
            }
            split_p();
          }
        }

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
            float* orow = out + ((long long)b * Sq + row) * D + h * kHeadDim;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) =
                  make_float2(o[4 * j + 2 * r] * inv,
                              o[4 * j + 2 * r + 1] * inv);
          }
        }
      }
    };
    if (key_mode)
      run(std::true_type{});
    else
      run(std::false_type{});
  }
}

// ---------------------------------------------------------------------------
// Host: the launch
// ---------------------------------------------------------------------------

template <int BQ>
cudaError_t launch_tf32_tile(const void* q, const void* k, const void* v,
                             const float* bias, void* out, long long ldq,
                             long long ldk, long long ldv, int B, int Sq,
                             int Sk, int num_heads, int key_mode,
                             long long sb, long long sq, long long sk,
                             float scale, cudaStream_t stream) {
  auto kernel = blockwise_attention_wgmma_tf32_kernel<BQ>;
  const size_t smem = tf32_wgmma_smem_bytes(BQ);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // setmaxnreg's counts balance only at the launch count they were set
  // for: refuse a build that launches with another
  if constexpr (BQ == 128) {
    static const int regs = [&] {
      cudaFuncAttributes attr;
      return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess
                 ? attr.numRegs
                 : -1;
    }();
    if (regs != Regs128::launch) return cudaErrorInvalidKernelImage;
  }
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  CUtensorMap tq, tk, tv;
  if (!icka_wgmma::tensor_map(&tq, q, num_heads, Sq, B, ldq, BQ, 4) ||
      !icka_wgmma::tensor_map(&tk, k, num_heads, Sk, B, ldk, kBlockK, 4) ||
      !icka_wgmma::tensor_map(&tv, v, num_heads, Sk, B, ldv, kBlockK, 4))
    return cudaErrorInvalidValue;
  const long long items = (long long)(Sq + BQ - 1) / BQ * num_heads * B;
  if (items > INT_MAX) return cudaErrorInvalidValue;   // the kernel's count
  const int grid = (int)std::min<long long>(items, sms);   // one an SM
  kernel<<<grid, (BQ / 64 + 1) * kWarpgroup, smem, stream>>>(
      tq, tk, tv, bias, static_cast<float*>(out), Sq, Sk, num_heads, B,
      key_mode, sb, sq, sk, scale * kLog2e);
  return cudaGetLastError();
}

// block_q 64 or 128, block_k 64
inline cudaError_t launch_wgmma_tf32(int bq, int bk, const void* q,
                                     const void* k, const void* v,
                                     const float* bias, void* out,
                                     long long ldq, long long ldk,
                                     long long ldv, int B, int Sq, int Sk,
                                     int num_heads, int key_mode,
                                     long long sb, long long sq, long long sk,
                                     float scale, cudaStream_t stream) {
  if (bk != kBlockK) return cudaErrorInvalidValue;
  if (bq == 64)
    return launch_tf32_tile<64>(q, k, v, bias, out, ldq, ldk, ldv, B, Sq, Sk,
                                num_heads, key_mode, sb, sq, sk, scale,
                                stream);
  if (bq == 128)
    return launch_tf32_tile<128>(q, k, v, bias, out, ldq, ldk, ldv, B, Sq,
                                 Sk, num_heads, key_mode, sb, sq, sk, scale,
                                 stream);
  return cudaErrorInvalidValue;
}

}  // namespace icka_wgmma_tf32
