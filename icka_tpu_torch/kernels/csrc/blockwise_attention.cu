// Blockwise (flash-style) multi-head attention for any length and any head
// width, fp32 and bf16, sm_90a.
//
// Replaces both attention kernels of icka_tpu/kernels/attention.py:
// `fused_attention_blockwise` (the Pallas TPU kernel `_flash_kernel`) and,
// at a short-sequence tiling chosen by the Python wrapper,
// `fused_attention` (`_attn_kernel`). For every batch element b and head h:
//
//     out[b, :, h] = softmax(Q_h K_h^T * scale + bias[b]) V_h
//
// (scale = head_dim^-0.5, passed in) computed by the online-softmax
// recurrence over key tiles
//
//     m' = max(m, max_k s);  p = exp(s - m');  a = exp(m - m')
//     l' = a l + sum_k p;    acc' = a acc + round(p) V;   out = acc / l
//
// with m starting at -1e30, not -inf, as in the TPU kernel: a key tile whose
// scores are all -inf (a caller's -inf bias) then gives p = 0 and a = 1
// where -inf would give exp(-inf + inf) = NaN. fp32 inputs give fp32 math;
// bf16 inputs give exact bf16 products summed in fp32, with p rounded to
// bf16 before P.V (sum_k p takes the unrounded p). Output in q's type.
//
// What bounds it: at Sq = Sk = 1024, B = 128, 16 heads of 64 in bf16 the
// function moves Q+K+V+O, 1.07 GB, about 0.32 ms at 3.35 TB/s, against
// 550 GFLOP, about 0.56 ms at the 989 TFLOP/s bf16 tensor-core peak: bound
// by operations from about 600 keys on, by bytes below. In fp32 at the
// serving shape (S = 150, key bias) Q+K+V+O is 315 MB, 0.094 ms, against
// 11.8 GFLOP run as three TF32 products, 0.072 ms at the 494.7 TFLOP/s
// dense TF32 peak: bound by bytes. So the products belong on the tensor
// cores, and K and V are fetched as seldom as possible: a block owns a tile
// of block_q query rows (32, 64 or 128) of one head, and one K/V tile of
// block_k keys (32, 64 or 128), staged in shared memory in the input type,
// serves all of those rows. No score or probability tensor exists in device
// memory. The ragged last tile is masked in both dimensions (keys past Sk
// score -inf, rows past Sq are never stored), so no block size has to
// divide a sequence length.
//
// Three bodies:
//
// bf16 up to head width 128, on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 sums), in the shape of FlashAttention-2. A warp owns 16 query
// rows (one m16 tile), so a block has block_q / 16 warps. The warp's Q
// fragments are read once from the staged query tile with ldmatrix and stay
// in registers for the whole key loop. S = Q K^T takes its B fragments from
// the staged K tile with ldmatrix; the online softmax runs on the
// accumulator fragments (a thread holds two rows, reduced over its quad
// with shuffles); p, rounded to bf16, is packed in registers straight into
// the A fragments of O += P V (the m16n8 accumulator layout of two adjacent
// n8 tiles is the m16k16 A layout), whose V fragments come from
// ldmatrix.trans. O is divided by l at the end. K/V tiles (and the key-bias
// strip) move through cp.async in two stages, tile k + 1 in flight while
// tile k computes, one barrier per tile; rows past Sk arrive as zeros (the
// zero-fill form of cp.async), so p = 0 meets V = 0 and never a stale Inf
// or NaN. Staged rows are padded by 8 elements (16 bytes), which keeps
// every ldmatrix free of bank conflicts. 24 instances, (block_k, head_dim)
// with head_dim in 16..128.
//
// fp32 up to head width 128, on the tensor cores through 3xTF32
// (mma.sync m16n8k8 .tf32, fp32 sums), in the bf16 body's shape: the same
// warps, staging and softmax. TF32 keeps 10 of fp32's 23 mantissa bits, so
// one TF32 product does not hold the fp32 contract (2e-5 against the plain
// version). Each operand x is split as hi = tf32(x), lo = tf32(x - hi)
// (rounded as cvt.rna rounds: to nearest, ties away from zero), and each
// product runs lo*hi, hi*lo and hi*hi into one fp32 accumulator (lo*lo,
// below fp32's last bit, is dropped): about 22 bits of every product
// survive, the counterpart of the TPU kernel's Precision.HIGHEST. Both
// products are split: Q and K for the scores, p and V for the output; p
// itself is not rounded. The query tile is split once into hi and lo planes
// in shared memory and its fragments are re-read from there; K and V are
// split as their fragments are read (32-bit shared loads: ldmatrix moves
// 16-bit elements), which measured faster than hi and lo planes staged per
// tile (twice the bytes and one more barrier). P goes from the score
// accumulator to the A fragment of P V without a shuffle: within one k8
// step the keys may be taken in any order if V's rows follow it, so A
// position t holds key 2t and position t + 4 key 2t + 1, which is where the
// m16n8 accumulator already holds them. Staged rows are padded by 4 floats
// (row stride = 4 mod 32 words): the K fragment K[g][t] reads banks 4g + t
// and the V fragment V[2t][g] banks 8t + g, each 32 distinct. 16
// instances, (block_k 32 or 64, head_dim in 16..128).
//
// Head widths above 128, fp32 and bf16, on the CUDA cores: 8 query rows
// per warp, at most 64 a block, one key tile of 32 (lane j scores key j of
// the tile), p through shared memory. A head is split into column chunks
// of at most 256 (`column_chunk`); the grid has one block per (query tile,
// chunk), and a block stages and writes only its chunk of V and O (lane j
// owns columns j, j + 32, ... of it). The score product runs over the
// whole head, chunk by chunk through the same shared memory, so shared
// memory stays bounded at any width and every block of a query tile
// recomputes its scores. No model of the repo has such a width: this is a
// simple body that is right rather than a fast one. 8 instances, (type,
// chunk width 160, 192, 224 or 256).
//
// Bias: in key mode ((B, Sk), one row for all queries) the block stages the
// tile's strip in shared memory once per K tile, for every row and warp. In
// full mode ((B, Sq, Sk) through strides, e.g. a view of a (B, 1, Sq, Sk)
// block-diagonal mask) the tensor-core bodies read each thread's own
// fragment elements, two adjacent keys at a time, so each bias element is
// read once per (block, head), those of the next 16 keys in flight while
// the product of these runs (with a key bias, read from shared memory, the
// product runs over the whole tile first, every accumulator in flight); the
// wide body reads each warp's (8, 32) part.

#include <type_traits>

#include "attention_common.cuh"
#include "ptx.cuh"

namespace {

using namespace icka_attention;
using namespace icka_ptx;

// Row strides of q, k and v, in elements. A row is num_heads * head_dim
// wide but may lie inside a wider one (q, k and v as views of one fused
// (B, S, 3D) projection); batch b starts at b * S * ld. The output is
// always contiguous (B, Sq, num_heads * head_dim).
struct RowStrides {
  long long q, k, v;
};

// ---------------------------------------------------------------------------
// Head widths above 128: the CUDA-core body, in column chunks
// ---------------------------------------------------------------------------

constexpr int kRows = 8;           // query rows per warp
constexpr int kWideThreads = 256;  // block_q <= 64
constexpr int kWideKeys = 32;      // keys per tile, one per lane
constexpr int kMaxChunk = 256;     // columns a block stages at once, at most
constexpr int kVec = 4;            // elements per staged chunk
constexpr int kPad = 4;            // K/V tile row padding, in elements

// Columns per chunk at head width hd (a multiple of 32): hd itself up to
// 256; above, hd split evenly into the fewest chunks of at most 256, each
// rounded up to a multiple of 32 (the last chunk takes what is left). The
// Python wrapper computes the same (`column_chunk`).
inline int column_chunk(int hd) {
  const int n = (hd + kMaxChunk - 1) / kMaxChunk;
  return ((hd + n - 1) / n + 31) / 32 * 32;
}

// Bytes of dynamic shared memory for bq query rows at chunk width cw: the
// fp32 query chunk, the fp32 probability tile, the key-bias strip, and the
// K and V chunks in the input type with padded rows. The Python wrapper
// computes the same sum (`_smem_bytes`) to pick a tiling that fits.
inline size_t smem_bytes(int bq, int cw, size_t elt) {
  return (size_t)bq * cw * 4 + (size_t)bq * kWideKeys * 4 + kWideKeys * 4 +
         2 * (size_t)kWideKeys * (cw + kPad) * elt;
}

// grid (ceil(Sq / bq) * nc, num_heads, B), bq = 8 * warps of the block,
// nc = ceil(hd / CW) column chunks of CW = 32 * DPL columns; DPL output
// columns per lane.
template <typename T, int DPL>
__global__ void __launch_bounds__(kWideThreads, 1)
    blockwise_attention_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ bias,
                               T* __restrict__ out, RowStrides ld, int Sq,
                               int Sk, int num_heads, int hd, int key_mode,
                               long long bias_sb, long long bias_sq,
                               long long bias_sk, float scale) {
  using Chunk = typename Num<T>::Chunk;
  constexpr int BK = kWideKeys, CW = 32 * DPL, LD = CW + kPad;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int threads = blockDim.x, bq = (threads >> 5) * kRows;
  float* qs = reinterpret_cast<float*>(smem);          // (bq, CW)
  float* ps = qs + bq * CW;                            // (bq, BK)
  float* kbias = ps + bq * BK;                         // (BK,)
  T* ks = reinterpret_cast<T*>(kbias + BK);            // (BK, LD)
  T* vs = ks + BK * LD;                                // (BK, LD)

  const int nc = (hd + CW - 1) / CW;
  const int q0 = blockIdx.x / nc * bq, h = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x % nc * CW;    // this block's output columns:
  const int ow = min(CW, hd - c0);        // c0 .. c0 + ow - 1
  const long long D = (long long)num_heads * hd;  // output row
  const T* qb = q + (long long)b * Sq * ld.q + h * hd;
  const T* kb = k + (long long)b * Sk * ld.k + h * hd;
  const T* vb = v + (long long)b * Sk * ld.v + h * hd;
  const float* bias_b = bias + b * bias_sb;

  const int row0 = warp * kRows;           // this warp's rows of the tile
  const bool active = q0 + row0 < Sq;      // warp-uniform
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMinusBig;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + row0 * BK;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    // scores of 8 rows, key k0 + lane, summed over the head chunk by chunk
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int d0 = c * CW, chunks = min(CW, hd - d0) / kVec;
      __syncthreads();  // the previous chunk or tile consumed
      // the query chunk, converted to fp32; rows past Sq are zero. With
      // one chunk it is staged at the first tile and kept
      if (nc > 1 || k0 == 0)
        for (int i = tid; i < bq * chunks; i += threads) {
          const int r = i / chunks, cc = i % chunks;
          float f[kVec] = {0.f, 0.f, 0.f, 0.f};
          if (q0 + r < Sq)
            Num<T>::unpack(*reinterpret_cast<const Chunk*>(
                               qb + (long long)(q0 + r) * ld.q + d0 + cc * kVec),
                           f);
          *reinterpret_cast<float4*>(qs + r * CW + cc * kVec) =
              make_float4(f[0], f[1], f[2], f[3]);
        }
      for (int i = tid; i < BK * chunks; i += threads) {
        const int r = i / chunks, cc = i % chunks;
        Chunk kc = Num<T>::zero();
        if (k0 + r < Sk)
          kc = *reinterpret_cast<const Chunk*>(
              kb + (long long)(k0 + r) * ld.k + d0 + cc * kVec);
        *reinterpret_cast<Chunk*>(ks + r * LD + cc * kVec) = kc;
      }
      if (c == nc - 1) {  // this block's V chunk and the tile's bias strip
        const int vchunks = ow / kVec;
        for (int i = tid; i < BK * vchunks; i += threads) {
          const int r = i / vchunks, cc = i % vchunks;
          Chunk vc = Num<T>::zero();
          if (k0 + r < Sk)
            vc = *reinterpret_cast<const Chunk*>(
                vb + (long long)(k0 + r) * ld.v + c0 + cc * kVec);
          *reinterpret_cast<Chunk*>(vs + r * LD + cc * kVec) = vc;
        }
        if (key_mode)
          for (int i = tid; i < BK; i += threads)
            kbias[i] = k0 + i < Sk ? bias_b[(k0 + i) * bias_sk] : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      for (int d = 0; d < chunks * kVec; d += kVec) {
        float kf[kVec];
        Num<T>::unpack(*reinterpret_cast<const Chunk*>(ks + lane * LD + d),
                       kf);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 q4 =
              *reinterpret_cast<const float4*>(qs + (row0 + r) * CW + d);
          s[r] = fmaf(q4.x, kf[0], s[r]);
          s[r] = fmaf(q4.y, kf[1], s[r]);
          s[r] = fmaf(q4.z, kf[2], s[r]);
          s[r] = fmaf(q4.w, kf[3], s[r]);
        }
      }
    }
    if (!active) continue;

    // online softmax; rounded p to shared memory for the second product
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // rows past Sq run on the last row's bias and are never stored
      const int qi = min(q0 + row0 + r, Sq - 1);
      if (key < Sk) {
        const float bv =
            key_mode ? kbias[lane] : bias_b[qi * bias_sq + key * bias_sk];
        s[r] = s[r] * scale + bv;
      } else {
        s[r] = -INFINITY;
      }
      const float m_new = fmaxf(m[r], warp_max(s[r]));  // finite
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s[r] - m_new);
      pw[r * BK + lane] = Num<T>::round(p);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += P V, four keys at a time (p is 0 and V is 0 past Sk)
    const int kn = min(BK, (Sk - k0 + kVec - 1) / kVec * kVec);
    for (int j0 = 0; j0 < kn; j0 += kVec) {
      float vf[kVec][DPL];
#pragma unroll
      for (int i = 0; i < kVec; ++i)
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int col = lane + 32 * c;
          vf[i][c] = col < ow ? Num<T>::load(vs + (j0 + i) * LD + col) : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * BK + j0);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          acc[r][c] = fmaf(p4.x, vf[0][c], acc[r][c]);
          acc[r][c] = fmaf(p4.y, vf[1][c], acc[r][c]);
          acc[r][c] = fmaf(p4.z, vf[2][c], acc[r][c]);
          acc[r][c] = fmaf(p4.w, vf[3][c], acc[r][c]);
        }
      }
    }
    __syncwarp();  // the warp's p rows are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + row0 + r;
    if (qi < Sq) {
      T* o = out + ((long long)b * Sq + qi) * D + h * hd + c0;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        if (lane + 32 * c < ow)
          Num<T>::store(o + lane + 32 * c, acc[r][c] * inv);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch_wide_chunk(const void* q, const void* k, const void* v,
                              const float* bias, void* out, RowStrides ld,
                              int B, int Sq,
                              int Sk, int num_heads, int hd, int bq,
                              int key_mode, long long sb, long long sq,
                              long long sk, float scale, cudaStream_t stream) {
  auto kernel = blockwise_attention_kernel<T, DPL>;
  const size_t smem = smem_bytes(bq, 32 * DPL, sizeof(T));
  // above 48 KB the kernel has to be allowed its dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nc = (hd + 32 * DPL - 1) / (32 * DPL);
  const dim3 grid((Sq + bq - 1) / bq * nc, num_heads, B);
  kernel<<<grid, bq / kRows * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), ld, Sq, Sk,
      num_heads, hd, key_mode, sb, sq, sk, scale);
  return cudaGetLastError();
}

// widths above 128 (multiples of 32): one key tile of 32, bq <= 64
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const float* bias, void* out, RowStrides ld, int B,
                        int Sq, int Sk,
                        int num_heads, int hd, int bq, int key_mode,
                        long long sb, long long sq, long long sk, float scale,
                        cudaStream_t stream) {
  if (bq > kWideThreads / 32 * kRows) return cudaErrorInvalidValue;
  switch (column_chunk(hd) / 32) {
#define ICKA_COLS(DPL)                                                      \
  case DPL:                                                                 \
    return launch_wide_chunk<T, DPL>(q, k, v, bias, out, ld, B, Sq, Sk,     \
                                     num_heads, hd, bq, key_mode, sb, sq,   \
                                     sk, scale, stream);
    ICKA_COLS(5)
    ICKA_COLS(6)
    ICKA_COLS(7)
    ICKA_COLS(8)
#undef ICKA_COLS
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaRows = 16;          // query rows per warp: one m16 tile
constexpr int kMmaMaxThreads = 256;   // block_q = 128: 8 warps
constexpr int kRowPad = 8;            // bf16 elements of padding per row

// Bytes of dynamic shared memory of the bf16 body for a (bq, bk) tiling at
// head width hd: the query tile, then two stages of (K tile, V tile), rows
// padded by kRowPad, then two stages of the key-bias strip. The Python
// wrapper computes the same sum (`_smem_bytes`).
inline size_t mma_smem_bytes(int bq, int bk, int hd) {
  const size_t row = (size_t)(hd + kRowPad) * sizeof(bf16);
  return bq * row + 2 * (2 * bk * row + (size_t)bk * sizeof(float));
}

// c (16x8, fp32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even), `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// grid (ceil(Sq / bq), num_heads, B), bq = 16 * warps of the block. In the
// fragments of an m16n8 accumulator, thread (g = lane / 4, t = lane % 4)
// holds rows g and g + 8, columns 2t and 2t + 1. Up to 64 keys and 64
// columns the instance is held to 128 registers a thread, so that two
// blocks share an SM.
template <int BK, int HD>
__global__ void __launch_bounds__(kMmaMaxThreads,
                                  BK <= 64 && HD <= 64 ? 2 : 1)
    blockwise_attention_mma_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const float* __restrict__ bias,
                                   bf16* __restrict__ out, RowStrides ld,
                                   int Sq, int Sk, int num_heads,
                                   int key_mode,
                                   long long bias_sb, long long bias_sq,
                                   long long bias_sk, float scale) {
  constexpr int LD = HD + kRowPad;  // staged row, in elements
  constexpr int CH = HD / 8;        // 16-byte chunks per row
  constexpr int NT = BK / 8;        // n8 tiles of scores per warp
  constexpr int DT = HD / 8;        // n8 tiles of output per warp
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int threads = blockDim.x, bq = (threads >> 5) * kMmaRows;
  bf16* qs = reinterpret_cast<bf16*>(smem);          // (bq, LD)
  bf16* kvs = qs + bq * LD;                          // 2 x (K, V) (BK, LD)
  float* kbias = reinterpret_cast<float*>(kvs + 4 * BK * LD);  // 2 x (BK,)

  const int q0 = blockIdx.x * bq, h = blockIdx.y, b = blockIdx.z;
  const long long D = (long long)num_heads * HD;  // output row
  const bf16* qg = q + (long long)b * Sq * ld.q + h * HD;
  const bf16* kg = k + (long long)b * Sk * ld.k + h * HD;
  const bf16* vg = v + (long long)b * Sk * ld.v + h * HD;
  const float* bias_b = bias + b * bias_sb;

  // the query tile; rows past Sq arrive as zeros
  for (int i = tid; i < bq * CH; i += threads) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < Sq;
    cp_async16(qs + r * LD + c * 8,
               qg + (ok ? (long long)(q0 + r) * ld.q + c * 8 : 0), ok);
  }
  cp_async_commit();

  // K/V tile (and key-bias strip) of keys k0.. into stage st; rows past Sk
  // arrive as zeros
  auto stage_tile = [&](int k0, int st) {
    bf16* ks = kvs + st * 2 * BK * LD;
    bf16* vs = ks + BK * LD;
    for (int i = tid; i < BK * CH; i += threads) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < Sk;
      const long long row = ok ? k0 + r : 0;
      cp_async16(ks + r * LD + c * 8, kg + row * ld.k + c * 8, ok);
      cp_async16(vs + r * LD + c * 8, vg + row * ld.v + c * 8, ok);
    }
    if (key_mode)
      for (int i = tid; i < BK; i += threads) {
        const bool ok = k0 + i < Sk;
        cp_async4(kbias + st * BK + i,
                  bias_b + (ok ? (long long)(k0 + i) * bias_sk : 0), ok);
      }
  };

  const int n_tiles = (Sk + BK - 1) / BK;
  stage_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) stage_tile(BK, 1);
  cp_async_commit();   // possibly empty
  cp_async_wait<1>();  // the query tile and K/V tile 0 have landed
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * kMmaRows;        // this warp's rows of the tile
  const bool active = q0 + row0 < Sq;      // warp-uniform

  // A fragments of the warp's 16 query rows, one per 16 columns
  unsigned qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (row0 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMinusBig, kMinusBig}, l[2] = {0.f, 0.f};  // l: this thread's

  // full bias: this thread's two rows (rows past Sq run on the last row's
  // bias and are never stored); two adjacent keys in one 8-byte load where
  // the strides allow it
  const float* brow[2] = {
      bias_b + min(q0 + row0 + g, Sq - 1) * bias_sq,
      bias_b + min(q0 + row0 + g + 8, Sq - 1) * bias_sq};
  const bool pairs = !key_mode && bias_sk == 1 && bias_sq % 2 == 0 &&
                     bias_sb % 2 == 0 &&
                     (reinterpret_cast<size_t>(bias) & 7) == 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    if (t > 0) {
      cp_async_wait<0>();  // tile t has landed
      // ... for every thread; and every warp is done with tile t - 1, so
      // its stage takes tile t + 1
      __syncthreads();
      if (t + 1 < n_tiles) {
        stage_tile(k0 + BK, (t + 1) & 1);
        cp_async_commit();
      }
    }
    if (!active) continue;

    const bf16* ks = kvs + (t & 1) * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;
    const float* kb_s = kbias + (t & 1) * BK;
    const bool ragged = k0 + BK > Sk;  // uniform: mask keys past Sk

    // bias of keys n2 * 16 + 8 * hh + 2 * t4 (+ 1), hh = 0, 1, for the
    // thread's two rows r; zeros past Sk
    auto group_bias = [&](int n2, float2 (&bv)[2][2]) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kk = n2 * 16 + hh * 8 + 2 * t4, key = k0 + kk;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (key_mode) {
            bv[hh][r] = *reinterpret_cast<const float2*>(kb_s + kk);
          } else if (pairs && key + 1 < Sk) {
            bv[hh][r] = *reinterpret_cast<const float2*>(brow[r] + key);
          } else {
            bv[hh][r].x = key < Sk ? brow[r][key * bias_sk] : 0.f;
            bv[hh][r].y = key + 1 < Sk ? brow[r][(key + 1) * bias_sk] : 0.f;
          }
        }
      }
    };

    // S = Q K^T over keys n_begin * 16 .. n_end * 16 - 1: per 16 keys one
    // ldmatrix.x4 gives the B fragments of two n8 tiles over 16 columns;
    // the column steps run outermost, so every accumulator of the range is
    // in flight at once
    float s[NT][4];
    auto product = [&](int n_begin, int n_end) {
#pragma unroll
      for (int j = 2 * n_begin; j < 2 * n_end; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int n2 = n_begin; n2 < n_end; ++n2) {
          unsigned kf[4];
          ldmatrix_x4(kf, ks + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
        }
    };
    // scores of keys n2 * 16 .. + 15 times scale, plus their bias, keys
    // past Sk to -inf; the row maxima
    float mx[2] = {-INFINITY, -INFINITY};
    auto finish = [&](int n2, const float2 (&bv)[2][2]) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* sj = s[2 * n2 + hh];
        const int key = k0 + n2 * 16 + hh * 8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sj[2 * r] = sj[2 * r] * scale + bv[hh][r].x;
          sj[2 * r + 1] = sj[2 * r + 1] * scale + bv[hh][r].y;
          if (ragged) {
            if (key >= Sk) sj[2 * r] = -INFINITY;
            if (key + 1 >= Sk) sj[2 * r + 1] = -INFINITY;
          }
          mx[r] = fmaxf(mx[r], fmaxf(sj[2 * r], sj[2 * r + 1]));
        }
      }
    };
    if (key_mode) {
      // the bias strip is in shared memory: the whole product first
      product(0, NT / 2);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        float2 bv[2][2];
        group_bias(n2, bv);
        finish(n2, bv);
      }
    } else {
      // the bias comes from device memory: 16 keys at a time, the next
      // 16 keys' bias in flight while these keys' product runs
      float2 bnext[2][2];
      group_bias(0, bnext);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        float2 bv[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          bv[hh][0] = bnext[hh][0], bv[hh][1] = bnext[hh][1];
        if (n2 + 1 < NT / 2) group_bias(n2 + 1, bnext);
        product(n2, n2 + 1);
        finish(n2, bv);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }

    // p, rounded to bf16, packed into the A fragments of P V; l sums the
    // unrounded p
    unsigned pf[NT][2];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = expf(s[j][2 * r] - m[r]);
        const float p1 = expf(s[j][2 * r + 1] - m[r]);
        psum[r] += p0 + p1;
        pf[j][r] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: per 16 keys, one ldmatrix.x4.trans gives the B fragments
    // of two n8 tiles of output columns
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pf[2 * kk][0], pf[2 * kk][1],
                             pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        unsigned vf[4];
        ldmatrix_x4_trans(
            vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    d2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * d2], a, vf[0], vf[1]);
        mma_bf16(o[2 * d2 + 1], a, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + row0 + g + 8 * r;
    if (qi < Sq) {
      bf16* orow = out + ((long long)b * Sq + qi) * D + h * HD;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[j][2 * r] / l[r],
                                  o[j][2 * r + 1] / l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the tensor-core body, 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTf32Pad = 4;  // fp32 elements of padding per staged row

// Bytes of dynamic shared memory of the fp32 body for a (bq, bk) tiling at
// head width hd: the query tile's hi and lo planes, then two stages of
// (K tile, V tile), rows padded by kTf32Pad, then two stages of the
// key-bias strip. The Python wrapper computes the same sum (`_smem_bytes`).
inline size_t tf32_smem_bytes(int bq, int bk, int hd) {
  const size_t row = (size_t)(hd + kTf32Pad) * sizeof(float);
  return 2 * bq * row + 2 * (2 * bk * row + (size_t)bk * sizeof(float));
}

// x rounded to TF32 (10 stored mantissa bits; to nearest, ties away from
// zero), as the .b32 operand of a TF32 mma: the rounding of
// cvt.rna.tf32.f32, done on the bits. Half of the lowest kept bit is added
// to the magnitude (a carry runs into the exponent as it should) and the 13
// dropped bits are cleared: two integer instructions, where cvt.rna compiles
// to a longer sequence on sm_90a that also guards NaN payloads. For every
// finite x the two agree bit for bit (the outputs of both versions were
// bit-equal on an NVIDIA H100 80GB HBM3 at 700 W, and 13-15% apart in
// time; PERF.md); a NaN still gives a NaN lo part, so NaN propagates.
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, up to what TF32 drops of x - hi
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c (16x8, fp32) += a (16x8, tf32, row) * b (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: a given split, b0 and b1 split here; lo*hi, then
// hi*lo, then hi*hi (the small terms first), lo*lo dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&a_hi)[4],
                                           const unsigned (&a_lo)[4],
                                           float b0, float b1) {
  unsigned h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(c, a_lo, h0, h1);
  mma_tf32(c, a_hi, l0, l1);
  mma_tf32(c, a_hi, h0, h1);
}

// grid (ceil(Sq / bq), num_heads, B), bq = 16 * warps of the block; BK 32
// or 64: at 128 keys a tile the instances need 226-255 registers, spill at
// widths 112 and 128, and ran slower than at 64 at every shape measured. No
// register cap: held to 128 registers for two blocks an SM, the instances
// at width 64 spilled and ran slower (PERF.md; NVIDIA H100 80GB HBM3,
// 700 W). In the fragments of an m16n8 accumulator, thread (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns 2t and 2t + 1; of an m16k8
// A fragment (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); of a k8n8 B
// fragment (k = t, n = g), (k = t + 4, n = g).
template <int BK, int HD>
__global__ void __launch_bounds__(kMmaMaxThreads, 1)
    blockwise_attention_tf32_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ bias,
                                    float* __restrict__ out, RowStrides ld,
                                    int Sq, int Sk, int num_heads,
                                    int key_mode,
                                    long long bias_sb, long long bias_sq,
                                    long long bias_sk, float scale) {
  constexpr int LD = HD + kTf32Pad;  // staged row, in elements
  constexpr int CH = HD / 4;         // 16-byte chunks per row
  constexpr int NT = BK / 8;         // n8 tiles of scores per warp
  constexpr int DT = HD / 8;         // n8 tiles of output, k8 steps of QK^T
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int threads = blockDim.x, bq = (threads >> 5) * kMmaRows;
  float* qs = reinterpret_cast<float*>(smem);  // (bq, LD): Q, then its hi
  float* qlo = qs + bq * LD;                   // (bq, LD): its lo
  float* kvs = qlo + bq * LD;                  // 2 x (K, V) (BK, LD)
  float* kbias = kvs + 4 * BK * LD;            // 2 x (BK,)

  const int q0 = blockIdx.x * bq, h = blockIdx.y, b = blockIdx.z;
  const long long D = (long long)num_heads * HD;  // output row
  const float* qg = q + (long long)b * Sq * ld.q + h * HD;
  const float* kg = k + (long long)b * Sk * ld.k + h * HD;
  const float* vg = v + (long long)b * Sk * ld.v + h * HD;
  const float* bias_b = bias + b * bias_sb;

  // the query tile; rows past Sq arrive as zeros
  for (int i = tid; i < bq * CH; i += threads) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < Sq;
    cp_async16(qs + r * LD + c * 4,
               qg + (ok ? (long long)(q0 + r) * ld.q + c * 4 : 0), ok);
  }
  cp_async_commit();

  // K/V tile (and key-bias strip) of keys k0.. into stage st; rows past Sk
  // arrive as zeros
  auto stage_tile = [&](int k0, int st) {
    float* ks = kvs + st * 2 * BK * LD;
    float* vs = ks + BK * LD;
    for (int i = tid; i < BK * CH; i += threads) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < Sk;
      const long long row = ok ? k0 + r : 0;
      cp_async16(ks + r * LD + c * 4, kg + row * ld.k + c * 4, ok);
      cp_async16(vs + r * LD + c * 4, vg + row * ld.v + c * 4, ok);
    }
    if (key_mode)
      for (int i = tid; i < BK; i += threads) {
        const bool ok = k0 + i < Sk;
        cp_async4(kbias + st * BK + i,
                  bias_b + (ok ? (long long)(k0 + i) * bias_sk : 0), ok);
      }
  };

  const int n_tiles = (Sk + BK - 1) / BK;
  stage_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) stage_tile(BK, 1);
  cp_async_commit();   // possibly empty
  cp_async_wait<1>();  // the query tile and K/V tile 0 have landed
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * kMmaRows;        // this warp's rows of the tile
  const bool active = q0 + row0 < Sq;      // warp-uniform

  // the warp's 16 query rows, split once: hi in place, lo beside it (no
  // other warp reads these rows)
  for (int i = lane; i < kMmaRows * HD; i += 32) {
    const int at = (row0 + i / HD) * LD + i % HD;
    unsigned hi, lo;
    split_tf32(qs[at], hi, lo);
    qs[at] = __uint_as_float(hi);
    qlo[at] = __uint_as_float(lo);
  }
  __syncwarp();

  // the A fragments (hi and lo) of Q for the k8 step kk
  auto q_frag = [&](int kk, unsigned (&hi)[4], unsigned (&lo)[4]) {
    const int at = (row0 + g) * LD + kk * 8 + t4;
    const int offs[4] = {0, 8 * LD, 4, 8 * LD + 4};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = __float_as_uint(qs[at + offs[i]]);
      lo[i] = __float_as_uint(qlo[at + offs[i]]);
    }
  };

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMinusBig, kMinusBig}, l[2] = {0.f, 0.f};  // l: this thread's

  // full bias: this thread's two rows (rows past Sq run on the last row's
  // bias and are never stored); two adjacent keys in one 8-byte load where
  // the strides allow it
  const float* brow[2] = {
      bias_b + min(q0 + row0 + g, Sq - 1) * bias_sq,
      bias_b + min(q0 + row0 + g + 8, Sq - 1) * bias_sq};
  const bool pairs = !key_mode && bias_sk == 1 && bias_sq % 2 == 0 &&
                     bias_sb % 2 == 0 &&
                     (reinterpret_cast<size_t>(bias) & 7) == 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    if (t > 0) {
      cp_async_wait<0>();  // tile t has landed
      // ... for every thread; and every warp is done with tile t - 1, so
      // its stage takes tile t + 1
      __syncthreads();
      if (t + 1 < n_tiles) {
        stage_tile(k0 + BK, (t + 1) & 1);
        cp_async_commit();
      }
    }
    if (!active) continue;

    const float* ks = kvs + (t & 1) * 2 * BK * LD;
    const float* vs = ks + BK * LD;
    const float* kb_s = kbias + (t & 1) * BK;
    const bool ragged = k0 + BK > Sk;  // uniform: mask keys past Sk

    // bias of keys n2 * 16 + 8 * hh + 2 * t4 (+ 1), hh = 0, 1, for the
    // thread's two rows r; zeros past Sk
    auto group_bias = [&](int n2, float2 (&bv)[2][2]) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kk = n2 * 16 + hh * 8 + 2 * t4, key = k0 + kk;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (key_mode) {
            bv[hh][r] = *reinterpret_cast<const float2*>(kb_s + kk);
          } else if (pairs && key + 1 < Sk) {
            bv[hh][r] = *reinterpret_cast<const float2*>(brow[r] + key);
          } else {
            bv[hh][r].x = key < Sk ? brow[r][key * bias_sk] : 0.f;
            bv[hh][r].y = key + 1 < Sk ? brow[r][(key + 1) * bias_sk] : 0.f;
          }
        }
      }
    };

    // S = Q K^T over keys n_begin * 16 .. n_end * 16 - 1: per k8 step the
    // Q fragments once, then per n8 tile j the B fragment K[8j + g][8kk +
    // t4 (+ 4)]; the column steps run outermost, so every accumulator of
    // the range is in flight at once
    float s[NT][4];
    auto product = [&](int n_begin, int n_end) {
#pragma unroll
      for (int j = 2 * n_begin; j < 2 * n_end; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        unsigned a_hi[4], a_lo[4];
        q_frag(kk, a_hi, a_lo);
#pragma unroll
        for (int j = 2 * n_begin; j < 2 * n_end; ++j) {
          const float* kr = ks + (j * 8 + g) * LD + kk * 8 + t4;
          mma_3xtf32(s[j], a_hi, a_lo, kr[0], kr[4]);
        }
      }
    };
    // scores of keys n2 * 16 .. + 15 times scale, plus their bias, keys
    // past Sk to -inf; the row maxima
    float mx[2] = {-INFINITY, -INFINITY};
    auto finish = [&](int n2, const float2 (&bv)[2][2]) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* sj = s[2 * n2 + hh];
        const int key = k0 + n2 * 16 + hh * 8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sj[2 * r] = sj[2 * r] * scale + bv[hh][r].x;
          sj[2 * r + 1] = sj[2 * r + 1] * scale + bv[hh][r].y;
          if (ragged) {
            if (key >= Sk) sj[2 * r] = -INFINITY;
            if (key + 1 >= Sk) sj[2 * r + 1] = -INFINITY;
          }
          mx[r] = fmaxf(mx[r], fmaxf(sj[2 * r], sj[2 * r + 1]));
        }
      }
    };
    if (key_mode) {
      // the bias strip is in shared memory: the whole product first
      product(0, NT / 2);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        float2 bv[2][2];
        group_bias(n2, bv);
        finish(n2, bv);
      }
    } else {
      // the bias comes from device memory: 16 keys at a time, the next
      // 16 keys' bias in flight while these keys' product runs
      float2 bnext[2][2];
      group_bias(0, bnext);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        float2 bv[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          bv[hh][0] = bnext[hh][0], bv[hh][1] = bnext[hh][1];
        if (n2 + 1 < NT / 2) group_bias(n2 + 1, bnext);
        product(n2, n2 + 1);
        finish(n2, bv);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, one k8 step per n8 tile j of scores. The step's keys are
    // taken in the order the accumulator holds them: A position t4 is key
    // 8j + 2 t4, position t4 + 4 key 8j + 2 t4 + 1, and V's rows follow,
    // so the B fragment is V[8j + 2 t4 (+ 1)][8d + g]. p is split, never
    // rounded; l sums it
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = expf(s[j][0] - m[0]), p1 = expf(s[j][1] - m[0]);
      const float p2 = expf(s[j][2] - m[1]), p3 = expf(s[j][3] - m[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      unsigned a_hi[4], a_lo[4];
      split_tf32(p0, a_hi[0], a_lo[0]);   // (g, key 2 t4)
      split_tf32(p2, a_hi[1], a_lo[1]);   // (g + 8, key 2 t4)
      split_tf32(p1, a_hi[2], a_lo[2]);   // (g, key 2 t4 + 1)
      split_tf32(p3, a_hi[3], a_lo[3]);   // (g + 8, key 2 t4 + 1)
      const float* vr = vs + (j * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        mma_3xtf32(o[d], a_hi, a_lo, vr[d * 8], vr[LD + d * 8]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + row0 + g + 8 * r;
    if (qi < Sq) {
      float* orow = out + ((long long)b * Sq + qi) * D + h * HD;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<float2*>(orow + j * 8 + 2 * t4) =
            make_float2(o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launching the tensor-core bodies: bf16 (T = bf16) and 3xTF32 (T = float)
// ---------------------------------------------------------------------------

template <typename T>
using MmaKernel = void (*)(const T*, const T*, const T*, const float*, T*,
                           RowStrides, int, int, int, int, long long,
                           long long, long long, float);

template <typename T, int BK, int HD>
cudaError_t launch_mma_tile(const void* q, const void* k, const void* v,
                            const float* bias, void* out, RowStrides ld,
                            int B, int Sq,
                            int Sk, int num_heads, int bq, int key_mode,
                            long long sb, long long sq, long long sk,
                            float scale, cudaStream_t stream) {
  MmaKernel<T> kernel;
  size_t smem;
  if constexpr (std::is_same_v<T, float>) {
    kernel = blockwise_attention_tf32_kernel<BK, HD>;
    smem = tf32_smem_bytes(bq, BK, HD);
  } else {
    kernel = blockwise_attention_mma_kernel<BK, HD>;
    smem = mma_smem_bytes(bq, BK, HD);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + bq - 1) / bq, num_heads, B);
  kernel<<<grid, bq / kMmaRows * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), ld, Sq, Sk,
      num_heads, key_mode, sb, sq, sk, scale);
  return cudaGetLastError();
}

template <typename T, int BK>
cudaError_t launch_mma_width(int hd, const void* q, const void* k,
                             const void* v, const float* bias, void* out,
                             RowStrides ld, int B, int Sq, int Sk, int num_heads, int bq,
                             int key_mode, long long sb, long long sq,
                             long long sk, float scale, cudaStream_t stream) {
  switch (hd) {
#define ICKA_WIDTH(HD)                                                       \
  case HD:                                                                   \
    return launch_mma_tile<T, BK, HD>(q, k, v, bias, out, ld, B, Sq, Sk,     \
                                      num_heads, bq, key_mode, sb, sq, sk,   \
                                      scale, stream);
    ICKA_WIDTH(16)
    ICKA_WIDTH(32)
    ICKA_WIDTH(48)
    ICKA_WIDTH(64)
    ICKA_WIDTH(80)
    ICKA_WIDTH(96)
    ICKA_WIDTH(112)
    ICKA_WIDTH(128)
#undef ICKA_WIDTH
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_mma(int bk, const void* q, const void* k, const void* v,
                       const float* bias, void* out, RowStrides ld, int B,
                       int Sq, int Sk,
                       int num_heads, int hd, int bq, int key_mode,
                       long long sb, long long sq, long long sk, float scale,
                       cudaStream_t stream) {
  switch (bk) {
#define ICKA_KEYS(BK)                                                        \
  case BK:                                                                   \
    return launch_mma_width<T, BK>(hd, q, k, v, bias, out, ld, B, Sq, Sk,    \
                                   num_heads, bq, key_mode, sb, sq, sk,      \
                                   scale, stream);
    ICKA_KEYS(32)
    ICKA_KEYS(64)
  }
  if constexpr (!std::is_same_v<T, float>)  // 3xTF32: at most 64 keys
    if (bk == 128)
      return launch_mma_width<T, 128>(hd, q, k, v, bias, out, ld, B, Sq, Sk,
                                      num_heads, bq, key_mode, sb, sq, sk,
                                      scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Up to head_dim 128 (a multiple of 16)
// the tensor-core bodies run, bf16 or 3xTF32, block_q in {32, 64, 128},
// block_k in {32, 64, 128} (bf16) or {32, 64} (fp32); above, head_dim a
// multiple of 32, the CUDA-core body runs in both types at block_k 32 and
// block_q 32 or 64, in column chunks of at most 256. q, k and v aligned to
// 16 bytes, their rows ldq, ldk and ldv elements apart (multiples of 8, at
// least num_heads * head_dim; batch b at b * S * ld); the output is written
// contiguous. key_mode != 0 reads `bias` as (B, Sk) through (bias_sb,
// bias_sk), else as (B, Sq, Sk) through all three strides. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments without an instance or a tiling that
// does not fit shared memory; the caller checks it.
extern "C" int icka_blockwise_attention(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* out, long long ldq, long long ldk, long long ldv, int B, int Sq,
    int Sk, int num_heads, int head_dim, int block_q, int block_k,
    int key_mode, long long bias_sb, long long bias_sq, long long bias_sk,
    float scale, void* stream) {
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowStrides ld{ldq, ldk, ldv};
  if (head_dim <= 0 || head_dim % 16 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (block_q != 32 && block_q != 64 && block_q != 128)
    return cudaErrorInvalidValue;
  const long long D = (long long)num_heads * head_dim;
  if (ldq < D || ldk < D || ldv < D || ldq % 8 || ldk % 8 || ldv % 8)
    return cudaErrorInvalidValue;
  if (head_dim > 128) {
    if (head_dim % 32 || block_k != 32) return cudaErrorInvalidValue;
    return dtype == 0
               ? launch_wide<float>(q, k, v, b, out, ld, B, Sq, Sk,
                                    num_heads, head_dim, block_q, key_mode,
                                    bias_sb, bias_sq, bias_sk, scale, s)
               : launch_wide<bf16>(q, k, v, b, out, ld, B, Sq, Sk,
                                   num_heads, head_dim, block_q, key_mode,
                                   bias_sb, bias_sq, bias_sk, scale, s);
  }
  return dtype == 0
             ? launch_mma<float>(block_k, q, k, v, b, out, ld, B, Sq, Sk,
                                 num_heads, head_dim, block_q, key_mode,
                                 bias_sb, bias_sq, bias_sk, scale, s)
             : launch_mma<bf16>(block_k, q, k, v, b, out, ld, B, Sq, Sk,
                                num_heads, head_dim, block_q, key_mode,
                                bias_sb, bias_sq, bias_sk, scale, s);
}
