// Blockwise (flash-style) multi-head attention for any length, fp32 and
// bf16, sm_90a.
//
// Replaces icka_tpu/kernels/attention.py::fused_attention_blockwise, the
// Pallas TPU kernel `_flash_kernel`. Same function as the short-sequence
// kernel (fused_attention.cu):
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
// by operations from about 600 keys on, by bytes below. So the products
// belong on the tensor cores, and K and V are fetched as seldom as possible:
// a block owns a tile of block_q query rows (32, 64 or 128) of one head, and
// one K/V tile of block_k keys (32, 64 or 128), staged in shared memory in
// the input type, serves all of those rows. No score or probability tensor
// exists in device memory. The ragged last tile is masked in both
// dimensions (keys past Sk score -inf, rows past Sq are never stored), so no
// block size has to divide a sequence length.
//
// Two bodies, one per type:
//
// bf16, on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums), in the
// shape of FlashAttention-2. A warp owns 16 query rows (one m16 tile), so a
// block has block_q / 16 warps. The warp's Q fragments are read once from
// the staged query tile with ldmatrix and stay in registers for the whole
// key loop. S = Q K^T takes its B fragments from the staged K tile with
// ldmatrix; the online softmax runs on the accumulator fragments (a thread
// holds two rows, reduced over its quad with shuffles); p, rounded to bf16,
// is packed in registers straight into the A fragments of O += P V (the
// m16n8 accumulator layout of two adjacent n8 tiles is the m16k16 A
// layout), whose V fragments come from ldmatrix.trans. O is divided by l at
// the end. K/V tiles (and the key-bias strip) move through cp.async in two
// stages, tile k + 1 in flight while tile k computes, one barrier per tile;
// rows past Sk arrive as zeros (the zero-fill form of cp.async), so p = 0
// meets V = 0 and never a stale Inf or NaN. Staged rows are padded by 8 elements (16 bytes), which
// keeps every ldmatrix free of bank conflicts. Head width is a template
// parameter: 24 instances, (block_k, head_dim) with head_dim in 16..128.
//
// fp32, on the CUDA cores: 8 query rows per warp, block_q / 8 warps; lane j
// scores keys j, j + 32, ... of the tile and owns output columns j, j + 32,
// ... of the head, the query tile is converted to fp32 once, p goes through
// shared memory. Tensor cores in fp32 would mean TF32, which does not hold
// the fp32 contract (2e-5 against the plain version). 12 instances, (block_k,
// ceil(head_dim / 32)) up to head_dim 128. The same body, in fp32 and bf16,
// also takes head widths 160, 192, 224 and 256 (8 more instances, one key
// tile of 32, at most 64 query rows): the bf16 tensor-core body would hold
// 128 output registers a lane at 256, and no model of the repo has such a
// width, so these are a simple body that is right rather than a fast one.
//
// Bias: in key mode ((B, Sk), one row for all queries) the block stages the
// tile's strip in shared memory once per K tile, for every row and warp. In
// full mode ((B, Sq, Sk) through strides, e.g. a view of a (B, 1, Sq, Sk)
// block-diagonal mask) the bf16 body reads each thread's own fragment
// elements, two adjacent keys at a time, so each bias element is read once
// per (block, head), those of the next 16 keys in flight while the product
// of these runs (with a key bias, read from shared memory, the product runs
// over the whole tile first, every accumulator in flight); the fp32 body
// reads each warp's (8, block_k) part.

#include "attention_common.cuh"
#include "ptx.cuh"

namespace {

using namespace icka_attention;
using namespace icka_ptx;

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kRows = 8;         // query rows per warp
constexpr int kMaxThreads = 512; // block_q = 128
// Head widths 129..256 (DPL 5..8) run this body in both types, at one key
// tile of 32 and at most 64 query rows, so that a thread may hold its
// 8 x DPL accumulators in up to 255 registers.
constexpr int kWideMaxThreads = 256;
constexpr int kVec = 4;          // elements per staged chunk
constexpr int kPad = 4;          // K/V tile row padding, in elements

// Bytes of dynamic shared memory for a (bq, bk) tiling at head width hd:
// the fp32 query tile, the fp32 probability tile, the key-bias strip, and
// the K and V tiles in the input type with padded rows. The Python wrapper
// computes the same sum to pick a tiling that fits a block's limit.
inline size_t smem_bytes(int bq, int bk, int hd, size_t elt) {
  return (size_t)bq * hd * 4 + (size_t)bq * bk * 4 + (size_t)bk * 4 +
         2 * (size_t)bk * (hd + kPad) * elt;
}

// grid (ceil(Sq / bq), num_heads, B), bq = 8 * warps of the block. KPL keys
// per lane (block_k = 32 * KPL), DPL = ceil(hd / 32) output columns per lane.
template <typename T, int KPL, int DPL>
__global__ void __launch_bounds__(DPL > 4 ? kWideMaxThreads : kMaxThreads, 1)
    blockwise_attention_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int Sq, int Sk,
                               int num_heads, int hd, int key_mode,
                               long long bias_sb, long long bias_sq,
                               long long bias_sk, float scale) {
  using Chunk = typename Num<T>::Chunk;
  constexpr int BK = 32 * KPL;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int threads = blockDim.x, bq = (threads >> 5) * kRows;
  const int ks_stride = hd + kPad;  // elements; rows stay chunk-aligned
  float* qs = reinterpret_cast<float*>(smem);          // (bq, hd)
  float* ps = qs + bq * hd;                            // (bq, BK)
  float* kbias = ps + bq * BK;                         // (BK,)
  T* ks = reinterpret_cast<T*>(kbias + BK);            // (BK, hd + pad)
  T* vs = ks + BK * ks_stride;

  const int q0 = blockIdx.x * bq, h = blockIdx.y, b = blockIdx.z;
  const long long D = (long long)num_heads * hd;
  const T* qb = q + (long long)b * Sq * D + h * hd;
  const T* kb = k + (long long)b * Sk * D + h * hd;
  const T* vb = v + (long long)b * Sk * D + h * hd;
  const float* bias_b = bias + b * bias_sb;
  const int chunks = hd / kVec;  // per row

  // the query tile, converted to fp32 once; rows past Sq are zero
  for (int i = tid; i < bq * chunks; i += threads) {
    const int r = i / chunks, c = i % chunks;
    float f[kVec] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq)
      Num<T>::unpack(*reinterpret_cast<const Chunk*>(
                         qb + (long long)(q0 + r) * D + c * kVec), f);
    *reinterpret_cast<float4*>(qs + r * hd + c * kVec) =
        make_float4(f[0], f[1], f[2], f[3]);
  }

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
    __syncthreads();  // query tile stored; previous K/V tile consumed
    for (int i = tid; i < BK * chunks; i += threads) {
      const int r = i / chunks, c = i % chunks;
      Chunk kc = Num<T>::zero(), vc = Num<T>::zero();
      if (k0 + r < Sk) {
        const long long off = (long long)(k0 + r) * D + c * kVec;
        kc = *reinterpret_cast<const Chunk*>(kb + off);
        vc = *reinterpret_cast<const Chunk*>(vb + off);
      }
      *reinterpret_cast<Chunk*>(ks + r * ks_stride + c * kVec) = kc;
      *reinterpret_cast<Chunk*>(vs + r * ks_stride + c * kVec) = vc;
    }
    if (key_mode)
      for (int i = tid; i < BK; i += threads)
        kbias[i] = k0 + i < Sk ? bias_b[(k0 + i) * bias_sk] : 0.f;
    __syncthreads();
    if (!active) continue;

    // scores of 8 rows x KPL keys per lane
    float s[kRows][KPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += kVec) {
      float kf[KPL][kVec];
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        Num<T>::unpack(*reinterpret_cast<const Chunk*>(
                           ks + (lane + 32 * j) * ks_stride + d0), kf[j]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(qs + (row0 + r) * hd + d0);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          s[r][j] = fmaf(q4.x, kf[j][0], s[r][j]);
          s[r][j] = fmaf(q4.y, kf[j][1], s[r][j]);
          s[r][j] = fmaf(q4.z, kf[j][2], s[r][j]);
          s[r][j] = fmaf(q4.w, kf[j][3], s[r][j]);
        }
      }
    }

    // online softmax; rounded p to shared memory for the second product
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // rows past Sq run on the last row's bias and are never stored
      const int qi = min(q0 + row0 + r, Sq - 1);
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kk = lane + 32 * j, key = k0 + kk;
        if (key < Sk) {
          const float bv = key_mode
                               ? kbias[kk]
                               : bias_b[qi * bias_sq + key * bias_sk];
          s[r][j] = s[r][j] * scale + bv;
        } else {
          s[r][j] = -INFINITY;
        }
        tile_max = fmaxf(tile_max, s[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(tile_max));  // finite
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float p = expf(s[r][j] - m_new);
        psum += p;
        pw[r * BK + lane + 32 * j] = Num<T>::round(p);
      }
      l[r] = l[r] * alpha + warp_sum(psum);
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
          vf[i][c] = col < hd
                         ? Num<T>::load(vs + (j0 + i) * ks_stride + col)
                         : 0.f;
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
      T* o = out + ((long long)b * Sq + qi) * D + h * hd;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        if (lane + 32 * c < hd)
          Num<T>::store(o + lane + 32 * c, acc[r][c] * inv);
    }
  }
}

template <typename T, int KPL, int DPL>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const float* bias, void* out, int B, int Sq, int Sk,
                        int num_heads, int hd, int bq, int key_mode,
                        long long sb, long long sq, long long sk, float scale,
                        cudaStream_t stream) {
  auto kernel = blockwise_attention_kernel<T, KPL, DPL>;
  const size_t smem = smem_bytes(bq, 32 * KPL, hd, sizeof(T));
  // above 48 KB the kernel has to be allowed its dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + bq - 1) / bq, num_heads, B);
  kernel<<<grid, bq / kRows * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), Sq, Sk, num_heads,
      hd, key_mode, sb, sq, sk, scale);
  return cudaGetLastError();
}

template <typename T, int KPL>
cudaError_t launch_keys(int dpl, const void* q, const void* k, const void* v,
                        const float* bias, void* out, int B, int Sq, int Sk,
                        int num_heads, int hd, int bq, int key_mode,
                        long long sb, long long sq, long long sk, float scale,
                        cudaStream_t stream) {
  switch (dpl) {
#define ICKA_COLS(DPL)                                                      \
  case DPL:                                                                 \
    return launch_tile<T, KPL, DPL>(q, k, v, bias, out, B, Sq, Sk,          \
                                    num_heads, hd, bq, key_mode, sb, sq,    \
                                    sk, scale, stream);
    ICKA_COLS(1)
    ICKA_COLS(2)
    ICKA_COLS(3)
    ICKA_COLS(4)
#undef ICKA_COLS
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(int bk, const void* q, const void* k, const void* v,
                   const float* bias, void* out, int B, int Sq, int Sk,
                   int num_heads, int hd, int bq, int key_mode, long long sb,
                   long long sq, long long sk, float scale,
                   cudaStream_t stream) {
  const int dpl = (hd + 31) / 32;
  switch (bk) {
#define ICKA_KEYS(KPL)                                                      \
  case 32 * KPL:                                                            \
    return launch_keys<T, KPL>(dpl, q, k, v, bias, out, B, Sq, Sk,          \
                               num_heads, hd, bq, key_mode, sb, sq, sk,     \
                               scale, stream);
    ICKA_KEYS(1)
    ICKA_KEYS(2)
    ICKA_KEYS(4)
#undef ICKA_KEYS
  }
  return cudaErrorInvalidValue;
}

// widths 129..256: one key tile of 32, bq <= 64
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const float* bias, void* out, int B, int Sq, int Sk,
                        int num_heads, int hd, int bq, int key_mode,
                        long long sb, long long sq, long long sk, float scale,
                        cudaStream_t stream) {
  if (bq > kWideMaxThreads / 32 * kRows) return cudaErrorInvalidValue;
  switch ((hd + 31) / 32) {
#define ICKA_COLS(DPL)                                                      \
  case DPL:                                                                 \
    return launch_tile<T, 1, DPL>(q, k, v, bias, out, B, Sq, Sk, num_heads, \
                                  hd, bq, key_mode, sb, sq, sk, scale,      \
                                  stream);
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
                                   bf16* __restrict__ out, int Sq, int Sk,
                                   int num_heads, int key_mode,
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
  const long long D = (long long)num_heads * HD;
  const bf16* qg = q + (long long)b * Sq * D + h * HD;
  const bf16* kg = k + (long long)b * Sk * D + h * HD;
  const bf16* vg = v + (long long)b * Sk * D + h * HD;
  const float* bias_b = bias + b * bias_sb;

  // the query tile; rows past Sq arrive as zeros
  for (int i = tid; i < bq * CH; i += threads) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < Sq;
    cp_async16(qs + r * LD + c * 8,
               qg + (ok ? (long long)(q0 + r) * D + c * 8 : 0), ok);
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
      const long long off = ok ? (long long)(k0 + r) * D + c * 8 : 0;
      cp_async16(ks + r * LD + c * 8, kg + off, ok);
      cp_async16(vs + r * LD + c * 8, vg + off, ok);
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

template <int BK, int HD>
cudaError_t launch_mma_tile(const void* q, const void* k, const void* v,
                            const float* bias, void* out, int B, int Sq,
                            int Sk, int num_heads, int bq, int key_mode,
                            long long sb, long long sq, long long sk,
                            float scale, cudaStream_t stream) {
  auto kernel = blockwise_attention_mma_kernel<BK, HD>;
  const size_t smem = mma_smem_bytes(bq, BK, HD);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + bq - 1) / bq, num_heads, B);
  kernel<<<grid, bq / kMmaRows * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), Sq, Sk,
      num_heads, key_mode, sb, sq, sk, scale);
  return cudaGetLastError();
}

template <int BK>
cudaError_t launch_mma_width(int hd, const void* q, const void* k,
                             const void* v, const float* bias, void* out,
                             int B, int Sq, int Sk, int num_heads, int bq,
                             int key_mode, long long sb, long long sq,
                             long long sk, float scale, cudaStream_t stream) {
  switch (hd) {
#define ICKA_WIDTH(HD)                                                       \
  case HD:                                                                   \
    return launch_mma_tile<BK, HD>(q, k, v, bias, out, B, Sq, Sk, num_heads, \
                                   bq, key_mode, sb, sq, sk, scale, stream);
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

cudaError_t launch_mma(int bk, const void* q, const void* k, const void* v,
                       const float* bias, void* out, int B, int Sq, int Sk,
                       int num_heads, int hd, int bq, int key_mode,
                       long long sb, long long sq, long long sk, float scale,
                       cudaStream_t stream) {
  switch (bk) {
#define ICKA_KEYS(BK)                                                        \
  case BK:                                                                   \
    return launch_mma_width<BK>(hd, q, k, v, bias, out, B, Sq, Sk,           \
                                num_heads, bq, key_mode, sb, sq, sk, scale,  \
                                stream);
    ICKA_KEYS(32)
    ICKA_KEYS(64)
    ICKA_KEYS(128)
#undef ICKA_KEYS
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Up to head_dim 128 fp32 runs the
// CUDA-core body and bf16 the tensor-core body, head_dim a multiple of 16,
// block_q and block_k in {32, 64, 128}; head_dim 160, 192, 224 or 256 runs
// the CUDA-core body in both types at block_k 32 and block_q 32 or 64. q, k
// and v aligned to 16 bytes; key_mode != 0
// reads `bias` as (B, Sk) through (bias_sb, bias_sk), else as (B, Sq, Sk)
// through all three strides. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for arguments without an instance or
// a tiling that does not fit shared memory; the caller checks it.
extern "C" int icka_blockwise_attention(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* out, int B, int Sq, int Sk, int num_heads, int head_dim,
    int block_q, int block_k, int key_mode, long long bias_sb,
    long long bias_sq, long long bias_sk, float scale, void* stream) {
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 0 || head_dim % 16 || head_dim > 256)
    return cudaErrorInvalidValue;
  if (block_q != 32 && block_q != 64 && block_q != 128)
    return cudaErrorInvalidValue;
  if (head_dim > 128) {
    if (head_dim % 32 || block_k != 32) return cudaErrorInvalidValue;
    if (dtype == 0)
      return launch_wide<float>(q, k, v, b, out, B, Sq, Sk, num_heads,
                                head_dim, block_q, key_mode, bias_sb, bias_sq,
                                bias_sk, scale, s);
    if (dtype == 1)
      return launch_wide<bf16>(q, k, v, b, out, B, Sq, Sk, num_heads,
                               head_dim, block_q, key_mode, bias_sb, bias_sq,
                               bias_sk, scale, s);
    return cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch<float>(block_k, q, k, v, b, out, B, Sq, Sk, num_heads,
                         head_dim, block_q, key_mode, bias_sb, bias_sq,
                         bias_sk, scale, s);
  if (dtype == 1)
    return launch_mma(block_k, q, k, v, b, out, B, Sq, Sk, num_heads,
                      head_dim, block_q, key_mode, bias_sb, bias_sq, bias_sk,
                      scale, s);
  return cudaErrorInvalidValue;
}
