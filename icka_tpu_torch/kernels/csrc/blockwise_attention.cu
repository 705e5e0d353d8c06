// Blockwise (flash-style) multi-head attention for any length, fp32 and
// bf16, sm_90a.
//
// Replaces icka_tpu/kernels/attention.py::fused_attention_blockwise, the
// Pallas TPU kernel `_flash_kernel`. Same function as the short-sequence
// kernel (fused_attention.cu):
//
//     out[b, :, h] = softmax(Q_h K_h^T * head_dim^-0.5 + bias[b]) V_h
//
// computed by the online-softmax recurrence over key tiles
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
// by operations from about 600 keys on, by bytes below. What a block can
// do about either is to fetch K and V as seldom as possible, and that is
// the design: a block owns a tile of block_q query rows (32, 64 or 128) of
// one head, and one K/V tile of block_k keys (32, 64 or 128), staged in
// shared memory in the input type, serves all of those rows. At 128 rows
// K and V of a head are read from L2 or device memory Sq / 128 times (the
// short-sequence kernel reads them once per 16 rows and stages them as
// fp32). No score or probability tensor exists in device memory.
//
// Layout of the work: 8 query rows per warp, so block_q / 8 warps per block
// (4, 8 or 16). Lane j scores keys j, j + 32, ... of the tile and owns
// output columns j, j + 32, ... of the head. m, l and the output
// accumulator live in registers; the TPU kernel's (num_heads, bq, 128)
// lane-broadcast scratch has no counterpart. The ragged last tile is masked
// in both dimensions (keys past Sk score -inf, rows past Sq are never
// stored), so no block size has to divide a sequence length.
//
// Bias: in key mode ((B, Sk), one row for all queries) the block loads the
// tile's strip into shared memory once per K tile, for every row and warp.
// In full mode ((B, Sq, Sk) through strides, e.g. a view of a (B, 1, Sq, Sk)
// block-diagonal mask) each warp reads its rows' (8, block_k) part of the
// tile from device memory, once per head.
//
// The two products run on the CUDA cores in fp32. Tensor cores (mma.sync,
// wgmma) and TMA are later work.

#include "attention_common.cuh"

namespace {

using namespace icka_attention;

constexpr int kRows = 8;         // query rows per warp
constexpr int kMaxThreads = 512; // block_q = 128
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
__global__ void __launch_bounds__(kMaxThreads)
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim a multiple of 16 up to 128,
// block_q in {32, 64, 128}, block_k in {32, 64, 128}; key_mode != 0 reads
// `bias` as (B, Sk) through (bias_sb, bias_sk), else as (B, Sq, Sk) through
// all three strides. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments without an instance or a
// tiling that does not fit shared memory; the caller checks it.
extern "C" int icka_blockwise_attention(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* out, int B, int Sq, int Sk, int num_heads, int head_dim,
    int block_q, int block_k, int key_mode, long long bias_sb,
    long long bias_sq, long long bias_sk, float scale, void* stream) {
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 0 || head_dim % 16 || head_dim > 128)
    return cudaErrorInvalidValue;
  if (block_q != 32 && block_q != 64 && block_q != 128)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(block_k, q, k, v, b, out, B, Sq, Sk, num_heads,
                         head_dim, block_q, key_mode, bias_sb, bias_sq,
                         bias_sk, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(block_k, q, k, v, b, out, B, Sq, Sk,
                                 num_heads, head_dim, block_q, key_mode,
                                 bias_sb, bias_sq, bias_sk, scale, s);
  return cudaErrorInvalidValue;
}
