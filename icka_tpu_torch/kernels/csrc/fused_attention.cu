// Fused multi-head attention for short sequences in fp32, sm_90a.
//
// Replaces icka_tpu/kernels/attention.py::fused_attention, the Pallas TPU
// kernel `_attn_kernel`, for float32 inputs at head widths up to 128. (bf16
// inputs, and every width from 129 to 256, run the blockwise kernel's bodies
// in blockwise_attention.cu at a short-sequence tiling; the Python wrapper
// chooses.) For every batch element b and head h:
//
//     out[b, :, h] = softmax(Q_h K_h^T * head_dim^-0.5 + bias[b]) V_h
//
// with q (B, Sq, D), k and v (B, Sk, D), D = num_heads * head_dim, and an
// additive fp32 bias read through strides (sb, sq, sk): a (B, 1, 1, Sk) key
// mask reaches the kernel with sq = 0 and is never broadcast to (B, Sq, Sk)
// in device memory. Order of operations as in the TPU kernel: scores * scale,
// then + bias, then softmax in fp32; fp32 math throughout.
//
// What bounds it: at the main-path shape (B=128, Sq=Sk=150, 16 heads of 64,
// fp32) the function must move Q+K+V+O, about 315 MB, about 94 us at
// 3.35 TB/s, against 11.8 GFLOP (two products of 2*B*N*Sq*Sk*64), about
// 176 us at the 67 TFLOP/s fp32 rate of the CUDA cores: bound by operations.
// The design reads Q, K and V once per (query tile, head) and writes O once,
// with no score or probability tensor in device memory: a block owns 16
// query rows of one head, stages K/V tiles of that head in shared memory and
// keeps an online softmax (the running max m, sum l and the output
// accumulator) in registers, so any Sk works, ragged last tile included. K
// and V are re-read once per 16-row query tile, which L2 absorbs at these
// lengths. The products run on the CUDA cores with fmaf: tensor cores in
// fp32 would mean TF32, which does not hold the fp32 contract (2e-5 against
// the plain version); 3xTF32 is later work.

#include "attention_common.cuh"

namespace {

using namespace icka_attention;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block

// grid (ceil(Sq / kBlockQ), num_heads, B); each warp owns kRowsPerWarp
// query rows; lane j scores keys j, j + 32, ... of a tile and owns output
// columns j, j + 32, ... of the head (those below HD).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ bias, T* __restrict__ out,
                           int Sq, int Sk, int num_heads, long long bias_sb,
                           long long bias_sq, long long bias_sk, float scale) {
  constexpr int BK = HD <= 64 ? 64 : 32;  // keys per shared-memory tile
  constexpr int KPL = BK / 32;            // keys scored by each lane
  constexpr int DPL = (HD + 31) / 32;     // output columns owned by a lane
  constexpr int VW = DPL * 32;            // V tile row, padded with zeros
  __shared__ float qs[kBlockQ][HD];
  __shared__ float ks[BK][HD + 1];  // +1: lanes read one column of 32 rows
  __shared__ float vs[BK][VW];
  __shared__ float ps[kWarps][kRowsPerWarp][BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const long long D = (long long)num_heads * HD;
  const T* qb = q + (long long)b * Sq * D + h * HD;
  const T* kb = k + (long long)b * Sk * D + h * HD;
  const T* vb = v + (long long)b * Sk * D + h * HD;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r][d] = q0 + r < Sq ? Num<T>::load(qb + (q0 + r) * D + d) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  const float* brow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMinusBig;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
    // rows past Sq run on the last row's bias and are never stored
    const int qi = min(q0 + warp * kRowsPerWarp + r, Sq - 1);
    brow[r] = bias + b * bias_sb + qi * bias_sq;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // q tile stored; previous K/V tile consumed
    for (int i = tid; i < BK * VW; i += kThreads) {
      const int r = i / VW, d = i % VW;
      const bool ok = k0 + r < Sk && d < HD;
      if (d < HD) ks[r][d] = ok ? Num<T>::load(kb + (k0 + r) * D + d) : 0.f;
      vs[r][d] = ok ? Num<T>::load(vb + (k0 + r) * D + d) : 0.f;  // d >= HD: 0
    }
    __syncthreads();

    float s[kRowsPerWarp][KPL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float kd[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) kd[j] = ks[lane + 32 * j][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qd = qs[warp * kRowsPerWarp + r][d];
#pragma unroll
        for (int j = 0; j < KPL; ++j) s[r][j] = fmaf(qd, kd[j], s[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int key = k0 + lane + 32 * j;
        s[r][j] = key < Sk ? s[r][j] * scale + brow[r][key * bias_sk]
                           : -INFINITY;
        tile_max = fmaxf(tile_max, s[r][j]);
      }
      // m starts finite, so m_new is finite whatever the tile's scores
      const float m_new = fmaxf(m[r], warp_max(tile_max));
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float p = expf(s[r][j] - m_new);
        psum += p;
        ps[warp][r][lane + 32 * j] = Num<T>::round(p);
      }
      l[r] = l[r] * alpha + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    const int kn = min(BK, Sk - k0);
    for (int j = 0; j < kn; ++j) {
      float vd[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vd[c] = vs[j][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = ps[warp][r][j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(p, vd[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi < Sq) {
      T* o = out + ((long long)b * Sq + qi) * D + h * HD;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        if (lane + 32 * c < HD)
          Num<T>::store(o + lane + 32 * c, acc[r][c] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_width(const void* q, const void* k, const void* v,
                         const float* bias, void* out, int B, int Sq, int Sk,
                         int num_heads, long long sb, long long sq,
                         long long sk, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, num_heads, B);
  fused_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), Sq, Sk, num_heads,
      sb, sq, sk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int head_dim, const void* q, const void* k, const void* v,
                   const float* bias, void* out, int B, int Sq, int Sk,
                   int num_heads, long long sb, long long sq, long long sk,
                   float scale, cudaStream_t stream) {
  switch (head_dim) {
#define ICKA_WIDTH(HD)                                                     \
  case HD:                                                                 \
    return launch_width<T, HD>(q, k, v, bias, out, B, Sq, Sk, num_heads,   \
                               sb, sq, sk, scale, stream);
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

}  // namespace

// dtype: 0 = float32 (the only type with an instance); head_dim a multiple
// of 16 up to 128. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a type or width without an
// instance; the caller checks it.
extern "C" int icka_fused_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* bias, void* out,
                                    int B, int Sq, int Sk, int num_heads,
                                    int head_dim, long long bias_sb,
                                    long long bias_sq, long long bias_sk,
                                    float scale, void* stream) {
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(head_dim, q, k, v, b, out, B, Sq, Sk, num_heads,
                         bias_sb, bias_sq, bias_sk, scale, s);
  return cudaErrorInvalidValue;
}
