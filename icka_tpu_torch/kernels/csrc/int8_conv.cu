// int8 convolutions with fused epilogues for the ResNet serving path, sm_90a.
//
// Replaces the four Pallas TPU kernels of icka_tpu/kernels/conv.py:
//
//   int8_conv3x3        3x3/s1 conv of a pre-padded int8 image, 9 taps into
//                       int32, x scale(F) + bias(F) [+ residual] [ReLU], bf16
//                       or fp32 out, or int8 via round(out * (1/out_scale))
//                       clipped to +-127;
//   int8_bottleneck_v2  identity bottleneck: 1x1 -> ReLU -> requant [0,127]
//   int8_bottleneck     -> 3x3 -> ReLU -> requant -> 1x1 + x * res_scale ->
//                       ReLU, int8 [0,127] or bf16 out (one function for
//                       both; v2 passes res_scale as a device scalar and may
//                       read and write the padded layout through strides);
//   int8_stem_pool      (B, OB, OB, K) int8 patches x (K, 4F) int8 into
//                       int32; per sub-pixel plane (fp32 * scale) -> bf16,
//                       + bf16 bias, ReLU; 3x3/s2 max-pool in
//                       space-to-depth space; (B, OB, OB, F) bf16 out.
//
// All results are bit-equal to the plain PyTorch versions in
// icka_tpu_torch/kernels/conv.py: integer sums are exact, every epilogue is
// a separate round-to-nearest multiply and add (__fmul_rn, __fadd_rn: never
// contracted to an FMA) in the reference's order, (acc * s + b), then
// + x * res_scale or + residual, then ReLU; rounding to integers is
// half-to-even (rintf); int32 -> fp32 is a plain cast.
//
// What bounds them: at the serving shapes the functions are bound by
// operations once a batch fills the card (K4 at layer3, B=128: 52.5 MB and
// 55.9 GOP, 0.028 ms at the int8 tensor-core peak against 0.016 ms for the
// bytes), except the stem (224.8 MB against 88.8 GOP: bytes, 0.067 ms).
// This first version answers neither bound: the products run as __dp4a on
// the CUDA cores, and the bottleneck keeps its two narrow intermediates
// (a1q, a2q: Cw channels against the 4Cw of x and out) in a device scratch
// between three launches of one implicit-GEMM kernel, where L2 holds them at
// serving batch sizes. Tiling over pixels and channels is also what fills
// the card at a serving batch: 16 images of 14 x 14 pixels are 16 tiles for a
// kernel that keeps one image per block, against 196 tiles here. Tensor cores
// (mma.sync / wgmma int8), TMA and a single-launch bottleneck on spatial
// tiles with a halo are later work.
//
// The design is one implicit-GEMM tile kernel. A block of 256 threads owns a
// tile of BM output pixels x BN output channels and walks K = ks*ks*C in
// chunks of 64 bytes. The activation tile is gathered tap by tap from the
// NHWC image in 16-byte units (one tap and 16 channels each; a tap outside
// the image reads as zero, so no padded copy of an intermediate exists). The
// (K, F) weight chunk is transposed on its way into shared memory, 4x4 bytes
// at a time with __byte_perm, so that one 32-bit word holds four consecutive
// k of one output channel, which is what __dp4a wants. Each thread keeps a
// TM x TN register tile of int32 sums and reads both operands as 128-bit
// shared-memory loads (16 dp4a per load). The next chunk's global loads are
// started before the current chunk's products. The stem kernel runs the same
// main loop over a spatial tile of 7 x 14 outputs plus the one-pixel halo
// above and to the left that the pool needs, keeps the four ReLU'd planes of
// the tile in shared memory as bf16 and pools from there; pixels outside the
// image are stored as zero, which is exact because the planes are >= 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 (channels) x 16 (pixels) register tiles
constexpr int BK = 64;           // bytes of K per chunk
constexpr int BKW = BK / 4;      // the same in 32-bit words
constexpr int kSMs = 132;        // H100 SXM; only steers the tile choice

// An NHWC tensor whose logical (H, W) grid sits at (oy, ox) inside storage
// of (Hs, Ws) pixels per image: the padded layout without a padded kernel.
struct View {
  int Hs, Ws, oy, ox;
};

__device__ __forceinline__ size_t pixel(const View& v, int b, int y, int x) {
  return ((size_t)b * v.Hs + (y + v.oy)) * v.Ws + (x + v.ox);
}

// Where the activation operand comes from: tap (dy, dx) of output pixel
// (y, x) reads input pixel (y + dy - pad, x + dx - pad), zero outside
// [0, Hin) x [0, Win).
struct ASrc {
  const int8_t* in;
  View v;
  int Hin, Win, C, K, pad;
};

enum { RES_NONE = 0, RES_INT8_SCALED = 1, RES_BF16 = 2, RES_F32 = 3 };
enum { OUT_INT8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };

struct ConvArgs {
  ASrc a;
  const int8_t* w;           // (K, F), tap-major rows
  int F;
  int B, H, W;               // output grid
  const float* scale;        // (F,)
  const float* bias;         // (F,)
  const void* res;           // residual, (B, H, W, F) through res_v
  View res_v;
  int res_kind;
  const float* rs_ptr;       // res_scale on the device, or null
  float rs_val;              // res_scale from the host
  int relu;
  float qmul;                // int8 out: round(v * qmul), clipped to +-127
  void* out;
  View out_v;
  int out_kind;
};

template <int TM, int TN>
struct Cfg {
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  static constexpr int AJ = BM * (BK / 16) / kThreads;   // 16-byte units
  static constexpr int BJ = BKW * (BN / 4) / kThreads;   // 4x4 byte blocks
  static constexpr int A_INT4 = BM * (BK / 16);
  static constexpr int B_INT4 = BKW * (BN / 4);
};

__device__ __forceinline__ int4 load_a_unit(const ASrc& a, int b, int y,
                                            int x, int k) {
  int4 val = make_int4(0, 0, 0, 0);
  if (b >= 0 && k < a.K) {
    const int tap = k / a.C;            // 0 for a 1x1 conv (K == C)
    const int c = k - tap * a.C;
    const int dy = tap / 3, dx = tap - dy * 3;
    const int yy = y + dy - a.pad, xx = x + dx - a.pad;
    if ((unsigned)yy < (unsigned)a.Hin && (unsigned)xx < (unsigned)a.Win)
      val = __ldg(reinterpret_cast<const int4*>(
          a.in + pixel(a.v, b, yy, xx) * a.C + c));
  }
  return val;
}

// acc[i][j] += sum_k A[pixel i][k] * W[k][channel j] over all of K, for the
// pixels (rb, ry, rx) this thread stages and the channels n0.. of the block.
template <int TM, int TN>
__device__ __forceinline__ void mainloop(
    const ASrc& a, const int (&rb)[Cfg<TM, TN>::AJ],
    const int (&ry)[Cfg<TM, TN>::AJ], const int (&rx)[Cfg<TM, TN>::AJ],
    const int8_t* __restrict__ w, int F, int n0, int (&acc)[TM][TN],
    int4* As, int4* Bs) {
  using C = Cfg<TM, TN>;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int a_row = tid >> 2, a_kq = tid & 3;
  int4 ra[C::AJ];
  uint32_t rw[C::BJ][4];

  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int j = 0; j < C::AJ; ++j)
      ra[j] = load_a_unit(a, rb[j], ry[j], rx[j], k0 + a_kq * 16);
#pragma unroll
    for (int j = 0; j < C::BJ; ++j) {
      const int id = tid + kThreads * j;
      const int k4 = id / (C::BN / 4), ng = id % (C::BN / 4);
      const int n = n0 + ng * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + k4 * 4 + i;
        rw[j][i] = (k < a.K && n < F)
            ? __ldg(reinterpret_cast<const uint32_t*>(w + (size_t)k * F + n))
            : 0u;
      }
    }
  };

  const int nchunks = (a.K + BK - 1) / BK;
  load_chunk(0);
  for (int c = 0; c < nchunks; ++c) {
#pragma unroll
    for (int j = 0; j < C::AJ; ++j)
      As[(a_row + (kThreads / 4) * j) * 4 + a_kq] = ra[j];
#pragma unroll
    for (int j = 0; j < C::BJ; ++j) {
      // rows k..k+3 of four channels -> one word of four k per channel
      const uint32_t t0 = __byte_perm(rw[j][0], rw[j][1], 0x5140);
      const uint32_t t1 = __byte_perm(rw[j][2], rw[j][3], 0x5140);
      const uint32_t t2 = __byte_perm(rw[j][0], rw[j][1], 0x7362);
      const uint32_t t3 = __byte_perm(rw[j][2], rw[j][3], 0x7362);
      Bs[tid + kThreads * j] = make_int4(
          (int)__byte_perm(t0, t1, 0x5410), (int)__byte_perm(t0, t1, 0x7632),
          (int)__byte_perm(t2, t3, 0x5410), (int)__byte_perm(t2, t3, 0x7632));
    }
    __syncthreads();
    if (c + 1 < nchunks) load_chunk((c + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      int4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[(ty + 16 * i) * 4 + kk];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        int4 bv[TN / 4];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h)
          bv[h] = Bs[(kk * 4 + s) * (C::BN / 4) + tx + 16 * h];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int aw = s == 0 ? av[i].x : s == 1 ? av[i].y
                       : s == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int h = 0; h < TN / 4; ++h) {
            acc[i][4 * h + 0] = __dp4a(aw, bv[h].x, acc[i][4 * h + 0]);
            acc[i][4 * h + 1] = __dp4a(aw, bv[h].y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = __dp4a(aw, bv[h].z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = __dp4a(aw, bv[h].w, acc[i][4 * h + 3]);
          }
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int requant(float v, float qmul) {
  const float q = rintf(__fmul_rn(v, qmul));     // half to even
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

// Epilogue of four consecutive channels n..n+3 of output pixel (b, y, x).
__device__ __forceinline__ void epilogue4(const ConvArgs& p, int b, int y,
                                          int x, int n, const int* acc4,
                                          float rs) {
  const float4 s4 = __ldg(reinterpret_cast<const float4*>(p.scale + n));
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(p.bias + n));
  const float s[4] = {s4.x, s4.y, s4.z, s4.w};
  const float bi[4] = {b4.x, b4.y, b4.z, b4.w};
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __fadd_rn(__fmul_rn((float)acc4[j], s[j]), bi[j]);
  if (p.res_kind != RES_NONE) {
    const size_t at = pixel(p.res_v, b, y, x) * p.F + n;
    float r[4];
    if (p.res_kind == RES_INT8_SCALED) {
      const char4 c = *reinterpret_cast<const char4*>(
          static_cast<const int8_t*>(p.res) + at);
      r[0] = __fmul_rn((float)c.x, rs);
      r[1] = __fmul_rn((float)c.y, rs);
      r[2] = __fmul_rn((float)c.z, rs);
      r[3] = __fmul_rn((float)c.w, rs);
    } else if (p.res_kind == RES_BF16) {
      const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.res) + at;
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = __bfloat162float(q[j]);
    } else {
      const float4 f = *reinterpret_cast<const float4*>(
          static_cast<const float*>(p.res) + at);
      r[0] = f.x; r[1] = f.y; r[2] = f.z; r[3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(v[j], r[j]);
  }
  if (p.relu) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], 0.0f);
  }
  const size_t at = pixel(p.out_v, b, y, x) * p.F + n;
  if (p.out_kind == OUT_INT8) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= (uint32_t)(requant(v[j], p.qmul) & 0xff) << (8 * j);
    *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(p.out) + at) = word;
  } else if (p.out_kind == OUT_BF16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + at;
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16_rn(v[0]); lo.y = __float2bfloat16_rn(v[1]);
    hi.x = __float2bfloat16_rn(v[2]); hi.y = __float2bfloat16_rn(v[3]);
    reinterpret_cast<__nv_bfloat162*>(o)[0] = lo;
    reinterpret_cast<__nv_bfloat162*>(o)[1] = hi;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads) conv_kernel(const ConvArgs p) {
  using C = Cfg<TM, TN>;
  __shared__ int4 As[C::A_INT4];
  __shared__ int4 Bs[C::B_INT4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int HW = p.H * p.W;
  const int M = p.B * HW;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;

  int rb[C::AJ], ry[C::AJ], rx[C::AJ];
#pragma unroll
  for (int j = 0; j < C::AJ; ++j) {
    const int m = m0 + (tid >> 2) + (kThreads / 4) * j;
    rb[j] = -1; ry[j] = 0; rx[j] = 0;
    if (m < M) {
      rb[j] = m / HW;
      const int rem = m - rb[j] * HW;
      ry[j] = rem / p.W;
      rx[j] = rem - ry[j] * p.W;
    }
  }
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  mainloop<TM, TN>(p.a, rb, ry, rx, p.w, p.F, n0, acc, As, Bs);

  const float rs = p.rs_ptr ? __ldg(p.rs_ptr) : p.rs_val;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const int b = m / HW;
    const int rem = m - b * HW;
    const int y = rem / p.W, x = rem - y * p.W;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + tx * 4 + 64 * h;
      if (n < p.F) epilogue4(p, b, y, x, n, &acc[i][4 * h], rs);
    }
  }
}

template <int TM, int TN>
cudaError_t launch_conv(const ConvArgs& p, cudaStream_t stream) {
  using C = Cfg<TM, TN>;
  const long long M = (long long)p.B * p.H * p.W;
  dim3 grid((unsigned)((M + C::BM - 1) / C::BM),
            (unsigned)((p.F + C::BN - 1) / C::BN));
  conv_kernel<TM, TN><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The largest tile that still gives every SM two blocks.
cudaError_t run_conv(const ConvArgs& p, cudaStream_t stream) {
  const long long M = (long long)p.B * p.H * p.W;
  auto tiles = [&](int bm, int bn) {
    return ((M + bm - 1) / bm) * ((p.F + bn - 1) / bn);
  };
  if (p.F % 128 == 0 && tiles(128, 128) >= 2 * kSMs)
    return launch_conv<8, 8>(p, stream);
  if (tiles(128, 64) >= 2 * kSMs) return launch_conv<8, 4>(p, stream);
  return launch_conv<4, 4>(p, stream);
}

// ---- stem: dot + per-plane epilogue + max-pool in space-to-depth space ----

constexpr int kStemTH = 7, kStemTW = 14;       // outputs per tile
constexpr int kStemRows = (kStemTH + 1) * (kStemTW + 1);   // with the halo
constexpr int kStemYPad = 8;                   // bf16 of row padding

struct StemArgs {
  const int8_t* patches;     // (B, OB, OB, K)
  const int8_t* w;           // (K, 4F), sub-pixel-major columns
  const float* scale;        // (4F,)
  const float* bias;         // (4F,)
  __nv_bfloat16* out;        // (B, OB, OB, F)
  int B, OB, K, F;
};

__global__ void __launch_bounds__(kThreads) stem_pool_kernel(
    const StemArgs p) {
  using C = Cfg<8, 8>;
  static_assert(kStemRows <= C::BM, "tile and halo must fit one M tile");
  extern __shared__ int4 smem[];
  int4* As = smem;
  int4* Bs = smem + C::A_INT4;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(Bs + C::B_INT4);
  const int N = 4 * p.F;
  const int ystride = N + kStemYPad;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kStemTH, j0 = blockIdx.x * kStemTW;

  // tile row r is image pixel (i0 - 1 + r / (TW+1), j0 - 1 + r % (TW+1))
  auto image_pixel = [&](int r, int& i, int& j) {
    const int ti = r / (kStemTW + 1);
    i = i0 - 1 + ti;
    j = j0 - 1 + (r - ti * (kStemTW + 1));
    return r < kStemRows && (unsigned)i < (unsigned)p.OB
        && (unsigned)j < (unsigned)p.OB;
  };

  ASrc a;
  a.in = p.patches;
  a.v = View{p.OB, p.OB, 0, 0};
  a.Hin = p.OB; a.Win = p.OB; a.C = p.K; a.K = p.K; a.pad = 0;
  int rb[C::AJ], ry[C::AJ], rx[C::AJ];
#pragma unroll
  for (int j = 0; j < C::AJ; ++j) {
    const bool ok = image_pixel((tid >> 2) + (kThreads / 4) * j, ry[j], rx[j]);
    rb[j] = ok ? b : -1;
  }

  for (int n0 = 0; n0 < N; n0 += C::BN) {
    int acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;
    mainloop<8, 8>(a, rb, ry, rx, p.w, N, n0, acc, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      int pi, pj;
      const bool ok = image_pixel(r, pi, pj);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + tx * 4 + 64 * h;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // (int32 -> fp32 * scale) -> bf16, + bf16 bias in bf16, ReLU
          const __nv_bfloat16 y0 = __float2bfloat16_rn(
              __fmul_rn((float)acc[i][4 * h + j], __ldg(p.scale + n + j)));
          const __nv_bfloat16 bb = __float2bfloat16_rn(__ldg(p.bias + n + j));
          const float y1 = __bfloat162float(__float2bfloat16_rn(
              __fadd_rn(__bfloat162float(y0), __bfloat162float(bb))));
          ys[r * ystride + n + j] =
              __float2bfloat16_rn(ok ? fmaxf(y1, 0.0f) : 0.0f);
        }
      }
    }
  }
  __syncthreads();

  // output (i, j) pools conv rows {2i-1, 2i, 2i+1}: planes p0(i), p1(i),
  // p1(i-1), and columns likewise
  const int F = p.F;
  const int up = kStemTW + 1;
  for (int e = tid; e < kStemTH * kStemTW * F; e += kThreads) {
    const int f = e % F;
    const int cell = e / F;
    const int ti = 1 + cell / kStemTW, tj = 1 + cell % kStemTW;
    const int i = i0 - 1 + ti, j = j0 - 1 + tj;
    if (i >= p.OB || j >= p.OB) continue;
    const int r = ti * up + tj;
    auto at = [&](int row, int plane) {
      return __bfloat162float(ys[row * ystride + plane * F + f]);
    };
    const float rq0 = fmaxf(fmaxf(at(r, 0), at(r, 2)), at(r - up, 2));
    const float rq1 = fmaxf(fmaxf(at(r, 1), at(r, 3)), at(r - up, 3));
    const float rq1l =
        fmaxf(fmaxf(at(r - 1, 1), at(r - 1, 3)), at(r - 1 - up, 3));
    p.out[(((size_t)b * p.OB + i) * p.OB + j) * F + f] =
        __float2bfloat16_rn(fmaxf(fmaxf(rq0, rq1), rq1l));
  }
}

View plain_view(int H, int W) { return View{H, W, 0, 0}; }

}  // namespace

// int8_conv3x3: x_pad (B, H+2, W+2, C) int8, w (9C, F) int8, out (B, H, W, F).
// res_kind 0 none, 2 bf16, 3 fp32; out_kind 0 int8 (x qmul), 1 bf16, 2 fp32.
extern "C" int icka_int8_conv3x3(
    const void* x_pad, const void* w, const void* scale, const void* bias,
    const void* res, int res_kind, void* out, int out_kind, int B, int H,
    int W, int C, int F, int relu, float qmul, void* stream) {
  ConvArgs p{};
  p.a.in = static_cast<const int8_t*>(x_pad);
  p.a.v = plain_view(H + 2, W + 2);
  p.a.Hin = H + 2; p.a.Win = W + 2; p.a.C = C; p.a.K = 9 * C; p.a.pad = 0;
  p.w = static_cast<const int8_t*>(w);
  p.F = F; p.B = B; p.H = H; p.W = W;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.res = res; p.res_v = plain_view(H, W); p.res_kind = res_kind;
  p.rs_ptr = nullptr; p.rs_val = 1.0f;
  p.relu = relu; p.qmul = qmul;
  p.out = out; p.out_v = plain_view(H, W); p.out_kind = out_kind;
  return (int)run_conv(p, static_cast<cudaStream_t>(stream));
}

// The identity bottleneck in three launches of the tile kernel. x and out
// are (B, Hs, Ws, 4Cw) with the (H, W) grid at (oy, ox): (H, W, 0, 0) for
// the plain layout, (H+2, Wp, 1, 1) for the padded one. a1q and a2q are
// (B, H, W, Cw) int8 scratch. res_scale comes from rs_ptr (device) if not
// null, else rs_val.
extern "C" int icka_int8_bottleneck(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* s1, const void* b1, const void* s2, const void* b2,
    const void* s3, const void* b3, const void* rs_ptr, float rs_val,
    void* out, void* a1q, void* a2q, int B, int H, int W, int Cw, int Hs,
    int Ws, int oy, int ox, int out_bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const View io{Hs, Ws, oy, ox};
  const int Cin = 4 * Cw;

  ConvArgs p{};
  p.B = B; p.H = H; p.W = W;
  p.rs_ptr = nullptr; p.rs_val = 1.0f; p.res_kind = RES_NONE;
  p.relu = 1; p.qmul = 1.0f; p.out_kind = OUT_INT8;
  // conv1 1x1: x -> a1q
  p.a.in = static_cast<const int8_t*>(x); p.a.v = io;
  p.a.Hin = H; p.a.Win = W; p.a.C = Cin; p.a.K = Cin; p.a.pad = 0;
  p.w = static_cast<const int8_t*>(w1); p.F = Cw;
  p.scale = static_cast<const float*>(s1);
  p.bias = static_cast<const float*>(b1);
  p.out = a1q; p.out_v = plain_view(H, W);
  cudaError_t err = run_conv(p, stream);
  if (err != cudaSuccess) return (int)err;
  // conv2 3x3: a1q (taps outside the image are exactly 0) -> a2q
  p.a.in = static_cast<const int8_t*>(a1q); p.a.v = plain_view(H, W);
  p.a.C = Cw; p.a.K = 9 * Cw; p.a.pad = 1;
  p.w = static_cast<const int8_t*>(w2);
  p.scale = static_cast<const float*>(s2);
  p.bias = static_cast<const float*>(b2);
  p.out = a2q;
  err = run_conv(p, stream);
  if (err != cudaSuccess) return (int)err;
  // conv3 1x1 + x * res_scale + ReLU: a2q -> out
  p.a.in = static_cast<const int8_t*>(a2q);
  p.a.C = Cw; p.a.K = Cw; p.a.pad = 0;
  p.w = static_cast<const int8_t*>(w3); p.F = Cin;
  p.scale = static_cast<const float*>(s3);
  p.bias = static_cast<const float*>(b3);
  p.res = x; p.res_v = io; p.res_kind = RES_INT8_SCALED;
  p.rs_ptr = static_cast<const float*>(rs_ptr); p.rs_val = rs_val;
  p.out = out; p.out_v = io;
  p.out_kind = out_bf16 ? OUT_BF16 : OUT_INT8;
  return (int)run_conv(p, stream);
}

// int8_stem_pool: patches (B, OB, OB, K) int8, w (K, 4F) int8, out
// (B, OB, OB, F) bf16. 4F must be a multiple of 128 and at most 256.
extern "C" int icka_int8_stem_pool(
    const void* patches, const void* w, const void* scale, const void* bias,
    void* out, int B, int OB, int K, int F, void* stream) {
  using C = Cfg<8, 8>;
  StemArgs p;
  p.patches = static_cast<const int8_t*>(patches);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.OB = OB; p.K = K; p.F = F;
  const size_t smem = (C::A_INT4 + C::B_INT4) * sizeof(int4)
      + (size_t)C::BM * (4 * F + kStemYPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((OB + kStemTW - 1) / kStemTW, (OB + kStemTH - 1) / kStemTH, B);
  stem_pool_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
