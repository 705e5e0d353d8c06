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
//                       read and write the padded layout through strides):
//                       one launch of the wgmma body in
//                       int8_bottleneck_wgmma.cuh;
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
// operations once a batch fills the card (K3 at layer3, B=128: 0.015 ms at
// the int8 tensor-core peak), except the stem (224.8 MB against 88.8 GOP:
// bytes, 0.067 ms). So the products run on the int8 tensor cores: the
// bottleneck on wgmma (see its header), the 3x3 conv and the stem on
// mma.sync m16n8k32 (s8 x s8 -> s32). Tiling over pixels and channels is
// also what fills the card at a serving batch.
//
// K3 and K5 share one implicit-GEMM tile kernel. A block of 8 warps owns a
// tile of BM output pixels x BN output channels and walks K = ks*ks*C in
// chunks of 64 bytes, each warp a (BM / WM) x (BN / WN) part of the tile
// as m16 x n8 accumulators. The activation chunk (pixels x k, row-major) is
// gathered tap by tap from the NHWC image in 16-byte units (one tap and 16
// channels each) by cp.async; a tap outside the image, and k past K (the
// stem's K = 432 is no multiple of 64), arrive as zeros (source size 0), so
// no padded copy of an intermediate exists. The (K, F) weight chunk lands
// as stored, rows of channels, by the same cp.async (zeros past K and F).
// Both ride a ring of four stages, so that while chunk c's products run,
// chunks c + 2 and c + 3 are in flight. Then each thread reads 16 k of two
// channels of chunk c + 1's weights from shared memory and transposes them
// with __byte_perm into 16 bytes of k per channel, the "col" operand the mma
// wants, staged as [channel][k]. The activation chunk and the transposed
// weights sit in shared memory as rows of 64 bytes whose four 16-byte units
// are XOR-swizzled by the row, so that the ldmatrix.x4 loads of the
// fragments (16 int8 read as 8 b16) and the stores of a quarter-warp each
// touch every bank once. One barrier a chunk. The accumulators are staged
// through shared memory so that the epilogue reads four consecutive
// channels of one pixel, as the plain version's order wants and the stores
// coalesce. The stem kernel runs the same main loop over a spatial tile of
// 7 x 14 outputs plus the one-pixel halo above and to the left that the
// pool needs, writes its four ReLU'd planes from the fragments into shared
// memory as bf16, element by element in the same arithmetic, and pools from
// there; pixels outside the image are stored as zero, which is exact
// because the planes are >= 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_bottleneck_wgmma.cuh"
#include "ptx.cuh"

namespace {

using namespace icka_ptx;

constexpr int kThreads = 256;    // 8 warps; the epilogue: 16 x 16 threads
constexpr int kWarps = kThreads / 32;
constexpr int BK = 64;           // bytes of K per chunk: two mma k-steps
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

enum { RES_NONE = 0, RES_BF16 = 2, RES_F32 = 3 };
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
  int relu;
  float qmul;                // int8 out: round(v * qmul), clipped to +-127
  void* out;
  View out_v;
  int out_kind;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int kStages = 4;       // chunks of the cp.async ring

// A tile of BM = 16 TM pixels x BN = 16 TN channels. Its 8 warps form a
// WM x WN grid, each warp MT m16 tiles by NT n8 tiles of accumulators.
// Shared memory: kStages stages of (activation chunk, BM x 64 bytes; weight
// chunk as stored, 64 x BN bytes), then two weight chunks transposed to
// BN x 64; the epilogue reuses it for the (BM, BN) int32 tile.
template <int TM, int TN>
struct Cfg {
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  static constexpr int AU = BM * (BK / 16) / kThreads;   // 16-byte units
  static constexpr int BU = BK * (BN / 16) / kThreads;   // of A and of B
  static constexpr int WN = TN == 8 ? 4 : 2;
  static constexpr int WM = kWarps / WN;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = BN / WN / 8;
  static constexpr int STAGE = (BM + BN) * BK;
  static constexpr int PIPE = kStages * STAGE + 2 * BN * BK;
  static constexpr int CS = BN + 8;              // staged int32 row
  static constexpr int SMEM = cmax(PIPE, BM * CS * 4);
  static_assert(MT >= 1 && NT % 2 == 0, "warp tile of m16 x 2n8 steps");
  static __device__ __forceinline__ int wm0(int warp) {
    return warp / WN * (BM / WM);
  }
  static __device__ __forceinline__ int wn0(int warp) {
    return warp % WN * (BN / WN);
  }
};

// Byte offset of 16-byte unit u (0..3) of staged row r: rows of 64 bytes,
// units XOR-swizzled by (r >> 1) & 3. The 8 rows one ldmatrix matrix reads
// (consecutive, from a multiple of 8) and the 8 units a quarter-warp stores
// (two rows of four units, or eight rows of both parities) then fill the
// 32 banks once.
__device__ __forceinline__ int swz(int r, int u) {
  return r * BK + ((u ^ ((r >> 1) & 3)) << 4);
}

// c (16x8, s32) += a (16x32, s8, row) * b (32x8, s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 bytes of k .. k + 15 of pixel (b, y, x) in the activation operand,
// or null where they read as zero (b < 0: a row past the tile's pixels; k
// past K; a tap outside the image).
__device__ __forceinline__ const int8_t* a_unit(const ASrc& a, int b, int y,
                                                int x, int k) {
  if (b < 0 || k >= a.K) return nullptr;
  const int tap = k / a.C;              // 0 for a 1x1 conv (K == C)
  const int c = k - tap * a.C;
  const int dy = tap / 3, dx = tap - dy * 3;
  const int yy = y + dy - a.pad, xx = x + dx - a.pad;
  if ((unsigned)yy >= (unsigned)a.Hin || (unsigned)xx >= (unsigned)a.Win)
    return nullptr;
  return a.in + pixel(a.v, b, yy, xx) * a.C + c;
}

// acc[mt][nt] += sum_k A[pixel][k] * W[k][channel] over all of K, for the
// pixels (rb, ry, rx) this thread stages and the channels n0.. of the block;
// each warp's m16 x n8 tiles at (wm0 + 16 mt, wn0 + 8 nt) of the block
// tile, in the m16n8 accumulator layout (thread (g, t) = (lane / 4,
// lane % 4) holds rows g and g + 8, columns 2t and 2t + 1). `smem` holds
// Cfg::PIPE bytes; the loop ends on a barrier, so the caller may reuse them.
//
// Chunk c goes to stage c % kStages by cp.async; at step c the products of
// chunk c run while chunks c + 2 .. c + kStages - 1 are in flight, and then
// chunk c + 1's weights, landed, are transposed for step c + 1. One barrier
// a step.
template <int TM, int TN>
__device__ __forceinline__ void mainloop(
    const ASrc& a, const int (&rb)[Cfg<TM, TN>::AU],
    const int (&ry)[Cfg<TM, TN>::AU], const int (&rx)[Cfg<TM, TN>::AU],
    const int8_t* __restrict__ w, int F, int n0,
    int (&acc)[Cfg<TM, TN>::MT][Cfg<TM, TN>::NT][4], unsigned char* smem) {
  using C = Cfg<TM, TN>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm0 = C::wm0(warp), wn0 = C::wn0(warp);
  const int a_row = tid >> 2, a_u = tid & 3;
  // the transposition: channels 2 bp and 2 bp + 1, k unit bu (BN = 64
  // leaves half the threads without one)
  const int bp = tid % (C::BN / 2), bu = tid / (C::BN / 2);
  const int nchunks = (a.K + BK - 1) / BK;

  auto a_tile = [&](int c) { return smem + c % kStages * C::STAGE; };
  auto b_raw = [&](int c) { return a_tile(c) + C::BM * BK; };
  auto b_t = [&](int c) {
    return smem + kStages * C::STAGE + (c & 1) * C::BN * BK;
  };

  // chunk c: the activation units (zeros where they read as zero) into
  // swizzled rows, the weight rows k0.. as stored (zeros past K and F)
  auto load_chunk = [&](int c) {
    if (c < nchunks) {
      const int k0 = c * BK;
      unsigned char* As = a_tile(c);
#pragma unroll
      for (int j = 0; j < C::AU; ++j) {
        const int8_t* src = a_unit(a, rb[j], ry[j], rx[j], k0 + a_u * 16);
        cp_async16(As + swz(a_row + (kThreads / 4) * j, a_u),
                   src ? src : a.in, src != nullptr);
      }
      unsigned char* Bs = b_raw(c);
#pragma unroll
      for (int j = 0; j < C::BU; ++j) {
        const int id = tid + kThreads * j;
        const int kr = id / (C::BN / 16), u = id % (C::BN / 16);
        const int k = k0 + kr, n = n0 + 16 * u;
        const bool ok = k < a.K && n < F;
        cp_async16(Bs + kr * C::BN + 16 * u, ok ? w + (size_t)k * F + n : w,
                   ok);
      }
    }
    cp_async_commit();   // possibly empty: one group per chunk
  };
  // chunk c's weights, 16 k of two channels a thread, -> one 16-byte unit
  // of k per channel (four k of one channel per word, the mma's "col"
  // operand). Half the quarter-warp stores its even channel first, half
  // its odd, so that the quarter-warp's 8 units fall in 8 bank groups.
  auto transpose = [&](int c) {
    if (bu >= BK / 16) return;
    const unsigned char* raw = b_raw(c) + bu * 16 * C::BN + 2 * bp;
    unsigned rw[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      rw[r] = *reinterpret_cast<const unsigned short*>(raw + r * C::BN);
    unsigned lo[4], hi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned x01 = rw[4 * q] | (rw[4 * q + 1] << 16);
      const unsigned x23 = rw[4 * q + 2] | (rw[4 * q + 3] << 16);
      lo[q] = __byte_perm(x01, x23, 0x6420);   // k 4q..4q+3, channel 2bp
      hi[q] = __byte_perm(x01, x23, 0x7531);   // the same, channel 2bp + 1
    }
    const int first = (bp >> 2) & 1;
    unsigned char* Bt = b_t(c);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int par = first ^ s;
      const unsigned* v = par ? hi : lo;
      *reinterpret_cast<uint4*>(Bt + swz(2 * bp + par, bu)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  auto compute = [&](const unsigned char* As, const unsigned char* Bs) {
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned af[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        ldmatrix_x4(af[mt], As + swz(wm0 + mt * 16 + (lane & 15),
                                     2 * ks + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        unsigned bf[4];   // b0, b1 of n8 tile 2 np, then of 2 np + 1
        ldmatrix_x4(bf, Bs + swz(wn0 + np * 16 + (lane & 7) +
                                     ((lane >> 4) << 3),
                                 2 * ks + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          mma_s8(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_s8(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) load_chunk(c);
  cp_async_wait<kStages - 2>();   // chunk 0 has landed
  __syncthreads();
  transpose(0);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 3>();   // chunks c and c + 1 have landed
    // ... for every thread, chunk c's weights are transposed, and every
    // warp is done with chunk c - 1, so its stage takes chunk c + S - 1
    __syncthreads();
    load_chunk(c + kStages - 1);
    compute(a_tile(c), b_t(c));
    if (c + 1 < nchunks) transpose(c + 1);
  }
  __syncthreads();
}

__device__ __forceinline__ int requant(float v, float qmul) {
  const float q = rintf(__fmul_rn(v, qmul));     // half to even
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

// A bf16 or fp32 residual of channels n..n+3 of output pixel (b, y, x) as
// stored, 8 or 16 bytes. Loaded apart from the arithmetic, so that a thread has all
// of its loads in flight at once (a store to `out` might alias `res` for
// the compiler).
__device__ __forceinline__ uint4 load_res4(const ConvArgs& p, int b, int y,
                                           int x, int n) {
  const size_t at = pixel(p.res_v, b, y, x) * p.F + n;
  if (p.res_kind == RES_BF16) {
    const uint2 t = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p.res) + at);
    return make_uint4(t.x, t.y, 0u, 0u);
  }
  return *reinterpret_cast<const uint4*>(static_cast<const float*>(p.res)
                                         + at);
}

// Epilogue of four consecutive channels n..n+3 of output pixel (b, y, x):
// their scale and bias, their residual's bytes as stored (4 bf16 or 4
// fp32; unused without a residual).
__device__ __forceinline__ void epilogue4(const ConvArgs& p, int b, int y,
                                          int x, int n, const int* acc4,
                                          float4 s4, float4 b4, uint4 raw) {
  const float s[4] = {s4.x, s4.y, s4.z, s4.w};
  const float bi[4] = {b4.x, b4.y, b4.z, b4.w};
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __fadd_rn(__fmul_rn((float)acc4[j], s[j]), bi[j]);
  if (p.res_kind != RES_NONE) {
    float r[4];
    if (p.res_kind == RES_BF16) {
      r[0] = __uint_as_float(raw.x << 16);
      r[1] = __uint_as_float(raw.x & 0xffff0000u);
      r[2] = __uint_as_float(raw.y << 16);
      r[3] = __uint_as_float(raw.y & 0xffff0000u);
    } else {
      r[0] = __uint_as_float(raw.x);
      r[1] = __uint_as_float(raw.y);
      r[2] = __uint_as_float(raw.z);
      r[3] = __uint_as_float(raw.w);
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

// Two blocks an SM for the 128 x 128 tile (127 registers a thread), three
// for the narrower ones.
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, TN == 8 ? 2 : 3)
    conv_kernel(const ConvArgs p) {
  using C = Cfg<TM, TN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int HW = p.H * p.W;
  const int M = p.B * HW;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;

  int rb[C::AU], ry[C::AU], rx[C::AU];
#pragma unroll
  for (int j = 0; j < C::AU; ++j) {
    const int m = m0 + (tid >> 2) + (kThreads / 4) * j;
    rb[j] = -1; ry[j] = 0; rx[j] = 0;
    if (m < M) {
      rb[j] = m / HW;
      const int rem = m - rb[j] * HW;
      ry[j] = rem / p.W;
      rx[j] = rem - ry[j] * p.W;
    }
  }
  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  mainloop<TM, TN>(p.a, rb, ry, rx, p.w, p.F, n0, acc, smem);

  // the accumulators, through shared memory, as a (BM, BN) int32 tile
  int* cs = reinterpret_cast<int*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<int2*>(
            cs + (C::wm0(warp) + mt * 16 + g + 8 * r) * C::CS +
            C::wn0(warp) + nt * 8 + 2 * t4) =
            make_int2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
  __syncthreads();

  // thread (tx, ty): pixels ty + 16 i, channels tx * 4 + 64 h (+ 0..3)
  int pb[TM], py[TM], px[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    pb[i] = m < M ? m / HW : -1;
    const int rem = m - pb[i] * HW;
    py[i] = rem / p.W;
    px[i] = rem - py[i] * p.W;
  }
#pragma unroll
  for (int h = 0; h < TN / 4; ++h) {
    const int nl = tx * 4 + 64 * h, n = n0 + nl;
    if (n >= p.F) continue;
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(p.scale + n));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(p.bias + n));
    uint4 raw[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      raw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (p.res_kind != RES_NONE && pb[i] >= 0)
        raw[i] = load_res4(p, pb[i], py[i], px[i], n);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (pb[i] < 0) continue;
      const int4 v = *reinterpret_cast<const int4*>(
          cs + (ty + 16 * i) * C::CS + nl);
      const int acc4[4] = {v.x, v.y, v.z, v.w};
      epilogue4(p, pb[i], py[i], px[i], n, acc4, s4, b4, raw[i]);
    }
  }
}

template <int TM, int TN>
cudaError_t launch_conv(const ConvArgs& p, cudaStream_t stream) {
  using C = Cfg<TM, TN>;
  auto kernel = conv_kernel<TM, TN>;
  // above 48 KB the kernel has to be allowed its dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long M = (long long)p.B * p.H * p.W;
  dim3 grid((unsigned)((M + C::BM - 1) / C::BM),
            (unsigned)((p.F + C::BN - 1) / C::BN));
  kernel<<<grid, kThreads, C::SMEM, stream>>>(p);
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
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + C::PIPE);
  const int N = 4 * p.F;
  const int ystride = N + kStemYPad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
  int rb[C::AU], ry[C::AU], rx[C::AU];
#pragma unroll
  for (int j = 0; j < C::AU; ++j) {
    const bool ok = image_pixel((tid >> 2) + (kThreads / 4) * j, ry[j], rx[j]);
    rb[j] = ok ? b : -1;
  }

  const int g = lane >> 2, t4 = lane & 3;
  for (int n0 = 0; n0 < N; n0 += C::BN) {
    int acc[C::MT][C::NT][4];
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
    mainloop<8, 8>(a, rb, ry, rx, p.w, N, n0, acc, smem);
    // each accumulator element (tile row r, channel n) into the bf16 plane
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = C::wm0(warp) + mt * 16 + g + 8 * h;
        int pi, pj;
        const bool ok = image_pixel(r, pi, pj);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const int n = n0 + C::wn0(warp) + nt * 8 + 2 * t4;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // (int32 -> fp32 * scale) -> bf16, + bf16 bias in bf16, ReLU
            const __nv_bfloat16 y0 = __float2bfloat16_rn(__fmul_rn(
                (float)acc[mt][nt][2 * h + e], __ldg(p.scale + n + e)));
            const __nv_bfloat16 bb =
                __float2bfloat16_rn(__ldg(p.bias + n + e));
            const float y1 = __bfloat162float(__float2bfloat16_rn(
                __fadd_rn(__bfloat162float(y0), __bfloat162float(bb))));
            y[e] = ok ? fmaxf(y1, 0.0f) : 0.0f;
          }
          *reinterpret_cast<__nv_bfloat162*>(ys + r * ystride + n) =
              __floats2bfloat162_rn(y[0], y[1]);
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

// int8_conv3x3: x_pad (B, H+2, W+2, C) int8, w (9C, F) int8, out (B, H, W, F);
// C and F multiples of 16.
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
  p.relu = relu; p.qmul = qmul;
  p.out = out; p.out_v = plain_view(H, W); p.out_kind = out_kind;
  return (int)run_conv(p, static_cast<cudaStream_t>(stream));
}

// The identity bottleneck in one launch of the wgmma body. x and out are
// (B, Hs, Ws, 4Cw) with the (H, W) grid at (oy, ox): (H, W, 0, 0) for the
// plain layout, (H+2, Wp, 1, 1) for the padded one. w1t, w2t, w3t are the
// weights as `kmajor_tiles` lays them out. res_scale comes from rs_ptr
// (device) if not null, else rs_val. The geometry (tile rows and columns,
// rows of the products, cluster size, channels a pass, ring slots) is
// `bottleneck_geometry`'s in icka_tpu_torch/kernels/conv.py; one the body
// does not take returns cudaErrorInvalidValue.
extern "C" int icka_int8_bottleneck(
    const void* x, const void* w1t, const void* w2t, const void* w3t,
    const void* s1, const void* b1, const void* s2, const void* b2,
    const void* s3, const void* b3, const void* rs_ptr, float rs_val,
    void* out, int B, int H, int W, int Cw, int Hs, int Ws, int oy, int ox,
    int out_bf16, int TR, int TC, int BM1, int BM, int CL, int np1, int np2,
    int np3, int slots, void* stream) {
  icka_bneck::Args p{};
  p.x = static_cast<const int8_t*>(x);
  p.w1t = static_cast<const int8_t*>(w1t);
  p.w2t = static_cast<const int8_t*>(w2t);
  p.w3t = static_cast<const int8_t*>(w3t);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.s3 = static_cast<const float*>(s3);
  p.b3 = static_cast<const float*>(b3);
  p.rs_ptr = static_cast<const float*>(rs_ptr);
  p.rs_val = rs_val;
  p.out = out;
  p.B = B; p.H = H; p.W = W; p.Cw = Cw;
  p.Hs = Hs; p.Ws = Ws; p.oy = oy; p.ox = ox;
  p.out_bf16 = out_bf16;
  p.TR = TR; p.TC = TC; p.BM1 = BM1; p.BM = BM; p.CL = CL;
  p.np1 = np1; p.np2 = np2; p.np3 = np3; p.slots = slots;
  return (int)icka_bneck::launch(p, static_cast<cudaStream_t>(stream));
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
  const size_t smem = C::PIPE
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
