// What the attention bodies of blockwise_attention.cu,
// attention_wgmma.cuh and attention_wgmma_tf32.cuh share: element access
// for fp32 and bf16, bf16 packing, the TF32 rounding and split of 3xTF32,
// warp reductions, and the start of the online softmax's running maximum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace icka_attention {

// The running maximum starts here and not at -inf: a key tile whose scores
// are all -inf (a caller's -inf bias) then gives p = 0 and alpha = 1, where
// -inf would give exp(-inf + inf) = NaN.
constexpr float kMinusBig = -1e30f;

// Element type T of q/k/v/out: scalar load, store and rounding to T, and a
// Chunk of four elements that moves in one instruction.
template <typename T>
struct Num;

template <>
struct Num<float> {
  using Chunk = float4;
  static __device__ __forceinline__ Chunk zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void unpack(const Chunk& c, float* f) {
    f[0] = c.x, f[1] = c.y, f[2] = c.z, f[3] = c.w;
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  using Chunk = uint2;  // four bf16
  static __device__ __forceinline__ Chunk zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void unpack(const Chunk& c, float* f) {
    f[0] = __uint_as_float(c.x << 16);
    f[1] = __uint_as_float(c.x & 0xffff0000u);
    f[2] = __uint_as_float(c.y << 16);
    f[3] = __uint_as_float(c.y & 0xffff0000u);
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// two floats rounded to bf16 (to nearest even), `lo` in the low half: the
// A operand of a bf16 tensor-core product held in registers
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace icka_attention
