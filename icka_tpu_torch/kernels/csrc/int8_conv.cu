// int8 convolutions with fused epilogues for the ResNet serving path, sm_90a:
// the C entry points of the int8 wgmma bodies.
//
// Replaces the four Pallas TPU kernels of icka_tpu/kernels/conv.py:
//
//   int8_conv3x3        3x3/s1 conv of a pre-padded int8 image, 9 taps into
//                       int32, x scale(F) + bias(F) [+ residual] [ReLU], bf16
//                       or fp32 out, or int8 via round(out * (1/out_scale))
//                       clipped to +-127: int8_conv_wgmma.cuh;
//   int8_bottleneck_v2  identity bottleneck: 1x1 -> ReLU -> requant [0,127]
//   int8_bottleneck     -> 3x3 -> ReLU -> requant -> 1x1 + x * res_scale ->
//                       ReLU, int8 [0,127] or bf16 out (one function for
//                       both; v2 passes res_scale as a device scalar and may
//                       read and write the padded layout through strides):
//                       one launch of int8_bottleneck_wgmma.cuh;
//   int8_stem_pool      (B, OB, OB, K) int8 patches x (K, 4F) int8 into
//                       int32; per sub-pixel plane (fp32 * scale) -> bf16,
//                       + bf16 bias, ReLU; 3x3/s2 max-pool in
//                       space-to-depth space; (B, OB, OB, F) bf16 out:
//                       int8_conv_wgmma.cuh.
//
// All results are bit-equal to the plain PyTorch versions in
// icka_tpu_torch/kernels/conv.py: integer sums are exact, every epilogue is
// a separate round-to-nearest multiply and add (__fmul_rn, __fadd_rn: never
// contracted to an FMA) in the reference's order; rounding to integers is
// half-to-even (rintf); int32 -> fp32 is a plain cast.
//
// What bounds them on the H100, and what the bodies do about it (each
// header's note says more): the stem by bytes (224.8 MB at B = 128, 0.067
// ms at 3.35 TB/s; its products, padded, about 0.06 ms of the int8 peak),
// so its patches come once by TMA, its weight stays in shared memory and
// all 4F columns come from one landing of A; the 3x3 conv and the
// bottleneck by operations once a batch fills the card (K3 at B = 128, 14 x
// 14, C = F = 256: 0.015 ms at the int8 peak), so their products run on
// int8 wgmma, the only way to the card's int8 rate, with operands fed by
// TMA and no thread spending instructions on copies. Every body reads its
// weights K-major (8-bit wgmma reads both operands K-major only), laid out
// once on the host (`kmajor_tiles`). Every product is a wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_bottleneck_wgmma.cuh"
#include "int8_conv_wgmma.cuh"

// int8_conv3x3: x_pad (B, H+2, W+2, C) int8, wt `kmajor_tiles(w_q, 9)`, out
// (B, H, W, F); C and F multiples of 16. vecs: null, or scale and bias
// zero-padded to padded_width(F) each, end to end, where F is too wide for
// shared memory to hold them. res_kind 0 none, 2 bf16, 3 fp32;
// out_kind 0 int8 (x qmul), 1 bf16, 2 fp32. The geometry (tile rows and
// columns, rows of the product, channels a pass, ring slots, box buffers,
// spans a box) is `conv3x3_geometry`'s in icka_tpu_torch/kernels/conv.py;
// one the body does not take returns cudaErrorInvalidValue.
extern "C" int icka_int8_conv3x3(
    const void* x_pad, const void* wt, const void* scale, const void* bias,
    const void* vecs, const void* res, int res_kind, void* out, int out_kind,
    int B, int H, int W, int C, int F, int relu, float qmul, int TR, int TC,
    int BM, int np, int slots, int boxes, int sg, int grid, void* stream) {
  icka_convw::Conv3Args p{};
  p.x = static_cast<const int8_t*>(x_pad);
  p.wt = static_cast<const int8_t*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.vecs = static_cast<const float*>(vecs);
  p.res = res;
  p.res_kind = res_kind;
  p.out = out;
  p.out_kind = out_kind;
  p.relu = relu;
  p.qmul = qmul;
  p.B = B; p.H = H; p.W = W; p.C = C; p.F = F;
  p.TR = TR; p.TC = TC; p.BM = BM; p.np = np; p.slots = slots;
  p.boxes = boxes;
  p.sg = sg;
  return (int)icka_convw::launch_conv3(p, grid,
                                       static_cast<cudaStream_t>(stream));
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

// int8_stem_pool: patches (B, OB, OB, K) int8, wt `kmajor_tiles(w2)` of w2
// (K, N) int8, N = 4F of 128 or 256, out (B, OB, OB, F) bf16; K a multiple
// of 16. `slots` ring slots a consumer warpgroup, the weight resident in
// shared memory or streamed with the patches (`stem_geometry` in
// icka_tpu_torch/kernels/conv.py chooses them); at most `grid` CTAs.
extern "C" int icka_int8_stem_pool(
    const void* patches, const void* wt, const void* scale, const void* bias,
    void* out, int B, int OB, int K, int N, int slots, int resident,
    int grid, void* stream) {
  icka_convw::StemArgs p{};
  p.patches = static_cast<const int8_t*>(patches);
  p.wt = static_cast<const int8_t*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.OB = OB; p.K = K; p.N = N; p.slots = slots;
  p.resident = resident;
  return (int)icka_convw::launch_stem(p, grid,
                                      static_cast<cudaStream_t>(stream));
}
