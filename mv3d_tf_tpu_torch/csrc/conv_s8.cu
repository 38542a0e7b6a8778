// s8 convolutions with the fused requant epilogue: 3x3 SAME and 2x2 VALID.
//
// Replace the TPU kernels of mv3d_tf_tpu/ops/conv_s8_pallas.py:
//   conv3x3_s8_pallas_v2 (:155) and conv3x3_s8_pallas (:46), which compute
//     the same function (v1 as per-row dots, v2 as three large dots), so one
//     kernel serves both names: the int8 trunks (quant.py:249-273) and, with
//     float32 output, the int8 RPN conv (quant.py:567-574);
//   conv2x2_s8_pallas (:260), the packed conv1_2 of the s2d int8 stem
//     (quant.py:508-515).
// Plain versions: ops/conv_s8.py:conv3x3_s8_plain and conv2x2_s8_plain.
//
// What bounds it on Hopper: operations. A trunk conv does 2 * 9 * C
// multiply-adds per output byte it writes (C = 64..512), far above the
// card's ~590 int8 operations per byte of HBM, so the s8 tensor cores are
// the limit. The design answers with an implicit GEMM on mma.sync s8 tiles
// (s8_igemm.cuh): no im2col in memory, each input pixel read from L2 once per
// tap, s32 sums in registers, the requant fused into the store, and only
// the int8 (or float32) output written. The TPU kernel's row-halo views,
// tile-row budget and 128-lane channel padding have no counterpart: any
// C % 16 == 0 is taken, the wrapper zero-pads other C. wgmma and TMA are
// later work.

#include "s8_igemm.cuh"

using namespace s8igemm;

namespace {

template <int KH, int KW, int PAD>
int conv(const void* x, const void* w, const void* k, const void* b,
         void* out, int B, int H, int W, int C, int N, int out_f32,
         void* stream) {
  if (out_f32)
    return launch<KH, KW, PAD, OUT_F32>(x, w, k, b, out, B, H, W, C, N,
                                        stream);
  return launch<KH, KW, PAD, OUT_S8>(x, w, k, b, out, B, H, W, C, N, stream);
}

}  // namespace

// x (B,H,W,C) int8, w (N, 9*C) int8 in (dy, dx, c) order, k and b (N,)
// float32 -> out (B,H,W,N) int8, or float32 when out_f32 is nonzero
extern "C" int mv3d_conv3x3_s8(const void* x, const void* w, const void* k,
                               const void* b, void* out, int B, int H, int W,
                               int C, int N, int out_f32, void* stream) {
  return conv<3, 3, 1>(x, w, k, b, out, B, H, W, C, N, out_f32, stream);
}

// x (B,H,W,C) int8, w (N, 4*C) int8 -> out (B,H-1,W-1,N)
extern "C" int mv3d_conv2x2_s8(const void* x, const void* w, const void* k,
                               const void* b, void* out, int B, int H, int W,
                               int C, int N, int out_f32, void* stream) {
  return conv<2, 2, 0>(x, w, k, b, out, B, H, W, C, N, out_f32, stream);
}
