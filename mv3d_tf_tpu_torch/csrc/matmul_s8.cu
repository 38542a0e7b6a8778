// Tiled s8 x s8 -> s32 GEMM.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/conv_s8_pallas.py:matmul_s8_pallas
// (:376). In the port it carries the int8 fusion head's fc6/fc7 products
// (quant.py:_fc_s8), which the JAX package leaves to XLA's s8 dot; PyTorch
// has no public int8 matmul on CUDA. Plain version:
// ops/conv_s8.py:matmul_s8_plain.
//
// What bounds it on Hopper: operations at the head's shapes (M = 300 rois
// a frame, K = 25088 or 2048, N = 2048: ~2400 operations per byte at B=8),
// bytes for small M. It is the 1x1 case of the implicit GEMM of
// s8_igemm.cuh: A rows are a's rows, B rows are b's columns (the wrapper
// passes b transposed, reduction contiguous), 128 x 128 block tiles on
// mma.sync s8, s32 sums written as they are. Ragged M and N tiles are
// masked in the kernel, K at 16 bytes (the wrapper zero-pads K and N to a
// multiple of 16).

#include "s8_igemm.cuh"

using namespace s8igemm;

// a (M,K) int8 row-major, bt (N,K) int8 row-major -> out (M,N) int32
extern "C" int mv3d_matmul_s8(const void* a, const void* bt, void* out, int M,
                              int K, int N, void* stream) {
  return launch<1, 1, 0, OUT_S32>(a, bt, nullptr, nullptr, out, 1, 1, M, K, N,
                                  stream);
}
