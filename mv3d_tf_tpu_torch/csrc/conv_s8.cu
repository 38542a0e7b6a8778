// s8 convolutions with the fused requant epilogue: 3x3 SAME and 2x2 VALID,
// one kernel templated over the window.
//
// Replace the TPU kernels of mv3d_tf_tpu/ops/conv_s8_pallas.py:
//   conv3x3_s8_pallas_v2 (:155) and conv3x3_s8_pallas (:46), which compute
//     the same function (v1 as per-row dots, v2 as three large dots), so one
//     kernel serves both names: the int8 trunks (quant.py:_conv_requant, on
//     weights prepared once per detector) and, with float32 output, the int8
//     RPN conv (quant.py:rpn_conv_int8);
//   conv2x2_s8_pallas (:260), the packed conv1_2 of the s2d int8 stem
//     (quant.py:s2d_conv1_2_int8, on a weight prepared once per view).
// Plain versions: ops/conv_s8.py:conv3x3_s8_nk_plain and conv2x2_s8_nk_plain
// (the prepared operands this kernel reads), conv3x3_s8_plain and
// conv2x2_s8_plain.
//
// What bounds them on Hopper: operations. A trunk 3x3 conv does 2 * 9 * C
// multiply-adds per output byte it writes (C = 64..512), far above the
// card's ~590 int8 operations per byte of HBM. The stem's 2x2 (Cp = N =
// 256, K = 4 * 256) does ~1,000 per byte of its input and output: still
// above the ridge but close to it, so how well the epilogue overlaps the
// MMAs counts for more there. Either conv's 128 x 256 tile does ~170
// operations per byte it reads from L2. The design is the implicit GEMM
// M = B*Ho*Wo output pixels, N = output channels, K = KH*KW taps x Cp input
// channels, on the machinery of the s8 GEMM (matmul_s8.cu, sm90_s8.cuh):
//   * wgmma.mma_async m64nBNk32 s8 with s32 accumulators in registers, both
//     operands K-major in shared memory, as 8-bit wgmma requires; two
//     consumer warpgroups own 64 rows each of a 128 x BN tile (BN = 256
//     where N >= 256, else 128);
//   * a K slab is one tap's BK channels (BK = 128, or 64 where Cp is no
//     multiple of 128), so the KH * KW * Cp / BK slabs walk (dy, dx, c) in
//     the order of the prepared weight (N, KH*KW*Cp) (ops/conv_s8.py:
//     prepare_s8_conv_weight and prepare_s8_conv2x2_weight, laid out once
//     per weight);
//   * both operands arrive by TMA with the BK-byte swizzle that the wgmma
//     descriptors name, into a ring of 4-8 stages (~192 KB) counted on
//     mbarriers; one producer thread keeps the ring full, and a consumer
//     releases a slab once the wgmma group that read it has retired
//     (wait_group 1);
//   * the A operand (the im2col rows) is one TMA load per slab in im2col
//     mode: the 128 pixels m0 .. m0 + 127 of the tile, each shifted by the
//     tap (dx, dy), BK channels each. The tensor map's bounding box runs
//     the window origin over (-PAD .. W+PAD-KW) x (-PAD .. H+PAD-KH): for
//     the 3x3 SAME (-1 .. W-2) x (-1 .. H-2), for the 2x2 VALID
//     (0 .. W-2) x (0 .. H-2). So the hardware walks the Ho x Wo output
//     pixels of each image in NHWC order, across rows and images by
//     itself, and a tap that falls in the SAME padding (or a pixel past M)
//     reads zeros, which add zero to an integer sum: no address math, no
//     bounds tests and no per-pixel division in the kernel. A producer
//     warpgroup gathering A with cp.async (the other choice) would spend
//     128 threads on addresses and need a generic-to-async proxy fence
//     before each wgmma; TMA needs one thread and writes in the async
//     proxy that wgmma reads;
//   * the weights arrive by tiled TMA, zero past N; the N tiles of one M
//     tile run next to each other, so a tile of x comes from device memory
//     about once; the weights (<= 2.4 MB) stay in L2;
//   * persistent blocks, one per SM, walk the tiles with one ring for all
//     of them: the producer loads the next tile's first slabs while the
//     consumers store the last tile, so neither a block launch nor the
//     ring's fill is paid per tile (a C=64 3x3 tile has only nine slabs,
//     the stem's 2x2 tile eight);
//   * the epilogue is the JAX package's requant (quant.py:_conv_requant),
//     done as ONE fused multiply-add, the rounding XLA gives it under jit:
//       y = fma(float(acc), k[n], b[n])            (__fmaf_rn: one rounding)
//       int8 out:    clip(rint(y), 0, 127)          (rint: half to even)
//       float32 out: max(y, 0)
//     int8 results pass through eight staging rows per warp in shared
//     memory and leave as 16-byte stores covering whole rows (two-byte
//     stores straight from the fragments cost a third of the time);
//     float32 results leave from the fragments; rows past M are masked.
// The s32 sums are exact in any order: |acc| <= 128 * 127 * 9 * Cp < 2^31,
// so the kernel is bit-identical to the plain version. Channel counts that
// are no multiple of 64 are zero-padded by the wrapper (exact for integer
// sums).

#include "sm90_s8.cuh"

namespace {

enum Out { S8 = 0, F32 = 1 };

constexpr int BM = 128;             // output pixels of a block: 2 x m64
constexpr int THREADS = 384;        // a producer and two consumer warpgroups
constexpr int RING_BYTES = 192 * 1024;

template <int BK, int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      RING_BYTES / STAGE_BYTES < 8 ? RING_BYTES / STAGE_BYTES : 8;
  // int8 output leaves through 8 staging rows per consumer warp, 16 bytes
  // past a tile row so that the rows of a fragment store fall in different
  // banks
  static constexpr int SROW = BN + 16;
  static constexpr int STAGING = 8 * 8 * SROW;
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + STAGING + 2 * STAGES * 8 + 1024;
  static constexpr int ACC = BN / 2;   // s32 accumulators per consumer thread
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
                "swizzled tiles must start 1024-byte aligned");
};

// A KH x KW window with PAD pixels of zero padding on each side, stride 1:
// map_x: im2col map of x (B,H,W,C) int8 (encode_im2col with the window's
// corners); map_w: tiled map of the prepared weight (N, KH*KW*C); k, b (N,)
// float32; out (B*Ho*Wo, N) int8 or float32, M = B*Ho*Wo.
template <int KH, int KW, int PAD, int BK, int BN, int OUT>
__global__ void __launch_bounds__(THREADS, 1)
conv_s8_wgmma(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w,
              const float* __restrict__ kscale,
              const float* __restrict__ bias, void* __restrict__ out, int M,
              int Ho, int Wo, int C, int N) {
  using namespace sm90;
  typedef Tile<BK, BN> T;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need 1024-byte aligned tiles
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;                               // STAGES x A tile
  uint8_t* sb = smem + T::STAGES * T::A_BYTES;      // STAGES x B tile
  uint8_t* staging = smem + T::STAGES * T::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + T::STAGING);
  uint64_t* empty = full + T::STAGES;

  const int ntiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * ntiles;
  const int cslabs = C / BK;
  const int ktiles = KH * KW * cslabs;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);                      // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // persistent: block b takes tiles b, b + gridDim.x, ...; N fastest, so
  // the N tiles of an M tile run side by side and share its x. The ring
  // runs on across tiles: `it` counts the slabs of all the block's tiles.
  if (wg == 0) {
    // producer: one thread keeps the ring full, into the next tile's slabs
    // while the consumers store the last one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % ntiles) * BN;
        const int m0 = (tile / ntiles) * BM;
        // the tile's first output pixel; its window starts PAD pixels up
        // and left
        const int hw = Ho * Wo;
        const int img = m0 / hw;
        const int oh = (m0 - img * hw) / Wo;
        const int ow = m0 - img * hw - oh * Wo;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % T::STAGES;
          const int tap = kt / cslabs;
          mbar_wait(&empty[s], ((it / T::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::STAGE_BYTES);
          tma_load_im2col(sa + s * T::A_BYTES, &map_x, &full[s],
                          (kt - tap * cslabs) * BK, ow - PAD, oh - PAD, img,
                          (uint16_t)(tap % KW), (uint16_t)(tap / KW));
          tma_load(sb + s * T::B_BYTES, &map_w, &full[s], kt * BK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;                           // consumer: rows c*64 ..
    const int t = threadIdx.x % 128;
    const bool leader = t == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % ntiles) * BN;
      const int m0 = (tile / ntiles) * BM;
      int d[T::ACC];
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) d[i] = 0;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % T::STAGES;
        mbar_wait(&full[s], (it / T::STAGES) & 1);
        const uint64_t da =
            kmajor_desc<BK>(sa + s * T::A_BYTES + c * 64 * BK);
        const uint64_t db = kmajor_desc<BK>(sb + s * T::B_BYTES);
        fence_acc<T::ACC>(d);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k)           // 32 bytes of K each
          wgmma_s8<BN>(d, da + 2 * k, db + 2 * k);
        wgmma_commit();
        // the group before this one has retired: its slab is free
        wgmma_wait<1>();
        fence_acc<T::ACC>(d);
        if (kt > 0 && leader) mbar_arrive(&empty[(it - 1) % T::STAGES]);
      }
      wgmma_wait<0>();
      fence_acc<T::ACC>(d);
      if (leader) mbar_arrive(&empty[(it - 1) % T::STAGES]);

      // requant from the m64nBN fragments (sm90_s8.cuh:wgmma_s8); N is
      // even, so a column pair is in or out together
      const int w = t / 32, g = (t % 32) / 4, q2 = 2 * (t % 4);
      if (OUT == F32) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + q2;
          if (n >= N) continue;
          const float2 kk = *reinterpret_cast<const float2*>(kscale + n);
          const float2 bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + c * 64 + w * 16 + h * 8 + g;
            if (m >= M) continue;
            const float y0 =
                __fmaf_rn(__int2float_rn(d[4 * j + 2 * h]), kk.x, bb.x);
            const float y1 =
                __fmaf_rn(__int2float_rn(d[4 * j + 2 * h + 1]), kk.y, bb.y);
            *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                       (size_t)m * N + n) =
                make_float2(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
          }
        }
      } else {
        // int8: eight rows at a time through the warp's staging rows, then
        // out as 16-byte stores that cover whole rows (N % 16 == 0)
        uint8_t* rows = staging + (c * 4 + w) * 8 * T::SROW;
        const int lane = t % 32;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int n = min(n0 + 8 * j + q2, N - 2);
            const float2 kk = *reinterpret_cast<const float2*>(kscale + n);
            const float2 bb = *reinterpret_cast<const float2*>(bias + n);
            const float y0 =
                __fmaf_rn(__int2float_rn(d[4 * j + 2 * h]), kk.x, bb.x);
            const float y1 =
                __fmaf_rn(__int2float_rn(d[4 * j + 2 * h + 1]), kk.y, bb.y);
            char2 q;
            q.x = (signed char)(int)fminf(fmaxf(rintf(y0), 0.f), 127.f);
            q.y = (signed char)(int)fminf(fmaxf(rintf(y1), 0.f), 127.f);
            *reinterpret_cast<char2*>(rows + g * T::SROW + 8 * j + q2) = q;
          }
          __syncwarp();
#pragma unroll
          for (int i = lane; i < 8 * BN / 16; i += 32) {
            const int r = i / (BN / 16), n = n0 + (i % (BN / 16)) * 16;
            const int m = m0 + c * 64 + w * 16 + h * 8 + r;
            if (m < M && n < N)
              *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) +
                                        (size_t)m * N + n) =
                  *reinterpret_cast<const uint4*>(rows + r * T::SROW +
                                                  (i % (BN / 16)) * 16);
          }
          __syncwarp();
        }
      }
    }
  }
}

// x (B,H,W,C) int8 NHWC: 128-pixel columns of BK channels, window origins
// over (-PAD .. W-1+PAD+1-KW) x (-PAD .. H-1+PAD+1-KH), zeros outside the
// tensor: lower corner -PAD, upper corner PAD+1-K on each axis, (-1, -1)
// and (-1, -1) for the 3x3 SAME, (0, 0) and (-1, -1) for the 2x2 VALID
template <int KH, int KW, int PAD>
CUresult encode_im2col(sm90::EncodeIm2col fn, CUtensorMap* map, const void* x,
                       int B, int H, int W, int C, int bk) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                                 (cuuint64_t)H * W * C};
  const int lower[2] = {-PAD, -PAD};  // (w, h) of the first window origin
  // the last, relative to (W - 1, H - 1)
  const int upper[2] = {PAD + 1 - KW, PAD + 1 - KH};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                        const_cast<void*>(x), dims, strides, lower, upper,
                        (cuuint32_t)bk, (cuuint32_t)BM, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sm90::swizzle_of(bk),
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // drivers up to 13.1 encode im2col maps of tensors under 128 KB with a
  // flag that must be clear; CUTLASS clears it the same way
  // (cute/atom/copy_traits_sm90_im2col.hpp, make_im2col_tma_copy_desc)
  int driver = 0;
  if (r == CUDA_SUCCESS && cudaDriverGetVersion(&driver) == cudaSuccess &&
      driver <= 13010 && (size_t)B * H * W * C < 131072)
    reinterpret_cast<uint64_t*>(map)[1] &= ~(1ull << 21);
  return r;
}

template <int KH, int KW, int PAD, int BK, int BN, int OUT>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w, const void* k,
           const void* b, void* out, int M, int Ho, int Wo, int C, int N,
           void* stream) {
  typedef Tile<BK, BN> T;
  cudaError_t err = cudaFuncSetAttribute(
      conv_s8_wgmma<KH, KW, PAD, BK, BN, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);   // one block per SM
  conv_s8_wgmma<KH, KW, PAD, BK, BN, OUT>
      <<<grid, THREADS, T::SMEM, (cudaStream_t)stream>>>(
          map_x, map_w, (const float*)k, (const float*)b, out, M, Ho, Wo, C,
          N);
  return (int)cudaGetLastError();
}

template <int KH, int KW, int PAD, int BK, int BN>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w, const void* k,
           const void* b, void* out, int M, int Ho, int Wo, int C, int N,
           int out_f32, void* stream) {
  if (out_f32)
    return launch<KH, KW, PAD, BK, BN, F32>(map_x, map_w, k, b, out, M, Ho,
                                            Wo, C, N, stream);
  return launch<KH, KW, PAD, BK, BN, S8>(map_x, map_w, k, b, out, M, Ho, Wo,
                                         C, N, stream);
}

// x (B,H,W,C) int8, C % 64 == 0; w (N, KH*KW*C) int8 in (dy, dx, c) order
// (the prepared weight), N % 16 == 0; k and b (N,) float32; all 16-byte
// aligned -> out (B,Ho,Wo,N) int8, or float32 when out_f32 is nonzero.
// The tile widths follow C and N; the tensor maps are encoded per call.
template <int KH, int KW, int PAD>
int conv_s8(const void* x, const void* w, const void* k, const void* b,
            void* out, int B, int H, int W, int C, int N, int out_f32,
            void* stream) {
  if (C % 64 != 0) return (int)cudaErrorInvalidValue;
  const sm90::EncodeTiled tiled = sm90::encode_tiled_fn();
  const sm90::EncodeIm2col im2col = sm90::encode_im2col_fn();
  if (tiled == nullptr || im2col == nullptr) return -999;
  const int bk = C % 128 == 0 ? 128 : 64;
  const int bn = N >= 256 ? 256 : 128;
  CUtensorMap map_x, map_w;
  CUresult r = encode_im2col<KH, KW, PAD>(im2col, &map_x, x, B, H, W, C, bk);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_kmajor(tiled, &map_w, w, N, KH * KW * C, bn, bk);
  if (r != CUDA_SUCCESS) return -(int)r;
  const int Ho = H + 2 * PAD - KH + 1, Wo = W + 2 * PAD - KW + 1;
  const int M = B * Ho * Wo;
  if (bk == 128 && bn == 256)
    return launch<KH, KW, PAD, 128, 256>(map_x, map_w, k, b, out, M, Ho, Wo,
                                         C, N, out_f32, stream);
  if (bk == 128)
    return launch<KH, KW, PAD, 128, 128>(map_x, map_w, k, b, out, M, Ho, Wo,
                                         C, N, out_f32, stream);
  if (bn == 256)
    return launch<KH, KW, PAD, 64, 256>(map_x, map_w, k, b, out, M, Ho, Wo,
                                        C, N, out_f32, stream);
  return launch<KH, KW, PAD, 64, 128>(map_x, map_w, k, b, out, M, Ho, Wo, C,
                                      N, out_f32, stream);
}

}  // namespace

// x (B,H,W,C) int8, C % 64 == 0; w (N, 9*C) int8 in (dy, dx, c) order (the
// prepared weight), N % 16 == 0; k and b (N,) float32; all 16-byte aligned
// -> out (B,H,W,N) int8, or float32 when out_f32 is nonzero. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a C the
// kernel does not take, or -CUresult if a tensor map could not be encoded
// (-999 if a driver entry point was not found).
extern "C" int mv3d_conv3x3_s8(const void* x, const void* w, const void* k,
                               const void* b, void* out, int B, int H, int W,
                               int C, int N, int out_f32, void* stream) {
  return conv_s8<3, 3, 1>(x, w, k, b, out, B, H, W, C, N, out_f32, stream);
}

// x (B,H,W,C) int8, C % 64 == 0, H and W >= 2; w (N, 4*C) int8 in
// (dy, dx, c) order (the prepared weight) -> out (B,H-1,W-1,N); otherwise
// as mv3d_conv3x3_s8, return codes included
extern "C" int mv3d_conv2x2_s8(const void* x, const void* w, const void* k,
                               const void* b, void* out, int B, int H, int W,
                               int C, int N, int out_f32, void* stream) {
  return conv_s8<2, 2, 0>(x, w, k, b, out, B, H, W, C, N, out_f32, stream);
}
