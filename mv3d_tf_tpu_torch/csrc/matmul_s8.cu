// s8 x s8 -> s32 GEMM on Hopper's warpgroup tensor-core instruction.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/conv_s8_pallas.py:matmul_s8_pallas
// (:376). In the port it carries the int8 fusion head's fc6/fc7 products
// (quant.py:_fc_s8), which the JAX package leaves to XLA's s8 dot. Plain
// versions: ops/conv_s8.py:matmul_s8_plain (b as (K, N)) and
// matmul_s8_nk_plain (the (N, K) operand this kernel reads).
//
//   a    (M, K) int8 row-major, K % 16 == 0, 16-byte aligned
//   bt   (N, K) int8 row-major: b transposed, reduction contiguous (the
//        layout ops/conv_s8.prepare_s8_gemm_weight makes once per weight)
//   out  (M, N) int32, the exact sums
//
// What bounds it on this card: operations. The head's products (M = 2400
// rois at B=8, N = 2048, K = 25088 for fc6 and 2048 for fc7) do ~2400
// operations per unique byte, far above the card's ~590 int8 operations per
// HBM byte. The earlier kernel (an implicit GEMM on mma.sync m16n8k32,
// 2-stage cp.async, 64 bytes of K a stage) reached ~11% of the
// int8 peak: every warp spent its issue slots on shared-memory fragment
// loads, and fc6's 392 barrier-separated stages exposed each load's latency.
//
// What this design does about it:
//   * wgmma.mma_async m64n160k32 s8 reads both operands straight from
//     shared memory (K-major, which 8-bit wgmma requires of both, and which
//     the (N, K) operand gives); no fragment loads, no ldmatrix;
//   * TMA brings each 128-byte-deep K slab of A (128 rows) and B (160
//     rows) into a ring of STAGES buffers with the 128-byte swizzle that the
//     wgmma descriptors name; completion is counted on an mbarrier, so no
//     thread spends registers or instructions on addresses;
//   * one producer thread (its warpgroup drops to 40 registers with
//     setmaxnreg) keeps STAGES - 1 slabs in flight ahead of two consumer
//     warpgroups (raised to 232), each owning 64 rows x 160 columns of s32
//     accumulators in registers; a consumer releases a slab once the wgmma
//     group that read it has retired (wait_group 1);
//   * the 128 x 160 tile is chosen for the head's waves: 19 x 13 = 247
//     tiles on 132 SMs is 1.87 waves (128 x 256 would be 1.15, 128 x 128
//     2.3). All blocks walk K in step, so the K slab that every tile of a
//     wave reads (~0.6 MB for fc6) stays in L2 and device memory sees the
//     operands about once;
//   * ragged edges cost nothing extra: TMA fills rows past M or N and
//     columns past K with zeros (which add zero to an integer sum), and the
//     epilogue masks its stores.
//
// The s32 sums are exact in any order: |acc| <= 128 * 127 * K < 2^31 for
// K <= 132,000, so the kernel is bit-identical to the plain version.
//
// The tensor maps are encoded on the host for each call with the driver's
// cuTensorMapEncodeTiled, fetched once through cudaGetDriverEntryPoint, so
// the library links without -lcuda.

#include "sm90_s8.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;             // output rows of a block: 2 x m64
constexpr int BN = 160;             // output columns of a block
constexpr int BK = 128;             // K bytes of a slab: one 128-byte swizzle row
constexpr int STAGES = 5;           // slabs in the ring
constexpr int THREADS = 384;        // producer warpgroup + 2 consumer warpgroups
constexpr int A_BYTES = BM * BK;    // 16 KB
constexpr int B_BYTES = BN * BK;    // 20 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int ACC = BN / 2;         // s32 accumulators per consumer thread
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
              "swizzled tiles must start 1024-byte aligned");

__global__ void __launch_bounds__(THREADS, 1)
matmul_s8_wgmma(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                int* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need 1024-byte aligned tiles
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;                            // STAGES x A tile
  uint8_t* sb = smem + STAGES * A_BYTES;         // STAGES x B tile
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int mtiles = (M + BM - 1) / BM;
  const int m0 = (blockIdx.x % mtiles) * BM;     // M fastest: a wave shares
  const int n0 = (blockIdx.x / mtiles) * BN;     // B's columns
  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);                   // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(sa + s * A_BYTES, &map_a, &full[s], kt * BK, m0);
        tma_load(sb + s * B_BYTES, &map_b, &full[s], kt * BK, n0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;                        // consumer: rows c*64 ..
    int d[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) d[i] = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint64_t da = kmajor_desc<BK>(sa + s * A_BYTES + c * 64 * BK);
      const uint64_t db = kmajor_desc<BK>(sb + s * B_BYTES);
      fence_acc<ACC>(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)          // 32 bytes of K each
        wgmma_s8<BN>(d, da + 2 * k, db + 2 * k);
      wgmma_commit();
      // the group before this one has retired: its slab is free
      wgmma_wait<1>();
      fence_acc<ACC>(d);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc<ACC>(d);

    // fragment layout of m64nN: warp w of the group holds rows 16w + l/4
    // and 16w + l/4 + 8; register 4j + e holds column 8j + 2(l%4) + (e&1)
    const int t = threadIdx.x % 128;
    const int row = m0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = n0 + 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = col + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= M || n >= N) continue;
        int* o = out + (size_t)m * N + n;
        const int v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
  }
}

}  // namespace

// a (M,K) int8 row-major, bt (N,K) int8 row-major -> out (M,N) int32.
// Returns cudaGetLastError() after the launch, or -CUresult if a tensor map
// could not be encoded (-999 if the driver entry point was not found).
extern "C" int mv3d_matmul_s8(const void* a, const void* bt, void* out, int M,
                              int K, int N, void* stream) {
  const EncodeTiled fn = encode_tiled_fn();
  if (fn == nullptr) return -999;
  CUtensorMap map_a, map_b;
  CUresult r = encode_kmajor(fn, &map_a, a, M, K, BM, BK);
  if (r == CUDA_SUCCESS) r = encode_kmajor(fn, &map_b, bt, N, K, BN, BK);
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_s8_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  matmul_s8_wgmma<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      map_a, map_b, (int*)out, M, N, K);
  return (int)cudaGetLastError();
}
