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
// HBM byte. The earlier kernel (the 1x1 instance of s8_igemm.cuh: mma.sync
// m16n8k32, 2-stage cp.async, 64 bytes of K a stage) reached ~11% of the
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one 2-D TMA tile load: box at (inner k, outer row) -> dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: 8-row core groups 1024 bytes apart (SBO), the leading offset
// unused by swizzled K-major layouts, layout type 1 (SWIZZLE_128B) in bits
// 62-63. Moving along K inside the 128-byte row adds bytes / 16 to the
// start address field; the hardware applies the swizzle to the address.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x 160 s32, the warpgroup's fragment) += A (64 x 32) * B (160 x 32)^T
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

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
      const uint64_t da = sw128_desc(sa + s * A_BYTES + c * 64 * BK);
      const uint64_t db = sw128_desc(sb + s * B_BYTES);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)          // 32 bytes of K each
        wgmma_s8(d, da + 2 * k, db + 2 * k);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the group before this one has retired: its slab is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, K) int8 row-major at ptr, boxes of box_rows x BK, 128-byte swizzle,
// zeros past the edges
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
                int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// a (M,K) int8 row-major, bt (N,K) int8 row-major -> out (M,N) int32.
// Returns cudaGetLastError() after the launch, or -CUresult if a tensor map
// could not be encoded (-999 if the driver entry point was not found).
extern "C" int mv3d_matmul_s8(const void* a, const void* bt, void* out, int M,
                              int K, int N, void* stream) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -999;
  CUtensorMap map_a, map_b;
  CUresult r = encode(fn, &map_a, a, M, K, BM);
  if (r == CUDA_SUCCESS) r = encode(fn, &map_b, bt, N, K, BN);
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
