// Implicit-GEMM s8 x s8 -> s32 on the tensor cores (mma.sync). It serves
// the 2x2 VALID s8 convolution (conv_s8.cu: the packed conv1_2 of the s2d
// int8 stem); the 3x3 conv and the s8 GEMM have wgmma kernels of their own.
//
// One output row m is one output pixel (b, h, w) of an NHWC map; one output
// column n is one output channel. The reduction runs over the taps (dy, dx)
// of a KH x KW window and, inside each tap, over the input channels c, the
// (dy, dx, c) order of the JAX package's im2col (quant.py:_conv_s8_im2col).
//
//   x    (B, H, W, C) int8 NHWC, C % 16 == 0, 16-byte aligned
//   w    (N, KH*KW*C) int8: output channel major, reduction contiguous
//   out  (B, Ho, Wo, N), Ho = H + 2*PAD - KH + 1 (likewise Wo), N % 16 == 0
//
// Block tile 128 x 128 outputs, 64 bytes of reduction per stage; 8 warps,
// each 64 x 32 outputs as 4 x 4 mma.sync.m16n8k32 tiles with s32
// accumulators in registers. Operand tiles go global -> shared with 16-byte
// cp.async, two stages deep; a tile row is one pixel's 64 channels of one
// tap (or one output channel's 64 weights), zero-filled where the tap falls
// in the SAME padding, past M or N, or past C. Zero taps add zero to an
// integer sum, so the padding is exact. Shared rows are 80 bytes apart,
// which makes the 32-bit fragment loads of a warp hit 32 distinct banks.
//
// The s32 sums are exact: |acc| <= 128 * 127 * K, under 2^31 for
// K <= 132,000.
//
// The epilogue is the JAX package's requant (quant.py:_conv_requant), done
// as ONE fused multiply-add, the rounding XLA gives it under jit:
//   y = fma(float(acc), k[n], b[n])            (__fmaf_rn: one rounding)
//   int8 out:    clip(rint(y), 0, 127)          (rint: half to even)
//   float32 out: max(y, 0)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace s8igemm {
namespace {  // each including source keeps its own copies

constexpr int BM = 128;          // output rows (pixels) of a block
constexpr int BN = 128;          // output columns (channels) of a block
constexpr int BK = 64;           // reduction bytes per stage
constexpr int LDS = BK + 16;     // shared row stride in bytes
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;           // warp tile rows
constexpr int WN = 32;           // warp tile columns

enum OutKind { OUT_S8 = 0, OUT_F32 = 1 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;   // 0: no read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// d += a (16x32, row) * b (32x8, col), s8 operands, s32 accumulate
__device__ __forceinline__ void mma_s8(int* d, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KH, int KW, int PAD, int OUT>
__global__ void __launch_bounds__(THREADS)
igemm_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ kscale,
                const float* __restrict__ bias, void* __restrict__ out,
                int B, int H, int W, int C, int N) {
  __shared__ __align__(16) int8_t sA[2][BM * LDS];
  __shared__ __align__(16) int8_t sB[2][BN * LDS];

  const int Ho = H + 2 * PAD - KH + 1;
  const int Wo = W + 2 * PAD - KW + 1;
  const long long M = (long long)B * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // loader role: rows lrow and lrow + 64 of each tile, 16-byte chunk `part`
  const int part = tid & 3;
  const int lrow = tid >> 2;
  int pb[2], ph[2], pw[2];
  bool pm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + lrow + 64 * i;
    pm[i] = m < M;
    const long long mm = pm[i] ? m : 0;
    pw[i] = (int)(mm % Wo);
    const long long t = mm / Wo;
    ph[i] = (int)(t % Ho);
    pb[i] = (int)(t / Ho);
  }
  const int cblocks = (C + BK - 1) / BK;
  const int KT = KH * KW * cblocks;
  const long long wrow = (long long)KH * KW * C;

  auto load_stage = [&](int stage, int it) {
    const int tap = it / cblocks;
    const int c = (it - tap * cblocks) * BK + part * 16;
    const int dy = tap / KW;
    const int dx = tap - dy * KW;
    const bool cok = c < C;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lrow + 64 * i;
      const int hi = ph[i] + dy - PAD;
      const int wi = pw[i] + dx - PAD;
      const bool ok = pm[i] && cok && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const int8_t* src =
          ok ? x + (((long long)pb[i] * H + hi) * W + wi) * C + c : x;
      cp_async16(&sA[stage][r * LDS + part * 16], src, ok);
      const int n = n0 + r;
      const bool okb = cok && n < N;
      const int8_t* srcb = okb ? w + n * wrow + (long long)tap * C + c : w;
      cp_async16(&sB[stage][r * LDS + part * 16], srcb, okb);
    }
  };

  // compute role: warp tile (wm, wn), fragment coordinates (g, t4)
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp >> 2) * WM;
  const int wn = (warp & 3) * WN;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < KT; ++it) {
    if (it + 1 < KT) {
      load_stage((it + 1) & 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a = sA[it & 1];
    const int8_t* b = sB[it & 1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = a + (wm + i * 16 + g) * LDS + ks + t4 * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b + (wn + j * 8 + g) * LDS + ks + t4 * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: thread holds rows g and g + 8, columns 2*t4 and 2*t4 + 1 of
  // each 16 x 8 tile; N is even, so a column pair is in or out together
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + t4 * 2;
    if (n >= N) continue;
    const float k0 = kscale[n], k1 = kscale[n + 1];
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm + i * 16 + g + half * 8;
        if (m >= M) continue;
        const int v0 = acc[i][j][2 * half];
        const int v1 = acc[i][j][2 * half + 1];
        const long long o = m * N + n;
        const float y0 = __fmaf_rn(__int2float_rn(v0), k0, b0);
        const float y1 = __fmaf_rn(__int2float_rn(v1), k1, b1);
        if (OUT == OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
        } else {
          const float q0 = fminf(fmaxf(rintf(y0), 0.f), 127.f);
          const float q1 = fminf(fmaxf(rintf(y1), 0.f), 127.f);
          char2 q;
          q.x = (signed char)(int)q0;
          q.y = (signed char)(int)q1;
          *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o) = q;
        }
      }
    }
  }
}

// one launch on `stream`; returns cudaGetLastError()
template <int KH, int KW, int PAD, int OUT>
int launch(const void* x, const void* w, const void* k, const void* b,
           void* out, int B, int H, int W, int C, int N, void* stream) {
  const long long M =
      (long long)B * (H + 2 * PAD - KH + 1) * (W + 2 * PAD - KW + 1);
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  igemm_s8_kernel<KH, KW, PAD, OUT>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const int8_t*)x, (const int8_t*)w, (const float*)k,
          (const float*)b, out, B, H, W, C, N);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace s8igemm
