// Fused VGG stem: pool2x2_valid(relu(conv1_2(bf16(relu(conv1_1(x)))))) in
// one pass, NHWC, bf16 operands, float32 accumulation and biases.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/vgg_stem_pallas.py:vgg_stem_pallas
// (pl.pallas_call at :226). Same math: both 3x3 convs SAME with bias and
// ReLU, conv1_1's output rounded to bf16 before conv1_2, the 2x2 VALID max
// pool (an odd last row/column is dropped), a bf16 output. The 64-channel
// full-resolution intermediates never reach device memory.
//
// What bounds it on Hopper: arithmetic. conv1_2 is 64x64x9 multiply-adds
// per full-resolution pixel (13.3 G per 601x601 frame); this first version
// runs them as float32 FMAs on the CUDA cores, not on the tensor cores
// (wgmma is later work). The design keeps every operand of those FMAs in
// shared memory or registers: one block per 8x8 tile of pooled outputs
// stages all of conv1_2's weights (72 KB), the 20x20 input tile with its
// 2-pixel halo, and conv1_1's 18x18 output tile with its 1-pixel halo
// (bf16). Each thread then owns one pooled pixel x 8 output channels: it
// accumulates the 2x2 conv1_2 pixels under that pool window (32 sums in
// registers), reuses each weight load 4 times and each activation load 8
// times, and pools in registers before one 16-byte store.
//
// The trap: conv1_1 outputs that fall outside the image are conv1_2's SAME
// padding, so they are stored as 0, not relu(b1) (the TPU kernel's mask at
// vgg_stem_pallas.py:163-171).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 64;                  // stem width
constexpr int kCinP = 16;               // input channels, padded
constexpr int kTP = 8;                  // pooled outputs per tile edge
constexpr int kTY = 2 * kTP + 2;        // conv1_1 tile edge (1-pixel halo)
constexpr int kTX = 2 * kTP + 4;        // input tile edge (2-pixel halo)
constexpr int kYS = kC + 8;             // y1 pixel stride: 144 B, no conflicts
constexpr int kThreads = kTP * kTP * 8; // (pooled pixel, 8-channel group)

constexpr int kW2Elems = 9 * kC * kC;
constexpr int kW1Elems = 9 * kCinP * kC;
constexpr int kY1Elems = kTY * kTY * kYS;
constexpr int kXElems = kTX * kTX * kCinP;
constexpr int kSmemBytes =
    (kW2Elems + kW1Elems + kY1Elems + kXElems) * (int)sizeof(bf16);

__device__ __forceinline__ void unpack8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  __align__(16) bf16 r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = __float2bfloat16_rn(f[k]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r);
}

// x (B,H,W,Cin) bf16; w1 (3,3,kCinP,64) bf16 HWIO, zero past Cin;
// w2 (3,3,64,64) bf16 HWIO; b1, b2 (64,) f32; out (B,H/2,W/2,64) bf16.
__global__ void __launch_bounds__(kThreads, 1)
    vgg_stem_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const bf16* __restrict__ w2,
                    const float* __restrict__ b2, bf16* __restrict__ out,
                    int H, int W, int Cin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w2s = reinterpret_cast<bf16*>(smem_raw);
  bf16* w1s = w2s + kW2Elems;
  bf16* y1s = w1s + kW1Elems;
  bf16* xs = y1s + kY1Elems;

  const int H2 = H / 2, W2 = W / 2;
  const int n = blockIdx.z;
  const int py0 = blockIdx.y * kTP, px0 = blockIdx.x * kTP;
  const int t = threadIdx.x;
  const int co0 = (t & 7) * 8;
  const int gy0 = 2 * py0 - 2, gx0 = 2 * px0 - 2;  // input pixel at xs[0]

  for (int i = t; i < kW2Elems / 8; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(w2)[i];
  for (int i = t; i < kW1Elems / 8; i += kThreads)
    reinterpret_cast<uint4*>(w1s)[i] = reinterpret_cast<const uint4*>(w1)[i];
  // input tile; zero outside the image (conv1_1's SAME padding) and past Cin
  const bf16* xn = x + (size_t)n * H * W * Cin;
  for (int i = t; i < kXElems; i += kThreads) {
    const int c = i % kCinP, p = i / kCinP;
    const int gy = gy0 + p / kTX, gx = gx0 + p % kTX;
    bf16 v = __float2bfloat16_rn(0.0f);
    if (c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xn[((size_t)gy * W + gx) * Cin + c];
    xs[i] = v;
  }
  __syncthreads();

  // conv1_1 + bias + ReLU over the haloed tile, rounded to bf16
  for (int p = t >> 3; p < kTY * kTY; p += kThreads / 8) {
    const int yy = p / kTY, yx = p % kTY;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) {
        const bf16* xp = xs + ((yy + u) * kTX + (yx + v)) * kCinP;
        const bf16* wp = w1s + (u * 3 + v) * kCinP * kC + co0;
        for (int c = 0; c < Cin; ++c) {
          const float xv = __bfloat162float(xp[c]);
          float wv[8];
          unpack8(wp + c * kC, wv);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(xv, wv[k], acc[k]);
        }
      }
    }
    const int gy = gy0 + 1 + yy, gx = gx0 + 1 + yx;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc[k] = inside ? fmaxf(acc[k] + b1[co0 + k], 0.0f) : 0.0f;
    store8(y1s + p * kYS + co0, acc);
  }
  __syncthreads();

  // conv1_2 for the 2x2 pixels under this thread's pool window
  const int pp = t >> 3;
  const int ppy = pp / kTP, ppx = pp % kTP;
  float acc[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[q][k] = 0.0f;
  for (int u = 0; u < 3; ++u) {
    for (int v = 0; v < 3; ++v) {
      const bf16* yb = y1s + ((2 * ppy + u) * kTY + (2 * ppx + v)) * kYS;
      const bf16* wb = w2s + (u * 3 + v) * kC * kC + co0;
#pragma unroll 4
      for (int ci = 0; ci < kC; ci += 2) {
        float wa[8], wc[8];
        unpack8(wb + ci * kC, wa);
        unpack8(wb + (ci + 1) * kC, wc);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 yv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  yb + ((q >> 1) * kTY + (q & 1)) * kYS + ci));
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            acc[q][k] = fmaf(yv.x, wa[k], acc[q][k]);
            acc[q][k] = fmaf(yv.y, wc[k], acc[q][k]);
          }
        }
      }
    }
  }
  // bias, ReLU and the 2x2 max; rounding is monotone, so pooling before the
  // bf16 rounding gives the same bits as pooling after it
  const int py = py0 + ppy, px = px0 + ppx;
  if (py < H2 && px < W2) {
    float r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float m = fmaxf(fmaxf(acc[0][k], acc[1][k]),
                            fmaxf(acc[2][k], acc[3][k]));
      r[k] = fmaxf(m + b2[co0 + k], 0.0f);
    }
    store8(out + (((size_t)n * H2 + py) * W2 + px) * kC + co0, r);
  }
}

}  // namespace

extern "C" int mv3d_vgg_stem_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, int Cin, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      vgg_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int H2 = H / 2, W2 = W / 2;
  dim3 grid((W2 + kTP - 1) / kTP, (H2 + kTP - 1) / kTP, B);
  vgg_stem_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (bf16*)out, H, W, Cin);
  return (int)cudaGetLastError();
}
