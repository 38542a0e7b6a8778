// Fused space-to-depth VGG stem: conv1_1 + ReLU + conv1_2 + ReLU + pool1 in
// one pass, NHWC, float32 or bf16 operands, float32 sums and biases.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/stem_s2d_pallas.py:stem_s2d_fused
// (pl.pallas_call at :224). Same function, with its rounding rule: the
// intermediate y = relu(conv1_1(x) + b1) is summed and biased in float32,
// zeroed where it falls outside the image (conv1_2's SAME padding, the edge
// mask at :171-184), and rounded ONCE to the io type; then
// z = conv1_2(y) is summed in float32, relu(z + b2) taken with b2 in float32
// and the 2x2 max pool rounded once to the io type.
//
// The TPU kernel packs 2x2 pixel blocks into 256 channels so that conv1_1
// becomes a 4x4 stride-2 dot and conv1_2 four shifted 256x256 dots, which
// fill its 128-wide matrix unit; 7 in 16 of their multiply-adds are by the
// packing's structural zeros. Every nonzero product of the packed dots is
// one product of the literal 3x3 convs, so this kernel sums the literal
// products directly (1/1.78 of the packed operations) and gets the same
// sums up to their order. The four subpixel groups of a packed block are
// the four conv1_2 pixels under one pool window.
//
// What bounds it on Hopper: arithmetic. conv1_2 is 64x64x9 multiply-adds per
// full-resolution pixel (13.3 G per 601x601 frame); this first version runs
// them as float32 FMAs on the CUDA cores (tensor cores are later work). One
// block per 8x8 tile of pooled outputs stages the 20x20 input tile with its
// 2-pixel halo and conv1_1's weights, computes conv1_1's 18x18 output tile
// (1-pixel halo) into shared memory in the io type, then streams conv1_2's
// weights through the space the input tile used, 16 input channels at a
// time (the float32 weights, 144 KB, do not fit beside the tile). Each
// thread owns one pooled pixel x 8 output channels: it accumulates the four
// conv1_2 pixels under its pool window in registers, reuses each weight load
// 4 times and each activation load 8 times, and pools before one store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 64;                  // stem width (C1 = C2)
constexpr int kCinP = 16;               // input channels, padded
constexpr int kTP = 8;                  // pooled outputs per tile edge
constexpr int kTY = 2 * kTP + 2;        // conv1_1 tile edge (1-pixel halo)
constexpr int kTX = 2 * kTP + 4;        // input tile edge (2-pixel halo)
constexpr int kKC = 16;                 // conv1_2 input channels per slice
constexpr int kThreads = kTP * kTP * 8; // (pooled pixel, 8-channel group)

constexpr int kXElems = kTX * kTX * kCinP;
constexpr int kW1Elems = 9 * kCinP * kC;
constexpr int kW2Slice = 9 * kKC * kC;
// the staging region holds the input tile and conv1_1's weights, then one
// slice of conv1_2's weights at a time
constexpr int kStage = kXElems + kW1Elems;
static_assert(kStage >= kW2Slice, "a conv1_2 weight slice must fit");

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kYS = kC + 4;    // y pixel stride: 272 B
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void load8(const float* p, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ static void store8(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <>
struct Io<bf16> {
  static constexpr int kYS = kC + 8;    // y pixel stride: 144 B
  __device__ static float to_f(bf16 v) { return __bfloat162float(v); }
  __device__ static bf16 from_f(float v) { return __float2bfloat16_rn(v); }
  __device__ static float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void load8(const bf16* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static void store8(bf16* p, const float* f) {
    __align__(16) bf16 r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = __float2bfloat16_rn(f[k]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r);
  }
};

template <typename T>
constexpr int smem_bytes() {
  return (kStage + kTY * kTY * Io<T>::kYS) * (int)sizeof(T);
}

// 16-byte copy of n elements of T, global -> shared
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int n, int t) {
  const int units = n * (int)sizeof(T) / 16;
  for (int i = t; i < units; i += kThreads)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// x (B,H,W,Cin) T; w1 (3,3,kCinP,64) T HWIO, zero past Cin; w2 (3,3,64,64)
// T HWIO; b1, b2 (64,) float32; out (B,H/2,W/2,64) T.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    stem_s2d_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const float* __restrict__ b1, const T* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ out, int H,
                    int W, int Cin) {
  typedef Io<T> io;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  T* xs = stage;
  T* w1s = stage + kXElems;
  T* w2s = stage;
  T* ys = stage + kStage;

  const int Ho = H / 2, Wo = W / 2;
  const int n = blockIdx.z;
  const int py0 = blockIdx.y * kTP, px0 = blockIdx.x * kTP;
  const int t = threadIdx.x;
  const int co0 = (t & 7) * 8;
  const int gy0 = 2 * py0 - 2, gx0 = 2 * px0 - 2;  // input pixel at xs[0]

  copy16(w1s, w1, kW1Elems, t);
  // input tile; zero outside the image (conv1_1's SAME padding) and past Cin
  const T* xn = x + (size_t)n * H * W * Cin;
  for (int i = t; i < kXElems; i += kThreads) {
    const int c = i % kCinP, p = i / kCinP;
    const int gy = gy0 + p / kTX, gx = gx0 + p % kTX;
    T v = io::from_f(0.0f);
    if (c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xn[((size_t)gy * W + gx) * Cin + c];
    xs[i] = v;
  }
  __syncthreads();

  // y = relu(conv1_1 + b1) in float32, 0 outside the image (the edge mask),
  // rounded once to T; ys[0] is conv1_1 output pixel (gy0 + 1, gx0 + 1)
  for (int p = t >> 3; p < kTY * kTY; p += kThreads / 8) {
    const int yy = p / kTY, yx = p % kTY;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) {
        const T* xp = xs + ((yy + u) * kTX + (yx + v)) * kCinP;
        const T* wp = w1s + (u * 3 + v) * kCinP * kC + co0;
        for (int c = 0; c < Cin; ++c) {
          const float xv = io::to_f(xp[c]);
          float wv[8];
          io::load8(wp + c * kC, wv);
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
    io::store8(ys + p * io::kYS + co0, acc);
  }

  // conv1_2 for the 2x2 pixels under this thread's pool window, conv1_2's
  // weights streamed through the staging region kKC input channels a time
  const int pp = t >> 3;
  const int ppy = pp / kTP, ppx = pp % kTP;
  float acc[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[q][k] = 0.0f;
  for (int s = 0; s < kC / kKC; ++s) {
    __syncthreads();   // ys complete; the staging region is free
    for (int tap = 0; tap < 9; ++tap)
      copy16(w2s + tap * kKC * kC, w2 + (tap * kC + s * kKC) * kC, kKC * kC,
             t);
    __syncthreads();
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) {
        const T* yb =
            ys + ((2 * ppy + u) * kTY + (2 * ppx + v)) * io::kYS + s * kKC;
        const T* wb = w2s + (u * 3 + v) * kKC * kC + co0;
#pragma unroll 4
        for (int ci = 0; ci < kKC; ci += 2) {
          float wa[8], wc[8];
          io::load8(wb + ci * kC, wa);
          io::load8(wb + (ci + 1) * kC, wc);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 yv =
                io::load2(yb + ((q >> 1) * kTY + (q & 1)) * io::kYS + ci);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              acc[q][k] = fmaf(yv.x, wa[k], acc[q][k]);
              acc[q][k] = fmaf(yv.y, wc[k], acc[q][k]);
            }
          }
        }
      }
    }
  }
  // relu(z + b2) and the max over the four subpixels; rounding and the
  // bias add are monotone, so pooling the sums first gives the same bits
  const int py = py0 + ppy, px = px0 + ppx;
  if (py < Ho && px < Wo) {
    float r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float m = fmaxf(fmaxf(acc[0][k], acc[1][k]),
                            fmaxf(acc[2][k], acc[3][k]));
      r[k] = fmaxf(m + b2[co0 + k], 0.0f);
    }
    io::store8(out + (((size_t)n * Ho + py) * Wo + px) * kC + co0, r);
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int B, int H, int W, int Cin,
           void* stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      stem_s2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int Ho = H / 2, Wo = W / 2;
  dim3 grid((Wo + kTP - 1) / kTP, (Ho + kTP - 1) / kTP, B);
  stem_s2d_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (T*)out, H, W, Cin);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mv3d_stem_s2d_f32(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out,
                                 int B, int H, int W, int Cin, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, out, B, H, W, Cin, stream);
}

extern "C" int mv3d_stem_s2d_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, int Cin, void* stream) {
  return launch<bf16>(x, w1, b1, w2, b2, out, B, H, W, Cin, stream);
}
