// Multi-level RoIAlign over an NHWC feature pyramid, float32 and bfloat16:
// Detectron2's ROIAlignV2 (aligned=True, sampling ratio 0) under its FPN
// ROIPooler, in one launch for all rois of a call.
//
// No TPU kernel stands behind it: the JAX package has no bilinear pooler.
// It computes what ops/roi_align.py:roi_align computes. Per roi:
// - its level k = clamp(4 + floor(log2(sqrt(area) / 224 + 1e-8)), k_min,
//   k_min + levels - 1), area = (x2 - x1)(y2 - y1), floor(log2(s)) taken as
//   the float32 s's binary exponent (frexpf), exact; the level is written
//   to level_out;
// - the roi scaled by 2^-k and shifted by -0.5; bins of roi_h / P, each the
//   mean of ceil(roi_h / P) x ceil(roi_w / P) bilinear samples at the
//   sub-bin centres; a sample outside [-1, H] x [-1, W] gives 0, one inside
//   is clamped to the map.
// Every float operation is an explicit round-to-nearest intrinsic in the
// plain version's order, so nvcc contracts nothing into an FMA, the sums
// are float32 in the samples' order, and the mean is rounded to T once:
// the output is bit-identical to the plain version's.
//
// What bounds it on Hopper: the loads of the four corners of each sample.
// The pyramid's P2-P5 at 800x1088 (256 channels, bf16) is 37 MB and stays
// in the 50 MB L2; the pooled output (1000 x 7 x 7 x 256 bf16, 25 MB) is
// written once. The design:
// - one block per (roi, bin row): the roi's level, scale and grid are
//   computed once per thread from the (R, 5) rois, no host work;
// - a thread covers 4 channels of one bin of the row (8 bytes of bf16, 16
//   of float32): a warp reads 128 contiguous channels of each corner, and
//   the row's P bins x C / 4 packs are the block's threads (448 at 7x7 and
//   256 channels, 896 at 14x14), so most blocks loop no further;
// - the y terms of a sample are shared by every thread of the row, the x
//   terms by the threads of a bin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxThreads = 1024;

struct Pyramid {
  const void* map[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int levels;
  int k_min;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// acc + (((w1 v1 + w2 v2) + w3 v3) + w4 v4), each op rounded on its own
__device__ __forceinline__ float blend(float acc, float w1, float v1, float w2,
                                       float v2, float w3, float v3, float w4,
                                       float v4) {
  const float val = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(w1, v1), __fmul_rn(w2, v2)),
                __fmul_rn(w3, v3)),
      __fmul_rn(w4, v4));
  return __fadd_rn(acc, val);
}

// One axis of a sample: the low and high cell and the weights (l, h), the
// coordinate clamped at 0 and at the last cell.
struct Axis {
  int lo, hi;
  float l, h;
};
__device__ __forceinline__ Axis axis(float v, int size) {
  Axis a;
  v = v <= 0.f ? 0.f : v;
  a.lo = (int)v;
  if (a.lo >= size - 1) {
    a.lo = a.hi = size - 1;
    v = (float)a.lo;
  } else {
    a.hi = a.lo + 1;
  }
  a.l = __fsub_rn(v, (float)a.lo);
  a.h = __fsub_rn(1.f, a.l);
  return a;
}

__device__ __forceinline__ int roi_level(const float* r, int k_min,
                                         int k_max) {
  const float area = __fmul_rn(__fsub_rn(r[3], r[1]), __fsub_rn(r[4], r[2]));
  const float s = __fadd_rn(__fdiv_rn(__fsqrt_rn(area), 224.f), 1e-8f);
  int e;
  frexpf(s, &e);                    // s = m 2^e, m in [0.5, 1)
  const int k = 4 + (e - 1);
  return k < k_min ? k_min : (k > k_max ? k_max : k);
}

// blockIdx.x = roi * P + ph; thread t covers bin pw = t / C4 of the row and
// channels 4 (t % C4) .. + 3, C4 = C / 4.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_kernel(Pyramid pyr, const float* __restrict__ rois,
                     T* __restrict__ out, int* __restrict__ level_out, int C,
                     int P) {
  const int roi = blockIdx.x / P, ph = blockIdx.x - roi * P;
  const float* r = rois + (size_t)roi * 5;
  const int k = roi_level(r, pyr.k_min, pyr.k_min + pyr.levels - 1);
  const int li = k - pyr.k_min;
  if (ph == 0 && threadIdx.x == 0 && level_out) level_out[roi] = k;
  const int H = pyr.h[li], W = pyr.w[li];
  const float scale = ldexpf(1.f, -k);
  const float x0 = __fsub_rn(__fmul_rn(r[1], scale), 0.5f);
  const float y0 = __fsub_rn(__fmul_rn(r[2], scale), 0.5f);
  const float roi_w = __fsub_rn(__fsub_rn(__fmul_rn(r[3], scale), 0.5f), x0);
  const float roi_h = __fsub_rn(__fsub_rn(__fmul_rn(r[4], scale), 0.5f), y0);
  const float bin_w = __fdiv_rn(roi_w, (float)P);
  const float bin_h = __fdiv_rn(roi_h, (float)P);
  const int gw = (int)ceilf(bin_w), gh = (int)ceilf(bin_h);
  const float count = (float)max(gh * gw, 1);
  const float gwf = (float)gw, ghf = (float)gh;
  const float ys = __fadd_rn(y0, __fmul_rn((float)ph, bin_h));
  const T* f = reinterpret_cast<const T*>(pyr.map[li]) +
               (size_t)(int)r[0] * H * W * C;
  const int C4 = C / 4;
  T* o = out + ((size_t)roi * P + ph) * P * C;
  for (int t = threadIdx.x; t < P * C4; t += blockDim.x) {
    const int pw = t / C4, c = (t - pw * C4) * 4;
    const float xs = __fadd_rn(x0, __fmul_rn((float)pw, bin_w));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int iy = 0; iy < gh; ++iy) {
      const float y = __fadd_rn(
          ys, __fdiv_rn(__fmul_rn((float)iy + 0.5f, bin_h), ghf));
      if (y < -1.f || y > (float)H) continue;
      const Axis ay = axis(y, H);
      const T* row_lo = f + (size_t)ay.lo * W * C + c;
      const T* row_hi = f + (size_t)ay.hi * W * C + c;
      for (int ix = 0; ix < gw; ++ix) {
        const float x = __fadd_rn(
            xs, __fdiv_rn(__fmul_rn((float)ix + 0.5f, bin_w), gwf));
        if (x < -1.f || x > (float)W) continue;
        const Axis ax = axis(x, W);
        const float w1 = __fmul_rn(ay.h, ax.h), w2 = __fmul_rn(ay.h, ax.l);
        const float w3 = __fmul_rn(ay.l, ax.h), w4 = __fmul_rn(ay.l, ax.l);
        const float4 v1 = load4(row_lo + (size_t)ax.lo * C);
        const float4 v2 = load4(row_lo + (size_t)ax.hi * C);
        const float4 v3 = load4(row_hi + (size_t)ax.lo * C);
        const float4 v4 = load4(row_hi + (size_t)ax.hi * C);
        acc.x = blend(acc.x, w1, v1.x, w2, v2.x, w3, v3.x, w4, v4.x);
        acc.y = blend(acc.y, w1, v1.y, w2, v2.y, w3, v3.y, w4, v4.y);
        acc.z = blend(acc.z, w1, v1.z, w2, v2.z, w3, v3.z, w4, v4.z);
        acc.w = blend(acc.w, w1, v1.w, w2, v2.w, w3, v3.w, w4, v4.w);
      }
    }
    store4(o + (size_t)pw * C + c,
           make_float4(__fdiv_rn(acc.x, count), __fdiv_rn(acc.y, count),
                       __fdiv_rn(acc.z, count), __fdiv_rn(acc.w, count)));
  }
}

template <typename T>
int launch(const void* const* maps, const int* hw, int levels, int k_min,
           int C, const float* rois, int R, int pooled, void* out,
           int* level_out, void* stream) {
  if (levels < 1 || levels > kMaxLevels || C % 4 != 0 || pooled < 1)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr;
  for (int i = 0; i < kMaxLevels; ++i) {
    pyr.map[i] = i < levels ? maps[i] : nullptr;
    pyr.h[i] = i < levels ? hw[2 * i] : 0;
    pyr.w[i] = i < levels ? hw[2 * i + 1] : 0;
  }
  pyr.levels = levels;
  pyr.k_min = k_min;
  const int work = pooled * (C / 4);
  const int threads =
      work >= kMaxThreads ? kMaxThreads : ((work + 31) / 32) * 32;
  const long long grid = (long long)R * pooled;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  roi_align_kernel<T><<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      pyr, rois, (T*)out, level_out, C, pooled);
  return (int)cudaGetLastError();
}

}  // namespace

// maps: the levels' (B, H_l, W_l, C) NHWC maps, level k_min + l at stride
// 2^(k_min + l); hw: H_0, W_0, H_1, W_1, ... on the host; rois (R, 5)
// float32 [frame, x1, y1, x2, y2]; out (R, P, P, C) in the maps' dtype;
// level_out (R,) int32, the level each roi was pooled from.
extern "C" int mv3d_roi_align_f32(const void* m0, const void* m1,
                                  const void* m2, const void* m3,
                                  const int* hw, int levels, int k_min, int C,
                                  const float* rois, int R, int pooled,
                                  void* out, int* level_out, void* stream) {
  const void* maps[kMaxLevels] = {m0, m1, m2, m3};
  return launch<float>(maps, hw, levels, k_min, C, rois, R, pooled, out,
                       level_out, stream);
}

extern "C" int mv3d_roi_align_bf16(const void* m0, const void* m1,
                                   const void* m2, const void* m3,
                                   const int* hw, int levels, int k_min,
                                   int C, const float* rois, int R,
                                   int pooled, void* out, int* level_out,
                                   void* stream) {
  const void* maps[kMaxLevels] = {m0, m1, m2, m3};
  return launch<__nv_bfloat16>(maps, hw, levels, k_min, C, rois, R, pooled,
                               out, level_out, stream);
}
