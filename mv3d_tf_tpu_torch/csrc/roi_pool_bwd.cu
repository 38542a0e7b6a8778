// Gradient of ROI max-pooling w.r.t. an NHWC feature map of B frames
// (B = 1 for a single frame), with float32 or bfloat16 features and float32
// dy and dfeat. A roi's frame is its column 0, truncated and clamped to
// [0, B-1] (csrc/roi_bin.cuh, as in the forward); rois of every frame may
// come in one call, in any order.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/roi_pool_pallas.py:
// roi_pool_pallas_bwd (pl.pallas_call at :461). It computes what that kernel
// computes: an equality replay of the forward max. For roi r, bin (ph,pw)
// and channel c, the cells of [h0,h1) x [w0,w1) whose value equals
// out[r,ph,pw,c] (both read as float32) are counted, and each such cell gets
// dy[r,ph,pw,c] * (1 / count): ties split dy evenly, as the TPU kernel does
// (:431-433, a multiply by the reciprocal, not a division). Overlapping bins
// and rois add; an empty bin gives nothing; dfeat starts at 0 (the wrapper
// allocates it with torch.zeros). The kernel computes each bin's bounds
// from the (R,5) float32 rois itself (csrc/roi_bin.cuh, the formula of
// ops/roi_pool.py:bin_bounds), so the tie count is exact and a call is one
// launch.
//
// NaN: a NaN max equals no cell, so its bin gives no gradient, and a NaN
// cell never ties. (The TPU kernel builds its indicator as
// 1 - sign(|x - max|), which turns a whole window NaN instead.)
//
// What bounds it on Hopper: the latency of the bins' loads, as in the
// forward (csrc/roi_pool.cu): each bin reads its cells twice (count, then
// spread), mostly from L2 (a 75x75x512 f32 map and its dfeat fit the 50 MB
// L2 together, so the atomics resolve there too). The design is the
// forward's:
// - one block per (roi, bin), of kSlices slices of lanes; a lane covers 16
//   bytes of feat (4 float32 or 8 bf16 channels), the bin's cells are dealt
//   to the slices in turn, kUnroll independent loads a lane at a time;
// - the tie counts stay in registers; the slices sum them in shared memory
//   before the spread, so every slice spreads with the bin's whole count;
// - the spread adds 4 channels per atomic (sm_90's atomicAdd on float4 in
//   global memory), and only where one of them ties.
// A channel count or a tensor that is not 16-byte aligned takes the same
// code one channel a lane, with scalar atomics.
//
// The order of the atomics changes from run to run, so dfeat equals the
// plain version within f32 rounding of the sums (the smoke run holds it to
// 1e-5 * max|dfeat| + 1e-7), not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_bin.cuh"

namespace {

constexpr int kSlices = 2;   // slices of lanes per block, each covering C
constexpr int kUnroll = 4;   // cells a lane loads before it compares them
constexpr int kMaxThreads = 512;

// P, the unit a lane loads, as float32 channels: uint4 (16 bytes of T) or
// T itself.
__device__ __forceinline__ void to_f32(float, float p, float* x) { x[0] = p; }
__device__ __forceinline__ void to_f32(__nv_bfloat16, __nv_bfloat16 p,
                                       float* x) {
  x[0] = __bfloat162float(p);
}
__device__ __forceinline__ void to_f32(float, uint4 p, float* x) {
  x[0] = __uint_as_float(p.x);
  x[1] = __uint_as_float(p.y);
  x[2] = __uint_as_float(p.z);
  x[3] = __uint_as_float(p.w);
}
__device__ __forceinline__ void to_f32(__nv_bfloat16, uint4 p, float* x) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// V float32 values at p: float4 loads when V is a multiple of 4.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* x) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      x[i] = q.x;
      x[i + 1] = q.y;
      x[i + 2] = q.z;
      x[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = p[i];
  }
}

// dfeat[p + i] += share[i] where hit[i]: one float4 atomic per 4 channels
// that hold a hit (a channel without one adds +0, which changes nothing).
template <int V>
__device__ __forceinline__ void add_f32(float* p, const float* share,
                                        const bool* hit) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      if (hit[i] || hit[i + 1] || hit[i + 2] || hit[i + 3]) {
        atomicAdd(reinterpret_cast<float4*>(p + i),
                  make_float4(hit[i] ? share[i] : 0.0f,
                              hit[i + 1] ? share[i + 1] : 0.0f,
                              hit[i + 2] ? share[i + 2] : 0.0f,
                              hit[i + 3] ? share[i + 3] : 0.0f));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (hit[i]) atomicAdd(p + i, share[i]);
    }
  }
}

// Adds to cnt the cells first, first + step, ... < n of bin b that tie the
// max m in lane cv's pack; kUnroll loads in flight.
template <typename T, typename P>
__device__ __forceinline__ void bin_count(const P* __restrict__ f,
                                          const RoiBin& b, int W, int CV,
                                          int cv, int first, int n, int step,
                                          const float* m, int* cnt) {
  constexpr int V = sizeof(P) / sizeof(T);
  for (int k0 = first; k0 < n; k0 += step * kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * step;
      if (k < n) v[u] = f[bin_cell(b, k, W) * CV + cv];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u * step < n) {
        float x[V];
        to_f32(T(), v[u], x);
#pragma unroll
        for (int i = 0; i < V; ++i) cnt[i] += x[i] == m[i];
      }
    }
  }
}

// share[i] = dy[i] * (1 / cnt[i]), 0 where nothing ties (a NaN max);
// returns whether anything ties.
template <int V>
__device__ __forceinline__ bool shares(const float* dy, const int* cnt,
                                       float* share) {
  load_f32<V>(dy, share);
  bool any = false;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    share[i] = cnt[i] ? share[i] * (1.0f / (float)cnt[i]) : 0.0f;
    any |= cnt[i] != 0;
  }
  return any;
}

// Adds share to dfeat at the cells first, first + step, ... < n of bin b
// that tie m, in lane cv's channels.
template <typename T, typename P>
__device__ __forceinline__ void bin_spread(const P* __restrict__ f,
                                           float* __restrict__ dfeat,
                                           const RoiBin& b, int W, int CV,
                                           int cv, int first, int n, int step,
                                           const float* m,
                                           const float* share) {
  constexpr int V = sizeof(P) / sizeof(T);
  for (int k0 = first; k0 < n; k0 += step * kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * step;
      if (k < n) v[u] = f[bin_cell(b, k, W) * CV + cv];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * step;
      if (k < n) {
        float x[V];
        bool hit[V];
        to_f32(T(), v[u], x);
#pragma unroll
        for (int i = 0; i < V; ++i) hit[i] = x[i] == m[i];
        add_f32<V>(dfeat + (bin_cell(b, k, W) * CV + cv) * V, share, hit);
      }
    }
  }
}

// One block per (roi, bin): blockIdx.x = roi * pooled^2 + ph * pooled + pw.
// A block is S = blockDim.x / L slices of L lanes; lane l of every slice
// covers the packs l, l + L, ... of a cell (CV = C / V packs of V
// channels), and slice s the cells s, s + S, ... of the bin.
template <typename T, typename P>
__global__ void __launch_bounds__(kMaxThreads)
    roi_pool_bwd_kernel(const T* __restrict__ feat,
                        const float* __restrict__ rois,
                        const T* __restrict__ out,
                        const float* __restrict__ dy,
                        float* __restrict__ dfeat, int B, int H, int W,
                        int C, int pooled, float scale, int L) {
  constexpr int V = sizeof(P) / sizeof(T);
  extern __shared__ int part[];   // [thread][V] tie counts
  const RoiBin b = flat_bin(rois, blockIdx.x, pooled, scale, B, H, W);
  const int n = bin_cells(b);
  if (n == 0) return;   // an empty bin: no cell, no gradient
  const int S = blockDim.x / L;
  const int slice = threadIdx.x / L, lane = threadIdx.x - slice * L;
  const int CV = C / V;
  const size_t frame = (size_t)b.frame * H * W;   // the frame's first cell
  const P* f = reinterpret_cast<const P*>(feat) + frame * CV;
  dfeat += frame * C;
  for (int c0 = 0; c0 < CV; c0 += L) {   // once, unless CV > kMaxThreads
    const int cv = c0 + lane;
    const bool on = cv < CV;
    const size_t idx = blockIdx.x * (size_t)CV + cv;   // out's and dy's pack
    float m[V], share[V];
    int cnt[V];
#pragma unroll
    for (int i = 0; i < V; ++i) cnt[i] = 0;
    if (on) {
      to_f32(T(), reinterpret_cast<const P*>(out)[idx], m);
      bin_count<T, P>(f, b, W, CV, cv, slice, n, S, m, cnt);
    }
    if (S > 1) {   // every slice spreads with the bin's whole count
#pragma unroll
      for (int i = 0; i < V; ++i) part[threadIdx.x * V + i] = cnt[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < V; ++i) cnt[i] = 0;
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int i = 0; i < V; ++i) cnt[i] += part[(s * L + lane) * V + i];
      }
      __syncthreads();
    }
    if (on && shares<V>(dy + idx * V, cnt, share)) {
      bin_spread<T, P>(f, dfeat, b, W, CV, cv, slice, n, S, m, share);
    }
  }
}

template <typename T, typename P>
int launch_as(const void* feat, const float* rois, const void* out,
              const float* dy, float* dfeat, int B, int H, int W, int C,
              int R,
              int pooled, float scale, cudaStream_t stream) {
  constexpr int V = sizeof(P) / sizeof(T);
  const int CV = C / V;
  const int L = CV >= kMaxThreads ? kMaxThreads : ((CV + 31) / 32) * 32;
  const int S = kMaxThreads / L < kSlices ? kMaxThreads / L : kSlices;
  const int threads = S * L;
  const long long grid = (long long)R * pooled * pooled;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  roi_pool_bwd_kernel<T, P><<<(unsigned)grid, threads,
                              threads * V * sizeof(int), stream>>>(
      (const T*)feat, rois, (const T*)out, dy, dfeat, B, H, W, C, pooled,
      scale, L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* feat, const float* rois, const void* out,
           const float* dy, float* dfeat, int B, int H, int W, int C, int R,
           int pooled, float scale, void* stream) {
  const bool packed = C % (16 / sizeof(T)) == 0 &&
                      ((uintptr_t)feat | (uintptr_t)out | (uintptr_t)dy |
                       (uintptr_t)dfeat) % 16 == 0;
  return packed ? launch_as<T, uint4>(feat, rois, out, dy, dfeat, B, H, W, C,
                                      R, pooled, scale, (cudaStream_t)stream)
                : launch_as<T, T>(feat, rois, out, dy, dfeat, B, H, W, C, R,
                                  pooled, scale, (cudaStream_t)stream);
}

}  // namespace

extern "C" int mv3d_roi_pool_bwd_f32(const void* feat, const float* rois,
                                     const void* out, const float* dy,
                                     float* dfeat, int B, int H, int W, int C,
                                     int R, int pooled, float scale,
                                     void* stream) {
  return launch<float>(feat, rois, out, dy, dfeat, B, H, W, C, R, pooled,
                       scale, stream);
}

extern "C" int mv3d_roi_pool_bwd_bf16(const void* feat, const float* rois,
                                      const void* out, const float* dy,
                                      float* dfeat, int B, int H, int W,
                                      int C, int R, int pooled, float scale,
                                      void* stream) {
  return launch<__nv_bfloat16>(feat, rois, out, dy, dfeat, B, H, W, C, R,
                               pooled, scale, stream);
}
