// ROI max-pooling over an NHWC feature map, float32, bfloat16 and int8.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/roi_pool_pallas.py:roi_pool_pallas
// (pl.pallas_call at :321). It computes what roi_pool_np computes
// (mv3d_tf_tpu/ops/roi_pool.py:226-256): for each roi and each of the
// pooled x pooled bins, the per-channel max over the bin's
// [h0,h1) x [w0,w1) cells of the roi's frame; an empty bin gives 0, and a
// NaN in a bin gives NaN, as torch.maximum and jnp.max do. A max rounds
// nothing, so the output is bit-identical to ops/roi_pool.py:roi_pool.
//
// The kernel takes the (R,5) float32 rois and computes each bin's bounds
// and frame itself (csrc/roi_bin.cuh, the formula of
// ops/roi_pool.py:bin_bounds and _as_batch), so a call is one launch.
//
// What bounds it on Hopper: the latency of the bins' loads. Each bin reads
// its cells once, (bin area) x C x sizeof(T) bytes, mostly from L2 (a
// stride-8 map, 75x75x512 bf16 = 5.8 MB a frame, fits the 50 MB L2 and
// neighbouring rois overlap), and writes C values. A typical bin holds 1-9
// cells, so what sets the rate is how many bins are in flight on an SM and
// how many dependent load latencies each takes; a whole-map roi's bins
// hold ~120-180 cells. The design:
// - one block per (roi, bin), rois major, so the blocks of one roi (and of
//   one frame, as the detector orders its rois) run together and share L2
//   lines; the block computes its bin from the roi (csrc/roi_bin.cuh);
// - a block is kSlices slices of lanes; each slice covers the C channels,
//   16 bytes a lane (4 float32, 8 bf16 or 16 int8 channels; C = 512 is
//   128, 64 or 32 lanes), so a warp's load is 512 contiguous bytes;
// - the bin's cells are dealt to the slices in turn, and a lane issues
//   kUnroll independent loads before it reduces them: a bin of n cells
//   costs ceil(n / (kSlices * kUnroll)) load latencies, one for a typical
//   bin of up to 8 cells, ~16 for a whole BEV map's bins;
// - the slices' maxima meet in shared memory, and the first slice stores
//   16 bytes a lane, coalesced along C;
// - NaN-keeping maxima on whole words: max_of per float32, __hmax2_nan per
//   bf16 pair, __vmaxs4 per four int8 (exact; int8 stays int8).
// Two slices of four loads came out fastest on the H100 among 2-8 slices
// of 2-8 loads, and faster than giving each slice a bin of its own and
// splitting only the large bins: more lanes per bin cut the rounds but
// leave fewer bins in flight, and the whole-map bins' longer chains cost a
// launch a few percent (PERF.md, section 6).
// A channel count or a map that is not 16-byte aligned takes the same code
// one channel a lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "roi_bin.cuh"

namespace {

constexpr int kSlices = 2;   // slices of lanes per block, each covering C
constexpr int kUnroll = 4;   // cells a lane loads before it reduces them
constexpr int kMaxThreads = 512;

// a NaN wins and stays, as in torch.maximum (fmaxf would drop it)
__device__ __forceinline__ float max_of(float m, float v) {
  return (v != v || v > m) ? v : m;
}
__device__ __forceinline__ __nv_bfloat16 max_of(__nv_bfloat16 m,
                                                __nv_bfloat16 v) {
  return __hmax_nan(m, v);
}
__device__ __forceinline__ int8_t max_of(int8_t m, int8_t v) {
  return v > m ? v : m;
}

// One 32-bit word of a 16-byte pack: 1 float32, 2 bf16 or 4 int8 channels.
__device__ __forceinline__ uint32_t word_max(float, uint32_t m, uint32_t v) {
  return __float_as_uint(max_of(__uint_as_float(m), __uint_as_float(v)));
}
__device__ __forceinline__ uint32_t word_max(__nv_bfloat16, uint32_t m,
                                             uint32_t v) {
  __nv_bfloat162 r = __hmax2_nan(*reinterpret_cast<__nv_bfloat162*>(&m),
                                 *reinterpret_cast<__nv_bfloat162*>(&v));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t word_max(int8_t, uint32_t m, uint32_t v) {
  return __vmaxs4(m, v);
}

// P is the unit a lane loads: uint4 (16 bytes of T) or T itself.
template <typename T>
__device__ __forceinline__ uint4 pack_max(uint4 m, uint4 v) {
  return make_uint4(word_max(T(), m.x, v.x), word_max(T(), m.y, v.y),
                    word_max(T(), m.z, v.z), word_max(T(), m.w, v.w));
}
template <typename T>
__device__ __forceinline__ T pack_max(T m, T v) {
  return max_of(m, v);
}

// The max's start: -inf, or -128, in every channel.
template <typename T, typename P> __device__ __forceinline__ P lowest();
template <> __device__ __forceinline__ uint4 lowest<float, uint4>() {
  return make_uint4(0xff800000u, 0xff800000u, 0xff800000u, 0xff800000u);
}
template <> __device__ __forceinline__ uint4 lowest<__nv_bfloat16, uint4>() {
  return make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);
}
template <> __device__ __forceinline__ uint4 lowest<int8_t, uint4>() {
  return make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
}
template <> __device__ __forceinline__ float lowest<float, float>() {
  return -INFINITY;
}
template <>
__device__ __forceinline__ __nv_bfloat16 lowest<__nv_bfloat16,
                                                __nv_bfloat16>() {
  return __ushort_as_bfloat16(0xff80);
}
template <> __device__ __forceinline__ int8_t lowest<int8_t, int8_t>() {
  return -128;
}

// The max over cells first, first + step, ... < n of bin b, lane cv's
// pack; kUnroll loads in flight.
template <typename T, typename P>
__device__ __forceinline__ P bin_max(const P* __restrict__ f, const RoiBin& b,
                                     int W, int CV, int cv, int first, int n,
                                     int step) {
  P m = lowest<T, P>();
  for (int k0 = first; k0 < n; k0 += step * kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * step;
      v[u] = k < n ? f[bin_cell(b, k, W) * CV + cv] : lowest<T, P>();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = pack_max<T>(m, v[u]);
  }
  return m;
}

// One block per (roi, bin): blockIdx.x = roi * pooled^2 + ph * pooled + pw.
// A block is S = blockDim.x / L slices of L lanes; lane l of every slice
// covers the packs l, l + L, ... of a cell (CV = C / V packs of V
// channels), and slice s the cells s, s + S, ... of the bin.
template <typename T, typename P>
__global__ void __launch_bounds__(kMaxThreads)
    roi_pool_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                    T* __restrict__ out, int B, int H, int W, int C,
                    int pooled, float scale, int L) {
  extern __shared__ uint4 smem[];
  P* part = reinterpret_cast<P*>(smem);
  constexpr int V = sizeof(P) / sizeof(T);
  const RoiBin b = flat_bin(rois, blockIdx.x, pooled, scale, B, H, W);
  const int n = bin_cells(b);
  const int S = blockDim.x / L;
  const int slice = threadIdx.x / L, lane = threadIdx.x - slice * L;
  const int CV = C / V;
  const P* f = reinterpret_cast<const P*>(feat) + (size_t)b.frame * H * W * CV;
  P* o = reinterpret_cast<P*>(out) + (size_t)blockIdx.x * CV;
  for (int c0 = 0; c0 < CV; c0 += L) {   // once, unless CV > kMaxThreads
    const int cv = c0 + lane;
    P m = lowest<T, P>();
    if (cv < CV) m = bin_max<T, P>(f, b, W, CV, cv, slice, n, S);
    if (S > 1) {
      part[threadIdx.x] = m;
      __syncthreads();
      if (slice == 0) {
        for (int s = 1; s < S; ++s) m = pack_max<T>(m, part[s * L + lane]);
      }
      __syncthreads();
    }
    if (slice == 0 && cv < CV) o[cv] = n > 0 ? m : P{};
  }
}

template <typename T, typename P>
int launch_as(const void* feat, const float* rois, void* out, int B, int H,
              int W, int C, int R, int pooled, float scale,
              cudaStream_t stream) {
  constexpr int V = sizeof(P) / sizeof(T);
  const int CV = C / V;
  const int L = CV >= kMaxThreads ? kMaxThreads : ((CV + 31) / 32) * 32;
  const int S = kMaxThreads / L < kSlices ? kMaxThreads / L : kSlices;
  const int threads = S * L;
  const long long grid = (long long)R * pooled * pooled;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  roi_pool_kernel<T, P><<<(unsigned)grid, threads, threads * sizeof(P),
                          stream>>>((const T*)feat, rois, (T*)out, B, H, W,
                                    C, pooled, scale, L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* feat, const float* rois, void* out, int B, int H,
           int W, int C, int R, int pooled, float scale, void* stream) {
  const bool packed = C % (16 / sizeof(T)) == 0 &&
                      (uintptr_t)feat % 16 == 0 && (uintptr_t)out % 16 == 0;
  return packed ? launch_as<T, uint4>(feat, rois, out, B, H, W, C, R, pooled,
                                      scale, (cudaStream_t)stream)
                : launch_as<T, T>(feat, rois, out, B, H, W, C, R, pooled,
                                  scale, (cudaStream_t)stream);
}

}  // namespace

extern "C" int mv3d_roi_pool_f32(const void* feat, const float* rois,
                                 void* out, int B, int H, int W, int C, int R,
                                 int pooled, float scale, void* stream) {
  return launch<float>(feat, rois, out, B, H, W, C, R, pooled, scale, stream);
}

extern "C" int mv3d_roi_pool_bf16(const void* feat, const float* rois,
                                  void* out, int B, int H, int W, int C,
                                  int R, int pooled, float scale,
                                  void* stream) {
  return launch<__nv_bfloat16>(feat, rois, out, B, H, W, C, R, pooled, scale,
                               stream);
}

extern "C" int mv3d_roi_pool_s8(const void* feat, const float* rois,
                                void* out, int B, int H, int W, int C, int R,
                                int pooled, float scale, void* stream) {
  return launch<int8_t>(feat, rois, out, B, H, W, C, R, pooled, scale, stream);
}
