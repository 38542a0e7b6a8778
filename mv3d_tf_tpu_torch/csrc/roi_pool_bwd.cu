// Gradient of ROI max-pooling w.r.t. a single-frame NHWC feature map, with
// float32 or bfloat16 features and float32 dy and dfeat.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/roi_pool_pallas.py:
// roi_pool_pallas_bwd (pl.pallas_call at :461). It computes what that kernel
// computes: an equality replay of the forward max. For roi r, bin (ph,pw)
// and channel c, the cells of [h0,h1) x [w0,w1) whose value equals
// out[r,ph,pw,c] (both read as float32) are counted, and each such cell gets
// dy[r,ph,pw,c] * (1 / count): ties split dy evenly, as the TPU kernel does
// (:431-433, a multiply by the reciprocal, not a division). Overlapping bins
// and rois add; an empty bin gives nothing; dfeat starts at 0 (the wrapper
// allocates it with torch.zeros). The bin bounds come from the wrapper, from
// the same integer-exact helper the forward and the plain versions use
// (ops/roi_pool.py:bin_bounds), so the tie count is exact.
//
// NaN: a NaN max equals no cell, so its bin gives no gradient, and a NaN
// cell never ties. (The TPU kernel builds its indicator as
// 1 - sign(|x - max|), which turns a whole window NaN instead.)
//
// What bounds it on Hopper: bytes. Per bin it reads the bin's cells twice
// (count, then spread) and makes one f32 atomicAdd per tying cell into
// dfeat; a stride-8 map (75x75x512 f32 = 11.5 MB) and its dfeat fit the
// 50 MB L2 together, so the scattered atomics resolve in L2. The design
// answers that with coalescing: one block per (roi, pooled row), threads
// across channels, so a warp reads and adds 32 consecutive channels of one
// cell. The count stays in a register; there is no shared memory. The TPU
// kernel's VMEM-resident dfeat block, its roi steps, window globals and
// f32 indicator arithmetic (a Mosaic workaround) have no counterpart.
//
// The order of the atomics changes from run to run, so dfeat equals the
// plain version within f32 rounding of the sums (the smoke run holds it to
// 1e-5 * max|dfeat| + 1e-7), not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void roi_pool_bwd_kernel(const T* __restrict__ feat,
                                    const int* __restrict__ bounds,
                                    const T* __restrict__ out,
                                    const float* __restrict__ dy,
                                    float* __restrict__ dfeat, int W, int C,
                                    int pooled) {
  const int r = blockIdx.x;
  const int ph = blockIdx.y;
  const int* bd = bounds + (size_t)r * 4 * pooled;
  const int h0 = bd[ph];
  const int h1 = bd[pooled + ph];
  const size_t row = ((size_t)r * pooled + ph) * pooled;
  for (int pw = 0; pw < pooled; ++pw) {
    const int w0 = bd[2 * pooled + pw];
    const int w1 = bd[3 * pooled + pw];
    if (h1 <= h0 || w1 <= w0) continue;  // empty bin: no cell, no gradient
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const size_t o_idx = (row + pw) * C + c;
      const float m = to_f32(out[o_idx]);
      int cnt = 0;  // pass 1: cells tying the max
      for (int h = h0; h < h1; ++h) {
        for (int w = w0; w < w1; ++w) {
          cnt += to_f32(feat[((size_t)h * W + w) * C + c]) == m;
        }
      }
      if (cnt == 0) continue;  // a NaN max ties nothing
      const float share = dy[o_idx] * (1.0f / (float)cnt);
      for (int h = h0; h < h1; ++h) {  // pass 2: spread the share
        for (int w = w0; w < w1; ++w) {
          const size_t i = ((size_t)h * W + w) * C + c;
          if (to_f32(feat[i]) == m) atomicAdd(dfeat + i, share);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* feat, const int* bounds, const void* out,
           const float* dy, float* dfeat, int W, int C, int R, int pooled,
           void* stream) {
  const int threads = C < 128 ? ((C + 31) / 32) * 32 : 128;
  dim3 grid(R, pooled);
  roi_pool_bwd_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)feat, bounds, (const T*)out, dy, dfeat, W, C, pooled);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mv3d_roi_pool_bwd_f32(const void* feat, const int* bounds,
                                     const void* out, const float* dy,
                                     float* dfeat, int W, int C, int R,
                                     int pooled, void* stream) {
  return launch<float>(feat, bounds, out, dy, dfeat, W, C, R, pooled, stream);
}

extern "C" int mv3d_roi_pool_bwd_bf16(const void* feat, const int* bounds,
                                      const void* out, const float* dy,
                                      float* dfeat, int W, int C, int R,
                                      int pooled, void* stream) {
  return launch<__nv_bfloat16>(feat, bounds, out, dy, dfeat, W, C, R, pooled,
                               stream);
}
