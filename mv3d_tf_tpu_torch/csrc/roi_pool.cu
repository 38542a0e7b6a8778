// ROI max-pooling over an NHWC feature map, float32 and bfloat16.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/roi_pool_pallas.py:roi_pool_pallas
// (pl.pallas_call at :321). It computes what roi_pool_np computes
// (mv3d_tf_tpu/ops/roi_pool.py:226-256): for each roi and each of the
// pooled x pooled bins, the per-channel max over the bin's
// [h0,h1) x [w0,w1) cells of the roi's frame; an empty bin gives 0.
//
// The bin bounds are NOT computed here: the Python wrapper computes them
// once, in exact integer arithmetic, with the same helper the plain
// PyTorch version uses (ops/roi_pool.py:bin_bounds), and passes them as an
// (R, 4, pooled) int32 array [hstart, hend, wstart, wend]. The kernel only
// takes maxima, so its output is bit-identical to the plain version; a NaN
// in a bin gives NaN, as torch.maximum and jnp.max do.
//
// What bounds it on Hopper: bytes. It does no arithmetic besides the max;
// each bin reads its cells once, (bin area) x C x sizeof(T) bytes, mostly
// from L2, since a stride-8 map (75x75x512 f32 = 11.5 MB) fits the 50 MB L2
// and neighbouring rois overlap. The design answers that with coalesced
// reads: one block per (roi, pooled row), threads across channels, so a
// warp reads 32 consecutive channels of one cell. The TPU kernel's SMEM roi
// chunking, column-window globals and int32 widening have no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// exact: v is the max of bf16 values, or 0
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void roi_pool_kernel(const T* __restrict__ feat,
                                const int* __restrict__ bounds,
                                const int* __restrict__ frame,
                                T* __restrict__ out, int H, int W, int C,
                                int pooled) {
  const int r = blockIdx.x;
  const int ph = blockIdx.y;
  const int* bd = bounds + (size_t)r * 4 * pooled;
  const int h0 = bd[ph];
  const int h1 = bd[pooled + ph];
  const T* f = feat + (size_t)frame[r] * H * W * C;
  T* o = out + ((size_t)r * pooled + ph) * pooled * C;
  for (int pw = 0; pw < pooled; ++pw) {
    const int w0 = bd[2 * pooled + pw];
    const int w1 = bd[3 * pooled + pw];
    const bool empty = h1 <= h0 || w1 <= w0;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float m = -INFINITY;
      for (int h = h0; h < h1; ++h) {
        const T* row = f + (size_t)h * W * C + c;
        for (int w = w0; w < w1; ++w) {
          // a NaN wins and stays, as in torch.maximum (fmaxf would drop it)
          const float v = to_f32(row[(size_t)w * C]);
          m = (v != v || v > m) ? v : m;
        }
      }
      o[(size_t)pw * C + c] = from_f32<T>(empty ? 0.0f : m);
    }
  }
}

template <typename T>
int launch(const void* feat, const int* bounds, const int* frame, void* out,
           int H, int W, int C, int R, int pooled, void* stream) {
  const int threads = C < 128 ? ((C + 31) / 32) * 32 : 128;
  dim3 grid(R, pooled);
  roi_pool_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)feat, bounds, frame, (T*)out, H, W, C, pooled);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mv3d_roi_pool_f32(const void* feat, const int* bounds,
                                 const int* frame, void* out, int H, int W,
                                 int C, int R, int pooled, void* stream) {
  return launch<float>(feat, bounds, frame, out, H, W, C, R, pooled, stream);
}

extern "C" int mv3d_roi_pool_bf16(const void* feat, const int* bounds,
                                  const int* frame, void* out, int H, int W,
                                  int C, int R, int pooled, void* stream) {
  return launch<__nv_bfloat16>(feat, bounds, frame, out, H, W, C, R, pooled,
                               stream);
}
