// ROI max-pooling over an NHWC feature map, float32, bfloat16 and int8.
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
// chunking, column-window globals and int32 widening have no counterpart:
// int8 maps (the int8 detector's trunk outputs) are reduced in int8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Each type's running max: float for float32 and bfloat16 (exact, a max
// rounds nothing), int8 for int8.
template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int8_t; };

__device__ __forceinline__ float load(float v) { return v; }
__device__ __forceinline__ float load(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int8_t load(int8_t v) { return v; }

__device__ __forceinline__ float lowest(float) { return -INFINITY; }
__device__ __forceinline__ int8_t lowest(int8_t) { return -128; }

// a NaN wins and stays, as in torch.maximum (fmaxf would drop it)
__device__ __forceinline__ float max_of(float m, float v) {
  return (v != v || v > m) ? v : m;
}
__device__ __forceinline__ int8_t max_of(int8_t m, int8_t v) {
  return v > m ? v : m;
}

template <typename T> __device__ __forceinline__ T store(float v);
template <> __device__ __forceinline__ float store<float>(float v) {
  return v;
}
// exact: v is the max of bf16 values, or 0
template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ T store(int8_t v) {
  return v;
}

template <typename T>
__global__ void roi_pool_kernel(const T* __restrict__ feat,
                                const int* __restrict__ bounds,
                                const int* __restrict__ frame,
                                T* __restrict__ out, int H, int W, int C,
                                int pooled) {
  using A = typename Acc<T>::type;
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
      A m = lowest(A());
      for (int h = h0; h < h1; ++h) {
        const T* row = f + (size_t)h * W * C + c;
        for (int w = w0; w < w1; ++w) m = max_of(m, load(row[(size_t)w * C]));
      }
      o[(size_t)pw * C + c] = store<T>(empty ? A(0) : m);
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

extern "C" int mv3d_roi_pool_s8(const void* feat, const int* bounds,
                                const int* frame, void* out, int H, int W,
                                int C, int R, int pooled, void* stream) {
  return launch<int8_t>(feat, bounds, frame, out, H, W, C, R, pooled, stream);
}
