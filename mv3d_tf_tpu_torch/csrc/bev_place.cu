// BEV placement: the sorted last-write-wins winners into the
// (B, 601, 601, 9) float32 raster.
//
// Replaces the TPU kernel mv3d_tf_tpu/ops/bev_pallas.py:bev_place_pallas
// (pl.pallas_call at :133). The input is what the stable sort of
// mv3d_tf_tpu_torch/ops/bev.py gives, per scan: seg (N,) int32 slots
// cell*9 + slice in ascending order (a dead point at a value >= n_flat),
// with zs (z - HEIGHT_MIN) and rs (reflectance) in the same order. The sort
// kept file order within a run of equal slots, so:
//   * the height winner of a (cell, slice) is the last entry of its run:
//     it stores out[seg] = zs;
//   * the intensity winner of a cell is the last entry of the cell's run
//     (slices ascend within a cell): it stores out[cell*9 + 8] = rs.
// Each winner owns its output element, so plain stores suffice: no atomics,
// and the result equals the plain version (ops/bev_cuda.py:bev_place_plain)
// bit for bit.
//
// What bounds it on Hopper: bytes. It does no arithmetic; it reads 12 bytes
// a point and writes the raster, 13 MB a scan, most of it the zeroing
// (cudaMemsetAsync on the caller's stream, counted as the kernel's time).
// One thread per sorted point, grid-stride: neighbouring threads read
// neighbouring entries, and a winner's store lands near the previous
// winner's, since the slots ascend. The TPU kernel's searchsorted row
// bounds, (48, 128) row stripes, NO_REM sentinel, one-hot MXU matmul and
// transpose onto sublanes have no counterpart: they exist because a TPU
// cannot scatter. Offsets are 64-bit: B x 3.25M elements passes 2^31 at
// B >= 661.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bev_place_kernel(const int* __restrict__ seg,
                                 const float* __restrict__ zs,
                                 const float* __restrict__ rs,
                                 float* __restrict__ out, int64_t total,
                                 int64_t n, int n_flat, int channels) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int s = seg[i];
    if (s < 0 || s >= n_flat) continue;  // dead: no slot
    const int64_t b = i / n;
    const bool last = (i - b * n) == n - 1;  // the scan's last entry
    const int next = last ? 0 : seg[i + 1];
    const int cell = s / channels;
    float* o = out + b * n_flat;
    if (last || next != s) o[s] = zs[i];
    if (last || next / channels != cell) {
      o[(int64_t)cell * channels + channels - 1] = rs[i];
    }
  }
}

}  // namespace

extern "C" int mv3d_bev_place_f32(const int* seg, const float* zs,
                                  const float* rs, float* out, int64_t B,
                                  int64_t n, int n_flat, int channels,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)B * n_flat * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = B * n;
  if (total > 0) {
    const int threads = 256;
    const int64_t want = (total + threads - 1) / threads;
    const int blocks = (int)(want < 4096 ? want : 4096);
    bev_place_kernel<<<blocks, threads, 0, st>>>(seg, zs, rs, out, total, n,
                                                 n_flat, channels);
  }
  return (int)cudaGetLastError();
}
