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
// What bounds it on Hopper: bytes. It does no arithmetic; it must read 12
// bytes a point and write the raster, 13 MB a scan, nearly all of it zeros.
// So the raster is written once and nothing else is: a block owns a chunk
// of CHUNK_CELLS whole cells of one scan (CHUNK_CELLS * 9 floats, 36 KB)
// in shared memory. Two warps find the chunk's entries
// [lo, hi) in the scan's ascending slots, a lower bound each by a 32-way
// search (four dependent loads for 131,072 points, where a binary search
// takes seventeen), while the other warps zero the chunk; the block then
// stores its winners into shared memory and writes the chunk out in
// 16-byte stores, neighbouring threads on neighbouring addresses. Whole
// cells keep a winner's intensity target cell*9 + 8 in its own chunk. A
// scan's raster is 13,003,236 bytes, 4 (mod 16), so the chunks of scan b
// start 4b bytes (mod 16) off a 16-byte line: the chunk sits in shared
// memory at the offset its first float has within a 16-byte line, and the
// partial lines at its ends are stored a float at a time. This is the TPU
// kernel's idea (each grid step builds whole raster rows from their
// searchsorted range and stores them once) without its one-hot MXU matmul,
// row stripes and NO_REM sentinel, which exist because a TPU cannot
// scatter. Offsets into the raster are 64-bit: B x 3.25M elements passes
// 2^31 at B >= 661.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// cells a block owns; ops/bev_cuda.py:CHUNK_CELLS names the same number
// (256 to 2048 cells were measured on an H100: PERF.md)
constexpr int CHUNK_CELLS = 1024;
constexpr int CHANNELS = 9;             // the raster's: 8 slices, intensity
// the chunk, and up to three floats before it (its place in a 16-byte line)
constexpr int CHUNK_QUADS = (CHUNK_CELLS * CHANNELS + 3 + 3) / 4;

// the first index i in [0, n) with seg[i] >= key (n if none), seg
// ascending, by one warp: each step probes 32 evenly spaced entries and
// keeps the stretch between the last probe below key and the first not
__device__ __forceinline__ int lower_bound_warp(const int* __restrict__ seg,
                                                int n, int key) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = n;                   // the answer lies in [lo, hi]
  while (lo < hi) {
    const int stride = (hi - lo + 31) / 32;
    const int q = lo + (lane + 1) * stride - 1;
    const bool below = q < hi && seg[q] < key;
    const int cnt = __popc(__ballot_sync(0xffffffffu, below));
    const int base = lo;
    lo = base + cnt * stride;
    hi = min(hi, base + (cnt + 1) * stride - 1);
  }
  return lo;
}

// one block per (scan, chunk of CHUNK_CELLS cells)
__global__ void __launch_bounds__(THREADS)
bev_place_chunks(const int* __restrict__ seg, const float* __restrict__ zs,
                 const float* __restrict__ rs, float* __restrict__ out, int n,
                 int n_flat, int chunks) {
  __shared__ float4 chunk4[CHUNK_QUADS];
  float* chunk = reinterpret_cast<float*>(chunk4);
  __shared__ int range[2];
  const int64_t b = blockIdx.x / chunks;
  const int cell0 = (int)(blockIdx.x - b * chunks) * CHUNK_CELLS;
  const int cells = min(CHUNK_CELLS, n_flat / CHANNELS - cell0);
  const int slot0 = cell0 * CHANNELS;
  const int len = cells * CHANNELS;
  const int64_t g0 = b * n_flat + slot0;        // the chunk's first float
  const int head = (int)(g0 % 4);               // its place in a 16-byte line
  const int end = head + len;
  const int quads = (end + 3) / 4;
  const int* sg = seg + b * n;
  const int warp = threadIdx.x / 32;

  if (warp < 2) {
    const int v = lower_bound_warp(sg, n, slot0 + warp * len);
    if (threadIdx.x % 32 == 0) range[warp] = v;
  } else {
    for (int q = threadIdx.x - 64; q < quads; q += THREADS - 64)
      chunk4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the winners: the last entry of a slot's run, of a cell's run; the
  // scan's last entry ends both
  const float* z = zs + b * n;
  const float* r = rs + b * n;
  for (int i = range[0] + threadIdx.x; i < range[1]; i += THREADS) {
    const int s = sg[i];
    const bool last = i == n - 1;
    const int next = last ? 0 : sg[i + 1];
    const int cell = s / CHANNELS;
    if (last || next != s) chunk[head + s - slot0] = z[i];
    if (last || next / CHANNELS != cell)
      chunk[head + cell * CHANNELS + CHANNELS - 1 - slot0] = r[i];
  }
  __syncthreads();

  // out once: whole 16-byte lines as float4, the partial lines at the
  // chunk's ends a float at a time (the floats around them are not its)
  float* line = out + (g0 - head);              // 16-byte aligned
  for (int q = threadIdx.x; q < quads; q += THREADS) {
    const int i0 = 4 * q;
    if (i0 >= head && i0 + 4 <= end) {
      reinterpret_cast<float4*>(line)[q] = chunk4[q];
    } else {
      for (int e = max(i0, head); e < min(i0 + 4, end); ++e)
        line[e] = chunk[e];
    }
  }
}

}  // namespace

// seg, zs, rs (B, n) contiguous; out (B, n_flat) float32, 16-byte aligned,
// every element written by the kernel; n_flat a multiple of channels,
// which must be the kernel's 9. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a channels or n it does not take.
extern "C" int mv3d_bev_place_f32(const int* seg, const float* zs,
                                  const float* rs, float* out, int64_t B,
                                  int64_t n, int n_flat, int channels,
                                  void* stream) {
  if (channels != CHANNELS || n < 0 || n >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  const int chunks = (n_flat / CHANNELS + CHUNK_CELLS - 1) / CHUNK_CELLS;
  if (B <= 0) return (int)cudaGetLastError();
  if (B * chunks >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  bev_place_chunks<<<(unsigned)(B * chunks), THREADS, 0,
                     (cudaStream_t)stream>>>(seg, zs, rs, out, (int)n, n_flat,
                                             chunks);
  return (int)cudaGetLastError();
}
