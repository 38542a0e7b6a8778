// Greedy NMS of the proposal layer: the exact greedy keep set of boxes
// already in descending score order, batched over frames, in two launches.
//
// Replaces no Pallas kernel. It stands for the JAX package's greedy NMS,
// mv3d_tf_tpu/ops/nms.py:nms (:224-260), a lax.fori_loop of max_out steps
// that XLA compiles into one program; run eagerly in PyTorch
// (ops/nms.py:nms_plain), each step is some 34 small launches, and the host
// issuing 300 steps a call leaves the card idle.
//
// The function, per frame of n boxes in score order, for a threshold
// 0 < thr (the wrapper refuses others): candidate j is live iff
// valid[j] (no array: all valid), score[j] is finite and score[j] > -1e30
// (ops/nms.py:NEG_INF). The first live candidate that is not suppressed is
// kept; a kept i suppresses every j >= i with IoU(i, j) >= thr, itself
// included where its IoU with itself reaches thr. A degenerate box that does
// not suppress itself stays the best candidate and fills every later slot,
// as the loop's argmax keeps taking it. The first max_out keeps go to their
// slots, order[i] in place of i where an order is given; unused slots get 0
// and false. The IoU is ops/iou.py:iou_one_to_many's with the kept box as
// `box`, operation by operation, each rounded once: __fadd_rn, __fsub_rn and
// __fmul_rn keep nvcc from contracting a product and a sum into an FMA, and
// the division is IEEE; fminf and fmaxf, which drop a NaN where
// torch.minimum and torch.clamp pass it on, reach torch's decision at a
// positive threshold (see suppresses).
//
// What bounds it on Hopper. Pass 1 writes the suppression mask, B * n *
// ceil(n/64) 64-bit words (36 MB at B = 8, n = 6000: 11 us at 3.35 TB/s), and
// computes the n (n + 1) / 2 IoUs of a frame's upper triangle (144 M at B =
// 8), a float32 division each. Pass 2 is a chain of up to max_out dependent
// steps: the next keep is known only once the last kept row is ORed in, so
// every step waits for one row's load.
//
// What the design does about it. Pass 1 spreads the 64 x 64 tiles of the
// upper triangle over every SM (a block a tile, a thread a row, the 64
// column boxes and their areas in shared memory); tiles below the diagonal
// are neither computed nor written, since the scan never reads them; a pair
// whose intersection is 0 (or NaN) skips the division, since its IoU is
// then 0 or NaN. Pass 2 runs one block a frame: its warps build
// the frame's "dead" words (not live, or suppressed; the bits past n set)
// in shared memory by ballots, then one warp walks them, a ballot finding
// the first word with a free bit and __ffsll the bit, so a step costs one
// round trip for the kept row (its words from the kept word on, all loads
// issued before the first OR; L2-resident at B = 8) and a warp barrier,
// and no block barrier. The scan stops at max_out keeps: later candidates
// cannot change the first max_out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;            // candidates a mask word covers
constexpr int SCAN_THREADS = 256;   // the scan block: 8 warps build, 1 walks
constexpr int LOADS = 4;            // a kept row's words a lane loads at once
constexpr float NEG_INF = -1e30f;   // ops/nms.py:NEG_INF, no candidate's score
// the dead words of a frame live in shared memory: at most 48 KB
constexpr int MAX_WORDS = 48 * 1024 / 8;

__device__ __forceinline__ float4 load_box(const float* __restrict__ p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

// (x2 - x1 + 1) * (y2 - y1 + 1)
__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// IoU(p, q) >= thr > 0, p the kept box (iou_one_to_many's `box`). A test
// needs inter > 0 and a finite union, so fminf and fmaxf, one instruction
// each, decide as torch's NaN-passing min, max and clamp do: a NaN
// coordinate makes its box's area NaN, so the union and the IoU, and a NaN
// width (inf - inf) gives inter 0 or NaN, both refused.
__device__ __forceinline__ bool suppresses(float4 p, float pa, float4 q,
                                           float qa, float thr) {
  const float iw = __fadd_rn(__fsub_rn(fminf(p.z, q.z), fmaxf(p.x, q.x)), 1.0f);
  const float ih = __fadd_rn(__fsub_rn(fminf(p.w, q.w), fmaxf(p.y, q.y)), 1.0f);
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  if (!(inter > 0.0f)) return false;                // IoU 0 or NaN
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(pa, qa), inter)) >= thr;
}

__device__ __forceinline__ bool live(const float* __restrict__ scores,
                                     const uint8_t* __restrict__ valid,
                                     int j) {
  const float s = scores[j];
  return (valid == nullptr || valid[j] != 0) && isfinite(s) && s > NEG_INF;
}

// the first tile of row tile r in the upper triangle's numbering
__device__ __forceinline__ int64_t row_start(int64_t r, int words) {
  return r * words - r * (r - 1) / 2;
}

// Pass 1. Block (t, b): tile t of frame b's upper triangle, row tile r and
// column tile c >= r, numbered row by row. Thread k owns row i = 64 r + k:
// bit q of mask[b][i][c] is set iff candidate j = 64 c + q is at or after i,
// below n, and IoU(i, j) >= thr.
__global__ void __launch_bounds__(TILE)
nms_mask_f32(const float* __restrict__ boxes, uint64_t* __restrict__ mask,
             int n, int words, float thr) {
  __shared__ float4 cbox[TILE];
  __shared__ float carea[TILE];
  // solve row_start(r) <= t < row_start(r + 1) in floating point, then
  // correct the estimate by whole rows
  const int64_t t = blockIdx.x;
  const double w2 = 2.0 * words + 1.0;
  int64_t r = (int64_t)((w2 - sqrt(w2 * w2 - 8.0 * (double)t)) / 2.0);
  while (r > 0 && row_start(r, words) > t) --r;
  while (row_start(r + 1, words) <= t) ++r;
  const int c = (int)(r + (t - row_start(r, words)));
  const int k = threadIdx.x;
  const int64_t frame = (int64_t)blockIdx.y * n;
  const int col = c * TILE + k;
  if (col < n) {
    const float4 q = load_box(boxes + (frame + col) * 4);
    cbox[k] = q;
    carea[k] = area(q);
  }
  __syncthreads();
  const int row = (int)r * TILE + k;
  if (row >= n) return;
  const float4 p = load_box(boxes + (frame + row) * 4);
  const float pa = area(p);
  const int cols = min(TILE, n - c * TILE);
  uint64_t bits = 0;
#pragma unroll 8
  for (int q = 0; q < cols; ++q)
    if (suppresses(p, pa, cbox[q], carea[q], thr)) bits |= 1ull << q;
  if (c == r) bits &= ~0ull << k;       // j >= i only
  mask[(frame + row) * words + c] = bits;
}

// Pass 2. Block b walks frame b's candidates in order; see the note above.
__global__ void __launch_bounds__(SCAN_THREADS)
nms_scan(const uint64_t* __restrict__ mask, const float* __restrict__ scores,
         const uint8_t* __restrict__ valid, const int64_t* __restrict__ order,
         int64_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_valid,
         int n, int words, int max_out) {
  extern __shared__ uint64_t dead[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t frame = (int64_t)blockIdx.x * n;
  scores += frame;
  if (valid != nullptr) valid += frame;
  for (int u = warp; u < words; u += SCAN_THREADS / 32) {
    const int j = u * TILE + lane;
    const unsigned lo = __ballot_sync(~0u, j < n && live(scores, valid, j));
    const unsigned hi =
        __ballot_sync(~0u, j + 32 < n && live(scores, valid, j + 32));
    if (lane == 0) dead[u] = ~(((uint64_t)hi << 32) | lo);
  }
  __syncthreads();
  if (warp != 0) return;

  const uint64_t* rows = mask + frame * words;
  keep_idx += (int64_t)blockIdx.x * max_out;
  keep_valid += (int64_t)blockIdx.x * max_out;
  int kept = 0, w = 0;            // every candidate before word w is dead
  while (kept < max_out) {
    int i = -1;
    for (int base = w; base < words; base += 32) {
      const int u = base + lane;
      const uint64_t open = u < words ? ~dead[u] : 0ull;
      const unsigned has = __ballot_sync(~0u, open != 0ull);
      if (has != 0u) {
        const int src = __ffs(has) - 1;
        w = base + src;
        i = w * TILE + __ffsll((long long)__shfl_sync(~0u, open, src)) - 1;
        break;
      }
    }
    if (i < 0) break;             // no live candidate left
    if (lane == 0) {
      keep_idx[kept] = order != nullptr ? order[frame + i] : i;
      keep_valid[kept] = 1;
    }
    ++kept;
    // the kept row's words from w on, LOADS a lane at a time, all loads
    // issued before the first OR: one round trip for up to 32 * LOADS words
    const uint64_t* row = rows + (int64_t)i * words;
    for (int base = w + lane; base < words; base += 32 * LOADS) {
      uint64_t got[LOADS];
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int u = base + 32 * q;
        got[q] = u < words ? row[u] : 0ull;
      }
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int u = base + 32 * q;
        if (u < words) dead[u] |= got[q];
      }
    }
    __syncwarp();
  }
  for (int q = kept + lane; q < max_out; q += 32) {
    keep_idx[q] = 0;
    keep_valid[q] = 0;
  }
}

}  // namespace

// boxes (B, n, 4) float32 -> mask (B, n, ceil(n/64)) uint64 at thr > 0;
// only the words at and right of each row's diagonal word are written.
extern "C" int mv3d_nms_mask_f32(const float* boxes, uint64_t* mask, int B,
                                 int n, float thr, void* stream) {
  if (B < 0 || n < 0 || B > 65535 || !(thr > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const int64_t words = (n + TILE - 1) / TILE;
  const int64_t tiles = words * (words + 1) / 2;
  if (tiles >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  nms_mask_f32<<<dim3((unsigned)tiles, (unsigned)B), TILE, 0,
                 (cudaStream_t)stream>>>(boxes, mask, n, (int)words, thr);
  return (int)cudaGetLastError();
}

// mask from mv3d_nms_mask_f32, scores (B, n) float32, valid (B, n) bool or
// NULL (all valid), order (B, n) int64 or NULL -> keep_idx (B, max_out)
// int64 and keep_valid (B, max_out) bool, every slot written.
extern "C" int mv3d_nms_scan(const uint64_t* mask, const float* scores,
                             const uint8_t* valid, const int64_t* order,
                             int64_t* keep_idx, uint8_t* keep_valid, int B,
                             int n, int max_out, void* stream) {
  const int words = (n + TILE - 1) / TILE;
  if (B < 0 || n < 0 || max_out < 0 || words > MAX_WORDS)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || max_out == 0) return (int)cudaGetLastError();
  nms_scan<<<(unsigned)B, SCAN_THREADS, words * sizeof(uint64_t),
             (cudaStream_t)stream>>>(mask, scores, valid, order, keep_idx,
                                     keep_valid, n, words, max_out);
  return (int)cudaGetLastError();
}
