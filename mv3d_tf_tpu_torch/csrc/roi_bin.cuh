// One bin of a roi, computed on the card from the (R,5) float32 rois: the
// formula of ops/roi_pool.py:bin_bounds and _as_batch (which the TPU
// kernels' _bin_bounds, roi_pool_pallas.py:48-65, also follows), included
// by csrc/roi_pool.cu and csrc/roi_pool_bwd.cu.
//
// The float steps are written with __fmul_rn / __fadd_rn so that nvcc
// cannot contract them into a fused multiply-add: a corner times
// spatial_scale rounds to float32, then round half away from zero
// (sign(x) * floor(|x| + 0.5), _c_round), then truncation to int32. The
// rest is integer: floor and ceiling division on non-negative operands
// (exact in C), the corner added, clamped to [0,H] / [0,W].
#pragma once

struct RoiBin {
  int frame, h0, h1, w0, w1;   // cells [h0,h1) x [w0,w1) of map `frame`
};

__device__ __forceinline__ int roi_corner(float x, float scale) {
  const float s = __fmul_rn(x, scale);
  const float a = floorf(__fadd_rn(fabsf(s), 0.5f));
  return (int)(s < 0.0f ? -a : a);
}

__device__ __forceinline__ int clamp_to(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// roi: one (5,) row [frame, x1, y1, x2, y2] in input pixels; B frames of
// H x W cells. The frame is column 0 truncated and clamped to [0, B-1].
__device__ __forceinline__ RoiBin roi_bin(const float* roi, int ph, int pw,
                                          int pooled, float scale, int B,
                                          int H, int W) {
  const int frame = (int)roi[0];
  const int xs = roi_corner(roi[1], scale), ys = roi_corner(roi[2], scale);
  const int xe = roi_corner(roi[3], scale), ye = roi_corner(roi[4], scale);
  const int roi_w = max(xe - xs + 1, 1), roi_h = max(ye - ys + 1, 1);
  RoiBin b;
  b.frame = clamp_to(frame, B - 1);
  b.h0 = clamp_to(ph * roi_h / pooled + ys, H);
  b.h1 = clamp_to(((ph + 1) * roi_h + pooled - 1) / pooled + ys, H);
  b.w0 = clamp_to(pw * roi_w / pooled + xs, W);
  b.w1 = clamp_to(((pw + 1) * roi_w + pooled - 1) / pooled + xs, W);
  return b;
}

// The bin of flat index g = roi * pooled^2 + ph * pooled + pw.
__device__ __forceinline__ RoiBin flat_bin(const float* rois, int g,
                                           int pooled, float scale, int B,
                                           int H, int W) {
  const int r = g / (pooled * pooled), bin = g - r * pooled * pooled;
  return roi_bin(rois + 5 * (size_t)r, bin / pooled, bin % pooled, pooled,
                 scale, B, H, W);
}

// The number of cells of a bin (0 if it is empty), and the flat index into
// the map's H*W cells of its k-th cell in row-major order.
__device__ __forceinline__ int bin_cells(const RoiBin& b) {
  const int h = b.h1 - b.h0, w = b.w1 - b.w0;
  return h > 0 && w > 0 ? h * w : 0;
}
__device__ __forceinline__ size_t bin_cell(const RoiBin& b, int k, int W) {
  const int bw = b.w1 - b.w0, dh = k / bw;
  return (size_t)(b.h0 + dh) * W + b.w0 + (k - dh * bw);
}
