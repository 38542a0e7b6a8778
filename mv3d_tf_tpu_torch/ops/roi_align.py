"""Multi-level RoIAlign (Detectron2's ROIAlignV2 under its ROIPooler): the
level rule, the plain PyTorch version and the dispatch to the CUDA kernel
(csrc/roi_align.cu through ops/roi_align_cuda.py).

Each roi is pooled from one map of a pyramid whose level k has stride 2^k:
  * level: k = clamp(floor(K0 + log2(sqrt(area) / S0 + 1e-8)), k_min,
    k_max), area = (x2 - x1) (y2 - y1) without the +1, K0 = 4, S0 = 224;
    floor(log2(s)) is taken as the binary exponent of the float32 s, which
    is exact, where a rounded log2 could cross an integer (``assign_levels``;
    the kernel takes the same exponent);
  * the roi scaled by 2^-k and shifted by -0.5 (aligned=True); its size is
    not forced to 1;
  * each of the pooled x pooled bins averages ceil(roi_h / pooled) x
    ceil(roi_w / pooled) bilinear samples at the sub-bin centres (sampling
    ratio 0), y = y0 + ph bin_h + (iy + 0.5) bin_h / grid_h;
  * a sample outside [-1, H] x [-1, W] gives 0; one inside is clamped to
    [0, H-1] x [0, W-1] (Detectron2's edge rule).

The plain version computes sample by sample in float32, each bilinear
value as ((w1 v1 + w2 v2) + w3 v3) + w4 v4 and the bin's sum in the
samples' order (iy outer, ix inner), then the mean by one division, and
rounds to the maps' dtype once; it divides by tensors only, since on a
card PyTorch turns a division by a Python number into a product with its
rounded reciprocal. The kernel does the same operations in
the same order without contraction into FMAs, so the two agree bit for
bit (chip_smoke.py:phase_roi_align).
"""

import torch

CANONICAL_LEVEL = 4
CANONICAL_SIZE = 224.0
_CHUNK = 128   # rois per block of the plain version: bounds its memory


def assign_levels(boxes, k_min, k_max):
    """(R,) int64 pyramid levels of (R, 4) float32 boxes [x1, y1, x2, y2] in
    image pixels, by the rule above."""
    boxes = boxes.float()
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    # a tensor divisor: PyTorch's CUDA division by a Python number
    # multiplies by its rounded reciprocal, the kernel divides
    s = torch.sqrt(area) / torch.full_like(area, CANONICAL_SIZE) + 1e-8
    exponent = torch.frexp(s).exponent.long() - 1      # floor(log2(s))
    return (CANONICAL_LEVEL + exponent).clamp(k_min, k_max)


def roi_align(maps, rois, pooled, k_min=2):
    """The plain multi-level RoIAlign. maps: a list of (H_l, W_l, C) or
    (B, H_l, W_l, C) maps, level k_min + l at stride 2^(k_min + l), one
    dtype; rois (R, 5) float32 [frame, x1, y1, x2, y2] in image pixels.
    Returns ((R, pooled, pooled, C) in the maps' dtype, levels (R,) int32,
    the level each roi was pooled from)."""
    maps = [m if m.dim() == 4 else m[None] for m in maps]
    dtype, dev = maps[0].dtype, maps[0].device
    C = maps[0].shape[-1]
    k_max = k_min + len(maps) - 1
    rois = rois.float()
    levels = assign_levels(rois[:, 1:5], k_min, k_max)
    # every level's cells in one (cells, C) float32 table
    sizes = [m.shape[:3] for m in maps]
    base = [0]
    for B, H, W in sizes:
        base.append(base[-1] + B * H * W)
    table = torch.cat([m.reshape(-1, C).float() for m in maps])
    out = torch.zeros(rois.shape[0], pooled, pooled, C, dtype=torch.float32,
                      device=dev)
    for i in range(0, rois.shape[0], _CHUNK):
        out[i:i + _CHUNK] = _align_block(table, sizes, base,
                                         rois[i:i + _CHUNK],
                                         levels[i:i + _CHUNK] - k_min,
                                         k_min, pooled)
    return out.to(dtype), levels.int()


def _align_block(table, sizes, base, rois, lvl, k_min, P):
    """One block of rois (r, 5) at level indices lvl (r,): (r, P, P, C)
    float32."""
    r, dev = rois.shape[0], rois.device
    C = table.shape[1]
    if r == 0:
        return table.new_zeros((0, P, P, C))
    Hs = torch.tensor([s[1] for s in sizes], device=dev)[lvl]
    Ws = torch.tensor([s[2] for s in sizes], device=dev)[lvl]
    start = (torch.tensor(base[:-1], device=dev)[lvl]
             + rois[:, 0].long() * Hs * Ws)
    scale = torch.tensor([2.0 ** -(k_min + i) for i in range(len(sizes))],
                         device=dev)[lvl]
    x0 = rois[:, 1] * scale - 0.5
    y0 = rois[:, 2] * scale - 0.5
    roi_w = rois[:, 3] * scale - 0.5 - x0
    roi_h = rois[:, 4] * scale - 0.5 - y0
    pf = torch.full_like(roi_w, P)          # divided by a tensor, as above
    bin_w, bin_h = roi_w / pf, roi_h / pf
    grid_w = torch.ceil(bin_w).clamp(min=0).long()
    grid_h = torch.ceil(bin_h).clamp(min=0).long()
    count = (torch.ceil(bin_h).long() * torch.ceil(bin_w).long()
             ).clamp(min=1).float()
    p = torch.arange(P, device=dev, dtype=torch.float32)
    # (r, P) bin starts: roi start + bin index x bin size
    ys0 = y0[:, None] + p[None, :] * bin_h[:, None]
    xs0 = x0[:, None] + p[None, :] * bin_w[:, None]
    Hf, Wf = Hs.float()[:, None], Ws.float()[:, None]
    # a roi without samples on an axis divides by 1 here; its sums stay 0
    gh_div = grid_h.clamp(min=1)[:, None].float()
    gw_div = grid_w.clamp(min=1)[:, None].float()
    acc = table.new_zeros((r, P, P, C))
    for iy in range(int(grid_h.max())):
        y = ys0 + (iy + 0.5) * bin_h[:, None] / gh_div
        y_ok = (y >= -1.0) & (y <= Hf)
        yl, yh, ly, hy = _corner(y, Hs[:, None])
        for ix in range(int(grid_w.max())):
            x = xs0 + (ix + 0.5) * bin_w[:, None] / gw_div
            x_ok = (x >= -1.0) & (x <= Wf)
            xl, xh, lx, hx = _corner(x, Ws[:, None])
            row_l = start[:, None] + yl * Ws[:, None]          # (r, P)
            row_h = start[:, None] + yh * Ws[:, None]

            def value(row, col):
                return table[row[:, :, None] + col[:, None, :]]   # (r,P,P,C)

            w1 = (hy[:, :, None] * hx[:, None, :])[..., None]
            w2 = (hy[:, :, None] * lx[:, None, :])[..., None]
            w3 = (ly[:, :, None] * hx[:, None, :])[..., None]
            w4 = (ly[:, :, None] * lx[:, None, :])[..., None]
            val = (((w1 * value(row_l, xl) + w2 * value(row_l, xh))
                    + w3 * value(row_h, xl)) + w4 * value(row_h, xh))
            inside = ((iy < grid_h)[:, None, None]
                      & (ix < grid_w)[:, None, None]
                      & y_ok[:, :, None] & x_ok[:, None, :])
            acc = torch.where(inside[..., None], acc + val, acc)
    return acc / count[:, None, None, None]


def _corner(v, size):
    """Detectron2's bilinear corner of sample coordinates v (r, P) on an
    axis of ``size`` (r, 1) cells: (low, high) cell indices and the (l, h)
    weights, v clamped at 0 and at the last cell."""
    v = v.clamp(min=0.0)
    low = torch.floor(v).long()
    last = low >= size - 1
    low = torch.where(last, size - 1, low)
    high = torch.where(last, size - 1, low + 1)
    v = torch.where(last, low.float(), v)
    lv = v - low.float()
    return low, high, lv, 1.0 - lv


def roi_align_fast(maps, rois, pooled, k_min=2):
    """Inference dispatch: CUDA maps go to the hand-written kernel, one
    launch for every roi; CPU maps to the plain version; any other device
    raises. Returns (pooled maps, levels) as ``roi_align``."""
    if maps[0].is_cuda:
        from mv3d_tf_tpu_torch.ops.roi_align_cuda import roi_align_cuda
        return roi_align_cuda(maps, rois, pooled, k_min)
    if maps[0].device.type == "cpu":
        return roi_align(maps, rois, pooled, k_min)
    raise ValueError("roi_align_fast: no RoIAlign for device "
                     + str(maps[0].device))
