"""Plain versions of the detector's operations, for the reference.

Frozen copies, as of the port's first benchmark, of
mv3d_tf_tpu_torch/ops/roi_pool.py (``bin_bounds``, ``roi_pool``: the
reference's ROIPoolForward as a masked max), mv3d_tf_tpu_torch/ops/nms.py
(``nms_np``, the host greedy oracle with cpu_nms.pyx semantics) and
mv3d_tf_tpu_torch/ops/bev.py (``point_cloud_2_top_np``, the numpy twin of
the reference's read_lidar.py), plus a greedy NMS written out as the
reference's definition: one box per step, the first highest score among
those left, each step suppressing IoU >= threshold.
"""

import numpy as np
import torch

from benchmark.reference import geometry as G

_CHUNK = 128


def _c_round(x):
    """C round(): half away from zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def bin_bounds(rois, pooled, spatial_scale, H, W):
    """(R, 4, pooled) int32 rows hstart, hend, wstart, wend of each bin."""
    xs, ys, xe, ye = _c_round(rois[:, 1:5] * spatial_scale).to(
        torch.int32).unbind(1)
    roi_w = (xe - xs + 1).clamp(min=1)[:, None]
    roi_h = (ye - ys + 1).clamp(min=1)[:, None]
    p = torch.arange(pooled, dtype=torch.int32, device=rois.device)
    return torch.stack([
        ((p * roi_h) // pooled + ys[:, None]).clamp(0, H),
        (((p + 1) * roi_h + pooled - 1) // pooled + ys[:, None]).clamp(0, H),
        ((p * roi_w) // pooled + xs[:, None]).clamp(0, W),
        (((p + 1) * roi_w + pooled - 1) // pooled + xs[:, None]).clamp(0, W),
    ], dim=1)


def roi_pool(feat, rois, pooled=7, spatial_scale=1.0 / 8):
    """ROI max-pool of feat (H, W, C) at rois (R, 5) [frame, x1, y1, x2,
    y2]: (R, pooled, pooled, C); empty bins give 0."""
    H, W, C = feat.shape
    bounds = bin_bounds(rois, pooled, spatial_scale, H, W).long()
    outs = []
    for i in range(0, rois.shape[0], _CHUNK):
        hs, he, ws, we = bounds[i:i + _CHUNK].unbind(1)
        r, P = hs.shape[0], pooled
        m1 = feat.new_full((r, P, W, C), float("-inf"))
        hlen = he - hs
        for k in range(int(hlen.max().clamp(min=0)) if r else 0):
            rows = feat[(hs + k).clamp(max=H - 1)]               # (r,P,W,C)
            m1 = torch.where((k < hlen)[:, :, None, None],
                             torch.maximum(m1, rows), m1)
        out = feat.new_full((r, P, P, C), float("-inf"))
        wlen = we - ws
        for k in range(int(wlen.max().clamp(min=0)) if r else 0):
            idx = (ws + k).clamp(max=W - 1)[:, None, :, None].expand(
                r, P, P, C)
            out = torch.where((k < wlen)[:, None, :, None],
                              torch.maximum(out, torch.gather(m1, 2, idx)),
                              out)
        empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]
        outs.append(out.masked_fill(empty[..., None], 0))
    if not outs:
        return feat.new_zeros((0, pooled, pooled, C))
    return torch.cat(outs)


def top_k(scores, valid, k):
    """Indices of the k highest valid scores, descending, ties to the lower
    index; and whether each is valid."""
    masked = torch.where(valid, scores, -1e30)
    vals, idx = torch.sort(masked, descending=True, stable=True)
    return idx[:k], vals[:k] > -1e30


def nms_greedy(boxes, scores, valid, max_out, thresh):
    """Greedy NMS with max_out slots: (keep_idx (max_out,), keep_valid)."""
    msk = torch.where(valid, scores, -1e30)
    keep = torch.zeros(max_out, dtype=torch.long, device=boxes.device)
    found = torch.zeros(max_out, dtype=torch.bool, device=boxes.device)
    for i in range(max_out):
        best = torch.argmax(msk)
        ok = msk[best] > -1e30
        iou = G.bbox_overlaps(boxes[best][None], boxes)[0]
        # a box whose IoU with itself rounds below 1 is still taken out
        hit = (iou >= thresh) | (torch.arange(len(msk), device=msk.device)
                                 == best)
        msk = torch.where(ok & hit, -1e30, msk)
        keep[i] = torch.where(ok, best, 0)
        found[i] = ok
    return keep, found


def nms_np(dets, thresh):
    """Host greedy NMS over dets (N, 5) [x1, y1, x2, y2, score] -> keep."""
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    suppressed = np.zeros(dets.shape[0], bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas - inter)
        suppressed |= ovr >= thresh
    return keep


def point_cloud_2_top_np(points):
    """A scan (N, 4) [x, y, z, reflectance] -> the (601, 601, 9) raster:
    channels 0-7 the height above HEIGHT_MIN of the last point in file order
    in each 0.3 m slice of a cell, channel 8 the reflectance of the last
    point of the highest slice that touches it; slice bounds compared in
    float32, pixel coordinates by float32 division, truncated."""
    points = np.asarray(points, np.float32)
    x, y, z, r = points[:, 0], points[:, 1], points[:, 2], points[:, 3]
    res = np.float32(G.RES)
    x_max = int((G.TOP_Y_MAX * 2) / G.RES)
    y_max = int((G.TOP_X_MAX - G.TOP_X_MIN) / G.RES)
    z_max = int((G.HEIGHT_MAX - G.HEIGHT_MIN) / G.ZRES)
    top = np.zeros((y_max + 1, x_max + 1, z_max + 1), np.float32)
    in_range = ((x > G.TOP_X_MIN) & (x < G.TOP_X_MAX)
                & (y > -G.TOP_Y_MAX) & (y < G.TOP_Y_MAX))
    x_shift = -int(np.floor(-G.TOP_Y_MAX / G.RES))
    y_shift = int(np.floor(G.TOP_X_MAX / G.RES))
    for i, h in enumerate(np.arange(G.HEIGHT_MIN, G.HEIGHT_MAX, G.ZRES)):
        lo, hi = np.float32(h), np.float32(h + G.ZRES)
        idx = np.flatnonzero(in_range & (z >= lo) & (z < hi))
        x_img = (-y[idx] / res).astype(np.int32) + x_shift
        y_img = (-x[idx] / res).astype(np.int32) + y_shift
        top[y_img, x_img, i] = z[idx] - np.float32(G.HEIGHT_MIN)
        top[y_img, x_img, z_max] = r[idx]
    return top
