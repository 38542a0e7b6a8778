"""Frozen copy of mv3d_tf_tpu_torch/geometry.py (constants, BEV and image
projections, box codecs) and mv3d_tf_tpu_torch/anchors.py (the BEV and 2D
anchor grids), as of the port's first benchmark.

The reference keeps its own copy so that it does not move when the
program does. Float32 throughout; the BEV pixel coordinate multiplies by
float32(1 / RES), as the program and the JAX package's jitted code do.
"""

import numpy as np
import torch

TOP_X_MAX, TOP_X_MIN = 60.0, 0.0
TOP_Y_MIN, TOP_Y_MAX = -30.0, 30.0
RES, ZRES = 0.1, 0.3
HEIGHT_MIN, HEIGHT_MAX = -2.0, 0.4
LIDAR_HEIGHT, CAR_HEIGHT = 1.73, 1.56
Xn = int((TOP_X_MAX - TOP_X_MIN) // RES) + 1   # 600
Yn = int((TOP_Y_MAX - TOP_Y_MIN) // RES) + 1   # 600
_INV_RES = float(np.float32(1) / np.float32(RES))

_X_SIGN = (1, 1, -1, -1, 1, 1, -1, -1)
_Y_SIGN = (1, -1, -1, 1, 1, -1, -1, 1)
_Z_SIGN = (-1, -1, -1, -1, 1, 1, 1, 1)

# the proposal layer's hardcoded camera bounds and padding
IMG_BOUNDS = (375.0, 1242.0)
IMG_PAD = 50.0


def _signs(s, like, scale=1.0):
    return torch.tensor(s, dtype=torch.float32, device=like.device) * scale


def lidar_to_bv_coord(x, y):
    xx = Yn - torch.floor((y - TOP_Y_MIN) * _INV_RES)
    yy = Xn - torch.floor((x - TOP_X_MIN) * _INV_RES)
    return xx, yy


def lidar_3d_to_bv(rois_3d):
    """(..., 6) lidar [x,y,z,l,w,h] -> (..., 4) BEV px."""
    a = rois_3d[..., 0] + rois_3d[..., 3] * 0.5
    b = rois_3d[..., 1] + rois_3d[..., 4] * 0.5
    c = rois_3d[..., 0] - rois_3d[..., 3] * 0.5
    d = rois_3d[..., 1] - rois_3d[..., 4] * 0.5
    x1, y1 = lidar_to_bv_coord(a, b)
    x2, y2 = lidar_to_bv_coord(c, d)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def lidar_3d_to_corners(pts_3d):
    """(..., 6) -> (..., 24) corners (x0..x7, y0..y7, z0..z7)."""
    xc = pts_3d[..., 3:4] * _signs(_X_SIGN, pts_3d, 0.5) + pts_3d[..., 0:1]
    yc = pts_3d[..., 4:5] * _signs(_Y_SIGN, pts_3d, 0.5) + pts_3d[..., 1:2]
    zc = pts_3d[..., 5:6] * _signs(_Z_SIGN, pts_3d, 0.5) + pts_3d[..., 2:3]
    return torch.cat([xc, yc, zc], dim=-1)


def corners_to_bv(corners):
    """(N, 24K) corners -> (N, 4K) BEV boxes per class."""
    n, d = corners.shape
    c = corners.reshape(n, d // 24, 24)
    x1, y1 = lidar_to_bv_coord(c[:, :, 0:8].amax(2), c[:, :, 8:16].amax(2))
    x2, y2 = lidar_to_bv_coord(c[:, :, 0:8].amin(2), c[:, :, 8:16].amin(2))
    return torch.stack([x1, y1, x2, y2], dim=2).reshape(n, d // 6)


def _mat(a, b):
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def _homogeneous(pts, value):
    return torch.cat([pts, torch.full_like(pts[..., :1, :], value)], dim=-2)


def lidar_cnr_to_img(corners, calib):
    """Lidar corners (N, 24) -> image boxes (N, 4): P2 @ R0 @ Tr with a 0
    homogeneous coordinate, division by depth without abs, truncation (the
    reference's projection). calib (4, 12) rows P2, P3, R0, Tr."""
    p2 = calib[0].reshape(3, 4)
    r0 = calib[2].reshape(4, 3)
    tr = calib[3].reshape(3, 4)
    mat = _mat(_mat(p2, r0), tr)
    pts = corners.reshape(corners.shape[:-1] + (3, 8))
    img = _mat(mat.unsqueeze(-3), _homogeneous(pts, 0.0))
    img = img / img[..., 2:3, :]
    xs, ys = img[..., 0, :], img[..., 1, :]
    boxes = torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1),
                         ys.amax(-1)], dim=-1)
    return torch.trunc(boxes)


def bbox_transform_inv_3d(boxes, deltas):
    """(N, 6) anchors, (N, 6) deltas -> (N, 6) boxes."""
    l, w, h = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    return torch.cat([deltas[:, 0:1] * l + boxes[:, 0:1],
                      deltas[:, 1:2] * w + boxes[:, 1:2],
                      deltas[:, 2:3] * h + boxes[:, 2:3],
                      torch.exp(deltas[:, 3:4]) * l,
                      torch.exp(deltas[:, 4:5]) * w,
                      torch.exp(deltas[:, 5:6]) * h], dim=1)


def corner_diag(boxes_cnr):
    d = boxes_cnr[..., 0::8] - boxes_cnr[..., 6::8]
    return torch.linalg.vector_norm(d, dim=-1)


def bbox_transform_inv_cnr(boxes_cnr, deltas):
    """Corner decode: deltas * diag + tiled base corners."""
    d = deltas * corner_diag(boxes_cnr)[:, None]
    k = deltas.shape[1] // 24
    return (d.reshape(-1, k, 24) + boxes_cnr[:, None, :]).reshape(deltas.shape)


def bbox_transform_inv(boxes, deltas):
    """2D decode of (N, 4K) deltas on (N, 4) boxes."""
    w = boxes[:, 2:3] - boxes[:, 0:1] + 1.0
    h = boxes[:, 3:4] - boxes[:, 1:2] + 1.0
    cx = boxes[:, 0:1] + 0.5 * w
    cy = boxes[:, 1:2] + 0.5 * h
    pcx = deltas[:, 0::4] * w + cx
    pcy = deltas[:, 1::4] * h + cy
    pw = torch.exp(deltas[:, 2::4]) * w
    ph = torch.exp(deltas[:, 3::4]) * h
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw, pcy + 0.5 * ph], dim=2)
    return out.reshape(deltas.shape)


def clip_boxes(boxes, h, w):
    """Clip (..., 4K) boxes to [0, dim - 1]."""
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    out = torch.stack([b[..., 0].clamp(min=0).clamp(max=w - 1),
                       b[..., 1].clamp(min=0).clamp(max=h - 1),
                       b[..., 2].clamp(min=0).clamp(max=w - 1),
                       b[..., 3].clamp(min=0).clamp(max=h - 1)], dim=-1)
    return out.reshape(boxes.shape)


def bbox_overlaps(boxes, query):
    """(N, 4) x (K, 4) -> (N, K) IoU, +1 pixel areas, 0 without overlap."""
    b, q = boxes[:, None, :], query[None, :, :]
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0],
                                                             q[..., 0]) + 1.0
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1],
                                                             q[..., 1]) + 1.0
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_b = ((boxes[:, 2] - boxes[:, 0] + 1.0)
              * (boxes[:, 3] - boxes[:, 1] + 1.0))[:, None]
    area_q = ((query[:, 2] - query[:, 0] + 1.0)
              * (query[:, 3] - query[:, 1] + 1.0))[None, :]
    iou = inter / (area_b + area_q - inter)
    return torch.where((iw > 0.0) & (ih > 0.0), iou, 0.0)


# --- anchors ---------------------------------------------------------------

def _shift(base, height, width, stride):
    sx, sy = np.meshgrid(np.arange(width) * stride, np.arange(height) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    out = base[None, :, :] + shifts[:, None, :]
    return out.reshape(-1, 4).astype(np.float32)


def anchors_bv(feat_h, feat_w, stride=8):
    """BEV anchors (K*4, 4) px and their lidar boxes (K*4, 6), location-major:
    car 3.9 x 1.6 m and 1.0 x 0.6 m, two orientations each."""
    base = np.array([[0, 0, int(3.9 / RES), int(1.6 / RES)],
                     [0, 0, int(1.0 / RES), int(0.6 / RES)]])
    base[:, 0] -= base[:, 2] // 2
    base[:, 1] -= base[:, 3] // 2
    base[:, 2] -= base[:, 2] // 2
    base[:, 3] -= base[:, 3] // 2
    base = np.vstack([base, base[:, [1, 0, 3, 2]]])
    bv = _shift(base, feat_h, feat_w, stride)
    a = bv.astype(np.float64)
    cxx = (a[:, 0] + a[:, 2]) / 2.0
    cyy = (a[:, 1] + a[:, 3]) / 2.0
    x = Yn * RES - (cyy + 0.5) * RES + TOP_X_MIN
    y = Xn * RES - (cxx + 0.5) * RES + TOP_Y_MIN
    lidar = np.stack([x, y, np.full_like(x, -(LIDAR_HEIGHT - CAR_HEIGHT / 2)),
                      (a[:, 3] - a[:, 1]) * RES, (a[:, 2] - a[:, 0]) * RES,
                      np.full_like(x, CAR_HEIGHT)], 1)
    return bv, lidar.astype(np.float32)


def anchors_2d(feat_h, feat_w, stride=16, ratios=(0.5, 1, 2),
               scales=(8, 16, 32)):
    """The classic 9 anchors a location, shifted: (K*9, 4) float32."""
    def whctrs(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, cx, cy):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                          cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])

    w, h, cx, cy = whctrs(np.array([0, 0, 15, 15]))
    ws = np.round(np.sqrt(w * h / np.array(ratios, np.float64)))
    ratio_anchors = mk(ws, np.round(ws * np.array(ratios)), cx, cy)
    base = []
    for a in ratio_anchors:
        w, h, cx, cy = whctrs(a)
        base.append(mk(w * np.array(scales), h * np.array(scales), cx, cy))
    return _shift(np.vstack(base), feat_h, feat_w, stride)
