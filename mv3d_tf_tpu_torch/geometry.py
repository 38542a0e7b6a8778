"""Geometry and box math on tensors: the port of mv3d_tf_tpu/geometry.py.

Same constants, formulas, shapes and reference quirks as the JAX module
(each function cites it). Every function takes and returns float32
tensors; the box functions keep any leading batch dimensions. The
projections run as broadcast multiply-and-sum in float32, so no TF32
matmul can touch them (the JAX module pins ``Precision.HIGHEST`` for the
same reason).

One float32 rule: JAX runs these functions under ``jit``, where XLA turns
a division by a constant into a multiply by the constant's float32
reciprocal. So BEV pixel coordinates are ``floor((y - TOP_Y_MIN) *
float32(1 / RES))`` here, on the CPU and on the card alike; a true
division puts 5 of 200,000 random boxes in front of the car one pixel off
(tests/test_torch_geometry_rest.py). Other divisions
are by tensors (PyTorch's CUDA division by a Python scalar is itself a
reciprocal multiply) or by powers of two. The BEV front end
(ops/bev.py) keeps the true division, because its reference is numpy.
"""

import numpy as np
import torch

# --- BEV grid constants (mv3d_tf_tpu/geometry.py:37-56) ----------------------
TOP_X_MAX = 60.0
TOP_X_MIN = 0.0
TOP_Y_MIN = -30.0
TOP_Y_MAX = 30.0
RES = 0.1
ZRES = 0.3
HEIGHT_MIN = -2.0
HEIGHT_MAX = 0.4
LIDAR_HEIGHT = 1.73
CAR_HEIGHT = 1.56
# floor division gives 600 coordinate cells; the raster itself is 601 wide
Xn = int((TOP_X_MAX - TOP_X_MIN) // RES) + 1   # 600
Yn = int((TOP_Y_MAX - TOP_Y_MIN) // RES) + 1   # 600
BEV_H = int((TOP_X_MAX - TOP_X_MIN) / RES) + 1  # 601
BEV_W = int((TOP_Y_MAX - TOP_Y_MIN) / RES) + 1  # 601
N_SLICES = int(round((HEIGHT_MAX - HEIGHT_MIN) / ZRES))  # 8
BEV_C = N_SLICES + 1

# 1 / RES as XLA folds it under jit: float32(1) / float32(RES) (10.0)
_INV_RES = float(np.float32(1) / np.float32(RES))

_X_SIGN = (1, 1, -1, -1, 1, 1, -1, -1)
_Y_SIGN = (1, -1, -1, 1, 1, -1, -1, 1)
_Z_SIGN = (-1, -1, -1, -1, 1, 1, 1, 1)


def _signs(s, like, scale=1.0):
    return torch.tensor(s, dtype=torch.float32, device=like.device) * scale


def lidar_to_bv_coord(x, y):
    """Lidar meters -> BEV pixel coords. geometry.py:61-65, as jitted JAX
    computes it: the division by RES is a multiply by _INV_RES."""
    xx = Yn - torch.floor((y - TOP_Y_MIN) * _INV_RES)
    yy = Xn - torch.floor((x - TOP_X_MIN) * _INV_RES)
    return xx, yy


def bv_to_lidar_coords(xx, yy):
    """BEV pixel coords (+0.5 cell center) -> lidar meters. geometry.py:68-72."""
    y = Xn * RES - (xx + 0.5) * RES + TOP_Y_MIN
    x = Yn * RES - (yy + 0.5) * RES + TOP_X_MIN
    return x, y


def bv_anchor_to_lidar(anchors):
    """(N, 4) BEV px boxes -> (N, 6) lidar [x,y,z,l,w,h] in float32.
    geometry.py:77-88 (anchors.bv_anchor_to_lidar_np is the float64 twin)."""
    lengths = (anchors[:, 3] - anchors[:, 1]) * RES
    widths = (anchors[:, 2] - anchors[:, 0]) * RES
    xx = (anchors[:, 0] + anchors[:, 2]) / 2.0
    yy = (anchors[:, 1] + anchors[:, 3]) / 2.0
    x, y = bv_to_lidar_coords(xx, yy)
    z = torch.full_like(x, -(LIDAR_HEIGHT - CAR_HEIGHT / 2.0))
    h = torch.full_like(x, CAR_HEIGHT)
    return torch.stack([x, y, z, lengths, widths, h], dim=1)


def lidar_3d_to_bv(rois_3d):
    """(..., 6) lidar [x,y,z,l,w,h] -> (..., 4) BEV px. geometry.py:91-100."""
    a = rois_3d[..., 0] + rois_3d[..., 3] * 0.5
    b = rois_3d[..., 1] + rois_3d[..., 4] * 0.5
    c = rois_3d[..., 0] - rois_3d[..., 3] * 0.5
    d = rois_3d[..., 1] - rois_3d[..., 4] * 0.5
    x1, y1 = lidar_to_bv_coord(a, b)
    x2, y2 = lidar_to_bv_coord(c, d)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def lidar_to_bv(rois_3d):
    """(N, 7) [batch,x,y,z,l,w,h] -> (N, 5) [batch,x1,y1,x2,y2].
    geometry.py:103-107."""
    return torch.cat([rois_3d[:, :1], lidar_3d_to_bv(rois_3d[:, 1:7])], dim=1)


def lidar_3d_to_corners(pts_3d):
    """(..., 6) [x,y,z,l,w,h] -> (..., 24) corners (x0..x7, y0..y7, z0..z7).
    geometry.py:110-125."""
    xc = pts_3d[..., 3:4] * _signs(_X_SIGN, pts_3d, 0.5) + pts_3d[..., 0:1]
    yc = pts_3d[..., 4:5] * _signs(_Y_SIGN, pts_3d, 0.5) + pts_3d[..., 1:2]
    zc = pts_3d[..., 5:6] * _signs(_Z_SIGN, pts_3d, 0.5) + pts_3d[..., 2:3]
    return torch.cat([xc, yc, zc], dim=-1)


def lidar_cnr_to_3d(corners, lwh):
    """(N, 24) corners + (N, 3) lwh -> (N, 6) [x,y,z,l,w,h]: the corners'
    mean and the given sizes. geometry.py:128-133."""
    ctr = corners.reshape(-1, 3, 8).mean(dim=2)
    return torch.cat([ctr, lwh.reshape(-1, 3)], dim=1)


def corners_to_bv(corners):
    """(N, 24*K) corners -> (N, 4*K) BEV boxes per class. geometry.py:136-152."""
    n, d = corners.shape
    k = d // 24
    c = corners.reshape(n, k, 24)
    xmin = c[:, :, 0:8].amin(dim=2)
    xmax = c[:, :, 0:8].amax(dim=2)
    ymin = c[:, :, 8:16].amin(dim=2)
    ymax = c[:, :, 8:16].amax(dim=2)
    x1, y1 = lidar_to_bv_coord(xmax, ymax)
    x2, y2 = lidar_to_bv_coord(xmin, ymin)
    return torch.stack([x1, y1, x2, y2], dim=2).reshape(n, 4 * k)


def _mat(a, b):
    """(..., i, j) @ (..., j, k) as a float32 multiply-and-sum."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def _homogeneous(pts, value):
    """(..., 3, k) points with a row of ``value`` below: (..., 4, k)."""
    return torch.cat([pts, torch.full_like(pts[..., :1, :], value)], dim=-2)


def compute_corners_3d(box3d, ry):
    """Camera-frame corners of one box (6,) [x,y,z,l,w,h] turned by the yaw
    ry (a number or a 0-dim tensor) about the camera's y axis: (3, 8).
    geometry.py:157-171."""
    ry = torch.as_tensor(ry, dtype=torch.float32, device=box3d.device)
    cos, sin = torch.cos(ry), torch.sin(ry)
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    R = torch.stack([torch.stack([cos, zero, sin]),
                     torch.stack([zero, one, zero]),
                     torch.stack([-sin, zero, cos])])
    l, w, h = box3d[3], box3d[4], box3d[5]
    x_c = _signs((1, 1, -1, -1, 1, 1, -1, -1), box3d) * (l / 2)
    y_c = _signs((0, 0, 0, 0, -1, -1, -1, -1), box3d) * h
    z_c = _signs((1, -1, -1, 1, 1, -1, -1, 1), box3d) * (w / 2)
    return _mat(R, torch.stack([x_c, y_c, z_c])) + box3d[0:3, None]


def _legacy_inverse_rt(Tr):
    """The reference's hand-rolled 'inverse' extrinsics: R = inv(Tr[:, :3])
    in float32 and the permuted T = [-Tr[1,3], -Tr[2,3], Tr[0,3]]; (3, 4).
    geometry.py:174-181."""
    Tr = Tr.reshape(3, 4)
    R = torch.linalg.inv(Tr[:, :3])
    T = torch.stack([-Tr[1, 3], -Tr[2, 3], Tr[0, 3]])[:, None]
    return torch.cat([R, T], dim=1)


def camera_to_lidar_cnr(pts_3d, Tr):
    """Camera corners, one box (3, 8) or (N, 24) in the cam layout, -> lidar
    corners (N, 24). geometry.py:184-198: the homogeneous coordinate is 0,
    so the T column of _legacy_inverse_rt is never applied."""
    pts = _homogeneous(pts_3d.reshape(-1, 3, 8), 0.0)
    return _mat(_legacy_inverse_rt(Tr), pts).reshape(-1, 24)


def cam_to_lidar_3d(pts_3d, Tr):
    """Camera (N, 6) [x,y,z,l,w,h] -> lidar (N, 6), the centers through
    _legacy_inverse_rt with a 0 homogeneous coordinate. geometry.py:201-208."""
    pts = _homogeneous(pts_3d[:, :3].T, 0.0)              # (4, N)
    lidar = _mat(_legacy_inverse_rt(Tr), pts).T
    return torch.cat([lidar, pts_3d[:, 3:6]], dim=1)


def project_to_image(pts_3d, P):
    """(3, N) points -> (2, N) image px through the 3x4 P, homogeneous
    coordinate 1. geometry.py:211-216."""
    p2 = _mat(P.reshape(3, 4), _homogeneous(pts_3d, 1.0))
    return p2[:2] / p2[2:3]


def _img_boxes(img):
    """(..., 3, 8) projected corners -> (..., 4) [x1,y1,x2,y2] after the
    division by depth WITHOUT abs (parity)."""
    img = img / img[..., 2:3, :]
    xs, ys = img[..., 0, :], img[..., 1, :]
    return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)],
                       dim=-1)


def _calib(rows, n, shape):
    """The first n entries of calib rows (..., >= n) as (..., *shape)."""
    return rows[..., :n].reshape(rows.shape[:-1] + shape)


def lidar_cnr_to_img(corners, Tr, R0, P2, legacy_int=True):
    """Lidar corners (..., N, 24) -> image boxes (..., N, 4) [x1,y1,x2,y2].

    geometry.py:219-248: mat = P2(3,4) @ R0(4,3) @ Tr(3,4), a 0 homogeneous
    coordinate, division by depth WITHOUT abs, then truncation (not with
    legacy_int=False). Tr, R0, P2 are calib rows, (12,) or (..., 12) per
    frame: Tr = calib[3], R0 = calib[2], P2 = calib[0].
    """
    if R0.shape[-1] == 9:   # raw 3x3 R0 -> pad the zero row the calib blob has
        R0 = torch.cat([R0, R0.new_zeros(R0.shape[:-1] + (3,))], dim=-1)
    mat = _mat(_mat(_calib(P2, 12, (3, 4)), _calib(R0, 12, (4, 3))),
               _calib(Tr, 12, (3, 4)))                  # (..., 3, 4)
    pts = corners.reshape(corners.shape[:-1] + (3, 8))
    boxes = _img_boxes(_mat(mat.unsqueeze(-3), _homogeneous(pts, 0.0)))
    return torch.trunc(boxes) if legacy_int else boxes


def lidar_cnr_to_img_full(corners, Tr, R0, P2):
    """Lidar corners (..., N, 24) -> image boxes (..., N, 4) through the
    standard KITTI chain with translations kept: P2 @ [R0 @ (Tr @ [xyz;1]);
    1], R0 the first 9 entries as 3x3. geometry.py:251-278 (the quality
    mode beside lidar_cnr_to_img's reference parity)."""
    pts = corners.reshape(corners.shape[:-1] + (3, 8))
    cam = _mat(_calib(Tr, 12, (3, 4)).unsqueeze(-3), _homogeneous(pts, 1.0))
    rect = _mat(_calib(R0, 9, (3, 3)).unsqueeze(-3), cam)
    return _img_boxes(_mat(_calib(P2, 12, (3, 4)).unsqueeze(-3),
                           _homogeneous(rect, 1.0)))


def bbox_transform_inv_3d(boxes, deltas):
    """6-dof decode: dx*length, dy*width. geometry.py:348-365.
    boxes (..., N, 6), deltas (..., N, 6K) -> (..., N, 6K)."""
    l, w, h = boxes[..., 3:4], boxes[..., 4:5], boxes[..., 5:6]
    cx, cy, cz = boxes[..., 0:1], boxes[..., 1:2], boxes[..., 2:3]
    out = torch.stack([
        deltas[..., 0::6] * l + cx,
        deltas[..., 1::6] * w + cy,
        deltas[..., 2::6] * h + cz,
        torch.exp(deltas[..., 3::6]) * l,
        torch.exp(deltas[..., 4::6]) * w,
        torch.exp(deltas[..., 5::6]) * h,
    ], dim=-1)
    return out.reshape(deltas.shape)


def bbox_transform_3d(ex_rois_3d, gt_rois_3d):
    """6-dof regression targets of (N, 6) boxes ``ex_rois_3d`` toward
    ``gt_rois_3d``, keeping the reference's dx/width and dy/length mixing.
    geometry.py:299-310."""
    ex, gt = ex_rois_3d, gt_rois_3d
    return torch.stack([
        (gt[:, 0] - ex[:, 0]) / ex[:, 4],
        (gt[:, 1] - ex[:, 1]) / ex[:, 3],
        (gt[:, 2] - ex[:, 2]) / ex[:, 5],
        torch.log(gt[:, 3] / ex[:, 3]),
        torch.log(gt[:, 4] / ex[:, 4]),
        torch.log(gt[:, 5] / ex[:, 5]),
    ], dim=1)


def corner_diag(boxes_cnr):
    """|corner0 - corner6| per box. geometry.py:313-318."""
    d = boxes_cnr[..., 0::8] - boxes_cnr[..., 6::8]
    return torch.linalg.vector_norm(d, dim=-1)


def bbox_transform_cnr(ex_rois_cnr, gt_rois_cnr):
    """Corner offsets normalized by the gt diagonal. geometry.py:321-326."""
    return (gt_rois_cnr - ex_rois_cnr) / corner_diag(gt_rois_cnr)[..., None]


def bbox_transform_inv_cnr(boxes_cnr, deltas):
    """Corner decode: deltas * diag + tiled base corners. geometry.py:368-375."""
    d = deltas * corner_diag(boxes_cnr)[:, None]
    k = deltas.shape[1] // 24
    return (d.reshape(-1, k, 24) + boxes_cnr[:, None, :]).reshape(deltas.shape)


def bbox_transform(ex_rois, gt_rois):
    """2D regression targets of (N, 4) boxes ``ex_rois`` toward ``gt_rois``,
    with the +1 width convention. geometry.py:283-296."""
    ex_w = ex_rois[:, 2] - ex_rois[:, 0] + 1.0
    ex_h = ex_rois[:, 3] - ex_rois[:, 1] + 1.0
    ex_cx = ex_rois[:, 0] + 0.5 * ex_w
    ex_cy = ex_rois[:, 1] + 0.5 * ex_h
    gt_w = gt_rois[:, 2] - gt_rois[:, 0] + 1.0
    gt_h = gt_rois[:, 3] - gt_rois[:, 1] + 1.0
    gt_cx = gt_rois[:, 0] + 0.5 * gt_w
    gt_cy = gt_rois[:, 1] + 0.5 * gt_h
    return torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                        torch.log(gt_w / ex_w), torch.log(gt_h / ex_h)],
                       dim=1)


def bbox_transform_inv(boxes, deltas):
    """2D decode of (N, 4K) deltas on (N, 4) boxes -> (N, 4K) boxes.
    geometry.py:329-345."""
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


def clip_boxes(boxes, im_shape):
    """Clip (..., 4K) boxes to [0, dim-1]. geometry.py:378-388. im_shape
    (h, w) holds numbers or 0-d tensors (the 2D path's traced im_info)."""
    h, w = im_shape[0], im_shape[1]
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))

    def clip(x, dim):
        return x.clamp(min=0).clamp(max=dim - 1)

    out = torch.stack([clip(b[..., 0], w), clip(b[..., 1], h),
                       clip(b[..., 2], w), clip(b[..., 3], h)], dim=-1)
    return out.reshape(boxes.shape)
