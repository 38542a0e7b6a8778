"""Geometry and box math on tensors: the subset of mv3d_tf_tpu/geometry.py
that the detector and the train step run.

Same constants, formulas and reference quirks as the JAX module (each
function cites it). Every function takes and returns float32 tensors and
keeps any leading batch dimensions. The projections run as broadcast
multiply-and-sum in float32, so no TF32 matmul can touch them (the JAX
module pins ``Precision.HIGHEST`` for the same reason).
"""

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

_X_SIGN = (1, 1, -1, -1, 1, 1, -1, -1)
_Y_SIGN = (1, -1, -1, 1, 1, -1, -1, 1)
_Z_SIGN = (-1, -1, -1, -1, 1, 1, 1, 1)


def lidar_to_bv_coord(x, y):
    """Lidar meters -> BEV pixel coords. geometry.py:61-65."""
    xx = Yn - torch.floor((y - TOP_Y_MIN) / RES)
    yy = Xn - torch.floor((x - TOP_X_MIN) / RES)
    return xx, yy


def bv_anchor_to_lidar(anchors):
    """(N, 4) BEV px boxes -> (N, 6) lidar [x,y,z,l,w,h] in float32.
    geometry.py:77-88 (anchors.bv_anchor_to_lidar_np is the float64 twin)."""
    lengths = (anchors[:, 3] - anchors[:, 1]) * RES
    widths = (anchors[:, 2] - anchors[:, 0]) * RES
    xx = (anchors[:, 0] + anchors[:, 2]) / 2.0
    yy = (anchors[:, 1] + anchors[:, 3]) / 2.0
    y = Xn * RES - (xx + 0.5) * RES + TOP_Y_MIN
    x = Yn * RES - (yy + 0.5) * RES + TOP_X_MIN
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


def lidar_3d_to_corners(pts_3d):
    """(..., 6) [x,y,z,l,w,h] -> (..., 24) corners (x0..x7, y0..y7, z0..z7).
    geometry.py:110-125."""
    def signs(s):
        return torch.tensor(s, dtype=torch.float32, device=pts_3d.device) * 0.5
    xc = pts_3d[..., 3:4] * signs(_X_SIGN) + pts_3d[..., 0:1]
    yc = pts_3d[..., 4:5] * signs(_Y_SIGN) + pts_3d[..., 1:2]
    zc = pts_3d[..., 5:6] * signs(_Z_SIGN) + pts_3d[..., 2:3]
    return torch.cat([xc, yc, zc], dim=-1)


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


def lidar_cnr_to_img(corners, Tr, R0, P2):
    """Lidar corners (..., N, 24) -> image boxes (..., N, 4) [x1,y1,x2,y2].

    geometry.py:219-248 with legacy_int=True: mat = P2(3,4) @ R0(4,3) @
    Tr(3,4), a 0 homogeneous coordinate, division by depth WITHOUT abs, then
    truncation. Tr, R0, P2 are calib rows, (12,) or (..., 12) per frame:
    Tr = calib[3], R0 = calib[2], P2 = calib[0].
    """
    lead = corners.shape[:-2]
    if R0.shape[-1] == 9:   # raw 3x3 R0 -> pad the zero row the calib blob has
        R0 = torch.cat([R0, R0.new_zeros(R0.shape[:-1] + (3,))], dim=-1)
    tr = Tr[..., :12].reshape(Tr.shape[:-1] + (3, 4))
    r0 = R0[..., :12].reshape(R0.shape[:-1] + (4, 3))
    p2 = P2[..., :12].reshape(P2.shape[:-1] + (3, 4))
    mat = _mat(_mat(p2, r0), tr)                        # (..., 3, 4)
    pts = corners.reshape(lead + (corners.shape[-2], 3, 8))
    pts4 = torch.cat([pts, pts.new_zeros(pts.shape[:-2] + (1, 8))], dim=-2)
    img = _mat(mat.unsqueeze(-3), pts4)                 # (..., N, 3, 8)
    img = img / img[..., 2:3, :]                        # no abs (parity)
    xs, ys = img[..., 0, :], img[..., 1, :]
    boxes = torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)],
                        dim=-1)
    return torch.trunc(boxes)


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


def bbox_transform_3d(ex, gt):
    """6-dof regression targets of (N, 6) boxes ``ex`` toward ``gt``,
    keeping the reference's dx/width and dy/length mixing.
    geometry.py:299-310."""
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


def bbox_transform_inv_cnr(boxes_cnr, deltas):
    """Corner decode: deltas * diag + tiled base corners. geometry.py:368-375."""
    d = deltas * corner_diag(boxes_cnr)[:, None]
    k = deltas.shape[1] // 24
    return (d.reshape(-1, k, 24) + boxes_cnr[:, None, :]).reshape(deltas.shape)


def clip_boxes(boxes, im_shape):
    """Clip (..., 4K) boxes to [0, dim-1]. geometry.py:378-388."""
    h, w = im_shape[0], im_shape[1]
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    out = torch.stack([b[..., 0].clamp(0, w - 1), b[..., 1].clamp(0, h - 1),
                       b[..., 2].clamp(0, w - 1), b[..., 3].clamp(0, h - 1)],
                      dim=-1)
    return out.reshape(boxes.shape)
