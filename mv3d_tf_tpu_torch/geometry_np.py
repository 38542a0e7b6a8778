"""Numpy twins of the geometry functions that host code runs: the label
reader (data/kitti.py), the synthetic generator (data/synthetic.py) and the
evaluator. The port's own copy of mv3d_tf_tpu/geometry_np.py, with the same
float32 arithmetic; the constants are the port's geometry.py's.
"""

import numpy as np

from mv3d_tf_tpu_torch.geometry import (CAR_HEIGHT, LIDAR_HEIGHT, RES,
                                        TOP_X_MIN, TOP_Y_MIN, Xn, Yn)


def lidar_to_bv_coord_np(x, y):
    """geometry.lidar_to_bv_coord (transform.py:13-20)."""
    xx = Yn - np.floor((y - TOP_Y_MIN) / RES)
    yy = Xn - np.floor((x - TOP_X_MIN) / RES)
    return xx, yy


def lidar_3d_to_bv_np(rois_3d):
    """geometry.lidar_3d_to_bv (transform.py:113-142)."""
    r = np.asarray(rois_3d, np.float32).reshape(-1, 6)
    a = r[:, 0] + r[:, 3] * np.float32(0.5)
    b = r[:, 1] + r[:, 4] * np.float32(0.5)
    c = r[:, 0] - r[:, 3] * np.float32(0.5)
    d = r[:, 1] - r[:, 4] * np.float32(0.5)
    x1, y1 = lidar_to_bv_coord_np(a, b)
    x2, y2 = lidar_to_bv_coord_np(c, d)
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)


def lidar_cnr_to_3d_np(corners, lwh):
    """geometry.lidar_cnr_to_3d (transform.py:172-187)."""
    c = np.asarray(corners, np.float32).reshape(-1, 3, 8)
    ctr = c.mean(axis=2)
    return np.concatenate(
        [ctr, np.asarray(lwh, np.float32).reshape(-1, 3)], axis=1)


def compute_corners_3d_np(box3d, ry):
    """geometry.compute_corners_3d (transform.py:441-465)."""
    b = np.asarray(box3d, np.float32)
    cos, sin = np.float32(np.cos(ry)), np.float32(np.sin(ry))
    R = np.array([[cos, 0.0, sin], [0.0, 1.0, 0.0], [-sin, 0.0, cos]],
                 np.float32)
    l, w, h = b[3], b[4], b[5]
    x_c = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32) * (l / 2)
    y_c = np.array([0, 0, 0, 0, -1, -1, -1, -1], np.float32) * h
    z_c = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32) * (w / 2)
    corners = R @ np.stack([x_c, y_c, z_c])
    return corners + b[0:3, None]


def _legacy_inverse_rt_np(Tr):
    """geometry._legacy_inverse_rt (transform.py:513-519)."""
    Tr = np.asarray(Tr, np.float32).reshape(3, 4)
    R = np.linalg.inv(Tr[:, :3].astype(np.float64)).astype(np.float32)
    T = np.array([-Tr[1, 3], -Tr[2, 3], Tr[0, 3]], np.float32)[:, None]
    return np.concatenate([R, T], axis=1)


def camera_to_lidar_cnr_np(pts_3d, Tr):
    """geometry.camera_to_lidar_cnr (transform.py:502-524)."""
    pts_3d = np.asarray(pts_3d, np.float32)
    if pts_3d.ndim == 2 and pts_3d.shape == (3, 8):
        pts_3d = pts_3d.reshape(1, 24)
    pts = pts_3d.reshape(-1, 3, 8)
    pts4 = np.concatenate(
        [pts, np.zeros((pts.shape[0], 1, 8), np.float32)], axis=1)
    RT = _legacy_inverse_rt_np(Tr)
    lidar = np.einsum("ij,njk->nik", RT, pts4)
    return lidar.reshape(-1, 24).astype(np.float32)


def bv_anchor_to_lidar_np(anchors):
    """geometry.bv_anchor_to_lidar (transform.py:89-111)."""
    a = np.asarray(anchors, np.float32)
    ex_lengths = (a[:, 3] - a[:, 1]) * np.float32(RES)
    ex_widths = (a[:, 2] - a[:, 0]) * np.float32(RES)
    ex_ctr_xx = (a[:, 0] + a[:, 2]) / 2.0
    ex_ctr_yy = (a[:, 1] + a[:, 3]) / 2.0
    y = np.float32(Xn * RES) - (ex_ctr_xx + 0.5) * np.float32(RES) \
        + np.float32(TOP_Y_MIN)
    x = np.float32(Yn * RES) - (ex_ctr_yy + 0.5) * np.float32(RES) \
        + np.float32(TOP_X_MIN)
    ex_heights = np.full_like(ex_lengths, CAR_HEIGHT)
    ex_ctr_z = np.full_like(ex_lengths, -(LIDAR_HEIGHT - CAR_HEIGHT / 2.0))
    return np.stack([x, y, ex_ctr_z, ex_lengths, ex_widths, ex_heights],
                    axis=1)


def project_to_image_np(pts_3d, P):
    """geometry.project_to_image (transform.py:317-340): 3xN camera-frame
    points -> 2xN image px via 3x4 P with homogeneous 1."""
    pts_3d = np.asarray(pts_3d, np.float32)
    mat = np.concatenate(
        [pts_3d, np.ones((1, pts_3d.shape[1]), np.float32)])
    p2 = np.asarray(P, np.float32).reshape(3, 4) @ mat
    return p2[:2] / p2[2:3]
