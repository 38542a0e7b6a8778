"""Anchor grid: a numpy copy of mv3d_tf_tpu/anchors.py:18-133 that takes its
constants from this package's geometry module, so it loads without jax.
``generate_anchors`` gives the legacy 2D path's 9 scale/ratio anchors.

The BEV anchors and their shifted grid depend only on the feature-map
shape; the table is built once per shape and cached. Anchor order is
location-major, anchor-minor, matching the score reshape
[1,H,W,A,2][...,1] -> (H*W*A,) and the delta reshape (-1,6).
"""

import functools

import numpy as np

from mv3d_tf_tpu_torch.geometry import (CAR_HEIGHT, LIDAR_HEIGHT, RES,
                                        TOP_X_MIN, TOP_Y_MIN, Xn, Yn)


def generate_anchors_bv(base_size=((3.9, 1.6), (1.0, 0.6)), res=0.1):
    """BEV anchor priors: car 3.9x1.6 m and small 1.0x0.6 m, two
    orientations each; int() truncates meters/res like the reference
    (3.9/0.1 -> 38)."""
    base_anchors = np.vstack(
        [[0, 0, int(base[0] / res), int(base[1] / res)] for base in base_size])
    base_anchors[:, 0] -= base_anchors[:, 2] // 2
    base_anchors[:, 1] -= base_anchors[:, 3] // 2
    base_anchors[:, 2] -= base_anchors[:, 2] // 2
    base_anchors[:, 3] -= base_anchors[:, 3] // 2
    return np.vstack((base_anchors, base_anchors[:, [1, 0, 3, 2]]))


def generate_anchors(base_size=16, ratios=(0.5, 1, 2),
                     scales=2 ** np.arange(3, 6)):
    """The classic Faster R-CNN anchors, 3 ratios x 3 scales (anchors.py:34-41,
    the reference's generate_anchors.py:53-113)."""
    base_anchor = np.array([1, 1, base_size, base_size]) - 1
    ratio_anchors = _ratio_enum(base_anchor, np.array(ratios, np.float64))
    return np.vstack([_scale_enum(ratio_anchors[i, :], np.array(scales))
                      for i in range(ratio_anchors.shape[0])])


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack((x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)))


def _ratio_enum(anchor, ratios):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = np.round(np.sqrt(w * h / ratios))
    return _mkanchors(ws, np.round(ws * ratios), x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    return _mkanchors(w * scales, h * scales, x_ctr, y_ctr)


def shift_anchors(base_anchors, height, width, feat_stride):
    """The (K*A, 4) shifted anchor grid, location-major."""
    shift_x, shift_y = np.meshgrid(np.arange(0, width) * feat_stride,
                                   np.arange(0, height) * feat_stride)
    shifts = np.vstack((shift_x.ravel(), shift_y.ravel(),
                        shift_x.ravel(), shift_y.ravel())).transpose()
    A = base_anchors.shape[0]
    K = shifts.shape[0]
    all_anchors = (base_anchors.reshape(1, A, 4)
                   + shifts.reshape(1, K, 4).transpose(1, 0, 2))
    return all_anchors.reshape(K * A, 4).astype(np.float32)


def bv_anchor_to_lidar_np(anchors):
    """BEV anchors (N,4 px) -> 3D lidar boxes (N,6 m), computed in float64."""
    a = anchors.astype(np.float64)
    lengths = (a[:, 3] - a[:, 1]) * RES
    widths = (a[:, 2] - a[:, 0]) * RES
    cxx = (a[:, 0] + a[:, 2]) / 2.0
    cyy = (a[:, 1] + a[:, 3]) / 2.0
    y = Xn * RES - (cxx + 0.5) * RES + TOP_Y_MIN
    x = Yn * RES - (cyy + 0.5) * RES + TOP_X_MIN
    z = np.full_like(x, -(LIDAR_HEIGHT - CAR_HEIGHT / 2.0))
    h = np.full_like(x, CAR_HEIGHT)
    return np.stack([x, y, z, lengths, widths, h], axis=1).astype(np.float32)


def inside_image_mask(all_anchors, im_height, im_width, allowed_border=0):
    """Boolean mask of anchors fully inside the image."""
    return ((all_anchors[:, 0] >= -allowed_border)
            & (all_anchors[:, 1] >= -allowed_border)
            & (all_anchors[:, 2] < im_width + allowed_border)
            & (all_anchors[:, 3] < im_height + allowed_border))


class AnchorGrid:
    """Static per-shape anchor tables."""

    def __init__(self, height, width, feat_stride=8,
                 im_height=601, im_width=601):
        self.height = height
        self.width = width
        self.feat_stride = feat_stride
        self.base = generate_anchors_bv()
        self.num_anchors = self.base.shape[0]              # A = 4
        self.anchors_bv = shift_anchors(self.base, height, width, feat_stride)
        self.anchors_3d = bv_anchor_to_lidar_np(self.anchors_bv)
        self.total = self.anchors_bv.shape[0]              # K*A
        self.inside = inside_image_mask(self.anchors_bv, im_height, im_width)


@functools.lru_cache(maxsize=None)
def get_anchor_grid(height, width, feat_stride=8, im_height=601, im_width=601):
    return AnchorGrid(height, width, feat_stride, im_height, im_width)
