"""Grid region proposals, the port's copy of mv3d_tf_tpu/data/boxes_grid.py
(the reference's lib/utils/boxes_grid.py, SubCNN).

get_boxes_grid tiles aspect-ratio boxes over the network's heatmap and
scales them back to image coordinates; the multiscale (IS_MULTISCALE)
data path rates gt coverage against this grid
(kitti_tracking.py:241-260, pascal3d.py:196-226).

The reference reads KERNEL_SIZE / ASPECTS / SPATIAL_SCALE from cfg keys
that its shipped config comments out (lib/fast_rcnn/config.py:50-56), so
here they are explicit arguments with the documented defaults; cfg
overrides still apply when the keys exist (cfg_from_file can add them).
"""

import math

import numpy as np

from mv3d_tf_tpu_torch.config import cfg


def _heatmap_hw(image_height, image_width, scale, net_name):
    """Heatmap extent for the given net's downsampling chain
    (boxes_grid.py:17-36)."""
    if net_name == "CaffeNet":
        h = np.floor((image_height * scale - 1) / 4.0 + 1)
        h = np.floor((h - 1) / 2.0 + 1 + 0.5)
        h = np.floor((h - 1) / 2.0 + 1 + 0.5)
        w = np.floor((image_width * scale - 1) / 4.0 + 1)
        w = np.floor((w - 1) / 2.0 + 1 + 0.5)
        w = np.floor((w - 1) / 2.0 + 1 + 0.5)
    elif net_name == "VGGnet":
        h = np.floor(image_height * scale / 2.0 + 0.5)
        for _ in range(3):
            h = np.floor(h / 2.0 + 0.5)
        w = np.floor(image_width * scale / 2.0 + 0.5)
        for _ in range(3):
            w = np.floor(w / 2.0 + 0.5)
    else:
        raise ValueError("unsupported net_name: " + net_name)
    return int(h), int(w)


def get_boxes_grid(image_height, image_width, scale=None, kernel_size=None,
                   aspects=None, spatial_scale=None, net_name=None):
    """Boxes on the image grid (boxes_grid.py:12-70).

    Returns (boxes_grid (N*A, 4), centers_x, centers_y) where each
    heatmap cell spawns one box per aspect with area kernel_size^2
    (heatmap units), mapped to image pixels by /spatial_scale.
    """
    scale = (max(cfg.TRAIN.SCALES_BASE) if scale is None else scale)
    kernel_size = (getattr(cfg.TRAIN, "KERNEL_SIZE", 5)
                   if kernel_size is None else kernel_size)
    aspects = (tuple(getattr(cfg.TRAIN, "ASPECTS", (1, 0.75, 0.5, 0.25)))
               if aspects is None else tuple(aspects))
    spatial_scale = (getattr(cfg.TRAIN, "SPATIAL_SCALE", 0.0625)
                     if spatial_scale is None else spatial_scale)
    net_name = (getattr(cfg, "NET_NAME", "VGGnet")
                if net_name is None else net_name)

    height, width = _heatmap_hw(image_height, image_width, scale, net_name)

    y, x = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    centers = np.reshape(np.dstack((x, y)), (-1, 2))
    num = centers.shape[0]

    area = kernel_size * kernel_size
    num_aspect = len(aspects)
    widths = np.zeros((1, num_aspect), np.float32)
    heights = np.zeros((1, num_aspect), np.float32)
    for i, aspect in enumerate(aspects):      # aspect = height / width
        widths[0, i] = math.sqrt(area / aspect)
        heights[0, i] = widths[0, i] * aspect

    centers = np.repeat(centers, num_aspect, axis=0)
    widths = np.tile(widths, num).transpose()
    heights = np.tile(heights, num).transpose()

    x1 = np.reshape(centers[:, 0], (-1, 1)) - widths * 0.5
    x2 = np.reshape(centers[:, 0], (-1, 1)) + widths * 0.5
    y1 = np.reshape(centers[:, 1], (-1, 1)) - heights * 0.5
    y2 = np.reshape(centers[:, 1], (-1, 1)) + heights * 0.5

    boxes_grid = np.hstack((x1, y1, x2, y2)) / spatial_scale
    return boxes_grid, centers[:, 0], centers[:, 1]
