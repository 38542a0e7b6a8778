"""Dataset box helpers (mv3d_tf_tpu/data/ds_utils.py, the reference's
lib/datasets/ds_utils.py:9-41), numpy: dedup by coordinate hash,
xywh <-> xyxy, bounds validation and the min-size filter."""

import numpy as np


def unique_boxes(boxes, scale=1.0):
    """Sorted indices of unique boxes by the hash round(box * scale) .
    [1, 1e3, 1e6, 1e9] (ds_utils.py:9-15)."""
    hashes = np.round(boxes * scale).dot(np.array([1, 1e3, 1e6, 1e9]))
    _, index = np.unique(hashes, return_index=True)
    return np.sort(index)


def xywh_to_xyxy(boxes):
    """[x y w h] -> [x1 y1 x2 y2], inclusive corners (ds_utils.py:17-19)."""
    return np.hstack((boxes[:, 0:2], boxes[:, 0:2] + boxes[:, 2:4] - 1))


def xyxy_to_xywh(boxes):
    """[x1 y1 x2 y2] -> [x y w h] (ds_utils.py:21-23)."""
    return np.hstack((boxes[:, 0:2], boxes[:, 2:4] - boxes[:, 0:2] + 1))


def validate_boxes(boxes, width=0, height=0):
    """Assert that every box is well formed and inside [0,width) x
    [0,height) (ds_utils.py:25-36)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    assert (x1 >= 0).all()
    assert (y1 >= 0).all()
    assert (x2 >= x1).all()
    assert (y2 >= y1).all()
    assert (x2 < width).all()
    assert (y2 < height).all()


def filter_small_boxes(boxes, min_size):
    """Indices of the boxes with w >= min_size and h > min_size: the
    asymmetric pair is the reference's (ds_utils.py:38-41)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    return np.where((w >= min_size) & (h > min_size))[0]
