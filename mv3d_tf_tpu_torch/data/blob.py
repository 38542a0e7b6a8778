"""Blob helpers (mv3d_tf_tpu/data/blob.py, the reference's
lib/utils/blob.py): the legacy 2D path's image scaling and padding, in
numpy with Pillow, and the LiDAR ``make_bird_view`` on the port's BEV
rasterizer."""

import numpy as np

from mv3d_tf_tpu_torch.ops import bev as bev_ops


def prep_im_for_blob(im, pixel_means, target_size, max_size):
    """Mean-subtract, then scale so the short side is target_size unless the
    long side would pass max_size (blob.py:8-24). Each channel is resized by
    Pillow's mode-F bilinear, as in the JAX package. Returns (im float32,
    scale)."""
    from PIL import Image
    im = im.astype(np.float32, copy=False) - pixel_means
    h, w = im.shape[:2]
    im_scale = float(target_size) / float(min(h, w))
    if round(im_scale * max(h, w)) > max_size:
        im_scale = float(max_size) / float(max(h, w))
    new_w = int(round(w * im_scale))
    new_h = int(round(h * im_scale))
    chans = [np.asarray(Image.fromarray(im[:, :, c]).resize(
        (new_w, new_h), Image.BILINEAR)) for c in range(im.shape[2])]
    return np.stack(chans, axis=2), im_scale


def im_list_to_blob(ims):
    """Zero-pad a list of (H, W, 3) images into one (N, Hmax, Wmax, 3)
    float32 blob (blob.py:27-33)."""
    max_shape = np.array([im.shape for im in ims]).max(axis=0)
    blob = np.zeros((len(ims), max_shape[0], max_shape[1], 3), np.float32)
    for i, im in enumerate(ims):
        blob[i, :im.shape[0], :im.shape[1], :] = im
    return blob


def make_bird_view(velodyne_path, device="cuda"):
    """A velodyne .bin -> its (601, 601, 9) float32 BEV raster as a tensor
    on ``device`` (the card unless the caller asks for another), padded to
    the 131072-point bucket and rasterized by point_cloud_2_top_batch: the
    CUDA placement kernel on the card, the plain scatter on the CPU."""
    pts, valid = bev_ops.pad_points(bev_ops.load_velodyne(velodyne_path))
    return bev_ops.point_cloud_2_top_batch(pts[None], valid[None],
                                           device=device)[0]
