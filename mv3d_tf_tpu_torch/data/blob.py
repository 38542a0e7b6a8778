"""The LiDAR blob helper of mv3d_tf_tpu/data/blob.py:36-44
(``make_bird_view``). The image helpers beside it there serve the legacy 2D
path and wait for it (ROADMAP.md, Queue 1 item 8)."""

from mv3d_tf_tpu_torch.ops import bev as bev_ops


def make_bird_view(velodyne_path, device="cuda"):
    """A velodyne .bin -> its (601, 601, 9) float32 BEV raster as a tensor
    on ``device`` (the card unless the caller asks for another), padded to
    the 131072-point bucket and rasterized by point_cloud_2_top_batch: the
    CUDA placement kernel on the card, the plain scatter on the CPU."""
    pts, valid = bev_ops.pad_points(bev_ops.load_velodyne(velodyne_path))
    return bev_ops.point_cloud_2_top_batch(pts[None], valid[None],
                                           device=device)[0]
