"""The KITTI raw-sequence dataset (mv3d_tf_tpu/data/kitti_raw.py, the
reference's lib/datasets/kitti_raw.py): the kitti_mv3d layout variant whose
ground truth comes from per-frame .npy corner files (written by
tools/tracklet2label.py) instead of label_2 text. Host-side numpy.

Layout:
  <root>/<sequence>/velodyne/<frame>.bin
  <root>/<sequence>/lidar_bv/<frame>.npy
  <root>/<sequence>/image_2/<frame>.png
  <root>/<sequence>/gt_boxes3d/<frame>.npy     (N, 24) lidar corners
  <root>/<sequence>/calib.txt                  (sequence-wide calib)

The roidb has no 2D image boxes (zeros) and no truncation or occlusion,
so it trains (solver.train_net) but does not take the official-protocol
evaluation, whose difficulty levels need them.
"""

import os
import os.path as osp

import numpy as np

from mv3d_tf_tpu_torch import geometry_np as Gnp
from mv3d_tf_tpu_torch.data.imdb_base import Imdb


class KittiRaw(Imdb):
    def __init__(self, sequence, root):
        super().__init__("kitti_raw_" + sequence)
        self._root = osp.join(root, sequence)
        self._classes = ("__background__", "Car")
        self._image_index = sorted(
            f[:-4] for f in os.listdir(osp.join(self._root, "gt_boxes3d"))
            if f.endswith(".npy"))
        self._roidb_handler = self.gt_roidb

    def image_path_at(self, i):
        return osp.join(self._root, "image_2",
                        self._image_index[i] + ".png")

    def lidar_path_at(self, i):
        return osp.join(self._root, "lidar_bv",
                        self._image_index[i] + ".npy")

    def velodyne_path_at(self, i):
        return osp.join(self._root, "velodyne",
                        self._image_index[i] + ".bin")

    def calib_at(self, i):
        """(4, 12) float32: P2, P3, R0 (9 of 12), Tr_velo_to_cam, from the
        sequence's calib.txt (its 3rd to 6th non-empty lines)."""
        with open(osp.join(self._root, "calib.txt")) as f:
            lines = [line for line in f.readlines() if line.strip()]
        vals = [np.array(line.strip().split(" ")[1:], np.float32)
                for line in lines]
        calib = np.zeros((4, 12), np.float32)
        calib[0] = vals[2][:12]
        calib[1] = vals[3][:12]
        calib[2, :9] = vals[4][:9]
        calib[3] = vals[5][:12]
        return calib

    def gt_roidb(self):
        roidb = []
        for idx in self._image_index:
            corners = np.load(osp.join(self._root, "gt_boxes3d",
                                       idx + ".npy")).reshape(-1, 24)
            n = corners.shape[0]
            # lwh from the corner extents (axis-aligned, as
            # lidar_cnr_to_3d is fed)
            c = corners.reshape(n, 3, 8)
            lwh = np.stack([c[:, 0].max(1) - c[:, 0].min(1),
                            c[:, 1].max(1) - c[:, 1].min(1),
                            c[:, 2].max(1) - c[:, 2].min(1)], axis=1)
            boxes_3d = Gnp.lidar_cnr_to_3d_np(corners, lwh)
            boxes_bv = Gnp.lidar_3d_to_bv_np(boxes_3d[:, :6])
            roidb.append({
                "boxes_corners": corners.astype(np.float32),
                "boxes_3D": boxes_3d.astype(np.float32),
                "boxes_bv": boxes_bv.astype(np.float32),
                "boxes": np.zeros((n, 4), np.float32),
                "gt_classes": np.ones(n, np.int32),
                "gt_overlaps": np.tile([0.0, 1.0], (n, 1)).astype(np.float32),
                "flipped": False,
            })
        return roidb
