"""KITTI for the legacy 2D path (mv3d_tf_tpu/data/kitti_2d.py, the
reference's lib/datasets/kitti.py): camera 2D boxes of Car (Van remapped),
Pedestrian and Cyclist, the load-time difficulty filter, the gt roidb
cache, the KITTI result writers, and the per-class 2D AP at easy, moderate
and hard on the port's data/kitti_eval.py (the reference only writes the
files). Host-side numpy.
"""

import hashlib
import os
import os.path as osp
import pickle

import numpy as np

from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data.imdb_base import Imdb
from mv3d_tf_tpu_torch.data.kitti_eval import (evaluate_ap_difficulty,
                                               gt_levels, iou_2d)

# KITTI's per-class match thresholds (the official evaluate_object)
CLASS_IOU = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}


class Kitti2D(Imdb):
    """kitti2d_<split>: <kitti_path>/object/{training,testing}/image_2 and
    label_2, <kitti_path>/ImageSets/<split>.txt (kitti_2d.py:39-67)."""

    def __init__(self, image_set, kitti_path=None):
        super().__init__("kitti2d_" + image_set)
        self._image_set = image_set
        self._kitti_path = (kitti_path if kitti_path is not None
                            else osp.join(cfg.DATA_DIR, "KITTI"))
        self._data_path = osp.join(self._kitti_path, "object")
        self._classes = ("__background__", "Car", "Pedestrian", "Cyclist")
        self._class_to_ind = {c: i for i, c in enumerate(self._classes)}
        self._image_index = self._load_image_set_index()
        self._roidb_handler = self.gt_roidb
        assert osp.exists(self._kitti_path), \
            "KITTI path does not exist: " + self._kitti_path

    def _prefix(self):
        return "testing" if self._image_set == "test" else "training"

    def image_path_at(self, i):
        return osp.join(self._data_path, self._prefix(), "image_2",
                        self._image_index[i] + ".png")

    def _load_image_set_index(self):
        f = osp.join(self._kitti_path, "ImageSets", self._image_set + ".txt")
        assert osp.exists(f), "Path does not exist: " + f
        with open(f) as fh:
            return [x.strip() for x in fh.readlines() if x.strip()]

    def _cache_key(self):
        """The cache name, keyed by the data root and the split's index
        (kitti_2d.py:69-74)."""
        h = hashlib.sha1()
        h.update(osp.abspath(self._kitti_path).encode())
        h.update("\n".join(self._image_index).encode())
        return "{}_{}_gt_roidb.pkl".format(self.name, h.hexdigest()[:10])

    def gt_roidb(self):
        cache_file = osp.join(self.cache_path, self._cache_key())
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                roidb = pickle.load(fid)
            if len(roidb) == len(self._image_index):
                print("{} gt roidb loaded from {}".format(self.name,
                                                          cache_file))
                return roidb
        roidb = [self._load_annotation(idx) for idx in self._image_index]
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_annotation(self, index):
        """A label_2 file -> a roidb entry (kitti_2d.py:90-126): Van read as
        Car; kept when truncation < 0.5, occlusion < 3 and the 2D height >
        25 px; no labels for the test split."""
        lines = []
        if self._image_set != "test":
            path = osp.join(self._data_path, "training", "label_2",
                            index + ".txt")
            with open(path) as f:
                for line in f:
                    words = line.replace("Van", "Car").split()
                    if not words:
                        continue
                    height = float(words[7]) - float(words[5])
                    if (words[0] in self._class_to_ind
                            and float(words[1]) < 0.5
                            and int(float(words[2])) < 3 and height > 25):
                        lines.append(words)
        n = len(lines)
        boxes = np.zeros((n, 4), np.float32)
        gt_classes = np.zeros(n, np.int32)
        overlaps = np.zeros((n, self.num_classes), np.float32)
        trunc = np.zeros(n, np.float32)
        occ = np.zeros(n, np.float32)
        for ix, words in enumerate(lines):
            cls = self._class_to_ind[words[0]]
            boxes[ix] = [float(v) for v in words[4:8]]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
            trunc[ix] = float(words[1])
            occ[ix] = float(words[2])
        return {"boxes": boxes, "gt_classes": gt_classes,
                "gt_overlaps": overlaps, "truncation": trunc,
                "occlusion": occ, "flipped": False}

    def write_kitti_results(self, all_boxes, output_dir):
        """One KITTI txt per image: alpha -10, the 3D fields -1, the score
        last (kitti_2d.py:128-145)."""
        os.makedirs(output_dir, exist_ok=True)
        for im_ind, index in enumerate(self._image_index):
            with open(osp.join(output_dir, index + ".txt"), "wt") as f:
                for cls_ind, cls in enumerate(self._classes[1:], start=1):
                    dets = np.asarray(all_boxes[cls_ind][im_ind],
                                      np.float32).reshape(-1, 5)
                    for d in dets:
                        f.write("{:s} -1 -1 {:f} {:f} {:f} {:f} {:f} -1 -1 "
                                "-1 -1 -1 -1 -1 {:.32f}\n".format(
                                    cls, -10.0, d[0], d[1], d[2], d[3], d[4]))
        return output_dir

    def write_kitti_results_one_file(self, all_boxes, output_dir):
        """All detections in one detections.txt, subclass -1
        (kitti_2d.py:147-164)."""
        os.makedirs(output_dir, exist_ok=True)
        path = osp.join(output_dir, "detections.txt")
        with open(path, "wt") as f:
            for im_ind, index in enumerate(self._image_index):
                for cls_ind, cls in enumerate(self._classes[1:], start=1):
                    dets = np.asarray(all_boxes[cls_ind][im_ind],
                                      np.float32).reshape(-1, 5)
                    for d in dets:
                        f.write("{:s} {:s} {:f} {:f} {:f} {:f} {:d} {:f}\n"
                                .format(index, cls, d[0], d[1], d[2], d[3],
                                        -1, d[4]))
        return path

    def evaluate_detections(self, all_boxes, output_dir):
        """Write both result forms, then each class's 2D AP at easy,
        moderate and hard with the official difficulty levels at
        CLASS_IOU (kitti_2d.py:166-200); {} for the test split."""
        self.write_kitti_results(all_boxes, output_dir)
        self.write_kitti_results_one_file(all_boxes, output_dir)
        if self._image_set == "test":
            return {}
        table = {}
        for cls_ind, cls in enumerate(self._classes[1:], start=1):
            frames = []
            for i in range(self.num_images):
                e = self.roidb[i]
                m = e["gt_classes"] == cls_ind
                g = e["boxes"][m]
                dets = np.asarray(all_boxes[cls_ind][i],
                                  np.float32).reshape(-1, 5)
                frames.append({
                    "dets": dets[:, :4], "scores": dets[:, 4],
                    "det_heights": dets[:, 3] - dets[:, 1] + 1,
                    "gts": g,
                    "levels": gt_levels(g, e["truncation"][m],
                                        e["occlusion"][m]),
                    "iou": iou_2d})
            table[cls] = {
                d: evaluate_ap_difficulty(frames, CLASS_IOU[cls], d)["ap"]
                for d in ("easy", "moderate", "hard")}
            print("2D AP {:>10s}: easy {:.4f} moderate {:.4f} "
                  "hard {:.4f}".format(cls, table[cls]["easy"],
                                       table[cls]["moderate"],
                                       table[cls]["hard"]))
        return table
