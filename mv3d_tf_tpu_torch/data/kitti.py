"""The KITTI MV3D dataset (mv3d_tf_tpu/data/kitti.py:28-336, the
reference's lib/datasets/kitti_mv3d.py): paths, calib, the label reader,
the roidb cache, result writing and evaluation, host-side numpy.

Directory layout (kitti_mv3d.py:77-120):
  <kitti_path>/object/{training,testing}/{image_2,lidar_bv,calib,label_2,velodyne}
  <kitti_path>/ImageSets/<split>.txt

Annotation flow per object (kitti_mv3d.py:229-272): KITTI label line ->
camera 3D box -> yaw-rotated camera corners -> lidar corners (via the
legacy inverse extrinsics) -> lidar xyz/lwh -> BEV box.
"""

import hashlib
import os
import os.path as osp
import pickle
import time

import numpy as np

from mv3d_tf_tpu_torch import geometry_np as Gnp
from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data.imdb_base import Imdb
from mv3d_tf_tpu_torch.data.kitti_raw import KittiRaw

KITTI_SPLITS = ("train", "val", "trainval", "test")


class KittiMV3D(Imdb):
    """classes = ('__background__', 'Car') (kitti_mv3d.py:29)."""

    def __init__(self, image_set, kitti_path=None):
        super().__init__("kitti_" + image_set)
        self._image_set = image_set
        self._kitti_path = (kitti_path if kitti_path is not None
                            else osp.join(cfg.DATA_DIR, "KITTI"))
        self._data_path = osp.join(self._kitti_path, "object")
        self._classes = ("__background__", "Car")
        self._class_to_ind = {c: i for i, c in enumerate(self._classes)}
        self._image_ext = ".png"
        self._lidar_ext = ".npy"
        self._subset = "car"
        self._image_index = self._load_image_set_index()
        self._roidb_handler = self.gt_roidb
        assert osp.exists(self._kitti_path), \
            "KITTI path does not exist: " + self._kitti_path

    # -- paths ---------------------------------------------------------------
    def _prefix(self):
        return "testing" if self._image_set == "test" else "training"

    def image_path_at(self, i):
        return self.image_path_from_index(self._image_index[i])

    def image_path_from_index(self, index):
        return osp.join(self._data_path, self._prefix(), "image_2",
                        index + self._image_ext)

    def lidar_path_at(self, i):
        return osp.join(self._data_path, self._prefix(), "lidar_bv",
                        self._image_index[i] + self._lidar_ext)

    def velodyne_path_at(self, i):
        return osp.join(self._data_path, self._prefix(), "velodyne",
                        self._image_index[i] + ".bin")

    def _load_image_set_index(self):
        f = osp.join(self._kitti_path, "ImageSets", self._image_set + ".txt")
        assert osp.exists(f), "Path does not exist: " + f
        with open(f) as fh:
            return [x.strip() for x in fh.readlines() if x.strip()]

    # -- calib ---------------------------------------------------------------
    def _load_kitti_calib(self, index):
        """P2/P3/R0/Tr_velo2cam (kitti_mv3d.py:151-193)."""
        path = osp.join(self._data_path, self._prefix(), "calib",
                        index + ".txt")
        with open(path) as f:
            lines = f.readlines()
        vals = [np.array(line.strip().split(" ")[1:], np.float32)
                for line in lines if line.strip()]
        return {"P2": vals[2].reshape(3, 4),
                "P3": vals[3].reshape(3, 4),
                "R0": vals[4].reshape(3, 3),
                "Tr_velo2cam": vals[5].reshape(3, 4)}

    def calib_at(self, i):
        """(4,12) calib blob (kitti_mv3d.py:63-75)."""
        c = self._load_kitti_calib(self._image_index[i])
        calib = np.zeros((4, 12), np.float32)
        calib[0] = c["P2"].reshape(12)
        calib[1] = c["P3"].reshape(12)
        calib[2, :9] = c["R0"].reshape(9)
        calib[3] = c["Tr_velo2cam"].reshape(12)
        return calib

    # -- annotations ---------------------------------------------------------
    def _cache_key(self):
        """The dataset name and a digest of the data root and image index,
        so that a cache written for one tree never shadows another's."""
        h = hashlib.sha1()
        h.update(osp.abspath(self._kitti_path).encode())
        h.update("\n".join(self._image_index).encode())
        return "{}_{}_gt_roidb.pkl".format(self.name, h.hexdigest()[:10])

    def gt_roidb(self):
        cache_file = osp.join(self.cache_path, self._cache_key())
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                roidb = pickle.load(fid)
            if (len(roidb) == len(self._image_index)
                    and all("truncation" in e for e in roidb)):
                print("{} gt roidb loaded from {}".format(
                    self.name, cache_file))
                return roidb
            print("stale gt roidb cache ({} entries vs {} images), "
                  "rebuilding {}".format(len(roidb), len(self._image_index),
                                         cache_file))
        roidb = [self._load_kitti_annotation(idx)
                 for idx in self._image_index]
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        print("wrote gt roidb to " + cache_file)
        return roidb

    def _load_kitti_annotation(self, index):
        """One frame's labels -> its roidb entry (kitti_mv3d.py:195-306)."""
        calib = self._load_kitti_calib(index)
        Tr = calib["Tr_velo2cam"]
        path = osp.join(self._data_path, "training/label_2", index + ".txt")
        with open(path) as f:
            lines = [line for line in f.readlines() if line.strip()]

        rows = []
        for line in lines:
            obj = line.strip().split(" ")
            cls = self._class_to_ind.get(obj[0].strip())
            if cls is None:
                continue
            rows.append((cls, [float(v) for v in obj[1:15]]))

        n = len(rows)
        entry = {
            "truncation": np.zeros(n, np.float32),
            "occlusion": np.zeros(n, np.float32),
            "ry": np.zeros(n, np.float32),
            "lwh": np.zeros((n, 3), np.float32),
            "boxes": np.zeros((n, 4), np.float32),
            "boxes_bv": np.zeros((n, 4), np.float32),
            "boxes_3D_cam": np.zeros((n, 6), np.float32),
            "boxes_3D": np.zeros((n, 6), np.float32),
            "boxes3D_cam_corners": np.zeros((n, 24), np.float32),
            "boxes_corners": np.zeros((n, 24), np.float32),
            "gt_classes": np.zeros(n, np.int32),
            "gt_overlaps": np.zeros((n, self.num_classes), np.float32),
            "xyz": np.zeros((n, 3), np.float32),
            "alphas": np.zeros(n, np.float32),
            "flipped": False,
        }
        for ix, (cls, v) in enumerate(rows):
            # v = [truncated, occluded, alpha, bbox x1 y1 x2 y2, h w l,
            #      x y z, ry] (KITTI label_2 columns 1..14)
            entry["truncation"][ix] = v[0]
            entry["occlusion"][ix] = v[1]
            alpha, x1, y1, x2, y2 = v[2], v[3], v[4], v[5], v[6]
            h, w, l = v[7], v[8], v[9]
            tx, ty, tz, ry = v[10], v[11], v[12], v[13]
            entry["ry"][ix] = ry
            entry["lwh"][ix] = [l, w, h]
            entry["alphas"][ix] = alpha
            entry["xyz"][ix] = [tx, ty, tz]
            entry["boxes"][ix] = [x1, y1, x2, y2]
            cam_box = np.array([tx, ty, tz, l, w, h], np.float32)
            entry["boxes_3D_cam"][ix] = cam_box
            cam_cnr = Gnp.compute_corners_3d_np(cam_box, ry)
            entry["boxes3D_cam_corners"][ix] = cam_cnr.reshape(24)
            lidar_cnr = Gnp.camera_to_lidar_cnr_np(cam_cnr, Tr)[0]
            entry["boxes_corners"][ix] = lidar_cnr
            lidar_3d = Gnp.lidar_cnr_to_3d_np(lidar_cnr,
                                              entry["lwh"][ix])[0]
            entry["boxes_3D"][ix] = lidar_3d
            entry["boxes_bv"][ix] = Gnp.lidar_3d_to_bv_np(
                lidar_3d[None])[0]
            entry["gt_classes"][ix] = cls
            entry["gt_overlaps"][ix, cls] = 1.0
        return entry

    # -- result writing (kitti_mv3d.py:321-401) ------------------------------
    def _results_dir(self, tag):
        path = osp.join(
            cfg.ROOT_DIR, "kitti", tag,
            "kitti_{}_{}_-{}".format(self._subset, self._image_set,
                                     time.strftime("%m-%d-%H-%M-%S")),
            "data")
        os.makedirs(path, exist_ok=True)
        return path

    def _write_kitti_results_file(self, all_boxes):
        """KITTI server format: 2D image boxes, -1 for the rest
        (kitti_mv3d.py:321-352)."""
        path = self._results_dir("results")
        for im_ind, index in enumerate(self._image_index):
            with open(osp.join(path, index + ".txt"), "wt") as f:
                for cls_ind, cls in enumerate(self._classes):
                    if cls == "__background__":
                        continue
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        f.write("{:s} -1 -1 {:.2f} {:.2f} {:.2f} {:.2f} "
                                "{:.2f} -1 -1 -1 -1 -1 -1 -1 -1\n".format(
                                    cls.lower(), 0.0, dets[k, 0], dets[k, 1],
                                    dets[k, 2], dets[k, 3]))
        return path

    def evaluate_detections(self, all_boxes, all_boxes3D, output_dir=None,
                            all_boxes_cnr_r=None):
        """Writes the KITTI result files and prints BEV AP at IoU 0.7 and
        0.5 (data/kitti_eval.py), the official-protocol table on the
        unregressed corners the reference pickles (test_mv.py:434,489), and
        with all_boxes_cnr_r a quality-mode table on the regressed corners
        with the translation-keeping projection (kitti.py:243-278)."""
        path = self._write_kitti_results_file(all_boxes)
        if self._image_set != "test":
            from mv3d_tf_tpu_torch.data.kitti_eval import (
                evaluate_kitti_bev, evaluate_kitti_official)
            for thresh in (0.7, 0.5):
                res = evaluate_kitti_bev(self, all_boxes, iou_thresh=thresh)
                print("BEV AP@{:.1f} (car, R40): {:.4f}  [{} gt]".format(
                    thresh, res["ap"], res["num_gt"]))
            if all_boxes3D is not None:
                evaluate_kitti_official(self, all_boxes, all_boxes3D)
            if all_boxes_cnr_r is not None:
                evaluate_kitti_official(
                    self, all_boxes, all_boxes_cnr_r,
                    projection="proper", derive_bev_from_corners=True,
                    label="quality mode (regressed corners)")
        return path


def prepare_roidb(imdb):
    """Enrich roidb entries for training (lib/roi_data_layer/roidb.py:16-58)."""
    for i, entry in enumerate(imdb.roidb):
        entry["image_path"] = imdb.image_path_at(i)
        entry["lidar_bv_path"] = imdb.lidar_path_at(i)
        entry["calib"] = imdb.calib_at(i)
        overlaps = entry["gt_overlaps"]
        entry["max_classes"] = overlaps.argmax(axis=1)
        entry["max_overlaps"] = overlaps.max(axis=1)
        nonzero = np.where(entry["max_overlaps"] > 0)[0]
        assert all(entry["max_classes"][nonzero] != 0)
    return imdb.roidb


_IMDB_FACTORY = {}


def get_imdb(name, kitti_path=None, devkit_path=None):
    """datasets.factory.get_imdb (lib/datasets/factory.py:29-85, the JAX
    package's data/kitti.py:299-336): kitti_{train,val,trainval,test},
    kitti_raw_<sequence> (a sequence directory under kitti_path,
    data/kitti_raw.py), kitti_tracking_<split>_<sequence> (under
    kitti_path), kitti2d_<split> (data/kitti_2d.py, under kitti_path),
    voc_<year>_<split> (data/pascal_voc.py, under devkit_path),
    coco_<year>_<split> and nissan / nthu (under kitti_path, else
    devkit_path), pascal3d_<split> and imagenet3d_<split> (under
    devkit_path; data/extra_datasets.py); one instance per name and data
    root (the JAX package keys by name alone, so a second root would get
    the first one's imdb)."""
    if name.startswith(("voc_", "pascal3d_", "imagenet3d_")):
        root = devkit_path
    elif name.startswith("coco_") or name in ("nissan", "nthu"):
        root = kitti_path or devkit_path
    else:
        root = kitti_path
    key = (name, None if root is None else osp.abspath(root))
    if key in _IMDB_FACTORY:
        return _IMDB_FACTORY[key]
    split = name[len("kitti_"):] if name.startswith("kitti_") else None
    # the kitti_raw_ and kitti_tracking_ names come before the kitti_ splits
    if name.startswith("kitti_raw_"):
        imdb = KittiRaw(name[len("kitti_raw_"):], root=kitti_path)
    elif name.startswith("kitti_tracking_"):
        from mv3d_tf_tpu_torch.data.extra_datasets import KittiTracking
        _, _, image_set, seq = name.split("_", 3)
        imdb = KittiTracking(image_set, seq, root=root)
    elif name.startswith("kitti2d_"):
        from mv3d_tf_tpu_torch.data.kitti_2d import Kitti2D
        imdb = Kitti2D(name[len("kitti2d_"):], kitti_path=kitti_path)
    elif split in KITTI_SPLITS:
        imdb = KittiMV3D(split, kitti_path=kitti_path)
    elif name.startswith("voc_"):
        from mv3d_tf_tpu_torch.data.pascal_voc import PascalVOC
        _, year, image_set = name.split("_", 2)
        imdb = PascalVOC(image_set, year, devkit_path)
    elif name.startswith("coco_"):
        from mv3d_tf_tpu_torch.data.extra_datasets import Coco
        _, year, image_set = name.split("_", 2)
        imdb = Coco(image_set, year, data_path=root)
    elif name.startswith("pascal3d_"):
        from mv3d_tf_tpu_torch.data.extra_datasets import Pascal3D
        imdb = Pascal3D(name[len("pascal3d_"):], root)
    elif name.startswith("imagenet3d_"):
        from mv3d_tf_tpu_torch.data.extra_datasets import Imagenet3D
        imdb = Imagenet3D(name[len("imagenet3d_"):], root)
    elif name in ("nissan", "nthu"):
        from mv3d_tf_tpu_torch.data.extra_datasets import ImageListDataset
        imdb = ImageListDataset(name, image_dir=root)
    else:
        raise KeyError(
            "Unknown dataset: {} (kitti_{{{}}}, kitti_raw_<sequence>, "
            "kitti_tracking_<split>_<sequence>, kitti2d_<split>, "
            "voc_<year>_<split>, coco_<year>_<split>, pascal3d_<split>, "
            "imagenet3d_<split>, nissan, nthu)".format(
                name, ",".join(KITTI_SPLITS)))
    _IMDB_FACTORY[key] = imdb
    return imdb
