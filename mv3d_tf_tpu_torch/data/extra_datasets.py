"""The remaining 2D dataset families, the port's copy of
mv3d_tf_tpu/data/extra_datasets.py (the reference's
lib/datasets/kitti_tracking.py, coco.py, nissan.py, nthu.py, pascal3d.py
and imagenet3d.py), host numpy.

* KittiTracking: KITTI tracking sequences (per-sequence label_02 txt with
  frame-indexed object rows) exposed frame-by-frame like kitti_mv3d.
* Coco: COCO instances JSON parsed with the stdlib json module (no
  pycocotools dependency); detection results written in COCO format.
* Nissan / NTHU: image-list drive sequences for inference/demo (the
  reference versions carry no usable gt either).
* Pascal3D / Imagenet3D: VOC-style XML detection with the 12 rigid
  categories (viewpoint metadata parsed when present).
"""

import json
import os
import os.path as osp

import numpy as np

from mv3d_tf_tpu_torch.data.imdb_base import Imdb
from mv3d_tf_tpu_torch.data.pascal_voc import PascalVOC

PASCAL3D_CLASSES = ("__background__",
                    "aeroplane", "bicycle", "boat", "bottle", "bus", "car",
                    "chair", "diningtable", "motorbike", "sofa", "train",
                    "tvmonitor")


class KittiTracking(Imdb):
    """kitti_tracking_<split>_<seq> (lib/datasets/kitti_tracking.py):
    <root>/<split>/image_02/<seq>/<frame>.png,
    <root>/<split>/label_02/<seq>.txt, calib/<seq>.txt, velodyne/<seq>/.

    Two gt sources, like the reference: the real KITTI tracking label_02
    files (the per-frame parse below), or SubCNN voxel-exemplar txts
    (<root>/voxel_exemplars/<train|trainval>/<index>.txt with subclass
    ids, kitti_tracking.py:150-260) selected by use_voxel_exemplars.
    With cfg.IS_RPN False the roidb comes from precomputed region
    proposals merged with gt (kitti_tracking.py:329-398)."""

    def __init__(self, split, sequence, root, use_voxel_exemplars=False):
        super().__init__("kitti_tracking_{}_{}".format(split, sequence))
        from mv3d_tf_tpu_torch.config import cfg
        self._root = root
        self._split = "training" if split != "test" else "testing"
        self._sequence = sequence
        # reference class set (kitti_tracking.py:26)
        self._classes = ("__background__", "Car", "Pedestrian", "Cyclist")
        self._class_to_ind = {c: i for i, c in enumerate(self._classes)}
        self._use_voxel_exemplars = use_voxel_exemplars
        # train split uses train/ exemplars, others trainval/
        # (kitti_tracking.py:41-47)
        self._exemplar_prefix = ("train" if split == "train" else "trainval")
        self._num_subclasses = (220 + 1 if self._exemplar_prefix == "train"
                                else 472 + 1)
        self._subclass_names = None
        self._subclass_alpha = None
        img_dir = osp.join(root, self._split, "image_02", sequence)
        self._image_index = sorted(
            f[:-4] for f in os.listdir(img_dir) if f.endswith(".png"))
        self._roidb_handler = (self.gt_roidb if cfg.IS_RPN
                               else self.region_proposal_roidb)

    def image_path_at(self, i):
        return osp.join(self._root, self._split, "image_02", self._sequence,
                        self._image_index[i] + ".png")

    def velodyne_path_at(self, i):
        return osp.join(self._root, self._split, "velodyne", self._sequence,
                        self._image_index[i] + ".bin")

    def _parse_labels(self):
        """label_02/<seq>.txt rows: frame track_id type trunc occl alpha
        x1 y1 x2 y2 h w l X Y Z ry."""
        path = osp.join(self._root, self._split, "label_02",
                        self._sequence + ".txt")
        per_frame = {}
        if not osp.exists(path):
            return per_frame
        with open(path) as f:
            for line in f:
                v = line.strip().split(" ")
                if len(v) < 17:
                    continue
                cls = self._class_to_ind.get(v[2])
                if cls is None:
                    continue
                per_frame.setdefault(int(v[0]), []).append(
                    (cls, [float(x) for x in v[3:17]]))
        return per_frame

    def gt_roidb(self):
        if self._use_voxel_exemplars:
            return self._gt_roidb_voxel_exemplars()
        per_frame = self._parse_labels()
        roidb = []
        for idx in self._image_index:
            objs = per_frame.get(int(idx), [])
            n = len(objs)
            boxes = np.zeros((n, 4), np.float32)
            boxes3d_cam = np.zeros((n, 7), np.float32)
            gt_classes = np.zeros(n, np.int32)
            overlaps = np.zeros((n, self.num_classes), np.float32)
            for i, (cls, v) in enumerate(objs):
                boxes[i] = v[3:7]
                h, w, l = v[7:10]
                x, y, z = v[10:13]
                boxes3d_cam[i] = [x, y, z, l, w, h, v[13]]
                gt_classes[i] = cls
                overlaps[i, cls] = 1.0
            roidb.append({"boxes": boxes, "boxes_3D_cam": boxes3d_cam[:, :6],
                          "ry": boxes3d_cam[:, 6], "gt_classes": gt_classes,
                          "gt_overlaps": overlaps, "flipped": False})
        return roidb

    # -- SubCNN voxel-exemplar surface (kitti_tracking.py:150-440) --------

    def _exemplar_path(self, idx):
        # reference index is "<seq>/<frame>" (kitti_tracking.py:169)
        return osp.join(self._root, "voxel_exemplars",
                        self._exemplar_prefix, self._sequence,
                        idx + ".txt")

    def _gt_roidb_voxel_exemplars(self):
        """Voxel-exemplar gt (kitti_tracking.py:150-260): missing files
        mean no objects; coords are NOT 0-based-shifted (unlike
        pascal3d's -1)."""
        from mv3d_tf_tpu_torch.data import subcnn
        roidb = []
        for idx in self._image_index:
            path = self._exemplar_path(idx)
            if osp.exists(path):
                roidb.append(subcnn.load_voxel_exemplar_annotation(
                    path, self._class_to_ind, self.num_classes,
                    zero_based=False))
            else:
                n = 0
                roidb.append({
                    "boxes": np.zeros((n, 4), np.float32),
                    "gt_classes": np.zeros(n, np.int32),
                    "gt_subclasses": np.zeros(n, np.int32),
                    "gt_subclasses_flipped": np.zeros(n, np.int32),
                    "gt_overlaps": np.zeros((n, self.num_classes),
                                            np.float32),
                    "gt_subindexes": np.zeros((n, self.num_classes),
                                              np.int32),
                    "gt_subindexes_flipped": np.zeros(
                        (n, self.num_classes), np.int32),
                    "flipped": False})
        return roidb

    def _load_subclass_mapping(self):
        """<root>/voxel_exemplars/<prefix>/mapping.txt rows
        `<subcls> <class> <?> <alpha>` (kitti_tracking.py:401-412)."""
        if self._subclass_names is None:
            from mv3d_tf_tpu_torch.data import subcnn
            path = osp.join(self._root, "voxel_exemplars",
                            self._exemplar_prefix, "mapping.txt")
            self._subclass_names, self._subclass_alpha = \
                subcnn.parse_subclass_mapping(path, value_col=3)
        return self._subclass_names, self._subclass_alpha

    @property
    def subclass_mapping(self):
        from mv3d_tf_tpu_torch.data import subcnn
        names, _ = self._load_subclass_mapping()
        return subcnn.subclass_mapping_to_class_ind(names,
                                                    self._class_to_ind)

    def region_proposal_roidb(self):
        """Precomputed proposals merged with gt (kitti_tracking.py:
        329-398): <root>/region_proposals/<model>_<prefix>/<split>/
        <seq>_<frame>.txt rows [x1 y1 x2 y2 score]."""
        from mv3d_tf_tpu_torch.config import cfg
        from mv3d_tf_tpu_torch.data import subcnn
        gt = (self.gt_roidb() if self._split != "testing" else None)

        def path_fn(idx):
            return osp.join(self._root, "region_proposals",
                            "{}_{}".format(cfg.REGION_PROPOSAL,
                                           self._exemplar_prefix),
                            self._split, self._sequence, idx + ".txt")

        return subcnn.region_proposal_roidb(self, path_fn, gt)

    def evaluate_detections(self, all_boxes, output_dir):
        """KITTI-format per-frame result txt (kitti_tracking.py:400-434):
        dets carrying a subclass id in column 5 get that subclass's
        alpha viewpoint from the exemplar mapping, else alpha=-10."""
        os.makedirs(output_dir, exist_ok=True)
        have_mapping = osp.exists(osp.join(
            self._root, "voxel_exemplars", self._exemplar_prefix,
            "mapping.txt"))
        if have_mapping:
            mapping = self.subclass_mapping
            _, alpha_map = self._load_subclass_mapping()
        for im_ind, index in enumerate(self.image_index):
            filename = osp.join(output_dir, index + ".txt")
            with open(filename, "wt") as f:
                for cls_ind, cls in enumerate(self.classes):
                    if cls == "__background__":
                        continue
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        if have_mapping and dets.shape[1] > 5:
                            subcls = int(dets[k, 5])
                            assert self.classes[mapping[subcls]] == cls, \
                                "subclass not in class"
                            alpha = alpha_map[subcls]
                        else:
                            alpha = -10.0
                        f.write("{:s} -1 -1 {:f} {:f} {:f} {:f} {:f} -1 "
                                "-1 -1 -1 -1 -1 -1 {:.32f}\n".format(
                                    cls, alpha, dets[k, 0], dets[k, 1],
                                    dets[k, 2], dets[k, 3], dets[k, 4]))


class Coco(Imdb):
    """coco_<year>_<split>: instances JSON parsed with stdlib json
    (coco.py capability without the pycocotools dependency)."""

    def __init__(self, image_set, year, data_path):
        super().__init__("coco_{}_{}".format(year, image_set))
        self._data_path = data_path
        ann_file = osp.join(data_path, "annotations",
                            "instances_{}{}.json".format(image_set, year))
        with open(ann_file) as f:
            ann = json.load(f)
        cats = sorted(ann["categories"], key=lambda c: c["id"])
        self._classes = ("__background__",) + tuple(c["name"] for c in cats)
        self._cat_to_ind = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self._images = {im["id"]: im for im in ann["images"]}
        self._image_index = sorted(self._images)
        self._anns = {}
        for a in ann.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            self._anns.setdefault(a["image_id"], []).append(a)
        self._image_set = image_set
        self._year = year
        self._roidb_handler = self.gt_roidb

    def image_path_at(self, i):
        im = self._images[self._image_index[i]]
        return osp.join(self._data_path, "images", im["file_name"])

    def gt_roidb(self):
        roidb = []
        for img_id in self._image_index:
            anns = self._anns.get(img_id, [])
            n = len(anns)
            boxes = np.zeros((n, 4), np.float32)
            gt_classes = np.zeros(n, np.int32)
            overlaps = np.zeros((n, self.num_classes), np.float32)
            for i, a in enumerate(anns):
                x, y, w, h = a["bbox"]
                boxes[i] = [x, y, x + w - 1, y + h - 1]
                gt_classes[i] = self._cat_to_ind[a["category_id"]]
                overlaps[i, gt_classes[i]] = 1.0
            roidb.append({"boxes": boxes, "gt_classes": gt_classes,
                          "gt_overlaps": overlaps, "flipped": False})
        return roidb

    def evaluate_detections(self, all_boxes, output_dir=".", log=print):
        """Write COCO-format results json (bbox [x,y,w,h] + score) and
        compute COCO bbox AP on non-test splits (coco.py:371-386 evaluate_detections →
        _do_detection_eval, rebuilt in data/coco_eval.py without
        pycocotools). Returns the stats dict (or the json path on test
        splits, which carry no gt)."""
        results = []
        ind_to_cat = {v: k for k, v in self._cat_to_ind.items()}
        for j in range(1, self.num_classes):
            for i, img_id in enumerate(self._image_index):
                dets = all_boxes[j][i]
                for k in range(len(dets)):
                    x1, y1, x2, y2, sc = dets[k][:5]
                    results.append({
                        "image_id": int(img_id),
                        "category_id": int(ind_to_cat[j]),
                        "bbox": [float(x1), float(y1),
                                 float(x2 - x1 + 1), float(y2 - y1 + 1)],
                        "score": float(sc)})
        os.makedirs(output_dir, exist_ok=True)
        path = osp.join(output_dir, "detections_{}{}_results.json".format(
            self._image_set, self._year))
        with open(path, "w") as f:
            json.dump(results, f)
        if "test" in self._image_set:
            return path

        from mv3d_tf_tpu_torch.data.coco_eval import evaluate_coco_bbox
        gt, dets = {}, {}
        for j in range(1, self.num_classes):
            gt[j], dets[j] = {}, {}
            for i, img_id in enumerate(self._image_index):
                anns = [a["bbox"] for a in self._anns.get(img_id, [])
                        if self._cat_to_ind[a["category_id"]] == j]
                gt[j][img_id] = np.asarray(anns, np.float64).reshape(-1, 4)
                d = np.asarray(all_boxes[j][i],
                               np.float64).reshape(-1, 5) \
                    if len(all_boxes[j][i]) else np.zeros((0, 5))
                # xyxy (inclusive) -> xywh, the json convention above
                boxes = np.stack([d[:, 0], d[:, 1],
                                  d[:, 2] - d[:, 0] + 1,
                                  d[:, 3] - d[:, 1] + 1], axis=1) \
                    if len(d) else np.zeros((0, 4))
                dets[j][img_id] = (boxes, d[:, 4])
        stats = evaluate_coco_bbox(gt, dets, list(self._classes), log=log)
        stats["results_json"] = path
        return stats


class ImageListDataset(Imdb):
    """Inference-only drive imdb (nissan.py / nthu.py capability): an
    image directory or list file, no ground truth."""

    def __init__(self, name, image_dir, ext=".jpg", list_file=None):
        super().__init__(name)
        self._image_dir = image_dir
        self._classes = ("__background__", "Car")
        if list_file is not None:
            with open(list_file) as f:
                self._image_index = [l.strip() for l in f if l.strip()]
        else:
            self._image_index = sorted(
                osp.splitext(f)[0] for f in os.listdir(image_dir)
                if f.endswith(ext))
        self._ext = ext
        self._roidb_handler = self.gt_roidb

    def image_path_at(self, i):
        return osp.join(self._image_dir, self._image_index[i] + self._ext)

    def gt_roidb(self):
        return [{"boxes": np.zeros((0, 4), np.float32),
                 "gt_classes": np.zeros(0, np.int32),
                 "gt_overlaps": np.zeros((0, self.num_classes), np.float32),
                 "flipped": False} for _ in self._image_index]

    def evaluate_detections(self, all_boxes, output_dir="."):
        os.makedirs(output_dir, exist_ok=True)
        path = osp.join(output_dir, self.name + "_detections.txt")
        with open(path, "w") as f:
            for j in range(1, self.num_classes):
                for i, idx in enumerate(self._image_index):
                    for det in all_boxes[j][i]:
                        f.write("{} {} {:.2f} {:.2f} {:.2f} {:.2f} {:.4f}\n"
                                .format(idx, self._classes[j], *det[:5]))
        return path


def nissan(image_dir, **kw):
    return ImageListDataset("nissan", image_dir, **kw)


def nthu(image_dir, **kw):
    return ImageListDataset("nthu", image_dir, **kw)


class Pascal3D(PascalVOC):
    """pascal3d_<split> — the SubCNN subcategory dataset
    (lib/datasets/pascal3d.py): VOC2012 images, 12 rigid categories;
    val gt comes from the VOC XML annotations (pascal3d.py:149-186 via
    :294-296), train gt from voxel-exemplar txt files
    (<pascal3d_path>/<subcls_name>/<index>.txt, pascal3d.py:291-441)
    carrying per-object subclass ids whose mapping.txt row also holds
    the azimuth viewpoint used by the result writers (:600-632).

    devkit_path points at VOCdevkit2012 (so PascalVOC's path layout
    holds); pascal3d_path at the root holding <subcls_name>/ and
    region_proposals/ — defaults to devkit_path's parent.
    """

    def __init__(self, image_set, devkit_path, pascal3d_path=None,
                 subcls_name=None):
        super().__init__(image_set, "2012", devkit_path)
        from mv3d_tf_tpu_torch.config import cfg
        self._name = "pascal3d_" + image_set
        self._classes = PASCAL3D_CLASSES
        self._class_to_ind = {c: i for i, c in enumerate(self._classes)}
        self._pascal3d_path = (osp.dirname(osp.abspath(devkit_path))
                               if pascal3d_path is None else pascal3d_path)
        self._subcls_name = (getattr(cfg, "SUBCLS_NAME", "voxel_exemplars")
                             if subcls_name is None else subcls_name)
        # 337 voxel exemplars / 260 pose exemplars + background
        # (pascal3d.py:50-56)
        self._num_subclasses = (260 + 1 if self._subcls_name
                                == "pose_exemplars" else 337 + 1)
        self._subclass_names = None
        self._subclass_azimuth = None
        if not cfg.IS_RPN:
            self._roidb_handler = self.region_proposal_roidb

    def _load_subclass_mapping(self):
        """<pascal3d_path>/<subcls_name>/mapping.txt:
        `<subcls> <class> <azimuth>` (pascal3d.py:58-68, 602-612)."""
        if self._subclass_names is None:
            from mv3d_tf_tpu_torch.data import subcnn
            path = osp.join(self._pascal3d_path, self._subcls_name,
                            "mapping.txt")
            self._subclass_names, self._subclass_azimuth = \
                subcnn.parse_subclass_mapping(path, value_col=2)
        return self._subclass_names, self._subclass_azimuth

    @property
    def subclass_mapping(self):
        from mv3d_tf_tpu_torch.data import subcnn
        names, _ = self._load_subclass_mapping()
        return subcnn.subclass_mapping_to_class_ind(names,
                                                    self._class_to_ind)

    def gt_roidb(self):
        """val -> VOC XML; other splits -> voxel exemplar txt
        (pascal3d.py:291-296); prints anchor-coverage recall when IS_RPN
        (pascal3d.py:136-142)."""
        import pickle

        from mv3d_tf_tpu_torch.config import cfg
        cache_file = osp.join(self.cache_path, "{}_{}_gt_roidb.pkl".format(
            self.name, self._subcls_name))
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        if self._image_set == "val":
            roidb = [self._load_pascal_annotation(i)
                     for i in self._image_index]
        else:
            from mv3d_tf_tpu_torch.data import subcnn
            roidb = [subcnn.load_voxel_exemplar_annotation(
                osp.join(self._pascal3d_path, self._subcls_name,
                         index + ".txt"),
                self._class_to_ind, self.num_classes, zero_based=True)
                for index in self._image_index]
        if cfg.IS_RPN:
            self._print_coverage(roidb)
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _print_coverage(self, roidb, log=print):
        from PIL import Image

        from mv3d_tf_tpu_torch.config import cfg
        from mv3d_tf_tpu_torch.data import subcnn
        num_all = np.zeros(self.num_classes, np.int64)
        num_cov = np.zeros(self.num_classes, np.int64)
        for i, entry in enumerate(roidb):
            w, h = Image.open(self.image_path_at(i)).size
            fn = (subcnn.grid_coverage if cfg.IS_MULTISCALE
                  else subcnn.anchor_coverage)
            a, c = fn(entry["boxes"], entry["gt_classes"], h, w,
                      self.num_classes)
            num_all += a
            num_cov += c
        subcnn.log_coverage(self._classes, num_all, num_cov, log=log)

    def region_proposal_roidb(self):
        """Precomputed-proposal roidb merged with gt (pascal3d.py:443-480);
        proposal files live under <pascal3d_path>/region_proposals/
        <cfg.REGION_PROPOSAL>/{training,validation}/<index>.txt."""
        import pickle

        from mv3d_tf_tpu_torch.config import cfg
        from mv3d_tf_tpu_torch.data import subcnn
        cache_file = osp.join(
            self.cache_path, "{}_{}_{}_region_proposal_roidb.pkl".format(
                self.name, self._subcls_name, cfg.REGION_PROPOSAL))
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        prefix = {"val": "validation", "train": "training"}.get(
            self._image_set, "")
        gt = self.gt_roidb() if self._image_set != "test" else None

        def path_fn(index):
            return osp.join(self._pascal3d_path, "region_proposals",
                            cfg.REGION_PROPOSAL, prefix, index + ".txt")

        roidb = subcnn.region_proposal_roidb(self, path_fn, gt)
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def evaluate_detections(self, all_boxes, output_dir):
        """Per-class VOC-style result files with the subclass's azimuth
        viewpoint (pascal3d.py:600-632; dets carry the subclass id in
        column 5): `<index> <score> <azimuth> <x1> <y1> <x2> <y2>`,
        1-based coords."""
        mapping = self.subclass_mapping
        _, azimuth = self._load_subclass_mapping()
        os.makedirs(output_dir, exist_ok=True)
        for cls_ind, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            filename = osp.join(output_dir, "det_{}_{}.txt".format(
                self._image_set, cls))
            with open(filename, "wt") as f:
                for im_ind, index in enumerate(self.image_index):
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        subcls = int(dets[k, 5])
                        assert self.classes[mapping[subcls]] == cls, \
                            "subclass not in class"
                        f.write("{:s} {:.3f} {:.3f} {:.1f} {:.1f} {:.1f}"
                                " {:.1f}\n".format(
                                    index, dets[k, 4], azimuth[subcls],
                                    dets[k, 0] + 1, dets[k, 1] + 1,
                                    dets[k, 2] + 1, dets[k, 3] + 1))

    def evaluate_detections_one_file(self, all_boxes, output_dir):
        """Single-file variant (pascal3d.py:637-658)."""
        mapping = self.subclass_mapping
        os.makedirs(output_dir, exist_ok=True)
        filename = osp.join(output_dir, "detections.txt")
        with open(filename, "wt") as f:
            for im_ind, index in enumerate(self.image_index):
                for cls_ind, cls in enumerate(self.classes):
                    if cls == "__background__":
                        continue
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        subcls = int(dets[k, 5])
                        assert self.classes[mapping[subcls]] == cls, \
                            "subclass not in class"
                        f.write("{:s} {:s} {:f} {:f} {:f} {:f} {:d} "
                                "{:.32f}\n".format(
                                    index, cls, dets[k, 0] + 1,
                                    dets[k, 1] + 1, dets[k, 2] + 1,
                                    dets[k, 3] + 1, subcls, dets[k, 4]))

    def evaluate_proposals(self, all_boxes, output_dir):
        """Per-image proposal dumps (pascal3d.py:662-677)."""
        os.makedirs(output_dir, exist_ok=True)
        for im_ind, index in enumerate(self.image_index):
            filename = osp.join(output_dir, index + ".txt")
            with open(filename, "wt") as f:
                for cls_ind, cls in enumerate(self.classes):
                    if cls == "__background__":
                        continue
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        f.write("{:f} {:f} {:f} {:f} {:.32f}\n".format(
                            dets[k, 0], dets[k, 1], dets[k, 2],
                            dets[k, 3], dets[k, 4]))


IMAGENET3D_CLASSES = (
    "__background__", "aeroplane", "ashtray", "backpack", "basket", "bed",
    "bench", "bicycle", "blackboard", "boat", "bookshelf", "bottle",
    "bucket", "bus", "cabinet", "calculator", "camera", "can", "cap",
    "car", "cellphone", "chair", "clock", "coffee_maker", "comb",
    "computer", "cup", "desk_lamp", "diningtable", "dishwasher", "door",
    "eraser", "eyeglasses", "fan", "faucet", "filing_cabinet",
    "fire_extinguisher", "fish_tank", "flashlight", "fork", "guitar",
    "hair_dryer", "hammer", "headphone", "helmet", "iron", "jar",
    "kettle", "key", "keyboard", "knife", "laptop", "lighter", "mailbox",
    "microphone", "microwave", "motorbike", "mouse", "paintbrush", "pan",
    "pen", "pencil", "piano", "pillow", "plate", "pot", "printer",
    "racket", "refrigerator", "remote_control", "rifle", "road_pole",
    "satellite_dish", "scissors", "screwdriver", "shoe", "shovel", "sign",
    "skate", "skateboard", "slipper", "sofa", "speaker", "spoon",
    "stapler", "stove", "suitcase", "teapot", "telephone", "toaster",
    "toilet", "toothbrush", "train", "trash_bin", "trophy", "tub",
    "tvmonitor", "vending_machine", "washing_machine", "watch",
    "wheelchair")


class Imagenet3D(Imdb):
    """imagenet3d_<split> (lib/datasets/imagenet3d.py): 100 rigid
    categories; layout <path>/Images/<index>.jpg, Labels/<index>.txt,
    ImageSets/<split>.txt. Label rows: `<class> <x1> <y1> <x2> <y2>
    [<azimuth> <elevation> <theta>]` (imagenet3d.py:149-164); missing
    viewpoints store inf, flipped viewpoints negate azimuth/theta."""

    def __init__(self, image_set, imagenet3d_path):
        super().__init__("imagenet3d_" + image_set)
        self._image_set = image_set
        self._imagenet3d_path = imagenet3d_path
        self._data_path = osp.join(imagenet3d_path, "Images")
        self._classes = IMAGENET3D_CLASSES
        self._class_to_ind = {c: i for i, c in enumerate(self._classes)}
        set_file = osp.join(imagenet3d_path, "ImageSets",
                            image_set + ".txt")
        with open(set_file) as f:
            self._image_index = [x.strip() for x in f if x.strip()]
        from mv3d_tf_tpu_torch.config import cfg
        self._roidb_handler = (self.gt_roidb if cfg.IS_RPN
                               else self.region_proposal_roidb)

    def image_path_at(self, i):
        return osp.join(self._data_path, self._image_index[i] + ".jpg")

    def _load_annotation(self, index):
        """imagenet3d.py:122-186 (test splits carry no labels)."""
        if self._image_set.startswith("test"):
            lines = []
        else:
            with open(osp.join(self._imagenet3d_path, "Labels",
                               index + ".txt")) as f:
                lines = [l for l in f if l.split()]
        n = len(lines)
        boxes = np.zeros((n, 4), np.float32)
        viewpoints = np.zeros((n, 3), np.float32)
        viewpoints_flipped = np.zeros((n, 3), np.float32)
        gt_classes = np.zeros(n, np.int32)
        overlaps = np.zeros((n, self.num_classes), np.float32)
        for ix, line in enumerate(lines):
            words = line.split()
            assert len(words) in (5, 8), \
                "Wrong label format: {}".format(index)
            cls = self._class_to_ind[words[0]]
            boxes[ix] = [float(v) for v in words[1:5]]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
            if len(words) == 8:
                viewpoints[ix] = [float(v) for v in words[5:8]]
                viewpoints_flipped[ix] = [-viewpoints[ix, 0],
                                          viewpoints[ix, 1],
                                          -viewpoints[ix, 2]]
            else:
                viewpoints[ix] = np.inf
                viewpoints_flipped[ix] = np.inf
        return {"boxes": boxes, "gt_classes": gt_classes,
                "gt_viewpoints": viewpoints,
                "gt_viewpoints_flipped": viewpoints_flipped,
                "gt_overlaps": overlaps, "flipped": False}

    def gt_roidb(self):
        import pickle
        cache_file = osp.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        roidb = [self._load_annotation(i) for i in self._image_index]
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def region_proposal_roidb(self):
        """imagenet3d.py:300-336: proposals at
        <path>/region_proposals/<model>/<index>.txt; selective_search /
        mcg store [y1 x1 y2 x2], edge_boxes [x y w h], rpn_* [x1 y1 x2
        y2] (imagenet3d.py:339-371)."""
        import pickle

        from mv3d_tf_tpu_torch.config import cfg
        model = cfg.REGION_PROPOSAL
        cache_file = osp.join(
            self.cache_path,
            "{}_{}_region_proposal_roidb.pkl".format(self.name, model))
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        gt = (self.gt_roidb()
              if not self._image_set.startswith("test") else None)
        box_list = []
        for index in self._image_index:
            raw = np.loadtxt(osp.join(self._imagenet3d_path,
                                      "region_proposals", model,
                                      index + ".txt"), dtype=np.float64)
            if raw.ndim == 1:
                raw = raw.reshape((0, 5) if raw.size == 0 else (1, 5))
            if model in ("selective_search", "mcg"):
                x1, y1 = raw[:, 1].copy(), raw[:, 0].copy()
                x2, y2 = raw[:, 3].copy(), raw[:, 2].copy()
            elif model == "edge_boxes":
                x1, y1 = raw[:, 0].copy(), raw[:, 1].copy()
                x2 = raw[:, 2] + raw[:, 0]
                y2 = raw[:, 3] + raw[:, 1]
            else:                      # rpn_caffenet / rpn_vgg16 / RPN
                x1, y1, x2, y2 = (raw[:, 0].copy(), raw[:, 1].copy(),
                                  raw[:, 2].copy(), raw[:, 3].copy())
            keep = np.where((x2 > x1) & (y2 > y1))[0]
            box_list.append(
                np.stack([x1, y1, x2, y2], axis=1)[keep])
        roidb = self.create_roidb_from_box_list(box_list, gt)
        if gt is not None:
            roidb = Imdb.merge_roidbs(roidb, gt)
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def evaluate_detections(self, all_boxes, output_dir):
        """Per-image result txt with detection + viewpoint columns
        (imagenet3d.py:399-417; dets columns 6:9 are az/el/theta)."""
        os.makedirs(output_dir, exist_ok=True)
        for im_ind, index in enumerate(self.image_index):
            filename = osp.join(output_dir, index + ".txt")
            with open(filename, "wt") as f:
                for cls_ind, cls in enumerate(self.classes):
                    if cls == "__background__":
                        continue
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        vp = (dets[k, 6], dets[k, 7], dets[k, 8]) \
                            if dets.shape[1] > 8 else (0.0, 0.0, 0.0)
                        f.write("{:s} {:f} {:f} {:f} {:f} {:.32f} {:f} "
                                "{:f} {:f}\n".format(
                                    cls, dets[k, 0], dets[k, 1],
                                    dets[k, 2], dets[k, 3], dets[k, 4],
                                    *vp))

    def evaluate_proposals(self, all_boxes, output_dir):
        os.makedirs(output_dir, exist_ok=True)
        for im_ind, index in enumerate(self.image_index):
            filename = osp.join(output_dir, index + ".txt")
            with open(filename, "wt") as f:
                for cls_ind, cls in enumerate(self.classes):
                    if cls == "__background__":
                        continue
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        f.write("{:f} {:f} {:f} {:f} {:.32f}\n".format(
                            dets[k, 0], dets[k, 1], dets[k, 2],
                            dets[k, 3], dets[k, 4]))
