"""PASCAL VOC for the legacy 2D path (mv3d_tf_tpu/data/pascal_voc.py, the
reference's lib/datasets/pascal_voc.py and voc_eval.py): the VOC<year>
layout, XML annotations, VOC result files and the per-class AP (11-point
before 2010, area under the curve after), host-side numpy; and the
proposal roidbs the Fast R-CNN path trains over: region proposals (the
text files of rpn_generate.imdb_proposals_det) and selective search (the
.mat files).
"""

import os
import os.path as osp
import pickle
import xml.etree.ElementTree as ET

import numpy as np

from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data.imdb_base import Imdb, bbox_overlaps

VOC_CLASSES = ("__background__",
               "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")


class PascalVOC(Imdb):
    """voc_<year>_<split> under <devkit_path>/VOC<year> (pascal_voc.py:22-36)."""

    def __init__(self, image_set, year, devkit_path):
        super().__init__("voc_" + year + "_" + image_set)
        self._year = year
        self._image_set = image_set
        self._devkit_path = devkit_path
        self._data_path = osp.join(devkit_path, "VOC" + year)
        self._classes = VOC_CLASSES
        self._class_to_ind = {c: i for i, c in enumerate(self._classes)}
        self._image_ext = ".jpg"
        self._image_index = self._load_image_set_index()
        self._roidb_handler = self.gt_roidb
        self.config = {"cleanup": True, "use_salt": True, "use_diff": False}

    def image_path_at(self, i):
        return osp.join(self._data_path, "JPEGImages",
                        self._image_index[i] + self._image_ext)

    def _load_image_set_index(self):
        f = osp.join(self._data_path, "ImageSets", "Main",
                     self._image_set + ".txt")
        with open(f) as fh:
            return [x.strip() for x in fh.readlines() if x.strip()]

    def gt_roidb(self):
        """The annotations of the split, cached as a pickle under
        cfg.DATA_DIR/cache (pascal_voc.py:48-56)."""
        cache_file = osp.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        roidb = [self._load_pascal_annotation(i) for i in self._image_index]
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_pascal_annotation(self, index):
        """One VOC XML -> a roidb entry: 0-based uint16 corners, difficult
        objects left out unless use_diff (pascal_voc.py:58-84)."""
        tree = ET.parse(osp.join(self._data_path, "Annotations",
                                 index + ".xml"))
        objs = tree.findall("object")
        if not self.config["use_diff"]:
            objs = [o for o in objs if int(o.find("difficult").text) == 0]
        boxes = np.zeros((len(objs), 4), np.uint16)
        gt_classes = np.zeros((len(objs),), np.int32)
        overlaps = np.zeros((len(objs), self.num_classes), np.float32)
        for ix, obj in enumerate(objs):
            bbox = obj.find("bndbox")
            boxes[ix, :] = [float(bbox.find(k).text) - 1
                            for k in ("xmin", "ymin", "xmax", "ymax")]
            cls = self._class_to_ind[obj.find("name").text.lower().strip()]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
        return {"boxes": boxes, "gt_classes": gt_classes,
                "gt_overlaps": overlaps, "flipped": False}

    # -- proposal roidbs (pascal_voc2.py:432-586, the SubCNN variant) -----

    def region_proposal_roidb(self):
        """gt and precomputed region proposals in one roidb
        (pascal_voc2.py:432-469). The proposals are the per-image text
        files <devkit>/region_proposals/<cfg.REGION_PROPOSAL>/
        {training,testing}/<index>.txt of rows [x1 y1 x2 y2 score], as
        rpn_generate.imdb_proposals_det writes them. Cached as a pickle."""
        cache_file = osp.join(
            self.cache_path, "{}_{}_region_proposal_roidb.pkl".format(
                self.name, cfg.REGION_PROPOSAL))
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        if self._image_set != "test":
            gt = self.gt_roidb()
            roidb = Imdb.merge_roidbs(
                self._load_rpn_roidb(gt, cfg.REGION_PROPOSAL), gt)
        else:
            roidb = self._load_rpn_roidb(None, cfg.REGION_PROPOSAL)
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_rpn_roidb(self, gt_roidb, model):
        """One image's proposal file each (pascal_voc2.py:470-500); boxes
        with x2 <= x1 or y2 <= y1 are dropped, as the reference drops
        them."""
        prefix = osp.join(model, "testing" if self._image_set == "test"
                          else "training")
        box_list = []
        for index in self._image_index:
            filename = osp.join(self._devkit_path, "region_proposals",
                                prefix, index + ".txt")
            assert osp.exists(filename), \
                "RPN data not found at: {}".format(filename)
            raw = np.loadtxt(filename, dtype=float)
            if raw.ndim == 1:
                raw = raw.reshape((0, 5) if raw.size == 0 else (1, 5))
            keep = np.where((raw[:, 2] > raw[:, 0])
                            & (raw[:, 3] > raw[:, 1]))[0]
            box_list.append(raw[keep, :4])
        return self.create_roidb_from_box_list(box_list, gt_roidb)

    def selective_search_roidb(self):
        """gt and the selective-search proposals of
        <devkit>/selective_search_data/<name>.mat in one roidb
        (pascal_voc2.py:502-528). Cached as a pickle."""
        cache_file = osp.join(self.cache_path,
                              self.name + "_selective_search_roidb.pkl")
        if osp.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        if self._image_set != "test":
            gt = self.gt_roidb()
            roidb = Imdb.merge_roidbs(
                self._load_selective_search_roidb(gt), gt)
        else:
            roidb = self._load_selective_search_roidb(None)
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_selective_search_roidb(self, gt_roidb):
        """The .mat boxes are [y1 x1 y2 x2], 1-based: reordered with
        (1,0,3,2), minus 1 (pascal_voc2.py:530-543)."""
        import scipy.io as sio
        filename = osp.join(self._devkit_path, "selective_search_data",
                            self.name + ".mat")
        assert osp.exists(filename), \
            "Selective search data not found at: {}".format(filename)
        raw = sio.loadmat(filename)["boxes"].ravel()
        box_list = [raw[i][:, (1, 0, 3, 2)] - 1 for i in range(len(raw))]
        return self.create_roidb_from_box_list(box_list, gt_roidb)

    def evaluate_proposals(self, all_boxes, output_dir=None):
        """Proposal recall at IoU 0.5 over the gt roidb
        (pascal_voc2.py:634-649, computed here instead of in MATLAB).
        all_boxes[cls][im] rows are [x1, y1, x2, y2, score]. Prints and
        returns the recall."""
        del output_dir
        gt_roidb = self.gt_roidb()
        n_gt = 0
        n_hit = 0
        for i, entry in enumerate(gt_roidb):
            gt = entry["boxes"].astype(np.float32)
            if len(gt) == 0:
                continue
            props = np.vstack([
                np.asarray(all_boxes[c][i]).reshape(-1, 5)[:, :4]
                for c in range(1, self.num_classes)
                if len(all_boxes[c][i])]) if self.num_classes > 1 else \
                np.zeros((0, 4), np.float32)
            n_gt += len(gt)
            if len(props) == 0:
                continue
            ov = bbox_overlaps(gt, props.astype(np.float32))
            n_hit += int((ov.max(axis=1) >= 0.5).sum())
        recall = n_hit / max(n_gt, 1)
        print("proposal recall@0.5: {:.4f} ({}/{})".format(
            recall, n_hit, n_gt))
        return recall

    def _results_file_template(self):
        d = osp.join(self._devkit_path, "results", "VOC" + self._year, "Main")
        os.makedirs(d, exist_ok=True)
        return osp.join(d, "comp4_det_" + self._image_set + "_{:s}.txt")

    def _write_voc_results_file(self, all_boxes):
        """One file per class in the VOC server format, 1-based corners
        (pascal_voc.py:192-206)."""
        for cls_ind, cls in enumerate(self._classes):
            if cls == "__background__":
                continue
            with open(self._results_file_template().format(cls), "wt") as f:
                for im_ind, index in enumerate(self._image_index):
                    dets = all_boxes[cls_ind][im_ind]
                    for k in range(len(dets)):
                        f.write("{:s} {:.3f} {:.1f} {:.1f} {:.1f} {:.1f}\n"
                                .format(index, dets[k, -1],
                                        dets[k, 0] + 1, dets[k, 1] + 1,
                                        dets[k, 2] + 1, dets[k, 3] + 1))

    def evaluate_detections(self, all_boxes, output_dir=None):
        """Write the result files, then each class's AP at IoU 0.5 by
        voc_eval_from_roidb; prints the mean and returns {class: AP}
        (pascal_voc.py:208-225). output_dir is unused: the files go under
        the devkit's results/, as the reference writes them."""
        del output_dir
        self._write_voc_results_file(all_boxes)
        aps = {}
        use_07 = int(self._year) < 2010
        recs = {idx: self.roidb[i] for i, idx in enumerate(self._image_index)}
        for cls_ind, cls in enumerate(self._classes):
            if cls == "__background__":
                continue
            _, _, aps[cls] = voc_eval_from_roidb(
                self._results_file_template().format(cls), recs,
                self._image_index, cls_ind, ovthresh=0.5,
                use_07_metric=use_07)
        print("Mean AP = {:.4f}".format(
            float(np.mean(list(aps.values()))) if aps else 0.0))
        return aps


def voc_ap(rec, prec, use_07_metric=False):
    """AP from recall and precision (pascal_voc.py:228-242): the 11-point VOC07
    metric, or the area under the interpolated curve."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def voc_eval_from_roidb(detfile, recs, image_index, cls_ind, ovthresh=0.5,
                        use_07_metric=False):
    """voc_eval (pascal_voc.py:245-312) against the in-memory ground truth.

    recs: image index -> roidb entry; the detections come from a VOC result
    file. A detection is a true positive when its best IoU (+1 areas) with
    an unclaimed gt of the class exceeds ovthresh. Returns (rec, prec, ap).
    """
    class_recs = {}
    npos = 0
    for idx in image_index:
        entry = recs[idx]
        mask = entry["gt_classes"] == cls_ind
        class_recs[idx] = {"bbox": entry["boxes"][mask].astype(float),
                           "det": [False] * int(mask.sum())}
        npos += int(mask.sum())

    if not osp.exists(detfile):
        return np.zeros(0), np.zeros(0), 0.0
    with open(detfile) as f:
        lines = [x.strip().split(" ") for x in f.readlines() if x.strip()]
    if not lines:
        return np.zeros(0), np.zeros(0), 0.0
    confidence = np.array([float(x[1]) for x in lines])
    BB = np.array([[float(z) for z in x[2:]] for x in lines]) - 1  # 0-based
    order = np.argsort(-confidence)
    BB = BB[order]
    image_ids = [lines[i][0] for i in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs.get(image_ids[d])
        if R is None:
            fp[d] = 1.0
            continue
        bb = BB[d]
        ovmax, jmax = -np.inf, -1
        BBGT = R["bbox"]
        if BBGT.size > 0:
            iw = np.maximum(np.minimum(BBGT[:, 2], bb[2])
                            - np.maximum(BBGT[:, 0], bb[0]) + 1.0, 0.0)
            ih = np.maximum(np.minimum(BBGT[:, 3], bb[3])
                            - np.maximum(BBGT[:, 1], bb[1]) + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                   + (BBGT[:, 2] - BBGT[:, 0] + 1.0)
                   * (BBGT[:, 3] - BBGT[:, 1] + 1.0) - inters)
            overlaps = inters / uni
            ovmax = np.max(overlaps)
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh and not R["det"][jmax]:
            tp[d] = 1.0
            R["det"][jmax] = True
        else:
            fp[d] = 1.0

    tp, fp = np.cumsum(tp), np.cumsum(fp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)
