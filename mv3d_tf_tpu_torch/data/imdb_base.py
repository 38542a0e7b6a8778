"""The image-database base of mv3d_tf_tpu/data/imdb_base.py (the
reference's lib/datasets/imdb.py): the lazy cached roidb, its cache path,
horizontal flip augmentation, proposal recall (both the imdb and the
SubCNN form), box-list roidb construction and roidb merging. Host code in
numpy; the box overlaps are the port's ops/iou.bbox_overlaps on CPU
tensors.
"""

import os
import os.path as osp

import numpy as np
import torch

from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.ops.iou import bbox_overlaps as _bbox_overlaps


# np.trapz became np.trapezoid in numpy 2.0 (same sum)
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def bbox_overlaps(boxes, query_boxes):
    """+1-area IoU of (N,4) against (K,4) boxes in float32, as numpy."""
    return _bbox_overlaps(
        torch.from_numpy(np.ascontiguousarray(boxes, np.float32)),
        torch.from_numpy(np.ascontiguousarray(query_boxes, np.float32))
    ).numpy()


class Imdb:
    def __init__(self, name):
        self._name = name
        self._classes = ()
        self._image_index = []
        self._roidb = None
        self._roidb_handler = self.default_roidb

    @property
    def name(self):
        return self._name

    @property
    def classes(self):
        return self._classes

    @property
    def num_classes(self):
        return len(self._classes)

    @property
    def image_index(self):
        return self._image_index

    @property
    def num_images(self):
        return len(self._image_index)

    @property
    def cache_path(self):
        path = osp.join(cfg.DATA_DIR, "cache")
        os.makedirs(path, exist_ok=True)
        return path

    @property
    def roidb(self):
        if self._roidb is None:
            self._roidb = self._roidb_handler()
        return self._roidb

    @property
    def roidb_handler(self):
        return self._roidb_handler

    @roidb_handler.setter
    def roidb_handler(self, handler):
        self._roidb_handler = handler

    def default_roidb(self):
        raise NotImplementedError

    def image_path_at(self, i):
        raise NotImplementedError

    def _image_width(self, i):
        from PIL import Image
        with Image.open(self.image_path_at(i)) as im:
            return im.size[0]

    def append_flipped_images(self):
        """Double the roidb with horizontally flipped entries
        (imdb.py:104-119)."""
        for i in range(self.num_images):
            entry = self.roidb[i]
            width = self._image_width(i)
            boxes = entry["boxes"].copy()
            oldx1 = boxes[:, 0].copy()
            oldx2 = boxes[:, 2].copy()
            boxes[:, 0] = width - oldx2 - 1
            boxes[:, 2] = width - oldx1 - 1
            assert (boxes[:, 2] >= boxes[:, 0]).all()
            flipped = dict(entry)
            flipped["boxes"] = boxes
            flipped["flipped"] = True
            self.roidb.append(flipped)
        self._image_index = self._image_index * 2

    def evaluate_recall(self, candidate_boxes=None, thresholds=None,
                        area="all", limit=None):
        """Proposal recall against gt at IoU thresholds (imdb.py:121-209,
        the 'all'-area path the reference uses)."""
        gt_overlaps = np.zeros(0)
        num_pos = 0
        for i in range(self.num_images):
            entry = self.roidb[i]
            gt_inds = np.where(entry["gt_classes"] > 0)[0]
            gt_boxes = entry["boxes"][gt_inds]
            num_pos += len(gt_inds)
            if candidate_boxes is None:
                non_gt = np.where(entry["gt_classes"] == 0)[0]
                boxes = entry["boxes"][non_gt]
            else:
                boxes = candidate_boxes[i]
            if boxes.shape[0] == 0 or gt_boxes.shape[0] == 0:
                continue
            if limit is not None and boxes.shape[0] > limit:
                boxes = boxes[:limit]
            overlaps = bbox_overlaps(boxes.astype(np.float32),
                                     gt_boxes.astype(np.float32))
            _gt_overlaps = np.zeros(gt_boxes.shape[0])
            for j in range(gt_boxes.shape[0]):
                argmax_overlaps = overlaps.argmax(axis=0)
                max_overlaps = overlaps.max(axis=0)
                gt_ind = max_overlaps.argmax()
                gt_ovr = max_overlaps.max()
                if gt_ovr < 0:
                    break
                box_ind = argmax_overlaps[gt_ind]
                _gt_overlaps[j] = overlaps[box_ind, gt_ind]
                overlaps[box_ind, :] = -1
                overlaps[:, gt_ind] = -1
            gt_overlaps = np.hstack((gt_overlaps, _gt_overlaps))
        gt_overlaps = np.sort(gt_overlaps)
        if thresholds is None:
            step = 0.05
            thresholds = np.arange(0.5, 0.95 + 1e-5, step)
        recalls = np.array([(gt_overlaps >= t).sum() / float(max(num_pos, 1))
                            for t in thresholds])
        return {"ar": recalls.mean(), "recalls": recalls,
                "thresholds": thresholds, "gt_overlaps": gt_overlaps}

    def evaluate_proposals(self, candidate_boxes, ar_thresh=0.5):
        """Average recall of proposals, the SubCNN form
        (lib/datasets/imdb2.py:161-201): greedy one-to-one box-gt matching
        per image, recall over the thresholds ar_thresh:0.001:1.0, and
        AR = 2 * the trapezoid integral. An image without candidates adds
        no gt (imdb2.py:170-171). Returns (ar, gt_overlaps, recalls,
        thresholds)."""
        gt_overlaps = np.zeros(0)
        for i in range(self.num_images):
            entry = self.roidb[i]
            gt_inds = np.where(entry["gt_classes"] > 0)[0]
            gt_boxes = entry["boxes"][gt_inds]
            boxes = candidate_boxes[i]
            if boxes.shape[0] == 0:
                continue
            overlaps = bbox_overlaps(boxes.astype(np.float32),
                                     gt_boxes.astype(np.float32))
            _gt_overlaps = np.zeros(gt_boxes.shape[0])
            for j in range(gt_boxes.shape[0]):
                argmax_overlaps = overlaps.argmax(axis=0)
                max_overlaps = overlaps.max(axis=0)
                gt_ind = max_overlaps.argmax()
                box_ind = argmax_overlaps[gt_ind]
                _gt_overlaps[j] = overlaps[box_ind, gt_ind]
                overlaps[box_ind, :] = -1
                overlaps[:, gt_ind] = -1
            gt_overlaps = np.hstack((gt_overlaps, _gt_overlaps))
        num_pos = gt_overlaps.size
        gt_overlaps = np.sort(gt_overlaps)
        step = 0.001
        thresholds = np.minimum(np.arange(ar_thresh, 1.0 + step, step), 1.0)
        recalls = np.array([(gt_overlaps >= t).sum() / float(max(num_pos, 1))
                            for t in thresholds])
        ar = 2 * _trapezoid(recalls, thresholds)
        return ar, gt_overlaps, recalls, thresholds

    def create_roidb_from_box_list(self, box_list, gt_roidb):
        """Proposal boxes and gt -> roidb entries with overlap matrices
        (imdb.py:211-238)."""
        assert len(box_list) == self.num_images
        roidb = []
        for i in range(self.num_images):
            boxes = box_list[i]
            num_boxes = boxes.shape[0]
            overlaps = np.zeros((num_boxes, self.num_classes), np.float32)
            if gt_roidb is not None and gt_roidb[i]["boxes"].size > 0:
                gt_boxes = gt_roidb[i]["boxes"]
                gt_classes = gt_roidb[i]["gt_classes"]
                ious = bbox_overlaps(boxes.astype(np.float32),
                                     gt_boxes.astype(np.float32))
                argmaxes = ious.argmax(axis=1)
                maxes = ious.max(axis=1)
                pos = np.where(maxes > 0)[0]
                overlaps[pos, gt_classes[argmaxes[pos]]] = maxes[pos]
            roidb.append({
                "boxes": boxes,
                "gt_classes": np.zeros((num_boxes,), np.int32),
                "gt_overlaps": overlaps,
                "flipped": False,
            })
        return roidb

    @staticmethod
    def merge_roidbs(a, b):
        """Concatenate the box sets of two aligned roidbs into a
        (imdb.py:240-250)."""
        assert len(a) == len(b)
        for i in range(len(a)):
            a[i]["boxes"] = np.vstack((a[i]["boxes"], b[i]["boxes"]))
            a[i]["gt_classes"] = np.hstack((a[i]["gt_classes"],
                                            b[i]["gt_classes"]))
            a[i]["gt_overlaps"] = np.vstack((a[i]["gt_overlaps"],
                                             b[i]["gt_overlaps"]))
        return a
