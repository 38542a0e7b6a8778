"""SubCNN subcategory machinery shared by the pascal3d / imagenet3d /
kitti_tracking dataset families, the port's copy of
mv3d_tf_tpu/data/subcnn.py: the voxel-exemplar
annotation path (lib/datasets/pascal3d.py:291-441,
kitti_tracking.py:160-300), the subclass mapping files, the
region-proposal roidb loaders (pascal3d.py:443-512,
kitti_tracking.py:329-398), and the RPN/grid gt-coverage statistics the
reference prints while building gt roidbs (pascal3d.py:136-142,196-226).

All host-side numpy: these run once at dataset-load time, nothing here
touches the device path.
"""

import os.path as osp

import numpy as np

from mv3d_tf_tpu_torch.anchors import generate_anchors, shift_anchors
from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data.boxes_grid import get_boxes_grid
from mv3d_tf_tpu_torch.data.imdb_base import bbox_overlaps

# the SubCNN anchor recipe used by the exemplar datasets
# (pascal3d.py:381-385, kitti_tracking.py:264-269)
SUBCNN_ANCHOR_RATIOS = (3.0, 2.0, 1.5, 1.0, 0.75, 0.5, 0.25)
SUBCNN_ANCHOR_SCALES = tuple(2 ** np.arange(1, 6, 0.5))


def parse_subclass_mapping(path, value_col=None):
    """Parse a SubCNN mapping.txt: `<subcls> <class_name> <float>...`.

    Returns (names, values): names[subcls] = class name string,
    values[subcls] = float(words[value_col]) when value_col is given
    (azimuth col 2 for pascal3d:602-612, alpha col 3 for
    kitti_tracking:407-412), else 0.
    """
    rows = []
    with open(path) as f:
        for line in f:
            words = line.split()
            if not words:
                continue
            rows.append((int(words[0]), words[1],
                         float(words[value_col]) if value_col else 0.0))
    n = max(r[0] for r in rows) + 1
    names = [""] * n
    values = np.zeros(n, np.float64)
    for subcls, name, val in rows:
        names[subcls] = name
        values[subcls] = val
    return names, values


def subclass_mapping_to_class_ind(names, class_to_ind):
    """mapping array subcls -> class index (pascal3d.py:62-68)."""
    return np.array([class_to_ind.get(n, 0) for n in names], np.int64)


def load_voxel_exemplar_annotation(path, class_to_ind, num_classes,
                                   zero_based=True):
    """Parse one voxel-exemplar annotation txt.

    Row format: `<class> <subcls> <is_flip> <x1> <y1> <x2> <y2> ...`;
    rows with subcls == -1 are dropped; flipped rows (is_flip=1) pair
    1:1 with unflipped rows and contribute gt_subclasses_flipped
    (pascal3d.py:300-345; kitti_tracking.py:180-230 — which keeps
    1-based coords, hence zero_based=False there).

    Returns the roidb entry dict with the SubCNN keys (dense float32
    gt_overlaps instead of the reference's csr matrices).
    """
    lines, lines_flipped = [], []
    with open(path) as f:
        for line in f:
            words = line.split()
            if len(words) < 7:
                continue
            if int(words[1]) == -1:
                continue
            (lines_flipped if int(words[2]) else lines).append(words)

    num_objs = len(lines)
    assert num_objs == len(lines_flipped), \
        "The number of flipped objects is not the same!"

    gt_subclasses_flipped = np.array(
        [int(w[1]) for w in lines_flipped], np.int32).reshape(num_objs)

    boxes = np.zeros((num_objs, 4), np.float32)
    gt_classes = np.zeros(num_objs, np.int32)
    gt_subclasses = np.zeros(num_objs, np.int32)
    overlaps = np.zeros((num_objs, num_classes), np.float32)
    subindexes = np.zeros((num_objs, num_classes), np.int32)
    subindexes_flipped = np.zeros((num_objs, num_classes), np.int32)
    off = 1.0 if zero_based else 0.0
    for ix, words in enumerate(lines):
        cls = class_to_ind[words[0]]
        subcls = int(words[1])
        boxes[ix] = [float(n) - off for n in words[3:7]]
        gt_classes[ix] = cls
        gt_subclasses[ix] = subcls
        overlaps[ix, cls] = 1.0
        subindexes[ix, cls] = subcls
        subindexes_flipped[ix, cls] = gt_subclasses_flipped[ix]

    return {"boxes": boxes,
            "gt_classes": gt_classes,
            "gt_subclasses": gt_subclasses,
            "gt_subclasses_flipped": gt_subclasses_flipped,
            "gt_overlaps": overlaps,
            "gt_subindexes": subindexes,
            "gt_subindexes_flipped": subindexes_flipped,
            "flipped": False}


def load_rpn_proposals(path):
    """One per-image proposal txt `<x1> <y1> <x2> <y2> <score>` ->
    (M, 4) boxes with degenerate rows dropped (pascal3d.py:486-509)."""
    raw = np.loadtxt(path, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw.reshape((0, 5) if raw.size == 0 else (1, 5))
    keep = np.where((raw[:, 2] > raw[:, 0]) & (raw[:, 3] > raw[:, 1]))[0]
    return raw[keep, :4]


def region_proposal_roidb(imdb, proposal_path_fn, gt_roidb, log=print):
    """RPN-proposal roidb merged with gt — the reference's
    region_proposal_roidb flow (pascal3d.py:443-480): load each frame's
    proposal file, build overlap-labelled entries, then stack the gt
    boxes onto the proposal entries (merge_roidbs(rpn, gt))."""
    box_list = []
    total = 0
    for i, index in enumerate(imdb.image_index):
        boxes = load_rpn_proposals(proposal_path_fn(index))
        total += boxes.shape[0]
        box_list.append(boxes)
    if log:
        log("{} region proposals per image".format(
            total // max(len(imdb.image_index), 1)))
    rpn_roidb = imdb.create_roidb_from_box_list(box_list, gt_roidb)
    if gt_roidb is not None:
        return imdb.merge_roidbs(rpn_roidb, gt_roidb)
    return rpn_roidb


def _vgg_heatmap_hw(image_height, image_width, scale):
    """SubCNN's inline heatmap size (pascal3d.py:229-238): round at
    conv1 then three floor(x/2 + .5) halvings — NOT the same rounding
    as boxes_grid's CaffeNet branch."""
    h = np.round((image_height * scale - 1) / 4.0 + 1)
    for _ in range(2):
        h = np.floor((h - 1) / 2.0 + 1 + 0.5)
    w = np.round((image_width * scale - 1) / 4.0 + 1)
    for _ in range(2):
        w = np.floor((w - 1) / 2.0 + 1 + 0.5)
    return int(h), int(w)


def anchor_coverage(boxes, gt_classes, image_height, image_width,
                    num_classes, scale=None, fg_thresh=None):
    """Per-class (boxes_all, boxes_covered) counts for the RPN-anchor
    recall statistic (pascal3d.py:377-426): enumerate the SubCNN anchor
    set over the heatmap and count gt boxes any anchor covers at
    >= FG_THRESH."""
    scale = cfg.TRAIN.SCALES_BASE[0] if scale is None else scale
    thresh = np.asarray(cfg.TRAIN.FG_THRESH if fg_thresh is None
                        else fg_thresh, np.float64).reshape(-1)
    if thresh.size == 1:
        thresh = np.full(num_classes - 1, float(thresh[0]))

    num_all = np.zeros(num_classes, np.int64)
    num_cov = np.zeros(num_classes, np.int64)
    for i in range(num_classes):
        num_all[i] = int((gt_classes == i).sum())
    if boxes.shape[0] == 0:
        return num_all, num_cov

    anchors = generate_anchors(16, SUBCNN_ANCHOR_RATIOS,
                               SUBCNN_ANCHOR_SCALES)
    h, w = _vgg_heatmap_hw(image_height, image_width, scale)
    all_anchors = np.asarray(shift_anchors(anchors, h, w, 16))
    ious = np.asarray(bbox_overlaps(
        all_anchors.astype(np.float32),
        (boxes * scale).astype(np.float32)))
    max_overlaps = ious.max(axis=0)
    fg = np.zeros(boxes.shape[0], bool)
    for k in range(1, num_classes):
        fg |= (gt_classes == k) & (max_overlaps >= thresh[k - 1])
    for i in range(num_classes):
        num_cov[i] = int((gt_classes[fg] == i).sum())
    return num_all, num_cov


def grid_coverage(boxes, gt_classes, image_height, image_width,
                  num_classes, scales=None, fg_thresh=None, **grid_kw):
    """Multiscale variant (IS_MULTISCALE, pascal3d.py:347-376): gt boxes
    replicated per pyramid scale against the boxes_grid."""
    scales = tuple(cfg.TRAIN.SCALES_BASE if scales is None else scales)
    thresh = np.asarray(cfg.TRAIN.FG_THRESH if fg_thresh is None
                        else fg_thresh, np.float64).reshape(-1)
    if thresh.size == 1:
        thresh = np.full(num_classes - 1, float(thresh[0]))

    num_all = np.zeros(num_classes, np.int64)
    num_cov = np.zeros(num_classes, np.int64)
    for i in range(num_classes):
        num_all[i] = int((gt_classes == i).sum())
    num_objs = boxes.shape[0]
    if num_objs == 0:
        return num_all, num_cov

    boxes_all = np.vstack([boxes * s for s in scales])
    gt_classes_all = np.tile(gt_classes, len(scales))
    grid, _, _ = get_boxes_grid(image_height, image_width, **grid_kw)
    ious = np.asarray(bbox_overlaps(grid.astype(np.float32),
                                    boxes_all.astype(np.float32)))
    max_overlaps = ious.max(axis=0)
    obj_idx = np.tile(np.arange(num_objs), len(scales))
    fg = []
    for k in range(1, num_classes):
        fg.extend(np.where((gt_classes_all == k)
                           & (max_overlaps >= thresh[k - 1]))[0])
    covered = np.unique(obj_idx[fg]) if fg else np.zeros(0, np.int64)
    for i in range(num_classes):
        num_cov[i] = int((gt_classes[covered.astype(np.int64)] == i).sum())
    return num_all, num_cov


def log_coverage(classes, num_all, num_covered, log=print):
    """The per-class recall printout (pascal3d.py:136-142)."""
    for i in range(1, len(classes)):
        log("{}: Total number of boxes {:d}".format(classes[i],
                                                    int(num_all[i])))
        log("{}: Number of boxes covered {:d}".format(classes[i],
                                                      int(num_covered[i])))
        log("{}: Recall {:f}".format(
            classes[i], float(num_covered[i]) / float(max(num_all[i], 1))))
