"""Self-contained COCO bbox AP, the port's copy of
mv3d_tf_tpu/data/coco_eval.py: the evaluation the reference delegates
to pycocotools (lib/datasets/coco.py:281-334 _do_detection_eval /
_print_detection_eval_metrics), rebuilt in numpy so the framework
computes real numbers without the external dependency.

Protocol (matching COCOeval for ann_type='bbox', area range 'all',
maxDets=100, no crowd/ignore regions — our JSON parser drops crowds):
  * IoU thresholds 0.50:0.05:0.95;
  * per image+category, detections sorted by score greedily claim the
    unmatched gt with the highest IoU >= t;
  * precision envelope sampled at 101 recall points [0, 0.01, ..., 1];
  * AP averaged over categories present in the ground truth.
"""

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 0.95 + 1e-9, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_xywh(dets, gts):
    """IoU matrix for [x, y, w, h] boxes (COCO convention, w/h exclusive)."""
    D, G = len(dets), len(gts)
    out = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return out
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = (np.minimum(dx2[:, None], gx2[None]) -
          np.maximum(dx1[:, None], gx1[None])).clip(min=0)
    ih = (np.minimum(dy2[:, None], gy2[None]) -
          np.maximum(dy1[:, None], gy1[None])).clip(min=0)
    inter = iw * ih
    union = (dets[:, 2] * dets[:, 3])[:, None] \
        + (gts[:, 2] * gts[:, 3])[None] - inter
    return inter / np.maximum(union, 1e-12)


def _match_image(det_boxes, det_scores, gt_boxes, thresholds):
    """Greedy COCO matching for one (image, category).

    Returns tp (T, D) bool for detections sorted by score descending,
    plus the sort order."""
    order = np.argsort(-det_scores, kind="mergesort")
    dets = det_boxes[order]
    ious = _iou_xywh(dets, gt_boxes)
    T, D, G = len(thresholds), len(dets), len(gt_boxes)
    tp = np.zeros((T, D), bool)
    for ti, t in enumerate(thresholds):
        gt_taken = np.zeros(G, bool)
        for d in range(D):
            best, best_iou = -1, t - 1e-12
            for g in range(G):
                if gt_taken[g]:
                    continue
                if ious[d, g] > best_iou:
                    best, best_iou = g, ious[d, g]
            if best >= 0:
                gt_taken[best] = True
                tp[ti, d] = True
    return tp, order


def evaluate_category(gt_by_img, det_by_img, thresholds=IOU_THRESHOLDS,
                      max_dets=100):
    """AP per IoU threshold for one category.

    gt_by_img: {img_id: (G, 4) xywh}; det_by_img: {img_id: ((D, 4) xywh,
    (D,) scores)}. Returns (T,) AP vector, or None if the category has
    no ground truth (excluded from the mean, matching COCOeval's -1)."""
    n_gt = sum(len(g) for g in gt_by_img.values())
    if n_gt == 0:
        return None
    T = len(thresholds)
    all_scores, all_tp = [], []
    for img_id, (boxes, scores) in det_by_img.items():
        if len(boxes) == 0:
            continue
        if len(boxes) > max_dets:
            keep = np.argsort(-scores, kind="mergesort")[:max_dets]
            boxes, scores = boxes[keep], scores[keep]
        gts = gt_by_img.get(img_id, np.zeros((0, 4)))
        tp, order = _match_image(boxes, scores, np.asarray(gts), thresholds)
        all_scores.append(scores[order])
        all_tp.append(tp)
    if not all_scores:
        return np.zeros(T)
    scores = np.concatenate(all_scores)
    tp = np.concatenate(all_tp, axis=1)
    order = np.argsort(-scores, kind="mergesort")
    tp = tp[:, order]

    ap = np.zeros(T)
    for ti in range(T):
        tps = np.cumsum(tp[ti])
        fps = np.cumsum(~tp[ti])
        rec = tps / n_gt
        prec = tps / np.maximum(tps + fps, 1e-12)
        # precision envelope (monotone non-increasing from the right)
        for i in range(len(prec) - 1, 0, -1):
            prec[i - 1] = max(prec[i - 1], prec[i])
        # sample at the 101 recall points
        inds = np.searchsorted(rec, RECALL_POINTS, side="left")
        q = np.zeros(len(RECALL_POINTS))
        valid = inds < len(prec)
        q[valid] = prec[inds[valid]]
        ap[ti] = q.mean()
    return ap


def evaluate_coco_bbox(gt, dets, class_names, thresholds=IOU_THRESHOLDS,
                       max_dets=100, log=print):
    """Full COCO-style bbox evaluation.

    gt: {cls_ind: {img_id: (G, 4) xywh}};
    dets: {cls_ind: {img_id: ((D, 4) xywh, (D,) scores)}};
    class_names[cls_ind] for the printout. Returns the stats dict with
    'ap' (mAP@[.5:.95]), 'ap50', 'ap75', 'per_class'.
    """
    per_class = {}
    for c in sorted(gt):
        ap = evaluate_category(gt[c], dets.get(c, {}), thresholds, max_dets)
        if ap is not None:
            per_class[c] = ap
    if not per_class:
        return {"ap": 0.0, "ap50": 0.0, "ap75": 0.0, "per_class": {}}
    mat = np.stack([per_class[c] for c in sorted(per_class)])
    t50 = int(np.argmin(np.abs(thresholds - 0.5)))
    t75 = int(np.argmin(np.abs(thresholds - 0.75)))
    stats = {
        "ap": float(mat.mean()),
        "ap50": float(mat[:, t50].mean()),
        "ap75": float(mat[:, t75].mean()),
        "per_class": {class_names[c]: float(per_class[c].mean())
                      for c in sorted(per_class)},
    }
    if log:
        log("~~~~ Mean and per-category AP @ IoU=[0.50,0.95] ~~~~")
        log("{:.1f}".format(100 * stats["ap"]))
        for c in sorted(per_class):
            log("{}: {:.1f}".format(class_names[c],
                                    100 * per_class[c].mean()))
        log("AP@0.50: {:.1f}  AP@0.75: {:.1f}".format(
            100 * stats["ap50"], 100 * stats["ap75"]))
    return stats
