"""KITTI-style AP evaluation (mv3d_tf_tpu/data/kitti_eval.py), host numpy:
BEV-box AP at an IoU threshold with the KITTI R40 recall sampling, and the
official-protocol 2D / BEV / 3D table over the easy / moderate / hard
buckets. The reference's evaluator binary is absent (kitti_mv3d.py:392-395),
so this is the working one.

The per-difficulty AP's greedy matcher runs in C++ (native/kitti_eval.cc
through utils/native.eval_ap_native) when every frame uses this module's
iou_2d or iou_3d_aabb, and in numpy for any other IoU callable or with
use_native=False; the numpy loop is the plain version the tests hold the
C++ to (tests/test_torch_native.py).
"""

import functools

import numpy as np

from mv3d_tf_tpu_torch.geometry import RES, TOP_X_MIN, TOP_Y_MIN, Xn, Yn


def ap_r40(rec, prec):
    """KITTI 40-point interpolated AP."""
    total = 0.0
    for t in np.linspace(1.0 / 40, 1.0, 40):
        p = prec[rec >= t]
        total += np.max(p) if p.size else 0.0
    return float(total) / 40.0


def evaluate_bev_ap(all_dets, gt_boxes_per_image, iou_thresh=0.7):
    """AP for one class over a dataset.

    all_dets: list over images of (N_i, 5) [x1,y1,x2,y2,score] arrays;
    gt_boxes_per_image: list over images of (M_i, 4) gt BEV boxes.
    Returns dict with ap (R40), recall, precision arrays and num_gt.
    """
    records = []          # (score, is_tp)
    npos = 0
    for dets, gts in zip(all_dets, gt_boxes_per_image):
        gts = np.asarray(gts, np.float32).reshape(-1, 4)
        npos += len(gts)
        dets = np.asarray(dets, np.float32).reshape(-1, 5)
        if len(dets) == 0:
            continue
        order = np.argsort(-dets[:, 4])
        dets = dets[order]
        taken = np.zeros(len(gts), bool)
        if len(gts):
            ious = iou_2d(dets[:, :4], gts)
        for d in range(len(dets)):
            tp = False
            if len(gts):
                j = int(np.argmax(np.where(taken, -1.0, ious[d])))
                if not taken[j] and ious[d, j] >= iou_thresh:
                    taken[j] = True
                    tp = True
            records.append((dets[d, 4], tp))
    if not records or npos == 0:
        return {"ap": 0.0, "recall": np.zeros(0), "precision": np.zeros(0),
                "num_gt": npos}
    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records])
    fps = np.cumsum([not r[1] for r in records])
    rec = tps / float(npos)
    prec = tps / np.maximum(tps + fps, 1e-9)
    return {"ap": ap_r40(rec, prec), "recall": rec, "precision": prec,
            "num_gt": npos}


def evaluate_kitti_bev(imdb, all_boxes, iou_thresh=0.7, cls_ind=1,
                       num_frames=None):
    """Detections against an imdb's gt BEV boxes. num_frames limits the
    scoring to the first N frames: a caller that detects a subset of the
    split must pass it, or the undetected frames' gt dilutes recall."""
    n = imdb.num_images if num_frames is None else min(num_frames,
                                                       imdb.num_images)
    gts = []
    for i in range(n):
        entry = imdb.roidb[i]
        mask = entry["gt_classes"] == cls_ind
        gts.append(entry["boxes_bv"][mask])
    dets = [np.asarray(all_boxes[cls_ind][i]).reshape(-1, 5)
            for i in range(n)]
    return evaluate_bev_ap(dets, gts, iou_thresh)


# ---------------------------------------------------------------------------
# Official-protocol evaluation (kitti_eval.py:82-94): difficulty buckets from
# the label's 2D height / occlusion / truncation, 2D image-box AP, BEV AP and
# 3D AP. Matching is greedy by detection score; BEV/3D overlaps use
# axis-aligned boxes; Van/DontCare regions are not modeled.
# ---------------------------------------------------------------------------

# (min 2D box height px, max occlusion, max truncation)
DIFFICULTY = {
    "easy": (40.0, 0, 0.15),
    "moderate": (25.0, 1, 0.30),
    "hard": (25.0, 2, 0.50),
}


def gt_levels(boxes2d, truncation, occlusion):
    """Difficulty level 1/2/3 per gt (4 = excluded), kitti_mv3d.py:308-319,
    with the same +1 height convention."""
    height = boxes2d[:, 3] - boxes2d[:, 1] + 1
    lvl = np.full(len(boxes2d), 4, np.int32)
    lvl[(height >= 25) & (truncation <= 0.5) & (occlusion <= 2)] = 3
    lvl[(height >= 25) & (truncation <= 0.3) & (occlusion <= 1)] = 2
    lvl[(height >= 40) & (truncation <= 0.15) & (occlusion <= 0)] = 1
    return lvl


def iou_2d(a, b):
    """Pairwise IoU of (N,4) vs (M,4) axis-aligned boxes, +1 convention."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    iw = (np.minimum(a[:, None, 2], b[None, :, 2])
          - np.maximum(a[:, None, 0], b[None, :, 0]) + 1).clip(min=0)
    ih = (np.minimum(a[:, None, 3], b[None, :, 3])
          - np.maximum(a[:, None, 1], b[None, :, 1]) + 1).clip(min=0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def _lidar_cnr_to_img_np(corners, Tr, R0, P2, legacy=True):
    """geometry.lidar_cnr_to_img (legacy=True, the 0-homogeneous definition
    of transform.py:483-500) and lidar_cnr_to_img_full (legacy=False)."""
    corners = np.asarray(corners, np.float32).reshape(-1, 3, 8)
    Tr = np.asarray(Tr, np.float32).reshape(-1)[:12].reshape(3, 4)
    R0v = np.asarray(R0, np.float32).reshape(-1)
    P2 = np.asarray(P2, np.float32).reshape(-1)[:12].reshape(3, 4)
    if legacy:
        if R0v.shape[0] == 9:
            R0v = np.concatenate([R0v, np.zeros(3, np.float32)])
        mat = P2 @ R0v[:12].reshape(4, 3) @ Tr
        pts4 = np.concatenate(
            [corners, np.zeros((corners.shape[0], 1, 8), np.float32)], 1)
        img = np.einsum("ij,njk->nik", mat, pts4)
        img = img / img[:, 2:3, :]
        xs, ys = img[:, 0, :], img[:, 1, :]
        boxes = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)
        return np.trunc(boxes)
    R0m = R0v[:9].reshape(3, 3)
    n = corners.shape[0]
    pts4 = np.concatenate([corners, np.ones((n, 1, 8), np.float32)], 1)
    cam = np.einsum("ij,njk->nik", Tr, pts4)
    rect = np.einsum("ij,njk->nik", R0m, cam)
    rect4 = np.concatenate([rect, np.ones((n, 1, 8), np.float32)], 1)
    img = np.einsum("ij,njk->nik", P2, rect4)
    img = img / img[:, 2:3, :]
    xs, ys = img[:, 0, :], img[:, 1, :]
    return np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)


def _corners_to_bv_np(cnr):
    """geometry.corners_to_bv for one class: (N,24) lidar corners -> (N,4)
    BEV pixel boxes of their footprints."""
    c = np.asarray(cnr, np.float32).reshape(-1, 24)
    xmin, xmax = c[:, 0:8].min(1), c[:, 0:8].max(1)
    ymin, ymax = c[:, 8:16].min(1), c[:, 8:16].max(1)
    x1 = Yn - np.floor((ymax - TOP_Y_MIN) / RES)
    y1 = Xn - np.floor((xmax - TOP_X_MIN) / RES)
    x2 = Yn - np.floor((ymin - TOP_Y_MIN) / RES)
    y2 = Xn - np.floor((xmin - TOP_X_MIN) / RES)
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)


def corners_to_aabb3d(cnr):
    """(N,24) corner sets (x0..7, y0..7, z0..7) -> (N,6) aabb."""
    cnr = np.asarray(cnr, np.float32).reshape(-1, 3, 8)
    return np.concatenate([cnr.min(axis=2), cnr.max(axis=2)], axis=1)


def iou_3d_aabb(a, b):
    """Pairwise 3D IoU of axis-aligned boxes (N,6) vs (M,6)."""
    a = np.asarray(a, np.float32).reshape(-1, 6)
    b = np.asarray(b, np.float32).reshape(-1, 6)
    inter = np.ones((len(a), len(b)), np.float32)
    for d in range(3):
        lo = np.maximum(a[:, None, d], b[None, :, d])
        hi = np.minimum(a[:, None, d + 3], b[None, :, d + 3])
        inter *= np.maximum(hi - lo, 0.0)
    va = np.prod(np.maximum(a[:, 3:] - a[:, :3], 0.0), axis=1)
    vb = np.prod(np.maximum(b[:, 3:] - b[:, :3], 0.0), axis=1)
    union = va[:, None] + vb[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def evaluate_ap_difficulty(frames, iou_thresh, difficulty,
                           use_native=True):
    """Per-difficulty AP. frames: list of dicts with dets (N, D), scores
    (N,), det_heights (N,), gts (M, D), levels (M,) and iou, a callable
    (dets, gts) -> (N, M). Gts harder than the difficulty are ignored (not
    in npos; detections matching them are neither TP nor FP); detections
    shorter than its min height that match nothing are ignored too.

    use_native: frames whose iou is this module's iou_2d (or iou_3d_aabb)
    in every frame go to the C++ matcher (kitti_eval.py:206-237), which
    returns ap and num_gt only; other frames, or use_native=False, take the
    numpy loop below."""
    min_h, _, _ = DIFFICULTY[difficulty]
    lvl_max = {"easy": 1, "moderate": 2, "hard": 3}[difficulty]
    if use_native and frames:
        kind = {id(iou_2d): 0, id(iou_3d_aabb): 1}.get(id(frames[0]["iou"]))
        if kind is not None and all(fr["iou"] is frames[0]["iou"]
                                    for fr in frames):
            from mv3d_tf_tpu_torch.utils.native import eval_ap_native
            ap, npos = eval_ap_native(frames, kind, iou_thresh, min_h,
                                      lvl_max)
            return {"ap": ap, "num_gt": npos}
    records = []
    npos = 0
    for fr in frames:
        levels = np.asarray(fr["levels"])
        valid = (levels >= 1) & (levels <= lvl_max)
        npos += int(valid.sum())
        dets = np.asarray(fr["dets"])
        if len(dets) == 0:
            continue
        scores = np.asarray(fr["scores"])
        hts = np.asarray(fr["det_heights"])
        order = np.argsort(-scores)
        gts = np.asarray(fr["gts"])
        ious = fr["iou"](dets, gts) if len(gts) else None
        taken = np.zeros(len(gts), bool)
        for d in order:
            matched_valid = matched_ignored = False
            if ious is not None:
                cand = np.where(valid & ~taken, ious[d], -1.0)
                j = int(np.argmax(cand)) if len(gts) else -1
                if len(gts) and cand[j] >= iou_thresh:
                    taken[j] = True
                    matched_valid = True
                elif len(gts) and np.max(
                        np.where(~valid, ious[d], -1.0)) >= iou_thresh:
                    matched_ignored = True
            if matched_valid:
                records.append((scores[d], True))
            elif matched_ignored or hts[d] < min_h:
                continue            # ignored detection: neither TP nor FP
            else:
                records.append((scores[d], False))
    if not records or npos == 0:
        return {"ap": 0.0, "num_gt": npos}
    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records]).astype(np.float64)
    fps = np.cumsum([not r[1] for r in records]).astype(np.float64)
    rec = tps / float(npos)
    prec = tps / np.maximum(tps + fps, 1e-9)
    return {"ap": ap_r40(rec, prec), "num_gt": npos,
            "recall": rec, "precision": prec}


def evaluate_kitti_official(imdb, all_boxes, all_boxes_cnr, cls_ind=1,
                            iou_2d_thresh=0.7, iou_bev_thresh=0.7,
                            iou_3d_thresh=0.7, log=print,
                            projection="legacy",
                            derive_bev_from_corners=False, label=None,
                            num_frames=None, use_native=True):
    """The 3 metric x 3 difficulty AP table for one class
    (kitti_eval.py:282-371).

    all_boxes[cls][i]: (N,5) BEV dets [x1,y1,x2,y2,score];
    all_boxes_cnr[cls][i]: (N,25) lidar corner dets + score. 2D image boxes
    are projected from the corners with the frame calib: "legacy" is the
    reference's translation-dropping projection (parity mode), "proper"
    the standard KITTI chain (quality mode). derive_bev_from_corners
    recomputes each BEV det and gt from its corners' footprint, for scoring
    regressed corners; scores still come from all_boxes. use_native is
    evaluate_ap_difficulty's.
    """
    proj = functools.partial(_lidar_cnr_to_img_np,
                             legacy=(projection == "legacy"))
    n = imdb.num_images if num_frames is None else min(num_frames,
                                                       imdb.num_images)
    frames_2d, frames_bev, frames_3d = [], [], []
    for i in range(n):
        entry = imdb.roidb[i]
        m = entry["gt_classes"] == cls_ind
        g2 = entry["boxes"][m]
        levels = gt_levels(g2, entry["truncation"][m], entry["occlusion"][m])
        calib = imdb.calib_at(i)

        bev = np.asarray(all_boxes[cls_ind][i], np.float32).reshape(-1, 5)
        cnr = np.asarray(all_boxes_cnr[cls_ind][i],
                         np.float32).reshape(-1, 25)
        scores = bev[:, 4]
        if derive_bev_from_corners and len(cnr):
            bev = np.concatenate(
                [_corners_to_bv_np(cnr[:, :24]), scores[:, None]], axis=1)
        if len(cnr):
            img_boxes = np.asarray(proj(
                cnr[:, :24], calib[3], calib[2], calib[0]), np.float32)
        else:
            img_boxes = np.zeros((0, 4), np.float32)
        det_h = (img_boxes[:, 3] - img_boxes[:, 1] + 1 if len(img_boxes)
                 else np.zeros(0))

        frames_2d.append({"dets": img_boxes, "scores": scores,
                          "det_heights": det_h, "gts": g2,
                          "levels": levels, "iou": iou_2d})
        gt_bv = (entry["boxes_bv"][m] if not derive_bev_from_corners
                 else _corners_to_bv_np(entry["boxes_corners"][m]))
        frames_bev.append({"dets": bev[:, :4], "scores": scores,
                           "det_heights": det_h, "gts": gt_bv,
                           "levels": levels, "iou": iou_2d})
        frames_3d.append({"dets": corners_to_aabb3d(cnr[:, :24]),
                          "scores": scores, "det_heights": det_h,
                          "gts": corners_to_aabb3d(
                              entry["boxes_corners"][m]),
                          "levels": levels, "iou": iou_3d_aabb})

    table = {}
    for metric, frames, thr in (("2d", frames_2d, iou_2d_thresh),
                                ("bev", frames_bev, iou_bev_thresh),
                                ("3d", frames_3d, iou_3d_thresh)):
        table[metric] = {}
        for diff in ("easy", "moderate", "hard"):
            table[metric][diff] = evaluate_ap_difficulty(
                frames, thr, diff, use_native)["ap"]
    log("KITTI official-protocol AP{} (car, R40, IoU {:.2f}/{:.2f}/{:.2f}):"
        .format(", " + label if label else "",
                iou_2d_thresh, iou_bev_thresh, iou_3d_thresh))
    log("  {:>9s} {:>8s} {:>8s} {:>8s}".format(
        "metric", "easy", "moderate", "hard"))
    for metric in ("2d", "bev", "3d"):
        log("  {:>9s} {:8.4f} {:8.4f} {:8.4f}".format(
            metric, table[metric]["easy"], table[metric]["moderate"],
            table[metric]["hard"]))
    return table
