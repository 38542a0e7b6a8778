"""Score top-K and exact greedy NMS with fixed output slots
(mv3d_tf_tpu/ops/nms.py), plus the numpy greedy oracle for host code.

The JAX package's blocked, blocked-fixed and matrix NMS variants exist to
work around TPU faults; the one greedy loop here gives the same keep set.
"""

import numpy as np
import torch

from mv3d_tf_tpu_torch.ops.iou import iou_one_to_many

NEG_INF = -1e30


def top_k_by_score(scores, valid, k):
    """Score-ordered top-k over the last dim with validity propagation
    (ops/nms.py:316-321). A stable descending sort, so ties go to the lower
    index as in ``lax.top_k``; ``torch.topk`` promises no order among ties.
    Returns (idx (..., k) int64, valid (..., k) bool)."""
    masked = torch.where(valid, scores, NEG_INF)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[..., :k], vals[..., :k] > NEG_INF


def nms(boxes, scores, valid, max_out, iou_threshold=0.7):
    """Greedy NMS with static output slots (ops/nms.py:224-260).

    boxes (..., N, 4), scores (..., N), valid (..., N) bool; leading dims
    are independent frames. Each of the max_out steps takes the first
    index of the highest remaining score and suppresses every box with
    IoU >= iou_threshold, itself included. Returns keep_idx (..., max_out)
    int64 (0 in unused slots) and keep_valid (..., max_out) bool.
    """
    msk = torch.where(valid & torch.isfinite(scores), scores, NEG_INF)
    keep_idx, keep_val = [], []
    for _ in range(max_out):
        best = msk.argmax(dim=-1, keepdim=True)              # first max
        found = msk.gather(-1, best) > NEG_INF
        best_box = boxes.gather(-2, best[..., None].expand(best.shape + (4,)))
        iou = iou_one_to_many(best_box[..., 0, :], boxes)
        msk = msk.masked_fill(found & (iou >= iou_threshold), NEG_INF)
        keep_idx.append(torch.where(found, best, 0))
        keep_val.append(found)
    return torch.cat(keep_idx, dim=-1), torch.cat(keep_val, dim=-1)


def nms_np(dets, thresh):
    """Host greedy oracle with the cpu_nms.pyx semantics (ops/nms.py:263-285).
    dets: (N,5) [x1,y1,x2,y2,score] -> keep list."""
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    suppressed = np.zeros(dets.shape[0], bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas - inter)
        suppressed |= ovr >= thresh
    return keep
