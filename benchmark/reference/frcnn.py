"""The legacy 2D Faster R-CNN VGG16's im_detect in plain PyTorch (float32,
TF32 off), and the comparison that judges one image of the program's
output by it.

py-faster-rcnn's test graph as the configuration file describes it: the
VGG16 trunk at stride 16, the RPN with 9 anchors a location, the proposal
layer (decode, clip to the image, min-size filter, stable top-K, greedy
NMS), ROI pooling at 1/16, fc6/fc7 and the two heads, the class-specific
box decode and clip, then the per-class threshold, NMS and cap on the host
in the original image's coordinates.
"""

import numpy as np
import torch

from benchmark.reference import geometry as G
from benchmark.reference import judge, nets
from benchmark.reference.ops import nms_greedy, nms_np, roi_pool, top_k

STRIDE = 16


def features(weights, image, q=nets.exact):
    """image (H, W, 3) float32 mean-subtracted -> conv5_3 (1, 512, h, w)."""
    return nets.trunk(weights, image.permute(2, 0, 1)[None], "", STRIDE, q)


def anchors_all(weights, c5, im_info, q=nets.exact):
    """logit (N,) fg minus bg, prob (N,), boxes (N, 4) decoded and
    clipped."""
    cls, box = nets.rpn(weights, c5, q)
    anchors = torch.from_numpy(G.anchors_2d(c5.shape[2], c5.shape[3],
                                            STRIDE)).to(c5.device)
    boxes = G.clip_boxes(G.bbox_transform_inv(anchors, box),
                         float(im_info[0]), float(im_info[1]))
    return {"logit": cls[:, 1] - cls[:, 0],
            "prob": torch.softmax(cls, -1)[:, 1], "boxes": boxes}


def passes(a, im_info, min_size, margin=0.0):
    b = a["boxes"]
    thr = min_size * float(im_info[2]) + margin
    return (b[:, 2] - b[:, 0] + 1.0 >= thr) & (b[:, 3] - b[:, 1] + 1.0 >= thr)


def head(weights, c5, rois, im_info, q=nets.exact):
    """cls_prob (n, K) and decoded, clipped boxes (n, 4K) at (n, 4) rois."""
    r5 = torch.cat([rois.new_zeros(len(rois), 1), rois], 1)
    pooled = roi_pool(c5[0].permute(1, 2, 0), r5, spatial_scale=1.0 / STRIDE)
    prob, bbox = nets.head_2d(weights, pooled, q)
    boxes = G.clip_boxes(G.bbox_transform_inv(rois, bbox),
                         float(im_info[0]), float(im_info[1]))
    return prob, boxes


def im_detect(weights, image, im_info, test, q=nets.exact):
    """The whole detector on one image: the program's keys (scores, boxes,
    rois, valid) as numpy arrays."""
    c5 = features(weights, image, q)
    a = anchors_all(weights, c5, im_info, q)
    k = min(test["pre_nms_top_n"], len(a["prob"]))
    top, top_valid = top_k(a["prob"], passes(a, im_info, test["min_size"]), k)
    keep, found = nms_greedy(a["boxes"][top], a["prob"][top], top_valid,
                             test["post_nms_top_n"], test["rpn_nms_thresh"])
    rois = a["boxes"][top[keep]]
    prob, boxes = head(weights, c5, rois, im_info, q)
    m = found[:, None].float()
    out = {"scores": prob * m, "boxes": boxes * m,
           "rois": torch.cat([torch.zeros_like(m), rois * m], 1),
           "valid": found}
    return {name: v.cpu().numpy() for name, v in out.items()}


def class_detections(det, im_scale, score_thresh, nms_thresh, max_per_image):
    """Per-class threshold and NMS in the original image's coordinates, then
    the cap: [dets (M, 5) per class], index 0 (background) empty."""
    scores, valid = det["scores"], det["valid"]
    boxes = det["boxes"] / im_scale
    k = scores.shape[1]
    out = [np.zeros((0, 5), np.float32)]
    for j in range(1, k):
        inds = np.where(valid & (scores[:, j] > score_thresh))[0]
        dets = np.hstack([boxes[inds, 4 * j:4 * (j + 1)],
                          scores[inds, j:j + 1]]).astype(np.float32)
        out.append(dets[nms_np(dets, nms_thresh)])
    if max_per_image > 0:
        flat = np.concatenate([d[:, -1] for d in out[1:]])
        if len(flat) > max_per_image:
            t = np.sort(flat)[-max_per_image]
            out = [out[0]] + [d[d[:, -1] >= t] for d in out[1:]]
    return out


def same_detections(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


# margins of the judgement: the program's boxes come from bfloat16 deltas,
# and an edge's error scales with the box before the clip (a few percent
# of boxes that He-random deltas stretch to the image's size): a candidate
# that the program's min-size filter dropped and the reference's kept
# would stay free through every step, so the filter is tightened by more
FILTER_MARGIN_PX = 32.0
IOU_MARGIN = 0.4
MATCH_SLACK_PX = 2.0
POOL_SHARE = 0.95


def judge_image(weights, det, dets, image, im_info, cfg):
    """The numbers that judge one image of the program: det its raw output
    (numpy), dets its per-class detections; image (H, W, 3) float32 and
    im_info (3,) as the program got them, on the reference's device."""
    test = cfg["test"]
    dev = image.device
    c5 = features(weights, image)
    a = anchors_all(weights, c5, im_info)
    valid = torch.as_tensor(det["valid"], device=dev)
    rois = torch.as_tensor(det["rois"], device=dev)[valid][:, 1:5]
    idx, _ = judge.match(rois, a["boxes"], a["logit"], MATCH_SLACK_PX)
    ok = passes(a, im_info, test["min_size"])
    cand = passes(a, im_info, test["min_size"], FILTER_MARGIN_PX)
    k = min(test["pre_nms_top_n"], len(a["prob"]))
    pool = torch.zeros_like(cand)
    pool[top_k(a["prob"], ok, int(k * POOL_SHARE))[0]] = True
    gap, missing = judge.gap(idx, a["logit"], a["boxes"], cand, pool & cand,
                             test["rpn_nms_thresh"], IOU_MARGIN,
                             test["post_nms_top_n"])
    prob, boxes = head(weights, c5, rois, im_info)

    def err(key, ref):
        got = torch.as_tensor(det[key], device=dev)[valid].float()
        return float((got - ref).abs().max()) if len(ref) else 0.0

    ref_dets = class_detections(det, float(im_info[2]), test["score_thresh"],
                                test["nms"], test["max_per_image"])
    return {"nms_overlap": judge.overlap(rois),
            "nms_gap": gap,
            "missing_rois": missing,
            "score_err": err("scores", prob),
            "box_err_px": err("boxes", boxes),
            "dets_mismatch": int(not same_detections(dets, ref_dets))}
