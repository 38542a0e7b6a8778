"""Faster R-CNN ResNet-101 C4's im_detect in plain PyTorch (float32, TF32
off), and the comparison that judges one image of the program's output by
it: reference/frcnn.py's, at this configuration's trunk (resnet_c4.py), 15
anchors of scales 2-32, a 14x14 RoI pool and res5 per RoI.

Detectron2's faster_rcnn_R_101_C4 test graph as the configuration file
describes it, with the departures its "assumed" lists: the trunk to res4
at stride 16, the RPN, the proposal layer (decode, clip to the image,
min-size filter, stable top-K, greedy NMS), RoI max pooling at 1/16, res5,
the mean, the two heads, the class-specific box decode and clip, then the
per-class threshold, NMS and cap on the host in the original image's
coordinates.
"""

import torch

from benchmark.reference import geometry as G
from benchmark.reference import judge
from benchmark.reference import resnet_c4 as net
from benchmark.reference.frcnn import (FILTER_MARGIN_PX, IOU_MARGIN,
                                       MATCH_SLACK_PX, POOL_SHARE,
                                       class_detections, passes,
                                       same_detections)
from benchmark.reference.nets import exact
from benchmark.reference.ops import nms_greedy, roi_pool, top_k

STRIDE = 16


def anchors_all(weights, feat, im_info, cfg, q=exact):
    """logit (N,) fg minus bg, prob (N,), boxes (N, 4) decoded and
    clipped."""
    cls, box = net.rpn(weights, feat, q)
    anchors = torch.from_numpy(G.anchors_2d(
        feat.shape[2], feat.shape[3], STRIDE, tuple(cfg["anchor_ratios"]),
        tuple(cfg["anchor_scales"]))).to(feat.device)
    boxes = G.clip_boxes(G.bbox_transform_inv(anchors, box),
                         float(im_info[0]), float(im_info[1]))
    return {"logit": cls[:, 1] - cls[:, 0],
            "prob": torch.softmax(cls, -1)[:, 1], "boxes": boxes}


def head(weights, feat, rois, im_info, cfg, q=exact):
    """cls_prob (n, K) and decoded, clipped boxes (n, 4K) at (n, 4) rois."""
    r5 = torch.cat([rois.new_zeros(len(rois), 1), rois], 1)
    pooled = roi_pool(feat[0].permute(1, 2, 0), r5, pooled=cfg["pooled"],
                      spatial_scale=1.0 / STRIDE)
    prob, bbox = net.heads(weights, net.res5(weights, pooled, q), q)
    boxes = G.clip_boxes(G.bbox_transform_inv(rois, bbox),
                         float(im_info[0]), float(im_info[1]))
    return prob, boxes


def im_detect(weights, image, im_info, cfg, q=exact):
    """The whole detector on one image: the program's keys (scores, boxes,
    rois, valid) as numpy arrays."""
    test = cfg["test"]
    feat = net.trunk(weights, image, q)
    a = anchors_all(weights, feat, im_info, cfg, q)
    k = min(test["pre_nms_top_n"], len(a["prob"]))
    top, top_valid = top_k(a["prob"], passes(a, im_info, test["min_size"]), k)
    keep, found = nms_greedy(a["boxes"][top], a["prob"][top], top_valid,
                             test["post_nms_top_n"], test["rpn_nms_thresh"])
    rois = a["boxes"][top[keep]]
    prob, boxes = head(weights, feat, rois, im_info, cfg, q)
    m = found[:, None].float()
    out = {"scores": prob * m, "boxes": boxes * m,
           "rois": torch.cat([torch.zeros_like(m), rois * m], 1),
           "valid": found}
    return {name: v.cpu().numpy() for name, v in out.items()}


def judge_image(weights, det, dets, image, im_info, cfg):
    """The numbers that judge one image of the program: det its raw output
    (numpy), dets its per-class detections; image (H, W, 3) float32 and
    im_info (3,) as the program got them, on the reference's device. The
    numbers and margins are reference/frcnn.judge_image's."""
    test = cfg["test"]
    dev = image.device
    feat = net.trunk(weights, image)
    a = anchors_all(weights, feat, im_info, cfg)
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
    prob, boxes = head(weights, feat, rois, im_info, cfg)

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
