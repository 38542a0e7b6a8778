"""MV3D's test-time detector in plain PyTorch (float32, TF32 off), and the
comparison that judges one frame of the program's output by it.

The detector follows the reference repo's MV3D_test graph as the
configuration file describes it: two VGG16 trunks at stride 8, the BEV RPN
with 4 anchors a location, the 3D proposal layer (decode, BEV clip,
min-size and image-bounds filters, stable top-K, greedy NMS), ROI pooling
of both views at 1/8, the fusion head, the corner decode, then the
per-class assembly on the host (threshold, NMS over BEV boxes, top-N cap).
"""

import numpy as np
import torch

from benchmark.reference import geometry as G
from benchmark.reference import judge, nets
from benchmark.reference.ops import nms_greedy, nms_np, roi_pool, top_k

PIXEL_MEANS = (95.8814, 98.7743, 93.8549)
BEV_HW = (601, 601)      # the proposal layer clips to the full raster


def features(weights, bev, image, q=nets.exact):
    """bev (H, W, 9) float32 and image (H', W', 3) uint8 tensors -> the two
    conv5_3 maps, (h, w, 512) each."""
    means = torch.tensor(PIXEL_MEANS, device=image.device)
    im = image.float() - means
    c5 = nets.trunk(weights, bev.float().permute(2, 0, 1)[None], "", 8, q)
    c5_2 = nets.trunk(weights, im.permute(2, 0, 1)[None], "_2", 8, q)
    return c5, c5_2


def anchors_all(weights, c5, calib, q=nets.exact):
    """Every anchor decoded: logit (N,) fg minus bg, prob (N,), p3d (N, 6),
    pbv (N, 4) clipped, pimg (N, 4)."""
    cls, box = nets.rpn(weights, c5, q)
    _, a3 = G.anchors_bv(c5.shape[2], c5.shape[3])
    p3d = G.bbox_transform_inv_3d(torch.from_numpy(a3).to(c5.device), box)
    return {"logit": cls[:, 1] - cls[:, 0],
            "prob": torch.softmax(cls, -1)[:, 1],
            "p3d": p3d,
            "pbv": G.clip_boxes(G.lidar_3d_to_bv(p3d), *BEV_HW),
            "pimg": G.lidar_cnr_to_img(G.lidar_3d_to_corners(p3d), calib)}


def passes(a, min_size=5.0, size_margin=0.0, image_margin=0.0):
    """The layer's filters: the BEV min-size filter tightened by
    ``size_margin`` pixels, the image-bounds filter by ``image_margin``."""
    pbv, pimg, m = a["pbv"], a["pimg"], image_margin
    return ((pbv[:, 2] - pbv[:, 0] + 1.0 >= min_size + size_margin)
            & (pbv[:, 3] - pbv[:, 1] + 1.0 >= min_size + size_margin)
            & (pimg[:, 0] >= -G.IMG_PAD + m)
            & (pimg[:, 2] <= G.IMG_BOUNDS[1] + G.IMG_PAD - m)
            & (pimg[:, 1] >= -G.IMG_PAD + m)
            & (pimg[:, 3] <= G.IMG_BOUNDS[0] + G.IMG_PAD - m))


def head(weights, c5, c5_2, rois_3d, calib, q=nets.exact):
    """The fusion head at (n, 6) lidar rois: (cls_prob (n, 2), regressed
    corners (n, 48), unregressed corners (n, 48), BEV boxes (n, 8))."""
    zeros = rois_3d.new_zeros(len(rois_3d), 1)
    cnr = G.lidar_3d_to_corners(rois_3d)
    rois_bv = torch.cat([zeros, G.clip_boxes(G.lidar_3d_to_bv(rois_3d),
                                             *BEV_HW)], 1)
    rois_img = torch.cat([zeros, G.lidar_cnr_to_img(cnr, calib)], 1)
    pooled_bv = roi_pool(c5[0].permute(1, 2, 0), rois_bv)
    pooled_img = roi_pool(c5_2[0].permute(1, 2, 0), rois_img)
    prob, bbox = nets.fusion_head(weights, pooled_bv, pooled_img, q)
    cnr2 = torch.cat([cnr, cnr], 1)
    return prob, G.bbox_transform_inv_cnr(cnr, bbox), cnr2, G.corners_to_bv(
        cnr2)


def detect(weights, bev, image, calib, test, q=nets.exact):
    """The whole detector on one frame: the program's output keys (scores,
    boxes_bv, boxes_cnr, boxes_cnr_r, rois_3d, valid) as numpy arrays."""
    c5, c5_2 = features(weights, bev, image, q)
    a = anchors_all(weights, c5, calib, q)
    k = min(test["pre_nms_top_n"], len(a["prob"]))
    top, top_valid = top_k(a["prob"], passes(a), k)
    keep, found = nms_greedy(a["pbv"][top], a["prob"][top], top_valid,
                             test["post_nms_top_n"], test["rpn_nms_thresh"])
    rois = a["p3d"][top[keep]]
    prob, cnr_r, cnr, bv = head(weights, c5, c5_2, rois, calib, q)
    m = found[:, None].float()
    out = {"scores": prob * m, "boxes_bv": bv * m, "boxes_cnr": cnr * m,
           "boxes_cnr_r": cnr_r * m,
           "rois_3d": torch.cat([torch.zeros_like(m), rois * m], 1),
           "valid": found}
    return {name: v.cpu().numpy() for name, v in out.items()}


def frame_detections(det, num_classes, score_thresh, nms_thresh,
                     max_per_image):
    """Per-class threshold, BEV NMS and the global top-N cap:
    {cls: (dets_bv (M, 5), dets_cnr (M, 25), dets_cnr_r (M, 25))}."""
    scores, valid = det["scores"], det["valid"]
    out, all_scores = {}, []
    for j in range(1, num_classes):
        inds = np.where(valid & (scores[:, j] > score_thresh))[0]
        cls_scores = scores[inds, j]
        dets = np.hstack([det["boxes_bv"][inds, j * 4:(j + 1) * 4],
                          cls_scores[:, None]]).astype(np.float32)
        keep = nms_np(dets, nms_thresh)
        out[j] = (dets[keep],
                  np.hstack([det["boxes_cnr"][inds, j * 24:(j + 1) * 24][keep],
                             cls_scores[keep, None]]),
                  np.hstack([det["boxes_cnr_r"][inds,
                                                j * 24:(j + 1) * 24][keep],
                             cls_scores[keep, None]]))
        all_scores.append(out[j][0][:, -1])
    if max_per_image > 0 and all_scores:
        flat = np.concatenate(all_scores)
        if len(flat) > max_per_image:
            thresh = np.sort(flat)[-max_per_image]
            for j in list(out):
                keep = np.where(out[j][0][:, -1] >= thresh)[0]
                out[j] = tuple(x[keep] for x in out[j])
    return out


def same_detections(a, b):
    """Whether two per-class outputs hold the same arrays, bit for bit."""
    if sorted(a) != sorted(b):
        return False
    return all(len(a[j]) == len(b[j]) and all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(a[j], b[j])) for j in a)


def log_sizes(boxes):
    """(n, 6) [x, y, z, l, w, h] -> [x, y, z, log l, log w, log h]: the
    decode's errors are of one scale in these coordinates (meters of the
    anchor's size times a delta's error, and a delta's error)."""
    return torch.cat([boxes[:, :3], torch.log(boxes[:, 3:6])], 1)


# margins of the judgement. The program's boxes come from bfloat16 deltas,
# a few centimetres off the reference's. A BEV box edge is a floor of meters
# to 0.1 m pixels, so it may sit one pixel off on each edge: on the small
# anchors' 10 x 6 pixel boxes that moves an IoU by up to 0.4. A box a few
# metres ahead projects into the image at some 100 pixels a metre, so its
# image edges may move by several pixels across the image-bounds filter.
# A candidate that the program's filter dropped and the reference's kept
# would stay free through every step; the margins keep such boxes out.
SIZE_MARGIN_PX = 2.0
IMAGE_MARGIN_PX = 16.0
IOU_MARGIN = 0.4
POOL_SHARE = 0.95
# matching: decoded boxes within this of the nearest (in meters and log
# sizes) count as one box, and the best-scoring of them is taken
MATCH_SLACK = 0.05


def judge_frame(weights, det, dets, bev, image, calib, cfg):
    """The numbers that judge one frame of the program: det its raw output
    (numpy, the detector's keys), dets its per-class detections; bev, image
    and calib the frame's inputs as tensors on the reference's device."""
    test = cfg["test"]
    dev = bev.device
    c5, c5_2 = features(weights, bev, image)
    a = anchors_all(weights, c5, calib)
    valid = torch.as_tensor(det["valid"], device=dev)
    rois = torch.as_tensor(det["rois_3d"], device=dev)[valid][:, 1:7]
    idx, dist = judge.match(log_sizes(rois), log_sizes(a["p3d"]), a["logit"],
                            MATCH_SLACK)
    cand = passes(a, size_margin=SIZE_MARGIN_PX,
                  image_margin=IMAGE_MARGIN_PX)
    k = min(test["pre_nms_top_n"], len(a["prob"]))
    order = top_k(a["prob"], passes(a), int(k * POOL_SHARE))[0]
    pool = torch.zeros_like(cand)
    pool[order] = True
    gap, missing = judge.gap(idx, a["logit"], a["pbv"], cand, pool & cand,
                             test["rpn_nms_thresh"], IOU_MARGIN,
                             test["post_nms_top_n"])
    own = G.clip_boxes(G.lidar_3d_to_bv(rois), *BEV_HW)
    prob, cnr_r, cnr, bv = head(weights, c5, c5_2, rois, calib)

    def got(key):
        return torch.as_tensor(det[key], device=dev)[valid].float()

    def err(key, ref):
        return float((got(key) - ref).abs().max()) if len(ref) else 0.0

    def logit(p):
        p = p.clamp(min=torch.finfo(torch.float32).tiny)
        return torch.log(p[:, 1]) - torch.log(p[:, 0])

    def rel(x, ref, scale):
        # the largest error over the spread of the reference's values
        if not len(ref):
            return 0.0
        return float((x - ref).abs().max() / scale.clamp(min=1e-12))

    ref_logit = logit(prob)
    offsets = cnr_r - cnr

    ref_dets = frame_detections(det, cfg["num_classes"], test["score_thresh"],
                                test["nms"], test["max_per_image"])
    return {"roi_err": float(dist.mean()) if len(dist) else 0.0,
            "nms_overlap": judge.overlap(own),
            "nms_gap": gap,
            "missing_rois": missing,
            "logit_err": rel(logit(got("scores")), ref_logit,
                             ref_logit.std() if len(ref_logit) > 1
                             else ref_logit.abs().max()),
            "offset_err": rel(got("boxes_cnr_r"), cnr_r,
                              offsets.abs().max() if len(offsets)
                              else cnr_r.new_ones(())),
            "box_err": max(err("boxes_cnr", cnr), err("boxes_bv", bv)),
            "dets_mismatch": int(not same_detections(dets, ref_dets))}
