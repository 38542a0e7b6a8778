"""Mask R-CNN ResNet-101-FPN in plain PyTorch (float32, TF32 off), and the
comparison that judges one image of the program's output by it.

The networks are a frozen copy, as of the configuration's first benchmark,
of torch_reference/mask_rcnn_r101_fpn.py (its trunk from resnet_c4.py, run
whole), with each conv and fully connected layer's input and weight rounded
by ``q`` as in nets.py (``exact`` for the reference, ``fp8`` for the
control): the trunk to C2-C5, the pyramid P2-P6, the RPN over the levels,
the per-level proposals (top k, decode, clip, empties dropped, greedy NMS
within the level, the best over the levels), ROIAlignV2 on P2-P5 by
Detectron2's level rule, the 2-fc box head with its class-specific decode
(weights 10, 10, 5, 5), the class step on the host, and the mask head at
the class step's detections.

The judgement holds the program to what it promises, as frcnn.py's does
for one map, level by level (judge.py): each kept proposal is a decoded
anchor of the level the program names for it (its ``rpn_levels``: two
levels can decode nearly the same box, which distance alone cannot tell
apart); within a level no two kept boxes overlap by the
threshold and each scores no lower than the best free candidate of its
level at its step; over the levels no free candidate outscores the lowest
kept one by a margin (``missing_rois``). Then the head at the program's
rois by the reference's own RoIAlign, the levels the kernel chose against
the rule, the class step, and the mask logits at the program's
detections.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import judge
from benchmark.reference import resnet_c4 as net
from benchmark.reference.frcnn import (IOU_MARGIN, MATCH_SLACK_PX,
                                       class_detections, same_detections)
from benchmark.reference.nets import exact
from benchmark.reference.ops import nms_greedy

LEVELS = (2, 3, 4, 5, 6)
SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
SCALE_CLAMP = math.log(1000.0 / 16)
# the candidates a level's judgement sees: its best this share of the
# pre-NMS top k by the reference's logit (the program's top k, from its
# bfloat16 logits, reaches a little past the reference's)
CAND_SHARE = 1.5
# a level's pool, the candidates the program's top k must hold: the best
# this share of k by the reference. P2's 163,200 logits put some 36 of them
# in one bfloat16 step at its 1000th, so the program's rank there moves by
# tens to a hundred; a fifth of k is room (frcnn.py's 0.95 is one map's)
POOL_SHARE = 0.8
# candidates for the gap and the merge: boxes wider and taller than this.
# The program drops empty boxes after the clip; a box a few pixels wide
# that the reference keeps can be empty in the program's, whose P6 edges
# carry errors of some pixels
EMPTY_MARGIN_PX = 8.0
# a free candidate of some level that outscores the lowest kept proposal
# by this many of the logits' standard deviations is a slot given to a
# worse box (bfloat16 moves a logit by a few hundredths of it)
MERGE_MARGIN = 0.25
# the mask logits compared as logit(p) of the program's probabilities,
# both sides clamped where a float32 sigmoid saturates
MASK_EPS = 1e-6


def trunk(w, image, q=exact):
    """image (H, W, 3) -> [C2, C3, C4, C5] NCHW at strides 4-32."""
    x = net.conv_bn(image.permute(2, 0, 1)[None], w["conv1"], q, stride=2)
    x = F.max_pool2d(x, 3, 2, 1)
    out = []
    for spec in net.STAGES + (net.RES5,):
        x = net.stage(w, x, spec, q)
        out.append(x)
    return out


def conv(w, name, x, q=exact, relu=False):
    d = w[name]
    y = F.conv2d(q(x), q(d["weight"]), d["bias"],
                 padding=d["weight"].shape[-1] // 2)
    return F.relu(y) if relu else y


def fpn(w, feats, q=exact):
    """[C2..C5] -> [P2..P6], NCHW, 256 channels."""
    lat = [conv(w, "fpn_lateral%d" % k, c, q) for k, c in zip((2, 3, 4, 5),
                                                                feats)]
    m = [None] * 4
    m[3] = lat[3]
    for i in (2, 1, 0):
        m[i] = lat[i] + F.interpolate(m[i + 1], scale_factor=2.0,
                                      mode="nearest")
    p = [conv(w, "fpn_output%d" % k, x, q) for k, x in zip((2, 3, 4, 5), m)]
    return p + [F.max_pool2d(p[3], kernel_size=1, stride=2)]


def rpn(w, p, q=exact):
    """One level: (logits (H*W*3,), deltas (H*W*3, 4)), location-major."""
    h = conv(w, "rpn_conv", p, q, relu=True)
    logits = conv(w, "rpn_cls_score", h, q)[0].permute(1, 2, 0).reshape(-1)
    deltas = conv(w, "rpn_bbox_pred", h, q)[0].permute(1, 2, 0).reshape(-1,
                                                                        4)
    return logits, deltas


def anchors(h, w, level):
    """(h*w*3, 4) anchors of a level: size 2^(level+3) at stride 2^level,
    ratios fastest, centred on (x, y) x stride, corners c -/+ (w - 1) / 2
    (torch_reference's loops, written with arrays)."""
    stride, size = 2 ** level, SIZES[level - 2]
    half = []
    for r in RATIOS:
        aw = math.sqrt(size * size / r)
        ah = r * aw
        half.append(((aw - 1) / 2, (ah - 1) / 2))
    half = np.array(half)
    ys, xs = np.meshgrid(np.arange(h) * stride, np.arange(w) * stride,
                         indexing="ij")
    c = np.stack([xs, ys], -1)[:, :, None, :].astype(np.float64)
    out = np.concatenate([c - half, c + half], -1)
    return torch.from_numpy(out.reshape(-1, 4).astype(np.float32))


def decode(boxes, deltas, weights, clamp=SCALE_CLAMP):
    """(n, 4) boxes and (n, 4K) deltas -> (n, 4K) boxes, +1 widths, each
    delta divided by its weight, dw and dh clamped."""
    w = boxes[:, 2:3] - boxes[:, 0:1] + 1.0
    h = boxes[:, 3:4] - boxes[:, 1:2] + 1.0
    cx, cy = boxes[:, 0:1] + 0.5 * w, boxes[:, 1:2] + 0.5 * h
    dx, dy = deltas[:, 0::4] / weights[0], deltas[:, 1::4] / weights[1]
    dw = torch.clamp(deltas[:, 2::4] / weights[2], max=clamp)
    dh = torch.clamp(deltas[:, 3::4] / weights[3], max=clamp)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                        pcy + 0.5 * ph], 2).reshape(deltas.shape)


def level_boxes(w, maps, im_info, q=exact):
    """Per RPN level: (logits (N_l,), every anchor's decoded, clipped box
    (N_l, 4))."""
    out = []
    for level, p in zip(LEVELS, maps):
        logits, deltas = rpn(w, p, q)
        a = anchors(p.shape[2], p.shape[3], level).to(p.device)
        boxes = G.clip_boxes(decode(a, deltas, (1.0,) * 4),
                             float(im_info[0]), float(im_info[1]))
        out.append((logits, boxes))
    return out


def assign_levels(boxes):
    """Detectron2's level of each (n, 4) box, 2..5."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    # divided by a tensor (a card's division by a Python number multiplies
    # by the rounded reciprocal); floor(log2(s)) as s's binary exponent,
    # exact where a rounded log2 could cross an integer
    s = torch.sqrt(area) / torch.full_like(area, 224.0) + 1e-8
    return (4 + torch.frexp(s).exponent.long() - 1).clamp(2, 5)


def roi_align(maps, boxes, pooled, levels=None):
    """ROIAlignV2 of (n, 4) image-pixel boxes over [P2..P5] (NCHW, one
    image): (n, C, pooled, pooled)."""
    levels = assign_levels(boxes) if levels is None else levels
    C = maps[0].shape[1]
    out = boxes.new_zeros((len(boxes), C, pooled, pooled))
    for k, fmap in zip((2, 3, 4, 5), maps):
        sel = torch.nonzero(levels == k)[:, 0]
        if len(sel):
            out[sel] = _align_level(fmap[0], boxes[sel] * (0.5 ** k) - 0.5,
                                    pooled)
    return out


def _align_level(fmap, b, P):
    """(r, 4) boxes in map cells (already shifted) on (C, H, W)."""
    C, H, W = fmap.shape
    flat = fmap.reshape(C, H * W)
    rw, rh = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    bw, bh = rw / P, rh / P
    gw, gh = torch.ceil(rw / P).long(), torch.ceil(rh / P).long()
    count = (gw * gh).clamp(min=1).float()
    out = b.new_zeros((len(b), C, P, P))
    idx = torch.arange(P, device=b.device, dtype=torch.float32)
    for iy in range(int(gh.max().clamp(min=0))):
        for ix in range(int(gw.max().clamp(min=0))):
            ys = (b[:, 1:2] + idx * bh[:, None]
                  + (iy + 0.5) * bh[:, None] / gh.clamp(min=1)[:, None])
            xs = (b[:, 0:1] + idx * bw[:, None]
                  + (ix + 0.5) * bw[:, None] / gw.clamp(min=1)[:, None])
            y = ys[:, :, None].expand(-1, P, P)
            x = xs[:, None, :].expand(-1, P, P)
            used = ((iy < gh)[:, None, None] & (ix < gw)[:, None, None]
                    & (y >= -1) & (y <= H) & (x >= -1) & (x <= W))
            y, x = y.clamp(min=0), x.clamp(min=0)
            y0, x0 = y.floor().long(), x.floor().long()
            ylast, xlast = y0 >= H - 1, x0 >= W - 1
            y0, x0 = y0.clamp(max=H - 1), x0.clamp(max=W - 1)
            y1 = torch.where(ylast, y0, y0 + 1)
            x1 = torch.where(xlast, x0, x0 + 1)
            y = torch.where(ylast, y0.float(), y)
            x = torch.where(xlast, x0.float(), x)
            ly, lx = y - y0, x - x0
            hy, hx = 1 - ly, 1 - lx

            def at(yy, xx):
                return flat[:, (yy * W + xx).reshape(-1)].reshape(
                    C, len(b), P, P).permute(1, 0, 2, 3)
            v = ((hy * hx)[:, None] * at(y0, x0) + (hy * lx)[:, None]
                 * at(y0, x1) + (ly * hx)[:, None] * at(y1, x0)
                 + (ly * lx)[:, None] * at(y1, x1))
            out = out + torch.where(used[:, None], v, 0.0)
    return out / count[:, None, None, None]


def box_head(w, pooled, q=exact):
    """(n, 256, 7, 7) -> (cls_prob (n, 81), deltas (n, 320))."""
    x = pooled.reshape(len(pooled), -1)

    def fc(name, x):
        return q(x) @ q(w[name]["weight"]).t() + w[name]["bias"]
    x = F.relu(fc("fc7", F.relu(fc("fc6", x))))
    return torch.softmax(fc("cls_score", x), -1), fc("bbox_pred", x)


def detections(w, maps, rois, im_info, q=exact):
    """cls_prob (n, 81) and (n, 320) decoded, clipped class boxes at (n, 4)
    rois."""
    prob, deltas = box_head(w, roi_align(maps[:4], rois, 7), q)
    boxes = G.clip_boxes(decode(rois, deltas, BOX_WEIGHTS),
                         float(im_info[0]), float(im_info[1]))
    return prob, boxes


def mask_logits(w, pooled, q=exact):
    """(n, 256, 14, 14) -> (n, 80, 28, 28) logits."""
    x = pooled
    for i in range(1, 5):
        x = conv(w, "mask_fcn%d" % i, x, q, relu=True)
    d = w["mask_deconv"]
    x = F.relu(F.conv_transpose2d(q(x), q(d["weight"]), d["bias"], stride=2))
    return conv(w, "mask_predictor", x, q)


def det_boxes(dets, im_scale, device):
    """The class step's detections as the mask stage takes them: (n, 4)
    boxes scaled back by im_scale in float32, and (n,) classes."""
    boxes = np.concatenate([d[:, :4] for d in dets]).astype(
        np.float32) * np.float32(im_scale)
    cls = np.repeat(np.arange(len(dets)), [len(d) for d in dets])
    return torch.from_numpy(boxes).to(device), torch.from_numpy(cls).to(
        device)


def class_logits(w, maps, boxes, cls, q=exact):
    """(n, 28, 28) logits of each detection's class channel, c - 1."""
    logits = mask_logits(w, roi_align(maps[:4], boxes, 14), q)
    return logits[torch.arange(len(cls), device=cls.device), cls - 1]


def im_detect(w, image, im_info, cfg, q=exact):
    """The whole detector and its mask stage on one image, in the
    program's form: (det {scores (P, 81), boxes (P, 324), rois (P, 5),
    valid, levels, rpn_levels}, dets per class, masks {"masks",
    "levels"}), numpy."""
    test, dev = cfg["test"], image.device
    k, post = test["pre_nms_top_n"], test["post_nms_top_n"]
    maps = fpn(w, trunk(w, image, q), q)
    boxes_all, sc_all, lv_all = [], [], []
    for level, (logits, boxes) in zip(LEVELS, level_boxes(w, maps, im_info,
                                                          q)):
        top = torch.sort(logits, descending=True, stable=True)[1][:k]
        b, s = boxes[top], logits[top]
        ok = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        keep, found = nms_greedy(b, s, ok, min(k, post),
                                 test["rpn_nms_thresh"])
        boxes_all.append(b[keep][found])
        sc_all.append(s[keep][found])
        lv_all.append(torch.full((int(found.sum()),), level, device=dev))
    boxes, sc, lv = (torch.cat(x) for x in (boxes_all, sc_all, lv_all))
    order = torch.sort(sc, descending=True, stable=True)[1][:post]
    rois, n = boxes[order], len(order)
    prob, cls_boxes = detections(w, maps, rois, im_info, q)
    P = post
    det = {"scores": torch.zeros(P, prob.shape[1], device=dev),
           "boxes": torch.zeros(P, 4 * prob.shape[1], device=dev),
           "rois": torch.zeros(P, 5, device=dev),
           "valid": torch.arange(P, device=dev) < n,
           "levels": torch.full((P,), 2, dtype=torch.int32, device=dev),
           "rpn_levels": torch.full((P,), 2, dtype=torch.int32, device=dev)}
    det["scores"][:n], det["boxes"][:n, 4:] = prob, cls_boxes
    det["rois"][:n, 1:] = rois
    det["levels"][:n] = assign_levels(rois).int()
    det["rpn_levels"][:n] = lv[order].int()
    det = {key: v.cpu().numpy() for key, v in det.items()}
    dets = class_detections(det, float(im_info[2]), test["score_thresh"],
                            test["nms"], test["max_per_image"])
    boxes, cls = det_boxes(dets, float(im_info[2]), dev)
    probs = (torch.sigmoid(class_logits(w, maps, boxes, cls, q)).cpu()
             .numpy() if len(cls) else np.zeros((0, 28, 28), np.float32))
    masks = {"masks": np.split(probs, np.cumsum([len(d) for d in dets])[:-1]),
             "levels": assign_levels(boxes).int().cpu().numpy()}
    return det, dets, masks


def _match_in_level(rois, boxes, logits, level_of, level):
    """Each roi's candidate within the level the program names for it
    (``level``, an index into LEVELS): judge.match's, the best-scoring of
    the level's boxes within MATCH_SLACK_PX of the nearest. Two levels can
    give nearly the same box, which no match by distance tells apart."""
    idx = torch.zeros(len(rois), dtype=torch.long, device=rois.device)
    for lv in level.unique():
        sel = level == lv
        in_lv = torch.nonzero(level_of == lv)[:, 0]
        got, _ = judge.match(rois[sel], boxes[in_lv], logits[in_lv],
                             MATCH_SLACK_PX)
        idx[sel] = in_lv[got]
    return idx


def _logit(p):
    p = np.clip(np.asarray(p, np.float64), MASK_EPS, 1 - MASK_EPS)
    return np.log(p / (1 - p))


def judge_image(w, det, dets, masks, image, im_info, cfg):
    """The numbers that judge one image of the program: det its raw output,
    dets its class step, masks its mask stage (numpy); image (H, W, 3)
    float32 and im_info (3,) as the program got them, on the reference's
    device."""
    test = cfg["test"]
    dev = image.device
    k, post = test["pre_nms_top_n"], test["post_nms_top_n"]
    thresh = test["rpn_nms_thresh"]
    maps = fpn(w, trunk(w, image))
    # each level's candidates: its best CAND_SHARE x k by the logit
    cand = []
    for lv, (logits, boxes) in zip(LEVELS, level_boxes(w, maps, im_info)):
        top = torch.sort(logits, descending=True,
                         stable=True)[1][:int(k * CAND_SHARE)]
        b = boxes[top]
        ok = ((b[:, 2] - b[:, 0] > EMPTY_MARGIN_PX)
              & (b[:, 3] - b[:, 1] > EMPTY_MARGIN_PX))
        pool = torch.arange(len(top), device=dev) < int(
            min(k, len(logits)) * POOL_SHARE)
        cand.append((logits[top], b, ok, pool & ok))
    logit_all = torch.cat([c[0] for c in cand])
    box_all = torch.cat([c[1] for c in cand])
    level_of = torch.cat([torch.full((len(c[0]),), i, device=dev)
                          for i, c in enumerate(cand)])
    start = torch.cumsum(torch.tensor([0] + [len(c[0]) for c in cand[:-1]],
                                      device=dev), 0)
    sigma = logit_all[torch.cat([c[2] for c in cand])].std().clamp(
        min=1e-12)

    valid = torch.as_tensor(det["valid"], device=dev)
    rois = torch.as_tensor(det["rois"], device=dev)[valid][:, 1:5]
    n = len(rois)
    claimed = torch.as_tensor(det["rpn_levels"], device=dev)[valid].long()
    idx = _match_in_level(rois, box_all, logit_all, level_of,
                          claimed - LEVELS[0])
    gap_sum, overlap, free_logits = 0.0, 0.0, []
    for i, (logits, boxes, ok, pool) in enumerate(cand):
        sel = level_of[idx] == i
        kept = idx[sel] - start[i]
        if len(kept):
            if int(ok.sum()) > 1:     # a spread of the logits to scale by
                g, _ = judge.gap(kept, logits, boxes, ok, pool, thresh,
                                 IOU_MARGIN, k)
                gap_sum += g * len(kept)
            overlap = max(overlap, judge.overlap(rois[sel]))
            hit = (G.bbox_overlaps(boxes[kept], boxes)
                   >= thresh - IOU_MARGIN).any(0)
            hit[kept] = True
        else:
            hit = torch.zeros_like(pool)
        free_logits.append(logits[pool & ~hit])
    free = torch.cat(free_logits)
    if n < post:
        missing = min(post - n, len(free))
    else:
        cut = logit_all[idx].min()
        missing = int((free > cut + MERGE_MARGIN * sigma).sum())

    prob, boxes = detections(w, maps, rois, im_info)

    def err(key, ref, cols=slice(None)):
        got = torch.as_tensor(det[key], device=dev)[valid][:, cols].float()
        return float((got - ref).abs().max()) if len(ref) else 0.0

    level_mismatch = int((torch.as_tensor(det["levels"], device=dev)[valid]
                          .long() != assign_levels(rois)).sum())
    mask_err = 0.0
    d_boxes, cls = det_boxes(dets, float(im_info[2]), dev)
    if len(cls):
        level_mismatch += int((torch.as_tensor(masks["levels"], device=dev)
                               .long() != assign_levels(d_boxes)).sum())
        ref_logit = class_logits(w, maps, d_boxes, cls).cpu().double()
        got = torch.from_numpy(_logit(np.concatenate(masks["masks"])))
        lim = float(_logit(1 - MASK_EPS))
        mask_err = float((got - ref_logit.clamp(-lim, lim)).abs().max()
                         / ref_logit.std().clamp(min=1e-12))
    ref_dets = class_detections(det, float(im_info[2]), test["score_thresh"],
                                test["nms"], test["max_per_image"])
    return {"nms_overlap": overlap,
            "nms_gap": gap_sum / max(n, 1),
            "missing_rois": missing,
            "score_err": err("scores", prob),
            "box_err_px": err("boxes", boxes, slice(4, None)),
            "level_mismatch": level_mismatch,
            "mask_err": mask_err,
            "dets_mismatch": int(not same_detections(dets, ref_dets))}
