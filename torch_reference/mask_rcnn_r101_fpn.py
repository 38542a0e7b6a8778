"""Mask R-CNN ResNet-101-FPN's test-time forward pass in plain PyTorch,
float32 with TF32 off: the reference the port (mv3d_tf_tpu_torch,
models/fpn.py, faster_rcnn_2d.build_im_detect_2d and build_im_mask_2d,
ops/roi_align.py) is held to. It imports neither the port nor the JAX
package, nor JAX; the trunk's blocks are faster_rcnn_r101_c4.py's.

The network is He et al., arXiv:1703.06870, with the feature pyramid of Lin
et al., arXiv:1612.03144, at the sizes and test settings of Detectron2's
configs/COCO-InstanceSegmentation/mask_rcnn_R_101_FPN_3x.yaml over
Base-RCNN-FPN.yaml:
  * the R-101 trunk (frozen BN applied after each bias-free conv, never
    folded) run whole, res5 too, to C2-C5 at strides 4-32;
  * FPN: lateral 1x1 convs with bias, the top-down sum with nearest 2x
    upsampling, 3x3 output convs with bias and no ReLU, P6 = P5 at stride 2;
  * one RPN head over P2-P6 (3x3 conv and ReLU, 3 objectness logits, 12
    deltas), one anchor size a level (32-512) at ratios 0.5, 1 and 2;
  * proposals: the top 1000 by logit a level, decoded (weights 1, scale
    clamp log(1000/16)), clipped, empty boxes dropped, greedy NMS at 0.7
    within each level, the best 1000 over the levels;
  * ROIAlignV2 (aligned, sampling ratio 0) at 7x7 on P2-P5, level
    k = clamp(floor(4 + log2(sqrt(area) / 224 + 1e-8)), 2, 5) (floor(log2)
    as the binary exponent, exact);
  * the box head (fc 1024, ReLU, fc 1024, ReLU; cls_score with softmax,
    bbox_pred 80 x 4 decoded with weights (10, 10, 5, 5) and clipped);
  * the class step: score > 0.05, greedy NMS at 0.5 per class, the best
    100 of the image, in the original image's coordinates;
  * the mask head on the detections' boxes: ROIAlignV2 at 14x14, 4 x
    conv3x3 and ReLU, deconv 2x2/2 and ReLU, conv1x1 to 80, the sigmoid of
    channel c - 1 for a detection of class c.

Departures from Detectron2, each the port's convention:
  * py-faster-rcnn's +1 widths in the anchors, the box decode, the clip
    (to [0, w - 1]) and every IoU; anchors centred on each cell's corner as
    Detectron2's, with corners c -/+ (w - 1) / 2;
  * the proposals' and detections' ties broken by index (stable sorts);
  * masks stay 28x28 probabilities, not pasted at the image's size;
  * the weights are random (no trained weights are in the repository).
Level assignment and RoIAlign take Detectron2's areas and sizes (no +1).

Weights are a dict {name: {"weight", and "gamma", "beta", "mean", "var"
for a conv with a BN, else "bias"}} under the names of the port's
models/fpn.py: fc6's weight (1024, 256 x 7 x 7) in (c, h, w) input order,
the deconv's (in, out, 2, 2). Images are (H, W, 3) float32 with the pixel
means subtracted, H and W multiples of 32; im_info (3,) [h, w, scale].
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from torch_reference import faster_rcnn_r101_c4 as c4
from torch_reference.faster_rcnn_r101_c4 import greedy_nms

SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
SCALE_CLAMP = math.log(1000.0 / 16)
no_tf32 = c4.no_tf32


def trunk(w, image):
    """image (H, W, 3) -> [C2, C3, C4, C5] NCHW at strides 4, 8, 16, 32."""
    x = c4.conv_bn(image.permute(2, 0, 1)[None], w["conv1"], stride=2)
    x = F.max_pool2d(x, 3, 2, 1)
    out = []
    for spec in c4.STAGES + (c4.RES5,):
        x = c4.stage(w, x, spec)
        out.append(x)
    return out


def conv(w, name, x, relu=False, stride=1):
    d = w[name]
    y = F.conv2d(x, d["weight"], d["bias"], stride=stride,
                 padding=d["weight"].shape[-1] // 2)
    return F.relu(y) if relu else y


def fpn(w, feats):
    """[C2..C5] -> [P2..P6], NCHW, 256 channels."""
    lat = [conv(w, "fpn_lateral%d" % k, c) for k, c in zip((2, 3, 4, 5),
                                                             feats)]
    m = [None] * 4
    m[3] = lat[3]
    for i in (2, 1, 0):
        m[i] = lat[i] + F.interpolate(m[i + 1], scale_factor=2.0,
                                      mode="nearest")
    p = [conv(w, "fpn_output%d" % k, x) for k, x in zip((2, 3, 4, 5), m)]
    return p + [F.max_pool2d(p[3], kernel_size=1, stride=2)]


def rpn(w, p):
    """One level: (logits (H*W*3,), deltas (H*W*3, 4)), location-major."""
    h = conv(w, "rpn_conv", p, relu=True)
    logits = conv(w, "rpn_cls_score", h)[0].permute(1, 2, 0).reshape(-1)
    deltas = conv(w, "rpn_bbox_pred", h)[0].permute(1, 2, 0).reshape(-1, 4)
    return logits, deltas


def anchors(h, w, level):
    """(h*w*3, 4) anchors of a level: size 2^(level+3) at stride 2^level,
    ratios fastest, centred on (x, y) x stride, corners c -/+ (w - 1) / 2."""
    stride, size = 2 ** level, SIZES[level - 2]
    out = np.zeros((h, w, len(RATIOS), 4))
    for a, r in enumerate(RATIOS):
        aw = math.sqrt(size * size / r)
        ah = r * aw
        for y in range(h):
            for x in range(w):
                cx, cy = x * stride, y * stride
                out[y, x, a] = (cx - (aw - 1) / 2, cy - (ah - 1) / 2,
                                cx + (aw - 1) / 2, cy + (ah - 1) / 2)
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


def proposals(maps, w, im_info, pre_nms=1000, post_nms=1000, thresh=0.7):
    """The RPN over [P2..P6] to (rois (n, 4), logits (n,), level (n,)),
    n <= post_nms, by descending logit."""
    boxes_all, sc_all, lv_all = [], [], []
    for level, p in zip((2, 3, 4, 5, 6), maps):
        logits, deltas = rpn(w, p)
        a = anchors(p.shape[2], p.shape[3], level).to(p.device)
        order = torch.sort(logits, descending=True, stable=True)[1][:pre_nms]
        boxes = c4.clip(decode(a[order], deltas[order], (1.0,) * 4),
                        float(im_info[0]), float(im_info[1]))
        ok = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, sc = boxes[ok], logits[order][ok]
        keep = greedy_nms(boxes, thresh, post_nms)
        boxes_all.append(boxes[keep])
        sc_all.append(sc[keep])
        lv_all.append(torch.full((len(keep),), level, device=p.device))
    boxes, sc, lv = (torch.cat(x) for x in (boxes_all, sc_all, lv_all))
    order = torch.sort(sc, descending=True, stable=True)[1][:post_nms]
    return boxes[order], sc[order], lv[order]


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
    image): (n, C, pooled, pooled). Each box at its level (assign_levels,
    or ``levels``), scaled by 2^-k and shifted by -0.5; each bin the mean
    of ceil(h / pooled) x ceil(w / pooled) bilinear samples; a sample
    outside [-1, H] x [-1, W] is 0, one inside is clamped to the map."""
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


def box_head(w, pooled):
    """(n, 256, 7, 7) -> (cls_prob (n, 81), deltas (n, 320))."""
    x = pooled.reshape(len(pooled), -1)
    for name in ("fc6", "fc7"):
        x = F.relu(x @ w[name]["weight"].t() + w[name]["bias"])
    cls = x @ w["cls_score"]["weight"].t() + w["cls_score"]["bias"]
    return (torch.softmax(cls, -1),
            x @ w["bbox_pred"]["weight"].t() + w["bbox_pred"]["bias"])


def detections(w, maps, rois, im_info):
    """cls_prob (n, 81) and (n, 320) decoded, clipped class boxes at (n, 4)
    rois."""
    prob, deltas = box_head(w, roi_align(maps[:4], rois, 7))
    boxes = c4.clip(decode(rois, deltas, BOX_WEIGHTS), float(im_info[0]),
                    float(im_info[1]))
    return prob, boxes


def class_detections(prob, boxes, im_scale, thresh=0.05, nms=0.5,
                     max_per_image=100):
    """The class step on (n, 81) probabilities and (n, 320) boxes in the
    network's input: [dets (m, 5) float32 numpy] per class in the original
    image's coordinates, class 0 empty; per class the scores above
    ``thresh`` by descending score, greedy NMS, then the image's best
    ``max_per_image``."""
    prob, boxes = prob.cpu(), boxes.cpu() / im_scale
    out = [np.zeros((0, 5), np.float32)]
    for j in range(1, prob.shape[1]):
        inds = torch.nonzero(prob[:, j] > thresh)[:, 0]
        sc = prob[inds, j]
        order = torch.sort(sc, descending=True, stable=True)[1]
        b = boxes[inds, 4 * (j - 1):4 * j][order]
        keep = greedy_nms(b, nms, len(b)) if len(b) else order[:0]
        out.append(torch.cat([b[keep], sc[order][keep, None]], 1).numpy())
    flat = np.concatenate([d[:, 4] for d in out[1:]])
    if max_per_image > 0 and len(flat) > max_per_image:
        t = np.sort(flat)[-max_per_image]
        out = [out[0]] + [d[d[:, 4] >= t] for d in out[1:]]
    return out


def mask_logits(w, pooled):
    """(n, 256, 14, 14) -> (n, 80, 28, 28) logits."""
    x = pooled
    for i in range(1, 5):
        x = conv(w, "mask_fcn%d" % i, x, relu=True)
    d = w["mask_deconv"]
    x = F.relu(F.conv_transpose2d(x, d["weight"], d["bias"], stride=2))
    return conv(w, "mask_predictor", x)


def masks(w, maps, dets, im_scale):
    """The mask head at the class step's detections: [(n_j, 28, 28)
    probabilities] a class, each detection's boxes scaled back by
    im_scale (float32) onto the network's input, its class's channel."""
    boxes = np.concatenate([d[:, :4] for d in dets]).astype(
        np.float32) * np.float32(im_scale)
    cls = np.repeat(np.arange(len(dets)), [len(d) for d in dets])
    if not len(boxes):
        return [np.zeros((0, 28, 28), np.float32) for _ in dets]
    boxes = torch.from_numpy(boxes).to(maps[0].device)
    logits = mask_logits(w, roi_align(maps[:4], boxes, 14))
    sel = logits[torch.arange(len(cls)), torch.from_numpy(cls - 1)]
    probs = torch.sigmoid(sel).cpu().numpy()
    return np.split(probs, np.cumsum([len(d) for d in dets])[:-1])


def im_detect(w, image, im_info, pre_nms=1000, post_nms=1000, thresh=0.05,
              nms=0.5, max_per_image=100):
    """The whole forward pass on one image: {"rois" (n, 4), "scores" (n,
    81), "boxes" (n, 320), "dets" [per class], "masks" [per class]}. TF32
    is turned off first."""
    no_tf32()
    maps = fpn(w, trunk(w, image))
    rois, _, _ = proposals(maps, w, im_info, pre_nms, post_nms)
    prob, boxes = detections(w, maps, rois, im_info)
    dets = class_detections(prob, boxes, float(im_info[2]), thresh, nms,
                            max_per_image)
    return {"rois": rois, "scores": prob, "boxes": boxes, "dets": dets,
            "masks": masks(w, maps, dets, float(im_info[2]))}
