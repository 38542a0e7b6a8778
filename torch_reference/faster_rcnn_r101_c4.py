"""Faster R-CNN ResNet-101 C4's im_detect in plain PyTorch, float32 with
TF32 off: the reference the port (mv3d_tf_tpu_torch, models/resnet.py and
faster_rcnn_2d.build_im_detect_2d) is held to. It imports neither the port
nor the JAX package, nor JAX.

The network is He et al., arXiv:1512.03385, Appendix A, at the widths of
Detectron2's configs/COCO-Detection/faster_rcnn_R_101_C4_3x.yaml: the
stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool with padding 1), res2-res4 of
3, 4 and 23 MSRA bottlenecks (the stride on the first 1x1 conv) shared at
stride 16, the RPN on res4 (3x3 conv 1024 with ReLU, 1x1 objectness and
deltas, 15 anchors), the proposal layer, RoI max pooling to 14x14 at 1/16,
res5's 3 bottlenecks per RoI, the mean over its 7x7 map, and the sibling
cls_score (softmax) and class-specific bbox_pred. Every BN is frozen and
applied as its own affine op after a bias-free conv, never folded.

Departures from Detectron2, each the port's 2D path's convention:
  * RoI max pooling (the paper's, and the port's kernel) in place of
    ROIAlignV2;
  * the RPN scores each anchor with a 2-way softmax (bg, fg) in place of
    one sigmoid logit;
  * py-faster-rcnn's anchors (base 16, ratios 0.5, 1, 2, ratio-major),
    box decode and clip with its +1 width convention;
  * bbox_pred regresses 81 x 4 outputs, the background's included, in
    place of 80 x 4;
  * the proposals' min-size filter drops boxes narrower or shorter than
    min_size times the image's scale, py-faster-rcnn's rule;
  * the weights are random (no trained weights are in the repository).

Weights are a dict {name: {"weight", and "gamma", "beta", "mean", "var"
for a conv with a BN, else "bias"}} under the names of the port's
models/resnet.py; tensors (H, W, 3) images and (3,) im_info [h, w,
scale].
"""

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
STRIDE = 16
SCALES = (2, 4, 8, 16, 32)
RATIOS = (0.5, 1.0, 2.0)
POOLED = 14
# (stage, blocks, bottleneck width, stride of the first block)
STAGES = (("res2", 3, 64, 1), ("res3", 4, 128, 2), ("res4", 23, 256, 2))
RES5 = ("res5", 3, 512, 2)


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def frozen_bn(x, d):
    """y = gamma (x - mean) / sqrt(var + eps) + beta, per channel (NCHW)."""
    def c(v):
        return v.reshape(1, -1, 1, 1)
    return c(d["gamma"]) * (x - c(d["mean"])) / torch.sqrt(c(d["var"]) + EPS) \
        + c(d["beta"])


def conv_bn(x, d, stride=1, relu=True):
    y = frozen_bn(F.conv2d(x, d["weight"], None, stride=stride,
                           padding=d["weight"].shape[-1] // 2), d)
    return F.relu(y) if relu else y


def bottleneck(w, x, name, stride):
    y = conv_bn(x, w[name + "conv1"], stride)
    y = conv_bn(y, w[name + "conv2"])
    y = conv_bn(y, w[name + "conv3"], relu=False)
    short = (conv_bn(x, w[name + "shortcut"], stride, relu=False)
             if name + "shortcut" in w else x)
    return F.relu(y + short)


def stage(w, x, spec):
    name, blocks, _, stride = spec
    for i in range(blocks):
        x = bottleneck(w, x, "%s_%d_" % (name, i), stride if i == 0 else 1)
    return x


def trunk(w, image):
    """image (H, W, 3) -> res4 (1, 1024, H/16, W/16)."""
    x = conv_bn(image.permute(2, 0, 1)[None], w["conv1"], stride=2)
    x = F.max_pool2d(x, 3, 2, 1)
    for spec in STAGES:
        x = stage(w, x, spec)
    return x


def res5(w, pooled):
    """pooled (R, 14, 14, 1024) -> (R, 2048): res5, then the mean."""
    return stage(w, pooled.permute(0, 3, 1, 2), RES5).mean(dim=(2, 3))


def rpn(w, feat):
    """-> (cls (h*w*A, 2) logits, deltas (h*w*A, 4)), location-major."""
    def conv(x, name, relu):
        y = F.conv2d(x, w[name]["weight"], w[name]["bias"],
                     padding=w[name]["weight"].shape[-1] // 2)
        return F.relu(y) if relu else y
    x = conv(feat, "rpn_conv/3x3", True)
    cls = conv(x, "rpn_cls_score", False)[0].permute(1, 2, 0)
    box = conv(x, "rpn_bbox_pred", False)[0].permute(1, 2, 0)
    return cls.reshape(-1, 2), box.reshape(-1, 4)


def anchors(feat_h, feat_w):
    """py-faster-rcnn's anchors at base 16, ratio-major, shifted over the
    grid location-major: (h*w*15, 4) float32."""
    base = []
    for r in RATIOS:
        size = 16.0 * 16.0
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in SCALES:
            w, h = ws * s, hs * s
            base.append([7.5 - 0.5 * (w - 1), 7.5 - 0.5 * (h - 1),
                         7.5 + 0.5 * (w - 1), 7.5 + 0.5 * (h - 1)])
    base = np.array(base)
    sx, sy = np.meshgrid(np.arange(feat_w) * STRIDE,
                         np.arange(feat_h) * STRIDE)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    return (shifts[:, None, :] + base[None]).reshape(-1, 4).astype(np.float32)


def decode(boxes, deltas):
    """(N, 4) boxes and (N, 4K) deltas -> (N, 4K) boxes, +1 widths."""
    w = boxes[:, 2:3] - boxes[:, 0:1] + 1.0
    h = boxes[:, 3:4] - boxes[:, 1:2] + 1.0
    cx, cy = boxes[:, 0:1] + 0.5 * w, boxes[:, 1:2] + 0.5 * h
    pcx, pcy = deltas[:, 0::4] * w + cx, deltas[:, 1::4] * h + cy
    pw, ph = torch.exp(deltas[:, 2::4]) * w, torch.exp(deltas[:, 3::4]) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                        pcy + 0.5 * ph], 2).reshape(deltas.shape)


def clip(boxes, h, w):
    b = boxes.reshape(len(boxes), -1, 4)
    lim = torch.tensor([w - 1, h - 1, w - 1, h - 1], device=boxes.device)
    return torch.minimum(b.clamp(min=0), lim).reshape(boxes.shape)


def iou(a, b):
    """(n, 4) x (m, 4) -> (n, m), +1 widths, 0 where they do not meet."""
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1.0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1.0)
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    out = inter / (area_a[:, None] + area_b[None, :] - inter)
    return torch.where((iw > 0) & (ih > 0), out, 0.0)


def greedy_nms(boxes, thresh, max_out):
    """Boxes in descending score order: the indices kept, at most max_out;
    each kept box takes out every later box with IoU >= thresh."""
    alive = torch.ones(len(boxes), dtype=torch.bool, device=boxes.device)
    keep = []
    for i in range(len(boxes)):
        if len(keep) == max_out:
            break
        if not alive[i]:
            continue
        keep.append(i)
        alive &= iou(boxes[i:i + 1], boxes)[0] < thresh
    return torch.tensor(keep, dtype=torch.long, device=boxes.device)


def proposals(cls, box, feat_h, feat_w, im_info, pre_nms, post_nms, thresh,
              min_size):
    """Decode, clip to the image, the min-size filter, the pre_nms best by
    a stable sort, greedy NMS: (n, 4) rois in keep order."""
    prob = torch.softmax(cls, -1)[:, 1]
    a = torch.from_numpy(anchors(feat_h, feat_w)).to(cls.device)
    boxes = clip(decode(a, box), float(im_info[0]), float(im_info[1]))
    thr = min_size * float(im_info[2])
    ok = ((boxes[:, 2] - boxes[:, 0] + 1.0 >= thr)
          & (boxes[:, 3] - boxes[:, 1] + 1.0 >= thr))
    idx = torch.nonzero(ok)[:, 0]
    order = idx[torch.sort(prob[idx], descending=True, stable=True)[1]]
    order = order[:pre_nms]
    return boxes[order][greedy_nms(boxes[order], thresh, post_nms)]


def roi_pool(feat, rois, pooled=POOLED, scale=1.0 / STRIDE):
    """RoI max pooling, Caffe's ROIPoolForward: feat (H, W, C), rois (n, 4)
    -> (n, pooled, pooled, C); an empty bin gives 0."""
    H, W, C = feat.shape

    def c_round(x):
        return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
    q = c_round(rois * scale).long()
    out = feat.new_zeros((len(rois), pooled, pooled, C))
    for r in range(len(rois)):
        x1, y1, x2, y2 = (int(v) for v in q[r])
        rw, rh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
        for ph in range(pooled):
            h0 = min(max(ph * rh // pooled + y1, 0), H)
            h1 = min(max(((ph + 1) * rh + pooled - 1) // pooled + y1, 0), H)
            for pw in range(pooled):
                w0 = min(max(pw * rw // pooled + x1, 0), W)
                w1 = min(max(((pw + 1) * rw + pooled - 1) // pooled + x1, 0),
                         W)
                if h1 > h0 and w1 > w0:
                    out[r, ph, pw] = feat[h0:h1, w0:w1].amax(dim=(0, 1))
    return out


def im_detect(w, image, im_info, pre_nms=6000, post_nms=1000, thresh=0.7,
              min_size=16):
    """The whole detector on one image: {"rois" (n, 4), "scores" (n, 81),
    "boxes" (n, 324)} at the n kept proposals."""
    feat = trunk(w, image)
    cls, box = rpn(w, feat)
    rois = proposals(cls, box, feat.shape[2], feat.shape[3], im_info,
                     pre_nms, post_nms, thresh, min_size)
    x = res5(w, roi_pool(feat[0].permute(1, 2, 0), rois))
    scores = torch.softmax(x @ w["cls_score"]["weight"].t()
                           + w["cls_score"]["bias"], -1)
    deltas = x @ w["bbox_pred"]["weight"].t() + w["bbox_pred"]["bias"]
    boxes = clip(decode(rois, deltas), float(im_info[0]), float(im_info[1]))
    return {"rois": rois, "scores": scores, "boxes": boxes}
