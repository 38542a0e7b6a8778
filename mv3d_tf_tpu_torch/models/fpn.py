"""Mask R-CNN ResNet-101-FPN (He et al., arXiv:1703.06870; Lin et al.,
arXiv:1612.03144), at the sizes of Detectron2's
configs/COCO-InstanceSegmentation/mask_rcnn_R_101_FPN_3x.yaml over
Base-RCNN-FPN.yaml: the R-101 trunk of models/resnet.py run whole (res5
too) to C2-C5, the feature pyramid P2-P6, one RPN head shared over the
levels, the 2-fc box head over 7x7 RoIAlign of P2-P5, and the mask head
over 14x14 RoIAlign of the detections.

  * FPN: L_i = conv1x1(C_i) with bias, M_5 = L_5, M_i = L_i +
    up2_nearest(M_{i+1}), P_i = conv3x3(M_i) with bias and no ReLU, P6 =
    max_pool(P5, kernel 1, stride 2); 256 channels a level.
  * RPN: h = ReLU(conv3x3(P)), objectness conv1x1 -> 3 (one logit an
    anchor), deltas conv1x1 -> 12; one anchor size a level (32-512 at
    strides 4-64) at ratios 0.5, 1, 2 (``anchors``).
  * Box head: flatten(7x7x256) -> fc 1024 -> ReLU -> fc 1024 -> ReLU, then
    cls_score (81, softmax) and bbox_pred (80 x 4, class-specific),
    decoded with weights (10, 10, 5, 5) and the scale clamp log(1000/16).
  * Mask head: 4 x ReLU(conv3x3 256), ReLU(deconv 2x2/2 256) to 28x28,
    conv1x1 -> 80; a detection of class c keeps the sigmoid of channel c-1.

Boxes follow the port's 2D convention (+1 widths in the anchors, the
decode, the clip and the NMS); the level rule and RoIAlign take
Detectron2's areas and sizes (ops/roi_align.py). Anchors are Detectron2's
sizes and ratios centred on each cell's corner (offset 0), written in the
+1 convention: corners c -/+ (w - 1) / 2.

Conventions are models/resnet.py's: NHWC maps, each conv on the NCHW view
(channels_last), weights OIHW, the configuration's dtype for the convs and
fc6/fc7, the predictors in float32. Parameters are one ``nn.ModuleDict``:
resnet's folded trunk and the layers of ``plain_layers``; fc6's weight is
stored in (h, w, c) input order, so that the NHWC pooled maps flatten
without a copy (``params_from_raw``), and the deconv's weight keeps
conv_transpose2d's (in, out, 2, 2) layout.
"""

import math

import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch import trace as T
from mv3d_tf_tpu_torch.models import resnet, vgg

N_CLASSES = 81                        # COCO's 80 and the background
DIM = 256                             # the pyramid's channels
LEVELS = (2, 3, 4, 5, 6)              # P2-P6: the RPN's levels
POOL_LEVELS = (2, 3, 4, 5)            # the poolers' levels
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = len(ANCHOR_RATIOS)
BOX_POOLED, MASK_POOLED = 7, 14
FC_DIM = 1024
MASK_CONVS = 4
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
SCALE_CLAMP = math.log(1000.0 / 16)
PRE_NMS_PER_LEVEL, POST_NMS = 1000, 1000   # a level's top-k, kept in all
# He-normal gains (std sqrt(2 / fan_in) times the gain) of the layers whose
# outputs are scores or deltas: the pyramid's maps reach an RMS of some 9,
# and these give a trained model's spreads on them: objectness logits of
# 1.2-2.5, RPN deltas of 0.3, class logits of 2.7 (more of an image's rois
# pass the 0.05 threshold than the cap of 100 keeps), box deltas of 0.1
# (dx, dy) and 0.2 (dw, dh) after the weights, mask logits of 2; plain
# layers' biases are 0
INIT_GAINS = {"rpn_cls_score": 0.2, "rpn_bbox_pred": 0.025,
              "cls_score": 0.2, "bbox_pred": 0.08, "mask_predictor": 0.3}


def plain_layers(n_classes=N_CLASSES):
    """[(name, weight shape)] of the layers after the trunk: the laterals
    and outputs (conv OIHW), the RPN, the box head (fc (out, in); fc6's in
    Detectron2's (c, h, w) input order) and the mask head (its deconv in
    (in, out, kh, kw))."""
    out = []
    for k, cin in zip(POOL_LEVELS, (256, 512, 1024, 2048)):
        out += [("fpn_lateral%d" % k, (DIM, cin, 1, 1)),
                ("fpn_output%d" % k, (DIM, DIM, 3, 3))]
    out += [("rpn_conv", (DIM, DIM, 3, 3)),
            ("rpn_cls_score", (NUM_ANCHORS, DIM, 1, 1)),
            ("rpn_bbox_pred", (NUM_ANCHORS * 4, DIM, 1, 1)),
            ("fc6", (FC_DIM, DIM * BOX_POOLED ** 2)),
            ("fc7", (FC_DIM, FC_DIM)),
            ("cls_score", (n_classes, FC_DIM)),
            ("bbox_pred", ((n_classes - 1) * 4, FC_DIM))]
    out += [("mask_fcn%d" % i, (DIM, DIM, 3, 3))
            for i in range(1, MASK_CONVS + 1)]
    out += [("mask_deconv", (DIM, DIM, 2, 2)),
            ("mask_predictor", (n_classes - 1, DIM, 1, 1))]
    return out


def fan_in(name, shape):
    """The fan-in of a layer's weight: the deconv's is its input channels
    times its kernel, as its transpose conv sees it."""
    return shape[0] * 4 if name == "mask_deconv" else math.prod(shape[1:])


def init_raw_mask_rcnn_fpn(generator, n_classes=N_CLASSES, device="cuda"):
    """Random weights of the unfolded network: the trunk's convs with their
    frozen BNs by models/resnet.py's rule (resnet.raw_bn_convs), then the
    layers of plain_layers He-normal with INIT_GAINS and zero biases;
    float32 drawn on the generator's device, moved to ``device``."""
    raw = resnet.raw_bn_convs(generator)
    gen_dev = generator.device
    for name, shape in plain_layers(n_classes):
        std = math.sqrt(2.0 / fan_in(name, shape)) * INIT_GAINS.get(name, 1.0)
        raw[name] = {"weight": torch.randn(shape, generator=generator,
                                           device=gen_dev) * std,
                     "bias": torch.zeros(shape[1] if name == "mask_deconv"
                                         else shape[0], device=gen_dev)}
    return {n: {k: v.to(device) for k, v in d.items()} for n, d in raw.items()}


def params_from_raw(raw):
    """The program's ModuleDict from unfolded weights: resnet.params_from_raw
    (each BN folded once) with fc6's weight reordered once from (c, h, w)
    to (h, w, c) input order."""
    d = raw["fc6"]
    n = d["weight"].shape[0]
    w = d["weight"].reshape(n, DIM, BOX_POOLED, BOX_POOLED)
    fc6 = {"weight": w.permute(0, 2, 3, 1).reshape(n, -1).contiguous(),
           "bias": d["bias"]}
    return resnet.params_from_raw(dict(raw, fc6=fc6))


def init_params_mask_rcnn_fpn(generator, n_classes=N_CLASSES, device="cuda"):
    """The folded parameter set from init_raw_mask_rcnn_fpn's draw."""
    return params_from_raw(init_raw_mask_rcnn_fpn(generator, n_classes,
                                                  device))


# --- the trunk, the pyramid and the RPN -----------------------------------

def trunk_stages(params, dtype=None):
    """resnet.StageGraphs' stages of the whole R-101: the stem, res2-res5
    under im_detect_2d.trunk.stem, .res2, ..., .res5; outputs [stem, C2,
    C3, C4, C5]."""
    return resnet.chained(resnet.trunk_stages(
        params, dtype, resnet.STAGES + (resnet.RES5,)))


def trunk_apply(params, x, dtype=None):
    """(B,H,W,3) -> [C2, C3, C4, C5] at strides 4-32, eagerly."""
    outs = [x]
    for name, fn in trunk_stages(params, dtype):
        with T.span(name):
            outs.append(fn(outs))
    return outs[2:]


def neck(params, feats, dtype=None):
    """[C2..C5] -> (P2, ..., P6), 256 channels each, NHWC."""
    lat = [resnet.conv(c, *vgg.layer(params, "fpn_lateral%d" % k),
                       relu=False, dtype=dtype)
           for k, c in zip(POOL_LEVELS, feats)]
    m = [lat[-1]]
    for x in reversed(lat[:-1]):
        up = F.interpolate(m[0].permute(0, 3, 1, 2), scale_factor=2,
                           mode="nearest").permute(0, 2, 3, 1)
        m.insert(0, x + up)
    p = [resnet.conv(x, *vgg.layer(params, "fpn_output%d" % k), relu=False,
                     dtype=dtype) for k, x in zip(POOL_LEVELS, m)]
    p6 = p[-1][:, ::2, ::2]         # max_pool2d with kernel 1, stride 2
    return tuple(x.contiguous() for x in p + [p6])


def rpn(params, maps, dtype=None):
    """The shared head over (P2..P6): (logits (L, N_max) float32, -inf past
    each level's H_l W_l A anchors, location-major; deltas (sum_l H_l W_l
    A, 4) float32, the levels in order)."""
    logits, deltas = [], []
    for p in maps:
        h = resnet.conv(p, *vgg.layer(params, "rpn_conv"), dtype=dtype)
        logits.append(resnet.conv(h, *vgg.layer(params, "rpn_cls_score"),
                                  relu=False, dtype=dtype).reshape(-1))
        deltas.append(resnet.conv(h, *vgg.layer(params, "rpn_bbox_pred"),
                                  relu=False, dtype=dtype).reshape(-1, 4))
    n_max = max(x.numel() for x in logits)
    padded = torch.full((len(logits), n_max), float("-inf"),
                        device=logits[0].device)
    for i, x in enumerate(logits):
        padded[i, :x.numel()] = x.float()
    return padded, torch.cat(deltas).float()


def head_stages(params, dtype=None):
    """resnet.StageGraphs' stages after the trunk, reading its [stem, C2,
    ..., C5]: the pyramid under im_detect_2d.fpn, the RPN under
    im_detect_2d.rpn; outputs [(P2..P6), (logits, deltas)]."""
    return [("im_detect_2d.fpn",
             lambda outs: neck(params, outs[0][1:], dtype)),
            ("im_detect_2d.rpn",
             lambda outs: rpn(params, outs[-1], dtype))]


def level_shapes(image_hw):
    """[(H_l, W_l)] of P2..P6 for an (H, W) input: the trunk's convs and
    pools of padding k // 2, then P6's stride 2."""
    h, w = image_hw
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1          # the 7x7/2 stem
    out = []
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1          # the 3x3/2 pool
    out.append((h, w))
    for _ in range(3):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        out.append((h, w))
    out.append(((h - 1) // 2 + 1, (w - 1) // 2 + 1))
    return out


def anchors(shapes, device):
    """(sum_l H_l W_l A, 4) float32 anchors of every level, location-major
    (ratios fastest) within a level: size s_l at stride 2^l, w = sqrt(s^2 /
    r), h = r w, centred on (x 2^l, y 2^l), corners c -/+ (w - 1) / 2."""
    out = []
    for (h, w), k, size in zip(shapes, LEVELS, ANCHOR_SIZES):
        stride = 2.0 ** k
        cell = []
        for r in ANCHOR_RATIOS:
            aw = math.sqrt(size * size / r)
            ah = r * aw
            cell.append([-(aw - 1) / 2, -(ah - 1) / 2, (aw - 1) / 2,
                         (ah - 1) / 2])
        cell = torch.tensor(cell, dtype=torch.float64)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64) * stride,
                                torch.arange(w, dtype=torch.float64) * stride,
                                indexing="ij")
        shift = torch.stack([xs, ys, xs, ys], -1).reshape(-1, 1, 4)
        out.append((shift + cell).reshape(-1, 4))
    return torch.cat(out).float().to(device)


def decode(boxes, deltas, weights, clamp=SCALE_CLAMP):
    """Detectron2's Box2BoxTransform.apply_deltas in the +1 convention:
    (..., 4) boxes and (..., 4K) deltas -> (..., 4K) boxes; each delta
    divided by its weight, dw and dh clamped at ``clamp``."""
    w = boxes[..., 2:3] - boxes[..., 0:1] + 1.0
    h = boxes[..., 3:4] - boxes[..., 1:2] + 1.0
    cx = boxes[..., 0:1] + 0.5 * w
    cy = boxes[..., 1:2] + 0.5 * h
    wx, wy, ww, wh = weights
    dx, dy = deltas[..., 0::4] / wx, deltas[..., 1::4] / wy
    dw = (deltas[..., 2::4] / ww).clamp(max=clamp)
    dh = (deltas[..., 3::4] / wh).clamp(max=clamp)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                       pcy + 0.5 * ph], dim=-1)
    return out.reshape(deltas.shape)


# --- the heads --------------------------------------------------------------

def box_head(params, pooled, dtype=None):
    """(R, 7, 7, 256) pooled maps -> (cls_prob (R, 81), bbox_pred (R, 320)):
    fc6 and fc7 in dtype, the predictors and the softmax in float32."""
    x = pooled.reshape(pooled.shape[0], -1)
    for name in ("fc6", "fc7"):
        w, b = vgg.layer(params, name)
        if dtype is not None:
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
        x = F.relu(F.linear(x, w, b))
    x = x.float()
    cls_score = F.linear(x, *vgg.layer(params, "cls_score"))
    bbox_pred = F.linear(x, *vgg.layer(params, "bbox_pred"))
    return torch.softmax(cls_score, dim=-1), bbox_pred


def mask_logits(params, pooled, dtype=None):
    """(R, 14, 14, 256) pooled maps -> (R, 28, 28, 80) float32 logits: the
    four convs and the deconv in dtype, the predictor in float32."""
    x = pooled
    for i in range(1, MASK_CONVS + 1):
        x = resnet.conv(x, *vgg.layer(params, "mask_fcn%d" % i), dtype=dtype)
    w, b = vgg.layer(params, "mask_deconv")
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    x = F.relu(F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=2))
    w, b = vgg.layer(params, "mask_predictor")
    return F.conv2d(x.float(), w, b).permute(0, 2, 3, 1)


def mask_probs(params, pooled, classes, dtype=None):
    """(R, 28, 28) float32: the sigmoid of channel c - 1 of each
    detection's logits, c its class (1..80)."""
    logits = mask_logits(params, pooled, dtype)
    idx = (classes.long() - 1).reshape(-1, 1, 1, 1).expand(
        -1, logits.shape[1], logits.shape[2], 1)
    return torch.sigmoid(logits.gather(3, idx)[..., 0])
