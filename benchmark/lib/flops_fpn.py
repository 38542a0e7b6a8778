"""The work of Mask R-CNN ResNet-101-FPN, counted from the configuration's
shapes: the FLOPs of its convs and fully connected layers (2 x
multiply-adds), the mask head at a call's own detections, and the bytes
of its RoIAlign launches.
"""

import torch

from benchmark.lib.flops_r101 import conv_out, stage_flops, trunk_flops
from benchmark.lib.roofline import conv_flops


def level_shapes(image_hw):
    """[(H, W)] of P2..P6: the stem and pool to stride 4, res3-res5 by
    stride-2 first blocks, P6 P5 at stride 2."""
    h, w = (conv_out(conv_out(n, 2), 2) for n in image_hw)
    out = [(h, w)]
    for _ in range(4):
        h, w = conv_out(h, 2), conv_out(w, 2)
        out.append((h, w))
    return out


def backbone_flops(cfg):
    """The trunk through res5 on the whole image (GFLOP x 1e9)."""
    trunk, (h, w) = trunk_flops(cfg)
    res5, _ = stage_flops(h, w, cfg["out_dims"][2], cfg["stages"][3],
                          cfg["bottleneck_dims"][3], cfg["out_dims"][3], 2)
    return trunk + res5


def fpn_flops(cfg):
    """The laterals (1x1, with bias) and the outputs (3x3) of P2-P5."""
    d = cfg["fpn_dim"]
    shapes = level_shapes(cfg["image_hw"])[:4]
    return sum(conv_flops(h, w, cin, d, 1) + conv_flops(h, w, d, d, 3)
               for (h, w), cin in zip(shapes, cfg["out_dims"]))


def rpn_flops(cfg):
    """The shared head on P2-P6: the 3x3 conv, 3 logits, 12 deltas."""
    d, a = cfg["fpn_dim"], cfg["num_anchors"]
    return sum(conv_flops(h, w, d, d, 3) + conv_flops(h, w, d, a, 1)
               + conv_flops(h, w, d, 4 * a, 1)
               for h, w in level_shapes(cfg["image_hw"]))


def box_head_flops_per_roi(cfg):
    """fc6, fc7, cls_score and bbox_pred (80 x 4) on one roi."""
    fc, k = cfg["fc_dim"], cfg["num_classes"]
    flat = cfg["fpn_dim"] * cfg["box_pooled"] ** 2
    return 2 * (flat * fc + fc * fc + fc * k + fc * 4 * (k - 1))


def mask_flops_per_det(cfg):
    """The mask head on one detection: the 3x3 convs at 14x14, the 2x2/2
    deconv to 28x28 (a 1x1 conv's work at 28x28), the 1x1 predictor."""
    d, p, k = cfg["fpn_dim"], cfg["mask_pooled"], cfg["num_classes"]
    return (cfg["mask_convs"] * conv_flops(p, p, d, d, 3)
            + conv_flops(2 * p, 2 * p, d, d, 1)
            + conv_flops(2 * p, 2 * p, d, k - 1, 1))


def image_flops(cfg, mask_dets):
    """A test-time image: the trunk, the pyramid, the RPN, the box head on
    every post-NMS slot (the program runs it on all of them) and the mask
    head on ``mask_dets`` detections."""
    rois = cfg["test"]["post_nms_top_n"]
    return (backbone_flops(cfg) + fpn_flops(cfg) + rpn_flops(cfg)
            + rois * box_head_flops_per_roi(cfg)
            + mask_dets * mask_flops_per_det(cfg))


def roi_align_bytes(boxes, levels, shapes, channels, pooled, elem_size,
                    slots):
    """Bytes of one RoIAlign launch: on each level the cells that some
    roi's bilinear samples touch read once, the ``slots`` pooled maps
    written once, the (slots, 5) float32 rois read and the (slots,) int32
    levels written once. boxes (n, 4) in image pixels, levels (n,) the
    level each was pooled from (2..5), shapes [(H, W)] of P2..P5."""
    boxes, levels = boxes.float(), levels.long()
    cells = 0
    for k, (H, W) in zip((2, 3, 4, 5), shapes):
        b = boxes[levels == k] * (0.5 ** k) - 0.5
        if not len(b):
            continue
        rows = _touched(b[:, 1], b[:, 3], pooled, H)
        cols = _touched(b[:, 0], b[:, 2], pooled, W)
        cells += int((rows[:, :, None] & cols[:, None, :]).any(0).sum())
    return ((cells + slots * pooled * pooled) * channels * elem_size
            + slots * (5 * 4 + 4))


def _touched(lo, hi, pooled, size):
    """(n, size) bool: the cells of one axis that the samples of rois
    [lo, hi] (in cells) read, samples at the sub-bin centres, clamped as
    RoIAlign clamps them; none where every sample lies outside [-1,
    size]."""
    extent = hi - lo
    grid = torch.ceil(extent / pooled).clamp(min=1)
    step = extent / pooled / grid
    first = lo + 0.5 * step
    last = hi - 0.5 * step
    a = first.clamp(min=-1.0, max=float(size))
    b = last.clamp(min=-1.0, max=float(size))
    inside = (last >= -1.0) & (first <= float(size)) & (extent > 0)
    lo_cell = a.clamp(min=0).floor().clamp(max=size - 1)
    hi_cell = (b.clamp(min=0).floor() + 1).clamp(max=size - 1)
    ar = torch.arange(size, dtype=torch.float32)
    return (inside[:, None] & (ar[None, :] >= lo_cell[:, None])
            & (ar[None, :] <= hi_cell[:, None]))
