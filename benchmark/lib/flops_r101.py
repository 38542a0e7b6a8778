"""The work of Faster R-CNN ResNet-101 C4, counted from the configuration's
shapes: the FLOPs of its convs and fully connected layers (2 x
multiply-adds), and the bytes of its 14x14 RoI pool (lib/roofline.py's
roi_pool_work assumes 7x7 bins).
"""

import torch

from benchmark.lib.roofline import conv_flops
from benchmark.reference.ops import bin_bounds


def conv_out(n, stride):
    """A map side after a conv of padding k // 2 (or the 3x3/2 pool of
    padding 1) at ``stride``."""
    return (n - 1) // stride + 1


def stage_flops(h, w, cin, blocks, width, cout, stride):
    """A stage of bottlenecks on an h x w input, the stride on the first
    1x1 conv: (FLOPs, (h, w) out)."""
    total = 0
    for i in range(blocks):
        s = stride if i == 0 else 1
        ho, wo = conv_out(h, s), conv_out(w, s)
        total += (conv_flops(ho, wo, cin, width, 1)
                  + conv_flops(ho, wo, width, width, 3)
                  + conv_flops(ho, wo, width, cout, 1))
        if i == 0:
            total += conv_flops(ho, wo, cin, cout, 1)
        h, w, cin = ho, wo, cout
    return total, (h, w)


def trunk_flops(cfg):
    """The stem and res2-res4 on the configuration's input: (FLOPs, res4's
    (h, w))."""
    h, w = cfg["image_hw"]
    h, w = conv_out(h, 2), conv_out(w, 2)
    total = conv_flops(h, w, 3, cfg["stem_dim"], 7)
    h, w = conv_out(h, 2), conv_out(w, 2)
    cin = cfg["stem_dim"]
    for i in range(3):
        f, (h, w) = stage_flops(h, w, cin, cfg["stages"][i],
                                cfg["bottleneck_dims"][i], cfg["out_dims"][i],
                                1 if i == 0 else 2)
        total += f
        cin = cfg["out_dims"][i]
    return total, (h, w)


def res5_flops_per_roi(cfg):
    """res5 on one pooled map (pooled x pooled x res4's width)."""
    p = cfg["pooled"]
    f, _ = stage_flops(p, p, cfg["out_dims"][2], cfg["stages"][3],
                       cfg["bottleneck_dims"][3], cfg["out_dims"][3], 2)
    return f


def rpn_flops(cfg, h, w):
    a, d = cfg["num_anchors"], cfg["rpn_dim"]
    return (conv_flops(h, w, cfg["out_dims"][2], d, 3)
            + conv_flops(h, w, d, a * 2, 1) + conv_flops(h, w, d, a * 4, 1))


def head_flops_per_roi(cfg):
    """cls_score and bbox_pred on one RoI's features."""
    return 2 * cfg["head_dim"] * cfg["num_classes"] * 5


def image_flops(cfg):
    """A test-time image: the trunk, the RPN, and res5 and the heads on
    every post-NMS slot (the program runs them on all of them)."""
    trunk, (h, w) = trunk_flops(cfg)
    rois = cfg["test"]["post_nms_top_n"]
    return (trunk + rpn_flops(cfg, h, w)
            + rois * (res5_flops_per_roi(cfg) + head_flops_per_roi(cfg)))


def roi_pool_bytes(rois, hwc, pooled, scale, elem_size):
    """Bytes of one RoI max-pool launch over a (H, W, C) map: each cell
    that some roi's bins cover read once, the pooled maps written once, the
    (R, 5) float32 rois read once."""
    H, W, C = hwc
    hs, he, ws, we = bin_bounds(rois, pooled, scale, H, W).unbind(1)
    ar_h = torch.arange(H, device=rois.device)
    ar_w = torch.arange(W, device=rois.device)
    rows = (ar_h >= hs.amin(1)[:, None]) & (ar_h < he.amax(1)[:, None])
    cols = (ar_w >= ws.amin(1)[:, None]) & (ar_w < we.amax(1)[:, None])
    unique = int((rows[:, :, None] & cols[:, None, :]).any(0).sum())
    return (unique * C * elem_size + rois.shape[0] * pooled * pooled * C
            * elem_size + rois.numel() * 4)
