"""MV3D detector: dual VGG16 trunks, BEV RPN, multi-view fusion head with
train-mode dropout (mv3d_tf_tpu/models/mv3d.py).

Parameters are one ``nn.ModuleDict`` of ``nn.Conv2d`` / ``nn.Linear``
layers keyed by the reference layer names, with '/' mapped to '__'
(``vgg.module_key``); the apply functions are plain functions of it, as
in the JAX package. Linear weights are (out, in); fc6 rows act on pooled
maps flattened in (h, w, c) order, so one parameter file serves both
packages (utils/weights.py converts).
"""

import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch.models import vgg

N_CLASSES = 2            # background, Car
NUM_ANCHORS = 4          # generate_anchors_bv -> 4 anchors/location
FEAT_STRIDE = 8          # three VALID pools


def init_params(generator, bev_channels=9, fc_dim=2048, pooled=7, device=None):
    """Full parameter set with the JAX package's init (mv3d.py:33-65):
    truncated-normal std 0.01 (bbox_pred 0.001), zero biases."""
    def conv(cin, cout, k, std=0.01):
        return vgg.init_layer(generator, torch.nn.Conv2d, (cin, cout, k),
                              std=std, device=device)

    def fc(cin, cout, std=0.01):
        return vgg.init_layer(generator, torch.nn.Linear, (cin, cout),
                              std=std, device=device)

    params = {}
    params.update(vgg.init_trunk(generator, bev_channels, "", device))
    params.update(vgg.init_trunk(generator, 3, "_2", device))
    roi_dim = 512 * pooled * pooled
    params.update({
        vgg.module_key("rpn_conv/3x3"): conv(512, 512, 3),
        "rpn_cls_score": conv(512, NUM_ANCHORS * 2, 1),
        "rpn_bbox_pred": conv(512, NUM_ANCHORS * 6, 1),
        "fc6_1": fc(roi_dim, fc_dim),
        "fc7_1": fc(fc_dim, fc_dim),
        "fc6_2": fc(roi_dim, fc_dim),
        "fc7_2": fc(fc_dim, fc_dim),
        "cls_score": fc(2 * fc_dim, N_CLASSES),
        "bbox_pred": fc(2 * fc_dim, N_CLASSES * 24, std=0.001),
    })
    return torch.nn.ModuleDict(params)


def fc_apply(params, name, x, relu=True):
    """Linear (+ ReLU); 4D inputs flatten in (h, w, c) order (mv3d.py:68-84)."""
    w, b = vgg.layer(params, name)
    y = F.linear(x.reshape(x.shape[0], -1), w.to(x.dtype), b.to(x.dtype))
    return F.relu(y) if relu else y


def extract_features(params, bev, image, dtype=None, stem_impl=None):
    """Both trunks: (B,601,601,9) and (B,H,W,3) -> stride-8 conv5_3 maps."""
    return (vgg.trunk_apply(params, bev, "", dtype, stem_impl),
            vgg.trunk_apply(params, image, "_2", dtype, stem_impl))


def rpn_head(params, conv5_3, dtype=None):
    """RPN conv and score/delta heads: (B,h,w,2A) scores, (B,h,w,6A) deltas."""
    x = vgg.conv2d(conv5_3, *vgg.layer(params, "rpn_conv/3x3"), dtype=dtype)
    cls = vgg.conv2d(x, *vgg.layer(params, "rpn_cls_score"), padding="VALID",
                     relu=False, dtype=dtype)
    bbox = vgg.conv2d(x, *vgg.layer(params, "rpn_bbox_pred"), padding="VALID",
                      relu=False, dtype=dtype)
    return cls, bbox


def rpn_probs(rpn_cls_score):
    """Per-anchor softmax over (bg, fg) pairs, in float32 (mv3d.py:122-131)."""
    b, h, w, c = rpn_cls_score.shape
    pairs = rpn_cls_score.reshape(b, h, w, c // 2, 2).float()
    return torch.softmax(pairs, dim=-1).reshape(b, h, w, c)


def rpn_fg_scores(rpn_cls_prob):
    """Foreground scores (B, h*w*A), location-major, anchor-minor."""
    b, h, w, c = rpn_cls_prob.shape
    return rpn_cls_prob.reshape(b, h, w, c // 2, 2)[..., 1].reshape(b, -1)


def dropout(mask, x, keep_prob):
    """TF-style dropout with the keep mask given: kept units scaled by
    1/keep_prob (mv3d.py:87-92, where the mask is drawn from a key)."""
    return torch.where(mask, x / keep_prob, 0.0)


def fusion_head(params, pooled_bv, pooled_img, dtype=None, train=False,
                masks=None, keep_prob=1.0):
    """Fusion head, mv3d.py:143-177. Returns cls_score, cls_prob (float32
    softmax), bbox_pred.

    The test graph has no dropout. With train=True, masks holds the five
    boolean keep masks, in the order of the JAX keys k1..k5: after fc6_1,
    fc7_1, fc6_2, fc7_2 ((N, fc) each) and on the (N, 2fc) concat, which
    both heads read. keep_prob >= 1 or masks=None drops nothing, as in JAX.
    """
    if not (train and masks is not None and keep_prob < 1.0):
        masks = None
    if dtype is not None:
        pooled_bv, pooled_img = pooled_bv.to(dtype), pooled_img.to(dtype)

    def drop(i, x):
        return x if masks is None else dropout(masks[i], x, keep_prob)

    f1 = drop(1, fc_apply(params, "fc7_1",
                          drop(0, fc_apply(params, "fc6_1", pooled_bv))))
    f2 = drop(3, fc_apply(params, "fc7_2",
                          drop(2, fc_apply(params, "fc6_2", pooled_img))))
    fused = drop(4, torch.cat([f1, f2], dim=1))
    cls_score = fc_apply(params, "cls_score", fused, relu=False)
    cls_prob = torch.softmax(cls_score.float(), dim=-1)
    bbox_pred = fc_apply(params, "bbox_pred", fused, relu=False)
    return cls_score, cls_prob, bbox_pred
