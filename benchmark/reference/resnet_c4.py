"""Faster R-CNN ResNet-101 C4's networks in plain PyTorch, float32 with TF32
off: a frozen copy, as of the configuration's first benchmark, of
torch_reference/faster_rcnn_r101_c4.py's trunk, res5, RPN and heads, with
each conv and fully connected layer's input and weight rounded by ``q`` as
in nets.py (``exact`` for the reference, ``fp8`` for the control).

Every BN is frozen and applied as its own affine op after a bias-free
conv, never folded. Weights are lib/weights_r101.make's unfolded dict.
"""

import torch
import torch.nn.functional as F

from benchmark.reference.nets import exact

EPS = 1e-5
# (stage, blocks, stride of the first block); the stride sits on the first
# 1x1 conv (MSRA), a stage's first block projects its shortcut
STAGES = (("res2", 3, 1), ("res3", 4, 2), ("res4", 23, 2))
RES5 = ("res5", 3, 2)


def conv_bn(x, d, q, stride=1, relu=True):
    """NCHW conv without bias, then the frozen BN (+ ReLU)."""
    y = F.conv2d(q(x), q(d["weight"]), None, stride=stride,
                 padding=d["weight"].shape[-1] // 2)

    def c(v):
        return v.reshape(1, -1, 1, 1)
    y = c(d["gamma"]) * (y - c(d["mean"])) / torch.sqrt(c(d["var"]) + EPS) \
        + c(d["beta"])
    return F.relu(y) if relu else y


def bottleneck(w, x, name, stride, q):
    y = conv_bn(x, w[name + "conv1"], q, stride)
    y = conv_bn(y, w[name + "conv2"], q)
    y = conv_bn(y, w[name + "conv3"], q, relu=False)
    short = (conv_bn(x, w[name + "shortcut"], q, stride, relu=False)
             if name + "shortcut" in w else x)
    return F.relu(y + short)


def stage(w, x, spec, q):
    name, blocks, stride = spec
    for i in range(blocks):
        x = bottleneck(w, x, "%s_%d_" % (name, i), stride if i == 0 else 1, q)
    return x


def trunk(w, image, q=exact):
    """image (H, W, 3) float32 mean-subtracted -> res4 (1, 1024, H/16,
    W/16): the 7x7/2 stem, the 3x3/2 max pool (padding 1), res2-res4."""
    x = conv_bn(image.permute(2, 0, 1)[None], w["conv1"], q, stride=2)
    x = F.max_pool2d(x, 3, 2, 1)
    for spec in STAGES:
        x = stage(w, x, spec, q)
    return x


def res5(w, pooled, q=exact, chunk=250):
    """pooled (R, 14, 14, 1024) -> (R, 2048): res5 per RoI, then the mean
    over its 7x7 map; ``chunk`` RoIs at a time."""
    outs = [stage(w, pooled[i:i + chunk].permute(0, 3, 1, 2), RES5,
                  q).mean(dim=(2, 3)) for i in range(0, len(pooled), chunk)]
    return torch.cat(outs) if outs else pooled.new_zeros((0, 2048))


def rpn(w, feat, q=exact):
    """(1, 1024, h, w) -> (cls (h*w*A, 2) logits, deltas (h*w*A, 4)),
    location-major."""
    def conv(x, name, relu):
        d = w[name]
        y = F.conv2d(q(x), q(d["weight"]), d["bias"],
                     padding=d["weight"].shape[-1] // 2)
        return F.relu(y) if relu else y
    x = conv(feat, "rpn_conv/3x3", True)
    cls = conv(x, "rpn_cls_score", False)[0].permute(1, 2, 0)
    box = conv(x, "rpn_bbox_pred", False)[0].permute(1, 2, 0)
    return cls.reshape(-1, 2), box.reshape(-1, 4)


def heads(w, x, q=exact):
    """(R, 2048) -> cls_prob (R, K) softmax, bbox_pred (R, 4K)."""
    def fc(name):
        d = w[name]
        return q(x) @ q(d["weight"]).t() + d["bias"]
    return torch.softmax(fc("cls_score"), -1), fc("bbox_pred")
