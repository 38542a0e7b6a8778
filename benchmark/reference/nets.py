"""The networks in plain PyTorch, float32 with TF32 off: VGG16 trunks at
stride 8 (MV3D) or 16 (Faster R-CNN), the RPN head, MV3D's fusion head and
the 2D head.

Every convolution and fully connected layer takes ``q``, a rounding of its
input and weight: ``exact`` (float32) for the reference, ``fp8`` for the
control, which computes the same network one precision step below the
configuration's bfloat16. Weights are a dict {name: (weight, bias)} in the
layouts of the benchmark's weight maker (conv OIHW, fc (out, in)).
"""

import torch
import torch.nn.functional as F

VGG16 = (("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128),
         ("conv2_2", 128), ("conv3_1", 256), ("conv3_2", 256),
         ("conv3_3", 256), ("conv4_1", 512), ("conv4_2", 512),
         ("conv4_3", 512), ("conv5_1", 512), ("conv5_2", 512),
         ("conv5_3", 512))
# the 2x2 VALID max pools: after conv1_2, conv2_2, conv3_3 (stride 8), and
# conv4_3 too at stride 16
POOLS = {8: ("conv1_2", "conv2_2", "conv3_3"),
         16: ("conv1_2", "conv2_2", "conv3_3", "conv4_3")}
FP8_MAX = 448.0


def exact(x):
    return x


def fp8(x):
    """x rounded to float8 e4m3 under one per-tensor scale, back in float32."""
    s = x.abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def conv(x, w, b, q, relu=True, pad=1):
    """NCHW float32 conv + bias (+ ReLU)."""
    y = F.conv2d(q(x), q(w), b, padding=pad)
    return F.relu(y) if relu else y


def linear(x, w, b, q, relu=True):
    y = q(x) @ q(w).t() + b
    return F.relu(y) if relu else y


def trunk(weights, x, suffix, stride, q):
    """x (1, C, H, W) float32 -> conv5_3 (1, 512, H/stride, W/stride)."""
    for name, _ in VGG16:
        x = conv(x, *weights[name + suffix], q)
        if name in POOLS[stride]:
            x = F.max_pool2d(x, 2)
    return x


def rpn(weights, c5, q):
    """(1, 512, h, w) -> (cls (h*w*A, 2) logits, deltas (h*w*A, D))."""
    x = conv(c5, *weights["rpn_conv/3x3"], q)
    cls = conv(x, *weights["rpn_cls_score"], q, relu=False, pad=0)
    box = conv(x, *weights["rpn_bbox_pred"], q, relu=False, pad=0)
    a = cls.shape[1] // 2
    cls = cls[0].permute(1, 2, 0).reshape(-1, a, 2).reshape(-1, 2)
    box = box[0].permute(1, 2, 0).reshape(cls.shape[0], -1)
    return cls, box


def fusion_head(weights, pooled_bv, pooled_img, q):
    """MV3D's test-time fusion head on pooled maps (R, 7, 7, 512): cls_prob
    (R, 2) and bbox_pred (R, 48)."""
    f1 = linear(linear(pooled_bv.reshape(len(pooled_bv), -1),
                       *weights["fc6_1"], q), *weights["fc7_1"], q)
    f2 = linear(linear(pooled_img.reshape(len(pooled_img), -1),
                       *weights["fc6_2"], q), *weights["fc7_2"], q)
    fused = torch.cat([f1, f2], 1)
    cls = linear(fused, *weights["cls_score"], q, relu=False)
    return (torch.softmax(cls, -1),
            linear(fused, *weights["bbox_pred"], q, relu=False))


def head_2d(weights, pooled, q):
    """fc6, fc7, cls_score and bbox_pred on pooled maps (R, 7, 7, 512):
    cls_prob (R, K) and bbox_pred (R, 4K)."""
    x = linear(linear(pooled.reshape(len(pooled), -1), *weights["fc6"], q),
               *weights["fc7"], q)
    cls = linear(x, *weights["cls_score"], q, relu=False)
    return torch.softmax(cls, -1), linear(x, *weights["bbox_pred"], q,
                                          relu=False)
