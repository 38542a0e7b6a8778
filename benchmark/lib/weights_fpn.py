"""Random weights of Mask R-CNN ResNet-101-FPN, made on the device from a
seed: unfolded for the reference (each trunk conv's frozen BN kept apart),
and handed to the program's own conversion, which folds each BN into its
conv.

The rule (configs/mask_rcnn_r101_fpn_coco.json's "assumed"):
  * the trunk's convs and frozen BNs as lib/weights_r101.py draws them,
    res5 included: He-normal convs (the stem's divided by 64), BN scales
    spread over some 0.3-2x with a mean square of 1, the residual branches'
    last BN damped by sqrt(2 x the stage's blocks);
  * every layer after the trunk He-normal (std sqrt(2 / fan_in), the
    deconv's fan-in its input channels times its 2x2 kernel) times GAINS,
    biases 0. The pyramid's maps reach an RMS of some 9 under the trunk's
    rule, and the gains give a trained model's spreads on them: objectness
    logits of 1.2-2.5 and RPN deltas of 0.3, so that the per-level NMS
    does real work; class logits of 2.7, so that more of an image's rois
    pass the 0.05 threshold than the cap of 100 keeps; box deltas of 0.1
    (dx, dy) and 0.2 (dw, dh) after the weights (10, 10, 5, 5); mask logits
    of 2. (Plain He gives 3-6, 1.2, 13, 0.6/1.4 and 6.6: scores that
    saturate, boxes stretched to the image.)
All draws come from one generator on the device, in float32, in the
order of bn_convs then plain_layers.
"""

import math

import torch

from benchmark.lib.weights_r101 import STAGES, bn_convs

GAINS = {"rpn_cls_score": 0.2, "rpn_bbox_pred": 0.025, "cls_score": 0.2,
         "bbox_pred": 0.08, "mask_predictor": 0.3}


def plain_layers(cfg):
    """[(name, weight shape)] after the trunk, in the program's names:
    conv OIHW, fc (out, in) (fc6's input in (c, h, w) order), the deconv
    (in, out, 2, 2)."""
    d, a, k = cfg["fpn_dim"], cfg["num_anchors"], cfg["num_classes"]
    fc, p = cfg["fc_dim"], cfg["box_pooled"]
    out = []
    for lv, cin in zip((2, 3, 4, 5), cfg["out_dims"]):
        out += [("fpn_lateral%d" % lv, (d, cin, 1, 1)),
                ("fpn_output%d" % lv, (d, d, 3, 3))]
    out += [("rpn_conv", (d, d, 3, 3)), ("rpn_cls_score", (a, d, 1, 1)),
            ("rpn_bbox_pred", (a * 4, d, 1, 1)),
            ("fc6", (fc, d * p * p)), ("fc7", (fc, fc)),
            ("cls_score", (k, fc)), ("bbox_pred", ((k - 1) * 4, fc))]
    out += [("mask_fcn%d" % i, (d, d, 3, 3))
            for i in range(1, cfg["mask_convs"] + 1)]
    out += [("mask_deconv", (d, d, 2, 2)),
            ("mask_predictor", (k - 1, d, 1, 1))]
    return out


def make(cfg, seed, device):
    """{name: {"weight", and "gamma", "beta", "mean", "var" where the conv
    has a frozen BN, else "bias"}}, float32 on device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)

    blocks = {s: n for s, n, _, _ in STAGES}
    out = {}
    for name, cin, cout, k in bn_convs():
        std = math.sqrt(2.0 / (cin * k * k)) / (64.0 if name == "conv1"
                                                 else 1.0)
        damp = (1.0 / math.sqrt(2.0 * blocks[name.split("_")[0]])
                if name.endswith("conv3") else 1.0)
        var = uniform(0.5, 2.0, cout)
        out[name] = {"weight": normal(cout, cin, k, k).mul_(std),
                     "gamma": var.sqrt() * torch.exp(0.5 * normal(cout)
                                                     - 0.25) * damp,
                     "beta": normal(cout).mul_(0.2 * damp),
                     "mean": normal(cout).mul_(0.2), "var": var}
    for name, shape in plain_layers(cfg):
        fan = shape[0] * 4 if name == "mask_deconv" else math.prod(shape[1:])
        out[name] = {"weight": normal(*shape).mul_(
            math.sqrt(2.0 / fan) * GAINS.get(name, 1.0)),
            "bias": torch.zeros(shape[1] if name == "mask_deconv"
                                else shape[0], device=device)}
    return out


def program_params(raw):
    """The program's parameters from the unfolded weights, by its own
    conversion (models/fpn.params_from_raw: each BN folded once, fc6
    reordered to its NHWC input)."""
    from mv3d_tf_tpu_torch.models import fpn
    return fpn.params_from_raw(raw)
