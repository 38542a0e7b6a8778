"""Random weights of Faster R-CNN ResNet-101 C4, made on the device from a
seed: unfolded for the reference (each conv's frozen BN kept apart), and
handed to the program's own conversion, which folds each BN into its conv.

No trained weights are in the repository, and plain He-normal convs with
identity BNs make the residual sums grow some 2x a block over res4's 23,
so that the RPN's scores saturate and the NMS stops doing real work. The
rule (configs/faster_rcnn_r101_c4_coco.json's "assumed"):
  * convs He-normal, std sqrt(2 / fan_in); the stem's divided by 64, the
    spread of 8-bit pixels after the means;
  * each frozen BN draws mean ~ N(0, 0.2^2), var ~ U(0.5, 2), gamma =
    sqrt(var) exp(0.5 z - 0.25) with z ~ N(0, 1), and beta ~ N(0, 0.2^2):
    a per-channel scale gamma / sqrt(var) spread over some 0.3-2x whose
    mean square is 1, so that the activations keep their scale and a BN
    left out of its conv changes the network;
  * the last BN of each residual branch (conv3) has gamma and beta divided
    by sqrt(2 x the stage's blocks), so that a stage's residual sums grow
    its variance by about e^(1/2);
  * the RPN's conv and cls_score He-normal; rpn_cls_score divided by 3
    and the box layers (rpn_bbox_pred, bbox_pred) by 10, so that the
    objectness logits spread by some 2 and the deltas by some 0.4, as a
    trained RPN's do (plain He makes them 5 and 4: an eighth of the scores
    round to 1 and most proposals clip to the whole image); biases 0.
All draws come from one generator on the device, in float32.
"""

import math

import torch

GAINS = {"rpn_cls_score": 1.0 / 3, "rpn_bbox_pred": 0.1, "bbox_pred": 0.1}
# (stage, blocks, bottleneck width, output width)
STAGES = (("res2", 3, 64, 256), ("res3", 4, 128, 512), ("res4", 23, 256, 1024),
          ("res5", 3, 512, 2048))


def bn_convs():
    """[(name, cin, cout, kernel)] of every conv with a frozen BN, in the
    program's names."""
    out, cin = [("conv1", 3, 64, 7)], 64
    for stage, blocks, width, cout in STAGES:
        for i in range(blocks):
            name = "%s_%d_" % (stage, i)
            out += [(name + "conv1", cin, width, 1),
                    (name + "conv2", width, width, 3),
                    (name + "conv3", width, cout, 1)]
            if i == 0:
                out.append((name + "shortcut", cin, cout, 1))
            cin = cout
    return out


def plain_layers(cfg):
    a, k, d = cfg["num_anchors"], cfg["num_classes"], cfg["rpn_dim"]
    return [("rpn_conv/3x3", (d, 1024, 3, 3)),
            ("rpn_cls_score", (a * 2, d, 1, 1)),
            ("rpn_bbox_pred", (a * 4, d, 1, 1)),
            ("cls_score", (k, cfg["head_dim"])),
            ("bbox_pred", (k * 4, cfg["head_dim"]))]


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
        std = math.sqrt(2.0 / math.prod(shape[1:])) * GAINS.get(name, 1.0)
        out[name] = {"weight": normal(*shape).mul_(std),
                     "bias": torch.zeros(shape[0], device=device)}
    return out


def program_params(raw):
    """The program's parameters from the unfolded weights, by its own
    conversion (models/resnet.params_from_raw: each BN folded once)."""
    from mv3d_tf_tpu_torch.models import resnet
    return resnet.params_from_raw(raw)
