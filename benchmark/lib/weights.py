"""Random He-scaled weights, made on the device from a seed.

No trained weights are in the repository, and the networks' own init (a
normal of std 0.01) makes every RPN score equal, so that the NMS does no
real work. He scaling (std sqrt(2 / fan_in), zero biases) keeps features
at unit scale through both trunks. Two layers differ from plain He, as the
repository's He parameters have them: the image trunk's first conv is
divided by 64, about the spread of 8-bit pixels after the mean, and
bbox_pred is ten times smaller, as the networks' own init has it.

All weights come from one normal draw on the device, in float32, the type
the program keeps them in (its bfloat16 path casts them per call).
"""

import math

import torch

from benchmark.reference.nets import VGG16


def layer_shapes(cfg):
    """[(name, weight shape)] in the program's layouts: conv OIHW, fc
    (out, in)."""
    shapes = []

    def trunk(suffix, cin):
        for name, cout in VGG16:
            shapes.append((name + suffix, (cout, cin, 3, 3)))
            cin = cout

    a, fc, k = cfg["num_anchors"], cfg["fc_dim"], cfg["num_classes"]
    pooled = 512 * cfg["pooled"] ** 2
    if cfg["network"] == "mv3d":
        trunk("", cfg["bev_channels"])
        trunk("_2", 3)
        box = 6
        heads = [("fc6_1", (fc, pooled)), ("fc7_1", (fc, fc)),
                 ("fc6_2", (fc, pooled)), ("fc7_2", (fc, fc)),
                 ("cls_score", (k, 2 * fc)), ("bbox_pred", (k * 24, 2 * fc))]
    elif cfg["network"] == "faster_rcnn_2d":
        trunk("", 3)
        box = 4
        heads = [("fc6", (fc, pooled)), ("fc7", (fc, fc)),
                 ("cls_score", (k, fc)), ("bbox_pred", (k * 4, fc))]
    else:
        raise ValueError("unknown network %r" % cfg["network"])
    shapes += [("rpn_conv/3x3", (512, 512, 3, 3)),
               ("rpn_cls_score", (a * 2, 512, 1, 1)),
               ("rpn_bbox_pred", (a * box, 512, 1, 1))]
    return shapes + heads


def gain(cfg, name):
    if name == "bbox_pred":
        return 0.1
    first_image_conv = "conv1_1_2" if cfg["network"] == "mv3d" else "conv1_1"
    return 1.0 / 64 if name == first_image_conv else 1.0


def make(cfg, seed, device):
    """{name: (weight, bias)} float32 on device, from one draw of a
    generator on that device seeded with ``seed``."""
    shapes = layer_shapes(cfg)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        std = math.sqrt(2.0 / math.prod(shape[1:])) * gain(cfg, name)
        w = flat[at:at + n].view(shape).mul_(std)
        out[name] = (w, torch.zeros(shape[0], device=device))
        at += n
    return out


def module_dict(weights):
    """The program's parameter container: an nn.ModuleDict of Conv2d and
    Linear layers keyed by the reference names, '/' written '__', holding
    copies of the weights."""
    layers = {}
    for name, (w, b) in weights.items():
        if w.dim() == 4:
            m = torch.nn.utils.skip_init(torch.nn.Conv2d, w.shape[1],
                                         w.shape[0], w.shape[2],
                                         device=w.device)
        else:
            m = torch.nn.utils.skip_init(torch.nn.Linear, w.shape[1],
                                         w.shape[0], device=w.device)
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
        layers[name.replace("/", "__")] = m
    return torch.nn.ModuleDict(layers)
