"""Faster R-CNN ResNet-101 C4 (He et al., arXiv:1512.03385, Appendix A;
Detectron2's faster_rcnn_R_101_C4_3x): a 101-layer bottleneck trunk shared
up to res4 at stride 16, RoI pooling before conv5_1, and res5 run per RoI,
then the mean over its 7x7 map and the sibling class and box layers.

Every conv is followed by a frozen BN, y = gamma (x - mu) / sqrt(var + eps)
+ beta, which ``fold_frozen_bn`` folds into the conv's weight and bias once,
when the parameters are made. The bottleneck is MSRA's: the stride sits on
the first 1x1 conv, and a stage's first block projects its shortcut by a
strided 1x1 conv and its BN.

Conventions are models/vgg.py's: feature maps NHWC, each conv on the NCHW
view of the NHWC tensor (channels_last), weights OIHW, TF32 off for
float32 convs on a card, and a dtype argument that casts input, weight and
bias per call. Parameters are one ``nn.ModuleDict`` of Conv2d and Linear
layers keyed by the names of ``bn_convs`` and ``plain_layers``; the RPN's
layers carry the names of models/mv3d.rpn_head.
"""

import functools
import math

import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch import trace as T
from mv3d_tf_tpu_torch.models import mv3d, vgg

BN_EPS = 1e-5
N_CLASSES = 81                       # COCO's 80 and the background
FEAT_STRIDE = 16
ANCHOR_SCALES = (2, 4, 8, 16, 32)    # sizes 32-512 at base 16
NUM_ANCHORS = 3 * len(ANCHOR_SCALES)
POOLED = 14
RPN_DIM = 1024
# (stage, blocks, bottleneck width, output width, stride of the first block)
STAGES = (("res2", 3, 64, 256, 1), ("res3", 4, 128, 512, 2),
          ("res4", 23, 256, 1024, 2))
RES5 = ("res5", 3, 512, 2048, 2)
HEAD_DIM = 2048
INIT_GAINS = {"rpn_cls_score": 1.0 / 3, "rpn_bbox_pred": 0.1, "bbox_pred": 0.1}


def bottleneck_convs(stage, blocks, width, cout, cin):
    """[(name, cin, cout, kernel)] of a stage's convs, each with a BN: per
    block conv1 (1x1), conv2 (3x3), conv3 (1x1), and the first block's
    shortcut (1x1)."""
    out = []
    for i in range(blocks):
        name = "%s_%d_" % (stage, i)
        out += [(name + "conv1", cin, width, 1),
                (name + "conv2", width, width, 3),
                (name + "conv3", width, cout, 1)]
        if i == 0:
            out.append((name + "shortcut", cin, cout, 1))
        cin = cout
    return out


def bn_convs():
    """[(name, cin, cout, kernel)] of every conv with a frozen BN: the 7x7
    stem, res2-res4 and res5."""
    out, cin = [("conv1", 3, 64, 7)], 64
    for stage, blocks, width, cout, _ in STAGES + (RES5,):
        out += bottleneck_convs(stage, blocks, width, cout, cin)
        cin = cout
    return out


def plain_layers(n_classes=N_CLASSES):
    """[(name, weight shape)] of the layers without BN: the RPN (conv OIHW)
    and the two heads (fc (out, in))."""
    return [("rpn_conv/3x3", (RPN_DIM, 1024, 3, 3)),
            ("rpn_cls_score", (NUM_ANCHORS * 2, RPN_DIM, 1, 1)),
            ("rpn_bbox_pred", (NUM_ANCHORS * 4, RPN_DIM, 1, 1)),
            ("cls_score", (n_classes, HEAD_DIM)),
            ("bbox_pred", (n_classes * 4, HEAD_DIM))]


def fold_frozen_bn(weight, gamma, beta, mean, var, eps=BN_EPS):
    """A conv (OIHW, no bias) followed by a frozen BN as one conv: (weight
    * s, beta - mean * s) with s = gamma / sqrt(var + eps) per output
    channel, computed in float64 and returned in the weight's dtype."""
    s = gamma.double() / torch.sqrt(var.double() + eps)
    w = weight.double() * s.reshape(-1, *([1] * (weight.dim() - 1)))
    b = beta.double() - mean.double() * s
    return w.to(weight.dtype), b.to(weight.dtype)


def init_raw_r101_c4(generator, n_classes=N_CLASSES, device="cuda"):
    """Random weights of the unfolded network, {name: {"weight", and
    "gamma", "beta", "mean", "var" for a conv with BN, else "bias"}},
    float32 on the generator's device, moved to ``device``.

    No trained weights are drawn here, so the rule keeps the activations
    at one scale through the 33 blocks: convs are He-normal (std
    sqrt(2 / fan_in)), the stem's divided by 64 for 8-bit pixels; each BN
    draws mean ~ N(0, 0.2^2), var ~ U(0.5, 2), gamma = sqrt(var) exp(0.5 z
    - 0.25) with z ~ N(0, 1), and beta ~ N(0, 0.2^2), so that its scale
    gamma / sqrt(var) spreads over some 0.3-2x with a mean square of 1 and
    the fold is no identity; the last BN of each residual branch (conv3) has
    its gamma and beta divided by sqrt(2 * blocks of the stage), so that
    the residual sums of a stage grow its variance by about e^(1/2), not
    2x a block. The RPN's conv and cls_score are He-normal, rpn_cls_score
    divided by 3 and the box layers by 10, so that the objectness logits
    spread by some 2 and the deltas by some 0.4, as a trained RPN's do;
    biases of plain layers are 0."""
    raw = raw_bn_convs(generator)
    gen_dev = generator.device
    for name, shape in plain_layers(n_classes):
        std = math.sqrt(2.0 / math.prod(shape[1:])) * INIT_GAINS.get(name, 1.0)
        raw[name] = {"weight": torch.randn(shape, generator=generator,
                                           device=gen_dev) * std,
                     "bias": torch.zeros(shape[0], device=gen_dev)}
    return {n: {k: v.to(device) for k, v in d.items()} for n, d in raw.items()}


def raw_bn_convs(generator):
    """init_raw_r101_c4's draws of the convs with a frozen BN (bn_convs), in
    their order, float32 on the generator's device."""
    gen_dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=gen_dev)

    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=generator,
                                           device=gen_dev)

    blocks = {s: n for s, n, _, _, _ in STAGES + (RES5,)}
    raw = {}
    for name, cin, cout, k in bn_convs():
        std = math.sqrt(2.0 / (cin * k * k)) / (64.0 if name == "conv1"
                                                 else 1.0)
        var = uniform(0.5, 2.0, cout)
        damp = (1.0 / math.sqrt(2.0 * blocks[name.split("_")[0]])
                if name.endswith("conv3") else 1.0)
        raw[name] = {"weight": normal(cout, cin, k, k) * std,
                     "gamma": (torch.sqrt(var) * torch.exp(0.5 * normal(cout)
                                                           - 0.25) * damp),
                     "beta": normal(cout) * 0.2 * damp,
                     "mean": normal(cout) * 0.2, "var": var}
    return raw


def params_from_raw(raw):
    """The program's ModuleDict from unfolded weights (init_raw_r101_c4's
    layout): each BN folded into its conv once, here."""
    layers = {}
    for name, d in raw.items():
        w = d["weight"]
        b = (fold_frozen_bn(w, d["gamma"], d["beta"], d["mean"], d["var"])
             if "gamma" in d else (w, d["bias"]))
        cls = torch.nn.Conv2d if w.dim() == 4 else torch.nn.Linear
        shape = ((w.shape[1], w.shape[0], w.shape[2]) if w.dim() == 4
                 else (w.shape[1], w.shape[0]))
        m = vgg.empty_layer(cls, shape, device=w.device)
        with torch.no_grad():
            m.weight.copy_(b[0])
            m.bias.copy_(b[1])
        layers[vgg.module_key(name)] = m
    return torch.nn.ModuleDict(layers)


def init_params_r101_c4(generator, n_classes=N_CLASSES, device="cuda"):
    """The folded parameter set from init_raw_r101_c4's draw."""
    return params_from_raw(init_raw_r101_c4(generator, n_classes, device))


def conv(x, w, b, stride=1, relu=True, dtype=None):
    """Conv + bias (+ ReLU) on NHWC, padding k // 2 (7x7 pad 3, 3x3 pad 1,
    1x1 pad 0), as vgg.conv2d with a stride."""
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    if x.dtype == torch.float32 and x.is_cuda:
        vgg.f32_convs_without_tf32()
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride,
                 padding=w.shape[-1] // 2).permute(0, 2, 3, 1)
    return F.relu(y) if relu else y


def bottleneck(params, x, name, stride, dtype=None):
    """ReLU(conv3(ReLU(conv2(ReLU(conv1/s(x))))) + P(x)), each conv with its
    folded BN; P is the strided projection where the block has one, else
    the identity."""
    def c(suffix, y, s=1, relu=True):
        return conv(y, *vgg.layer(params, name + suffix), stride=s,
                    relu=relu, dtype=dtype)

    y = c("conv3", c("conv2", c("conv1", x, stride)), relu=False)
    if vgg.module_key(name + "shortcut") in params:
        x = c("shortcut", x, stride, relu=False)
    elif dtype is not None:
        x = x.to(dtype)
    return F.relu(y + x)


def stage(params, x, spec, dtype=None):
    """One stage's blocks, the stride on its first."""
    name, blocks, _, _, stride = spec
    for i in range(blocks):
        x = bottleneck(params, x, "%s_%d_" % (name, i),
                       stride if i == 0 else 1, dtype)
    return x


def stem(params, x, dtype=None):
    """conv1 7x7/2 with its BN and ReLU, then the 3x3/2 max pool, pad 1."""
    x = conv(x, *vgg.layer(params, "conv1"), stride=2, dtype=dtype)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def trunk_stages(params, dtype=None, stages=STAGES):
    """[(span, x -> y)] of the shared trunk in order: the stem, res2, res3
    and res4 (and each further stage of ``stages``) under
    im_detect_2d.trunk.stem, .res2, .res3 and .res4."""
    out = [("im_detect_2d.trunk.stem",
            functools.partial(stem, params, dtype=dtype))]
    for spec in stages:
        out.append(("im_detect_2d.trunk." + spec[0],
                    functools.partial(stage, params, spec=spec, dtype=dtype)))
    return out


def trunk_apply_r101(params, x, dtype=None):
    """The shared trunk: (B,H,W,3) NHWC -> res4 (B,H/16,W/16,1024), each
    stage under its span (trunk_stages)."""
    for name, fn in trunk_stages(params, dtype):
        with T.span(name):
            x = fn(x)
    return x


class StageGraphs:
    """A chain of stages on the card as CUDA graphs, one a stage, each
    replayed under its span: the host issues one launch a stage where a
    stage of eager convs takes hundreds. ``stages(params, dtype)`` gives
    [(span, fn)], fn(outs) -> out of the outputs so far (outs[0] the
    input, a tensor or a tuple of tensors); a call returns the stages'
    outputs, the graphs' output buffers, which the next call overwrites.

    With copy_input a call's input is copied into the graphs' input;
    without, the graphs read the given tensors where they lie (the output
    buffers of another StageGraphs), and new addresses recapture. The
    graphs are captured at the first call for a parameter set (its
    tensors' addresses), input shape and dtype, and again when one of
    these changes; a parameter written in place is read by the next
    replay. Before a capture two eager runs on a side stream settle
    cuDNN's and the allocator's choices. On the CPU the stages run
    eagerly, each under its span."""

    def __init__(self, stages, copy_input=True):
        self._stages, self._copy = stages, copy_input
        self._key = None
        self._graphs = self._input = self._outputs = None

    def __call__(self, params, x, dtype=None):
        xs = _tensors(x)
        if not xs[0].is_cuda:
            outs = [x]
            for name, fn in self._stages(params, dtype):
                with T.span(name):
                    outs.append(fn(outs))
            return outs[1:]
        key = (tuple(p.data_ptr() for p in params.parameters()),
               tuple(tuple(t.shape) for t in xs), xs[0].dtype, xs[0].device,
               dtype, () if self._copy else tuple(t.data_ptr() for t in xs))
        if key != self._key:
            self._capture(params, x, dtype)
            self._key = key
        if self._copy:
            for dst, src in zip(_tensors(self._input), xs):
                dst.copy_(src)
        for name, graph in self._graphs:
            with T.span(name):
                graph.replay()
        return self._outputs

    def _capture(self, params, x, dtype):
        self._graphs = self._input = self._outputs = None
        stages = self._stages(params, dtype)
        dev = _tensors(x)[0].device
        here = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            for _ in range(2):
                outs = [x]
                for _, fn in stages:
                    outs.append(fn(outs))
        here.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        if self._copy:
            x = (x.clone() if torch.is_tensor(x)
                 else type(x)(t.clone() for t in x))
        graphs, outs = [], [x]
        for name, fn in stages:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                outs.append(fn(outs))
            graphs.append((name, graph))
        self._graphs, self._input, self._outputs = graphs, x, outs[1:]


def _tensors(x):
    return [x] if torch.is_tensor(x) else list(x)


def chained(stages):
    """[(span, x -> y)] as StageGraphs' stages: each takes the output
    before it."""
    return [(name, lambda outs, fn=fn: fn(outs[-1])) for name, fn in stages]


class TrunkGraphs(StageGraphs):
    """trunk_apply_r101 on the card as four CUDA graphs, the stem's and
    each stage's (StageGraphs), each replayed under its span: the host
    issues one launch a stage where res4 alone took 395. A call returns
    res4, the graphs' output buffer. On the CPU it runs trunk_apply_r101."""

    def __init__(self):
        super().__init__(lambda params, dtype: chained(
            trunk_stages(params, dtype)))

    def __call__(self, params, x, dtype=None):
        if not x.is_cuda:
            return trunk_apply_r101(params, x, dtype)
        return super().__call__(params, x, dtype)[-1]


def res5_head(params, pooled, dtype=None):
    """res5 per RoI: pooled (R,14,14,1024) -> (R,2048), the mean over its
    7x7 map, in float32."""
    return stage(params, pooled, RES5, dtype).float().mean(dim=(1, 2))


def predict(params, feat):
    """cls_score and its softmax, bbox_pred: the heads in float32 on (R,
    2048) features."""
    cls_score = mv3d.fc_apply(params, "cls_score", feat.float(), relu=False)
    bbox_pred = mv3d.fc_apply(params, "bbox_pred", feat.float(), relu=False)
    return cls_score, torch.softmax(cls_score, dim=-1), bbox_pred


def detect_head(params, pooled, dtype, decode):
    """im_detect_2d's head (models/factory's 2D spec): res5 per RoI in
    dtype under the span im_detect_2d.head.res5, then the float32 heads
    and decode(cls_prob, bbox_pred) under im_detect_2d.head.predict."""
    with T.span("im_detect_2d.head.res5"):
        x = res5_head(params, pooled, dtype)
    with T.span("im_detect_2d.head.predict"):
        _, cls_prob, bbox_pred = predict(params, x)
        return decode(cls_prob, bbox_pred)
