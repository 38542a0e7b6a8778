"""VGG16 trunk, stride-8 detection variant (mv3d_tf_tpu/models/vgg.py):
13 SAME 3x3 convs with ReLU and three 2x2 VALID max pools, so a 601x601
BEV becomes 75x75 features.

Feature maps are NHWC at every function here, as in the JAX package.
Inside, each op runs on the NCHW view of the NHWC tensor (a permute, no
copy), which PyTorch treats as channels_last. Conv weights are OIHW
(converted from the JAX HWIO once, in utils/weights.py).
"""

import torch
import torch.nn.functional as F

# (name, out_channels, pool_after) — pool follows conv1_2, conv2_2, conv3_3
VGG_LAYERS = (
    ("conv1_1", 64, False), ("conv1_2", 64, True),
    ("conv2_1", 128, False), ("conv2_2", 128, True),
    ("conv3_1", 256, False), ("conv3_2", 256, False), ("conv3_3", 256, True),
    ("conv4_1", 512, False), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv5_1", 512, False), ("conv5_2", 512, False), ("conv5_3", 512, False),
)


def f32_convs_without_tf32():
    """Float32 convolutions in full float32: cuDNN runs them in TF32 by
    default, which the JAX package's HIGHEST precision does not. Turns
    TF32 off for the process's cuDNN convs and leaves it off: the flag is
    written once, never toggled around a call, so no thread sees it flip."""
    if torch.backends.cudnn.allow_tf32:
        torch.backends.cudnn.allow_tf32 = False


def conv2d(x, w, b, padding="SAME", relu=True, dtype=None):
    """Conv + bias (+ ReLU), vgg.py:29-45. x (B,H,W,Cin) NHWC, w OIHW.

    dtype=None keeps float32 with TF32 off (parity mode; the first float32
    conv on a card calls f32_convs_without_tf32); bfloat16 casts input,
    weights and bias, as the JAX package does.
    """
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    pad = w.shape[-1] // 2 if padding == "SAME" else 0
    if x.dtype == torch.float32 and x.is_cuda:
        f32_convs_without_tf32()
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=pad)
    y = y.permute(0, 2, 3, 1)
    return F.relu(y) if relu else y


def max_pool_2x2_valid(x):
    """2x2 stride-2 VALID max pool on NHWC; drops an odd last row/column."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def module_key(name):
    """Legal module name of a reference layer name ('rpn_conv/3x3')."""
    return name.replace("/", "__")


def layer(params, name):
    """(weight, bias) of the reference-named layer in a parameter ModuleDict."""
    m = params[module_key(name)]
    return m.weight, m.bias


def empty_layer(cls, shape_args, device="cuda"):
    """An uninitialised Conv2d or Linear layer on ``device``: the card
    unless the caller asks for another device; without a card it raises."""
    return torch.nn.utils.skip_init(cls, *shape_args, device=device)


def init_layer(generator, cls, shape_args, std=0.01, device="cuda"):
    """A conv or linear layer with truncated-normal(0, std) weights cut at
    two std and zero biases, the JAX package's init (vgg.py:62-73)."""
    m = empty_layer(cls, shape_args, device)
    with torch.no_grad():
        torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                    generator=generator)
        m.bias.zero_()
    return m


def init_trunk(generator, in_channels, suffix="", device="cuda"):
    """{module key: Conv2d} for the 13 trunk convs."""
    params = {}
    c_in = in_channels
    for name, c_out, _ in VGG_LAYERS:
        params[module_key(name + suffix)] = init_layer(
            generator, torch.nn.Conv2d, (c_in, c_out, 3), device=device)
        c_in = c_out
    return params


# The stem vocabulary: each accepted stem_impl name -> its canonical stem.
# "bf16" and "pallas" are the JAX package's names of the literal and the
# fused stem. The last two stems are integer and run only in the int8
# detector (quant.extract_features_int8).
STEMS = {"literal": "literal", "bf16": "literal", "fused": "fused",
         "pallas": "fused", "s2d": "s2d", "s2d_fused": "s2d_fused",
         "s2d_int8": "s2d_int8", "int8": "int8"}
INT8_STEMS = ("s2d_int8", "int8")


def stem_name(stem_impl, int8=False):
    """The canonical stem that stem_impl names (STEMS); None is the literal
    stem. The integer stems only with int8=True."""
    stem = STEMS.get("literal" if stem_impl is None else stem_impl)
    if stem is None or (stem in INT8_STEMS and not int8):
        raise ValueError(
            "unknown stem_impl {!r}{}".format(
                stem_impl, "" if int8 else " for the float trunk (the "
                "s2d_int8 and int8 stems run in the int8 detector)"))
    return stem


def detector_stem(stem_impl, dtype=None, int8=False):
    """The stem a detector runs: stem_impl's, or for None the detectors'
    default, the fused stem for the float detector in bfloat16 and the
    literal stem otherwise and for the int8 detector (eval.py:174-182)."""
    if stem_impl is None and dtype == torch.bfloat16 and not int8:
        return "fused"
    return stem_name(stem_impl, int8)


def vgg_stem_plain(x, w1, b1, w2, b2, dtype=torch.bfloat16):
    """The literal stem: conv1_1, conv1_2 (each + bias + ReLU) and pool1 in
    dtype, bfloat16 by default (None keeps float32): the fused stem's plain
    version. It rounds after each bias; the fused kernel rounds once, within
    one bf16 ulp of the max."""
    y = conv2d(x, w1, b1, dtype=dtype)
    return max_pool_2x2_valid(conv2d(y, w2, b2, dtype=dtype))


def stem_apply(stem_impl, x, w1, b1, w2, b2, dtype=None):
    """conv1_1 + conv1_2 + pool1 (vgg.py:76-126) by the float stem that
    stem_impl names, in dtype (None: float32). x (B,H,W,Cin) NHWC, weights
    OIHW, biases (64,) -> (B,H//2,W//2,64):
      "literal" — vgg_stem_plain: two conv2d calls and the pool;
      "fused"   — the hand-written bf16 kernel of csrc/stem_s2d.cu
                  (ops/stem_s2d_cuda.stem_s2d_fused_cuda) on a CUDA tensor,
                  the literal bf16 stem on the CPU; bfloat16 only;
      "s2d"     — ops/stem_s2d.stem_s2d: the space-to-depth packed convs,
                  differentiable;
      "s2d_fused" — ops/stem_s2d_cuda.stem_s2d_fused (float32 for None):
                  the fused s2d kernel on a CUDA tensor, its plain version
                  on the CPU; inference only.
    """
    # imported here: ops/stem_s2d imports this module
    from mv3d_tf_tpu_torch.ops.stem_s2d import stem_s2d
    from mv3d_tf_tpu_torch.ops.stem_s2d_cuda import (stem_s2d_fused,
                                                     stem_s2d_fused_cuda)
    stem = stem_name(stem_impl)
    if stem == "literal":
        return vgg_stem_plain(x, w1, b1, w2, b2, dtype)
    if stem == "s2d":
        return stem_s2d(x, w1, b1, w2, b2, dtype=dtype)
    if stem == "s2d_fused":
        return stem_s2d_fused(x, w1, b1, w2, b2, dtype=dtype or torch.float32)
    if dtype != torch.bfloat16:
        raise ValueError("the fused literal stem outputs bfloat16: run the "
                         "trunk with dtype=torch.bfloat16")
    if x.is_cuda:
        return stem_s2d_fused_cuda(x, w1, b1, w2, b2, torch.bfloat16)
    if x.device.type == "cpu":
        return vgg_stem_plain(x, w1, b1, w2, b2, torch.bfloat16)
    raise ValueError("stem_apply: no fused stem for device " + str(x.device))


def trunk_apply(params, x, suffix="", dtype=None, stem_impl=None):
    """Run the 13-conv trunk. x (B,H,W,C) NHWC -> conv5_3 (B,H/8,W/8,512).

    stem_impl names how conv1_1 + conv1_2 + pool1 run (STEMS, stem_apply);
    None is the literal stem.
    """
    x = stem_apply(stem_impl, x, *layer(params, "conv1_1" + suffix),
                   *layer(params, "conv1_2" + suffix), dtype=dtype)
    for name, _, pool in VGG_LAYERS[2:]:
        x = conv2d(x, *layer(params, name + suffix), dtype=dtype)
        if pool:
            x = max_pool_2x2_valid(x)
    return x
