"""Post-training int8 quantization (PTQ) of the detector, the port of
mv3d_tf_tpu/quant.py.

  * weights: per-output-channel symmetric int8 (scale = max|w| / 127);
  * activations: per-tensor scales from a calibration pass (max|a| / 127
    over a few frames); every trunk activation is post-ReLU, so [0, 127];
  * conv: s8 x s8 -> s32, then the folded requant epilogue
    clip(round(fma(acc, s_in*s_w/s_out, bias/s_out)), 0, 127), fused into
    the conv kernel (ops/conv_s8.py, csrc/conv_s8.cu). A built detector
    prepares each trunk once (prepare_trunk_weights: the (N, 9*Cp) weight
    operand and the folded k and b) and keeps that copy itself;
  * the s2d int8 stem's packed conv1_2 is the s8 2x2 kernel on the
    quantized packed weight; a built detector prepares each view's stem
    (prepare_s2d_stem_int8: packed conv1_1 in bf16, the (N, 4*Cp) operand
    of conv1_2 and its folded k and b) on its first call and keeps it until
    the params' conv1 tensors or the state's conv1 scales change
    (s2d_stem_weights);
  * 2x2 max pools run on int8 directly (max commutes with the monotone
    quantization map);
  * the fusion head's fc6/fc7 run as s8 GEMMs (csrc/matmul_s8.cu) on the
    int8 ROI-pooled features; cls/bbox stay bf16. A built detector lays the
    four fc weights out once for the GEMM (prepare_head_weights) and keeps
    that copy itself: the state keeps JAX's (in, out) leaves.

The quant state is the JAX package's pytree with tensor leaves: the same
keys, HWIO ``w_q`` for convs and (in, out) for fcs, 0-dim float32 scales,
``head`` None when no head calibration was given. One ``.npz`` serves both
packages (``save_quant_state`` / ``load_quant_state``,
utils/weights.quant_state_from_jax).

Every s8 conv runs through ops/conv_s8 (the kernel on a card, the plain
version on the CPU): the JAX package's TPU lowerings of the int8 convs
name one set of integers, and the tilings they pick stay behind. Scales
divide as 0-dim tensors on the data's device, never as Python floats (a
card turns those into a reciprocal multiply).
"""

import numpy as np
import torch

from mv3d_tf_tpu_torch.models import mv3d, vgg
from mv3d_tf_tpu_torch.ops import conv_s8 as S8
from mv3d_tf_tpu_torch.ops.conv_s8 import requant
from mv3d_tf_tpu_torch.ops.stem_s2d import (group_max, hwio, pack_stem_weights,
                                            packed_conv1_1)

FC_LAYERS = ("fc6_1", "fc7_1", "fc6_2", "fc7_2")
_BF16 = torch.bfloat16
# XLA rewrites a division by a constant under jit into a multiply by the
# constant's float32 reciprocal; a division by a runtime scale it keeps
_INV127 = float(np.float32(1.0 / 127.0))


def _device(params):
    return next(params.parameters()).device


def _f32(v, device):
    """v (a Python float or a 0-dim tensor) as a 0-dim float32 tensor on
    ``device``: jnp.float32(v)."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _quantize(x, s, low):
    """clip(round(float32(x) / s), low, 127) as int8."""
    return torch.round(x.float() / _f32(s, x.device)).clamp(low, 127).to(
        torch.int8)


def _max_pool_s8(x):
    """2x2 VALID max pool of an int8 NHWC map (drops an odd last row and
    column), as the max of four strided slices: exact on any device."""
    H, W = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    return torch.maximum(
        torch.maximum(x[:, 0:H:2, 0:W:2], x[:, 0:H:2, 1:W:2]),
        torch.maximum(x[:, 1:H:2, 0:W:2], x[:, 1:H:2, 1:W:2]))


def quantize_weights(w):
    """(kh,kw,cin,cout) float32 numpy -> (int8 weights, (cout,) float32
    scales), quant.py:92-98."""
    w = np.asarray(w, np.float32)
    scale = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return w_q, scale


def _quantize_weights_t(w):
    """quantize_weights on a float32 HWIO tensor, on its device: the JAX
    package's in-graph form (quant.py:501-505, 559-563) as XLA compiles it,
    which turns ``max / 127.0`` into a multiply by float32(1/127)."""
    s_w = (w.abs().reshape(-1, w.shape[-1]).amax(0)
           * _f32(_INV127, w.device)).clamp_min(1e-12)
    return torch.round(w / s_w).clamp(-127, 127).to(torch.int8), s_w


def calibrate_trunk(params, frames, suffix=""):
    """Per-layer activation scales of one trunk from a calibration batch
    frames (B,H,W,C) (mean-subtracted for the image trunk), through the
    literal bf16 trunk. Returns {"__input__": s_in, layer: s_out, ...} as
    Python floats max / 127."""
    dev = _device(params)
    x = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        maxes = {"__input__": x.abs().max()}
        h = x.to(_BF16)
        for name, _, pool in vgg.VGG_LAYERS:
            h = vgg.conv2d(h, *vgg.layer(params, name + suffix), dtype=_BF16)
            if pool:
                h = vgg.max_pool_2x2_valid(h)
            maxes[name] = h.float().abs().max()
    return {k: float(v) / 127.0 for k, v in maxes.items()}


def quantize_trunk(params, act_scales, suffix=""):
    """The int8 trunk: {layer: {w_q int8 HWIO, bias, s_w (cout,), s_in,
    s_out}}, keyed without the suffix, on the params' device."""
    dev = _device(params)
    q = {}
    s_in = float(act_scales["__input__"])
    for name, _, _ in vgg.VGG_LAYERS:
        w, b = vgg.layer(params, name + suffix)
        w_q, s_w = quantize_weights(
            np.ascontiguousarray(hwio(w).detach().float().cpu().numpy()))
        q[name] = {"w_q": torch.from_numpy(w_q).to(dev),
                   "bias": b.detach().float().clone(),
                   "s_w": torch.from_numpy(s_w).to(dev),
                   "s_in": _f32(s_in, dev),
                   "s_out": _f32(act_scales[name], dev)}
        s_in = float(act_scales[name])
    return q


def prepare_trunk_weights(qtrunk):
    """One int8 trunk's 13 convs as the 3x3 kernel takes them, made once:
    {layer: {"w_nk": the (N, 9*Cp) operand of
    ops/conv_s8.prepare_s8_conv_weight, "k": s_in*s_w/s_out, "b":
    bias/s_out}}, the folded requant of quant.py:172-173, computed on the
    state's device as the per-call epilogue computed it. A new dict; qtrunk
    is left as it is."""
    return {name: {"w_nk": S8.prepare_s8_conv_weight(p["w_q"]),
                   "k": p["s_in"] * p["s_w"] / p["s_out"],
                   "b": p["bias"] / p["s_out"]}
            for name, p in qtrunk.items()}


def _conv_requant(x, pw):
    """One int8 3x3 conv with the folded requant epilogue, on pw, one layer
    of prepare_trunk_weights' dict."""
    return S8.conv3x3_s8_nk(x, pw["w_nk"], pw["k"], pw["b"])


def trunk_apply_int8(qtrunk, x, trunk_w):
    """The 13-conv trunk in int8 from the input: float x is quantized at
    conv1_1's input scale (an int8 x is taken as it is); the convs run on
    trunk_w, prepare_trunk_weights(qtrunk). Returns (feat int8 (B,h,w,512),
    s_feat)."""
    if x.dtype != torch.int8:
        x = _quantize(x, qtrunk["conv1_1"]["s_in"], -127)
    for name, _, pool in vgg.VGG_LAYERS:
        x = _conv_requant(x, trunk_w[name])
        if pool:
            x = _max_pool_s8(x)
    return x, qtrunk["conv5_3"]["s_out"]


def trunk_apply_int8_from_stem(qtrunk, stem_out, trunk_w):
    """conv2_1 .. conv5_3 in int8 on trunk_w (prepare_trunk_weights) after
    a float stem output (conv1_2 and pool1 done), quantized at conv1_2's
    output scale."""
    x = _quantize(stem_out, qtrunk["conv1_2"]["s_out"], 0)
    return trunk_apply_int8_from_stem_q(qtrunk, x, trunk_w)


def trunk_apply_int8_from_stem_q(qtrunk, stem_q, trunk_w):
    """conv2_1 .. conv5_3 on trunk_w (prepare_trunk_weights) from an int8
    stem output at conv1_2's scale."""
    x = stem_q
    for name, _, pool in vgg.VGG_LAYERS[2:]:
        x = _conv_requant(x, trunk_w[name])
        if pool:
            x = _max_pool_s8(x)
    return x, qtrunk["conv5_3"]["s_out"]


# ---------------------------------------------------------------------------
# Fusion head (fc6/fc7 per view in int8, cls/bbox in bf16)
# ---------------------------------------------------------------------------

def calibrate_head(params, pooled_bv, pooled_img):
    """Activation scales of the fc stack from calibration ROI features,
    through the bf16 head (quant.py:300-321). Python floats max / 127."""
    dev = _device(params)

    def amax(a):
        return float(a.float().abs().max())

    with torch.inference_mode():
        x1 = torch.as_tensor(pooled_bv, device=dev)
        x2 = torch.as_tensor(pooled_img, device=dev)
        x1 = x1.reshape(x1.shape[0], -1).to(_BF16)
        x2 = x2.reshape(x2.shape[0], -1).to(_BF16)
        scales = {"pooled_bv": amax(x1) / 127.0,
                  "pooled_img": amax(x2) / 127.0}
        for view, x in (("1", x1), ("2", x2)):
            for fc in ("fc6_", "fc7_"):
                x = mv3d.fc_apply(params, fc + view, x)
                scales[fc + view] = amax(x) / 127.0
    return scales


def quantize_head(params, head_scales):
    """int8 fc6/fc7 of both views: w_q (in, out) int8, bias, s_w (out,);
    the scales as 0-dim float32. cls_score / bbox_pred stay bf16."""
    dev = _device(params)
    q = {"scales": {k: _f32(v, dev) for k, v in head_scales.items()}}
    for name in FC_LAYERS:
        w, b = vgg.layer(params, name)
        w = w.detach().float().cpu().numpy().T                 # (in, out)
        s_w = np.maximum(np.abs(w).max(axis=0) / 127.0,
                         1e-12).astype(np.float32)
        w_q = np.clip(np.rint(w / s_w), -127, 127).astype(np.int8)
        q[name] = {"w_q": torch.from_numpy(np.ascontiguousarray(w_q)).to(dev),
                   "bias": b.detach().float().clone(),
                   "s_w": torch.from_numpy(s_w).to(dev)}
    return q


def prepare_head_weights(qhead):
    """The four fc weights as the GEMM kernel's (out, in) operands
    (ops/conv_s8.prepare_s8_gemm_weight), laid out once: {layer: w_nk}.
    A new dict; qhead is left as it is."""
    return {name: S8.prepare_s8_gemm_weight(qhead[name]["w_q"])
            for name in FC_LAYERS}


def _fc_s8(x_q, p, s_in, w_nk):
    """relu(fma(float(x_q @ w_q), s_in*s_w, bias)) in float32, with w_nk
    the layer's w_q as prepare_head_weights lays it out."""
    acc = S8.matmul_s8_nk(x_q, w_nk)
    return requant(acc, s_in * p["s_w"], p["bias"], torch.float32)


def fc_int8(qhead, pooled_q, s_in, view, weights_nk):
    """fc6 and fc7 of one view ("1" BEV, "2" image) in int8 on its pooled
    codes (N,7,7,C) at scale s_in, requantized between the two at fc6's
    calibrated scale (quant.py:360-365), the GEMMs on weights_nk,
    prepare_head_weights' dict. Returns float32 (N, fc_dim)."""
    sc = qhead["scales"]
    fc6, fc7 = "fc6_" + view, "fc7_" + view
    f = _fc_s8(pooled_q.reshape(pooled_q.shape[0], -1), qhead[fc6], s_in,
               weights_nk[fc6])
    return _fc_s8(_quantize(f, sc[fc6], 0), qhead[fc7], sc[fc6],
                  weights_nk[fc7])


def fusion_head_int8(params, qhead, pooled_bv_q, s_bv, pooled_img_q, s_img,
                     weights_nk):
    """The fusion head on int8 ROI features (scales s_bv, s_img): fc6/fc7
    per view as s8 GEMMs (fc_int8 on weights_nk, prepare_head_weights'
    dict); cls/bbox in
    bf16 on the fused activations, no dropout. Returns cls_score, cls_prob
    (float32 softmax), bbox_pred."""
    fused = torch.cat([fc_int8(qhead, pooled_bv_q, s_bv, "1", weights_nk),
                       fc_int8(qhead, pooled_img_q, s_img, "2", weights_nk)],
                      dim=1).to(_BF16)
    cls_score = mv3d.fc_apply(params, "cls_score", fused, relu=False)
    cls_prob = torch.softmax(cls_score.float(), dim=-1)
    bbox_pred = mv3d.fc_apply(params, "bbox_pred", fused, relu=False)
    return cls_score, cls_prob, bbox_pred


def calibrate_pooled_features(params, bev_frames, image_frames, calib,
                              feat_h=75, feat_w=75, post_nms_top_n=300):
    """ROI-pooled calibration features for the int8 head: the bf16
    detector (literal stem, pre-NMS 6000) on the calibration frames; only
    the valid proposals' rows are kept (all rows if none is valid).
    image_frames must already be mean-subtracted."""
    from mv3d_tf_tpu_torch import eval as E
    from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_fast
    dev = _device(params)
    bev = torch.as_tensor(bev_frames, dtype=torch.float32, device=dev)
    image = torch.as_tensor(image_frames, dtype=torch.float32, device=dev)
    calib = torch.as_tensor(calib, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        c5, c5_2 = mv3d.extract_features(params, bev, image, dtype=_BF16)
        rpn_cls, rpn_box = mv3d.rpn_head(params, c5, dtype=_BF16)
        rois, flat_bv, flat_img = E.proposals(
            rpn_cls, rpn_box, calib, feat_h, feat_w, pre_nms_top_n=6000,
            post_nms_top_n=post_nms_top_n, rpn_nms_thresh=0.7)
        pooled_bv = roi_pool_fast(c5, flat_bv, spatial_scale=1.0 / 8)
        pooled_img = roi_pool_fast(c5_2, flat_img, spatial_scale=1.0 / 8)
        keep = rois["valid"].reshape(-1)
        if not keep.any():
            keep = torch.ones_like(keep)
        return pooled_bv[keep], pooled_img[keep]


def build_quant_state(params, bev_frames, image_frames, pooled_bv=None,
                      pooled_img=None, use_stem=True):
    """One-call PTQ: calibrate and quantize both trunks and, given
    head-calibration ROI features, the head. image_frames must already be
    mean-subtracted. Returns the state that build_detect_batch_fn takes."""
    state = {
        "trunk_bv": quantize_trunk(
            params, calibrate_trunk(params, bev_frames, suffix=""), ""),
        "trunk_img": quantize_trunk(
            params, calibrate_trunk(params, image_frames, suffix="_2"), "_2"),
        "use_stem": use_stem,
        "head": None,
    }
    if pooled_bv is not None and pooled_img is not None:
        state["head"] = quantize_head(
            params, calibrate_head(params, pooled_bv, pooled_img))
    return state


# ---------------------------------------------------------------------------
# Stems and the int8 RPN
# ---------------------------------------------------------------------------

def _conv1_2_operand(K2, b2, s1, s2):
    """The packed conv1_2 (K2 (2,2,4C1,4C2) float, bias b2 (C2,)) as the 2x2
    kernel takes it: {"w_nk": the (4C2, 4*Cp) operand of the weight
    quantized per output channel (quant.py:499-505), "k": s1*s_w/s2, "b":
    tile(b2, 4)/s2} (quant.py:506-507), on the weight's device."""
    K2q, s_w = _quantize_weights_t(K2.float())
    return {"w_nk": S8.prepare_s8_conv2x2_weight(K2q), "k": s1 * s_w / s2,
            "b": b2.float().repeat(4) / s2}


def s2d_conv1_2_int8(y_q, K2, b2, s1, s2):
    """The s2d int8 stem after conv1_1 (quant.py:495-548): the packed
    conv1_2 (K2 (2,2,4C1,4C2) float, bias b2 (C2,)) quantized as the JAX
    package quantizes it in-graph, as the s8 2x2 VALID conv on y_q (int8 at
    conv1_1's scale s1) with the requant epilogue at conv1_2's scale s2,
    then pool1 as the max of the 4 subpixel groups on int8. Returns stem_q
    int8 (B,H/2,W/2,C2). The weight is prepared on every call; a built
    detector prepares it once (prepare_s2d_stem_int8)."""
    pw = _conv1_2_operand(K2, b2, s1, s2)
    return group_max(S8.conv2x2_s8_nk(y_q, pw["w_nk"], pw["k"], pw["b"]),
                     b2.shape[0])


def prepare_s2d_stem_int8(params, qtrunk, suffix=""):
    """One view's s2d int8 stem weights, made once: {"K1", "B1": the packed
    conv1_1 in bf16, "C1", "C2": conv1_1's and conv1_2's widths, "conv1_2":
    _conv1_2_operand of the packed conv1_2 at the scales of qtrunk}, the
    bits that the per-call stem computes, detached from autograd."""
    w1, b1 = vgg.layer(params, "conv1_1" + suffix)
    w2, b2 = vgg.layer(params, "conv1_2" + suffix)
    with torch.no_grad():
        K1, B1, K2, _ = pack_stem_weights(hwio(w1), b1, hwio(w2), b2)
        return {"K1": K1.to(_BF16), "B1": B1.to(_BF16), "C1": w1.shape[0],
                "C2": w2.shape[0],
                "conv1_2": _conv1_2_operand(K2, b2,
                                            qtrunk["conv1_1"]["s_out"],
                                            qtrunk["conv1_2"]["s_out"])}


def _version(t):
    """t's in-place version counter (an inference tensor keeps none: -1)."""
    return -1 if t.is_inference() else t._version


def s2d_stem_weights(cache, params, qtrunk, suffix=""):
    """prepare_s2d_stem_int8's dict for one view, kept in ``cache`` (a dict
    the caller owns, one per view): made on the first call and again only
    when the tensors it is made from (the params' conv1_1 and conv1_2
    weights and biases, qtrunk's conv1_1 and conv1_2 s_out) are other
    tensors, or were changed in place, since. An inference tensor keeps no
    version counter, so an in-place change of one (possible only under
    torch.inference_mode) is not seen; its replacement by another tensor
    is. A built int8 detector keeps one cache per view, so the stem
    weights are prepared once for a given set of params."""
    src = [t for name in ("conv1_1", "conv1_2")
           for t in vgg.layer(params, name + suffix)]
    src += [qtrunk[name]["s_out"] for name in ("conv1_1", "conv1_2")]
    seen = cache.get("source")
    if seen is None or any(a is not t or v != _version(t)
                           for (a, v), t in zip(seen, src)):
        cache["weights"] = prepare_s2d_stem_int8(params, qtrunk, suffix)
        cache["source"] = [(t, _version(t)) for t in src]
    return cache["weights"]


def s2d_stem_int8_stages(qtrunk, x, stem_w):
    """The s2d int8 stem on stem_w (prepare_s2d_stem_int8's dict), one
    stage at a time: yields (stage, output) after the packed conv1_1 in
    bf16, its quantization at conv1_1's scale, the s8 2x2 packed conv1_2
    with the requant at conv1_2's scale, and pool1 as the max of the 4
    subpixel groups on int8, whose output is stem_q int8 (B,H/2,W/2,C2).
    _s2d_stem_int8 runs it to its end; a caller that times the stages
    reads the clock between the yields."""
    y = packed_conv1_1(x.to(_BF16), stem_w["K1"], stem_w["B1"],
                       stem_w["C1"])
    yield "packed conv1_1", y
    y_q = _quantize(y, qtrunk["conv1_1"]["s_out"], 0)
    yield "quantize", y_q
    pw = stem_w["conv1_2"]
    z_q = S8.conv2x2_s8_nk(y_q, pw["w_nk"], pw["k"], pw["b"])
    yield "2x2 conv", z_q
    yield "group max", group_max(z_q, stem_w["C2"])


def _s2d_stem_int8(qtrunk, x, stem_w):
    """Space-to-depth stem with the packed conv1_1 in bf16 (quantized at
    the literal conv1_1 scale) and the packed conv1_2 in int8, on stem_w
    (prepare_s2d_stem_int8's dict): s2d_stem_int8_stages to its end.
    Returns (stem_q int8, s_out) for trunk_apply_int8_from_stem_q."""
    *_, (_, stem_q) = s2d_stem_int8_stages(qtrunk, x, stem_w)
    return stem_q, qtrunk["conv1_2"]["s_out"]


def rpn_conv_int8(params, feat_q, s_in):
    """The RPN's 3x3 512->512 conv in s8 on the int8 trunk features at
    scale s_in (weights quantized per output channel, quant.py:558-565),
    with the dequant + ReLU epilogue: float32 (B,h,w,512)."""
    w, b = vgg.layer(params, "rpn_conv/3x3")
    w_q, s_w = _quantize_weights_t(hwio(w).float())
    return S8.conv3x3_s8(feat_q, w_q, s_in * s_w, b.float(),
                         out_dtype=torch.float32)


def rpn_head_int8(params, feat_q, s_in):
    """RPN head on the int8 trunk features: rpn_conv_int8, then the bf16
    1x1 score and delta heads (twin of mv3d.rpn_head)."""
    x = rpn_conv_int8(params, feat_q, s_in).to(_BF16)
    cls = vgg.conv2d(x, *vgg.layer(params, "rpn_cls_score"), padding="VALID",
                     relu=False, dtype=_BF16)
    bbox = vgg.conv2d(x, *vgg.layer(params, "rpn_bbox_pred"),
                      padding="VALID", relu=False, dtype=_BF16)
    return cls, bbox


def extract_features_int8(params, quant, bev, image, trunk_w, stem_cache,
                          stem=None):
    """Quantized twin of mv3d.extract_features (quant.py:610-689), the
    trunks' convs on trunk_w = {key: prepare_trunk_weights(quant[key])} for
    "trunk_bv" and "trunk_img"; the s2d_int8 stem's weights from
    stem_cache = {"trunk_bv": {}, "trunk_img": {}}, owned by the caller
    (s2d_stem_weights: prepared once per view and kept there; the other
    stems do not read it). stem is any name of models/vgg.STEMS (None:
    the literal stem):
      "s2d_int8" — s2d with the packed conv1_2 as the s8 2x2 kernel,
                   feeding the trunk int8 directly;
      "int8"     — int8 from the input;
      a float stem — vgg.stem_apply in bf16, then int8 from conv2_1.
    Returns (feat_bv_q, s_bv, feat_img_q, s_img)."""
    stem = vgg.stem_name(stem, int8=True)
    out = []
    for key, x, suffix in (("trunk_bv", bev, ""), ("trunk_img", image, "_2")):
        qt, tw = quant[key], trunk_w[key]
        if stem == "s2d_int8":
            sw = s2d_stem_weights(stem_cache[key], params, qt, suffix)
            stem_q, _ = _s2d_stem_int8(qt, x, sw)
            out += trunk_apply_int8_from_stem_q(qt, stem_q, tw)
        elif stem == "int8":
            out += trunk_apply_int8(qt, x, tw)
        else:
            s = vgg.stem_apply(stem, x,
                               *vgg.layer(params, "conv1_1" + suffix),
                               *vgg.layer(params, "conv1_2" + suffix),
                               dtype=_BF16)
            out += trunk_apply_int8_from_stem(qt, s, tw)
    return tuple(out)


# ---------------------------------------------------------------------------
# Quant-state persistence: the .npz layout of quant.py:698-727
# ---------------------------------------------------------------------------

def save_quant_state(path, state):
    """Write a quant state to one .npz, keys "q/trunk_bv/conv1_1/w_q", ...,
    a missing head as "q/head//none": the file the JAX package writes."""
    from mv3d_tf_tpu_torch.utils.weights import quant_state_to_jax
    flat = {}

    def rec(prefix, node):
        if node is None:
            flat[prefix + "//none"] = np.zeros(0, np.int8)
        elif isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + "/" + k, v)
        else:
            flat[prefix] = node
    rec("q", quant_state_to_jax(state))
    np.savez_compressed(path, **flat)


def load_quant_state(path, device="cuda"):
    """Read a quant state .npz (written by either package) with tensor
    leaves on ``device``: the card unless the caller asks otherwise."""
    from mv3d_tf_tpu_torch.utils.weights import quant_state_from_jax
    state = {}
    with np.load(path) as blob:
        for key in blob.files:
            is_none = key.endswith("//none")
            parts = [p for p in key[2:].split("/") if p]   # strip "q/"
            if is_none:
                parts = parts[:-1]                         # drop "none"
            node = state
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = None if is_none else blob[key]
    return quant_state_from_jax(state, device)
