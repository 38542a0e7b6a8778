"""Inference: the MV3D detector on tensors (mv3d_tf_tpu/eval.py) — both
trunks, RPN, proposal layer, dual-view ROI pooling, fusion head and
corner decode, eagerly, on the device that holds the parameters: the card,
since utils/weights.params_from_jax and models/mv3d.init_params put them
there unless asked otherwise. Its BEV input comes from the LiDAR front end
(ops/bev.py:point_cloud_2_top_batch, data/blob.make_bird_view), which
rasterizes a scan on the card, or from a raster file (tools/read_lidar.py).

Parity notes, as in the JAX package:
  * the image mean is subtracted in float32 before any cast;
  * boxes for BEV NMS come from the UNREGRESSED corners; the regressed
    corners are returned alongside.
In bfloat16 the trunks run the fused conv1 stem (ops/vgg_stem_cuda.py)
unless the batched detector is given another stem (the fused s2d stem of
ops/stem_s2d_cuda.py among them); on a card both run the one bf16 kernel
of csrc/stem_s2d.cu, and the ROI pooling runs the CUDA kernel
(ops/roi_pool.py).
Given an int8 quant state (quant.py), the batched detector runs the int8
trunks, RPN conv, ROI pool and fc6/fc7 through the s8 kernels
(ops/conv_s8.py).
"""

import numpy as np
import torch

from mv3d_tf_tpu_torch import geometry as G
from mv3d_tf_tpu_torch import quant as Q
from mv3d_tf_tpu_torch import trace as T
from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.models import mv3d
from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_fast
from mv3d_tf_tpu_torch.proposals import proposal_layer_3d
from mv3d_tf_tpu_torch.utils.native import nms_np_native

PIXEL_MEANS = np.array([95.8814, 98.7743, 93.8549], np.float32)
_NMS_IMPLS = ("auto", "blocked_fixed")


def proposals(rpn_cls, rpn_box, calib, feat_h=75, feat_w=75,
              pre_nms_top_n=6000, post_nms_top_n=300, rpn_nms_thresh=0.7,
              nms_impl="auto"):
    """The proposal layer for B frames, and its rois flattened for the ROI
    pool with the frame index in column 0 (eval.py:217-220). Returns
    (rois, flat_bv (B*P,5), flat_img (B*P,5)); nms_impl is the layer's."""
    B, P = rpn_cls.shape[0], post_nms_top_n
    with T.span("detect.proposals"):
        rois = proposal_layer_3d(mv3d.rpn_probs(rpn_cls), rpn_box.float(),
                                 calib, feat_h, feat_w,
                                 pre_nms_top_n=pre_nms_top_n,
                                 post_nms_top_n=P, nms_thresh=rpn_nms_thresh,
                                 nms_impl=nms_impl)
        frame = torch.arange(B, dtype=torch.float32, device=rpn_cls.device
                             ).repeat_interleave(P)[:, None]
        flat_bv = torch.cat([frame, rois["rois_bv"].reshape(B * P, 5)[:, 1:]],
                            1)
        flat_img = torch.cat(
            [frame, rois["rois_img"].reshape(B * P, 5)[:, 1:]], 1)
    return rois, flat_bv, flat_img


def _outputs(rois, cls_prob, bbox_pred):
    """The corner decode and the masked output dict, leading dims (B, P)."""
    B, P = rois["valid"].shape
    boxes_cnr = G.lidar_3d_to_corners(rois["rois_3d"].reshape(B * P, 7)[:, 1:])
    # unregressed corners duplicated per class (test_mv.py:255)
    pred_cnr = torch.cat([boxes_cnr, boxes_cnr], dim=1)
    pred_cnr_r = G.bbox_transform_inv_cnr(boxes_cnr, bbox_pred.float())
    pred_bv = G.corners_to_bv(pred_cnr)

    mask = rois["valid"].reshape(B * P, 1).float()
    out = {
        "scores": (cls_prob * mask).reshape(B, P, -1),
        "boxes_bv": (pred_bv * mask).reshape(B, P, -1),
        "boxes_cnr": (pred_cnr * mask).reshape(B, P, -1),
        "boxes_cnr_r": (pred_cnr_r * mask).reshape(B, P, -1),
        "rois_3d": rois["rois_3d"],
        "rois_img": rois["rois_img"],
        "valid": rois["valid"],
    }
    if "nms_converged" in rois:
        out["nms_converged"] = rois["nms_converged"]
    return out


def detect_from_features(params, c5, c5_2, calib, feat_h=75, feat_w=75,
                         pre_nms_top_n=6000, post_nms_top_n=300,
                         rpn_nms_thresh=0.7, compute_dtype=None,
                         pool=roi_pool_fast, nms_impl="auto"):
    """The detector after the trunks, for B frames.

    c5 (B,h,w,512) BEV and c5_2 (B,h',w',512) image features; calib
    (B,4,12). ``pool`` is the ROI pool (the kernel dispatch by default).
    Returns the single-frame detector's keys with leading dims (B, P), and
    "nms_converged" (B,) with nms_impl="blocked_fixed".
    """
    with T.span("detect.rpn"):
        rpn_cls, rpn_box = mv3d.rpn_head(params, c5, dtype=compute_dtype)
    rois, flat_bv, flat_img = proposals(
        rpn_cls, rpn_box, calib, feat_h, feat_w, pre_nms_top_n,
        post_nms_top_n, rpn_nms_thresh, nms_impl)
    with T.span("detect.roi_pool"):
        pooled_bv = pool(c5, flat_bv, spatial_scale=1.0 / 8)
        pooled_img = pool(c5_2, flat_img, spatial_scale=1.0 / 8)
    with T.span("detect.head"):
        _, cls_prob, bbox_pred = mv3d.fusion_head(
            params, pooled_bv, pooled_img, dtype=compute_dtype)
        return _outputs(rois, cls_prob, bbox_pred)


def _inputs(params, bev, image, calib):
    """Inputs as float32 tensors on the params' device, the image
    mean-subtracted in float32 before any cast."""
    with T.span("detect.inputs"):
        dev = next(params.parameters()).device
        bev = torch.as_tensor(bev, dtype=torch.float32, device=dev)
        image = (torch.as_tensor(image, device=dev).float()
                 - torch.from_numpy(PIXEL_MEANS).to(dev))
        calib = torch.as_tensor(calib, dtype=torch.float32, device=dev)
    return bev, image, calib


@torch.inference_mode()
def _detect(params, bev, image, calib, compute_dtype, stem_impl=None, **kw):
    """Batched detector from raw inputs (B,...) on the params' device.
    stem_impl None picks the fused stem in bfloat16 and the literal one
    otherwise; any other value names the stem (models/vgg.trunk_apply)."""
    bev, image, calib = _inputs(params, bev, image, calib)
    if stem_impl is None and compute_dtype == torch.bfloat16:
        stem_impl = "fused"
    with T.span("detect.trunks"):
        c5, c5_2 = mv3d.extract_features(params, bev, image,
                                         dtype=compute_dtype,
                                         stem_impl=stem_impl)
    return detect_from_features(params, c5, c5_2, calib,
                                compute_dtype=compute_dtype, **kw)


def _dequant(q, s):
    """int8 codes times their scale, as bf16: the product is taken in
    float32, as JAX promotes bf16 * float32 (PyTorch would keep bf16)."""
    return (q.to(torch.bfloat16).float() * s).to(torch.bfloat16)


@torch.inference_mode()
def _detect_int8(params, qstate, bev, image, calib, stem_impl, conv_impl,
                 quant_rpn, quant_pool, feat_h, feat_w, pre_nms_top_n,
                 post_nms_top_n, rpn_nms_thresh, nms_impl, trunk_w, head_nk,
                 stem_cache):
    """The int8 batched detector (eval.py:137-291): int8 trunks (their convs
    on trunk_w, quant.prepare_trunk_weights' dict per trunk; the s2d_int8
    stem's weights kept in stem_cache per view), the int8 RPN
    conv with quant_rpn, the ROI pool on the int8 maps with quant_pool (on
    dequantized bf16 maps without), the int8 head when the state has one
    (its GEMMs on head_nk, quant.prepare_head_weights' dict); bf16 heads
    otherwise."""
    bev, image, calib = _inputs(params, bev, image, calib)
    fbv, s_bv, fim, s_im = Q.extract_features_int8(
        params, qstate, bev, image, trunk_w, stem_cache,
        stem=stem_impl or "bf16", conv_impl=conv_impl)
    if quant_rpn:
        rpn_cls, rpn_box = Q.rpn_head_int8(params, fbv, s_bv,
                                           conv_impl=conv_impl)
    else:
        rpn_cls, rpn_box = mv3d.rpn_head(params, _dequant(fbv, s_bv),
                                         dtype=torch.bfloat16)
    rois, flat_bv, flat_img = proposals(
        rpn_cls, rpn_box, calib, feat_h, feat_w, pre_nms_top_n,
        post_nms_top_n, rpn_nms_thresh, nms_impl)
    if not quant_pool:
        fbv, fim = _dequant(fbv, s_bv), _dequant(fim, s_im)
    with T.span("detect.roi_pool"):
        pooled_bv = roi_pool_fast(fbv, flat_bv, spatial_scale=1.0 / 8)
        pooled_img = roi_pool_fast(fim, flat_img, spatial_scale=1.0 / 8)
    head = qstate.get("head")
    if head is not None:
        if not quant_pool:
            # the bf16 pool gave dequantized values: back to int8 at the
            # trunk scales (exact up to the one bf16 rounding of q * s)
            pooled_bv = Q._quantize(pooled_bv, s_bv, 0)
            pooled_img = Q._quantize(pooled_img, s_im, 0)
        _, cls_prob, bbox_pred = Q.fusion_head_int8(
            params, head, pooled_bv, s_bv, pooled_img, s_im, head_nk)
    else:
        if quant_pool:
            pooled_bv = _dequant(pooled_bv, s_bv)
            pooled_img = _dequant(pooled_img, s_im)
        _, cls_prob, bbox_pred = mv3d.fusion_head(
            params, pooled_bv, pooled_img, dtype=torch.bfloat16)
    return _outputs(rois, cls_prob, bbox_pred)


def build_detect_fn(feat_h=75, feat_w=75, pre_nms_top_n=6000,
                    post_nms_top_n=300, rpn_nms_thresh=0.7,
                    compute_dtype=None):
    """The single-frame detector (eval.py:41-96).

    Returns detect(params, bev (H,W,9), image (H',W',3), calib (4,12)) ->
    dict with scores (P,2), boxes_bv (P,4K) [from unregressed corners],
    boxes_cnr (P,24K), boxes_cnr_r (P,24K), rois_3d (P,7), rois_img (P,5),
    valid (P,); P = post_nms_top_n, K = 2 classes. Inputs may be numpy
    arrays or tensors; outputs are tensors on the params' device.
    """
    kw = dict(feat_h=feat_h, feat_w=feat_w, pre_nms_top_n=pre_nms_top_n,
              post_nms_top_n=post_nms_top_n, rpn_nms_thresh=rpn_nms_thresh)

    def detect(params, bev, image, calib):
        with T.span("detect"):
            out = _detect(params, torch.as_tensor(bev)[None],
                          torch.as_tensor(image)[None],
                          torch.as_tensor(calib)[None], compute_dtype, **kw)
            return {name: v[0] for name, v in out.items()}

    return detect


def build_detect_batch_fn(feat_h=75, feat_w=75, pre_nms_top_n=6000,
                          post_nms_top_n=300, rpn_nms_thresh=0.7,
                          compute_dtype=None, quant=None,
                          quant_conv_impl="xla", stem_impl=None,
                          quant_rpn=False, rois_per_step=12,
                          quant_pool=True, nms_impl="auto"):
    """The batched detector (eval.py:99-305).

    Returns detect_batch(params, bev (B,...), image (B,...), calib (B,4,12))
    -> dict with leading dims (B, P) and the keys of the JAX batch detector.
    nms_impl "auto" leaves the choice to the proposal layer (the greedy
    loop at post_nms_top_n <= 512, the blocked scan above);
    "blocked_fixed" runs the fixed-round blocked NMS and the output carries
    its certificate "nms_converged" (B,) bool (eval.py:289-290), which a
    caller must check before it trusts the frame (solver.test_net raises).

    quant: an int8 PTQ state (quant.build_quant_state, load_quant_state or
    utils.weights.quant_state_from_jax) runs the int8 detector: stem_impl
    picks its stem (quant.extract_features_int8, "bf16" by default),
    quant_rpn the int8 RPN conv, quant_pool the ROI pool on int8 maps;
    heads run in bf16, the fc6/fc7 in int8 when the state has a head; the
    trunks' conv weights (with their folded requant) and the fc weights are
    laid out for the kernels once, here (the state is left as it is); the
    s2d_int8 stem's weights, which come from params, on the first call and
    again only when the params' conv1 tensors or the state's conv1 scales
    change (quant.s2d_stem_weights).
    quant_conv_impl is checked and names the same integers for every value;
    rois_per_step, a TPU tiling, is accepted and unused. With quant=None the
    float detector runs in compute_dtype with the stem stem_impl names
    (models/vgg.trunk_apply: "literal", "fused" / "pallas", "s2d",
    "s2d_fused"); None picks the fused stem in bfloat16 and the literal one
    otherwise (eval.py:174-182).
    """
    if nms_impl not in _NMS_IMPLS:
        raise ValueError("unknown nms_impl {!r}".format(nms_impl))
    kw = dict(feat_h=feat_h, feat_w=feat_w, pre_nms_top_n=pre_nms_top_n,
              post_nms_top_n=post_nms_top_n, rpn_nms_thresh=rpn_nms_thresh,
              nms_impl=nms_impl)
    if quant is None:
        run = lambda p, b, i, c: _detect(  # noqa: E731
            p, b, i, c, compute_dtype, stem_impl, **kw)
    else:
        Q._check_impl(quant_conv_impl)
        trunk_w = {key: Q.prepare_trunk_weights(quant[key])
                   for key in ("trunk_bv", "trunk_img")}
        head_nk = (None if quant.get("head") is None
                   else Q.prepare_head_weights(quant["head"]))
        stem_cache = {"trunk_bv": {}, "trunk_img": {}}
        run = lambda p, b, i, c: _detect_int8(  # noqa: E731
            p, quant, b, i, c, stem_impl, quant_conv_impl, quant_rpn,
            quant_pool, trunk_w=trunk_w, head_nk=head_nk,
            stem_cache=stem_cache, **kw)

    def detect_batch(params, bev, image, calib):
        with T.span("detect"):
            out = run(params, bev, image, calib)
        del out["rois_img"]
        return out

    return detect_batch


def frame_detections(det, num_classes=2, score_thresh=0.05,
                     nms_thresh=None, max_per_image=300):
    """Host-side assembly of one frame's detections per class
    (eval.py:308-346): threshold, BEV NMS, global top-N cap. The NMS is
    ops.nms.nms_np's keep list from its C++ twin utils/native.nms_np_native.
    Counts the boxes handed to the NMS on trace.assembly_boxes and those it
    keeps on trace.assembly_kept.

    Returns {cls: (dets_bv (M,5), dets_cnr (M,25), dets_cnr_r (M,25))}.
    """
    if nms_thresh is None:
        nms_thresh = cfg.TEST.NMS
    with T.span("assembly"):
        with T.span("assembly.to_host"):
            T.host_syncs += sum(torch.is_tensor(v) for v in det.values())
            det = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                       else np.asarray(v)) for k, v in det.items()}
        scores, valid = det["scores"], det["valid"]

        out = {}
        all_scores = []
        for j in range(1, num_classes):
            inds = np.where(valid & (scores[:, j] > score_thresh))[0]
            cls_scores = scores[inds, j]
            cls_bv = det["boxes_bv"][inds, j * 4:(j + 1) * 4]
            cls_cnr = det["boxes_cnr"][inds, j * 24:(j + 1) * 24]
            cls_cnr_r = det["boxes_cnr_r"][inds, j * 24:(j + 1) * 24]
            dets = np.hstack([cls_bv, cls_scores[:, None]]).astype(np.float32)
            keep = nms_np_native(dets, nms_thresh)
            T.assembly_boxes += len(inds)
            T.assembly_kept += len(keep)
            out[j] = (dets[keep],
                      np.hstack([cls_cnr[keep], cls_scores[keep, None]]),
                      np.hstack([cls_cnr_r[keep], cls_scores[keep, None]]))
            all_scores.append(out[j][0][:, -1])

        # global top-N cap across classes (test_mv.py:492-501)
        if max_per_image > 0 and all_scores:
            flat = np.concatenate(all_scores)
            if len(flat) > max_per_image:
                thresh = np.sort(flat)[-max_per_image]
                for j in list(out):
                    keep = np.where(out[j][0][:, -1] >= thresh)[0]
                    out[j] = tuple(a[keep] for a in out[j])
        return out
