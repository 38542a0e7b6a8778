"""3D proposal layer (mv3d_tf_tpu/proposals.py): RPN outputs -> fixed-size
proposal blocks with a validity mask.

Same pipeline as the JAX layer: fg scores -> static anchor grid -> 6-dof
decode -> BEV and image projections -> clip -> min-size and image-bounds
filters (as score masks) -> stable top-K -> BEV NMS -> fixed (P, ...)
blocks. ``nms_route`` picks the NMS: on the card the greedy kernel of
csrc/nms.cu (two launches, no host sync, on the candidates already in
score order) at any post-NMS size it takes; on the CPU the greedy loop at
post-NMS <= 512 and the blocked scan above it, as the JAX layer routes it
(proposals.py:115-121).
Frames are a batch dimension written out, where the JAX package vmaps a
single-frame layer.
"""

import torch

from mv3d_tf_tpu_torch import geometry as G
from mv3d_tf_tpu_torch import trace as T
from mv3d_tf_tpu_torch.anchors import get_anchor_grid
from mv3d_tf_tpu_torch.models.mv3d import rpn_fg_scores
from mv3d_tf_tpu_torch.ops.nms import (nms, nms_blocked, nms_blocked_fixed,
                                       top_k_by_score)
from mv3d_tf_tpu_torch.ops.nms_cuda import MAX_CANDIDATES

# the reference hardcodes the camera image bounds and padding rather than
# using the real image size (proposal_layer_tf.py:146-147,343-352)
IMG_BOUNDS = (375.0, 1242.0)
IMG_PAD = 50.0
NMS_IMPLS = ("auto", "blocked", "blocked_fixed")


def _take(a, idx):
    """a (B, N, D), idx (B, K) -> (B, K, D)."""
    return a.gather(1, idx[..., None].expand(-1, -1, a.shape[-1]))


def nms_route(device, n, post_nms_top_n, nms_impl="auto"):
    """The NMS that proposal_layer_3d and faster_rcnn_2d.proposal_layer_2d
    (always "auto") run on n candidates a frame on ``device``: "greedy"
    (ops/nms.nms), "blocked" or "blocked_fixed".

    "auto" takes the greedy kernel (csrc/nms.cu) on a CUDA device whenever
    it holds the frame (n <= ops/nms_cuda.MAX_CANDIDATES) and the blocked
    scan beyond. On any other device it takes the greedy loop at
    post_nms_top_n <= 512 and the blocked scan above: the loop takes one
    step a slot, too slow for the train step's 2000 on the CPU. "blocked"
    and "blocked_fixed" name their own route."""
    if nms_impl not in NMS_IMPLS:
        raise ValueError("unknown nms_impl {!r}".format(nms_impl))
    if nms_impl != "auto":
        return nms_impl
    if torch.device(device).type == "cuda":
        return "greedy" if n <= MAX_CANDIDATES else "blocked"
    return "greedy" if post_nms_top_n <= 512 else "blocked"


def proposal_layer_3d(rpn_cls_prob, rpn_bbox_pred, calib, feat_h, feat_w,
                      feat_stride=8, pre_nms_top_n=12000,
                      post_nms_top_n=2000, nms_thresh=0.7, min_size=5,
                      im_h=601, im_w=601, im_scale=1.0, nms_impl="auto"):
    """RPN outputs -> proposal blocks (proposals.py:38-137).

    rpn_cls_prob (B,h,w,2A) softmax probabilities; rpn_bbox_pred (B,h,w,6A)
    float32 deltas; calib (B,4,12) rows P2, P3, R0, Tr_velo2cam. Returns
    rois_bv (B,P,5), rois_img (B,P,5), rois_3d (B,P,7) [frame column 0,
    left 0 here], scores (B,P), valid (B,P), P = post_nms_top_n. Given a
    single (4,12) calib and B = 1, the leading dim is dropped, as the JAX
    layer returns.

    nms_impl "auto" runs the greedy ``nms`` on the card (csrc/nms.cu) at
    any post_nms_top_n, and on the CPU at post_nms_top_n <= 512 with
    ``nms_blocked`` above (``nms_route``); "blocked" runs ``nms_blocked``
    at any size; "blocked_fixed" runs ``nms_blocked_fixed`` and adds its
    certificate, "nms_converged" (B,) bool (0-d for a single frame). All
    three give the greedy keep set (the fixed one where certified).
    """
    single = calib.dim() == 2
    if single:
        calib = calib[None]
    B = rpn_cls_prob.shape[0]
    grid = get_anchor_grid(feat_h, feat_w, feat_stride, im_h, im_w)
    anchors_3d = torch.from_numpy(grid.anchors_3d).to(rpn_bbox_pred.device)

    scores = rpn_fg_scores(rpn_cls_prob)                     # (B, K*A)
    deltas = rpn_bbox_pred.reshape(B, -1, 6)
    p3d = G.bbox_transform_inv_3d(anchors_3d, deltas)
    pbv = G.clip_boxes(G.lidar_3d_to_bv(p3d), (im_h, im_w))
    pimg = G.lidar_cnr_to_img(G.lidar_3d_to_corners(p3d), calib[:, 3],
                              calib[:, 2], calib[:, 0])

    # min-size filter (proposal_layer_tf.py:140,336-341)
    thr = min_size * im_scale
    keep = ((pbv[..., 2] - pbv[..., 0] + 1.0 >= thr)
            & (pbv[..., 3] - pbv[..., 1] + 1.0 >= thr))
    # image-bounds filter (proposal_layer_tf.py:147,343-352)
    keep &= ((pimg[..., 0] >= -IMG_PAD)
             & (pimg[..., 2] <= IMG_BOUNDS[1] + IMG_PAD)
             & (pimg[..., 1] >= -IMG_PAD)
             & (pimg[..., 3] <= IMG_BOUNDS[0] + IMG_PAD))

    k = min(pre_nms_top_n, scores.shape[-1])
    route = nms_route(scores.device, k, post_nms_top_n, nms_impl)
    top_idx, top_valid = top_k_by_score(scores, keep, k)
    bv, p3d, pimg = _take(pbv, top_idx), _take(p3d, top_idx), _take(pimg, top_idx)
    psc = scores.gather(1, top_idx)

    converged = None
    with T.span("detect.proposals.nms"):
        if route == "blocked_fixed":
            keep_idx, keep_valid, converged = nms_blocked_fixed(
                bv, psc, top_valid, post_nms_top_n, nms_thresh,
                presorted=True)
        elif route == "greedy":
            keep_idx, keep_valid = nms(bv, psc, top_valid, post_nms_top_n,
                                       nms_thresh, presorted=True)
        else:
            keep_idx, keep_valid = nms_blocked(bv, psc, top_valid,
                                               post_nms_top_n, nms_thresh,
                                               presorted=True)
    mask = keep_valid[..., None].float()
    zeros = mask.new_zeros((B, post_nms_top_n, 1))

    def rows(a):
        return torch.cat([zeros, _take(a, keep_idx)], dim=-1) * mask

    out = {
        "rois_bv": rows(bv),
        "rois_img": rows(pimg),
        "rois_3d": rows(p3d),
        "scores": psc.gather(1, keep_idx) * keep_valid,
        "valid": keep_valid,
    }
    if converged is not None:
        out["nms_converged"] = converged
    if single:
        out = {name: v[0] for name, v in out.items()}
    return out
