"""The legacy 2D Faster R-CNN stages (mv3d_tf_tpu/faster_rcnn_2d.py): the
proposal layer, both target layers, im_detect, the 4-term loss, the
momentum-SGD train steps (end to end, and Fast R-CNN over precomputed
proposals on an image pyramid) and the snapshot unnormalization, on
tensors.

The JAX module implements the canonical py-faster-rcnn semantics (classic
bbox_transform decode, 2D anchor targets), not the reference's broken 2D
wiring (faster_rcnn_2d.py:7-14); so does this one.

As in train.py, the random draws are arguments (``make_draws_2d``): the
JAX layers draw them from a key chain whose bits a ``torch.Generator``
cannot give, so a parity test passes JAX's own. Each target layer takes one
fg and one bg uniform vector and uses each twice, for its sample and for
the sampled rows' slot order, as JAX does: both of its draws from one key
have one shape, so they are the same numbers (faster_rcnn_2d.py:147-161).

The ROI pools run the hand kernels on a card: ``roi_pool_fast`` in
im_detect, ``roi_pool_train`` (forward and gradient kernel, the even split
of dy among tied cells) in the train steps, over one frame end to end and
over the batched pyramid levels in the Fast R-CNN step; JAX pools with its
XLA roi_pool, the same function. The head runs in float32 whatever the
trunk's dtype.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch import geometry as G
from mv3d_tf_tpu_torch import trace as T
from mv3d_tf_tpu_torch.anchors import generate_anchors, shift_anchors
from mv3d_tf_tpu_torch.models import fpn, mv3d, resnet, vggnet
from mv3d_tf_tpu_torch.models.factory import get_network
from mv3d_tf_tpu_torch.ops.nms import nms, nms_blocked, top_k_by_score
from mv3d_tf_tpu_torch.ops.roi_align import roi_align_fast
from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_fast, roi_pool_train
from mv3d_tf_tpu_torch.proposals import nms_route
from mv3d_tf_tpu_torch.targets import _max_overlaps, _rank_desc, _sample_mask
from mv3d_tf_tpu_torch.train import _masked_mean, smooth_l1

SPATIAL_SCALE = 1.0 / vggnet.FEAT_STRIDE_2D


@functools.lru_cache(maxsize=None)
def get_anchor_grid_2d(height, width, feat_stride=16, scales=(8, 16, 32)):
    """The (h*w*9, 4) float32 anchor grid, location-major (numpy)."""
    return shift_anchors(generate_anchors(scales=np.array(scales)), height,
                         width, feat_stride)


def _anchors(feat_h, feat_w, feat_stride, device, scales=(8, 16, 32)):
    return torch.from_numpy(get_anchor_grid_2d(feat_h, feat_w, feat_stride,
                                               tuple(scales))).to(device)


def rpn_fg_scores_2d(rpn_cls_prob):
    """(1,h,w,2A) pairwise-softmax probs -> (h*w*A,) fg scores."""
    b, h, w, c = rpn_cls_prob.shape
    return rpn_cls_prob.reshape(b, h, w, c // 2, 2)[..., 1].reshape(-1)


def proposal_layer_2d(rpn_cls_prob, rpn_bbox_pred, im_info, feat_h, feat_w,
                      feat_stride=16, pre_nms_top_n=6000, post_nms_top_n=300,
                      nms_thresh=0.7, min_size=16, scales=(8, 16, 32)):
    """Classic 2D proposals (faster_rcnn_2d.py:47-81): decode, clip to the
    image, the min-size filter, score top-K (stable), then the greedy NMS
    keep set on the candidates in score order, routed as the 3D layer
    routes it (proposals.nms_route): csrc/nms.cu's kernel on the card (two
    launches, no host sync), the greedy loop on the CPU up to post-NMS 512
    and ``nms_blocked`` above. ``scales`` are the anchors' (at base 16,
    three ratios each), the network spec's.

    im_info (3,) float32 tensor [im_h, im_w, im_scale]. Returns rois (P,5)
    [0,x1,y1,x2,y2], scores (P,) and valid (P,) bool, zero where invalid.
    """
    anchors = _anchors(feat_h, feat_w, feat_stride, rpn_cls_prob.device,
                       scales)
    scores = rpn_fg_scores_2d(rpn_cls_prob)
    proposals = G.bbox_transform_inv(anchors, rpn_bbox_pred.reshape(-1, 4))
    proposals = G.clip_boxes(proposals, (im_info[0], im_info[1]))

    ws = proposals[:, 2] - proposals[:, 0] + 1.0
    hs = proposals[:, 3] - proposals[:, 1] + 1.0
    thr = min_size * im_info[2]
    keep = (ws >= thr) & (hs >= thr)

    k = min(pre_nms_top_n, scores.shape[0])
    top_idx, top_valid = top_k_by_score(scores, keep, k)
    props, psc = proposals[top_idx], scores[top_idx]
    greedy = nms_route(scores.device, k, post_nms_top_n) == "greedy"
    with T.span("im_detect_2d.proposals.nms"):
        keep_idx, keep_valid = (nms if greedy else nms_blocked)(
            props, psc, top_valid, post_nms_top_n, nms_thresh,
            presorted=True)
    rois = torch.cat([props.new_zeros(post_nms_top_n, 1), props[keep_idx]],
                     dim=1)
    return (rois * keep_valid[:, None].float(), psc[keep_idx] * keep_valid,
            keep_valid)


def anchor_target_layer_2d(u_fg, u_bg, gt_boxes, gt_valid, im_info, feat_h,
                           feat_w, feat_stride=16, rpn_batch=256,
                           fg_fraction=0.5, pos_overlap=0.7, neg_overlap=0.3):
    """Classic RPN targets (faster_rcnn_2d.py:84-121): labels in {-1,0,1}
    over the whole grid and 4-dof targets.

    u_fg, u_bg (h*w*9,) uniforms of the fg and bg samples; gt_boxes (G,5)
    [x1,y1,x2,y2,cls], gt_valid (G,) bool, im_info (3,) tensor. An anchor
    is inside when x1, y1 >= 0 and x2 < im_w, y2 < im_h (strict); an
    anchor is a gt's best when it ties that gt's max over the inside
    anchors; argmax takes the first index. Returns labels (h*w*9,) int32
    and bbox_targets (h*w*9, 4), 0 outside.
    """
    anchors = _anchors(feat_h, feat_w, feat_stride, gt_boxes.device)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_info[1]) & (anchors[:, 3] < im_info[0]))
    overlaps, argmax, max_ovr = _max_overlaps(anchors, gt_boxes, gt_valid)
    ovl_in = torch.where(inside[:, None], overlaps, -1.0)
    gt_max = ovl_in.amax(dim=0)
    is_gt_best = ((ovl_in == gt_max[None, :]) & gt_valid[None, :]).any(dim=1)

    fg_pool = inside & (is_gt_best | (max_ovr >= pos_overlap))
    fg_sel = _sample_mask(u_fg, fg_pool, int(fg_fraction * rpn_batch))
    bg_cand = inside & (max_ovr < neg_overlap) & ~fg_sel
    bg_sel = _sample_mask(u_bg, bg_cand, rpn_batch - fg_sel.sum())

    labels = torch.full(inside.shape, -1, dtype=torch.int32,
                        device=inside.device)
    labels = torch.where(bg_sel, 0, labels)
    labels = torch.where(fg_sel, 1, labels).int()
    tgt = G.bbox_transform(anchors, gt_boxes[argmax, :4])
    return labels, torch.where(inside[:, None], tgt, 0.0)


def proposal_target_layer_2d(u_fg, u_bg, rois, rois_valid, gt_boxes,
                             gt_valid, num_classes=21, rois_per_image=128,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.1,
                             bbox_normalize=False,
                             normalize_means=(0., 0., 0., 0.),
                             normalize_stds=(0.1, 0.1, 0.2, 0.2)):
    """Classic RoI sampling with 4-of-4K targets and inside/outside weights
    (faster_rcnn_2d.py:124-188).

    u_fg, u_bg (P+G,) uniforms: each selects its sample and orders the
    sampled rows (fg first, by descending uniform). Returns a dict of rois
    (R,5), labels (R,) int32, bbox_targets, bbox_inside_weights and
    bbox_outside_weights (R, 4K), valid (R,) bool and num_fg.
    """
    dev = rois.device
    gt_as_roi = torch.cat([gt_boxes.new_zeros(gt_boxes.shape[0], 1),
                           gt_boxes[:, :4]], dim=1)
    all_rois = torch.cat([rois, gt_as_roi])
    all_valid = torch.cat([rois_valid, gt_valid])
    _, assignment, max_ovr = _max_overlaps(all_rois[:, 1:5], gt_boxes,
                                           gt_valid)
    roi_labels = gt_boxes[assignment, 4]

    R = rois_per_image
    fg_sel = _sample_mask(u_fg, all_valid & (max_ovr >= fg_thresh),
                          int(round(fg_fraction * R)))
    n_fg = fg_sel.sum()
    bg_sel = _sample_mask(
        u_bg, all_valid & (max_ovr < bg_thresh_hi) & (max_ovr >= bg_thresh_lo),
        R - n_fg)
    n_keep = n_fg + bg_sel.sum()

    rank_fg = _rank_desc(torch.where(fg_sel, u_fg, -1e30))
    rank_bg = _rank_desc(torch.where(bg_sel, u_bg, -1e30))
    slot = torch.where(fg_sel, rank_fg, torch.where(bg_sel, n_fg + rank_bg, R))

    def scatter(x):
        out = x.new_zeros((R + 1,) + x.shape[1:])
        out[slot] = x
        return out[:R]

    out_rois = scatter(all_rois)
    out_labels = scatter(torch.where(fg_sel, roi_labels, 0.0).int())
    out_assign = scatter(assignment)
    out_valid = torch.arange(R, device=dev) < n_keep

    t = G.bbox_transform(out_rois[:, 1:5], gt_boxes[out_assign, :4])
    if bbox_normalize:
        # jitted JAX divides by the constant stds as a multiply by their
        # float32 reciprocals
        inv_stds = np.float32(1) / np.asarray(normalize_stds, np.float32)
        t = ((t - torch.tensor(normalize_means, device=dev))
             * torch.tensor(inv_stds, device=dev))
    cols = torch.arange(4 * num_classes, device=dev)
    hit = ((cols[None, :] // 4 == out_labels[:, None])
           & ((out_labels > 0) & out_valid)[:, None])
    inside_w = hit.float()
    return {"rois": out_rois, "labels": out_labels,
            "bbox_targets": torch.where(hit, t.repeat(1, num_classes), 0.0),
            "bbox_inside_weights": inside_w,
            "bbox_outside_weights": (inside_w > 0).float(),
            "valid": out_valid, "num_fg": n_fg}


def build_im_detect_2d(feat_h, feat_w, pre_nms_top_n=6000,
                       post_nms_top_n=300, compute_dtype=None,
                       pool=roi_pool_fast, spec=None):
    """Single-image 2D detection (faster_rcnn_2d.py:191-217): trunk, RPN,
    proposals, ROI pool at 1/16 (``pool``, the kernel dispatch by default),
    head, decoded and clipped boxes.

    ``spec`` is the network's (models/factory.get_network, VGGnet_test's
    when None): its trunk (ResNet-101 C4's as CUDA graphs on the card, this
    detector's own), anchor scales, pool size and head (VGG16: the fc head
    in float32; ResNet-101 C4: res5 per RoI in compute_dtype, then the
    float32 heads).

    Returns im_detect(params, image, im_info): image (H,W,3) mean-subtracted
    float32 padded to (16 feat_h, 16 feat_w), im_info (3,) [h, w, scale],
    as arrays or tensors; runs on the params' device and returns tensors
    scores (P, K), boxes (P, 4K), rois (P,5), valid (P,), K the head's
    classes.

    A spec with levels (Mask R-CNN R-101-FPN) runs the pyramid path
    instead (``_build_im_detect_fpn``): feat_h and feat_w are not read,
    pre_nms_top_n is the top-k a level and post_nms_top_n the proposals
    kept over all levels.
    """
    if spec is None:
        spec = get_network("VGGnet_test")
    if spec.levels is not None:
        return _build_im_detect_fpn(spec, pre_nms_top_n, post_nms_top_n,
                                    compute_dtype)
    trunk = (spec.trunk_apply if spec.trunk_graphs is None
             else spec.trunk_graphs())

    @torch.inference_mode()
    def im_detect(params, image, im_info):
        with T.span("im_detect_2d"):
            with T.span("im_detect_2d.inputs"):
                dev = next(params.parameters()).device
                image = torch.as_tensor(image, dtype=torch.float32, device=dev)
                im_info = torch.as_tensor(im_info, dtype=torch.float32,
                                          device=dev)
            with T.span("im_detect_2d.trunk"):
                c5 = trunk(params, image[None], dtype=compute_dtype)
            with T.span("im_detect_2d.rpn"):
                cls, box = vggnet.rpn_head_2d(params, c5, dtype=compute_dtype)
            with T.span("im_detect_2d.proposals"):
                rois, _, valid = proposal_layer_2d(
                    mv3d.rpn_probs(cls), box.float(), im_info, feat_h, feat_w,
                    pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
                    scales=spec.anchor_scales)
            with T.span("im_detect_2d.roi_pool"):
                pooled = pool(c5[0], rois, pooled=spec.pooled,
                              spatial_scale=SPATIAL_SCALE)
            with T.span("im_detect_2d.head"):
                return spec.head(params, pooled, compute_dtype,
                                 lambda cls_prob, bbox_pred: _detections(
                                     cls_prob, bbox_pred, rois, valid,
                                     im_info))

    return im_detect


def _detections(cls_prob, bbox_pred, rois, valid, im_info):
    """im_detect's outputs: the class-specific boxes decoded at the rois and
    clipped to the image, scores and boxes zeroed where no roi is."""
    boxes = G.bbox_transform_inv(rois[:, 1:5], bbox_pred)
    boxes = G.clip_boxes(boxes, (im_info[0], im_info[1]))
    mask = valid[:, None].float()
    return {"scores": cls_prob * mask, "boxes": boxes * mask, "rois": rois,
            "valid": valid}


def proposal_layer_fpn(logits, deltas, anchors, counts, im_info,
                       pre_nms_top_n=1000, post_nms_top_n=1000,
                       nms_thresh=0.7):
    """Detectron2's find_top_rpn_proposals at test time over L levels:
    the top pre_nms_top_n by logit a level (a stable sort, ties to the
    lower index), decoded with weights (1, 1, 1, 1) and the scale clamp,
    clipped to the image, empty boxes (x2 <= x1 or y2 <= y1) dropped, then
    greedy NMS within each level only, the L levels as L frames of one
    ops/nms.nms call (csrc/nms.cu on the card), and the post_nms_top_n best
    over all levels by logit (a stable sort, level-major).

    logits (L, N_max) float32, level l's first counts[l] entries its
    anchors'; deltas and anchors (sum(counts), 4), the levels in order;
    counts (L,) int64. Returns rois (post_nms_top_n, 5) [0, x1, y1, x2,
    y2], scores (post_nms_top_n,) logits, valid (post_nms_top_n,) bool and
    levels (post_nms_top_n,) int32, the index of each roi's level in the
    L; zero where not valid."""
    L, n_max = logits.shape
    k = min(pre_nms_top_n, n_max)
    live = (torch.arange(n_max, device=logits.device)[None, :]
            < counts[:, None])
    top_idx, top_valid = top_k_by_score(logits, live, k)
    offset = (torch.cumsum(counts, 0) - counts)[:, None]
    flat = torch.where(top_valid, top_idx + offset, 0)
    boxes = fpn.decode(anchors[flat], deltas[flat], fpn.RPN_WEIGHTS)
    boxes = G.clip_boxes(boxes, (im_info[0], im_info[1]))
    scores = logits.gather(1, top_idx)
    valid = (top_valid & (boxes[..., 2] > boxes[..., 0])
             & (boxes[..., 3] > boxes[..., 1]))
    m = min(k, post_nms_top_n)
    with T.span("im_detect_2d.proposals.nms"):
        keep_idx, keep_valid = nms(boxes.contiguous(), scores.contiguous(),
                                   valid, m, nms_thresh, presorted=True)
    kept = boxes.gather(1, keep_idx[..., None].expand(L, m, 4)).reshape(-1, 4)
    kept_sc = torch.where(keep_valid, scores.gather(1, keep_idx),
                          float("-inf")).reshape(-1)
    order = torch.sort(kept_sc, descending=True,
                       stable=True)[1][:post_nms_top_n]
    sc, out_valid = kept_sc[order], keep_valid.reshape(-1)[order]
    rois = torch.cat([kept.new_zeros(len(order), 1), kept[order]], dim=1)
    rois, sc = rois * out_valid[:, None].float(), torch.where(out_valid, sc,
                                                              0.0)
    levels = torch.where(out_valid, order // m, 0).int()
    pad = post_nms_top_n - len(order)
    if pad:
        rois = torch.cat([rois, rois.new_zeros(pad, 5)])
        sc = torch.cat([sc, sc.new_zeros(pad)])
        out_valid = torch.cat([out_valid, out_valid.new_zeros(pad)])
        levels = torch.cat([levels, levels.new_zeros(pad)])
    return rois, sc, out_valid, levels


@functools.lru_cache(maxsize=8)
def _fpn_anchors(image_hw, device):
    """(anchors (N, 4), counts (L,) int64) of the levels of an (H, W)
    input."""
    shapes = fpn.level_shapes(image_hw)
    counts = torch.tensor([h * w * fpn.NUM_ANCHORS for h, w in shapes],
                          device=device)
    return fpn.anchors(shapes, device), counts


def _build_im_detect_fpn(spec, pre_nms_top_n, post_nms_top_n, compute_dtype):
    """build_im_detect_2d for a spec with levels (models/factory): the trunk
    to C2-C5, then the pyramid and the RPN (resnet.StageGraphs on the
    card: graphs under im_detect_2d.trunk.*, im_detect_2d.fpn and
    im_detect_2d.rpn), proposal_layer_fpn, one multi-level RoIAlign of
    every roi (ops/roi_align.roi_align_fast, csrc/roi_align.cu on the
    card), the box head and the class-specific decode (weights 10, 10, 5,
    5), the boxes clipped to the image.

    im_detect's outputs are build_im_detect_2d's with 81 x 4 boxes, the
    background's columns 0, ``levels`` (P,) int32, the level each roi was
    pooled from, and ``rpn_levels`` (P,) int32, the pyramid level whose
    anchor it was decoded from (2-6; 2 where not valid). After a call
    ``im_detect.maps`` holds the P2-P5 maps it pooled from, (1, H_l, W_l,
    256) each, for the mask stage (build_im_mask_2d); the next call
    overwrites them."""
    trunk = resnet.StageGraphs(spec.trunk_stages)
    head = resnet.StageGraphs(spec.head_stages, copy_input=False)
    n_pool = len(fpn.POOL_LEVELS)

    @torch.inference_mode()
    def im_detect(params, image, im_info):
        with T.span("im_detect_2d"):
            with T.span("im_detect_2d.inputs"):
                dev = next(params.parameters()).device
                image = torch.as_tensor(image, dtype=torch.float32, device=dev)
                im_info = torch.as_tensor(im_info, dtype=torch.float32,
                                          device=dev)
            with T.span("im_detect_2d.trunk"):
                feats = trunk(params, image[None], dtype=compute_dtype)
            maps, (logits, deltas) = head(params, tuple(feats),
                                          dtype=compute_dtype)
            with T.span("im_detect_2d.proposals"):
                anchors, counts = _fpn_anchors(tuple(image.shape[:2]), dev)
                rois, _, valid, rpn_levels = proposal_layer_fpn(
                    logits, deltas, anchors, counts, im_info,
                    pre_nms_top_n=pre_nms_top_n,
                    post_nms_top_n=post_nms_top_n)
            pyramid = list(maps[:n_pool])
            with T.span("im_detect_2d.roi_align"):
                pooled, levels = roi_align_fast(pyramid, rois, spec.pooled,
                                                fpn.POOL_LEVELS[0])
            with T.span("im_detect_2d.head"):
                cls_prob, bbox_pred = spec.head(params, pooled, compute_dtype)
                boxes = fpn.decode(rois[:, 1:5], bbox_pred, fpn.BOX_WEIGHTS)
                boxes = G.clip_boxes(boxes, (im_info[0], im_info[1]))
                mask = valid[:, None].float()
                out = {"scores": cls_prob * mask,
                       "boxes": F.pad(boxes * mask, (4, 0)), "rois": rois,
                       "valid": valid, "levels": levels,
                       "rpn_levels": rpn_levels + spec.levels[0]}
        im_detect.maps = pyramid
        return out

    im_detect.maps = None
    return im_detect


def build_im_mask_2d(spec, compute_dtype=None):
    """The mask stage of a spec with a mask head (Mask R-CNN R-101-FPN), a
    second device stage after the host's class step
    (solver.class_detections_2d): RoIAlign at ``spec.mask_pooled`` of every
    detection's box from the pyramid im_detect left on the card, the mask
    head, and the 28x28 probabilities of each detection's class to the
    host.

    Returns im_mask(params, maps, dets, im_scale): maps im_detect.maps;
    dets the class step's [(n_j, 5) float32] in the original image's
    coordinates (class 0's empty), their boxes scaled back by im_scale (in
    float32) onto the network's input. Returns {"masks": [(n_j, 28, 28)
    float32 probabilities], "levels": (n,) int32 the pooled levels, the
    classes in order}, numpy."""

    @torch.inference_mode()
    def im_mask(params, maps, dets, im_scale):
        with T.span("im_mask_2d"):
            with T.span("im_mask_2d.inputs"):
                counts = [len(d) for d in dets]
                n = sum(counts)
                side = 2 * spec.mask_pooled
                if n == 0:
                    return {"masks": [np.zeros((c, side, side), np.float32)
                                      for c in counts],
                            "levels": np.zeros(0, np.int32)}
                boxes = np.concatenate([d[:, :4] for d in dets]).astype(
                    np.float32) * np.float32(im_scale)
                rows = np.zeros((n, 6), np.float32)
                rows[:, 1:5] = boxes
                rows[:, 5] = np.repeat(np.arange(len(dets)), counts)
                rows = torch.from_numpy(rows).to(maps[0].device)
                rois, classes = rows[:, :5].contiguous(), rows[:, 5]
            with T.span("im_mask_2d.roi_align"):
                pooled, levels = roi_align_fast(maps, rois, spec.mask_pooled,
                                                fpn.POOL_LEVELS[0])
            with T.span("im_mask_2d.head"):
                probs = spec.mask_head(params, pooled, classes, compute_dtype)
            with T.span("im_mask_2d.to_host"):
                probs = probs.cpu().numpy()
                levels = levels.cpu().numpy()
                T.host_syncs += 2
        return {"masks": np.split(probs, np.cumsum(counts)[:-1]),
                "levels": levels}

    return im_mask


def compute_losses_2d(rpn_cls_score, rpn_bbox_pred, rpn_labels,
                      rpn_bbox_targets, cls_score, bbox_pred, roi_labels,
                      roi_bbox_targets, bbox_inside_weights,
                      bbox_outside_weights, roi_valid):
    """The legacy 4-term loss (faster_rcnn_2d.py:220-254): RPN CE over the
    labelled anchors, RPN smooth-L1 over the positives, RCNN CE over the
    valid rois, and outside_w * smoothL1(inside_w * (pred - target))."""
    ce = F.cross_entropy(rpn_cls_score.reshape(-1, 2).float(),
                         rpn_labels.clamp(min=0).long(), reduction="none")
    rpn_cross_entropy = _masked_mean(ce, (rpn_labels != -1).float())

    deltas = rpn_bbox_pred.reshape(-1, 4).float()
    rpn_loss_box = _masked_mean(
        smooth_l1(deltas - rpn_bbox_targets).sum(dim=1),
        (rpn_labels == 1).float())

    cross_entropy, loss_box = rcnn_losses_2d(
        cls_score, bbox_pred, roi_labels, roi_bbox_targets,
        bbox_inside_weights, bbox_outside_weights, roi_valid)
    return {"loss": cross_entropy + loss_box + rpn_cross_entropy
            + rpn_loss_box,
            "rpn_cross_entropy": rpn_cross_entropy,
            "rpn_loss_box": rpn_loss_box, "cross_entropy": cross_entropy,
            "loss_box": loss_box}


def rcnn_losses_2d(cls_score, bbox_pred, roi_labels, roi_bbox_targets,
                   bbox_inside_weights, bbox_outside_weights, roi_valid):
    """The head's two terms: CE over the valid rois and the mean over them of
    sum(outside_w * smoothL1(inside_w * (pred - target)))
    (faster_rcnn_2d.py:242-250, :360-368). Returns (cross_entropy,
    loss_box)."""
    rvalid = roi_valid.float()
    rce = F.cross_entropy(cls_score.float(), roi_labels.long(),
                          reduction="none")
    cross_entropy = _masked_mean(rce, rvalid)
    diff = bbox_inside_weights * (bbox_pred.float() - roi_bbox_targets)
    loss_box = _masked_mean(
        (bbox_outside_weights * smooth_l1(diff)).sum(dim=1), rvalid)
    return cross_entropy, loss_box


def _uniform(generator, device, *shape):
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def make_draws_fast_rcnn(generator, rois_per_batch, fc_dim, keep_prob,
                         device):
    """The Fast R-CNN step's draws from ``generator``, moved to ``device``:
    the head's two boolean dropout keep masks (rois_per_batch, fc_dim), the
    torch counterpart of the JAX step's key (faster_rcnn_2d.py:355,
    vggnet.py:76)."""
    return {"drop": tuple(_uniform(generator, device, rois_per_batch,
                                   fc_dim) < keep_prob for _ in range(2))}


def make_draws_2d(generator, n_anchors, n_all, rois_per_image, fc_dim,
                  keep_prob, device):
    """One 2D step's random draws from ``generator`` (on its own device),
    moved to ``device``: the torch counterpart of the JAX step's key chain
    (faster_rcnn_2d.py:276, :114, :147, vggnet.py:76). n_anchors =
    feat_h * feat_w * 9, n_all = post-NMS proposals + gt rows. Returns
    anchor_fg, anchor_bg (n_anchors,), roi_fg, roi_bg (n_all,) uniforms and
    drop: two boolean keep masks (rois_per_image, fc_dim)."""
    draws = {key: _uniform(generator, device, n)
             for key, n in (("anchor_fg", n_anchors), ("anchor_bg", n_anchors),
                            ("roi_fg", n_all), ("roi_bg", n_all))}
    draws.update(make_draws_fast_rcnn(generator, rois_per_image, fc_dim,
                                      keep_prob, device))
    return draws


def build_forward_losses_2d(feat_h, feat_w, rois_per_image=128,
                            pre_nms_top_n=6000, post_nms_top_n=300,
                            n_classes=21, keep_prob=0.5, compute_dtype=None,
                            bbox_normalize=True, pool=roi_pool_train):
    """The 2D step's forward and 4-term loss (faster_rcnn_2d.py:275-303).

    Returns forward_losses(params, batch, draws) -> dict of 0-d tensors.
    batch holds image (H,W,3) mean-subtracted, im_info (3,), gt_boxes (G,5)
    and gt_valid (G,), as arrays or tensors; draws come from make_draws_2d.
    bbox_normalize divides the RCNN targets by the precomputed stds
    (snapshot_unnormalize_2d folds them back). ``pool`` is the
    differentiable single-frame ROI pool. Gradients do not flow through the
    proposals or the sampling.
    """
    def forward_losses(params, batch, draws):
        dev = next(params.parameters()).device
        b = {k: torch.as_tensor(batch[k], device=dev)
             for k in ("image", "im_info", "gt_boxes", "gt_valid")}
        im_info, gt = b["im_info"].float(), b["gt_boxes"].float()
        gt_valid = b["gt_valid"].bool()
        c5 = vggnet.trunk_apply_2d(params, b["image"].float()[None],
                                   dtype=compute_dtype)
        rpn_cls, rpn_box = vggnet.rpn_head_2d(params, c5, dtype=compute_dtype)
        with torch.no_grad():
            rpn_labels, rpn_targets = anchor_target_layer_2d(
                draws["anchor_fg"], draws["anchor_bg"], gt, gt_valid, im_info,
                feat_h, feat_w)
            rois, _, valid = proposal_layer_2d(
                mv3d.rpn_probs(rpn_cls), rpn_box.float(), im_info, feat_h,
                feat_w, pre_nms_top_n=pre_nms_top_n,
                post_nms_top_n=post_nms_top_n)
            roi_data = proposal_target_layer_2d(
                draws["roi_fg"], draws["roi_bg"], rois, valid, gt, gt_valid,
                num_classes=n_classes, rois_per_image=rois_per_image,
                bbox_normalize=bbox_normalize)
        pooled = pool(c5[0], roi_data["rois"], spatial_scale=SPATIAL_SCALE)
        cls_score, _, bbox_pred = vggnet.head_2d(
            params, pooled.float(), train=True, masks=draws["drop"],
            keep_prob=keep_prob)
        return compute_losses_2d(
            rpn_cls.float(), rpn_box, rpn_labels, rpn_targets, cls_score,
            bbox_pred, roi_data["labels"], roi_data["bbox_targets"],
            roi_data["bbox_inside_weights"], roi_data["bbox_outside_weights"],
            roi_data["valid"])

    return forward_losses


def build_train_step_2d(feat_h, feat_w, lr=0.001, momentum=0.9,
                        stepsize=50000, gamma=0.1, rois_per_image=128,
                        pre_nms_top_n=6000, post_nms_top_n=300,
                        n_classes=21, keep_prob=0.5, compute_dtype=None,
                        bbox_normalize=True, pool=roi_pool_train):
    """The legacy 2D train step (faster_rcnn_2d.py:257-316).

    Returns (train_step, make_optimizer). make_optimizer(params) freezes
    conv1/conv2 (vggnet.freeze_2d_grads) and returns (SGD with momentum,
    dampening 0, over the rest; a StepLR of ``gamma`` every ``stepsize``
    updates), which is optax.sgd(exponential_decay(lr, stepsize, gamma,
    staircase=True), momentum). train_step(params, opt, sched, batch,
    draws) runs build_forward_losses_2d's forward, the backward, one update
    and one scheduler step, in place, and returns the metrics as detached
    0-d tensors. The other arguments are build_forward_losses_2d's.
    """
    forward_losses = build_forward_losses_2d(
        feat_h, feat_w, rois_per_image=rois_per_image,
        pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
        n_classes=n_classes, keep_prob=keep_prob,
        compute_dtype=compute_dtype, bbox_normalize=bbox_normalize,
        pool=pool)
    return _sgd_step(forward_losses, lr, momentum, stepsize, gamma)


def _sgd_step(forward_losses, lr, momentum, stepsize, gamma):
    """(train_step, make_optimizer) around forward_losses(params, batch,
    draws), as build_train_step_2d documents them."""
    def make_optimizer(params):
        opt = torch.optim.SGD(vggnet.freeze_2d_grads(params), lr=lr,
                              momentum=momentum, dampening=0)
        return opt, torch.optim.lr_scheduler.StepLR(opt, stepsize, gamma)

    def train_step(params, opt, sched, batch, draws):
        opt.zero_grad(set_to_none=True)
        metrics = forward_losses(params, batch, draws)
        metrics["loss"].backward()
        opt.step()
        sched.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step, make_optimizer


_FAST_RCNN_KEYS = ("data", "rois", "labels", "bbox_targets",
                   "bbox_inside_weights", "bbox_outside_weights", "roi_valid")


def build_fast_rcnn_forward_losses(keep_prob=0.5, compute_dtype=None,
                                   pool=roi_pool_train):
    """The Fast R-CNN step's forward and 2-term loss
    (faster_rcnn_2d.py:346-369). Returns forward_losses(params, batch,
    draws) -> {"loss", "cross_entropy", "loss_box"} of 0-d tensors.

    batch holds data/multiscale.pad_minibatch_multiscale's arrays (or
    tensors): data (n_levels, H, W, 3) the pyramid slabs, rois
    (rois_per_batch, 5) [level, x1, y1, x2, y2], labels, the three
    (rois_per_batch, 4K) bbox arrays and roi_valid. The trunk runs over all
    levels at once, ``pool`` (the differentiable ROI pool) over the batched
    conv5_3 at 1/16, each roi from its level; draws come from
    make_draws_fast_rcnn."""
    def forward_losses(params, batch, draws):
        dev = next(params.parameters()).device
        b = {k: torch.as_tensor(batch[k], device=dev)
             for k in _FAST_RCNN_KEYS}
        c5 = vggnet.trunk_apply_2d(params, b["data"].float(),
                                   dtype=compute_dtype)
        pooled = pool(c5, b["rois"].float(), spatial_scale=SPATIAL_SCALE)
        cls_score, _, bbox_pred = vggnet.head_2d(
            params, pooled.float(), train=True, masks=draws["drop"],
            keep_prob=keep_prob)
        cross_entropy, loss_box = rcnn_losses_2d(
            cls_score, bbox_pred, b["labels"], b["bbox_targets"].float(),
            b["bbox_inside_weights"].float(),
            b["bbox_outside_weights"].float(), b["roi_valid"])
        return {"loss": cross_entropy + loss_box,
                "cross_entropy": cross_entropy, "loss_box": loss_box}

    return forward_losses


def build_fast_rcnn_train_step(lr=0.001, momentum=0.9, stepsize=50000,
                               gamma=0.1, keep_prob=0.5, compute_dtype=None,
                               pool=roi_pool_train):
    """The Fast R-CNN train step over precomputed proposals, the
    cfg.TRAIN.HAS_RPN = False branch (faster_rcnn_2d.py:319-382): the
    image pyramid's levels through the trunk, the host-sampled rois pooled
    from their levels, the head in train mode, CE plus weighted smooth-L1
    over the valid rois (no RPN terms), conv1/conv2 frozen, momentum SGD
    with the staircase decay.

    Returns (train_step, make_optimizer) as build_train_step_2d does, with
    batch and draws those of build_fast_rcnn_forward_losses. The JAX
    function also takes n_levels, bucket_hw, rois_per_batch and n_classes
    and ignores them (its shapes come from the batch); the port takes the
    shapes from the batch alone."""
    forward_losses = build_fast_rcnn_forward_losses(
        keep_prob=keep_prob, compute_dtype=compute_dtype, pool=pool)
    return _sgd_step(forward_losses, lr, momentum, stepsize, gamma)


def snapshot_unnormalize_2d(params, means=(0., 0., 0., 0.),
                            stds=(0.1, 0.1, 0.2, 0.2), n_classes=21):
    """Fold the bbox-target normalization back into bbox_pred
    (faster_rcnn_2d.py:385-403), so test-time decode needs none. Returns a
    NEW ModuleDict sharing every layer but bbox_pred. means/stds are per
    coordinate (4,), tiled over the classes, or per class (4K,). The
    products are taken in float64 and rounded once to float32, as the JAX
    package's numpy float64 arrays reach its float32 net."""
    m = params["bbox_pred"]
    w, b = m.weight.detach().double(), m.bias.detach().double()
    means = torch.tensor(np.asarray(means, np.float64), device=w.device)
    stds = torch.tensor(np.asarray(stds, np.float64), device=w.device)
    stds_t = stds if stds.numel() == w.shape[0] else stds.repeat(n_classes)
    means_t = means if means.numel() == w.shape[0] else means.repeat(n_classes)
    new = torch.nn.utils.skip_init(torch.nn.Linear, w.shape[1], w.shape[0],
                                   device=w.device)
    with torch.no_grad():
        new.weight.copy_((w * stds_t[:, None]).float())
        new.bias.copy_((b * stds_t + means_t).float())
    out = torch.nn.ModuleDict(dict(params.items()))
    out["bbox_pred"] = new
    return out
