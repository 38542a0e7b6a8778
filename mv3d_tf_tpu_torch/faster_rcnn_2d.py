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
from mv3d_tf_tpu_torch.models import mv3d, vggnet
from mv3d_tf_tpu_torch.ops.nms import nms_matrix, top_k_by_score
from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_fast, roi_pool_train
from mv3d_tf_tpu_torch.targets import _max_overlaps, _rank_desc, _sample_mask
from mv3d_tf_tpu_torch.train import _masked_mean, smooth_l1

SPATIAL_SCALE = 1.0 / vggnet.FEAT_STRIDE_2D


@functools.lru_cache(maxsize=None)
def get_anchor_grid_2d(height, width, feat_stride=16, scales=(8, 16, 32)):
    """The (h*w*9, 4) float32 anchor grid, location-major (numpy)."""
    return shift_anchors(generate_anchors(scales=np.array(scales)), height,
                         width, feat_stride)


def _anchors(feat_h, feat_w, feat_stride, device):
    return torch.from_numpy(get_anchor_grid_2d(feat_h, feat_w,
                                               feat_stride)).to(device)


def rpn_fg_scores_2d(rpn_cls_prob):
    """(1,h,w,2A) pairwise-softmax probs -> (h*w*A,) fg scores."""
    b, h, w, c = rpn_cls_prob.shape
    return rpn_cls_prob.reshape(b, h, w, c // 2, 2)[..., 1].reshape(-1)


def proposal_layer_2d(rpn_cls_prob, rpn_bbox_pred, im_info, feat_h, feat_w,
                      feat_stride=16, pre_nms_top_n=6000, post_nms_top_n=300,
                      nms_thresh=0.7, min_size=16):
    """Classic 2D proposals (faster_rcnn_2d.py:47-81): decode, clip to the
    image, the min-size filter, score top-K (stable), exact NMS
    (ops/nms.nms_matrix).

    im_info (3,) float32 tensor [im_h, im_w, im_scale]. Returns rois (P,5)
    [0,x1,y1,x2,y2], scores (P,) and valid (P,) bool, zero where invalid.
    """
    anchors = _anchors(feat_h, feat_w, feat_stride, rpn_cls_prob.device)
    scores = rpn_fg_scores_2d(rpn_cls_prob)
    proposals = G.bbox_transform_inv(anchors, rpn_bbox_pred.reshape(-1, 4))
    proposals = G.clip_boxes(proposals, (im_info[0], im_info[1]))

    ws = proposals[:, 2] - proposals[:, 0] + 1.0
    hs = proposals[:, 3] - proposals[:, 1] + 1.0
    thr = min_size * im_info[2]
    keep = (ws >= thr) & (hs >= thr)

    top_idx, top_valid = top_k_by_score(scores, keep,
                                        min(pre_nms_top_n, scores.shape[0]))
    props, psc = proposals[top_idx], scores[top_idx]
    with T.span("im_detect_2d.proposals.nms"):
        keep_idx, keep_valid = nms_matrix(props, psc, top_valid,
                                          post_nms_top_n, nms_thresh)
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
                       pool=roi_pool_fast):
    """Single-image 2D detection (faster_rcnn_2d.py:191-217): trunk, RPN,
    proposals, ROI pool at 1/16 (``pool``, the kernel dispatch by default),
    head, decoded and clipped boxes.

    Returns im_detect(params, image, im_info): image (H,W,3) mean-subtracted
    float32 padded to (16 feat_h, 16 feat_w), im_info (3,) [h, w, scale],
    as arrays or tensors; runs on the params' device and returns tensors
    scores (P, K), boxes (P, 4K), rois (P,5), valid (P,), K the head's
    classes.
    """

    @torch.inference_mode()
    def im_detect(params, image, im_info):
        with T.span("im_detect_2d"):
            with T.span("im_detect_2d.inputs"):
                dev = next(params.parameters()).device
                image = torch.as_tensor(image, dtype=torch.float32, device=dev)
                im_info = torch.as_tensor(im_info, dtype=torch.float32,
                                          device=dev)
            with T.span("im_detect_2d.trunk"):
                c5 = vggnet.trunk_apply_2d(params, image[None],
                                           dtype=compute_dtype)
            with T.span("im_detect_2d.rpn"):
                cls, box = vggnet.rpn_head_2d(params, c5, dtype=compute_dtype)
            with T.span("im_detect_2d.proposals"):
                rois, _, valid = proposal_layer_2d(
                    mv3d.rpn_probs(cls), box.float(), im_info, feat_h, feat_w,
                    pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n)
            with T.span("im_detect_2d.roi_pool"):
                pooled = pool(c5[0], rois, spatial_scale=SPATIAL_SCALE)
            with T.span("im_detect_2d.head"):
                _, cls_prob, bbox_pred = vggnet.head_2d(params, pooled.float())
                boxes = G.bbox_transform_inv(rois[:, 1:5], bbox_pred)
                boxes = G.clip_boxes(boxes, (im_info[0], im_info[1]))
                mask = valid[:, None].float()
                return {"scores": cls_prob * mask, "boxes": boxes * mask,
                        "rois": rois, "valid": valid}

    return im_detect


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
