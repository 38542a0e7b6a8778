"""Training (mv3d_tf_tpu/train.py): the single-frame train step on tensors
-- trunks, RPN, anchor targets, proposal layer, proposal targets, ROI pool
of both views, fusion head with dropout, the 4-term loss and Adam.

Loss parity (train.py:37-86): RPN softmax CE over anchors labelled 0/1;
RPN smooth-L1 (sigma 3) summed over the 6 dof, mean over the positives;
RCNN CE over the valid sampled rois; RCNN smooth-L1 over the FULL (N, 48)
block (background rows regress toward 0, a reference quirk); total = sum;
Adam at lr 1e-5 with optax's defaults; no weight decay.

The random draws are an argument, ``draws`` (``make_draws``): the JAX step
derives its samples and dropout masks from one key, whose bits a
``torch.Generator`` cannot give, so the port takes them as tensors and a
parity test can pass JAX's. Gradients do not flow through proposals or
sampling. The ROI pool is ``ops/roi_pool.py:roi_pool_train``: on a card
the forward and backward CUDA kernels, with the TPU kernel's even split of
dy among tied cells. The fusion head and the loss run in float32 whatever
the trunks' compute dtype.
"""

import numpy as np
import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch.eval import PIXEL_MEANS
from mv3d_tf_tpu_torch.models import mv3d, vgg
from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_train
from mv3d_tf_tpu_torch.proposals import proposal_layer_3d
from mv3d_tf_tpu_torch.targets import (anchor_target_layer,
                                       proposal_target_layer_3d)

BATCH_KEYS = ("bev", "image", "calib", "gt_boxes_bv", "gt_boxes_3d",
              "gt_boxes_corners", "gt_valid")
TRAIN_STEMS = ("literal", "s2d")   # the differentiable stems


def smooth_l1(diff, sigma=3.0):
    """train.py:37-43."""
    sigma2 = sigma * sigma
    a = diff.abs()
    return torch.where(a < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       a - 0.5 / sigma2)


def _masked_mean(x, mask):
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def compute_losses(rpn_cls_score, rpn_bbox_pred, rpn_labels, rpn_bbox_targets,
                   cls_score, bbox_pred, roi_labels, roi_bbox_targets,
                   roi_valid):
    """The 4-term loss (train.py:51-86), with masks over fixed shapes."""
    ce = F.cross_entropy(rpn_cls_score.reshape(-1, 2).float(),
                         rpn_labels.clamp(min=0).long(), reduction="none")
    rpn_cross_entropy = _masked_mean(ce, (rpn_labels != -1).float())

    deltas = rpn_bbox_pred.reshape(-1, 6).float()
    sl1 = smooth_l1(deltas - rpn_bbox_targets).sum(dim=1)
    rpn_loss_box = _masked_mean(sl1, (rpn_labels == 1).float())

    rvalid = roi_valid.float()
    rce = F.cross_entropy(cls_score.float(), roi_labels.long(),
                          reduction="none")
    cross_entropy = _masked_mean(rce, rvalid)
    rsl1 = smooth_l1(bbox_pred.float() - roi_bbox_targets).sum(dim=1)
    loss_box = _masked_mean(rsl1, rvalid)

    return {
        "loss": cross_entropy + loss_box + rpn_cross_entropy + rpn_loss_box,
        "rpn_cross_entropy": rpn_cross_entropy,
        "rpn_loss_box": rpn_loss_box,
        "cross_entropy": cross_entropy,
        "loss_box": loss_box,
    }


def make_draws(generator, n_anchors, n_all, rois_per_image, fc_dim,
               keep_prob, device):
    """One step's random draws, from ``generator`` on its own device, moved
    to ``device``: the torch counterpart of the JAX step's key splits
    (train.py:122, targets.py:90,155, mv3d.py:154).

    n_anchors = feat_h * feat_w * 4; n_all = post-NMS proposals + the gt
    rows. Returns anchor_fg, anchor_bg (n_anchors,) and roi_fg, roi_bg
    (n_all,) uniforms in [0, 1), and drop: five boolean keep masks
    (N, fc_dim) x 4 and (N, 2 fc_dim), N = rois_per_image, each True with
    probability keep_prob.
    """
    def uniform(*shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(device)

    drop_shapes = [(rois_per_image, fc_dim)] * 4 + [(rois_per_image,
                                                     2 * fc_dim)]
    return {
        "anchor_fg": uniform(n_anchors), "anchor_bg": uniform(n_anchors),
        "roi_fg": uniform(n_all), "roi_bg": uniform(n_all),
        "drop": tuple(uniform(*s) < keep_prob for s in drop_shapes),
    }


def _on_device(batch, device):
    return {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}


def build_forward_losses(feat_h=75, feat_w=75, pre_nms_top_n=12000,
                         post_nms_top_n=2000, rpn_nms_thresh=0.7,
                         rois_per_image=128, keep_prob=0.5,
                         compute_dtype=None, pool=roi_pool_train,
                         stem_impl=None, nms_impl="auto"):
    """The per-frame forward and 4-term loss (train.py:89-161).

    Returns forward_losses(params, batch, draws) -> dict of 0-d tensors
    (loss and its four terms). batch holds one frame: bev (601,601,9),
    image (H,W,3) raw BGR, calib (4,12), gt_boxes_bv (G,5), gt_boxes_3d
    (G,7), gt_boxes_corners (G,25), gt_valid (G,) bool, as arrays or
    tensors; draws comes from make_draws. ``pool`` is the differentiable
    single-frame ROI pool. stem_impl None or "literal" runs the literal
    stem, "s2d" the space-to-depth packed convs (ops/stem_s2d.py), whose
    gradient is the literal stem's; the fused stems have no gradient and
    are refused. nms_impl is the proposal layer's
    (proposals.proposal_layer_3d).
    """
    if vgg.stem_name(stem_impl) not in TRAIN_STEMS:
        raise ValueError(
            "stem_impl {!r} cannot train: the fused stems are inference "
            "kernels without a gradient; use one of {}".format(
                stem_impl, TRAIN_STEMS))

    def forward_losses(params, batch, draws):
        dev = next(params.parameters()).device
        b = _on_device(batch, dev)
        image = b["image"].float() - torch.from_numpy(PIXEL_MEANS).to(dev)
        c5, c5_2 = mv3d.extract_features(params, b["bev"].float()[None],
                                         image[None], dtype=compute_dtype,
                                         stem_impl=stem_impl)
        rpn_cls, rpn_box = mv3d.rpn_head(params, c5, dtype=compute_dtype)
        gt = (b["gt_boxes_bv"], b["gt_valid"], b["gt_boxes_3d"])

        with torch.no_grad():
            rpn_labels, rpn_bbox_targets = anchor_target_layer(
                draws["anchor_fg"], draws["anchor_bg"], *gt, feat_h, feat_w)
            rois = proposal_layer_3d(
                mv3d.rpn_probs(rpn_cls), rpn_box.float(), b["calib"], feat_h,
                feat_w, pre_nms_top_n=pre_nms_top_n,
                post_nms_top_n=post_nms_top_n, nms_thresh=rpn_nms_thresh,
                nms_impl=nms_impl)
            roi_data = proposal_target_layer_3d(
                draws["roi_fg"], draws["roi_bg"], rois["rois_bv"],
                rois["rois_3d"], rois["valid"], *gt, b["gt_boxes_corners"],
                b["calib"], rois_per_image=rois_per_image)

        pooled_bv = pool(c5[0], roi_data["rois_bv"], spatial_scale=1.0 / 8)
        pooled_img = pool(c5_2[0], roi_data["rois_img"],
                          spatial_scale=1.0 / 8)
        cls_score, _, bbox_pred = mv3d.fusion_head(
            params, pooled_bv.float(), pooled_img.float(), train=True,
            masks=draws["drop"], keep_prob=keep_prob)
        return compute_losses(
            rpn_cls.float(), rpn_box, rpn_labels, rpn_bbox_targets,
            cls_score, bbox_pred, roi_data["labels"],
            roi_data["bbox_targets"], roi_data["valid"])

    return forward_losses


def build_train_step(feat_h=75, feat_w=75, pre_nms_top_n=12000,
                     post_nms_top_n=2000, rpn_nms_thresh=0.7,
                     rois_per_image=128, keep_prob=0.5, lr=1e-5,
                     compute_dtype=None, stem_impl=None, nms_impl="auto",
                     pool=roi_pool_train):
    """Build (train_step, make_optimizer) (train.py:164-198).

    make_optimizer(params) is Adam over the parameter ModuleDict with
    optax.adam's defaults. train_step(params, opt, batch, draws) runs the
    forward, the backward and one optimizer step, updating params in place,
    and returns the metrics as detached 0-d tensors. stem_impl, nms_impl
    and pool are build_forward_losses'.
    """
    forward_losses = build_forward_losses(
        feat_h=feat_h, feat_w=feat_w, pre_nms_top_n=pre_nms_top_n,
        post_nms_top_n=post_nms_top_n, rpn_nms_thresh=rpn_nms_thresh,
        rois_per_image=rois_per_image, keep_prob=keep_prob,
        compute_dtype=compute_dtype, stem_impl=stem_impl, nms_impl=nms_impl,
        pool=pool)

    def make_optimizer(params):
        return torch.optim.Adam(params.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)

    def train_step(params, opt, batch, draws):
        opt.zero_grad(set_to_none=True)
        metrics = forward_losses(params, batch, draws)
        metrics["loss"].backward()
        opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step, make_optimizer


def build_train_step_cached(**kwargs):
    """build_train_step over a device-resident dataset (train.py:201-226):
    train_step(params, opt, data, idx, draws), where data holds stacked
    per-frame tensors (bev may be bfloat16 and image uint8; both are cast
    back to float32) and idx selects the frame."""
    inner, make_optimizer = build_train_step(**kwargs)

    def train_step(params, opt, data, idx, draws):
        batch = {k: data[k][idx] for k in BATCH_KEYS}
        batch["bev"] = batch["bev"].float()
        batch["image"] = batch["image"].float()
        return inner(params, opt, batch, draws)

    return train_step, make_optimizer


def filter_roidb(roidb, fg_thresh=0.5, bg_hi=0.5, bg_lo=0.1):
    """Drop entries with no usable fg or bg rois (train.py:229-242)."""
    def is_valid(entry):
        overlaps = entry["max_overlaps"]
        fg = np.where(overlaps >= fg_thresh)[0]
        bg = np.where((overlaps < bg_hi) & (overlaps >= bg_lo))[0]
        return len(fg) > 0 or len(bg) > 0

    filtered = [e for e in roidb if is_valid(e)]
    print("Filtered {} roidb entries: {} -> {}".format(
        len(roidb) - len(filtered), len(roidb), len(filtered)))
    return filtered
