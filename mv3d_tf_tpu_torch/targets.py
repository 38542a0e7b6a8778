"""Training target layers (mv3d_tf_tpu/targets.py): RPN anchor targets and
the RCNN proposal sample with its corner targets, as fixed-shape stages.

The random draws are arguments. The JAX layers draw them inside from a key
(``jax.random.uniform``), whose bits a ``torch.Generator`` cannot give, so
here the caller passes the uniforms (``train.make_draws``, or JAX's own
arrays in a parity test). Sampling without replacement is a ranking by
random priority, exactly as in the JAX layers, so the same uniforms select
the same anchors and rois.
"""

import torch

from mv3d_tf_tpu_torch import geometry as G
from mv3d_tf_tpu_torch.anchors import get_anchor_grid
from mv3d_tf_tpu_torch.ops.iou import bbox_overlaps

NEG_BIG = -1e30


def _rank_desc(pri):
    """Rank of each entry under a stable descending sort of ``pri``, as
    ``jnp.argsort(-pri)`` (stable) orders it."""
    order = torch.argsort(-pri, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=pri.device)
    return rank


def _sample_mask(u, candidates, k):
    """min(k, #candidates) candidates, those of the k highest uniforms ``u``
    (targets.py:33-45). ``k`` may be an int or a 0-d tensor."""
    return candidates & (_rank_desc(torch.where(candidates, u, NEG_BIG)) < k)


def _max_overlaps(boxes, gt_boxes_bv, gt_valid):
    """IoU against the valid gts: (overlaps (N, G) with -1 at invalid gts,
    first argmax (N,), max clamped at 0 (N,))."""
    overlaps = torch.where(gt_valid[None, :],
                           bbox_overlaps(boxes, gt_boxes_bv[:, :4]), -1.0)
    return (overlaps, overlaps.argmax(dim=1),
            overlaps.amax(dim=1).clamp(min=0.0))


def anchor_target_layer(u_fg, u_bg, gt_boxes_bv, gt_valid, gt_boxes_3d,
                        feat_h, feat_w, feat_stride=8, im_h=601, im_w=601,
                        rpn_batch=128, fg_fraction=0.25, pos_overlap=0.7,
                        neg_overlap=0.5):
    """RPN targets over the (K*A,) anchor grid (targets.py:48-116).

    u_fg, u_bg (K*A,) uniforms of the fg and bg samples; gt_boxes_bv
    (G, 5) [x1,y1,x2,y2,cls], gt_valid (G,) bool, gt_boxes_3d (G, 7).
    Returns labels (K*A,) int32 in {-1, 0, 1} and bbox_targets (K*A, 6),
    0 outside the inside-image anchors.
    """
    dev = gt_boxes_bv.device
    grid = get_anchor_grid(feat_h, feat_w, feat_stride, im_h, im_w)
    anchors_bv = torch.from_numpy(grid.anchors_bv).to(dev)
    anchors_3d = torch.from_numpy(grid.anchors_3d).to(dev)
    inside = torch.from_numpy(grid.inside).to(dev)

    overlaps, argmax, max_overlaps = _max_overlaps(anchors_bv, gt_boxes_bv,
                                                   gt_valid)
    # each gt's best anchors among the inside ones
    ovl_inside = torch.where(inside[:, None], overlaps, -1.0)
    gt_max = ovl_inside.amax(dim=0)
    is_gt_best = ((ovl_inside == gt_max[None, :])
                  & gt_valid[None, :]).any(dim=1)

    # the fg quota samples the first-round pool; IoU < neg then demotes
    fg_pool = inside & (is_gt_best | (max_overlaps >= pos_overlap))
    fg_sel = (_sample_mask(u_fg, fg_pool, int(fg_fraction * rpn_batch))
              & (max_overlaps >= neg_overlap))
    bg_cand = inside & (max_overlaps < neg_overlap)
    bg_sel = _sample_mask(u_bg, bg_cand, rpn_batch - fg_sel.sum())

    labels = torch.full((grid.total,), -1, dtype=torch.int32, device=dev)
    labels = torch.where(fg_sel, 1, torch.where(bg_sel, 0, labels))

    tgt = G.bbox_transform_3d(anchors_3d, gt_boxes_3d[argmax, :6])
    return labels, torch.where(inside[:, None], tgt, 0.0)


def proposal_target_layer_3d(u_fg, u_bg, rois_bv, rois_3d, rois_valid,
                             gt_boxes_bv, gt_valid, gt_boxes_3d,
                             gt_boxes_corners, calib, num_classes=2,
                             rois_per_image=128, fg_fraction=0.25,
                             fg_thresh=0.5, bg_thresh_hi=0.5,
                             bg_thresh_lo=0.1):
    """The RCNN minibatch of N = rois_per_image rois with corner targets
    (targets.py:119-215).

    u_fg, u_bg (P+G,) uniforms over the proposals and the gts appended as
    candidates; rois_bv (P, 5), rois_3d (P, 7), rois_valid (P,); gt_* the
    padded (G, ...) ground truth; calib (4, 12). The uniforms order the
    slots as well as choosing them: fg rows first, then bg, each by
    descending uniform. Returns rois_bv (N,5), rois_img (N,5), rois_3d
    (N,7), labels (N,) int32, bbox_targets (N, 24*num_classes), valid (N,)
    bool and num_fg (0-d), with rows past the sample zeroed.
    """
    dev = rois_bv.device
    n_gt = gt_boxes_bv.shape[0]
    zero = torch.zeros((n_gt, 1), dtype=torch.float32, device=dev)
    all_bv = torch.cat([rois_bv, torch.cat([zero, gt_boxes_bv[:, :4]], 1)])
    all_3d = torch.cat([rois_3d, torch.cat([zero, gt_boxes_3d[:, :6]], 1)])
    all_valid = torch.cat([rois_valid, gt_valid])

    _, gt_assignment, max_overlaps = _max_overlaps(all_bv[:, 1:5],
                                                   gt_boxes_bv, gt_valid)
    roi_labels = gt_boxes_bv[gt_assignment, 4]

    fg_sel = _sample_mask(u_fg, all_valid & (max_overlaps >= fg_thresh),
                          int(round(fg_fraction * rois_per_image)))
    n_fg = fg_sel.sum()
    bg_cand = (all_valid & (max_overlaps < bg_thresh_hi)
               & (max_overlaps >= bg_thresh_lo))
    bg_sel = _sample_mask(u_bg, bg_cand, rois_per_image - n_fg)
    n_keep = n_fg + bg_sel.sum()

    # slots: fg rows first, then bg; unselected rows go to a dump slot
    rank_fg = _rank_desc(torch.where(fg_sel, u_fg, NEG_BIG))
    rank_bg = _rank_desc(torch.where(bg_sel, u_bg, NEG_BIG))
    slot = torch.where(fg_sel, rank_fg,
                       torch.where(bg_sel, n_fg + rank_bg, rois_per_image))
    slot = slot.clamp(max=rois_per_image)

    def scatter(x):
        out = x.new_zeros((rois_per_image + 1,) + x.shape[1:])
        out[slot] = x
        return out[:rois_per_image]

    out_bv = scatter(all_bv)
    out_3d = scatter(all_3d)
    out_labels = scatter(torch.where(fg_sel, roi_labels, 0.0)
                         .to(torch.int32))    # bg labels are 0
    out_assign = scatter(gt_assignment)
    out_valid = torch.arange(rois_per_image, device=dev) < n_keep

    # corner targets normalised by the gt diagonal; padded gts guarded
    rois_cnr = G.lidar_3d_to_corners(out_3d[:, 1:7])
    gt_cnr = gt_boxes_corners[out_assign, :24]
    diag = G.corner_diag(gt_cnr)
    tgt = (gt_cnr - rois_cnr) / torch.where(diag > 0, diag, 1.0)[:, None]
    # one-class-hot (N, 24K): only fg rows, in their class's block
    cls_block = torch.arange(24 * num_classes, device=dev) // 24
    hit = ((cls_block[None, :] == out_labels[:, None])
           & ((out_labels > 0) & out_valid)[:, None])
    bbox_targets = torch.where(hit, tgt.repeat(1, num_classes), 0.0)

    rois_img = G.lidar_cnr_to_img(rois_cnr, calib[3], calib[2], calib[0])
    vmask = out_valid[:, None].float()
    return {
        "rois_bv": out_bv * vmask,
        "rois_img": torch.cat([out_bv[:, :1], rois_img], 1) * vmask,
        "rois_3d": out_3d * vmask,
        "labels": out_labels * out_valid,
        "bbox_targets": bbox_targets,
        "valid": out_valid,
        "num_fg": n_fg,
    }
