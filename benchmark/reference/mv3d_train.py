"""MV3D's train step in plain PyTorch (float32, TF32 off, autograd), and the
comparison that judges replayed steps of the program by it.

The step of the reference repo's MV3D_train graph as the configuration's
"train" section describes it, for one frame: both VGG16 trunks at stride
8, the BEV RPN, the anchor targets (128 anchors a frame, a quarter
foreground; IoU 0.7 and 0.5), the RCNN minibatch (128 rois, a quarter
foreground at IoU 0.5, background in [0.1, 0.5), the ground truth appended
as candidates, corner targets over the gt's diagonal), ROI pooling of both
views at 1/8, the fusion head with its five dropout masks (keep 0.5), the
four losses (RPN softmax CE over the labelled anchors, RPN smooth-L1 with
sigma 3 over the positives, RCNN CE and smooth-L1 over the valid rois,
the latter over the whole 48-wide block) and Adam (adam).

The sampling is the program's contract: the draws are inputs, and a
sample is the k candidates of the highest uniforms (ties to the lower
index), its slots ordered foreground first, each by descending uniform.
The proposals are the program's (its proposal layer's output): the
reference judges the step at the rois the program's NMS chose, as the
detection cells judge the head at the program's rois, and judges the
proposals themselves by what greedy NMS promises (proposal_numbers).
"""

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import judge, nets
from benchmark.reference import mv3d as det
from benchmark.reference.ops import nms_greedy, roi_pool, top_k

NEG = float("-inf")
BEV = 601                   # the raster's size, the anchors' bounds
KEEP_PROB = 0.5
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box")
# the program's optimizer: optax.adam's defaults
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def sample(u, candidates, k):
    """The candidates of the k highest uniforms u (stable), as a mask, and
    them in descending order."""
    order = torch.sort(torch.where(candidates, u, NEG), descending=True,
                       stable=True)[1][:int(k)]
    order = order[candidates[order]]
    mask = torch.zeros_like(candidates)
    mask[order] = True
    return mask, order


def max_overlaps(boxes, gt_bv, gt_valid):
    """IoU against the valid gts: (overlaps with -1 at invalid gts, first
    argmax, max clamped at 0)."""
    ov = torch.where(gt_valid[None, :], G.bbox_overlaps(boxes, gt_bv[:, :4]),
                     -1.0)
    return ov, ov.argmax(1), ov.amax(1).clamp(min=0.0)


def targets_3d(ex, gt):
    """6-dof regression targets of (N, 6) boxes toward (N, 6) gts, the
    reference repo's dx over the width and dy over the length."""
    return torch.stack([(gt[:, 0] - ex[:, 0]) / ex[:, 4],
                        (gt[:, 1] - ex[:, 1]) / ex[:, 3],
                        (gt[:, 2] - ex[:, 2]) / ex[:, 5],
                        torch.log(gt[:, 3] / ex[:, 3]),
                        torch.log(gt[:, 4] / ex[:, 4]),
                        torch.log(gt[:, 5] / ex[:, 5])], 1)


def anchor_targets(u_fg, u_bg, gt, feat_h, feat_w, rpn_batch=128,
                   fg_fraction=0.25, pos=0.7, neg=0.5):
    """labels (N,) in {-1, 0, 1} and targets (N, 6), 0 outside."""
    dev = u_fg.device
    bv, a3 = (torch.from_numpy(x).to(dev) for x in G.anchors_bv(feat_h,
                                                                feat_w))
    inside = ((bv[:, 0] >= 0) & (bv[:, 1] >= 0) & (bv[:, 2] < BEV)
              & (bv[:, 3] < BEV))
    ov, arg, best = max_overlaps(bv, gt["gt_boxes_bv"], gt["gt_valid"])
    ov_in = torch.where(inside[:, None], ov, -1.0)
    gt_best = ((ov_in == ov_in.amax(0)[None, :])
               & gt["gt_valid"][None, :]).any(1)
    fg, _ = sample(u_fg, inside & (gt_best | (best >= pos)),
                   int(fg_fraction * rpn_batch))
    fg &= best >= neg
    bg, _ = sample(u_bg, inside & (best < neg), rpn_batch - int(fg.sum()))
    labels = torch.full(inside.shape, -1, dtype=torch.int32, device=dev)
    labels[bg] = 0
    labels[fg] = 1
    t = targets_3d(a3, gt["gt_boxes_3d"][arg, :6])
    return labels, torch.where(inside[:, None], t, 0.0)


def roi_targets(u_fg, u_bg, props, gt, calib, num_classes=2, rois=128,
                fg_fraction=0.25, fg_thresh=0.5, bg_hi=0.5, bg_lo=0.1):
    """The RCNN minibatch from the proposals props {"rois_bv" (P, 5),
    "rois_3d" (P, 7), "valid" (P,)}: rois_bv, rois_img (R, 5), labels (R,),
    bbox_targets (R, 24K), valid (R,); slots past the sample zero."""
    dev = u_fg.device
    n_gt = len(gt["gt_valid"])
    z = torch.zeros(n_gt, 1, device=dev)
    all_bv = torch.cat([props["rois_bv"],
                        torch.cat([z, gt["gt_boxes_bv"][:, :4]], 1)])
    all_3d = torch.cat([props["rois_3d"],
                        torch.cat([z, gt["gt_boxes_3d"][:, :6]], 1)])
    valid = torch.cat([props["valid"], gt["gt_valid"]])
    _, assign, best = max_overlaps(all_bv[:, 1:5], gt["gt_boxes_bv"],
                                   gt["gt_valid"])
    fg, fg_order = sample(u_fg, valid & (best >= fg_thresh),
                          round(fg_fraction * rois))
    _, bg_order = sample(u_bg, valid & (best < bg_hi) & (best >= bg_lo),
                         rois - int(fg.sum()))
    order = torch.cat([fg_order, bg_order])
    n, n_fg = len(order), len(fg_order)

    def slots(x):
        out = x.new_zeros((rois,) + x.shape[1:])
        out[:n] = x[order]
        return out

    out_bv, out_3d = slots(all_bv), slots(all_3d)
    labels = slots(gt["gt_boxes_bv"][assign, 4].to(torch.int32))
    labels[n_fg:] = 0
    gt_cnr = slots(gt["gt_boxes_corners"][assign, :24])
    ok = torch.arange(rois, device=dev) < n
    cnr = G.lidar_3d_to_corners(out_3d[:, 1:7])
    diag = G.corner_diag(gt_cnr)
    t = (gt_cnr - cnr) / torch.where(diag > 0, diag, 1.0)[:, None]
    hit = ((torch.arange(24 * num_classes, device=dev)[None, :] // 24
            == labels[:, None]) & ((labels > 0) & ok)[:, None])
    img = G.lidar_cnr_to_img(cnr, calib)
    m = ok[:, None].float()
    return {"rois_bv": out_bv * m,
            "rois_img": torch.cat([out_bv[:, :1], img], 1) * m,
            "labels": labels * ok, "valid": ok,
            "bbox_targets": torch.where(hit, t.repeat(1, num_classes), 0.0)}


def smooth_l1(d, sigma=3.0):
    s2 = sigma * sigma
    return torch.where(d.abs() < 1.0 / s2, 0.5 * s2 * d * d,
                       d.abs() - 0.5 / s2)


def masked_mean(x, m):
    return (x * m).sum() / m.sum().clamp(min=1.0)


def head_train(weights, pooled_bv, pooled_img, masks, q):
    """The fusion head with its dropout masks: cls_score (R, 2), bbox_pred
    (R, 48)."""
    def drop(i, x):
        return torch.where(masks[i], x / KEEP_PROB, 0.0)

    def fc(x, name, relu=True):
        return nets.linear(x, *weights[name], q, relu)
    f1 = drop(1, fc(drop(0, fc(pooled_bv.reshape(len(pooled_bv), -1),
                                "fc6_1")), "fc7_1"))
    f2 = drop(3, fc(drop(2, fc(pooled_img.reshape(len(pooled_img), -1),
                                "fc6_2")), "fc7_2"))
    fused = drop(4, torch.cat([f1, f2], 1))
    return fc(fused, "cls_score", False), fc(fused, "bbox_pred", False)


def step(weights, frame, draws, props, q=nets.exact):
    """The four losses at the program's proposals, their gradients by
    autograd, and the targets: {"losses", "grads" {name: (gw, gb)},
    "anchor_labels", "rois", "c5" (the BEV trunk's map)}. weights {name:
    (w, b)} are made leaves here."""
    w = {k: tuple(t.detach().clone().requires_grad_(True) for t in v)
         for k, v in weights.items()}
    gt = {k: frame[k] for k in ("gt_boxes_bv", "gt_boxes_3d",
                                "gt_boxes_corners", "gt_valid")}
    means = torch.tensor(det.PIXEL_MEANS, device=frame["image"].device)
    image = frame["image"].float() - means
    c5 = nets.trunk(w, frame["bev"].float().permute(2, 0, 1)[None], "", 8, q)
    c5_2 = nets.trunk(w, image.permute(2, 0, 1)[None], "_2", 8, q)
    cls, box = nets.rpn(w, c5, q)
    with torch.no_grad():
        labels, tgt = anchor_targets(draws["anchor_fg"], draws["anchor_bg"],
                                     gt, c5.shape[2], c5.shape[3])
        rois = roi_targets(draws["roi_fg"], draws["roi_bg"], props, gt,
                           frame["calib"])
    pooled_bv = roi_pool(c5[0].permute(1, 2, 0), rois["rois_bv"])
    pooled_img = roi_pool(c5_2[0].permute(1, 2, 0), rois["rois_img"])
    score, pred = head_train(w, pooled_bv, pooled_img, draws["drop"], q)
    ce = F.cross_entropy(cls, labels.clamp(min=0).long(), reduction="none")
    rv = rois["valid"].float()
    losses = {
        "rpn_cross_entropy": masked_mean(ce, (labels != -1).float()),
        "rpn_loss_box": masked_mean(smooth_l1(box - tgt).sum(1),
                                    (labels == 1).float()),
        "cross_entropy": masked_mean(F.cross_entropy(
            score, rois["labels"].long(), reduction="none"), rv),
        "loss_box": masked_mean(smooth_l1(pred - rois["bbox_targets"])
                                .sum(1), rv)}
    sum(losses.values()).backward()

    def grad(t):
        # a layer the loss does not reach (no roi inside the image) has none
        return torch.zeros_like(t) if t.grad is None else t.grad
    return {"losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": {k: (grad(v[0]), grad(v[1])) for k, v in w.items()},
            "anchor_labels": labels, "rois": rois, "c5": c5.detach()}


def proposals(a, pre_nms, post_nms, thresh):
    """The proposal layer on decoded anchors a (mv3d.anchors_all's): the
    filters, the stable top-K, greedy NMS; the program's keys "rois_bv"
    (P, 5), "rois_3d" (P, 7), "valid" (P,)."""
    k = min(pre_nms, len(a["prob"]))
    top, top_valid = top_k(a["prob"], det.passes(a), k)
    keep, found = nms_greedy(a["pbv"][top], a["prob"][top], top_valid,
                             post_nms, thresh)
    m = found[:, None].float()
    z = torch.zeros_like(m)
    return {"rois_bv": torch.cat([z, a["pbv"][top[keep]] * m], 1),
            "rois_3d": torch.cat([z, a["p3d"][top[keep]] * m], 1),
            "valid": found}


def proposal_numbers(a, props, pre_nms, post_nms, thresh):
    """What greedy NMS promises (reference/judge.py), of a proposal layer's
    output props, judged by the float32 reference's decoded anchors a with
    the detection cells' margins (mv3d.judge_frame): nms_gap, missing_rois,
    and nms_overlap, the largest IoU between two of props' valid BEV
    boxes."""
    valid = props["valid"]
    rois = props["rois_3d"][valid][:, 1:7]
    idx, _ = judge.match(det.log_sizes(rois), det.log_sizes(a["p3d"]),
                         a["logit"], det.MATCH_SLACK)
    cand = det.passes(a, size_margin=det.SIZE_MARGIN_PX,
                      image_margin=det.IMAGE_MARGIN_PX)
    k = min(pre_nms, len(a["prob"]))
    pool = torch.zeros_like(cand)
    pool[top_k(a["prob"], det.passes(a), int(k * det.POOL_SHARE))[0]] = True
    gap, missing = judge.gap(idx, a["logit"], a["pbv"], cand, pool & cand,
                             thresh, det.IOU_MARGIN, post_nms)
    return {"nms_gap": gap, "missing_rois": missing,
            "nms_overlap": judge.overlap(props["rois_bv"][valid][:, 1:5])}


def adam(grads, lr, q=nets.exact):
    """Adam's updates over one tensor's gradients at steps 1, 2, ... from
    zero moments, bias-corrected, -lr m_hat / (sqrt(v_hat) + eps) as
    torch.optim.Adam and optax.adam compute it, in float64; q rounds each
    update (the control's float8)."""
    (b1, b2), m, v, out = BETAS, 0.0, 0.0, []
    for t, g in enumerate(grads, 1):
        g = g.double()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        d = -lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt()
                                         + ADAM_EPS)
        out.append(q(d).double())
    return out


def flat(pair):
    return torch.cat([t.reshape(-1) for t in pair])


def judge_step(ref, got, a, nms):
    """The numbers of one replayed step: ref the reference's step (step's
    output), got the program's {"losses", "grads" {name: (gw, gb)},
    "anchor_labels", "rois" (its RCNN minibatch), "props" (its
    proposals)}, a the reference's decoded anchors, nms (pre-NMS, post-NMS,
    threshold). anchor_mismatch and roi_mismatch count the anchors and roi
    slots whose label (and for a roi its validity and box) differ;
    loss_err is the largest relative error of the four losses; nms_gap,
    missing_rois and nms_overlap proposal_numbers'. "along" holds, for
    each layer with a gradient, <g, g_ref> / <g_ref, g_ref>: the
    gradient's length along the reference's, weight and bias as one
    vector (a bias alone can be a sum that cancels, such as cls_score's,
    whose rounding then swamps its length)."""
    r, g = ref["rois"], got["rois"]
    roi_bad = ((r["labels"] != g["labels"]) | (r["valid"] != g["valid"])
               | (r["rois_bv"] != g["rois_bv"]).any(1))
    along = {}
    for name, pair in ref["grads"].items():
        want = flat(pair)
        if bool(want.any()):
            along[name] = float((flat(got["grads"][name]) @ want)
                                / (want @ want))
    return {"anchor_mismatch": int((ref["anchor_labels"]
                                    != got["anchor_labels"]).sum()),
            "roi_mismatch": int(roi_bad.sum()),
            "loss_err": max(abs(got["losses"][k] - ref["losses"][k])
                            / max(abs(ref["losses"][k]), 1e-12)
                            for k in LOSSES),
            **proposal_numbers(a, got["props"], *nms),
            "along": along}


def adam_err(gots, lr):
    """The largest over the parameter tensors and steps of |d - d_ref| /
    |d_ref|: gots the program's steps in turn, one optimizer, each with its
    "grads" and "updates" {name: (dw, db)}; d_ref Adam's update (adam) from
    the program's own gradients, so that only the optimizer is judged. A
    step that leaves the parameters as they were reads 1."""
    worst = 0.0
    for name in gots[0]["grads"]:
        for i in (0, 1):
            want = adam([g["grads"][name][i] for g in gots], lr)
            for g, d_ref in zip(gots, want):
                d = g["updates"][name][i].double()
                if bool(d_ref.any()) or bool(d.any()):
                    worst = max(worst, float((d - d_ref).norm()
                                             / d_ref.norm().clamp(min=1e-30)))
    return worst


def judge_replays(replays, lr):
    """The numbers that judge the replays: replays a list of [(judge_step's
    numbers, the program's step)] over each replay's steps in turn. The
    worst over the steps of judge_step's numbers; adam_err over each
    replay, the worst; grad_scale_err the largest over the layers of
    |mean over the steps of "along" - 1|: bfloat16's error lies mostly
    across the gradient, and along it mostly changes sign from step to
    step (the BEV trunk's first convs keep a 2-4% shrink); a scaled
    gradient's lies along it in every step."""
    out, along = {}, {}
    for replay in replays:
        for nums, _ in replay:
            for k, v in nums.items():
                if k == "along":
                    for name, x in v.items():
                        along.setdefault(name, []).append(x)
                else:
                    out[k] = max(out.get(k, 0.0), v)
        out["adam_err"] = max(out.get("adam_err", 0.0),
                              adam_err([g for _, g in replay], lr))
    out["grad_scale_err"] = max((abs(sum(v) / len(v) - 1.0)
                                 for v in along.values()), default=0.0)
    return out
