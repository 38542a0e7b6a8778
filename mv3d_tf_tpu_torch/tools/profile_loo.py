"""Leave-one-out profile of the batched bf16 detector: the counterpart of
tools/profile_loo.py.

    python -m mv3d_tf_tpu_torch.tools.profile_loo [--batch 8] [--iters 10] \\
        [--variants "base,no roi pool"] [--device cuda|cpu]

Times the whole batched bf16 detector (fused stem, greedy NMS at post-NMS
300, both ROI kernels, the fusion head and the corner decode, reduced to
one scalar) with exactly one stage swapped for a shape-preserving
near-free stand-in (tools/profile_loo.py:83-130): the stem for a strided
slice and a channel pad, conv2-5 for a slice and pad to the feature shape,
the proposal layer for fixed rois (or, inside it, the NMS, the top-K or the
decode alone), the ROI pools for broadcast constants, the fusion head for
a softmax of two channels. base - variant is the stage's time in the
context of the whole call, its host launches overlapping the device work
before it. Each variant is timed by CUDA events around --iters calls after
a warm-up, at the reference shapes with He-scaled weights and inputs from
seed 0. The last line of stdout is a JSON object of the times.
"""

import argparse
import json
import sys

VARIANTS = {
    "base (fused stem)": {},
    "stem=literal": {"stem": "literal"},
    "no stem (slice)": {"stem": "skip"},
    "no conv2-5": {"trunks": False},
    "no proposal/nms": {"proposal": False},
    "prop sans nms": {"proposal": "no_nms"},
    "prop sans topk": {"proposal": "no_topk"},
    "prop sans decode": {"proposal": "no_decode"},
    "no roi pool": {"pool": False},
    "no fusion head": {"fusion": False},
    "stem only": {"trunks": False, "proposal": False, "pool": False,
                  "fusion": False},
}
P_ROIS = 300


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Leave-one-out profile")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", default=None,
                    help="comma-separated substrings of the variants to run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def fixed_rois(B, device):
    """A grid of plausible rois (input pixels) per frame, BEV and image."""
    import torch
    g = torch.arange(P_ROIS, dtype=torch.float32).repeat(B)
    frame = torch.arange(B, dtype=torch.float32).repeat_interleave(P_ROIS)
    bv = torch.stack([frame, (g % 20) * 28.0, (g // 20) * 36.0,
                      (g % 20) * 28.0 + 120.0, (g // 20) * 36.0 + 96.0], 1)
    img = bv.clone()
    img[:, 2] = (g // 20) * 16.0
    img[:, 4] = img[:, 2] + 90.0
    return bv.to(device), img.to(device)


def build_graph(params, B, device):
    """graph(bev, image, calib, **variant) -> one scalar."""
    import torch
    import torch.nn.functional as F

    from mv3d_tf_tpu_torch import geometry as G
    from mv3d_tf_tpu_torch.anchors import get_anchor_grid
    from mv3d_tf_tpu_torch.eval import PIXEL_MEANS
    from mv3d_tf_tpu_torch.models import mv3d, vgg
    from mv3d_tf_tpu_torch.ops.nms import nms, top_k_by_score
    from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_fast
    from mv3d_tf_tpu_torch.proposals import (IMG_BOUNDS, IMG_PAD,
                                             proposal_layer_3d)
    from mv3d_tf_tpu_torch.tools import profiling as P

    dt = torch.bfloat16
    fh, fw = P.feat_hw()
    im_h, im_w = P.BEV_HW
    means = torch.from_numpy(PIXEL_MEANS).to(device)
    fixed_bv, fixed_img = fixed_rois(B, device)
    grid = get_anchor_grid(fh, fw, 8, im_h, im_w)
    anchors_3d = torch.from_numpy(grid.anchors_3d).to(device)
    anchors_bv = torch.from_numpy(grid.anchors_bv).to(device)

    def run_trunk(x, suffix, stem, trunks):
        if stem in ("fused", "literal") and trunks:
            return vgg.trunk_apply(params, x, suffix, dt, stem)
        if stem == "skip":          # strided slice + channel pad stand-in
            h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
            s = F.pad(x[:, 0:h:2, 0:w:2, :].to(dt), (0, 64 - x.shape[-1]))
        else:
            p = (*vgg.layer(params, "conv1_1" + suffix),
                 *vgg.layer(params, "conv1_2" + suffix))
            s = vgg.stem_apply(stem, x, *p, dtype=dt)
        if not trunks:              # conv2-5 -> slice + pad to the features
            s = s[:, :s.shape[1] // 4 * 4:4, :s.shape[2] // 4 * 4:4]
            return F.pad(s, (0, 512 - s.shape[-1]))
        for name, _, pool in vgg.VGG_LAYERS[2:]:
            s = vgg.conv2d(s, *vgg.layer(params, name + suffix), dtype=dt)
            if pool:
                s = vgg.max_pool_2x2_valid(s)
        return s

    def proposal_sans(prob, deltas, calib, skip):
        """proposal_layer_3d with one internal stage left out."""
        scores = mv3d.rpn_fg_scores(prob)
        deltas = deltas.reshape(B, -1, 6)
        if skip == "no_decode":
            p3d = anchors_3d[None] + 0.0 * deltas
            pbv = anchors_bv[None] + 0.0 * deltas[..., :4]
            pim = pbv * 0.5
        else:
            p3d = G.bbox_transform_inv_3d(anchors_3d, deltas)
            pbv = G.clip_boxes(G.lidar_3d_to_bv(p3d), (im_h, im_w))
            pim = G.lidar_cnr_to_img(G.lidar_3d_to_corners(p3d),
                                     calib[:, 3], calib[:, 2], calib[:, 0])
        keep = ((pbv[..., 2] - pbv[..., 0] + 1.0 >= 5.0)
                & (pbv[..., 3] - pbv[..., 1] + 1.0 >= 5.0)
                & (pim[..., 0] >= -IMG_PAD)
                & (pim[..., 2] <= IMG_BOUNDS[1] + IMG_PAD)
                & (pim[..., 1] >= -IMG_PAD)
                & (pim[..., 3] <= IMG_BOUNDS[0] + IMG_PAD))
        k = min(6000, scores.shape[-1])
        if skip == "no_topk":
            top_idx = torch.arange(k, device=device).expand(B, k)
            top_valid = keep[:, :k]
        else:
            top_idx, top_valid = top_k_by_score(scores, keep, k)

        def take(a, idx):
            return a.gather(1, idx[..., None].expand(-1, -1, a.shape[-1]))

        bv, psc = take(pbv, top_idx), scores.gather(1, top_idx)
        if skip == "no_nms":
            keep_idx = torch.arange(P_ROIS, device=device).expand(B, P_ROIS)
            keep_idx = keep_idx.clamp(max=k - 1)
            keep_valid = top_valid.gather(1, keep_idx)
        else:
            keep_idx, keep_valid = nms(bv, psc, top_valid, P_ROIS, 0.7)
        mask = keep_valid[..., None].float()
        zeros = mask.new_zeros((B, P_ROIS, 1))

        def rows(a):
            return torch.cat([zeros, take(a, keep_idx)], -1) * mask

        return {"rois_bv": rows(bv), "rois_img": rows(take(pim, top_idx)),
                "rois_3d": rows(take(p3d, top_idx)), "valid": keep_valid}

    def graph(bev, image, calib, stem="fused", trunks=True, proposal=True,
              pool=True, fusion=True):
        image = image - means
        c5 = run_trunk(bev, "", stem, trunks)[:, :fh, :fw]
        c5_2 = run_trunk(image, "_2", stem, trunks)
        rpn_cls, rpn_box = mv3d.rpn_head(params, c5, dtype=dt)
        prob = mv3d.rpn_probs(rpn_cls)
        frame = torch.arange(B, dtype=torch.float32,
                             device=device).repeat_interleave(P_ROIS)[:, None]
        if proposal:
            if proposal is True:
                rois = proposal_layer_3d(prob, rpn_box.float(), calib, fh,
                                         fw, pre_nms_top_n=6000,
                                         post_nms_top_n=P_ROIS,
                                         im_h=im_h, im_w=im_w)
            else:
                rois = proposal_sans(prob, rpn_box.float(), calib, proposal)
            flat_bv = torch.cat([frame, rois["rois_bv"].reshape(-1, 5)[:, 1:]],
                                1)
            flat_img = torch.cat(
                [frame, rois["rois_img"].reshape(-1, 5)[:, 1:]], 1)
            rois_3d = rois["rois_3d"].reshape(-1, 7)
            valid = rois["valid"].reshape(-1)
        else:   # a cheap data dependence keeps the RPN head in the graph
            flat_bv = fixed_bv + 0.0 * prob[0, 0, 0, 0]
            flat_img = fixed_img + 0.0 * rpn_box[0, 0, 0, 0].float()
            rois_3d = torch.zeros(B * P_ROIS, 7, device=device)
            rois_3d[:, 4:7] = 1.0
            valid = torch.ones(B * P_ROIS, dtype=torch.bool, device=device)
        if pool:
            pooled_bv = roi_pool_fast(c5, flat_bv, spatial_scale=1.0 / 8)
            pooled_img = roi_pool_fast(c5_2, flat_img, spatial_scale=1.0 / 8)
        else:   # broadcast constants that keep both trunks and rois alive
            z = (c5[:, 0, 0, :] + c5_2[:, 0, 0, :]).to(dt)
            pooled_bv = (torch.zeros(B * P_ROIS, 7, 7, 512, dtype=dt,
                                     device=device)
                         + z[0] + flat_bv[0, 1].to(dt))
            pooled_img = pooled_bv + flat_img[0, 1].to(dt)
        if fusion:
            _, cls_prob, bbox_pred = mv3d.fusion_head(
                params, pooled_bv, pooled_img, dtype=dt)
        else:
            s = (pooled_bv[:, 0, 0, :2] + pooled_img[:, 0, 0, :2]).float()
            cls_prob = torch.softmax(s, -1)
            bbox_pred = torch.zeros(B * P_ROIS, 48, device=device)
        cnr = G.lidar_3d_to_corners(rois_3d[:, 1:7])
        pred_cnr = torch.cat([cnr, cnr], 1)
        pred_cnr_r = G.bbox_transform_inv_cnr(cnr, bbox_pred.float())
        mask = valid[:, None].float()
        return ((cls_prob * mask).sum()
                + (G.corners_to_bv(pred_cnr) * mask).sum()
                + pred_cnr_r[:, 0].sum())

    return graph


def main(argv=None):
    args = parse_args(argv)
    import torch

    from mv3d_tf_tpu_torch.tools import profiling as P

    device = torch.device(args.device)
    B = args.batch
    log("device:", P.device_name(device), "batch:", B)
    params = P.he_params(device)
    bev, image, calib = P.detector_inputs(B, device)
    graph = build_graph(params, B, device)
    variants = VARIANTS
    if args.variants:
        keys = [s.strip() for s in args.variants.split(",")]
        variants = {n: kw for n, kw in VARIANTS.items()
                    if any(k in n for k in keys)}
    results = {}
    with torch.inference_mode():
        for name, kw in variants.items():
            results[name] = P.stage_ms(
                lambda kw=kw: graph(bev, image, calib, **kw), device,
                iters=args.iters)[0]
            log("%-24s %9.3f ms" % (name, results[name]))
    base = results.get("base (fused stem)")
    if base is not None:
        log("--- leave-one-out attribution (ms in the context of the call)")
        for name, ms in results.items():
            if name.startswith(("no ", "stem=", "prop ")):
                log("%-24s %+9.3f ms vs base" % (name, ms - base))
    result = {"device": P.device_name(device), "batch": B, "ms": results}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
