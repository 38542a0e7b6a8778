"""Pre-NMS top-K knee: the counterpart of tools/prenms_knee.py.

    python -m mv3d_tf_tpu_torch.tools.prenms_knee --kitti_path <kitti> \\
        [--model w.npy|snapshot.pt] [--frames 64] [--batch 8] \\
        [--ks 6000 3000 2048 1024 512] [--device cuda|cpu]

The test config feeds 6000 score-sorted candidates into the RPN's BEV NMS
and keeps 300. At each pre-NMS K over the val split's first frames (a
multiple of the batch), the batched bf16 detector's keep-set agreement with
the first K's (the baseline; 6000 by default: the share of its valid rois
found in any slot at this K), the BEV AP at IoU 0.5 and 0.7
(data/kitti_eval.evaluate_bev_ap on the car detections after the per-class
NMS at 0.1), the ms per batch (CUDA events around one pass over the
batches, after a first call) and the mean valid count. Progress goes to
stderr; the last line of stdout is the JSON list of rows.
"""

import argparse
import json
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Pre-NMS top-K knee")
    ap.add_argument("--kitti_path", required=True)
    ap.add_argument("--model", default=None,
                    help="a .npy weight dict or the port's .pt snapshot")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ks", type=int, nargs="+",
                    default=[6000, 3000, 2048, 1024, 512])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def keep_agreement(base_rois, base_valid, rois, valid):
    """The share of the baseline's valid rois_3d rows (per frame) found in
    any slot of this K's, within 1e-3."""
    hit = tot = 0
    for f in range(len(base_rois)):
        ref = base_rois[f][base_valid[f] > 0][:, 1:]
        got = rois[f][valid[f] > 0][:, 1:]
        tot += len(ref)
        if len(got) and len(ref):
            d = np.abs(ref[:, None] - got[None]).max(-1)
            hit += int((d.min(1) < 1e-3).sum())
    return hit / max(tot, 1)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from mv3d_tf_tpu_torch.data.kitti import KittiMV3D, prepare_roidb
    from mv3d_tf_tpu_torch.data.kitti_eval import evaluate_bev_ap
    from mv3d_tf_tpu_torch.data.loader import load_image_bgr, pad_image
    from mv3d_tf_tpu_torch.eval import build_detect_batch_fn, frame_detections
    from mv3d_tf_tpu_torch.models import mv3d
    from mv3d_tf_tpu_torch.tools import profiling as P
    from mv3d_tf_tpu_torch.utils.checkpoint import load_pretrained

    device = torch.device(args.device)
    params = mv3d.init_params(torch.Generator(device=device).manual_seed(0),
                              device=device)
    if args.model:
        load_pretrained(params, args.model)
    imdb = KittiMV3D("val", kitti_path=args.kitti_path)
    prepare_roidb(imdb)
    B = args.batch
    n = min(args.frames, imdb.num_images)
    n -= n % B
    if n == 0:
        raise SystemExit("fewer val frames (%d) than one batch (%d)"
                         % (imdb.num_images, B))
    log("device:", P.device_name(device), " frames:", n, " batch:", B)
    gts = [imdb.roidb[i]["boxes_bv"][imdb.roidb[i]["gt_classes"] == 1]
           for i in range(n)]
    data = []
    for s in range(0, n, B):
        idx = range(s, s + B)
        bev = np.stack([np.load(imdb.lidar_path_at(i)).astype(np.float32)
                        for i in idx])
        img = np.stack([pad_image(load_image_bgr(imdb.image_path_at(i)))
                        for i in idx])
        cal = np.stack([np.asarray(imdb.calib_at(i), np.float32)
                        for i in idx])
        data.append(tuple(torch.from_numpy(a).to(device)
                          for a in (bev, img, cal)))

    report, base = [], None
    for k in args.ks:
        detect = build_detect_batch_fn(compute_dtype=torch.bfloat16,
                                       pre_nms_top_n=k)
        first_ms, _ = P.stage_ms(lambda: detect(params, *data[0]), device,
                                 iters=1, warmup=0)
        outs = []
        total_ms, _ = P.stage_ms(
            lambda: outs.extend(detect(params, *d) for d in data), device,
            iters=1, warmup=0)
        outs = [{key: v.float().cpu().numpy() for key, v in o.items()}
                for o in outs]
        rois = np.concatenate([o["rois_3d"] for o in outs])
        valid = np.concatenate([o["valid"] for o in outs])
        if base is None:
            base = rois, valid
        agree = keep_agreement(*base, rois, valid)
        dets = []
        for o in outs:
            for b in range(B):
                one = {key: o[key][b] for key in (
                    "scores", "boxes_bv", "boxes_cnr", "boxes_cnr_r")}
                one["valid"] = o["valid"][b] > 0
                per = frame_detections(one, score_thresh=0.05,
                                       nms_thresh=0.1)
                dets.append(per.get(1, (np.zeros((0, 5), np.float32),))[0])
        row = {"pre_nms": k, "ms_per_batch": total_ms / len(data),
               "keep_agree_vs_%d" % args.ks[0]: float(agree),
               "bev_ap@0.5": float(evaluate_bev_ap(dets, gts, 0.5)["ap"]),
               "bev_ap@0.7": float(evaluate_bev_ap(dets, gts, 0.7)["ap"]),
               "first_call_ms": first_ms,
               "valid_mean": float(valid.sum() / n)}
        report.append(row)
        log(row)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
