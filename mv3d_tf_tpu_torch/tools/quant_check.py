"""The int8 PTQ accuracy gate: the bf16 and int8 batched detectors on the
frames of a KITTI-layout tree; the counterpart of tools/quant_check.py, with
its flags but --conv-impl (its TPU lowerings name one set of integers) and
its final JSON line (plus ``--device``); --stem takes any name of
models/vgg.STEMS.

    python -m mv3d_tf_tpu_torch.tools.quant_check --kitti_path <kitti> \\
        [--frames 8] [--calib_frames 8] [--batch 16] [--model w.npy] \\
        [--stem s2d_fused] [--int8-head] [--int8-rpn] [--nms blocked_fixed] \\
        [--pre-nms 1024] [--device cuda|cpu]

Calibrates the quantizer on train-split frames, then runs both detectors on
val frames: score deltas over the slots both keep, and the AP battery
against gt for both (BEV AP at IoU 0.5 and 0.7 and, unless --skip-3d, the
quality-mode table on the regressed corners). Progress goes to stderr; the
last line of stdout is one JSON object. Exits 3 if the blocked_fixed NMS
certificate failed on any frame.
"""

import argparse
import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_parser():
    from mv3d_tf_tpu_torch.models.vgg import STEMS
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti_path", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--calib_frames", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16,
                    help="device batch per detect call (frames are "
                         "processed in chunks of this size)")
    ap.add_argument("--model", default=None)
    ap.add_argument("--stem", default=None, choices=list(STEMS),
                    help="int8-path stem (default literal)")
    ap.add_argument("--int8-head", action="store_true",
                    help="also quantize and gate the fc6/fc7 head")
    ap.add_argument("--int8-rpn", action="store_true",
                    help="also quantize and gate the RPN 3x3 conv")
    ap.add_argument("--no-quant-pool", action="store_true",
                    help="dequantize trunk outputs before the ROI pool")
    ap.add_argument("--pre-nms", type=int, default=6000,
                    help="pre-NMS top-N for the int8 path (the bf16 "
                         "reference keeps 6000)")
    ap.add_argument("--nms", default="auto",
                    choices=["auto", "blocked_fixed"],
                    help="NMS of the int8 path (the bf16 reference keeps "
                         "auto; both are exact greedy)")
    ap.add_argument("--skip-3d", action="store_true",
                    help="skip the official 3d/bev quality tables")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from mv3d_tf_tpu_torch import quant as Q
    from mv3d_tf_tpu_torch.data.kitti import KittiMV3D, prepare_roidb
    from mv3d_tf_tpu_torch.data.kitti_eval import (evaluate_kitti_bev,
                                                   evaluate_kitti_official)
    from mv3d_tf_tpu_torch.data.loader import load_image_bgr, pad_image
    from mv3d_tf_tpu_torch.eval import (PIXEL_MEANS, build_detect_batch_fn,
                                        frame_detections)
    from mv3d_tf_tpu_torch.models import mv3d
    from mv3d_tf_tpu_torch.utils.checkpoint import load_pretrained

    device = torch.device(args.device)
    params = mv3d.init_params(torch.Generator(device=device).manual_seed(0),
                              device=device)
    if args.model:
        load_pretrained(params, args.model)

    def load_frames(imdb, idx):
        bevs, images, calibs = [], [], []
        for i in idx:
            images.append(pad_image(load_image_bgr(imdb.image_path_at(i))))
            bevs.append(np.load(imdb.lidar_path_at(i)).astype(np.float32))
            calibs.append(np.asarray(imdb.calib_at(i), np.float32))
        return np.stack(bevs), np.stack(images), np.stack(calibs)

    def to_numpy(out):
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    train_imdb = KittiMV3D("train", kitti_path=args.kitti_path)
    prepare_roidb(train_imdb)
    val_imdb = KittiMV3D("val", kitti_path=args.kitti_path)
    prepare_roidb(val_imdb)
    n_val = min(args.frames, val_imdb.num_images)

    cb, ci, cc = load_frames(
        train_imdb, range(min(args.calib_frames, train_imdb.num_images)))
    log("calibrating on {} train frames...".format(len(cb)))
    pool_bv = pool_img = None
    if args.int8_head:
        pool_bv, pool_img = Q.calibrate_pooled_features(
            params, cb, ci - PIXEL_MEANS, cc)
    qs = Q.build_quant_state(params, cb, ci - PIXEL_MEANS,
                             pooled_bv=pool_bv, pooled_img=pool_img)

    B = args.batch
    det_f16 = build_detect_batch_fn(compute_dtype=torch.bfloat16)
    det_int8 = build_detect_batch_fn(compute_dtype=torch.bfloat16, quant=qs,
                                     stem_impl=args.stem,
                                     quant_rpn=args.int8_rpn,
                                     quant_pool=not args.no_quant_pool,
                                     pre_nms_top_n=args.pre_nms,
                                     nms_impl=args.nms)

    # the official table needs full per-class detection lists
    k = val_imdb.num_classes

    def empty(width):
        return {p: [[np.zeros((0, width), np.float32)
                     for _ in range(val_imdb.num_images)] for _ in range(k)]
                for p in ("f", "q")}

    boxes, cnr, cnr_r = empty(5), empty(25), empty(25)
    deltas = []
    n_valid = {"f": 0, "q": 0}
    cert_fail = 0

    t0 = time.time()
    for b0 in range(0, n_val, B):
        idx = list(range(b0, min(b0 + B, n_val)))
        vb, vi, vc = load_frames(val_imdb, idx)
        while len(vb) < B:              # pad the tail batch
            vb = np.concatenate([vb, vb[-1:]])
            vi = np.concatenate([vi, vi[-1:]])
            vc = np.concatenate([vc, vc[-1:]])
        vb_d, vi_d, vc_d = (torch.from_numpy(a).to(device)
                            for a in (vb, vi, vc))
        out_f = to_numpy(det_f16(params, vb_d, vi_d, vc_d))
        out_q = to_numpy(det_int8(params, vb_d, vi_d, vc_d))
        if "nms_converged" in out_q:
            cert_fail += int((~out_q["nms_converged"][:len(idx)]).sum())
        both = out_f["valid"] & out_q["valid"]
        deltas.append(np.abs(out_f["scores"][..., 1]
                             - out_q["scores"][..., 1])[both])
        n_valid["f"] += int(out_f["valid"][:len(idx)].sum())
        n_valid["q"] += int(out_q["valid"][:len(idx)].sum())
        for p, out in (("f", out_f), ("q", out_q)):
            for bi, i in enumerate(idx):
                one = {key: out[key][bi] for key in
                       ("scores", "boxes_bv", "boxes_cnr", "boxes_cnr_r",
                        "valid")}
                per = frame_detections(one, num_classes=k,
                                       score_thresh=0.05, nms_thresh=0.1)
                for j, (d_bv, d_cnr, d_cnr_r) in per.items():
                    boxes[p][j][i] = d_bv
                    cnr[p][j][i] = d_cnr
                    cnr_r[p][j][i] = d_cnr_r
        log("  {}/{} frames ({:.0f}s)".format(
            min(b0 + B, n_val), n_val, time.time() - t0))

    ds = np.concatenate(deltas) if deltas else np.zeros(0)
    log("valid slots: bf16 {} int8 {}".format(n_valid["f"], n_valid["q"]))
    log("score |delta| over shared slots: mean {:.4f} p95 {:.4f}".format(
        ds.mean() if len(ds) else -1,
        np.percentile(ds, 95) if len(ds) else -1))
    if cert_fail:
        log("WARNING: blocked_fixed NMS certificate FAILED on {} "
            "frames: the int8 APs below are not trustworthy".format(
                cert_fail))

    quiet = lambda *a, **kw: None  # noqa: E731
    res = {"frames": n_val, "nms_cert_failures": cert_fail}
    for p, name in (("f", "bf16"), ("q", "int8")):
        for thr in (0.5, 0.7):
            res["ap{}_{}".format(thr, name)] = round(float(
                evaluate_kitti_bev(val_imdb, boxes[p], iou_thresh=thr,
                                   num_frames=n_val)["ap"]), 4)
        if not args.skip_3d:
            # quality-mode table: regressed corners, the proper projection,
            # footprint against footprint in BEV
            tq = evaluate_kitti_official(
                val_imdb, boxes[p], cnr_r[p], log=quiet,
                projection="proper", derive_bev_from_corners=True,
                label="quality/" + name, num_frames=n_val)
            res["q3d_hard_" + name] = round(float(tq["3d"]["hard"]), 4)
            res["qbev_hard_" + name] = round(float(tq["bev"]["hard"]), 4)
    log("BEV AP@0.5: bf16 {} int8 {}".format(res["ap0.5_bf16"],
                                             res["ap0.5_int8"]))
    log("BEV AP@0.7: bf16 {} int8 {}".format(res["ap0.7_bf16"],
                                             res["ap0.7_int8"]))
    if not args.skip_3d:
        log("quality 3d(hard): bf16 {} int8 {}".format(
            res["q3d_hard_bf16"], res["q3d_hard_int8"]))
        log("quality bev(hard): bf16 {} int8 {}".format(
            res["qbev_hard_bf16"], res["qbev_hard_int8"]))
    res.update({
        # the JAX tool's older key names, kept
        "ap_bf16": res["ap0.5_bf16"], "ap_int8": res["ap0.5_int8"],
        "score_delta_mean": round(float(ds.mean()), 5) if len(ds) else None,
        "score_delta_p95": round(float(np.percentile(ds, 95)), 5)
        if len(ds) else None,
        "valid_bf16": n_valid["f"], "valid_int8": n_valid["q"]})
    print(json.dumps(res))
    if cert_fail:
        sys.exit(3)
    return res


if __name__ == "__main__":
    main()
