"""Accuracy evidence run: train MV3D on a synthetic KITTI-layout dataset and
record the loss and AP trajectory; the counterpart of tools/accuracy_eval.py,
with the same flags and the same accuracy_trajectory.json keys.

    python -m mv3d_tf_tpu_torch.tools.accuracy_eval --frames 200 \\
        --iters 2000 --eval-every 500 [--data <dir>] [--out <dir>] \\
        [--dtype bf16|f32] [--resume] [--lr-decay [--stepsize N] \\
        [--gamma G]] [--train-stem s2d] [--data-hbm-gb G] \\
        [--device cuda|cpu]

The recipe (train_mv.py:373-382, mv3d.sh:31-49) with the
faster_rcnn_end2end.yml overrides on both sides: a VGG-style pretrain dict
made from --seed goes through utils/weights.make_mv3d_pretrain_dict; the
untrained model is evaluated; then solver.train_net runs in segments of
--eval-every iterations (each a snapshot, and the next a resume with Adam
and the LR scheduler), each followed by solver.test_net on the val split
(the C++ AP matcher): BEV AP at 0.5 and 0.7 and the official-protocol
tables, legacy and proper projection and the regressed corners. Runs on the
card unless --device cpu. The train set is pinned on the card once for all
segments. --resume continues from the latest snapshot in --out, with the
trajectory written so far (its losses too, which the JAX tool drops at the
first segment it writes), and does not make the pretrain dict again, which
only a run from iteration 0 reads. Losses are logged every
min(50, --eval-every) iterations, so that a short segment records them.
"""

import argparse
import json
import os
import os.path as osp
import time

_REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
END2END_YML = osp.join(_REPO, "experiments", "cfgs", "faster_rcnn_end2end.yml")
TRAJECTORY = "accuracy_trajectory.json"


def quiet(*a, **k):
    pass


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MV3D loss and AP trajectory")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--cars", type=int, default=4)
    ap.add_argument("--train-frac", type=float, default=0.5,
                    help="train/val split fraction at generation time")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--data", default=None,
                    help="synthetic tree, generated if absent (default "
                         "<ROOT_DIR>/output/accuracy_run/kitti_synth)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--eval-thresh", type=float, default=0.05)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest snapshot in --out "
                         "(keeps the previously recorded trajectory)")
    ap.add_argument("--data-hbm-gb", type=float, default=None,
                    help="cfg.TPU.TRAIN_DATA_HBM_GB: the card-resident "
                         "train-set budget; above it frames come from the "
                         "host")
    ap.add_argument("--lr-decay", action="store_true",
                    help="staircase lr decay 1e-5 * GAMMA^(it // stepsize) "
                         "(without it the reference's constant 1e-5)")
    ap.add_argument("--stepsize", type=int, default=None,
                    help="cfg.TRAIN.STEPSIZE for --lr-decay")
    ap.add_argument("--gamma", type=float, default=None,
                    help="cfg.TRAIN.GAMMA for --lr-decay")
    ap.add_argument("--train-stem", default=None, choices=[None, "s2d"],
                    help="cfg.TPU.TRAIN_STEM: 's2d' trains the packed stem")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def synthetic_vgg_dict(seed):
    """The VGG16-shaped weights the JAX tool makes from its seed
    (tools/accuracy_eval.py:123-135): the same arrays, in the same draw
    order."""
    import numpy as np

    from mv3d_tf_tpu_torch.models import vgg
    rng = np.random.RandomState(seed)
    vgg_dict = {}
    c_in = 3
    for name, c_out, _ in vgg.VGG_LAYERS:
        vgg_dict[name] = {
            "weights": (rng.randn(3, 3, c_in, c_out) * 0.05).astype(
                np.float32),
            "biases": np.zeros(c_out, np.float32)}
        c_in = c_out
    vgg_dict["fc6"] = {"weights": (rng.randn(25088, 4096) * 0.005).astype(
        np.float32), "biases": np.zeros(4096, np.float32)}
    vgg_dict["fc7"] = {"weights": (rng.randn(4096, 4096) * 0.005).astype(
        np.float32), "biases": np.zeros(4096, np.float32)}
    return vgg_dict


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from mv3d_tf_tpu_torch import solver, train
    from mv3d_tf_tpu_torch.config import cfg, cfg_from_file
    from mv3d_tf_tpu_torch.data import synthetic
    from mv3d_tf_tpu_torch.data.kitti import KittiMV3D, prepare_roidb
    from mv3d_tf_tpu_torch.data.kitti_eval import (evaluate_kitti_bev,
                                                   evaluate_kitti_official)
    from mv3d_tf_tpu_torch.models import mv3d
    from mv3d_tf_tpu_torch.utils.checkpoint import (latest_snapshot,
                                                    snapshot_iter)
    from mv3d_tf_tpu_torch.utils.weights import (load_npy_weights,
                                                  make_mv3d_pretrain_dict)

    # the reference recipe runs both sides with the end2end overrides
    # (mv3d.sh:34,46): TRAIN RPN 12000/2000, TEST RPN 6000/300 and NMS 0.1
    cfg_from_file(END2END_YML)
    if args.data_hbm_gb is not None:
        cfg.TPU.TRAIN_DATA_HBM_GB = args.data_hbm_gb
    if args.lr_decay:
        cfg.TRAIN.LR_DECAY = True
        if args.stepsize is not None:
            cfg.TRAIN.STEPSIZE = args.stepsize
        if args.gamma is not None:
            cfg.TRAIN.GAMMA = args.gamma
    if args.train_stem:
        cfg.TPU.TRAIN_STEM = args.train_stem

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu", " dtype:", args.dtype,
          flush=True)

    # --- dataset -------------------------------------------------------------
    if args.data is None:
        args.data = osp.join(cfg.ROOT_DIR, "output", "accuracy_run",
                             "kitti_synth")
    if not osp.exists(osp.join(args.data, "ImageSets", "train.txt")):
        print("generating {} synthetic frames under {}".format(
            args.frames, args.data), flush=True)
        synthetic.generate(args.data, num_frames=args.frames,
                           cars_per_frame=args.cars, seed=args.seed,
                           train_frac=args.train_frac)
    else:
        print("WARNING: reusing existing dataset at {} -- "
              "--train-frac/--frames/--cars/--seed ignored; delete the "
              "directory to regenerate".format(args.data), flush=True)
    train_imdb = KittiMV3D("train", kitti_path=args.data)
    val_imdb = KittiMV3D("val", kitti_path=args.data)
    roidb = prepare_roidb(train_imdb)
    prepare_roidb(val_imdb)
    print("train frames:", train_imdb.num_images,
          " val frames:", val_imdb.num_images, flush=True)

    out_dir = args.out or osp.join(cfg.ROOT_DIR, "output", "accuracy_run",
                                   "kitti_train")
    os.makedirs(out_dir, exist_ok=True)

    # --- train/eval trajectory -----------------------------------------------
    def run_eval(params, tag):
        print("[eval {}] starting".format(tag), flush=True)
        t0 = time.time()
        all_boxes, all_cnr, all_cnr_r = solver.test_net(
            params, val_imdb, weights_filename="accuracy_" + tag,
            thresh=args.eval_thresh, compute_dtype=dtype, log=quiet,
            return_cnr_r=True)
        rec = {"tag": tag}
        for thr in (0.5, 0.7):
            rec["bev_ap@{}".format(thr)] = evaluate_kitti_bev(
                val_imdb, all_boxes, iou_thresh=thr)["ap"]
        table = evaluate_kitti_official(val_imdb, all_boxes, all_cnr,
                                        log=quiet)
        rec["official"] = table
        # the reference's translation-dropping projection depresses the
        # legacy 2D AP; the proper projection's table shows the gap
        table_p = evaluate_kitti_official(val_imdb, all_boxes, all_cnr,
                                          log=quiet, projection="proper")
        rec["official_proper_projection"] = table_p
        # quality mode: the regressed corners, footprints from the corner
        # sets, the proper projection
        table_q = evaluate_kitti_official(val_imdb, all_boxes, all_cnr_r,
                                          log=quiet, projection="proper",
                                          derive_bev_from_corners=True,
                                          label="quality/regressed")
        rec["official_quality_regressed"] = table_q
        rec["eval_seconds"] = round(time.time() - t0, 1)
        print("[eval {}] BEV AP@0.5={:.4f} AP@0.7={:.4f} "
              "official bev(hard)={:.4f} 3d(hard)={:.4f} "
              "2d(hard) legacy={:.4f} proper={:.4f} "
              "quality 3d(hard)={:.4f} bev(hard)={:.4f} ({}s)".format(
                  tag, rec["bev_ap@0.5"], rec["bev_ap@0.7"],
                  table["bev"]["hard"], table["3d"]["hard"],
                  table["2d"]["hard"], table_p["2d"]["hard"],
                  table_q["3d"]["hard"], table_q["bev"]["hard"],
                  rec["eval_seconds"]), flush=True)
        return rec

    traj = {"config": vars(args), "evals": [], "losses": []}
    tj_path = osp.join(out_dir, TRAJECTORY)

    resume_from = 0
    if args.resume:
        snap = latest_snapshot(out_dir)
        if snap is not None:
            resume_from = snapshot_iter(snap)
            if osp.exists(tj_path):
                with open(tj_path) as f:
                    old = json.load(f)
                traj["evals"] = old.get("evals", [])
                traj["losses"] = old.get("losses", [])
            print("resuming from snapshot iter {} ({} prior evals)"
                  .format(resume_from, len(traj["evals"])), flush=True)

    pretrain_path = osp.join(out_dir, "vgg_synth_sampled.npy")
    if resume_from == 0:
        # the pretrain import (make_pretrain_data.ipynb path); a resumed
        # run starts from its snapshot and does not read it
        pretrain = make_mv3d_pretrain_dict(synthetic_vgg_dict(args.seed),
                                           seed=args.seed)
        np.save(pretrain_path, np.array(pretrain, dtype=object),
                allow_pickle=True)
        # baseline: pretrain-initialized, untrained
        gen = torch.Generator(device=device).manual_seed(cfg.RNG_SEED)
        params0 = load_npy_weights(mv3d.init_params(gen, device=device),
                                   pretrain, log=None)
        traj["evals"].append(run_eval(params0, "iter0"))
        del params0, pretrain

    losses = traj["losses"]

    def log_capture(msg):
        print(msg, flush=True)
        if msg.startswith("iter:"):
            losses.append(msg)

    # pin the (filtered) train set on the card once for all segments
    device_data = None
    if device.type == "cuda" and dtype is not None \
            and args.iters > resume_from:
        device_data = solver._build_device_dataset(
            train.filter_roidb(roidb), device)

    done = resume_from
    while done < args.iters:
        upto = min(done + args.eval_every, args.iters)
        params = solver.train_net(
            train_imdb, roidb, out_dir,
            pretrained_model=pretrain_path if done == 0 else None,
            max_iters=upto, compute_dtype=dtype, resume=done > 0,
            display=min(50, args.eval_every),
            snapshot_iters=args.eval_every, log=log_capture,
            device_data=device_data, device=device)
        done = upto
        traj["evals"].append(run_eval(params, "iter{}".format(done)))
        with open(tj_path, "w") as f:
            json.dump(traj, f, indent=1)

    print("\n=== trajectory ===")
    for rec in traj["evals"]:
        print("{:>8s}: BEV AP@0.5 {:.4f}  AP@0.7 {:.4f}  "
              "official hard 2d/bev/3d {:.4f}/{:.4f}/{:.4f}".format(
                  rec["tag"], rec["bev_ap@0.5"], rec["bev_ap@0.7"],
                  rec["official"]["2d"]["hard"],
                  rec["official"]["bev"]["hard"],
                  rec["official"]["3d"]["hard"]))
    print("results written to", tj_path)
    return traj


if __name__ == "__main__":
    main()
