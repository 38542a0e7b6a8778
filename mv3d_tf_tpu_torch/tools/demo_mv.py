"""MV3D on one frame, drawn: the counterpart of tools/demo_mv.py, with the
same flags.

    python -m mv3d_tf_tpu_torch.tools.demo_mv --root <kitti>/object/training \\
        --index 000000 [--weights w.npy] [--out <dir>] [--device cuda|cpu] \\
        [--dtype bfloat16|float32] [--conf 0.1] [--nms 0.1]

Reads the frame's image, calib and BEV raster (``lidar_bv/<index>.npy``;
without it the velodyne scan is rasterized, on the card by the BEV
placement kernel), runs the single-frame detector (eval.build_detect_fn)
on the card (``--device cpu`` for the plain versions on the CPU), keeps
each class's detections above ``--conf`` after BEV NMS at ``--nms``, and
writes per class ``<index>_cls<j>_img.png`` (corners on the camera image),
``_bev.png`` (boxes on the BEV intensity) and, when the scan exists,
``_3d.png`` (the point cloud with the unregressed corners in green and the
regressed ones in magenta). ``--weights`` takes a reference-style .npy
weight dict or a snapshot the port wrote; without it the port's random
init (``mv3d.init_params`` from a generator seeded 0) stands in.
"""

import argparse
import os
import os.path as osp
import sys
import tempfile
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="MV3D demo")
    p.add_argument("--root", required=True,
                   help="object/training dir with image_2/ velodyne/ calib/")
    p.add_argument("--index", default="000000")
    p.add_argument("--weights", dest="model", default=None)
    p.add_argument("--out", default=osp.join(tempfile.gettempdir(),
                                             "mv3d_demo"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--conf", type=float, default=0.1,
                   help="score threshold (demo_mv.py:127 uses 0.1)")
    p.add_argument("--nms", type=float, default=0.1,
                   help="NMS threshold (demo_mv.py:125 uses 0.1)")
    return p


def load_calib_file(path):
    """A KITTI calib txt -> the (4, 12) calib blob: rows P2, P3, R0 (9
    values), Tr_velo_to_cam (tools/demo_mv.py:48-59)."""
    with open(path) as f:
        lines = [line for line in f.readlines() if line.strip()]
    vals = [np.array(line.strip().split(" ")[1:], np.float32)
            for line in lines]
    calib = np.zeros((4, 12), np.float32)
    calib[0] = vals[2][:12]
    calib[1] = vals[3][:12]
    calib[2, :9] = vals[4][:9]
    calib[3] = vals[5][:12]
    return calib


def main(argv=None):
    """Run the demo; returns the paths of the PNGs written."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    from PIL import Image

    from mv3d_tf_tpu_torch.data.blob import make_bird_view
    from mv3d_tf_tpu_torch.data.loader import load_image_bgr, pad_image
    from mv3d_tf_tpu_torch.eval import build_detect_fn, frame_detections
    from mv3d_tf_tpu_torch.models import mv3d
    from mv3d_tf_tpu_torch.ops.bev import load_velodyne
    from mv3d_tf_tpu_torch.utils.checkpoint import load_pretrained
    from mv3d_tf_tpu_torch.utils.draw import (show_bev_detections,
                                              show_lidar_corners,
                                              show_pointcloud_3d)

    device = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)
    image_path = osp.join(args.root, "image_2", args.index + ".png")
    velo_path = osp.join(args.root, "velodyne", args.index + ".bin")
    calib_path = osp.join(args.root, "calib", args.index + ".txt")
    bv_path = osp.join(args.root, "lidar_bv", args.index + ".npy")

    image_raw = load_image_bgr(image_path)
    calib = load_calib_file(calib_path)
    if osp.exists(bv_path):
        bev = torch.from_numpy(np.load(bv_path).astype(np.float32))
    else:
        bev = make_bird_view(velo_path, device=device)
    image = pad_image(image_raw)

    params = mv3d.init_params(torch.Generator(device=device).manual_seed(0),
                              device=device)
    if args.model:
        load_pretrained(params, args.model)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    detect = build_detect_fn(compute_dtype=dtype)
    t0 = time.time()
    det = detect(params, bev, image, calib)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("Detection took {:.3f}s".format(time.time() - t0))

    per_cls = frame_detections(det, score_thresh=args.conf,
                               nms_thresh=args.nms)
    bev = bev.cpu().numpy()
    scan = load_velodyne(velo_path) if osp.exists(velo_path) else None
    written = []

    def save(arr, j, kind):
        path = osp.join(args.out, "{}_cls{}_{}.png".format(args.index, j,
                                                           kind))
        Image.fromarray(arr).save(path)
        written.append(path)

    for j, (dets_bv, dets_cnr, dets_cnr_r) in per_cls.items():
        print("class {}: {} detections".format(j, len(dets_bv)))
        save(show_lidar_corners(image_raw[:, :, ::-1].astype(np.uint8),
                                dets_cnr[:, :24], calib), j, "img")
        save(show_bev_detections(bev, dets_bv[:, :4]), j, "bev")
        if scan is not None:
            save(show_pointcloud_3d(
                scan, [dets_cnr[:, :24], dets_cnr_r[:, :24]],
                colors=[(64, 255, 64), (255, 64, 255)]), j, "3d")
    print("wrote overlays to", args.out)
    return written


if __name__ == "__main__":
    main()
