"""Batch BEV generation: velodyne scans -> lidar_bv/<idx>.npy rasters,
(601, 601, 9) float32 each; the counterpart of tools/read_lidar.py.

    python -m mv3d_tf_tpu_torch.tools.read_lidar \\
        --root <kitti>/object/training [--count N] [--batch 8] \\
        [--bucket 131072] [--device cuda|cpu] [--host]

Scans are read by the C++ loader (utils/native.load_velodyne_batch). On the
card each batch is rasterized by the sort and the CUDA placement kernel
(ops/bev.py:point_cloud_2_top_batch); with --device cpu by the plain torch
scatter; with --host by the C++ host raster
(utils/native.point_cloud_2_top_host). All three write the same files.
"""

import argparse
import os
import os.path as osp
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Velodyne -> BEV rasters")
    p.add_argument("--root", required=True,
                   help="dir containing velodyne/ (output goes to lidar_bv/)")
    p.add_argument("--count", type=int, default=0,
                   help="max scans to process (0 = all)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--bucket", type=int, default=131072,
                   help="point-count bucket per scan (longer scans are cut)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--host", action="store_true",
                   help="rasterize on the host in C++ instead")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from mv3d_tf_tpu_torch.ops import bev as bev_ops
    from mv3d_tf_tpu_torch.utils import native

    vel_dir = osp.join(args.root, "velodyne")
    out_dir = osp.join(args.root, "lidar_bv")
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(vel_dir) if f.endswith(".bin"))
    if args.count:
        files = files[:args.count]
    if not files:
        print("no velodyne scans under", vel_dir)
        sys.exit(1)

    t0 = time.time()
    n_done = 0
    for start in range(0, len(files), args.batch):
        chunk = files[start:start + args.batch]
        pts, val = native.load_velodyne_batch(
            [osp.join(vel_dir, f) for f in chunk], bucket=args.bucket)
        if args.host:
            tops = np.stack([native.point_cloud_2_top_host(pts[bi][val[bi]])
                             for bi in range(len(chunk))])
        else:
            tops = bev_ops.point_cloud_2_top_batch(
                pts, val, device=args.device).cpu().numpy()
        for bi, fname in enumerate(chunk):
            np.save(osp.join(out_dir, fname.replace(".bin", ".npy")),
                    tops[bi])
            print("Processed:", fname)
            n_done += 1
    dt = time.time() - t0
    print("{} scans in {:.2f}s -> {:.1f} scans/s".format(
        n_done, dt, n_done / max(dt, 1e-9)))


if __name__ == "__main__":
    main()
